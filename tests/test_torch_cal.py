"""The port's CAL / MCN (models/cal.py), its proposal engine
(retrieval/proposal_engine.py) and train_cal's trainer against the JAX
package on the same seeded numpy inputs and converted weights.

The JAX scan-LSTM of the query encoder is compiled here only, at the
smallest shapes, once per program in module-scoped jitted functions (XLA:
CPU has been seen to crash compiling it in long processes, VERDICT.md; a
file of its own keeps such a crash to this file): the forward with its
gradients, the engine's query scoring (shared by CAL and MCN, whose cached
proposal embeddings have the same shape), the trainer's step and the bf16
forward. Tolerances: f32 losses, distances and embeddings within 2e-4,
gradients within 2e-4 of each tensor's largest entry, engine scores within
1e-5 with rankings equal outside near-ties, the SVMR ranking of exact ties
equal (both rank with the same host ``np.argsort``), the trainer's epoch
losses within 1e-4 and its parameters within 2e-5."""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _baseline_pairs import JaxTrainer, one_torch_thread  # noqa: F401
from tvretrieval_tpu.data import retrieval_datasets as jrd
from tvretrieval_tpu.data.synthetic import make_synthetic_world as j_make_world
from tvretrieval_tpu.models import cal as jc
from tvretrieval_tpu.retrieval import proposal_engine as jpe
from tvretrieval_tpu_torch.convert import flax_params_to_state_dict
from tvretrieval_tpu_torch.data import retrieval_datasets as trd
from tvretrieval_tpu_torch.data.synthetic import make_synthetic_world
from tvretrieval_tpu_torch.models import cal as tc
from tvretrieval_tpu_torch.retrieval import proposal_engine as tpe
from tvretrieval_tpu_torch.testing import rank_mismatches
from tvretrieval_tpu_torch.training import train_cal

WORLD = dict(n_videos=9, n_queries=24, vid_dim=6, text_dim=5, max_clips=12, seed=3,
             query_dim=8)
CLIPS, LQ = 4, 6
MODEL = dict(visual_hidden_size=8, output_size=6, lstm_hidden_size=8)


def _pair(model_type="cal", ctx_mode="video_sub_tef", constant_video=None):
    """(world, builder) of each package, the same seeds; ``constant_video``:
    that video's clips all equal, so its proposals of one clip count tie."""
    out = []
    for make, rd in ((j_make_world, jrd), (make_synthetic_world, trd)):
        w = make(**WORLD)
        if constant_video is not None:
            name = w.corpus.vid_names[constant_video]
            for src in (w.video_source, w.sub_source):
                f = src._table[name]
                src._table[name] = np.repeat(f[:1], len(f), axis=0)
        bcfg = rd.CALBuilderConfig(ctx_mode=ctx_mode, model_type=model_type,
                                   clip_length=w.clip_length, max_desc_l=LQ, max_ctx_l=12,
                                   max_moment_clips=CLIPS)
        out.append((w, rd.CALExampleBuilder(bcfg, w.query_source, w.video_source,
                                            w.sub_source, seed=11)))
    return out


def _cfgs(builder, dtype_str="float32", **kw):
    tef = 2 * builder.use_tef
    base = dict(ctx_mode="video_sub", visual_input_size=2 * WORLD["vid_dim"] + tef,
                textual_input_size=2 * WORLD["text_dim"] + tef,
                query_feat_size=WORLD["query_dim"], dtype_str=dtype_str, **MODEL, **kw)
    return jc.CALConfig(**base), tc.CALConfig(**base)


def _params(jcfg, batch, seed=1):
    """Seeded flax parameters: kernels N(0, 1/fan_in), biases N(0, 0.1^2)."""
    shapes = jax.eval_shape(lambda b: jc.CALWithSub(jcfg).init(jax.random.PRNGKey(0), **b),
                            batch)["params"]
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        n = rng.standard_normal(leaf.shape).astype(np.float32)
        return n / np.sqrt(leaf.shape[0]) if path[-1].key == "kernel" else 0.1 * n

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _port(tcfg, params):
    m = tc.CALWithSub(tcfg)
    m.load_state_dict(flax_params_to_state_dict(params), strict=True)
    return m


@pytest.fixture(scope="module")
def setup():
    (jw, jb), (tw, tb) = _pair()
    rows = jw.annotations[:8]
    jbatch = jb.build_train_batch(rows, jw.annotations)
    tbatch = tb.build_train_batch(rows, tw.annotations)
    jcfg, tcfg = _cfgs(jb)
    return jcfg, tcfg, _params(jcfg, jbatch), jbatch, tbatch


def test_train_batches_are_bit_equal(setup):
    _, _, _, jbatch, tbatch = setup
    assert jbatch.keys() == tbatch.keys() and len(jbatch) == 11
    for k in jbatch:
        np.testing.assert_array_equal(jbatch[k], tbatch[k], err_msg=k)


def test_forward_embeddings_and_gradients_match_jax(setup):
    """One jitted program on the JAX side: the triplet loss and its
    gradients, the query embeddings, a pdist and the all-pairs cdist."""
    jcfg, tcfg, params, batch, _ = setup
    m = jc.CALWithSub(jcfg)

    def run(p, b):
        (loss, _), grads = jax.value_and_grad(lambda q: m.apply({"params": q}, **b),
                                              has_aux=True)(p)
        v = {"params": p}
        q = m.apply(v, b["query_feat"], b["query_mask"], method=jc.CALWithSub.encode_query)
        pd = m.apply(v, q, b["pos_video_feat"], b["pos_sub_feat"], b["pos_mask"],
                     method=jc.CALWithSub.compute_pdist)
        emb_v = m.apply(v, b["intra_video_feat"], "video", method=jc.CALWithSub.encode_moments)
        emb_s = m.apply(v, b["intra_sub_feat"], "sub", method=jc.CALWithSub.encode_moments)
        cd = m.apply(v, q, emb_v, emb_s, b["intra_mask"],
                     method=jc.CALWithSub.cdist_from_encoded)
        return loss, grads, q, pd, cd

    loss, grads, q, pd, cd = jax.jit(run)(params, batch)
    model = _port(tcfg, params)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got, aux = model(**tb)
    assert aux["loss_overall"] is got
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), rtol=0, atol=2e-4)
    jgrads = flax_params_to_state_dict(jax.device_get(grads))
    assert {k for k, _ in model.named_parameters()} == set(jgrads)
    for k, p in model.named_parameters():
        want = jgrads[k].numpy()
        if k.endswith("bias_ih_l0"):          # flax's cell has no input bias
            assert (p.grad == 0).all() and (want == 0).all(), k
            continue
        scale = np.abs(want).max()
        assert scale > 1e-6, k
        assert np.abs(p.grad.numpy() - want).max() <= 2e-4 * scale, k
    with torch.no_grad():
        tq = model.encode_query(tb["query_feat"], tb["query_mask"])
        tpd = model.compute_pdist(tq, tb["pos_video_feat"], tb["pos_sub_feat"], tb["pos_mask"])
        tcd = model.cdist_from_encoded(tq, model.encode_moments(tb["intra_video_feat"], "video"),
                                       model.encode_moments(tb["intra_sub_feat"], "sub"),
                                       tb["intra_mask"])
    for a, b in ((tq, q), (tpd, pd), (tcd, cd)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=2e-4)
    # the diagonal of the all-pairs distances is each row's own pdist
    np.testing.assert_allclose(np.diagonal(tcd.numpy()), tc.CALWithSub.compute_pdist(
        model, tq, tb["intra_video_feat"], tb["intra_sub_feat"],
        tb["intra_mask"]).detach().numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("loss_type", ["hinge", "lse"])
def test_rank_losses_match(setup, loss_type):
    jcfg, tcfg, params, _, _ = setup
    rng = np.random.default_rng(4)
    pos, neg = (rng.uniform(0, 4, 16).astype(np.float32) for _ in range(2))
    neg[:4] = pos[:4] + 0.1                            # at the hinge's margin
    jm = jc.CALWithSub(jc.CALConfig(**{**jcfg.__dict__, "loss_type": loss_type}))
    want = jm.apply({"params": params}, jnp.asarray(pos), jnp.asarray(neg),
                    method=jc.CALWithSub._rank_loss)
    tm = tc.CALWithSub(tc.CALConfig(**{**tcfg.__dict__, "loss_type": loss_type}))
    got = tm._rank_loss(torch.from_numpy(pos), torch.from_numpy(neg))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-7)
    with pytest.raises(NotImplementedError):
        tc.CALWithSub(tc.CALConfig(**{**tcfg.__dict__, "loss_type": "bogus"}))


@pytest.mark.parametrize("model_type", ["cal", "mcn"])
def test_engine_matches_jax_and_shares_the_npz_cache(setup, tmp_path, model_type):
    """encode_proposal_corpus + cal_retrieve on both packages: the cache
    JAX writes, read by the port, scores as the port's own does; VCMR
    scores within 1e-5 and the ranking equal outside near-ties; the SVMR
    ranking of the ground-truth video equal, exact ties included (video 2
    has constant clips: its proposals of one clip count tie; pads tie at
    1e10 past each video's proposals)."""
    (jw, jb), (tw, tb) = _pair(model_type, ctx_mode="video_sub", constant_video=2)
    jcfg, tcfg = _cfgs(jb)
    _, _, params, _, _ = setup
    params = dict(params, video_moment_mlp=_resize(params["video_moment_mlp"],
                                                   jcfg.visual_input_size),
                  sub_moment_mlp=_resize(params["sub_moment_mlp"], jcfg.textual_input_size))
    jm = jc.CALWithSub(jcfg)
    model = _port(tcfg, params).train()            # the engine runs it in eval mode
    rows = [r for r in jw.annotations if r["vid_name"] == jw.corpus.vid_names[2]][:2] + \
        jw.annotations[:10]
    kw = dict(query_bsz=4, max_before_nms=300, return_arrays=True)
    jcache = jpe.encode_proposal_corpus(jm, {"params": params}, jb, jw.corpus, ctx_bsz=4)
    want = jpe.cal_retrieve(jm, {"params": params}, jb, jcache, jw.corpus, rows, **kw)
    path = str(tmp_path / "cache.npz")
    jpe.save_proposal_cache(jcache, path)
    tcache = tpe.encode_proposal_corpus(model, tb, tw.corpus, ctx_bsz=4)
    loaded = tpe.load_proposal_cache(path, device="cpu")
    assert model.training
    P = jcache.prop_spans.shape[1]
    np.testing.assert_array_equal(tcache.prop_spans, jcache.prop_spans)
    np.testing.assert_array_equal(tcache.prop_mask.numpy(), np.asarray(jcache.prop_mask))
    for key in tpe.CACHE_KEYS:
        np.testing.assert_allclose(getattr(tcache, key).numpy(),
                                   np.asarray(getattr(jcache, key)), rtol=0, atol=2e-5)
    for cache in (tcache, loaded):
        got = tpe.cal_retrieve(model, tb, cache, tw.corpus, rows, **kw)
        (wv, ws, wsc), (gv, gs, gsc) = want["VCMR"], got["VCMR"]
        assert gv.shape == wv.shape == (len(rows), min(300, 9 * P))
        np.testing.assert_allclose(gsc, wsc, rtol=0, atol=1e-5)
        key = lambda v, s: (v * 1000 + s[..., 0] / 1.5) * 1000 + s[..., 1] / 1.5
        assert rank_mismatches(key(wv, ws), wsc, key(gv, gs), atol=2e-5) == 0
        (_, ws, wsc), (_, gs, gsc) = want["SVMR"], got["SVMR"]
        np.testing.assert_allclose(gsc, wsc, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(gs, ws)
    # the planted ties: equal distances inside the constant video's rows
    # and the pads' 1e10, ranked alike
    tied = (np.diff(wsc[:2], axis=1) == 0) & (wsc[:2, 1:] > -1e9)
    assert tied.any() and (wsc[:2] == -1e10).any()
    # the npz written by the port loads in JAX and scores alike there
    tpe.save_proposal_cache(tcache, path)
    back = jpe.cal_retrieve(jm, {"params": params}, jb, jpe.load_proposal_cache(path),
                            jw.corpus, rows, **kw)
    np.testing.assert_allclose(back["VCMR"][2], want["VCMR"][2], rtol=0, atol=1e-5)
    # the dict form
    sub = tpe.cal_retrieve(model, tb, tcache, tw.corpus, rows[:3], query_bsz=2)
    assert [e["desc_id"] for e in sub["VCMR"]] == [r["desc_id"] for r in rows[:3]]
    assert len(sub["SVMR"][0]["predictions"]) == min(200, P)


def _resize(mlp, in_dim):
    """The first Dense of a moment MLP cut to ``in_dim`` inputs (the
    engine's worlds drop the TEF features the fixture's have)."""
    return {**mlp, "Dense_0": {**mlp["Dense_0"], "kernel": mlp["Dense_0"]["kernel"][:in_dim]}}


def test_trainer_tracks_the_jax_generic_trainer():
    """train_cal's optimizer (SGD, momentum 0.95, weight decay, x0.1 after
    30 epochs of updates) on both trainers from the same weights: 31
    epochs of one step each cross the transition; the epoch losses and the
    final parameters agree. The JAX trainer builds one batch when it
    starts (its init batch), which draws from the CAL builder's generator,
    as does the parameters' shape batch: the port's builder draws the same
    batches first."""
    (jw, jb), (tw, tb) = _pair()
    jrows, trows = jw.annotations[:8], tw.annotations[:8]
    args = argparse.Namespace(bsz=8, lr=0.02, momentum=0.95, wd=1e-3, seed=5, device="cpu")
    jcfg, tcfg = _cfgs(jb)
    tx = optax.chain(optax.add_decayed_weights(args.wd),
                     optax.sgd(optax.exponential_decay(args.lr, transition_steps=30,
                                                       decay_rate=0.1, staircase=True),
                               momentum=args.momentum))
    # seeded parameters with non-zero biases: from flax's zero-bias init a
    # zero-padded clip's moment embedding is exactly zero, and jnp's norm
    # has a NaN gradient there (torch's has 0), which the mask's 0 does not
    # cancel: the JAX trainer's parameters turn NaN after its first step
    params = _params(jcfg, jb.build_train_batch(jrows[:2], jrows), seed=8)
    jtr = JaxTrainer({"params": params}, jc.CALWithSub(jcfg), tx,
                     lambda rows: jb.build_train_batch(rows, jrows), jrows, 8, args.seed,
                     loss_apply=lambda m, v, b, r, t: (*m.apply(v, **b), {}), rng_names=())
    ttr = train_cal.make_trainer(args, tcfg, tb, trows)
    tb.build_train_batch(trows[:2], trows)
    ttr.build_fn(trows)
    ttr.model.load_state_dict(flax_params_to_state_dict(params), strict=True)
    for epoch in range(31):
        jl, tl = jtr.train_epoch(epoch), ttr.train_epoch(epoch)
        assert abs(jl["loss"] - tl["loss"]) <= 1e-4, (epoch, jl, tl)
    assert ttr.optimizer.param_groups[0]["lr"] == pytest.approx(args.lr * 0.1)
    want = flax_params_to_state_dict(jax.device_get(jtr.params))
    for k, v in ttr.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0, atol=2e-5, err_msg=k)


def test_bf16_forward_matches_the_jax_bf16_model(setup):
    """The moment embeddings, the query embedding and the three distances
    at bf16 compute against the JAX bf16 model compiled with
    ``xla_allow_excess_precision=False``. Cast points on the way to a
    distance: the LSTM's 8 a step over LQ = 6 steps (tests/test_torch_rnn.py's
    bound: 8 * L bf16 steps at most), the query Dense and its norm (3), a
    moment MLP's two Dense (4), its norm and the squared difference's sum
    (3): N_CAST = 8 * LQ + 10 bf16 steps of the largest value at most. The
    moment MLP alone rounds as flax does (the same value at each cast up to
    summation order): within 2 bf16 steps, and ten times closer than the
    float32 port (the negative control). The bf16 LSTM has none: XLA expands
    its gates with a rounding after each op (tests/test_torch_rnn.py)."""
    jcfg, tcfg, params, batch, _ = setup
    jcfg = jc.CALConfig(**{**jcfg.__dict__, "dtype_str": "bfloat16"})
    m = jc.CALWithSub(jcfg)
    keys = ("pos", "intra", "inter")

    def run(p, b):
        v = {"params": p}
        q = m.apply(v, b["query_feat"], b["query_mask"], method=jc.CALWithSub.encode_query)
        emb = [m.apply(v, b["pos_video_feat"], "video", method=jc.CALWithSub.encode_moments),
               m.apply(v, b["pos_sub_feat"], "sub", method=jc.CALWithSub.encode_moments)]
        return [x.astype(jnp.float32) for x in emb + [q]] + [
            m.apply(v, q, b[f"{k}_video_feat"], b[f"{k}_sub_feat"], b[f"{k}_mask"],
                    method=jc.CALWithSub.compute_pdist) for k in keys]

    want = [np.asarray(x) for x in jax.jit(run).lower(params, batch).compile(
        compiler_options={"xla_allow_excess_precision": False})(params, batch)]
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    errs = {}
    for dtype_str in ("bfloat16", "float32"):
        model = _port(tc.CALConfig(**{**tcfg.__dict__, "dtype_str": dtype_str}), params)
        with torch.no_grad():
            q = model.encode_query(tb["query_feat"], tb["query_mask"])
            got = [model.encode_moments(tb["pos_video_feat"], "video"),
                   model.encode_moments(tb["pos_sub_feat"], "sub"), q] + [
                model.compute_pdist(q, tb[f"{k}_video_feat"], tb[f"{k}_sub_feat"],
                                    tb[f"{k}_mask"]) for k in keys]
        errs[dtype_str] = [np.abs(g.float().numpy() - w).max() / np.abs(w).max()
                           for g, w in zip(got, want)]
    u = 2.0 ** -8
    assert max(errs["bfloat16"]) <= (8 * LQ + 10) * u, errs
    assert max(errs["bfloat16"][:2]) <= 2 * u, errs
    assert max(errs["bfloat16"][:2]) < min(errs["float32"][:2]) / 10, errs
