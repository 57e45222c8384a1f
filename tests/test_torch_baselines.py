"""The port's MEE (models/mee.py), its VR engine (retrieval/vr_engine.py),
the generic trainer (training/generic.py) under train_mee's optimizer, and
the converter's BatchNorm / NetVLAD maps, against the JAX package on the
same seeded numpy inputs and converted weights.

Tolerances: f32 forwards, losses and BatchNorm statistics within 2e-4 (the
bound the JAX package meets against the reference); gradients within 2e-4
of each tensor's largest entry; engine scores within 1e-5 with indices
equal outside near-ties; the trainer's epoch losses within 1e-4 and its
parameters within 2e-5 after the steps (the bounds of
tests/test_torch_trainer.py). No JAX scan-RNN is compiled here: MEE has
none (CAL and ExCL are in tests/test_torch_baselines_rnn.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _baseline_pairs import JaxTrainer, one_torch_thread  # noqa: F401
from tvretrieval_tpu.data import retrieval_datasets as jrd
from tvretrieval_tpu.data.synthetic import make_synthetic_world as j_make_world
from tvretrieval_tpu.models import mee as jm
from tvretrieval_tpu.retrieval import vr_engine as jvr
from tvretrieval_tpu_torch.convert import flax_params_to_state_dict, flax_variables_to_state_dict
from tvretrieval_tpu_torch.data import retrieval_datasets as trd
from tvretrieval_tpu_torch.data.synthetic import make_synthetic_world
from tvretrieval_tpu_torch.models import mee as tm
from tvretrieval_tpu_torch.retrieval import vr_engine as tvr
from tvretrieval_tpu_torch.testing import rank_mismatches
from tvretrieval_tpu_torch.training.generic import GenericTrainer, staircase_decay
from tvretrieval_tpu_torch.training.train_mee import mee_loss_apply

DQ, DV, DS, OUT = 12, 10, 6, 8
N, LQ = 6, 5


def _batch(seed=0, n=N):
    rng = np.random.default_rng(seed)
    qm = (np.arange(LQ)[None] < rng.integers(1, LQ + 1, size=n)[:, None]).astype(np.float32)
    return dict(query_feat=rng.normal(size=(n, LQ, DQ)).astype(np.float32), query_mask=qm,
                video_feat=rng.normal(size=(n, DV)).astype(np.float32),
                sub_feat=rng.normal(size=(n, DS)).astype(np.float32))


def _cfgs(ctx_mode="video_sub", dtype_str="float32"):
    j = jm.MEEConfig(ctx_mode=ctx_mode, text_input_size=DQ, vid_input_size=DV,
                     output_size=OUT, dtype_str=dtype_str)
    t = tm.MEEConfig(ctx_mode=ctx_mode, text_input_size=DQ, vid_input_size=DV,
                     sub_input_size=DS, output_size=OUT, dtype_str=dtype_str)
    return j, t


def _variables(jcfg, batch, seed=1):
    """Seeded numpy variables in the flax tree: kernels N(0, 1/fan_in),
    BatchNorm scales 1 + N(0, 0.1^2), biases N(0, 0.1^2), the NetVLAD
    clusters N(0, 1/D), running means N(0, 0.1^2) and variances in
    [0.5, 1.5]."""
    shapes = jax.eval_shape(lambda b: jm.MEE(jcfg).init(jax.random.PRNGKey(0), **b), batch)
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        n = rng.standard_normal(leaf.shape).astype(np.float32)
        if name == "kernel":
            return n / np.sqrt(leaf.shape[0])
        if name in ("clusters", "clusters2"):
            return n / np.sqrt(DQ)
        if name == "scale":
            return 1.0 + 0.1 * n
        if name == "var":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return 0.1 * n

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _port(tcfg, variables):
    model = tm.MEE(tcfg)
    model.load_state_dict(flax_variables_to_state_dict(variables), strict=True)
    return model


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("ctx_mode", ["video_sub", "video", "sub"])
def test_train_step_loss_and_running_stats_match_flax(ctx_mode):
    """Train mode: batch statistics normalize, and the running statistics
    move by flax's rule (momentum 0.99) with the biased batch variance,
    where torch's BatchNorm1d takes the unbiased one."""
    jcfg, tcfg = _cfgs(ctx_mode)
    batch = _batch()
    variables = _variables(jcfg, batch)
    loss, new_state = jm.MEE(jcfg).apply(variables, **batch, train=True,
                                         mutable=["batch_stats"])
    model = _port(tcfg, variables).train()
    got = model(**_t(batch))
    np.testing.assert_allclose(got.item(), float(loss), rtol=0, atol=2e-4)
    want = flax_variables_to_state_dict({"params": variables["params"], **new_state})
    state = model.state_dict()
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * (1 + 2 * (("video" in ctx_mode) + ("sub" in ctx_mode)))
    moved = 0.0
    for k in stats:
        np.testing.assert_allclose(state[k].numpy(), want[k].numpy(), rtol=0, atol=2e-4,
                                   err_msg=k)
        before = flax_variables_to_state_dict(variables)[k].numpy()
        moved = max(moved, np.abs(want[k].numpy() - before).max())
    assert moved > 1e-3
    assert all(int(state[k.replace("running_mean", "num_batches_tracked")]) == 1
               for k in stats if k.endswith("running_mean"))
    # the batch variance each update took, (ra_new - 0.99 ra_old) / 0.01,
    # at the query unit's gate BN (N = 6 rows): the biased one, which is
    # (n - 1) / n = 5/6 of the unbiased one torch's BatchNorm1d would take
    unit = "video_query_gu" if "video" in ctx_mode else "sub_query_gu"
    fresh = getattr(_port(tcfg, variables).train(), unit)
    with torch.no_grad():
        pooled = _port(tcfg, variables).train().pool_query(torch.from_numpy(batch["query_feat"]))
        x = fresh.ContextGating_0.Dense_0(fresh.Dense_0(pooled))
    key = f"{unit}.ContextGating_0.bn.running_var"
    before = flax_variables_to_state_dict(variables)[key].numpy()
    took = lambda ra: (ra - 0.99 * before) / 0.01
    biased, unbiased = x.var(0, unbiased=False).numpy(), x.var(0, unbiased=True).numpy()
    for ra in (want[key].numpy(), state[key].numpy()):
        np.testing.assert_allclose(took(ra), biased, rtol=0, atol=1e-3)
        assert np.abs(took(ra) - unbiased).max() > 10 * np.abs(took(ra) - biased).max()


def test_eval_mode_matches_flax_and_ignores_the_query_mask():
    jcfg, tcfg = _cfgs()
    batch = _batch(3)
    variables = _variables(jcfg, batch)
    m = jm.MEE(jcfg)
    pooled = m.apply(variables, batch["query_feat"], False, method=jm.MEE.pool_query)
    ev, es = m.apply(variables, batch["video_feat"], batch["sub_feat"], False,
                     method=jm.MEE.encode_context)
    scores = m.apply(variables, pooled, ev, es, False, method=jm.MEE.scores)
    model = _port(tcfg, variables).eval()
    tb = _t(batch)
    with torch.no_grad():
        tp = model.pool_query(tb["query_feat"])
        tev, tes = model.encode_context(tb["video_feat"], tb["sub_feat"])
        ts = model.scores(tp, tev, tes)
        # padded tokens count, the mask does not: a zero mask leaves the loss
        a = model(**tb)
        b = model(**{**tb, "query_mask": torch.zeros_like(tb["query_mask"])})
    for got, want in ((tp, pooled), (tev, ev), (tes, es), (ts, scores)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-4)
    assert torch.equal(a, b)
    # eval mode leaves the running statistics where they are
    assert all(int(v) == 0 for k, v in model.state_dict().items()
               if k.endswith("num_batches_tracked"))


def test_gradients_match_jax_grad():
    jcfg, tcfg = _cfgs()
    batch = _batch(5)
    variables = _variables(jcfg, batch)

    def loss_fn(p):
        return jm.MEE(jcfg).apply({**variables, "params": p}, **batch, train=True,
                                  mutable=["batch_stats"])[0]

    jgrads = flax_params_to_state_dict(jax.device_get(jax.grad(loss_fn)(variables["params"])))
    model = _port(tcfg, variables).train()
    model(**_t(batch)).backward()
    names = {k for k, _ in model.named_parameters()}
    assert names == set(jgrads)
    for k, p in model.named_parameters():
        want = jgrads[k].numpy()
        scale = np.abs(want).max()
        if k.endswith("ContextGating_0.Dense_0.bias"):
            # train-mode BatchNorm subtracts the batch mean, so the bias
            # before it has no gradient: both sides hold round-off only
            assert scale < 1e-6 and np.abs(p.grad.numpy()).max() < 1e-6, k
            continue
        assert scale > 1e-6, k
        assert np.abs(p.grad.numpy() - want).max() <= 2e-4 * scale, k


@pytest.mark.parametrize("margin", [0.2, 0.0])
def test_max_margin_ranking_loss_matches(margin):
    rng = np.random.default_rng(2)
    # one decimal: ties within rows and columns, and the diagonal among them
    scores = np.round(rng.uniform(-1, 1, size=(7, 7)), 1).astype(np.float32)
    want = float(jm.max_margin_ranking_loss(jnp.asarray(scores), margin))
    got = tm.max_margin_ranking_loss(torch.from_numpy(scores), margin).item()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_bf16_forward_matches_the_jax_bf16_model():
    """Both round to bf16 at flax's cast points: the five Dense products
    and bias adds (the unit's Dense, the gate's Dense, per stream and for
    the query, and the MoE weights), N_CAST = 2 * 5 = 10 on the way to a
    score; BatchNorm returns float32 and NetVLAD ignores the dtype. As in
    tests/test_torch_xml_bf16.py, float32 summation order moves a value
    across a bf16 boundary with chance <= u = 2^-8 per cast, and then by a
    bf16 step: no output is further than N_CAST bf16 steps off. Negative
    control: the float32 port against the JAX bf16 model is further."""
    jcfg, tcfg = _cfgs(dtype_str="bfloat16")
    batch = _batch(7)
    variables = _variables(jcfg, batch)
    m = jm.MEE(jcfg)

    def run(v, b):
        pooled = m.apply(v, b["query_feat"], False, method=jm.MEE.pool_query)
        ev, es = m.apply(v, b["video_feat"], b["sub_feat"], False,
                         method=jm.MEE.encode_context)
        return m.apply(v, pooled, ev, es, False, method=jm.MEE.scores)

    want = np.asarray(jax.jit(run).lower(variables, batch).compile(
        compiler_options={"xla_allow_excess_precision": False})(variables, batch),
        np.float32)
    tb = _t(batch)
    outs = {}
    for dtype_str in ("bfloat16", "float32"):
        model = _port(_cfgs(dtype_str=dtype_str)[1], variables).eval()
        with torch.no_grad():
            ev, es = model.encode_context(tb["video_feat"], tb["sub_feat"])
            outs[dtype_str] = model.scores(model.pool_query(tb["query_feat"]), ev, es).float()
    bound = 10 * 2 * 2.0 ** -8 * np.abs(want).max()
    err = np.abs(outs["bfloat16"].numpy() - want).max()
    assert err <= bound, (err, bound)
    assert np.abs(outs["float32"].numpy() - want).max() > err


def _vr_world():
    kw = dict(n_videos=23, n_queries=30, vid_dim=DV, text_dim=DS, max_clips=9, seed=4,
              query_dim=DQ)
    out = []
    for make, rd in ((j_make_world, jrd), (make_synthetic_world, trd)):
        w = make(**kw)
        out.append((w, rd.MEEExampleBuilder(
            query_source=w.query_source, video_source=w.video_source,
            sub_source=w.sub_source, max_desc_l=LQ, max_ctx_l=9)))
    return out


@pytest.mark.parametrize("topk", [10, 100])
def test_vr_engine_matches_jax(topk):
    """mee_retrieve_vr on a synthetic world: scores within 1e-5, the ranking
    equal outside near-ties, ties planted by two copies of a video's
    features (equal scores, the lower index first); topk past the corpus
    clamps to it. Both submission forms."""
    (jw, jb), (tw, tb) = _vr_world()
    for w in (jw, tw):        # video 5 is a copy of video 2: exact ties
        for src in (w.video_source, w.sub_source):
            src._table[w.corpus.vid_names[5]] = src._table[w.corpus.vid_names[2]]
    jcfg, tcfg = _cfgs()
    qb = jb.build_query_batch(jw.annotations[:N])
    variables = _variables(jcfg, dict(query_feat=qb["query_feat"], query_mask=qb["query_mask"],
                                      video_feat=np.zeros((N, DV), np.float32),
                                      sub_feat=np.zeros((N, DS), np.float32)))
    kw = dict(ctx_bsz=7, query_bsz=8, topk=topk, return_arrays=True)
    want_vid, want_s = jvr.mee_retrieve_vr(jm.MEE(jcfg), variables, jb, jw.corpus,
                                           jw.annotations, **kw)["VR"]
    model = _port(tcfg, variables).train()      # the engine runs it in eval mode
    got_vid, got_s = tvr.mee_retrieve_vr(model, tb, tw.corpus, tw.annotations, **kw)["VR"]
    assert model.training
    assert got_vid.shape == want_vid.shape == (30, min(topk, 23))
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=1e-5)
    assert rank_mismatches(want_vid, want_s, got_vid, atol=2e-5) == 0
    p2, p5 = np.argmax(got_vid == 2, axis=1), np.argmax(got_vid == 5, axis=1)
    both = (got_vid == 2).any(axis=1) & (got_vid == 5).any(axis=1)
    assert both.any() and (p5[both] == p2[both] + 1).all()
    assert not ((got_vid == 5).any(axis=1) & ~both).any()
    sub = tvr.mee_retrieve_vr(model, tb, tw.corpus, tw.annotations[:4], ctx_bsz=7,
                              query_bsz=3, topk=topk)["VR"]
    assert [e["desc_id"] for e in sub] == [r["desc_id"] for r in tw.annotations[:4]]
    assert [p[0] for p in sub[0]["predictions"]] == got_vid[0].tolist()


def test_trainer_tracks_the_jax_generic_trainer():
    """train_mee's optimizer (Adam, x0.95 every epoch of updates) on both
    trainers from the same weights: 3 epochs of 3 steps, so the rate steps
    down twice; the epoch losses and the final parameters and running
    statistics agree."""
    world = j_make_world(n_videos=12, n_queries=40, vid_dim=DV, text_dim=DS, max_clips=9,
                         seed=6, query_dim=DQ)
    jb = jrd.MEEExampleBuilder(query_source=world.query_source, video_source=world.video_source,
                               sub_source=world.sub_source, max_desc_l=LQ, max_ctx_l=9)
    tworld = make_synthetic_world(n_videos=12, n_queries=40, vid_dim=DV, text_dim=DS,
                                  max_clips=9, seed=6, query_dim=DQ)
    tb = trd.MEEExampleBuilder(query_source=tworld.query_source,
                               video_source=tworld.video_source,
                               sub_source=tworld.sub_source, max_desc_l=LQ, max_ctx_l=9)
    rows, trows, bsz, lr, seed = world.annotations[:30], tworld.annotations[:30], 8, 3e-3, 3
    spe = len(rows) // bsz
    jcfg, tcfg = _cfgs()
    tx = optax.adam(optax.exponential_decay(lr, transition_steps=spe, decay_rate=0.95,
                                            staircase=True))

    def loss_apply(model, variables, batch, rngs, train):
        loss, new_state = model.apply(variables, **batch, train=train,
                                      mutable=["batch_stats"], rngs=rngs)
        return loss, {"loss_overall": loss}, new_state

    variables = _variables(jcfg, jb.build_train_batch(rows[:bsz]))
    jtr = JaxTrainer(variables, jm.MEE(jcfg), tx, jb.build_train_batch, rows, bsz, seed,
                     loss_apply=loss_apply, rng_names=())
    ttr = GenericTrainer(tm.MEE(tcfg), lambda ps: torch.optim.Adam(ps, lr=lr),
                         tb.build_train_batch, trows, bsz, seed, loss_apply=mee_loss_apply,
                         lr_multiplier=staircase_decay(spe, 0.95), device="cpu")
    ttr.model.load_state_dict(flax_variables_to_state_dict(jax.device_get(jtr.variables())),
                              strict=True)
    for epoch in range(3):
        jl, tl = jtr.train_epoch(epoch), ttr.train_epoch(epoch)
        assert jl.keys() == tl.keys()
        for k in jl:
            assert abs(jl[k] - tl[k]) <= 1e-4, (epoch, k, jl[k], tl[k])
    assert ttr.global_step == 9 == 3 * spe
    assert ttr.optimizer.param_groups[0]["lr"] == pytest.approx(lr * 0.95 ** 3)
    assert ttr.last_step_losses[0]["loss"] != ttr.last_step_losses[-1]["loss"]
    want = flax_variables_to_state_dict(jax.device_get(jtr.variables()))
    for k, v in ttr.model.state_dict().items():
        if k.endswith("num_batches_tracked"):       # torch's count; flax keeps none
            assert int(v) == 9, k
            continue
        if k.endswith(("ContextGating_0.Dense_0.bias", "ContextGating_0.bn.running_mean")):
            # the bias has no gradient but round-off (test_gradients_match_
            # jax_grad), which Adam scales up to steps of at most about the
            # learning rate on either side; the BN's running mean averages
            # it in. Each drifts by at most 2 * lr a step between the two
            assert np.abs(v.numpy() - want[k].numpy()).max() <= 2 * 9 * lr, k
            continue
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0, atol=2e-5, err_msg=k)


def test_converter_maps_batch_stats_and_raw_clusters():
    """``clusters`` (D, K) and ``clusters2`` (1, D, K) are raw parameters,
    copied as they are (a square D = K kernel would hide a transpose);
    ``batch_stats`` map to the running buffers with a zero count; other
    collections and leaves are refused."""
    rng = np.random.default_rng(0)
    c, c2 = rng.normal(size=(3, 3)), rng.normal(size=(1, 3, 3))
    mean, var = rng.normal(size=3), rng.uniform(0.5, 1, 3)
    sd = flax_variables_to_state_dict({
        "params": {"pool": {"clusters": c, "clusters2": c2, "bn": {"scale": var, "bias": mean}}},
        "batch_stats": {"pool": {"bn": {"mean": mean, "var": var}}}})
    np.testing.assert_array_equal(sd["pool.clusters"].numpy(), c.astype(np.float32))
    np.testing.assert_array_equal(sd["pool.clusters2"].numpy(), c2.astype(np.float32))
    np.testing.assert_array_equal(sd["pool.bn.weight"].numpy(), var.astype(np.float32))
    np.testing.assert_array_equal(sd["pool.bn.running_mean"].numpy(), mean.astype(np.float32))
    np.testing.assert_array_equal(sd["pool.bn.running_var"].numpy(), var.astype(np.float32))
    assert sd["pool.bn.num_batches_tracked"].dtype == torch.long
    assert int(sd["pool.bn.num_batches_tracked"]) == 0
    with pytest.raises(ValueError, match="collections"):
        flax_variables_to_state_dict({"params": {}, "cache": {}})
    with pytest.raises(ValueError, match="batch_stats leaf"):
        flax_variables_to_state_dict({"params": {}, "batch_stats": {"bn": {"mu": mean}}})
