"""The port's ExCL (models/excl.py), its engines (retrieval/excl_engine.py)
and train_excl's trainer against the JAX package on the same seeded numpy
inputs and converted weights.

The JAX scan-LSTMs (five of them: the query encoder and two per stream)
are compiled here only, at the smallest shapes, once per program in
module-scoped jitted functions (XLA:CPU has been seen to crash compiling
the scan in long processes, VERDICT.md; a file of its own keeps such a
crash to this file): the forward with its gradients, the two engines'
programs, the trainer's step and the bf16 forward. Dropout draws from
torch's generator, not JAX's PRNG, so parity runs without it (eval mode,
``drop=0``). Tolerances: f32 logits, losses and probabilities within 2e-4,
gradients within 2e-4 of each tensor's largest entry, engine scores within
1e-5 with rankings equal outside near-ties, the trainer's epoch losses
within 1e-4 and its parameters within 2e-5 but where Adam normalizes a
round-off gradient (argued in the trainer test)."""
import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _baseline_pairs import JaxTrainer, one_torch_thread  # noqa: F401
from tvretrieval_tpu.data.datasets import ExampleBuilder as JExampleBuilder
from tvretrieval_tpu.data.synthetic import make_synthetic_world as j_make_world
from tvretrieval_tpu.models import excl as jx
from tvretrieval_tpu.retrieval import excl_engine as jee
from tvretrieval_tpu_torch.convert import flax_params_to_state_dict
from tvretrieval_tpu_torch.data.datasets import ExampleBuilder
from tvretrieval_tpu_torch.data.synthetic import make_synthetic_world
from tvretrieval_tpu_torch.models import excl as tx
from tvretrieval_tpu_torch.retrieval import excl_engine as tee
from tvretrieval_tpu_torch.testing import rank_mismatches
from tvretrieval_tpu_torch.training import train_excl

WORLD = dict(n_videos=8, n_queries=24, vid_dim=6, text_dim=5, max_clips=8, seed=2,
             query_dim=7)
LQ, LC, HIDDEN = 6, 8, 8


def _pair():
    out = []
    for make, cls in ((j_make_world, JExampleBuilder), (make_synthetic_world, ExampleBuilder)):
        w = make(**WORLD)
        out.append((w, cls(query_source=w.query_source, video_source=w.video_source,
                           sub_source=w.sub_source, ctx_mode="video_sub_tef", max_desc_l=LQ,
                           max_ctx_l=LC, clip_length=w.clip_length)))
    return out


def _cfgs(drop=0.0, dtype_str="float32", ctx_mode="video_sub"):
    kw = dict(ctx_mode=ctx_mode, visual_input_size=WORLD["vid_dim"] + 2,
              sub_input_size=WORLD["text_dim"] + 2, query_input_size=WORLD["query_dim"],
              hidden_size=HIDDEN, drop=drop, dtype_str=dtype_str)
    return jx.ExCLConfig(**kw), tx.ExCLConfig(**kw)


def _params(jcfg, batch, seed=1):
    """Seeded flax parameters: kernels N(0, 1/fan_in), biases N(0, 0.1^2)."""
    shapes = jax.eval_shape(lambda b: jx.ExCL(jcfg).init(jax.random.PRNGKey(0), **b,
                                                          deterministic=True), batch)["params"]
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        n = rng.standard_normal(leaf.shape).astype(np.float32)
        return n / np.sqrt(leaf.shape[0]) if path[-1].key == "kernel" else 0.1 * n

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _port(tcfg, params):
    m = tx.ExCL(tcfg)
    m.load_state_dict(flax_params_to_state_dict(params), strict=True)
    return m


@pytest.fixture(scope="module")
def setup():
    (jw, jb), (tw, tb) = _pair()
    batch = jb.build_train_batch(jw.annotations[:6]).model_inputs()
    tbatch = tb.build_train_batch(tw.annotations[:6]).model_inputs()
    for k in batch:
        np.testing.assert_array_equal(batch[k], tbatch[k], err_msg=k)
    jcfg, tcfg = _cfgs()
    return dict(jw=jw, jb=jb, tw=tw, tb=tb, jcfg=jcfg, tcfg=tcfg, batch=batch,
                params=_params(jcfg, batch))


def test_forward_logits_and_gradients_match_jax(setup):
    """One jitted program on the JAX side: the span loss, its gradients and
    the span logits (row 1 has a single clip, so masked logits appear)."""
    jcfg, tcfg, params, batch = (setup[k] for k in ("jcfg", "tcfg", "params", "batch"))
    m = jx.ExCL(jcfg)

    def run(p, b):
        (loss, _), grads = jax.value_and_grad(
            lambda q: m.apply({"params": q}, **b, deterministic=True), has_aux=True)(p)
        st, ed = m.apply({"params": p}, *(b[k] for k in tee.BATCH_KEYS),
                         method=jx.ExCL.span_logits)
        return loss, grads, st, ed

    loss, grads, st, ed = jax.jit(run)(params, batch)
    model = _port(tcfg, params).eval()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got, aux = model(**tb)
    got.backward()
    assert aux["loss_st_ed"] is got
    np.testing.assert_allclose(got.item(), float(loss), rtol=0, atol=2e-4)
    jgrads = flax_params_to_state_dict(jax.device_get(grads))
    assert {k for k, _ in model.named_parameters()} == set(jgrads)
    for k, p in model.named_parameters():
        want = jgrads[k].numpy()
        if k.endswith("bias_ih_l0"):          # flax's cell has no input bias
            assert (p.grad == 0).all() and (want == 0).all(), k
            continue
        scale = np.abs(want).max()
        if k.endswith("predictor.Dense_1.bias"):
            # one shift of every logit of a row: the softmax ignores it, so
            # both sides hold round-off only
            assert scale < 1e-6 and np.abs(p.grad.numpy()).max() < 1e-6, k
            continue
        assert scale > 1e-6, k
        assert np.abs(p.grad.numpy() - want).max() <= 2e-4 * scale, k
    with torch.no_grad():
        tst, ted = model.span_logits(*(tb[k] for k in tee.BATCH_KEYS))
    for a, b in ((tst, st), (ted, ed)):
        b = np.asarray(b)
        assert ((b == -1e10) == (a.numpy() == -1e10)).all() and (b == -1e10).any()
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=2e-4)


def test_dropout_draws_from_the_generator(setup):
    jcfg, tcfg, params, batch = (setup[k] for k in ("jcfg", "tcfg", "params", "batch"))
    model = _port(tx.ExCLConfig(**{**tcfg.__dict__, "drop": 0.5}), params).train()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    g = lambda s: torch.Generator().manual_seed(s)
    a, b, c = (model(**tb, generator=g(s))[0] for s in (1, 1, 2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    with torch.no_grad():
        assert not torch.equal(a, model.eval()(**tb)[0])
    x = torch.ones(4000)
    y = tx.dropout(x, 0.25, True, g(3))
    assert set(y.unique().tolist()) == {0.0, float(np.float32(1 / 0.75))}
    assert abs((y == 0).float().mean() - 0.25) < 0.03
    assert tx.dropout(x, 0.25, False, g(3)) is x


def test_svmr_engine_matches_jax(setup):
    s = setup
    jm, model = jx.ExCL(s["jcfg"]), _port(s["tcfg"], s["params"]).train()
    kw = dict(clip_length=s["jw"].clip_length, query_bsz=7, min_pred_l=1, max_pred_l=5,
              max_before_nms=20)
    rows = s["jw"].annotations[:14]
    want = jee.excl_retrieve_svmr(jm, {"params": s["params"]}, s["jb"], s["jw"].corpus, rows,
                                  **kw)["SVMR"]
    got = tee.excl_retrieve_svmr(model, s["tb"], s["tw"].corpus, rows, **kw)["SVMR"]
    assert model.training
    _assert_same_predictions(want, got)


def _assert_same_predictions(want, got):
    assert [e["desc_id"] for e in want] == [e["desc_id"] for e in got]
    for a, b in zip(want, got):
        pa, pb = np.asarray(a["predictions"]), np.asarray(b["predictions"])
        assert pa.shape == pb.shape and len(pa)
        np.testing.assert_allclose(pb[:, 3], pa[:, 3], rtol=0, atol=1e-5)
        key = lambda p: (p[:, 0] * 1000 + p[:, 1] / 1.5) * 1000 + p[:, 2] / 1.5
        assert rank_mismatches(key(pa), pa[:, 3], key(pb), atol=2e-5) == 0


def test_vcmr_with_external_vr_matches_jax(setup, tmp_path):
    """Four candidate videos a query from a VR submission; two of them tie
    on their VR score and on every span (the same video twice), which the
    stable merge keeps in the submission's order; one query has no
    candidates."""
    s = setup
    jm, model = jx.ExCL(s["jcfg"]), _port(s["tcfg"], s["params"])
    rows = s["jw"].annotations[:5]
    rng = np.random.default_rng(5)
    vr = []
    for qi, r in enumerate(rows[:-1]):
        vids = rng.choice(WORLD["n_videos"], 4, replace=False).tolist()
        vids[3] = vids[2]
        sc = np.sort(rng.uniform(0.2, 0.8, 4))[::-1]
        sc[3] = sc[2]
        vr.append({"desc_id": r["desc_id"], "desc": "",
                   "predictions": [[v, 0, 0, float(x)] for v, x in zip(vids, sc)]})
    path = str(tmp_path / "vr.json")
    with open(path, "w") as f:
        json.dump({"VR": vr}, f)
    kw = dict(clip_length=s["jw"].clip_length, top_n_videos=4, q2c_alpha=5.0, min_pred_l=1,
              max_pred_l=5, top_n_per_video=6, max_before_nms=30)
    want = jee.excl_retrieve_vcmr_with_external_vr(jm, {"params": s["params"]}, s["jb"],
                                                   s["jw"].corpus, rows, path, **kw)["VCMR"]
    got = tee.excl_retrieve_vcmr_with_external_vr(model, s["tb"], s["tw"].corpus, rows, path,
                                                  **kw)["VCMR"]
    assert want[-1]["predictions"] == got[-1]["predictions"] == []
    _assert_same_predictions(want[:-1], got[:-1])
    for e in got[:-1]:             # the twin video's spans follow its first copy's
        p = np.asarray(e["predictions"])
        assert len(p) == 24 and (np.diff(p[:, 3]) <= 0).all()


def test_trainer_tracks_the_jax_generic_trainer(setup):
    """train_excl's optimizer (Adam, constant rate) with dropout 0 on both
    trainers from the same weights: 2 epochs of 3 steps, on the video
    stream alone (three LSTMs: the step's compile is the file's largest)."""
    s = setup
    jcfg, tcfg = _cfgs(ctx_mode="video")
    params = _params(jcfg, s["batch"], seed=3)
    args = argparse.Namespace(bsz=6, lr=1e-3, seed=4, device="cpu")        # the CLI default rate
    jrows, trows = s["jw"].annotations[:18], s["tw"].annotations[:18]
    jtr = JaxTrainer({"params": params}, jx.ExCL(jcfg), optax.adam(args.lr),
                     lambda rows: s["jb"].build_train_batch(rows).model_inputs(), jrows,
                     args.bsz, args.seed, rng_names=("dropout",))
    ttr = train_excl.make_trainer(args, tcfg, s["tb"], trows)
    ttr.model.load_state_dict(flax_params_to_state_dict(params), strict=True)
    for epoch in range(2):
        jl, tl = jtr.train_epoch(epoch), ttr.train_epoch(epoch)
        assert jl.keys() == tl.keys()
        for k in jl:
            assert abs(jl[k] - tl[k]) <= 1e-4, (epoch, k, jl[k], tl[k])
    assert ttr.global_step == 6
    assert ttr.last_step_losses[0]["loss"] != ttr.last_step_losses[-1]["loss"]
    # Adam's first step moves every element by lr * sign(g): an element
    # whose gradient is at round-off level (|g| ~ 1e-8 of a largest 2e-2
    # here) may step differently on the two sides, by up to 2 lr a step.
    # Every element stays within that; all but a few within 2e-5; and the
    # trained models agree on held-out rows within 2e-4.
    want = flax_params_to_state_dict(jax.device_get(jtr.params))
    far = total = 0
    for k, v in ttr.model.state_dict().items():
        d = np.abs(v.numpy() - want[k].numpy())
        assert d.max() <= 2 * 6 * args.lr, k
        if not k.endswith("predictor.Dense_1.bias"):   # no gradient, see above
            far, total = far + int((d > 2e-5).sum()), total + d.size
    assert far <= 0.01 * total, (far, total)
    held = s["jb"].build_train_batch(s["jw"].annotations[18:24]).model_inputs()
    jloss = jax.jit(lambda p, b: jx.ExCL(jcfg).apply({"params": p}, **b, deterministic=True)[0])(
        jax.device_get(jtr.params), held)
    with torch.no_grad():
        tloss = ttr.model.eval()(**{k: torch.from_numpy(v) for k, v in held.items()})[0]
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=0, atol=2e-4)


def test_bf16_forward_matches_the_jax_bf16_model(setup):
    """Span logits at bf16 compute against the JAX bf16 model compiled with
    ``xla_allow_excess_precision=False``. On the way to a logit: the query
    LSTM over LQ steps and the two context LSTMs over LC steps each (8 cast
    points a step: tests/test_torch_rnn.py's bound of 8 * L bf16 steps),
    then a span predictor's two Dense and its tanh (5): N_CAST = 8 * (LQ +
    2 * LC) + 5 bf16 steps of the largest logit at most. The predictor
    alone on the same float32 features rounds as flax does: within 2 bf16
    steps, and ten times closer than the float32 predictor (the negative
    control; the bf16 LSTMs have none, tests/test_torch_rnn.py)."""
    s = setup
    jcfg, _ = _cfgs(dtype_str="bfloat16")
    batch, params = s["batch"], s["params"]
    m = jx.ExCL(jcfg)
    feat = np.random.default_rng(6).normal(size=(6, LC, 3 * HIDDEN)).astype(np.float32)

    def run(p, b, f):
        st, ed = m.apply({"params": p}, *(b[k] for k in tee.BATCH_KEYS),
                         method=jx.ExCL.span_logits)
        pred = jx.SpanPredictor(HIDDEN, jnp.bfloat16).apply(
            {"params": p["video_st_predictor"]}, f)
        return st, ed, pred.astype(jnp.float32)

    want = [np.asarray(x, np.float32) for x in jax.jit(run).lower(params, batch, feat).compile(
        compiler_options={"xla_allow_excess_precision": False})(params, batch, feat)]
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    errs = {}
    for dtype_str in ("bfloat16", "float32"):
        model = _port(_cfgs(dtype_str=dtype_str)[1], params).eval()
        with torch.no_grad():
            got = list(model.span_logits(*(tb[k] for k in tee.BATCH_KEYS)))
            got.append(model.video_st_predictor(torch.from_numpy(feat)))
        keep = want[0] > -1e9
        errs[dtype_str] = [np.abs(g.float().numpy()[keep] - w[keep]).max()
                           / np.abs(w[keep]).max() for g, w in zip(got[:2], want[:2])]
        errs[dtype_str].append(np.abs(got[2].float().numpy() - want[2]).max()
                               / np.abs(want[2]).max())
    u = 2.0 ** -8
    assert max(errs["bfloat16"]) <= (8 * (LQ + 2 * LC) + 5) * u, errs
    assert errs["bfloat16"][2] <= 2 * u and errs["bfloat16"][2] < errs["float32"][2] / 10, errs
