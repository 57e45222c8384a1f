"""The approximate top-k of the port (ops/approx_topk.py; kernel B11 on the
card, its plain version here) and the approximate engine modes it serves.

Held:
- ``reduction_output_size`` equal to jaxlib's
  ``approx_top_k_reduction_output_size`` (without aggregation to top-k) on
  a grid of n, k, recall and rank, the engine's five sites among them;
- the plain version equal to a numpy model of the bin map (bin b holds the
  elements j % M == b) and the tie rule (a bin keeps its first maximum;
  ties between bins by bin index; output by value, then element index;
  -0.0 ties with 0.0), on ties, signed zeros, -inf pads and M > 16,384;
- where M equals the row length: equal to ``jax.lax.top_k`` and to B6's
  plain version (values only against ``lax.top_k`` where -0.0 appears);
- the mean tie-aware recall at least the target over 512 seeded rows, iid
  and with a contiguous run holding the top k; the same check fed
  contiguous windows as bins fails on the runs (negative control);
- ``banded_topk_spans_grouped_shift_approx`` and the engine in both
  approximate modes equal to the JAX package where every M equals its row
  length (``lax.approx_max_k`` is exact on the CPU, and so is the port
  there); at a bucketed shape every selection the engine makes equal to
  the numpy model on the engine's own rows, each at its recall target;
- the CLIs and ``engine_modes.combo_config`` taking the approximate flags.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.lib import _jax

from tvretrieval_tpu.data.datasets import ExampleBuilder
from tvretrieval_tpu.data.synthetic import make_synthetic_world
from tvretrieval_tpu.models.xml import XML as JXML
from tvretrieval_tpu.models.xml import XMLConfig as JXMLConfig
from tvretrieval_tpu.ops import span as jspan
from tvretrieval_tpu.retrieval import engine as je
from tvretrieval_tpu_torch.convert import flax_params_to_state_dict
from tvretrieval_tpu_torch.models.xml import XML, XMLConfig, l2_normalize
from tvretrieval_tpu_torch.ops import _build
from tvretrieval_tpu_torch.ops import approx_topk as at
from tvretrieval_tpu_torch.ops import sort as tsort
from tvretrieval_tpu_torch.ops import span as tspan
from tvretrieval_tpu_torch.ops.video_score import video_scores_xla
from tvretrieval_tpu_torch.profiling import engine_modes
from tvretrieval_tpu_torch.retrieval import engine as te
from tvretrieval_tpu_torch.retrieval import inference_xml
from tvretrieval_tpu_torch.testing import rank_mismatches, tie_aware_recall, within
from tvretrieval_tpu_torch.training import train_xml

# the engine's sites at the TVR corpus: (n, k, recall) -> M
ENGINE_SITES = {(21818, 100, 0.90): 1408, (10000, 200, 0.90): 2560, (2800, 200, 0.90): 2800,
                (21818, 100, 0.99): 11008, (21818, 100, 1.0): 21818}


def model_topk(x: np.ndarray, k: int, m: int, bin_map: str = "stride"):
    """numpy model of the binned top-k: ``stride`` bins hold j % m == b,
    ``window`` bins hold contiguous runs of ceil(n / m) elements. Returns
    (values, int64 element indices)."""
    nq, n = x.shape
    if bin_map == "stride":
        slots = -(-n // m)
        elem = np.arange(slots * m).reshape(slots, m)              # (slot, bin)
    else:
        w = -(-n // m)
        elem = np.arange(-(-n // w) * w).reshape(-1, w).T          # (slot, bin)
    pad = np.concatenate([x, np.full((nq, elem.size - n), -np.inf, x.dtype)], axis=1)
    grid = pad[:, elem]                                            # (nq, slot, bin)
    slot = np.argmax(grid, axis=1)                                 # first maximum: lowest index
    bin_idx = np.arange(elem.shape[1])
    best_elem = elem[slot, bin_idx[None]]                          # (nq, bins)
    best_val = np.take_along_axis(grid, slot[:, None], 1)[:, 0]
    vals, idx = [], []
    for r in range(nq):
        bins = np.lexsort((bin_idx, -best_val[r]))[:k]             # value desc, bin asc
        e = best_elem[r, bins]
        order = np.lexsort((e, -x[r, e]))                          # value desc, element asc
        vals.append(x[r, e[order]])
        idx.append(e[order])
    return np.stack(vals), np.stack(idx)


def _plain(x, k, recall):
    v, i = at.approx_max_k(torch.from_numpy(x), k, recall)
    assert v.dtype == torch.float32 and i.dtype == torch.int32 and v.shape == (x.shape[0], k)
    return v.numpy(), i.numpy()


def _assert_model(x, k, recall):
    m = at.bins(x.shape[1], k, recall)
    v, i = _plain(x, k, recall)
    mv, mi = model_topk(x, k, m)
    np.testing.assert_array_equal(i, mi)
    np.testing.assert_array_equal(v.view(np.int32), mv.view(np.int32))    # the own bits
    return m


@pytest.mark.parametrize("rank", [1, 2, 3])
def test_reduction_output_size_equals_jaxlib(rank):
    rng = np.random.default_rng(rank)
    cases = [(n, k, r) for n in (1, 5, 127, 128, 129, 200, 1024, 1025, 2049, 2800, 5000,
                                 10000, 21818, 100000)
             for k in (1, 2, 5, 100, 200) if k <= n
             for r in (0.5, 0.9, 0.95, 0.99, 0.999, 1.0)]
    cases += [(int(n), int(rng.integers(1, min(n, 3000) + 1)), float(rng.uniform(0.05, 1.0)))
              for n in rng.integers(1, 200000, 400)]
    for n, k, r in cases:
        want = tuple(_jax.approx_top_k_reduction_output_size(n, rank, k, r, False))
        assert at.reduction_output_size(n, rank, k, r) == want, (n, k, r, rank)


def test_the_engine_sites():
    for (n, k, r), m in ENGINE_SITES.items():
        assert at.bins(n, k, r) == m
        assert tuple(_jax.approx_top_k_reduction_output_size(n, 2, k, r, False))[0] == m
    with pytest.raises(ValueError, match="exceeds"):
        at.bins(100000, 1000, 0.01)
    with pytest.raises(ValueError, match="recall"):
        at.bins(1000, 10, 0.0)


@pytest.mark.parametrize("n,k,recall", [(300, 5, 0.5), (5000, 100, 0.9), (10000, 200, 0.9),
                                        (1000, 1, 0.9), (129, 1, 0.99), (129, 128, 0.99)])
def test_plain_equals_the_model_on_ties_and_signed_zeros(n, k, recall):
    rng = np.random.default_rng(n + k)
    # 9 levels, zeros among them, half of them negated: rows full of ties,
    # 0.0 and -0.0 mixed, in bins and across the cut
    x = (np.round(rng.random((24, n)) * 8) / 8).astype(np.float32)
    x[rng.random(x.shape) < 0.5] *= -1
    _assert_model(x, k, recall)
    # rows of one value: the first k bins, element b of each
    v, i = _plain(np.full((3, n), 0.25, np.float32), k, recall)
    np.testing.assert_array_equal(i, np.broadcast_to(np.arange(k), (3, k)))


def test_plain_equals_the_model_with_pads_and_long_rows():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(6, 10000)).astype(np.float32)
    x[:, 7000:] = -np.inf                       # fewer finite values than some bins
    x[0, :] = -np.inf                           # a row of pads only
    x[1, 100:] = -np.inf                        # fewer finite values than k
    assert _assert_model(x, 200, 0.9) == 2560
    v, i = _plain(x, 200, 0.9)
    assert np.isneginf(v[0]).all() and np.isfinite(v[1, :100]).all() and np.isneginf(v[1, 100:]).all()
    # M > 16,384: the card's chunked path; exact (recall 1.0) and bucketed
    for n, k, recall in ((21818, 100, 1.0), (200000, 100, 0.999)):
        x = np.round(rng.normal(size=(3, n)) * 64).astype(np.float32)
        assert _assert_model(x, k, recall) > 16384


@pytest.mark.parametrize("n,k,recall", [(100, 7, 0.9), (128, 128, 0.5), (2800, 200, 0.9),
                                        (21818, 100, 1.0)])
def test_plain_is_the_exact_top_k_where_bins_are_elements(n, k, recall):
    assert at.bins(n, k, recall) == n
    rng = np.random.default_rng(k)
    x = (np.round(rng.random((16, n)) * 64) / 64 + 0.5).astype(np.float32)   # ties, no zeros
    v, i = _plain(x, k, recall)
    jv, ji = jax.lax.top_k(jnp.asarray(x), k)
    np.testing.assert_array_equal(v, np.asarray(jv))
    np.testing.assert_array_equal(i, np.asarray(ji))
    pv, pi = tsort.topk_transposed_plain(torch.from_numpy(x), k)
    np.testing.assert_array_equal(i, pi.numpy())
    # with 0.0 and -0.0: lax.top_k orders +0.0 first, B6 and B11 tie them
    z = np.where(rng.random(x.shape) < 0.3, np.float32(-0.0), np.float32(0.0))
    z[:, ::3] = x[:, ::3]
    v, i = _plain(z, k, recall)
    pv, pi = tsort.topk_transposed_plain(torch.from_numpy(z), k)
    np.testing.assert_array_equal(i, pi.numpy())
    np.testing.assert_array_equal(v, np.asarray(jax.lax.top_k(jnp.asarray(z), k)[0]))


def test_tie_aware_recall():
    exact = np.array([[5.0, 4.0, 3.0, 3.0]])
    assert tie_aware_recall(exact, exact) == 1.0
    assert tie_aware_recall(exact, np.array([[5.0, 3.0, 3.0, 3.0]])) == 0.75   # two of two at 3
    assert tie_aware_recall(exact, np.array([[5.0, 4.0, 3.0, 1.0]])) == 0.75
    assert tie_aware_recall(np.full((1, 3), -np.inf), np.full((1, 3), -np.inf)) == 1.0


def _rows(kind, nq, n, k, rng):
    x = rng.random((nq, n), dtype=np.float32)
    if kind == "runs":
        # the top k in one contiguous run, as the span group select meets them
        for r, s in enumerate(rng.integers(0, n - k, nq)):
            x[r, s:s + k] += 1.0
    return x


def _recall_meets(kind, n, k, recall, bin_map):
    rng = np.random.default_rng(n)
    x = _rows(kind, 512, n, k, rng)
    m = at.bins(n, k, recall)
    v, _ = model_topk(x, k, m, bin_map) if bin_map == "window" else _plain(x, k, recall)
    got = tie_aware_recall(-np.sort(-x, axis=1)[:, :k], v)
    predicted = ((m - 1) / m) ** (k - 1)
    return got >= recall, got, predicted


@pytest.mark.parametrize("n,k", [(10000, 200), (21818, 100)])
@pytest.mark.parametrize("kind", ["iid", "runs"])
def test_mean_recall_reaches_the_target(kind, n, k):
    ok, got, predicted = _recall_meets(kind, n, k, 0.9, "stride")
    assert ok, (got, predicted)
    if kind == "iid":
        # the formula is the k-th best's chance to keep its bin; a better one
        # collides with fewer, so the mean is above it
        assert predicted <= got < 1.0, (got, predicted)
    else:
        assert got == 1.0                         # a run of k < M falls in k bins


def test_contiguous_windows_fail_on_runs():
    """Negative control: the recall check fed contiguous windows of 4 as
    bins fails on the runs rows (a run of 200 keeps 50 or 51)."""
    ok, got, _ = _recall_meets("runs", 10000, 200, 0.9, "window")
    assert not ok and got < 0.3, got
    ok, _, _ = _recall_meets("iid", 10000, 200, 0.9, "window")
    assert ok                                     # iid rows cannot tell the maps apart


def test_wrapper_checks():
    with pytest.raises(TypeError):
        at.approx_max_k(torch.zeros(3), 1)
    with pytest.raises(ValueError, match="k="):
        at.approx_max_k(torch.zeros(2, 5), 6)
    with pytest.raises(ValueError, match="expected cpu or cuda"):
        at.approx_max_k(torch.zeros(2, 5, device="meta"), 2)
    _build.reset_launch_counts()
    at.approx_max_k(torch.zeros(2, 500), 5, 0.9)
    assert _build.LAUNCHES["approx_max_k"] == 0             # CPU: the plain version


def test_banded_approx_equals_jax_where_bins_are_elements():
    """V * L = 126 groups and a pool of 350: M equals both rows' length."""
    rng = np.random.default_rng(5)
    nq, v, L, min_l, max_l, top_n = 4, 9, 14, 1, 8, 50
    st = jax.nn.softmax(jnp.asarray(rng.normal(size=(nq, v, L)), jnp.float32), -1)
    ed = jax.nn.softmax(jnp.asarray(rng.normal(size=(nq, v, L)), jnp.float32), -1)
    vsc = jnp.exp(20 * jnp.sort(jnp.asarray(rng.random((nq, v)) * 0.2, jnp.float32))[:, ::-1])
    keep = jnp.asarray(rng.random((nq, v)) < 0.8, jnp.float32)
    assert at.bins(v * L, top_n, 0.9) == v * L and at.bins(top_n * (max_l - min_l), top_n, 0.9) \
        == top_n * (max_l - min_l)
    for km in (None, keep):
        ref = jspan.banded_topk_spans_grouped_shift_approx(st, ed, vsc, min_l, max_l, top_n,
                                                           keep_mask=km, recall=0.9)
        t = lambda a: torch.from_numpy(np.array(a))
        got = tspan.banded_topk_spans_grouped_shift_approx(
            t(st), t(ed), t(vsc), min_l, max_l, top_n,
            keep_mask=None if km is None else t(km), recall=0.9)
        exact = tspan.banded_topk_spans_grouped_shift(
            t(st), t(ed), t(vsc), min_l, max_l, top_n, keep_mask=None if km is None else t(km))
        for a, b, c in zip(ref, got, exact):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
            np.testing.assert_array_equal(b.numpy(), c.numpy())


# ---- the engine, on a synthetic world with the JAX model's weights converted

ALPHA = 20.0
Q2C_F32, SPAN_F32 = 2e-5, 1e-3           # tests/test_torch_engine_modes.py
KW = dict(ctx_mode="video_sub", visual_input_size=18, sub_input_size=14,
          query_input_size=28, hidden_size=32, n_heads=2, max_ctx_l=14, max_desc_l=16)
COMMON = dict(max_vcmr_video=9, max_before_nms=50, min_pred_l=1, max_pred_l=8,
              context_bsz=8, query_bsz=5, video_score_mode="pallas",
              span_score_mode="simsweep_cat")
APPROX = dict(span_topk_mode="grouped_shift_approx", video_topk_approx=True,
              topk_approx_recall=0.9)


@pytest.fixture(scope="module")
def setup():
    world = make_synthetic_world(n_videos=20, n_queries=12, vid_dim=16, text_dim=12,
                                 max_clips=14, seed=7)
    builder = ExampleBuilder(
        query_source=world.query_source, video_source=world.video_source,
        sub_source=world.sub_source, ctx_mode="video_sub_tef", max_desc_l=16,
        max_ctx_l=14, clip_length=world.clip_length)
    jm = JXML(JXMLConfig(**KW))
    qb = builder.build_train_batch(world.annotations[:6])
    variables = jax.jit(lambda r, b: jm.init(r, **b, deterministic=True))(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
         "negatives": jax.random.PRNGKey(2)}, qb.model_inputs())
    tm = XML(XMLConfig(**KW)).eval()
    tm.load_state_dict(flax_params_to_state_dict(jax.device_get(variables["params"])),
                       strict=True)
    return world, builder, jm, variables, tm


def _span_key(vid, spans, clip):
    return (np.asarray(vid).astype(np.int64) * 1000 + np.rint(spans[..., 0] / clip)) * 1000 \
        + np.rint(spans[..., 1] / clip)


@pytest.mark.parametrize("mode", ["both", "video", "spans"])
def test_engine_approx_equals_jax_and_the_exact_modes_where_bins_are_elements(setup, mode):
    world, builder, jm, variables, tm = setup
    approx = {"both": APPROX, "video": dict(video_topk_approx=True, topk_approx_recall=0.9),
              "spans": dict(span_topk_mode="grouped_shift_approx", topk_approx_recall=0.9)}[mode]
    cfg = te.RetrievalConfig(**COMMON, **approx)
    te.check_supported(cfg)
    t = te.retrieve(tm, builder, te.encode_corpus(tm, builder, world.corpus, cfg),
                    world.annotations, world.corpus, cfg, return_arrays=True)
    jcfg = je.auto_interpret(je.RetrievalConfig(**COMMON, **approx))
    j = je.retrieve(jm, variables, builder, je.encode_corpus(jm, variables, builder,
                                                             world.corpus, jcfg),
                    world.annotations, world.corpus, jcfg, return_arrays=True)
    jq = np.log(np.asarray(j["VR"][2], np.float64)) / ALPHA
    tq = np.log(np.asarray(t["VR"][2], np.float64)) / ALPHA
    assert within(jq, tq, atol=Q2C_F32)
    assert rank_mismatches(np.asarray(j["VR"][0]), jq, t["VR"][0], atol=2 * Q2C_F32) == 0
    rtol = SPAN_F32 + np.expm1(ALPHA * Q2C_F32)
    for task in ("VCMR", "SVMR"):
        jv, js, jsc = (np.asarray(x) for x in j[task])
        tv, ts, tsc = t[task]
        assert within(jsc, tsc, rtol=rtol, atol=1e-12), task
        assert rank_mismatches(_span_key(jv, js, world.clip_length), jsc,
                               _span_key(tv, ts, world.clip_length), rtol=2 * rtol) == 0, task
    # and the port's exact modes (the video top-V on the pre-exp scores, as approx selects)
    exact = te.RetrievalConfig(**COMMON, span_topk_mode="grouped_shift",
                               video_topk_pre_exp=cfg.video_topk_approx)
    e = te.retrieve(tm, builder, te.encode_corpus(tm, builder, world.corpus, exact),
                    world.annotations, world.corpus, exact, return_arrays=True)
    for task in e:
        for a, b in zip(e[task], t[task]):
            np.testing.assert_array_equal(a, b, err_msg=task)


def test_engine_at_a_bucketed_shape(setup, monkeypatch):
    """600 videos, V = 100, top_n = 50, recall 0.5: the video top-V (600
    rows), the group select (1,400) and the final select (350) each cut
    into 256 bins. Every selection the engine makes equals the numpy
    model on the rows it was given, and reaches the target."""
    _, _, _, _, tm = setup
    nv, nq, L, d = 600, 12, 14, 32
    gen = torch.Generator().manual_seed(3)
    unit = lambda *s: torch.nn.functional.normalize(torch.randn(*s, generator=gen), dim=-1)
    vf1, sf1 = unit(nv, L, d), unit(nv, L, d)
    cat = torch.randn((nv, L, 2 * d), generator=gen)
    mask = (torch.arange(L)[None] < torch.randint(4, L + 1, (nv,), generator=gen)[:, None]).float()
    qf, qm = torch.randn((nq, 16, 28), generator=gen), torch.ones((nq, 16))
    cfg = te.RetrievalConfig(**dict(COMMON, max_vcmr_video=100, video_score_mode="einsum"),
                             span_topk_mode="grouped_shift_approx", video_topk_approx=True,
                             topk_approx_recall=0.5)
    calls = []
    original = at.approx_max_k

    def recording(x, k, recall=0.95):
        out = original(x, k, recall)
        calls.append((x.clone(), k, recall, out))
        return out

    monkeypatch.setattr(at, "approx_max_k", recording)
    out = te._score_query_batch(tm, cfg, qf, qm, vf1, None, sf1, None, mask,
                                torch.zeros(nq, dtype=torch.long), True, feat2_cat=cat)
    assert [tuple(c[0].shape) for c in calls] == [(nq, nv), (nq, 100 * L), (nq, 350)]
    for x, k, recall, (v, i) in calls:
        x = x.numpy()
        m = at.bins(x.shape[1], k, recall)
        assert m == 256 and recall == 0.5
        mv, mi = model_topk(x, k, m)
        np.testing.assert_array_equal(i.numpy(), mi)
        np.testing.assert_array_equal(v.numpy(), mv)
        got = tie_aware_recall(-np.sort(-x, axis=1)[:, :k], v.numpy())
        assert 0.5 <= got < 1.0, got                # approximate, and above its target
    # the video site selected on the pre-exp scores of the engine's own video scores
    q2c = video_scores_xla(*(l2_normalize(q) for q in tm.encode_query(qf, qm)), vf1, sf1, mask)
    assert torch.equal(calls[0][0], q2c.float())
    np.testing.assert_array_equal(out["topv_idx"].numpy(), calls[0][3][1].numpy())
    torch.testing.assert_close(out["topv_scores"], torch.exp(ALPHA * calls[0][3][0]),
                               rtol=0, atol=0)


def test_combo_config_and_the_clis_take_the_approximate_flags(setup, tmp_path):
    base = engine_modes.RetrievalConfig(cache_dtype_str="bfloat16")
    shipped = "simsweep_cat_bf16/pallas_int8/grouped_shift_approx/vapprox/rt0.9/pad128"
    cfg = engine_modes.combo_config(base, shipped)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(dataclasses.replace(
        base, span_score_mode="simsweep_cat_bf16", video_score_mode="pallas_int8",
        span_topk_mode="grouped_shift_approx", video_topk_approx=True, topk_approx_recall=0.9,
        span_sim_pad_l=128))
    assert engine_modes.combo_config(base, "gather/einsum/grouped").topk_approx_recall == 0.99
    args = train_xml.build_arg_parser().parse_args(
        ["--span_topk_mode", "grouped_shift_approx", "--video_topk_approx", "1",
         "--topk_approx_recall", "0.9"])
    train_xml.check_args_supported(args)
    rcfg = train_xml.retrieval_config(args, 100)
    assert (rcfg.span_topk_mode, rcfg.video_topk_approx, rcfg.topk_approx_recall) == \
        ("grouped_shift_approx", True, 0.9)
    p = inference_xml.build_arg_parser().parse_args(
        ["--model_dir", str(tmp_path), "--span_topk_mode", "grouped_shift_approx",
         "--video_topk_approx", "1", "--topk_approx_recall", "0.9"])
    assert (p.span_topk_mode, p.video_topk_approx, p.topk_approx_recall) == \
        ("grouped_shift_approx", 1, 0.9)
    for field in ("span_topk_mode", "video_topk_approx", "topk_approx_recall"):
        assert field in inference_xml.EVAL_OVERRIDABLE
