"""The engine modes beyond the first slices, through the port's entry
points (encode_corpus, encode_corpus_resident, retrieve and the two CLIs)
on a synthetic world with the JAX model's weights converted into the port.
JAX runs its Pallas kernels in interpret mode (auto_interpret); the port
runs the kernels' plain versions on the CPU.

What is held, and how tightly:
- the parity selections ("grouped_shift_psort" with ``video_topk_psort``,
  with and without ``video_topk_pre_exp``, and "grouped_shift8"): every
  output array of the port equal to its own "grouped_shift" run exactly,
  and the indices equal to the JAX engine's in the same mode wherever the
  JAX scores are not near-ties;
- span mode "simsweep": against the JAX engine within the f32 tolerances
  of tests/test_torch_engine.py, and against the port's own "gather" run;
- the int8 span modes: the top-V videos and their scores identical to the
  port's f32 sweep (the span mode never feeds the video stage), span scores
  within the bounds the JAX package's tests use against their own f32 mode
  (rtol 0.2, atol 1e-5 for "simsweep_cat_int8" against "simsweep_cat";
  rtol 0.1, atol 1e-4 for "simsweep_cat_int8_flat" against
  "simsweep_cat_int8"), and within the first of those of the JAX engine in
  the same mode; the caches' int8 bytes within one step of the JAX caches'.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from tvretrieval_tpu.data.datasets import ExampleBuilder
from tvretrieval_tpu.data.synthetic import make_synthetic_world
from tvretrieval_tpu.models.xml import XML as JXML
from tvretrieval_tpu.models.xml import XMLConfig as JXMLConfig
from tvretrieval_tpu.retrieval import engine as je
from tvretrieval_tpu_torch.convert import flax_params_to_state_dict
from tvretrieval_tpu_torch.data.device_corpus import build_device_data
from tvretrieval_tpu_torch.models.xml import XML, XMLConfig
from tvretrieval_tpu_torch.ops import _build
from tvretrieval_tpu_torch.ops import video_score as vs
from tvretrieval_tpu_torch.retrieval import engine as te
from tvretrieval_tpu_torch.retrieval import inference_xml
from tvretrieval_tpu_torch.testing import rank_mismatches, within
from tvretrieval_tpu_torch.training import train_xml

Q2C_F32, SPAN_F32 = 2e-5, 1e-3
ALPHA = 20.0
KW = dict(ctx_mode="video_sub", visual_input_size=18, sub_input_size=14,
          query_input_size=28, hidden_size=32, n_heads=2, max_ctx_l=14, max_desc_l=16)
COMMON = dict(max_vcmr_video=9, max_before_nms=50, min_pred_l=1, max_pred_l=8,
              context_bsz=8, query_bsz=5)


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


def _torch_run(setup, **mode):
    world, builder, _, _, tm = setup
    cfg = te.RetrievalConfig(**COMMON, **mode)
    cache = te.encode_corpus(tm, builder, world.corpus, cfg)
    return cache, te.retrieve(tm, builder, cache, world.annotations, world.corpus, cfg,
                              return_arrays=True)


def _jax_run(setup, **mode):
    world, builder, jm, variables, _ = setup
    cfg = je.auto_interpret(je.RetrievalConfig(**COMMON, **mode))
    cache = je.encode_corpus(jm, variables, builder, world.corpus, cfg)
    return cache, je.retrieve(jm, variables, builder, cache, world.annotations, world.corpus,
                              cfg, return_arrays=True)


def _span_key(vid, spans, clip):
    return (np.asarray(vid).astype(np.int64) * 1000 + np.rint(spans[..., 0] / clip)) * 1000 \
        + np.rint(spans[..., 1] / clip)


def _compare(ja, ta, q2c_tol, span_rtol, clip):
    """Scores within tolerance, indices equal outside near-ties (as
    tests/test_torch_engine.py compares the two engines)."""
    assert set(ja) == set(ta) == {"VCMR", "SVMR", "VR"}
    jq = np.log(np.asarray(ja["VR"][2], np.float64)) / ALPHA
    tq = np.log(np.asarray(ta["VR"][2], np.float64)) / ALPHA
    assert within(jq, tq, atol=q2c_tol)
    assert rank_mismatches(np.asarray(ja["VR"][0]), jq, ta["VR"][0], atol=2 * q2c_tol) == 0
    rtol = span_rtol + np.expm1(ALPHA * q2c_tol)
    for task in ("VCMR", "SVMR"):
        jv, jspans, jscores = (np.asarray(x) for x in ja[task])
        tv, tspans, tscores = ta[task]
        assert within(jscores, tscores, rtol=rtol, atol=1e-12), task
        assert rank_mismatches(_span_key(jv, jspans, clip), jscores,
                               _span_key(tv, tspans, clip), rtol=2 * rtol) == 0, task


def _assert_equal_arrays(a, b):
    for task in a:
        for x, y in zip(a[task], b[task]):
            np.testing.assert_array_equal(x, y, err_msg=task)


PARITY = {
    "psort": dict(span_topk_mode="grouped_shift_psort", video_topk_psort=True),
    "psort_pre_exp": dict(span_topk_mode="grouped_shift_psort", video_topk_psort=True,
                          video_topk_pre_exp=True),
    "psort_spans_only": dict(span_topk_mode="grouped_shift_psort"),
    "grouped_shift8": dict(span_topk_mode="grouped_shift8"),
}


@pytest.mark.parametrize("name", list(PARITY))
def test_parity_selection_modes_equal_grouped_shift_and_jax(setup, name):
    mode = PARITY[name]
    base = dict(video_score_mode="pallas", span_score_mode="simsweep_cat")
    ref_mode = dict(span_topk_mode="grouped_shift",
                    video_topk_pre_exp=mode.get("video_topk_pre_exp", False))
    _, ref = _torch_run(setup, **base, **ref_mode)
    _build.reset_launch_counts()
    _, out = _torch_run(setup, **base, **mode)
    _assert_equal_arrays(ref, out)
    assert _build.LAUNCHES["topk_transposed"] == 0                  # CPU: plain only
    _, ja = _jax_run(setup, **base, **mode)
    _compare(ja, out, Q2C_F32, SPAN_F32, setup[0].clip_length)


def test_simsweep_matches_jax_and_gather(setup):
    jcache, ja = _jax_run(setup, span_score_mode="simsweep", span_topk_mode="grouped_shift")
    tcache, ta = _torch_run(setup, span_score_mode="simsweep", span_topk_mode="grouped_shift")
    assert tcache.feat2_cat is None and tcache.video_feat2.shape == jcache.video_feat2.shape
    _compare(ja, ta, Q2C_F32, SPAN_F32, setup[0].clip_length)
    _, tg = _torch_run(setup, span_score_mode="gather", span_topk_mode="grouped_shift")
    _compare(tg, ta, 1e-6, 1e-4, setup[0].clip_length)
    # bf16 caches: the queries are cast to the cache dtype, as in "gather"
    _, tb = _torch_run(setup, span_score_mode="simsweep", cache_dtype_str="bfloat16")
    _, tgb = _torch_run(setup, span_score_mode="gather", cache_dtype_str="bfloat16")
    _compare(tgb, tb, 1e-6, 1e-4, setup[0].clip_length)


def _scores_close(ref, out, rtol, atol):
    for task in ("VCMR", "SVMR"):
        np.testing.assert_allclose(out[task][2], np.asarray(ref[task][2]), rtol=rtol,
                                   atol=atol, err_msg=task)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_span_modes(setup, dtype):
    base = dict(video_score_mode="pallas", span_topk_mode="grouped_shift",
                cache_dtype_str=dtype)
    _, cat = _torch_run(setup, span_score_mode="simsweep_cat", **base)
    c8, i8 = _torch_run(setup, span_score_mode="simsweep_cat_int8", **base)
    _build.reset_launch_counts()
    cf, flat = _torch_run(setup, span_score_mode="simsweep_cat_int8_flat", **base)
    assert _build.LAUNCHES["span_sim_cat_i8"] == 0                      # CPU: plain only

    # caches: int8 bytes + f32 scales, the two feat2 streams dropped
    nv, L = c8.mask.shape
    assert c8.feat2_cat.dtype == torch.int8 and c8.feat2_cat.shape == (nv, L, 64)
    assert c8.feat2_cat_scale.shape == (nv, L) and c8.feat2_cat_scale.dtype == torch.float32
    lp = vs.flat_lp(L)                      # the engine's rows a video: 16 at L = 14
    assert cf.feat2_cat.dtype == torch.int8 and cf.feat2_cat.shape == (32 * lp, 64)
    assert cf.feat2_cat_scale.shape == (32, lp)
    assert c8.video_feat2 is None and cf.sub_feat2 is None
    assert torch.equal(cf.feat2_cat.view(32, lp, 64)[:nv, :L], c8.feat2_cat)
    assert torch.equal(cf.feat2_cat_scale[:nv, :L], c8.feat2_cat_scale)

    # the video stage is untouched; span scores within the JAX tests' bounds
    for out in (i8, flat):
        for a, b in zip(cat["VR"], out["VR"]):
            np.testing.assert_array_equal(a, b)
    _scores_close(cat, i8, 0.2, 1e-5)
    _scores_close(i8, flat, 0.1, 1e-4)

    # and against the JAX engine in the same modes
    for mode, tcache, tout in (("simsweep_cat_int8", c8, i8),
                               ("simsweep_cat_int8_flat", cf, flat)):
        jcache, jout = _jax_run(setup, span_score_mode=mode, **base)
        tf, ts_ = tcache.feat2_cat.numpy(), tcache.feat2_cat_scale.numpy()
        jf, js_ = np.asarray(jcache.feat2_cat), np.asarray(jcache.feat2_cat_scale)
        if mode == "simsweep_cat_int8_flat":
            # the port's flat rows at flat_lp(L), the JAX package's at 128:
            # the real rows [:nv, :L] compared, the pad rows zeros either way
            k = tf.shape[1]
            tf, jf = tf.reshape(-1, lp, k), jf.reshape(-1, 128, k)
            assert tf.shape[0] == jf.shape[0] == js_.shape[0] == ts_.shape[0]
            assert not tf[:, L:].any() and not ts_[:, L:].any() and not tf[nv:].any()
            assert not jf[:, L:].any() and not js_[:, L:].any()
            tf, jf, ts_, js_ = tf[:nv, :L], jf[:nv, :L], ts_[:nv, :L], js_[:nv, :L]
        assert tf.shape == jf.shape and ts_.shape == js_.shape
        d = np.abs(tf.astype(np.int32) - jf.astype(np.int32))
        assert d.max() <= 1 and d.mean() < 0.01          # encoder round-off: rare one-step flips
        np.testing.assert_allclose(ts_, js_, rtol=1e-4, atol=1e-12)
        jq = np.log(np.asarray(jout["VR"][2], np.float64)) / ALPHA
        tq = np.log(np.asarray(tout["VR"][2], np.float64)) / ALPHA
        tol = Q2C_F32 if dtype == "float32" else 5e-3
        assert within(jq, tq, atol=tol)
        assert rank_mismatches(np.asarray(jout["VR"][0]), jq, tout["VR"][0], atol=2 * tol) == 0
        _scores_close(jout, tout, 0.2 + np.expm1(ALPHA * tol), 1e-5)


@pytest.mark.parametrize("lp", ["flat_lp", 128])
def test_int8_flat_engine_answers_alike_in_both_layouts(setup, lp):
    """The engine builds its int8 flat feat2 cache at flat_lp(L) rows a
    video (16 at L = 14); given the JAX package's 128-row layout of the same
    rows instead, every output of retrieve is the same."""
    world, builder, _, _, tm = setup
    mode = dict(video_score_mode="pallas_int8", span_score_mode="simsweep_cat_int8_flat",
                span_topk_mode="grouped_shift_psort", video_topk_psort=True,
                cache_dtype_str="bfloat16")
    cache, ref = _torch_run(setup, **mode)
    nv, L = cache.mask.shape
    assert cache.feat2_cat.shape == (32 * vs.flat_lp(L), 64)
    if lp == 128:
        # the same rows, 128 - 16 more zero rows a video with scale zero
        pad, k = 128 - vs.flat_lp(L), cache.feat2_cat.shape[1]
        f8 = torch.nn.functional.pad(cache.feat2_cat.view(32, -1, k), (0, 0, 0, pad))
        fs = torch.nn.functional.pad(cache.feat2_cat_scale, (0, pad))
        cache = dataclasses.replace(cache, feat2_cat=f8.reshape(32 * 128, k),
                                    feat2_cat_scale=fs)
    cfg = te.RetrievalConfig(**COMMON, **mode)
    out = te.retrieve(tm, builder, cache, world.annotations, world.corpus, cfg,
                      return_arrays=True)
    _assert_equal_arrays(ref, out)


def test_int8_and_psort_together_the_all_int8_engine(setup):
    """The serving configuration of this slice: int8 video scores, the int8
    flat span sweep and every selection through the sorting kernel."""
    mode = dict(video_score_mode="pallas_int8", span_score_mode="simsweep_cat_int8_flat",
                cache_dtype_str="bfloat16")
    cache, ref = _torch_run(setup, span_topk_mode="grouped_shift", **mode)
    assert cache.video_feat1.dtype == cache.feat2_cat.dtype == torch.int8
    _, out = _torch_run(setup, span_topk_mode="grouped_shift_psort", video_topk_psort=True,
                        **mode)
    _assert_equal_arrays(ref, out)
    _, fused = _torch_run(setup, span_topk_mode="grouped_shift_psort", video_topk_psort=True,
                          video_topk_fused=True, video_topk_pre_exp=True, **mode)
    _, pre = _torch_run(setup, span_topk_mode="grouped_shift", video_topk_pre_exp=True, **mode)
    _assert_equal_arrays(pre, fused)                     # fused block maxima take precedence


def test_encode_corpus_resident_builds_the_int8_caches(setup):
    world, builder, _, _, tm = setup
    dd = build_device_data(builder, world.corpus, world.annotations, world.annotations,
                           dtype_name="float32", device="cpu")
    for mode in ("simsweep_cat_int8", "simsweep_cat_int8_flat"):
        cfg = te.RetrievalConfig(**COMMON, span_score_mode=mode, video_score_mode="pallas_int8")
        ref = te.encode_corpus(tm, builder, world.corpus, cfg)
        out = te.encode_corpus_resident(tm, dd, world.corpus, cfg)
        assert out.feat2_cat.shape == ref.feat2_cat.shape and out.feat2_cat.dtype == torch.int8
        assert (out.feat2_cat.int() - ref.feat2_cat.int()).abs().max() <= 1
        np.testing.assert_allclose(out.feat2_cat_scale.numpy(), ref.feat2_cat_scale.numpy(),
                                   rtol=1e-5, atol=1e-12)
        a = te.retrieve(tm, builder, out, world.annotations, world.corpus, cfg,
                        return_arrays=True, query_table=dd.retrieval_queries)
        assert a["VCMR"][2].shape == (12, 50) and np.isfinite(a["VCMR"][2]).all()


def test_span_sim_pad_l_is_refused_with_the_int8_modes(setup):
    world, builder, _, _, tm = setup
    for mode in ("simsweep_cat_int8", "simsweep_cat_int8_flat", "simsweep"):
        cfg = te.RetrievalConfig(**COMMON, span_score_mode=mode, span_sim_pad_l=16)
        with pytest.raises(ValueError, match="span_sim_pad_l only composes"):
            te.encode_corpus(tm, builder, world.corpus, cfg)


def test_encode_corpus_batch_cache(setup):
    """An empty list is filled with the host-built batches (float16
    features) and a filled one is reused without touching the builder."""
    world, builder, _, _, tm = setup
    cfg = te.RetrievalConfig(**COMMON, span_score_mode="simsweep_cat")
    plain = te.encode_corpus(tm, builder, world.corpus, cfg)
    batches = []
    first = te.encode_corpus(tm, builder, world.corpus, cfg, batch_cache=batches)
    assert len(batches) == 3 and batches[0].video_feat.dtype == np.float16
    assert batches[2].video_feat.shape[0] == 4                      # 8 + 8 + 4 videos

    class NoBuilder:
        def build_context_batch(self, *a):
            raise AssertionError("the cached batches were not reused")

    again = te.encode_corpus(tm, NoBuilder(), world.corpus, cfg, batch_cache=batches)
    for name in ("video_feat1", "sub_feat1", "feat2_cat", "mask"):
        assert torch.equal(getattr(first, name), getattr(again, name)), name
        # float16 features: 2^-11 relative on the inputs
        np.testing.assert_allclose(getattr(first, name).numpy(), getattr(plain, name).numpy(),
                                   atol=5e-3, err_msg=name)
    assert len(batches) == 3


@pytest.mark.parametrize("field,value", [("span_topk_mode", "grouped_shift_approx"),
                                         ("video_topk_approx", True)])
def test_approximate_modes_still_raise(setup, field, value):
    """They raised NotImplementedError (ROADMAP A11) until the approximate
    top-k was ported; now they encode and retrieve, and at this world's
    shapes (every row no longer than its bins) equal the exact modes
    (tests/test_torch_approx_topk.py holds them against the JAX engine)."""
    world, builder, _, _, tm = setup
    cfg = dataclasses.replace(te.RetrievalConfig(**COMMON, span_score_mode="simsweep_cat"),
                              **{field: value})
    te.check_supported(cfg)
    _, out = _torch_run(setup, **{k: getattr(cfg, k) for k in (
        "span_score_mode", "span_topk_mode", "video_topk_approx")})
    _, ref = _torch_run(setup, span_score_mode="simsweep_cat",
                        span_topk_mode="grouped_shift" if field == "span_topk_mode"
                        else "grouped", video_topk_pre_exp=field == "video_topk_approx")
    _assert_equal_arrays(ref, out)


def test_unknown_mode_names_are_value_errors():
    for field, value in (("span_score_mode", "sweep"), ("span_topk_mode", "flat"),
                         ("video_score_mode", "mxu")):
        with pytest.raises(ValueError, match=field):
            te.check_supported(dataclasses.replace(te.RetrievalConfig(), **{field: value}))


TINY = ["--synthetic", "--synthetic_videos", "16", "--synthetic_queries", "48",
        "--synthetic_vid_dim", "32", "--synthetic_text_dim", "16", "--synthetic_max_clips", "12",
        "--max_ctx_l", "12", "--bsz", "16", "--hidden_size", "32", "--n_heads", "2",
        "--eval_query_bsz", "8", "--eval_context_bsz", "8", "--max_vcmr_video", "8"]


def test_clis_run_the_new_modes(tmp_path):
    """train_xml evaluates with the all-int8 psort configuration, and
    inference_xml overrides the modes of a saved run: the parity modes give
    the trainer's metrics again, and so do the approximate flags at this
    world's size, where every row is no longer than its bins."""
    flags = ["--video_score_mode", "pallas_int8", "--span_score_mode",
             "simsweep_cat_int8_flat", "--span_topk_mode", "grouped_shift_psort",
             "--video_topk_psort", "1", "--eval_cache_dtype", "bfloat16"]
    res = train_xml.start_training(TINY + flags + [
        "--device", "cpu", "--n_epoch", "1", "--results_root", str(tmp_path),
        "--exp_id", "int8"])
    assert res["final_metrics"]["VR"]["r5"] > 0
    same = inference_xml.start_inference(["--model_dir", res["results_dir"], "--device", "cpu",
                                          "--span_topk_mode", "grouped_shift8",
                                          "--video_topk_psort", "0"])
    assert same["metrics"] == res["final_metrics"]
    other = inference_xml.start_inference(["--model_dir", res["results_dir"], "--device", "cpu",
                                           "--span_score_mode", "simsweep",
                                           "--eval_id", "simsweep"])
    assert other["metrics"]["VR"] == res["final_metrics"]["VR"]
    for approx in (["--video_topk_approx", "1"], ["--span_topk_mode", "grouped_shift_approx"]):
        out = inference_xml.start_inference(["--model_dir", res["results_dir"], "--device", "cpu",
                                             "--eval_id", approx[-1]] + approx)
        assert out["metrics"]["VR"] == res["final_metrics"]["VR"]
