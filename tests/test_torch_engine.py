"""The port's retrieval slice (encode_corpus + _score_query_batch +
retrieve) against the JAX engine on a synthetic world, with the JAX
model's ``init`` weights converted into the port. JAX runs its Pallas
kernels in interpret mode (auto_interpret); the port runs the kernels'
plain versions on the CPU.

Tolerances, and why:
- f32 caches: the two frameworks' encoders agree to ~1e-6 relative, so
  video scores q2c agree to Q2C_F32 and span scores (two softmax
  probabilities times exp(20 q2c)) to SPAN_F32 relative;
- bf16 caches / bf16 similarity: that slack can round a value to the
  neighbouring bf16 (2^-8 relative): span scores to SPAN_BF16 relative;
- int8 video scores: integer accumulation is exact, but an encoder
  difference can round a query or cache component to a neighbouring int8.
  A change of |dq|_1 in a query and |df|_1 in a cache row moves that row's
  dot by at most 127 (|dq|_1 + |df|_1), the max over a video's rows by no
  more, and q2c by at most 0.5 / 127 * (|dq|_1 + max |df|_1) summed over
  both streams: the per-query bound the test computes from the bytes.
Rankings must agree wherever the JAX scores are separated by more than
twice the bound (testing.rank_mismatches).
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from tvretrieval_tpu.data.datasets import ExampleBuilder
from tvretrieval_tpu.data.synthetic import make_synthetic_world
from tvretrieval_tpu.models.xml import XML as JXML
from tvretrieval_tpu.models.xml import XMLConfig as JXMLConfig
from tvretrieval_tpu.ops.pallas_score import quantize_unit_i8 as j_quantize
from tvretrieval_tpu.retrieval import engine as je
from tvretrieval_tpu_torch.convert import flax_params_to_state_dict
from tvretrieval_tpu_torch.models.xml import XML, XMLConfig
from tvretrieval_tpu_torch.ops import _build
from tvretrieval_tpu_torch.ops import video_score as vs
from tvretrieval_tpu_torch.retrieval import engine as te
from tvretrieval_tpu_torch.testing import rank_mismatches, within

Q2C_F32, SPAN_F32, SPAN_BF16 = 2e-5, 1e-3, 3e-2
ALPHA = 20.0
KW = dict(ctx_mode="video_sub", visual_input_size=18, sub_input_size=14,
          query_input_size=28, hidden_size=32, n_heads=2, max_ctx_l=14, max_desc_l=16)
COMMON = dict(max_vcmr_video=9, max_before_nms=50, min_pred_l=1, max_pred_l=8,
              context_bsz=8, query_bsz=5, span_sim_pad_l=16, span_topk_mode="grouped_shift")


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


def _run_both(setup, **mode):
    world, builder, jm, variables, tm = setup
    jcfg = je.auto_interpret(je.RetrievalConfig(**COMMON, **mode))
    tcfg = te.RetrievalConfig(**COMMON, **mode)
    jcache = je.encode_corpus(jm, variables, builder, world.corpus, jcfg)
    tcache = te.encode_corpus(tm, builder, world.corpus, tcfg)
    rows = world.annotations
    ja = je.retrieve(jm, variables, builder, jcache, rows, world.corpus, jcfg,
                     return_arrays=True)
    ta = te.retrieve(tm, builder, tcache, rows, world.corpus, tcfg, return_arrays=True)
    return jcache, tcache, ja, ta


def _span_key(vid, spans, clip):
    return (vid.astype(np.int64) * 1000 + np.rint(spans[..., 0] / clip)) * 1000 \
        + np.rint(spans[..., 1] / clip)


def _compare(ja, ta, q2c_tol, span_rtol, clip):
    assert set(ja) == set(ta) == {"VCMR", "SVMR", "VR"}
    for task in ja:
        for a, b in zip(ja[task], ta[task]):
            assert np.asarray(a).shape == np.asarray(b).shape, task
    # video ranking on the pre-exp scale
    jq = np.log(np.asarray(ja["VR"][2], np.float64)) / ALPHA
    tq = np.log(np.asarray(ta["VR"][2], np.float64)) / ALPHA
    assert within(jq, tq, atol=q2c_tol)
    assert rank_mismatches(ja["VR"][0], jq, ta["VR"][0], atol=2 * np.asarray(q2c_tol)) == 0
    rtol = span_rtol + np.expm1(ALPHA * np.asarray(q2c_tol))
    for task in ("VCMR", "SVMR"):
        jv, jspans, jscores = (np.asarray(x) for x in ja[task])
        tv, tspans, tscores = ta[task]
        assert within(jscores, tscores, rtol=rtol, atol=1e-12), task
        assert rank_mismatches(_span_key(jv, jspans, clip), jscores,
                               _span_key(tv, tspans, clip), rtol=2 * rtol) == 0, task


def test_engine_pallas_f32_matches_jax(setup):
    """video_score_mode='pallas' (B2's plain version) on f32 caches with
    the f32 concatenated sweep: caches, selections and scores agree."""
    _build.reset_launch_counts()
    jcache, tcache, ja, ta = _run_both(setup, video_score_mode="pallas",
                                       span_score_mode="simsweep_cat",
                                       cache_dtype_str="float32")
    np.testing.assert_allclose(tcache.video_feat1.numpy(), np.asarray(jcache.video_feat1),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(tcache.feat2_cat.numpy(), np.asarray(jcache.feat2_cat),
                               rtol=0, atol=1e-5)
    assert tcache.feat2_cat.shape == jcache.feat2_cat.shape            # padded to 16
    np.testing.assert_array_equal(tcache.mask.numpy(), np.asarray(jcache.mask))
    _compare(ja, ta, Q2C_F32, SPAN_F32, setup[0].clip_length)
    assert all(v == 0 for v in _build.LAUNCHES.values())                  # CPU: plain only


def test_engine_pallas_int8_fused_matches_jax(setup):
    """video_score_mode='pallas_int8' with video_topk_fused (B3-int8's
    plain version) on bf16 caches and the bf16 similarity: video scores
    within the int8 rounding bound computed from the two frameworks'
    bytes, spans within the bf16 tolerance plus the video score's share."""
    world, builder, jm, variables, tm = setup
    jcache, tcache, ja, ta = _run_both(setup, video_score_mode="pallas_int8",
                                       video_topk_fused=True,
                                       span_score_mode="simsweep_cat_bf16",
                                       cache_dtype_str="bfloat16")
    assert tcache.video_feat1.dtype == torch.int8
    # cache rows: the largest per-row L1 byte difference, per stream
    row_l1 = 0
    for key in ("video_feat1", "sub_feat1"):
        d = np.abs(getattr(tcache, key).numpy().astype(np.int32)
                   - np.asarray(getattr(jcache, key)).astype(np.int32))
        assert d.max() <= 1
        row_l1 += d.sum(axis=1).max()
    # queries: the per-query L1 byte difference, both streams
    qb = builder.build_query_batch(world.annotations)
    norm = lambda x: x / (np.linalg.norm(x, axis=-1, keepdims=True) + 1e-12)
    jq = jm.apply(variables, qb.query_feat, qb.query_mask, method=JXML.encode_query)
    with torch.no_grad():
        tq = tm.encode_query(torch.from_numpy(qb.query_feat), torch.from_numpy(qb.query_mask))
    q_l1 = sum(np.abs(vs.quantize_unit_i8(torch.from_numpy(norm(t.numpy()))).numpy()
                      .astype(np.int32) - np.asarray(j_quantize(norm(np.asarray(j))))
                      .astype(np.int32)).sum(axis=1) for j, t in zip(jq, tq))
    q2c_tol = 1e-6 + 0.5 / 127 * (q_l1 + row_l1)
    _compare(ja, ta, q2c_tol, SPAN_BF16, world.clip_length)


def test_retrieve_submission_and_external_vr_match_jax(setup, tmp_path):
    """The submission-dict path with an external VR ranking (reference
    --external_inference_vr_res_path): the same JSON layout, the external
    videos taken as given, spans as in the array path."""
    world, builder, jm, variables, tm = setup
    mode = dict(video_score_mode="pallas", span_score_mode="simsweep_cat",
                cache_dtype_str="float32")
    rows = world.annotations[:5]
    rng = np.random.default_rng(3)
    vr = {"VR": [{"desc_id": r["desc_id"], "predictions": [
        [int(v), 0, 0, float(s)] for v, s in zip(rng.permutation(20)[:9],
                                                 -np.sort(-rng.random(9)))]}
        for r in rows]}
    path = tmp_path / "vr.json"
    path.write_text(json.dumps(vr))
    jcfg = je.auto_interpret(je.RetrievalConfig(**COMMON, **mode))
    tcfg = te.RetrievalConfig(**COMMON, **mode)
    js = je.retrieve(jm, variables, builder,
                     je.encode_corpus(jm, variables, builder, world.corpus, jcfg),
                     rows, world.corpus, jcfg, external_vr_path=str(path))
    ts = te.retrieve(tm, builder, te.encode_corpus(tm, builder, world.corpus, tcfg),
                     rows, world.corpus, tcfg, external_vr_path=str(path))
    assert list(js) == list(ts) == ["VCMR", "SVMR", "VR"]
    for task in js:
        for a, b in zip(js[task], ts[task]):
            assert a["desc_id"] == b["desc_id"] and a["desc"] == b["desc"]
            pa, pb = np.asarray(a["predictions"]), np.asarray(b["predictions"])
            assert pa.shape == pb.shape
            if task == "VR":
                np.testing.assert_array_equal(pb[:, :3], pa[:, :3])
                np.testing.assert_allclose(pb[:, 3], pa[:, 3], rtol=1e-6)
            else:
                assert rank_mismatches(_span_key(pa[:, 0], pa[:, 1:3], world.clip_length),
                                       pa[:, 3], _span_key(pb[:, 0], pb[:, 1:3],
                                                           world.clip_length),
                                       rtol=2 * SPAN_F32) == 0
                np.testing.assert_allclose(pb[:, 3], pa[:, 3], rtol=SPAN_F32)


def test_video_chunk_v_and_einsum_agree(setup):
    """video_chunk_v pads the flat cache and bounds B3's block: a tiling
    knob, outputs bit-equal across values; the einsum video path ranks the
    same videos as the flat path (f32 summation slack)."""
    world, builder, _, _, tm = setup
    rows = world.annotations
    outs = []
    for mode in (dict(video_score_mode="pallas", video_chunk_v=16),
                 dict(video_score_mode="pallas", video_chunk_v=8, video_topk_fused=True,
                      video_topk_pre_exp=True),
                 dict(video_score_mode="pallas", video_chunk_v=8, video_topk_pre_exp=True),
                 dict(video_score_mode="einsum")):
        cfg = te.RetrievalConfig(**COMMON, span_score_mode="simsweep_cat", **mode)
        cache = te.encode_corpus(tm, builder, world.corpus, cfg)
        outs.append(te.retrieve(tm, builder, cache, rows, world.corpus, cfg,
                                return_arrays=True))
    for out in outs[1:3]:
        for task in outs[0]:
            for a, b in zip(outs[0][task], out[task]):
                np.testing.assert_array_equal(a, b)
    _compare(outs[0], outs[3], Q2C_F32, SPAN_F32, world.clip_length)


def test_engine_gather_grouped_defaults_match_jax(setup):
    """The trainer's default exact modes: span mode "gather" (feature-row
    gather, XML.merged_st_ed_scores_gathered) with span top-k "grouped" and
    einsum video scores, f32 caches; then gather on bf16 caches."""
    world = setup[0]
    common = {k: v for k, v in COMMON.items() if k not in ("span_sim_pad_l",
                                                           "span_topk_mode")}
    _, _, _, tm = setup[1:]
    for dtype, span_tol in (("float32", SPAN_F32), ("bfloat16", SPAN_BF16)):
        mode = dict(span_score_mode="gather", span_topk_mode="grouped",
                    video_score_mode="einsum", cache_dtype_str=dtype)
        jcfg, tcfg = je.RetrievalConfig(**common, **mode), te.RetrievalConfig(**common, **mode)
        assert tcfg == te.RetrievalConfig(**common, cache_dtype_str=dtype)      # the defaults
        jcache = je.encode_corpus(setup[2], setup[3], setup[1], world.corpus, jcfg)
        tcache = te.encode_corpus(tm, setup[1], world.corpus, tcfg)
        assert tcache.feat2_cat is None and tcache.video_feat2.shape == jcache.video_feat2.shape
        ja = je.retrieve(setup[2], setup[3], setup[1], jcache, world.annotations, world.corpus,
                         jcfg, return_arrays=True)
        ta = te.retrieve(tm, setup[1], tcache, world.annotations, world.corpus, tcfg,
                         return_arrays=True)
        _compare(ja, ta, Q2C_F32 if dtype == "float32" else 5e-3, span_tol, world.clip_length)
    # gather and the concatenated sweep agree inside the port too
    sweep = te.RetrievalConfig(**common, span_score_mode="simsweep_cat",
                               span_topk_mode="grouped_shift")
    tb = te.retrieve(tm, setup[1], te.encode_corpus(tm, setup[1], world.corpus, sweep),
                     world.annotations, world.corpus, sweep, return_arrays=True)
    tcfg = te.RetrievalConfig(**common)
    ta = te.retrieve(tm, setup[1], te.encode_corpus(tm, setup[1], world.corpus, tcfg),
                     world.annotations, world.corpus, tcfg, return_arrays=True)
    _compare(tb, ta, 1e-6, 1e-4, world.clip_length)


def test_arrays_to_submission_matches_jax(setup):
    world, builder, _, _, tm = setup
    cfg = te.RetrievalConfig(**COMMON, span_score_mode="simsweep_cat")
    arrays = te.retrieve(tm, builder, te.encode_corpus(tm, builder, world.corpus, cfg),
                         world.annotations, world.corpus, cfg, return_arrays=True)
    assert te.arrays_to_submission(arrays, world.annotations, top_n=7) == \
        je.arrays_to_submission(arrays, world.annotations, top_n=7)


@pytest.mark.parametrize("field,value,item", [
    ("span_score_mode", "simsweep", "A15"),
    ("span_score_mode", "simsweep_cat_int8", "A11"),
    ("span_score_mode", "simsweep_cat_int8_flat", "A11"),
    ("span_topk_mode", "grouped_shift8", "A15"),
    ("span_topk_mode", "grouped_shift_approx", "A11"),
    ("span_topk_mode", "grouped_shift_psort", "A11"),
    ("video_topk_approx", True, "A11"), ("video_topk_psort", True, "A11"),
])
def test_unported_modes_raise(setup, field, value, item):
    """``item`` is the ROADMAP item each mode was queued under. Every one
    has been ported since and encodes and retrieves
    (tests/test_torch_engine_modes.py and tests/test_torch_approx_topk.py
    hold them against the JAX engine)."""
    world, builder, _, _, tm = setup
    common = dict(COMMON, span_score_mode="simsweep_cat")
    if field == "span_score_mode":
        common["span_sim_pad_l"] = 0        # the pad composes with simsweep_cat only
    cfg = dataclasses.replace(te.RetrievalConfig(**common), **{field: value})
    te.check_supported(cfg)
    cache = te.encode_corpus(tm, builder, world.corpus, cfg)
    out = te.retrieve(tm, builder, cache, world.annotations[:5], world.corpus, cfg,
                      return_arrays=True)
    assert out["VCMR"][2].shape == (5, COMMON["max_before_nms"])
    assert np.isfinite(out["VCMR"][2]).all()


def test_span_sim_pad_l_validation():
    cfg = te.RetrievalConfig(span_score_mode="simsweep_cat", span_sim_pad_l=8)
    with pytest.raises(ValueError, match="< cache clip length"):
        te._maybe_pad_clip_axis(torch.zeros(2, 10, 4), cfg)
    padded = te._maybe_pad_clip_axis(torch.ones(2, 10, 4),
                                     dataclasses.replace(cfg, span_sim_pad_l=16))
    assert padded.shape == (2, 16, 4) and padded[:, 10:].abs().sum() == 0
    with pytest.raises(ValueError, match="span_sim_pad_l only composes"):
        te._maybe_pad_clip_axis(torch.ones(2, 10, 4),
                                dataclasses.replace(cfg, span_score_mode="gather"))
