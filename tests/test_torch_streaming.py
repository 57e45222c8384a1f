"""The port's streaming engine (retrieval/streaming.py) against the JAX
package's streaming engine and against the port's resident engine, on a
tiny synthetic world (23 videos of up to 12 clips, hidden 16, blocks of 8:
the last block is padded) with the JAX model's weights converted into the
port and one fully masked video planted in the cache (video 20, in the
padded block). JAX runs its flat Pallas kernels in interpret mode; the
port runs the kernels' plain versions on the CPU.

What is held, and how tightly:
- against JAX, each mode on the JAX cache: the block scores within 1e-6
  (int8: bit-equal), a masked or pad video at exactly -1e10; the top-V
  indices and their order equal; top-V, span and SVMR scores within 2e-4;
  span indices equal outside near-ties;
- against the port's resident engine (span mode "gather", video mode
  "einsum" / "pallas" / "pallas_int8") through ``retrieve``: every output
  equal (the JAX test claims set equality and 1e-5; on the CPU both engines
  sum in the same order, so the claim here is exact);
- the edge cases: fewer videos than max_vcmr_video, the approximate span
  selection where every bin holds one element (both packages exact), the
  refusals, and inference_xml --streaming on a run of the port's trainer.
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
from tvretrieval_tpu.retrieval import streaming as js
from tvretrieval_tpu_torch.convert import flax_params_to_state_dict
from tvretrieval_tpu_torch.models.xml import XML, XMLConfig
from tvretrieval_tpu_torch.ops import approx_topk
from tvretrieval_tpu_torch.ops.masking import NEG_INF
from tvretrieval_tpu_torch.parallel.mesh import make_mesh
from tvretrieval_tpu_torch.retrieval import engine as te
from tvretrieval_tpu_torch.retrieval import inference_xml
from tvretrieval_tpu_torch.retrieval import streaming as ts
from tvretrieval_tpu_torch.testing import rank_mismatches
from tvretrieval_tpu_torch.training import train_xml

KW = dict(ctx_mode="video_sub", visual_input_size=18, sub_input_size=14,
          query_input_size=28, hidden_size=16, n_heads=4, max_ctx_l=12, max_desc_l=16)
COMMON = dict(max_vcmr_video=7, max_before_nms=30, min_pred_l=1, max_pred_l=8,
              context_bsz=8, query_bsz=6, span_topk_mode="grouped_shift")
N_VIDEOS, BLOCK, MASKED = 23, 8, 20
MODES = {"einsum": dict(), "flat": dict(flat=True), "flat_int8": dict(flat=True, int8=True)}
RESIDENT_MODE = {"einsum": "einsum", "flat": "pallas", "flat_int8": "pallas_int8"}
TOL = 2e-4


@pytest.fixture(scope="module")
def setup():
    world = make_synthetic_world(n_videos=N_VIDEOS, n_queries=10, vid_dim=16, text_dim=12,
                                 max_clips=12, seed=21)
    builder = ExampleBuilder(
        query_source=world.query_source, video_source=world.video_source,
        sub_source=world.sub_source, ctx_mode="video_sub_tef", max_desc_l=16,
        max_ctx_l=12, clip_length=world.clip_length)
    jm = JXML(JXMLConfig(**KW))
    batch = builder.build_train_batch(world.annotations[:6]).model_inputs()
    variables = jax.jit(lambda r, b: jm.init(r, **b, deterministic=True))(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
         "negatives": jax.random.PRNGKey(2)}, batch)
    tm = XML(XMLConfig(**KW)).eval()
    tm.load_state_dict(flax_params_to_state_dict(jax.device_get(variables["params"])),
                       strict=True)
    jcache = je.encode_corpus(jm, variables, builder, world.corpus,
                              je.RetrievalConfig(**COMMON))
    jcache = dataclasses.replace(jcache, mask=jcache.mask.at[MASKED].set(0.0))
    qb = builder.build_query_batch(world.annotations[:6])
    gt = np.arange(6, dtype=np.int32) % N_VIDEOS
    return world, builder, jm, variables, tm, jcache, qb, gt


def port_cache(jcache):
    """The JAX cache's arrays as the port's CorpusCache."""
    t = lambda x: torch.from_numpy(np.array(x))
    return te.CorpusCache(t(jcache.video_feat1), t(jcache.video_feat2), t(jcache.sub_feat1),
                          t(jcache.sub_feat2), t(jcache.mask), jcache.n_videos, jcache.metas)


def run_both(setup, mode, **cfg):
    _, _, jm, variables, tm, jcache, qb, gt = setup
    jcfg = je.RetrievalConfig(**{**COMMON, **cfg}, pallas_interpret=True)
    jout = js.streaming_score_query_batch(
        jm, variables, jcfg, qb.query_feat, qb.query_mask,
        js.host_cache_from_device(jcache, **MODES[mode]), gt_meta_idx=gt, block_videos=BLOCK)
    tout = ts.streaming_score_query_batch(
        tm, te.RetrievalConfig(**{**COMMON, **cfg}), torch.from_numpy(qb.query_feat),
        torch.from_numpy(qb.query_mask), ts.host_cache_from_device(port_cache(jcache),
                                                                   **MODES[mode]),
        gt_meta_idx=gt, block_videos=BLOCK)
    return {k: np.asarray(v) for k, v in jout.items()}, {k: v.numpy() for k, v in tout.items()}


def span_keys(out, task):
    """(Nq, top_n) int64 keys of the (video, st, ed) moments of a task."""
    vid = (np.take_along_axis(out["topv_idx"], out["vcmr_vid_local"], 1).astype(np.int64)
           if task == "vcmr" else 0)
    return (vid * 1000 + out[f"{task}_st"].astype(np.int64)) * 1000 + out[f"{task}_ed"]


def assert_like_jax(jout, tout):
    assert set(jout) == set(tout)
    np.testing.assert_array_equal(tout["topv_idx"], jout["topv_idx"])
    for k in ("topv_scores", "vcmr_scores", "svmr_scores"):
        np.testing.assert_allclose(tout[k], jout[k], rtol=TOL, atol=1e-30, err_msg=k)
    for task in ("vcmr", "svmr"):
        assert rank_mismatches(span_keys(jout, task), jout[f"{task}_scores"],
                               span_keys(tout, task), rtol=2 * TOL) == 0, task


@pytest.mark.parametrize("mode", list(MODES))
def test_streaming_matches_jax(setup, mode):
    """Three blocks, the last padded, the masked video in it."""
    jout, tout = run_both(setup, mode)
    assert_like_jax(jout, tout)
    assert MASKED not in tout["topv_idx"]


@pytest.mark.parametrize("mode", list(MODES))
def test_block_scores_match_jax(setup, mode):
    """Each streamed block's (Nq, B) scores: the JAX block scorer against the
    port's on the same normalized queries, the same host cache and the same
    zero-padded blocks; the planted masked video and the pad video score
    exactly -1e10 before exp."""
    _, _, jm, variables, tm, jcache, qb, _ = setup
    _, _, vqn, sqn = js._encode_queries(jm, variables, qb.query_feat, qb.query_mask)
    vqn, sqn = np.array(vqn), np.array(sqn)
    jhost = js.host_cache_from_device(jcache, **MODES[mode])
    thost = ts.host_cache_from_device(port_cache(jcache), **MODES[mode])
    score = ts._block_scorer(thost, torch.from_numpy(vqn), torch.from_numpy(sqn), BLOCK)
    offsets = []
    # the two block buffers are reused: score each block before the next
    for off, block in ts._device_blocks(thost, BLOCK, torch.device("cpu"), None):
        offsets.append(off)
        got = score(*block).numpy()
        nb = min(BLOCK, N_VIDEOS - off)
        pad = lambda a, r: np.concatenate([a, np.zeros(((BLOCK - nb) * r,) + a.shape[1:],
                                                       a.dtype)])
        if mode == "einsum":
            want = js._block_scores(vqn, sqn, pad(jhost.video_feat1[off:off + nb], 1),
                                    pad(jhost.sub_feat1[off:off + nb], 1),
                                    pad(jhost.mask[off:off + nb], 1))
        else:
            lp = jhost.lp
            want = js._block_scores_flat(
                vqn, sqn, pad(jhost.video_feat1[off * lp:(off + nb) * lp], lp),
                pad(jhost.sub_feat1[off * lp:(off + nb) * lp], lp),
                pad(jhost.video_valid[off:off + nb], 1), lp=lp, interpret=True)
        want = np.asarray(want)
        if mode == "flat_int8":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        if off == 16:
            assert (got[:, MASKED - off] == NEG_INF).all() and (got[:, nb:] == NEG_INF).all()
            assert (got[:, :MASKED - off] > -1.5).all()
    assert offsets == [0, 8, 16]


@pytest.mark.parametrize("mode", ["einsum_masked"] + list(MODES))
def test_streaming_equals_resident_engine(setup, mode):
    """retrieve through the streaming engine against retrieve on the
    resident cache, every output equal. The flat resident layout cannot
    hold a fully masked video, so only the einsum case keeps it planted."""
    world, builder, jm, variables, tm, jcache, _, _ = setup
    name = mode.replace("_masked", "")
    if mode != "einsum_masked":
        jcache = dataclasses.replace(jcache, mask=jcache.mask.at[MASKED].set(1.0))
    cache = port_cache(jcache)
    cfg = te.RetrievalConfig(**COMMON, video_score_mode=RESIDENT_MODE[name])
    rows = world.annotations[:10]
    bufs = dict(vf1=cache.video_feat1, sf1=cache.sub_feat1, vf2=cache.video_feat2,
                sf2=cache.sub_feat2, mask=cache.mask)
    resident = te.retrieve(tm, builder, te._finish_cache(tm, cfg, world.corpus, bufs), rows,
                           world.corpus, cfg, return_arrays=True)
    host = ts.host_cache_from_device(cache, **MODES[name])
    streamed = te.retrieve(tm, builder, cache, rows, world.corpus, cfg, return_arrays=True,
                           streaming_host=host, streaming_block_videos=BLOCK)
    assert set(streamed) == set(resident) == {"VCMR", "SVMR", "VR"}
    for task in resident:
        for a, b in zip(resident[task], streamed[task]):
            np.testing.assert_array_equal(b, a, err_msg=task)


@pytest.mark.parametrize("mode", ["einsum", "flat_int8"])
def test_fewer_videos_than_max_vcmr_video(setup, mode):
    """max_vcmr_video 30 over 23 videos: pad videos (-1e10) and initial -inf
    entries fill the state, their indices clipped to the last video, in
    both packages."""
    jout, tout = run_both(setup, mode, max_vcmr_video=30)
    assert tout["topv_idx"].shape == (6, 30) and tout["topv_idx"].max() == N_VIDEOS - 1
    assert_like_jax(jout, tout)


def test_approximate_spans_where_every_bin_holds_one_element(setup):
    """grouped_shift_approx (B11's plain version at both selections) where
    M = n at both (V * L = 84 and G * W = 210 elements, k = 30): the JAX
    package, exact on the CPU, and the port agree, and the port equals its
    own exact grouped_shift run."""
    v, L, W, top_n = COMMON["max_vcmr_video"], KW["max_ctx_l"], 7, COMMON["max_before_nms"]
    for n in (v * L, top_n * W):
        assert approx_topk.bins(n, top_n, 0.9) == n
    jout, tout = run_both(setup, "flat_int8", span_topk_mode="grouped_shift_approx",
                          topk_approx_recall=0.9)
    assert_like_jax(jout, tout)
    _, exact = run_both(setup, "flat_int8")
    for k in exact:
        np.testing.assert_array_equal(tout[k], exact[k], err_msg=k)


def test_refusals(setup, tmp_path):
    world, builder, _, _, tm, jcache, qb, _ = setup
    cache = port_cache(jcache)
    flat = dataclasses.replace(cache, video_feat1=cache.video_feat1.reshape(-1, 16))
    with pytest.raises(ValueError, match="flat"):
        ts.host_cache_from_device(flat, flat=True)
    with pytest.raises(ValueError, match="flat"):
        ts.host_cache_from_device(cache, flat=False, int8=True)
    host = ts.host_cache_from_device(cache)
    path = tmp_path / "vr.json"
    path.write_text('{"VR": []}')
    with pytest.raises(ValueError, match="external VR"):
        te.retrieve(tm, builder, cache, world.annotations[:3], world.corpus,
                    te.RetrievalConfig(**COMMON), external_vr_path=str(path),
                    streaming_host=host)
    # streaming over a mesh of cards where there are none: refused, no fallback
    # to the CPU (the mesh path itself is held in test_torch_parallel.py)
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="CUDA cards"):
            ts.streaming_score_query_batch(tm, te.RetrievalConfig(**COMMON),
                                           torch.from_numpy(qb.query_feat),
                                           torch.from_numpy(qb.query_mask), host,
                                           mesh=make_mesh(2))


TINY = ["--synthetic", "--synthetic_videos", "16", "--synthetic_queries", "48",
        "--synthetic_vid_dim", "32", "--synthetic_text_dim", "16", "--synthetic_max_clips", "12",
        "--max_ctx_l", "12", "--bsz", "16", "--hidden_size", "32", "--n_heads", "2",
        "--eval_query_bsz", "8", "--eval_context_bsz", "8", "--max_vcmr_video", "8"]


def test_inference_cli_streams_on_the_cpu(tmp_path):
    """inference_xml --streaming on a run directory of the port's trainer,
    blocks of 5 of the 16 videos (the last padded): einsum and flat give the
    trainer's metrics (its closing inference is the resident einsum /
    gather run of the same weights), flat_int8 those of the resident
    pallas_int8 run."""
    res = train_xml.start_training(TINY + ["--device", "cpu", "--n_epoch", "1",
                                           "--results_root", str(tmp_path), "--exp_id", "s"])
    run = lambda *flags: inference_xml.start_inference(
        ["--model_dir", res["results_dir"], "--device", "cpu", "--streaming_block_videos", "5",
         "--eval_id", "_".join(flags).replace("-", "")] + list(flags))
    for mode in ("einsum", "flat"):
        assert run("--streaming", mode)["metrics"] == res["final_metrics"], mode
    int8 = run("--streaming", "flat_int8")
    assert int8["metrics"] == run("--video_score_mode", "pallas_int8")["metrics"]
