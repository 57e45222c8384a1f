"""The port's multi-device layer (parallel/mesh.py, parallel/sharded_retrieval.py,
the streaming engine with a mesh) against the JAX package's sharded program
and against the port's single-device engine, at the shapes of
tests/test_sharded_retrieval.py: 19 videos of up to 12 clips, hidden 16,
V = 8, N = 40, 6 queries; meshes of k = 2 and 4 CPU shards
(``make_mesh(k, devices=["cpu"] * k)``; JAX runs on the 8 virtual devices of
tests/conftest.py, its Pallas kernels in interpret mode).

What is held, and how tightly:
- against JAX on its converted weights and its cache, k = 2 and 4: in
  einsum / gather (f32) the top-V indices and every span index equal,
  scores within 2e-4; in the int8 set (pallas_int8 + video_topk_fused +
  simsweep_cat_int8_flat + grouped_shift_psort: B1 / B3, B5 and B6) the
  top-V and span indices equal and every score within INT8_RTOL, two f32
  ulps: the integer video scores and the bf16 span similarities are
  bit-equal, and only ``exp`` differs, XLA's and torch's CPU exp
  disagreeing in the last bit on a few values; under the approximate
  selections where every bin holds one element (both packages exact
  then), k = 2, the same as in f32;
- against the port's single-device engine on the same cache, with three
  copies of one video planted in three shards (ties whose order crosses a
  shard edge): every span score mode, every span top-k mode, pre-exp,
  psort, the fused block maxima, the clip-axis pad, SVMR on and off, the
  non-fast branch; indices equal, scores equal up to the f32 summation
  order (1e-6);
- streaming with a mesh equal to streaming without one, in its three host
  modes, the last block padded;
- the mesh's refusals: a split that does not divide, more shards than
  cards, a shard on the wrong device.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tvretrieval_tpu.data.datasets import ExampleBuilder
from tvretrieval_tpu.data.synthetic import make_synthetic_world
from tvretrieval_tpu.models.xml import XML as JXML
from tvretrieval_tpu.models.xml import XMLConfig as JXMLConfig
from tvretrieval_tpu.parallel import mesh as jmesh
from tvretrieval_tpu.parallel import sharded_retrieval as jsr
from tvretrieval_tpu.retrieval import engine as je
from tvretrieval_tpu_torch.convert import flax_params_to_state_dict
from tvretrieval_tpu_torch.models.xml import XML, XMLConfig
from tvretrieval_tpu_torch.ops import approx_topk
from tvretrieval_tpu_torch.parallel import make_mesh, shard_batch
from tvretrieval_tpu_torch.parallel import sharded_retrieval as sr
from tvretrieval_tpu_torch.retrieval import engine as te
from tvretrieval_tpu_torch.retrieval import streaming as ts

N_VIDEOS, NQ = 19, 6
KW = dict(ctx_mode="video_sub", visual_input_size=18, sub_input_size=14,
          query_input_size=28, hidden_size=16, n_heads=4, max_ctx_l=12, max_desc_l=16)
COMMON = dict(max_vcmr_video=8, max_before_nms=40, min_pred_l=1, max_pred_l=8,
              context_bsz=8, query_bsz=6)
INT8_SET = dict(video_score_mode="pallas_int8", video_topk_fused=True,
                span_score_mode="simsweep_cat_int8_flat", span_topk_mode="grouped_shift_psort")
# every approximate site holds no more elements than its bins here
APPROX_SET = dict(video_topk_approx=True, span_topk_mode="grouped_shift_approx",
                  topk_approx_recall=0.9)
TOL = 2e-4
INT8_RTOL = 2.4e-7
OUT_KEYS = ("topv_idx", "topv_scores", "vcmr_vid_global", "vcmr_st", "vcmr_ed",
            "vcmr_scores", "svmr_st", "svmr_ed", "svmr_scores")


@pytest.fixture(scope="module")
def setup():
    world = make_synthetic_world(n_videos=N_VIDEOS, n_queries=12, vid_dim=16, text_dim=12,
                                 max_clips=12, seed=5)
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
    qb = builder.build_query_batch(world.annotations[:NQ])
    gt = np.arange(NQ, dtype=np.int32) % N_VIDEOS
    return world, builder, jm, variables, tm, qb, gt


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _port_sharded(tm, cfg, cache, k, qb, gt, do_svmr=True):
    mesh = make_mesh(k, devices=["cpu"] * k)
    sc = sr.shard_corpus_cache(cache, mesh, cfg)
    vf2, sf2 = (sr.cat_mode_feat2_args(sc) if cfg.cat_mode and sc.feat2_cat is not None
                else (sc.video_feat2, sc.sub_feat2))
    out = sr.score_query_batch_sharded(
        tm, cfg, torch.from_numpy(qb.query_feat), torch.from_numpy(qb.query_mask),
        sc.video_feat1, vf2, sc.sub_feat1, sf2, sc.mask, torch.from_numpy(gt), do_svmr, mesh)
    return {k: v.numpy() for k, v in out.items()}


def _jax_vs_port(setup, k, **modes):
    world, builder, jm, variables, tm, qb, gt = setup
    mesh = jmesh.make_mesh(k)
    cfg = je.RetrievalConfig(**COMMON, **modes, pallas_interpret=True)
    enc = dataclasses.replace(
        cfg, video_score_mode="einsum",
        span_score_mode=("simsweep_cat" if cfg.span_score_mode == "simsweep_cat_int8_flat"
                         else cfg.span_score_mode))
    jcache = je.encode_corpus(jm, variables, builder, world.corpus, enc)
    tcache = te.CorpusCache(*(_t(getattr(jcache, f)) for f in (
        "video_feat1", "video_feat2", "sub_feat1", "sub_feat2", "mask")),
        n_videos=jcache.n_videos, metas=jcache.metas, feat2_cat=_t(jcache.feat2_cat),
        feat2_cat_scale=_t(jcache.feat2_cat_scale))
    if cfg.video_score_mode == "einsum" and cfg.span_score_mode == "gather":
        arrs, _ = jsr.pad_videos_to_multiple(
            [jcache.video_feat1, jcache.video_feat2, jcache.sub_feat1, jcache.sub_feat2,
             jcache.mask], jcache.n_videos, k)
        sh = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("data"))
        vf1, vf2, sf1, sf2, mask = [jax.device_put(a, sh) for a in arrs]
    else:
        jcache = jsr.shard_corpus_cache(jcache, mesh, cfg=cfg)
        vf1, sf1, mask = jcache.video_feat1, jcache.sub_feat1, jcache.mask
        vf2, sf2 = jsr.cat_mode_feat2_args(jcache)
    jout = jsr.score_query_batch_sharded(jm, variables, cfg, jnp.asarray(qb.query_feat),
                                         jnp.asarray(qb.query_mask), vf1, vf2, sf1, sf2,
                                         mask, jnp.asarray(gt), True, mesh)
    tout = _port_sharded(tm, te.RetrievalConfig(**COMMON, **modes), tcache, k, qb, gt)
    return {k: np.asarray(v) for k, v in jout.items()}, tout


@pytest.mark.parametrize("name,modes,k", [
    ("f32", {}, 2), ("f32", {}, 4), ("int8", INT8_SET, 2), ("int8", INT8_SET, 4),
    ("approx", APPROX_SET, 2)])
def test_sharded_matches_jax(setup, name, modes, k):
    """One JAX program compiled per case."""
    if name == "approx":
        # every selection holds at most its bins: both packages are exact
        nv_local = -(-N_VIDEOS // k)
        L, W = KW["max_ctx_l"], COMMON["max_pred_l"] - COMMON["min_pred_l"]
        v = min(COMMON["max_vcmr_video"], nv_local)
        assert approx_topk.bins(nv_local, v, 0.9) == nv_local
        for n in (v * L, COMMON["max_before_nms"] * W):
            assert approx_topk.bins(n, COMMON["max_before_nms"], 0.9) >= n
    jout, tout = _jax_vs_port(setup, k, **modes)
    assert set(jout) == set(tout) == set(OUT_KEYS)
    for key in OUT_KEYS:
        if key.endswith("scores"):
            if name == "int8":
                np.testing.assert_allclose(tout[key], jout[key], rtol=INT8_RTOL, atol=0,
                                           err_msg=key)
            else:
                np.testing.assert_allclose(tout[key], jout[key], rtol=TOL, atol=1e-30,
                                           err_msg=key)
        else:
            np.testing.assert_array_equal(tout[key], jout[key], err_msg=key)


# ---------------------------------------------------------------- port vs port
PORT_MODES = {
    "gather": dict(),
    "gather_shift_presxp": dict(span_topk_mode="grouped_shift", video_topk_pre_exp=True),
    "simsweep_psort": dict(span_score_mode="simsweep", span_topk_mode="grouped_shift_psort",
                           video_topk_psort=True),
    "cat_pallas_pad": dict(span_score_mode="simsweep_cat", video_score_mode="pallas",
                           span_topk_mode="grouped_shift8", span_sim_pad_l=128),
    "cat_bf16_i8_psort": dict(span_score_mode="simsweep_cat_bf16",
                              video_score_mode="pallas_int8", video_topk_psort=True,
                              video_topk_pre_exp=True, span_topk_mode="grouped_shift_psort"),
    "cat_int8_fused": dict(span_score_mode="simsweep_cat_int8", video_score_mode="pallas",
                           video_topk_fused=True, span_topk_mode="grouped_shift"),
    "int8_set": INT8_SET,
    "approx": APPROX_SET,
}


@pytest.fixture(scope="module")
def planted(setup):
    """The port's einsum-layout buffers with the best video of query 0
    copied into two other videos, in other shards for k = 2 and 4."""
    world, builder, _, _, tm, qb, gt = setup
    cfg = te.RetrievalConfig(**COMMON)
    cache = te.encode_corpus(tm, builder, world.corpus, cfg)
    ref = te._score_query_batch(tm, cfg, torch.from_numpy(qb.query_feat),
                                torch.from_numpy(qb.query_mask), cache.video_feat1,
                                cache.video_feat2, cache.sub_feat1, cache.sub_feat2,
                                cache.mask, torch.from_numpy(gt), True)
    best = int(ref["topv_idx"][0, 0])
    copies = [v for v in (12, 17, 6) if v != best][:2]
    bufs = dict(vf1=cache.video_feat1, vf2=cache.video_feat2, sf1=cache.sub_feat1,
                sf2=cache.sub_feat2, mask=cache.mask)
    for key in bufs:
        bufs[key] = bufs[key].clone()
        bufs[key][copies] = bufs[key][best].clone()
    return bufs, best, copies


def _caches(tm, corpus, cfg, bufs):
    """(single-device cache in cfg's layout, einsum-layout cache to shard)."""
    def finish(c):
        b = dict(bufs)
        if c.cat_mode:
            b["feat2_cat"] = torch.cat([b.pop("vf2"), b.pop("sf2")], dim=-1)
        return te._finish_cache(tm, c, corpus, b)
    flat8 = cfg.span_score_mode == "simsweep_cat_int8_flat"
    return finish(cfg), finish(dataclasses.replace(
        cfg, video_score_mode="einsum",
        span_score_mode="simsweep_cat" if flat8 else cfg.span_score_mode))


def _single(tm, cfg, c, qb, gt, do_svmr=True):
    out = te._score_query_batch(tm, cfg, torch.from_numpy(qb.query_feat),
                                torch.from_numpy(qb.query_mask), c.video_feat1,
                                c.video_feat2, c.sub_feat1, c.sub_feat2, c.mask,
                                torch.from_numpy(gt), do_svmr, feat2_cat=c.feat2_cat,
                                feat2_cat_scale=c.feat2_cat_scale)
    out = {k: v.numpy() for k, v in out.items()}
    out["vcmr_vid_global"] = np.take_along_axis(out["topv_idx"], out.pop("vcmr_vid_local"), 1)
    return out


def _assert_equal_outputs(single, sharded, rtol):
    assert set(single) == set(sharded)
    for key in single:
        if key.endswith("scores"):
            np.testing.assert_allclose(sharded[key], single[key], rtol=rtol, atol=1e-30,
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(sharded[key], single[key], err_msg=key)


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("name", list(PORT_MODES))
def test_sharded_equals_single_device(setup, planted, name, k):
    world, builder, _, _, tm, qb, gt = setup
    bufs, best, copies = planted
    cfg = te.RetrievalConfig(**COMMON, **PORT_MODES[name])
    single_cache, shard_input = _caches(tm, world.corpus, cfg, bufs)
    single = _single(tm, cfg, single_cache, qb, gt)
    # the planted copies score alike, so their order is the tie-break
    assert set(copies) <= set(single["topv_idx"][0].tolist()) or name == "approx"
    sharded = _port_sharded(tm, cfg, shard_input, k, qb, gt)
    _assert_equal_outputs(single, sharded, rtol=1e-6)


@pytest.mark.parametrize("k", [2, 4])
def test_without_svmr_and_without_the_merged_head(setup, planted, k):
    """SVMR off on the fast path, and the other branch (no merged span
    head: every video's spans, then the top-V rows) with SVMR on."""
    world, builder, _, _, tm, qb, gt = setup
    bufs, _, _ = planted
    cfg = te.RetrievalConfig(**COMMON, span_topk_mode="grouped_shift_psort")
    single_cache, shard_input = _caches(tm, world.corpus, cfg, bufs)
    single = _single(tm, cfg, single_cache, qb, gt, do_svmr=False)
    _assert_equal_outputs(single, _port_sharded(tm, cfg, shard_input, k, qb, gt, False), 1e-6)

    other = XML(XMLConfig(**KW, merge_two_stream=False)).init_weights(
        torch.Generator().manual_seed(3)).eval()
    cache = te.encode_corpus(other, builder, world.corpus, cfg)
    single = _single(other, cfg, cache, qb, gt)
    _assert_equal_outputs(single, _port_sharded(other, cfg, cache, k, qb, gt), 1e-6)


def test_shard_corpus_cache_layouts(setup, planted):
    """Each shard's flat rows are the single-device flat rows of its
    videos, and the flat single-device layouts are refused."""
    world, _, _, _, tm, _, _ = setup
    bufs, _, _ = planted
    cfg = te.RetrievalConfig(**COMMON, **INT8_SET)
    single, shard_input = _caches(tm, world.corpus, cfg, bufs)
    k = 2
    sc = sr.shard_corpus_cache(shard_input, make_mesh(k, devices=["cpu"] * k), cfg)
    lp, nvl = 16, 16                         # flat_lp(12); 19 -> 32 videos over 2 shards
    assert sc.video_feat1[0].shape == (nvl * lp, KW["hidden_size"])
    assert torch.equal(sc.video_feat1[0], single.video_feat1[:nvl * lp])
    assert torch.equal(sc.video_feat1[1][:3 * lp], single.video_feat1[nvl * lp:19 * lp])
    assert sc.feat2_cat[0].shape == (nvl * lp, 2 * KW["hidden_size"])      # flat_lp(12) rows
    assert torch.equal(sc.feat2_cat[0], single.feat2_cat[:nvl * lp])
    assert torch.equal(sc.feat2_cat_scale[1][:3], single.feat2_cat_scale[nvl:19])
    assert not bool(sc.mask[1][3:].any()) and sc.n_videos == N_VIDEOS
    with pytest.raises(ValueError, match="FLAT"):
        sr.shard_corpus_cache(single, make_mesh(2, devices=["cpu"] * 2), cfg)


@pytest.mark.parametrize("mode", [dict(), dict(flat=True), dict(flat=True, int8=True)])
def test_streaming_with_a_mesh_equals_streaming_without(setup, mode):
    world, builder, _, _, tm, qb, gt = setup
    cfg = te.RetrievalConfig(**COMMON)
    host = ts.host_cache_from_device(te.encode_corpus(tm, builder, world.corpus, cfg), **mode)
    q = (torch.from_numpy(qb.query_feat), torch.from_numpy(qb.query_mask))
    for block, k in ((8, 2), (8, 4), (12, 2)):
        # flat blocks round up to 16 k videos; 19 videos: the last block is padded
        mesh = make_mesh(k, devices=["cpu"] * k)
        want = ts.streaming_score_query_batch(
            tm, cfg, *q, host, gt, block_videos=-(-block // (16 * k if mode else k))
            * (16 * k if mode else k))
        got = ts.streaming_score_query_batch(tm, cfg, *q, host, gt, block_videos=block,
                                             mesh=mesh)
        for key in want:
            assert torch.equal(got[key], want[key]), (key, block, k)


def test_retrieve_passes_the_streaming_mesh(setup):
    world, builder, _, _, tm, _, _ = setup
    cfg = te.RetrievalConfig(**COMMON)
    cache = te.encode_corpus(tm, builder, world.corpus, cfg)
    host = ts.host_cache_from_device(cache, flat=True, int8=True)
    rows = world.annotations[:NQ]
    run = lambda **kw: te.retrieve(tm, builder, cache, rows, world.corpus, cfg,
                                   streaming_host=host, **kw)
    assert run(streaming_block_videos=32) == run(
        streaming_block_videos=8, streaming_mesh=make_mesh(2, devices=["cpu"] * 2))


def test_mesh_and_shard_batch():
    mesh = make_mesh(4, devices=["cpu"] * 4)
    assert mesh.size == 4 and mesh.shape == {"data": 4}
    assert mesh.devices == (torch.device("cpu"),) * 4
    assert make_mesh(2, devices=["cpu"] * 3).size == 2
    parts = shard_batch({"x": torch.arange(8), "y": np.ones((8, 3))}, mesh)
    assert [p.tolist() for p in parts["x"]] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert all(p.shape == (2, 3) for p in parts["y"])
    with pytest.raises(ValueError, match="does not split"):
        shard_batch({"x": torch.arange(6)}, mesh)
    with pytest.raises(ValueError, match="only 3 devices"):
        make_mesh(4, devices=["cpu"] * 3)
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="CUDA cards"):
        make_mesh(n_cards + 1)
    if n_cards == 0:
        with pytest.raises(ValueError, match="CUDA"):
            make_mesh(2, devices=["cuda:0"] * 2)


def test_a_shard_on_the_wrong_device_is_refused(setup, planted):
    world, _, _, _, tm, qb, gt = setup
    bufs, _, _ = planted
    cfg = te.RetrievalConfig(**COMMON)
    _, cache = _caches(tm, world.corpus, cfg, bufs)
    sc = sr.shard_corpus_cache(cache, make_mesh(2, devices=["cpu"] * 2), cfg)
    with pytest.raises(ValueError, match="2 shards for a mesh of 4"):
        sr.score_query_batch_sharded(
            tm, cfg, torch.from_numpy(qb.query_feat), torch.from_numpy(qb.query_mask),
            sc.video_feat1, sc.video_feat2, sc.sub_feat1, sc.sub_feat2, sc.mask,
            torch.from_numpy(gt), True, make_mesh(4, devices=["cpu"] * 4))


@pytest.mark.parametrize("L,min_l,max_l", [(12, 1, 8), (10, 2, 6), (100, 2, 16), (3, 1, 8)])
def test_band_tables_are_built_on_the_device(L, min_l, max_l):
    """The span ops' band tables come from device aranges (no host table
    copied into the shard loop), equal to the host tables."""
    from tvretrieval_tpu_torch.ops import span
    idx, valid = span._band_tables(L, min_l, max_l, torch.device("cpu"))
    idx_np, valid_np, W = span._band_indices(L, min_l, max_l)
    assert idx.shape == (L, W) and idx.dtype == torch.int64 and valid.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), idx_np)
    np.testing.assert_array_equal(valid.numpy(), valid_np)
