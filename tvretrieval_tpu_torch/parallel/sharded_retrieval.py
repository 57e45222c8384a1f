"""Corpus-sharded retrieval over a device mesh, in PyTorch.

Port of tvretrieval_tpu/parallel/sharded_retrieval.py. The encoded-corpus
cache is split over the VIDEO axis of a 1-D mesh (``parallel.mesh``); each
shard scores the queries against its own videos and only small candidate
tensors cross devices:

  1. per-shard top-V video scores, copied to the first device with their
     global video indices (the all-gather); one two-key sort there
     (descending score, ascending global index) gives the EXACT global
     top-V, with the single-device engine's stable tie order, and its
     indices go back to every shard;
  2. each shard scores spans only for its local candidates, marks the ones
     inside the global top-V (the reference's span scoring restricted to
     the global top-V videos, inference.py:346-374), and emits its local
     top-N span candidates with a CANONICAL flat index
     (global rank * L * W + st * W + band offset);
  3. the (Nq, k * N) candidate strips concatenate on the first device, and
     a two-key sort (descending score, ascending canonical index)
     reproduces the single-device engine's flat top-k order given equal
     scores;
  4. the SVMR probabilities of each query's ground-truth video live on the
     shard that owns it; the one-hot contributions are summed (the psum).

All shards run from one process, in one loop that never waits for a
device (no ``.item()``, no ``.cpu()``, no shape read from data), so on k
cards the shards' kernels overlap; on one card with logical shards
(``make_mesh(k, devices=["cuda:0"] * k)``) they queue on one stream. Each
shard runs the resident engine's stages (``retrieval.stages``) on its own
slice, so a wrapper's launch count grows by k per batch where the engine's
grows by 1: B1 / B2 / B3 on the shard's flat feat1 rows, B11 under
``video_topk_approx`` and "grouped_shift_approx", B6 under
``video_topk_psort`` and "grouped_shift_psort", B5 under
"simsweep_cat_int8_flat".

Exactness: selection, merge and tie-break are exact. Score values can
differ from the single-device engine only by the f32 summation order of
products over differently tiled shards; the integer modes (B1, B5) are
bit-equal. The approximate selections approximate per shard row and the
merge stays exact, so the global recall is at least the per-shard target.
"""
from __future__ import annotations

import copy
import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from tvretrieval_tpu_torch.models.xml import XML
from tvretrieval_tpu_torch.ops.masking import NEG_INF
from tvretrieval_tpu_torch.ops.span import banded_top_spans_from_probs, banded_topk_spans
from tvretrieval_tpu_torch.parallel.mesh import Mesh, batch_sharding
from tvretrieval_tpu_torch.retrieval import stages
from tvretrieval_tpu_torch.retrieval.engine import CorpusCache

Sharded = Tuple[torch.Tensor, ...]
# stages.flat_layout's keys -> CorpusCache fields
_LAYOUT_FIELDS = {"vf1": "video_feat1", "sf1": "sub_feat1", "mask": "mask",
                  "feat2_cat": "feat2_cat", "feat2_cat_scale": "feat2_cat_scale"}


def pad_videos_to_multiple(arrs: Sequence[Optional[torch.Tensor]], n_videos: int,
                           multiple: int) -> Tuple[List[Optional[torch.Tensor]], int]:
    """Zero-pad axis 0 of each tensor (None stays None) so that its length
    is a multiple of ``multiple``; returns (tensors, padded length)."""
    pad = (-n_videos) % multiple
    if pad == 0:
        return list(arrs), n_videos
    out = [None if a is None else
           torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))]) for a in arrs]
    return out, n_videos + pad


def shard_corpus_cache(cache: CorpusCache, mesh: Mesh, cfg=None,
                       chunk_v: Optional[int] = None) -> CorpusCache:
    """The cache with every tensor split over the mesh's video axis: a new
    CorpusCache whose tensor fields are tuples of per-shard tensors, each
    on its shard's device (``n_videos`` and ``metas`` stay the corpus's).

    ``cache`` is encoded in video mode "einsum": (Nv, L, D) feat1, and a
    flat layout is refused. chunk_v defaults to ``cfg.video_chunk_v`` (16
    without cfg). cfg=None: the tensors must already be padded to a mesh
    multiple, pad rows with mask 0. cfg given: the videos are zero-padded
    to a multiple of mesh.size, or of mesh.size * chunk_v under the kernel
    video modes ("pallas", "pallas_int8") and "simsweep_cat_int8_flat", so
    that every shard holds whole chunk_v blocks; each shard then builds its
    own flat layouts as the single-device engine builds them
    (``stages.flat_layout``: the flat feat1 rows, int8 under "pallas_int8",
    and under "simsweep_cat_int8_flat" the int8 flat feat2 from a
    ``simsweep_cat`` cache). A flat layout is video-major, so building it
    per shard gives the same rows as building it whole and splitting it at
    video boundaries. Pad videos are fully masked;
    ``score_query_batch_sharded`` restores their exact -1e10 einsum-path
    score from the mask."""
    if cache.video_feat1 is not None and cache.video_feat1.dim() == 2:
        raise ValueError(
            "cache holds the FLAT single-device feat1 layout; pass the (Nv, L, D) "
            "cache and let shard_corpus_cache build the per-shard flat layout (cfg "
            "with video_score_mode='pallas')")
    if cache.feat2_cat is not None and cache.feat2_cat.dim() == 2:
        raise ValueError(
            "cache holds the FLAT single-device int8 feat2 layout; encode with "
            "span_score_mode='simsweep_cat' and let shard_corpus_cache build the "
            "per-shard flat layout (cfg with span_score_mode='simsweep_cat_int8_flat')")
    if chunk_v is None:
        chunk_v = getattr(cfg, "video_chunk_v", 16) if cfg is not None else 16
    names = ("video_feat1", "video_feat2", "sub_feat1", "sub_feat2", "mask",
             "feat2_cat", "feat2_cat_scale")
    arrs = [getattr(cache, n) for n in names]
    pallas = flat2 = False
    if cfg is not None:
        pallas = (cfg.video_score_mode in stages.KERNEL_VIDEO_MODES
                  and cache.video_feat1 is not None and cache.sub_feat1 is not None)
        flat2 = cfg.span_score_mode == "simsweep_cat_int8_flat" and cache.feat2_cat is not None
        mult = mesh.size * (chunk_v if (pallas or flat2) else 1)
        arrs, _ = pad_videos_to_multiple(arrs, cache.mask.shape[0], mult)
    if flat2 and cache.feat2_cat.dtype == torch.int8:
        raise ValueError("simsweep_cat_int8_flat shards a simsweep_cat cache (float "
                         "feat2_cat); got an int8 one")
    put = batch_sharding(mesh).put
    shards = {n: None if a is None else put(a) for n, a in zip(names, arrs)}
    if pallas or flat2:
        built = [stages.flat_layout(cfg, {k: None if shards[n] is None else shards[n][s]
                                          for k, n in _LAYOUT_FIELDS.items()},
                                    chunk_v, shard=True) for s in range(mesh.size)]
        shards.update({n: None if built[0][k] is None else tuple(b[k] for b in built)
                       for k, n in _LAYOUT_FIELDS.items()})
    return dataclasses.replace(cache, **shards)


def cat_mode_feat2_args(cache: CorpusCache) -> Tuple[Sharded, Sharded]:
    """(video_feat2, sub_feat2) slots for a sharded cat-mode cache:
    feat2_cat rides the video_feat2 slot, and the sub_feat2 slot gets the
    int8 cache's per-row scales or, for a float cache, a zero-width
    placeholder per shard. ``score_query_batch_sharded`` reads the slots so
    when cfg.span_score_mode starts with "simsweep_cat"."""
    if cache.feat2_cat_scale is not None:
        return cache.feat2_cat, cache.feat2_cat_scale
    return cache.feat2_cat, tuple(f.new_zeros((f.shape[0], 1, 0)) for f in cache.feat2_cat)


def _sort_desc_by_score_then_idx(scores: torch.Tensor, idx: torch.Tensor,
                                *extras: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Two-key sort along the last axis: descending score, ascending
    tie-break index, extras carried along — the tie order of a stable
    top-k over an index-ordered flat array. A stable sort by index, then a
    stable descending sort by score."""
    order = torch.sort(idx, dim=-1, stable=True).indices
    s = torch.gather(scores, -1, order)
    by_score = torch.sort(s, dim=-1, descending=True, stable=True).indices
    order = torch.gather(order, -1, by_score)
    return tuple(torch.gather(t, -1, order) for t in (scores, idx) + extras)


def replicate_model(model: XML, mesh: Mesh) -> Dict[torch.device, XML]:
    """The model on every distinct device of the mesh: the model itself on
    its own device, an eval-mode copy elsewhere (a real multi-card mesh)."""
    home = next(model.parameters()).device
    out = {home: model}
    for d in mesh.devices:
        if d not in out:
            out[d] = copy.deepcopy(model).to(d).eval()
    return out


def _to(x: torch.Tensor, d: torch.device) -> torch.Tensor:
    return x.to(d, non_blocking=True)


def _check_shards(mesh: Mesh, name: str, t: Optional[Sharded]) -> None:
    if t is None:
        return
    if len(t) != mesh.size:
        raise ValueError(f"{name}: {len(t)} shards for a mesh of {mesh.size}")
    for i, (x, d) in enumerate(zip(t, mesh.devices)):
        if x.device != d:
            raise ValueError(f"{name}: shard {i} lies on {x.device}, its mesh device is {d}")


@torch.no_grad()
def score_query_batch_sharded(model: XML, cfg, query_feat, query_mask,
                              video_feat1: Sharded, video_feat2: Sharded,
                              sub_feat1: Sharded, sub_feat2: Sharded, ctx_mask: Sharded,
                              gt_meta_idx, do_svmr: bool, mesh: Mesh,
                              models: Optional[Dict[torch.device, XML]] = None
                              ) -> Dict[str, torch.Tensor]:
    """Sharded equivalent of ``retrieval.engine._score_query_batch``.

    The cache arguments are per-shard tuples from ``shard_corpus_cache``
    (cat span modes: the feat2 slots from ``cat_mode_feat2_args``);
    query_feat / query_mask / gt_meta_idx (global video indices) lie on any
    device. ``models`` maps each mesh device to the model there
    (``replicate_model``; made per call when None). Returns tensors on
    ``mesh.devices[0]``: topv_scores, topv_idx (global, int32),
    vcmr_scores, vcmr_vid_global (global video indices, not the engine's
    local ones), vcmr_st, vcmr_ed, and with do_svmr svmr_st, svmr_ed,
    svmr_scores."""
    for name, t in (("video_feat1", video_feat1), ("video_feat2", video_feat2),
                    ("sub_feat1", sub_feat1), ("sub_feat2", sub_feat2),
                    ("ctx_mask", ctx_mask)):
        _check_shards(mesh, name, t)
    if models is None:
        models = replicate_model(model, mesh)
    f32 = torch.float32
    V, N, alpha = cfg.max_vcmr_video, cfg.max_before_nms, cfg.q2c_alpha
    W = cfg.max_pred_l - cfg.min_pred_l
    fast = model.cfg.merged_spans
    home = mesh.devices[0]
    nv_local = ctx_mask[0].shape[0]
    v_local = min(V, nv_local)
    gt = torch.as_tensor(gt_meta_idx).to(home, torch.int64) if do_svmr else None
    up = lambda x: None if x is None else x.to(f32)
    at = lambda t, s: None if t is None else t[s]

    if fast:
        # the query vectors once, on the model's device; each shard takes a copy
        model_dev = next(model.parameters()).device
        vq0, sq0 = model.encode_query(_to(query_feat, model_dev), _to(query_mask, model_dev))

    # ---- phase 1 per shard: video scores and the local top-v_local
    local = []
    for s, dev in enumerate(mesh.devices):
        m = models[dev]
        vf1, sf1, cmask = at(video_feat1, s), at(sub_feat1, s), ctx_mask[s]
        st = dict(dev=dev, base=s * nv_local, cmask=cmask)
        fused = None
        if fast:
            vq, sq = _to(vq0, dev), _to(sq0, dev)
            st.update(vq=vq, sq=sq)
            # per-shard flat kernel (B1 / B2 / B3) over the shard's own rows,
            # or the einsum
            q2c, fused = stages.video_scores(cfg, vq, sq, vf1, sf1, cmask)
            if vf1.dim() == 2:
                # the kernels ignore the mask, so a pad video scores 0 and
                # is put back to the einsum path's exact -1e10 from it
                has_clip = cmask.amax(dim=1) > 0                             # (nv_local,)
                if fused is not None:
                    # B3's, then the JAX program's four steps: the trailing
                    # pad videos (validity is a prefix by construction) to
                    # -1e10, the block maxima of all-pad blocks to -1e10 (or
                    # -inf past the shard), and the one block straddling the
                    # valid count re-maxed from the corrected scores; every
                    # other block's kernel maximum is exact
                    scores_pad, bmax = fused
                    nvp, nb = scores_pad.shape[1], bmax.shape[1]
                    chunk = nvp // nb
                    n_valid = has_clip.sum()
                    vidx = torch.arange(nvp, device=dev)
                    scores_pad = torch.where((vidx[None] >= n_valid) & (vidx[None] < nv_local),
                                             NEG_INF, scores_pad)
                    bend = (torch.arange(nb, device=dev) + 1) * chunk
                    bstart = bend - chunk
                    past = torch.full_like(bmax, -torch.inf).masked_fill(
                        (bstart < nv_local)[None].expand_as(bmax), NEG_INF)
                    bmax = torch.where(bend[None] <= n_valid, bmax, past)
                    b = torch.clamp_max(torch.div(n_valid, chunk, rounding_mode="floor"),
                                        nb - 1)
                    straddle = scores_pad.index_select(
                        1, b * chunk + torch.arange(chunk, device=dev)).amax(dim=1)
                    bmax = bmax.scatter(1, b.view(1, 1).expand(bmax.shape[0], 1),
                                        straddle[:, None])
                    fused = (scores_pad, bmax)
                    q2c = scores_pad[:, :nv_local]
                else:
                    q2c = torch.where(has_clip[None, :], q2c, NEG_INF)
        else:
            q2c, st_logits, ed_logits = m.get_pred_from_raw_query(
                _to(query_feat, dev), _to(query_mask, dev), up(vf1), up(at(video_feat2, s)),
                cmask, up(sf1), up(at(sub_feat2, s)), cmask, cross=True)
            st["st_probs_all"] = torch.softmax(st_logits.to(f32), dim=-1)
            st["ed_probs_all"] = torch.softmax(ed_logits.to(f32), dim=-1)

        # the local selection, in the JAX program's precedence
        sel, idx, pre_exp = stages.select_videos(cfg, q2c, v_local, fused)
        idx = idx.long()
        st.update(sel=sel, idx=idx, gidx=idx + st["base"],
                  top=torch.exp(alpha * sel) if pre_exp else sel)
        local.append(st)

    # ---- the all-gather and the exact global top-V on the first device
    all_scores = torch.cat([_to(st["sel"], home) for st in local], dim=1)
    all_gidx = torch.cat([_to(st["gidx"], home) for st in local], dim=1)
    topv_scores_g, topv_idx_g = (t[:, :V] for t in
                                 _sort_desc_by_score_then_idx(all_scores, all_gidx))
    if pre_exp:
        topv_scores_g = torch.exp(alpha * topv_scores_g)

    # ---- phase 2 per shard: spans of the local candidates in the global top-V
    cands, svmr = [], []
    for s, st in enumerate(local):
        dev, m, cmask, base = st["dev"], models[st["dev"]], st["cmask"], st["base"]
        eq = st["gidx"][:, :, None] == _to(topv_idx_g, dev)[:, None, :]  # (Nq, vl, V)
        keep = eq.any(dim=-1).to(f32)
        rank = torch.argmax(eq.to(torch.uint8), dim=-1)                    # valid iff keep
        if do_svmr:
            local_gt = _to(gt, dev) - base
            owned = ((local_gt >= 0) & (local_gt < nv_local)).to(f32)
        if fast:
            gather_idx = (torch.cat([st["idx"], local_gt.clamp(0, nv_local - 1)[:, None]], 1)
                          if do_svmr else st["idx"])
            # the cat modes' feat2 slots hold (feat2_cat, scales): cat_mode_feat2_args
            st_logits, ed_logits = stages.span_logits(
                m, cfg.span_score_mode, st["vq"], st["sq"], (video_feat2[s], sub_feat2[s]),
                cmask, gather_idx)
            st_probs = torch.softmax(st_logits.to(f32), dim=-1)
            ed_probs = torch.softmax(ed_logits.to(f32), dim=-1)
            st_top, ed_top = st_probs[:, :v_local], ed_probs[:, :v_local]
            if do_svmr:
                svmr.append((_to(st_probs[:, v_local] * owned[:, None], home),
                             _to(ed_probs[:, v_local] * owned[:, None], home)))
        else:
            rows = torch.arange(st["idx"].shape[0], device=dev)[:, None]
            st_top = st["st_probs_all"][rows, st["idx"]]
            ed_top = st["ed_probs_all"][rows, st["idx"]]
            if do_svmr:
                safe = local_gt.clamp(0, nv_local - 1)
                r0 = rows[:, 0]
                svmr.append((_to(st["st_probs_all"][r0, safe] * owned[:, None], home),
                             _to(st["ed_probs_all"][r0, safe] * owned[:, None], home)))

        L = st_top.shape[-1]
        n_local = min(N, v_local * L * W)
        # "grouped" has no keep_mask in the port: it runs as the flat
        # selection, as the JAX program does (bit-equal; the others keep B6, B11)
        span_topk = (banded_topk_spans if cfg.span_topk_mode == "grouped"
                     else stages.span_topk(cfg))
        vid_loc, st_i, ed_i, scores = span_topk(st_top, ed_top, st["top"], cfg.min_pred_l,
                                                cfg.max_pred_l, n_local, keep_mask=keep)
        vid_loc = vid_loc.long()
        canon = (torch.gather(rank, 1, vid_loc) * (L * W) + st_i.long() * W
                 + (ed_i.long() - st_i.long() - cfg.min_pred_l))
        cands.append(tuple(_to(t, home) for t in (
            scores, canon, torch.gather(st["gidx"], 1, vid_loc), st_i, ed_i)))

    # ---- the global merge (small tensors): the single-device flat top-k order
    scores, canon, vid, st_i, ed_i = _sort_desc_by_score_then_idx(
        *(torch.cat([c[i] for c in cands], dim=1) for i in range(5)))
    out = dict(topv_scores=topv_scores_g, topv_idx=topv_idx_g.to(torch.int32),
               vcmr_scores=scores[:, :N], vcmr_vid_global=vid[:, :N].to(torch.int32),
               vcmr_st=st_i[:, :N], vcmr_ed=ed_i[:, :N])
    if do_svmr:
        st_gt = functools.reduce(torch.add, (p[0] for p in svmr))
        ed_gt = functools.reduce(torch.add, (p[1] for p in svmr))
        svmr_st, svmr_ed, svmr_scores = banded_top_spans_from_probs(
            st_gt, ed_gt, cfg.min_pred_l, cfg.max_pred_l, N)
        out.update(svmr_st=svmr_st, svmr_ed=svmr_ed, svmr_scores=svmr_scores)
    return out
