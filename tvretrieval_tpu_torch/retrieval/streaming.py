"""Streaming corpus retrieval for a corpus larger than device memory.

Port of tvretrieval_tpu/retrieval/streaming.py. The encoded corpus stays
in host memory, pinned when a card is present so that a copy from it is
asynchronous, and each query batch runs in two phases on the model's
device:

1. video ranking: feat1 streams to the device in blocks of
   ``block_videos`` videos and a running top-V merge keeps the best videos
   of each query. On a card each block is copied on a copy stream of its
   own into one of two preallocated block buffers, in turn, while the
   compute stream scores the block before it: the copy waits for the last
   kernel that read its buffer, the scorer waits for the copy, and the
   host never waits inside this phase. A block is scored by the masked
   max of cosine scores (host mode "einsum"), by B2 over the flat layout
   (``ops.video_score.video_scores_flat``, "flat") or by B1 over its int8
   quantization (``video_scores_flat_i8``, "flat_int8");
2. span scoring: only the top-V (+ GT) rows of feat2 and the mask are
   gathered on the host (``torch.index_select`` into a pinned buffer) and
   shipped once; the span stage is the resident engine's span mode
   "gather" on those rows.

With a device mesh (``parallel.mesh``) each block is split into one
contiguous sub-block per mesh device, copied and scored there, and only
the (Nq, B) scores meet on the model's device for the merge.

The device memory a batch takes does not grow with the number of videos:
two blocks, the running state and the gathered rows. Results equal the
resident engine's (retrieval.engine, span mode "gather", video mode
"einsum", "pallas" or "pallas_int8") up to the f32 summation order of the
video scores; under "flat_int8" the video scores are integer-exact, so
the video ranking is equal. Only the residency differs.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import List, Optional

import torch

from tvretrieval_tpu_torch.models.xml import XML, _rows_dot, l2_normalize
from tvretrieval_tpu_torch.ops.masking import NEG_INF, mask_logits
from tvretrieval_tpu_torch.ops.span import banded_top_spans_from_probs, topk_stable
from tvretrieval_tpu_torch.ops.video_score import (
    flat_lp,
    flat_rows,
    quantize_unit_i8,
    video_scores_flat,
    video_scores_flat_i8,
)
from tvretrieval_tpu_torch.retrieval import stages

# videos converted and copied to the host at a time by host_cache_from_device
HOST_CHUNK_VIDEOS = 1024


@dataclass
class HostCorpusCache:
    """The encoded corpus in host memory (feat1 normalized, as in the
    resident cache), as CPU tensors, pinned when a card is present.

    flat=True: the feat1 slots hold the video-major flat mask-free layout
    of ``ops.video_score.build_flat_feat1`` without its video padding,
    (Nv * lp, D); a block is then a contiguous row range, scored by B2, or
    by B1 when ``int8`` (the layout quantized by ``quantize_unit_i8``: half
    the host memory and half the bytes a block copies). ``video_valid``
    gives a video without a valid clip the einsum path's exact -1e10, which
    the mask-free layout cannot represent."""

    video_feat1: torch.Tensor   # (Nv, L, D), or (Nv * lp, D) when flat
    video_feat2: torch.Tensor   # (Nv, L, D)
    sub_feat1: torch.Tensor
    sub_feat2: torch.Tensor
    mask: torch.Tensor          # (Nv, L)
    n_videos: int
    flat: bool = False
    lp: int = 0
    video_valid: Optional[torch.Tensor] = None   # (Nv,) bool, flat mode only
    int8: bool = False


@dataclass
class StreamTimes:
    """What one ``streaming_score_query_batch`` call on a card records for
    a caller that measures it: CUDA events (timing enabled) of each block's
    copy on the copy stream and of its score and merge on the compute
    stream, of phase 1 on the compute stream, and of phase 2's one
    host-to-device copy; phase 2's host gather in host seconds."""

    blocks: List[tuple] = field(default_factory=list)   # (copy0, copy1, score0, score1)
    phase1: tuple = ()
    gather_s: float = 0.0
    feat2_copy: tuple = ()


def host_cache_from_device(cache, flat: bool = False, int8: bool = False) -> HostCorpusCache:
    """Copy a resident ``CorpusCache`` (encoded with video mode "einsum":
    (Nv, L, D) feat1, both feat2 streams) into host memory, pinned when a
    card is present, HOST_CHUNK_VIDEOS videos at a time.

    flat=True converts feat1 to the flat layout on the cache's device
    before the copy, and int8=True (which needs flat) quantizes it: the
    bytes of ``build_flat_feat1`` and ``quantize_unit_i8`` without the
    video padding, which the streamed blocks handle. The (Nv, L, D) feat1
    is not kept then: phase 2 needs feat2 only."""
    if cache.video_feat1 is not None and cache.video_feat1.dim() == 2:
        raise ValueError(
            "cache holds the flat feat1 layout (built with video_score_mode="
            "'pallas'); the streaming engine builds its own block layout — "
            "encode with video_score_mode='einsum'")
    if int8 and not flat:
        raise ValueError("int8 host blocks require flat=True (the s8 kernel "
                         "consumes the flat layout)")
    streams = (cache.video_feat1, cache.video_feat2, cache.sub_feat1, cache.sub_feat2)
    if any(t is None for t in streams):
        raise ValueError("the streaming engine needs both streams' feat1 and feat2 (a "
                         "model with the merged two-stream span head)")
    pin = torch.cuda.is_available()
    mask = cache.mask
    nv, L = mask.shape
    lp = flat_lp(L) if flat else 0

    def pull(x, convert=None, rows_per_video=1, dtype=None):
        """x (Nv, ...) -> a new host tensor; ``convert`` maps a chunk of
        videos (and their mask) to its ``rows_per_video`` rows each."""
        row = x.shape[1:] if rows_per_video == 1 else x.shape[2:]
        out = torch.empty((nv * rows_per_video,) + row, dtype=dtype or x.dtype, pin_memory=pin)
        for v0 in range(0, nv, HOST_CHUNK_VIDEOS):
            v1 = min(v0 + HOST_CHUNK_VIDEOS, nv)
            part = x[v0:v1] if convert is None else convert(x[v0:v1], mask[v0:v1])
            out[v0 * rows_per_video:v1 * rows_per_video].copy_(part, non_blocking=pin)
        return out

    def flat_feat1(x, m):
        rows = flat_rows(x, m, lp)
        return quantize_unit_i8(rows) if int8 else rows

    if flat:
        vf1, sf1 = (pull(x, flat_feat1, lp, torch.int8 if int8 else None)
                    for x in (cache.video_feat1, cache.sub_feat1))
        valid = pull(mask.amax(dim=1) > 0)
    else:
        vf1, sf1, valid = pull(cache.video_feat1), pull(cache.sub_feat1), None
    host = HostCorpusCache(
        video_feat1=vf1, video_feat2=pull(cache.video_feat2), sub_feat1=sf1,
        sub_feat2=pull(cache.sub_feat2), mask=pull(mask), n_videos=cache.n_videos,
        flat=flat, lp=lp, video_valid=valid, int8=int8)
    if pin and mask.device.type == "cuda":
        torch.cuda.synchronize(mask.device)      # the copies into pinned memory
    return host


def _block_scorer(host: HostCorpusCache, vqn: torch.Tensor, sqn: torch.Tensor,
                  block_videos: int):
    """score(block) -> (Nq, block_videos) f32 scores of one device block.

    einsum: per stream the masked max over clips of the cosine scores, the
    query cast to the block's dtype, products summed in f32, a masked clip
    at mask_logits' exact -1e10; one matrix product over the block's
    (B * L, D) rows (``_rows_dot``: ``torch.einsum`` would copy the block
    into its own layout first). flat: B2 (B1 on int8 blocks, the queries
    quantized the same way), a video outside ``video_valid`` at -1e10."""
    if host.flat:
        if host.int8:
            qv, qs, kernel = (quantize_unit_i8(vqn).T, quantize_unit_i8(sqn).T,
                              video_scores_flat_i8)
        else:
            dt = host.video_feat1.dtype
            qv, qs, kernel = vqn.to(dt).T, sqn.to(dt).T, video_scores_flat

        def score(vf, sf, valid):
            s = kernel(qv, qs, vf, sf, n_videos=block_videos, lp=host.lp)
            return torch.where(valid[None], s, NEG_INF)
    else:
        def score(vf, sf, mask):
            one = lambda q, f: mask_logits(_rows_dot(q.to(f.dtype), f), mask[None]).amax(dim=-1)
            return (one(vqn, vf) + one(sqn, sf)) / 2
    return score


def _device_blocks(host: HostCorpusCache, block_videos: int, dev: torch.device,
                   times: Optional[StreamTimes]):
    """Yield (offset, [feat1_v, feat1_s, mask or valid]) for each block,
    on ``dev``: ``_shard_blocks`` on one device."""
    for off, parts in _shard_blocks(host, block_videos, (dev,), times):
        yield off, parts[0]


def _shard_blocks(host: HostCorpusCache, block_videos: int, devs, times: Optional[StreamTimes]):
    """Yield (offset, parts) for each block of block_videos videos, split
    into len(devs) contiguous sub-blocks: parts[s] = [feat1_v, feat1_s,
    mask or valid] of videos offset + s * sub ... on devs[s]. The caller
    scores a block before it asks for the next one.

    On a card, per shard: two preallocated sets of sub-block buffers, used
    in turn, and a copy stream of its own; each sub-block is copied from
    pinned host memory on that stream, after the event of the
    compute-stream work that last read its buffers, and the shard's compute
    stream waits for the copy's event. The rows past the corpus in the last
    block are zeroed on the device (zero mask / not valid: -1e10), not
    padded on the host, which would need an unpinned copy. The buffers are
    allocated on the compute stream: each copy stream first waits for the
    work already queued there (their memory may have been freed by it),
    and they stay alive until this generator ends, after the compute
    streams have waited for every copy, so the caching allocator cannot
    hand them out while a copy writes them. ``times`` gets one entry per
    block and shard."""
    n = host.n_videos
    k = len(devs)
    sub = block_videos // k
    r = host.lp if host.flat else 1             # feat1 rows per video
    srcs = ((host.video_feat1, r), (host.sub_feat1, r),
            (host.video_valid, 1) if host.flat else (host.mask, 1))
    shards = []
    for dev in devs:
        sh = dict(dev=dev, cuda=dev.type == "cuda",
                  bufs=[[torch.empty((sub * m,) + src.shape[1:], dtype=src.dtype, device=dev)
                         for src, m in srcs] for _ in range(2)])
        if sh["cuda"]:
            sh["compute"] = torch.cuda.current_stream(dev)
            sh["copy"] = torch.cuda.Stream(dev)
            sh["copy"].wait_stream(sh["compute"])
            sh["ready"] = [torch.cuda.Event(), torch.cuda.Event()]
            sh["free"] = [torch.cuda.Event(), torch.cuda.Event()]
        shards.append(sh)
    timed = lambda: torch.cuda.Event(enable_timing=True)
    for i, off in enumerate(range(0, n, block_videos)):
        slot = i % 2
        evs = []
        for si, sh in enumerate(shards):
            cuda = sh["cuda"]
            o = off + si * sub
            nb = max(0, min(sub, n - o))
            ev = (timed(), timed(), timed(), timed()) if cuda and times is not None else None
            with torch.cuda.stream(sh["copy"]) if cuda else contextlib.nullcontext():
                if cuda:
                    sh["copy"].wait_event(sh["free"][slot])   # a no-op before its first record
                    if ev:
                        ev[0].record(sh["copy"])
                for buf, (src, m) in zip(sh["bufs"][slot], srcs):
                    if nb:
                        buf[:nb * m].copy_(src[o * m:(o + nb) * m], non_blocking=cuda)
                    if nb < sub:
                        buf[nb * m:].zero_()
                if cuda:
                    if ev:
                        ev[1].record(sh["copy"])
                    sh["ready"][slot].record(sh["copy"])
            if cuda:
                sh["compute"].wait_event(sh["ready"][slot])
                if ev:
                    ev[2].record(sh["compute"])
            evs.append(ev)
        yield off, [sh["bufs"][slot] for sh in shards]
        for sh, ev in zip(shards, evs):
            if sh["cuda"]:
                sh["free"][slot].record(sh["compute"])
                if ev:
                    ev[3].record(sh["compute"])
                    times.blocks.append(ev)


@torch.no_grad()
def streaming_score_query_batch(model: XML, cfg, query_feat, query_mask,
                                host: HostCorpusCache, gt_meta_idx=None,
                                block_videos: int = 2048, mesh=None,
                                times: Optional[StreamTimes] = None):
    """Score one query batch against a host-resident corpus on the model's
    device. Returns the resident engine's ``_score_query_batch`` dict
    (device tensors), with ``topv_idx`` the top-V video indices, clipped to
    the corpus as in the JAX engine.

    The merge keeps max_vcmr_video entries, not clamped to the corpus: with
    fewer videos, pad videos (-1e10) and the initial -inf entries fill the
    state, their indices clipped to the last video. It is exact whatever
    ``video_topk_approx`` / ``video_topk_psort`` say, as in the JAX engine.
    gt_meta_idx: (Nq,) host indices of the GT videos, or None (no SVMR).
    times: a StreamTimes filled in on a card.

    mesh: a ``parallel.mesh.Mesh``; each block is then split into
    mesh.size contiguous sub-blocks, one on each mesh device, each scored
    there (B1 / B2 on a flat host cache), and only the (Nq, B / k) scores
    come back to the model's device for the running merge.
    ``block_videos`` rounds up to a multiple of k (of 16 k for a flat host
    cache, whole kernel chunks per shard), as in the JAX engine."""
    dev = next(model.parameters()).device
    cuda = dev.type == "cuda"
    host_parts = (host.video_feat1, host.sub_feat1, host.video_feat2, host.sub_feat2,
                  host.mask) + ((host.video_valid,) if host.flat else ())
    if any(t.device.type != "cpu" for t in host_parts):
        raise ValueError("the host cache must hold CPU tensors")
    if cuda and not all(t.is_pinned() for t in host_parts):
        raise ValueError("streaming to a card needs the host cache in pinned memory "
                         "(host_cache_from_device pins it when a card is present)")
    f32 = torch.float32
    V = cfg.max_vcmr_video
    n = host.n_videos
    query_feat = torch.as_tensor(query_feat, device=dev)
    query_mask = torch.as_tensor(query_mask, device=dev)
    nq = query_feat.shape[0]
    vq, sq = model.encode_query(query_feat, query_mask)
    # q / (||q|| + 1e-12), the JAX streaming engine's normalization
    vqn, sqn = l2_normalize(vq), l2_normalize(sq)
    if mesh is None:
        devs = (dev,)
    else:
        devs = tuple(mesh.devices)
        mult = len(devs) * (16 if host.flat else 1)
        block_videos = -(-block_videos // mult) * mult
    sub = block_videos // len(devs)
    scorers = [_block_scorer(host, vqn.to(d, non_blocking=True), sqn.to(d, non_blocking=True), sub)
               for d in devs]

    # ---- phase 1: feat1 blocks, running exact top-V
    timed = lambda: torch.cuda.Event(enable_timing=True)
    if cuda and times is not None:
        times.phase1 = (timed(), timed())
        times.phase1[0].record()
    best_scores = torch.full((nq, V), -torch.inf, dtype=f32, device=dev)
    best_idx = torch.zeros((nq, V), dtype=torch.int64, device=dev)
    for off, parts in _shard_blocks(host, block_videos, devs, times):
        s = torch.cat([score(*part).to(dev, non_blocking=True)
                       for score, part in zip(scorers, parts)], dim=1)  # (Nq, B)
        idx = torch.arange(off, off + block_videos, device=dev).expand(nq, -1)
        # lax.top_k keeps ties in concatenation order; the state's indices
        # precede the block's, so a stable sort by value is the same
        best_scores, sel = topk_stable(torch.cat([best_scores, s], dim=1), V)
        best_idx = torch.gather(torch.cat([best_idx, idx], dim=1), 1, sel)
    if cuda and times is not None:
        times.phase1[1].record()

    # ---- phase 2: the top-V (+ GT) rows of feat2 gathered on the host, one copy
    top_idx = best_idx.clamp(max=n - 1)
    gather_idx = top_idx.cpu()                                      # the first host sync
    if gt_meta_idx is not None:
        gt = torch.as_tensor(gt_meta_idx).to("cpu", torch.int64)
        gather_idx = torch.cat([gather_idx, gt[:, None]], dim=1)    # (Nq, V + 1)
    flat_idx = gather_idx.reshape(-1)
    t0 = time.perf_counter()
    rows = []
    for t in (host.video_feat2, host.sub_feat2, host.mask):
        buf = torch.empty((flat_idx.numel(),) + t.shape[1:], dtype=t.dtype, pin_memory=cuda)
        rows.append(torch.index_select(t, 0, flat_idx, out=buf))
    if times is not None:
        times.gather_s = time.perf_counter() - t0
        if cuda:
            times.feat2_copy = (timed(), timed())
            times.feat2_copy[0].record()
    vf2_g, sf2_g, mask_g = (x.to(dev, non_blocking=True).view(gather_idx.shape + x.shape[1:])
                            for x in rows)
    if cuda and times is not None:
        times.feat2_copy[1].record()

    st_logits, ed_logits = model.merged_st_ed_scores_gathered(vq, vf2_g, sq, sf2_g, mask_g)
    st_probs = torch.softmax(st_logits.to(f32), dim=-1)
    ed_probs = torch.softmax(ed_logits.to(f32), dim=-1)
    topv_scores = torch.exp(cfg.q2c_alpha * best_scores)
    # "grouped_shift_psort" runs as "grouped" (bit-equal), as in the JAX
    # streaming engine's span stage (streaming.py:224-239)
    span_topk = stages.span_topk(
        cfg, "grouped" if cfg.span_topk_mode == "grouped_shift_psort" else None)
    vid_local, st_i, ed_i, vcmr_scores = span_topk(
        st_probs[:, :V], ed_probs[:, :V], topv_scores, cfg.min_pred_l, cfg.max_pred_l,
        cfg.max_before_nms)
    out = dict(topv_scores=topv_scores, topv_idx=top_idx.to(torch.int32),
               vcmr_vid_local=vid_local, vcmr_st=st_i, vcmr_ed=ed_i, vcmr_scores=vcmr_scores)
    if gt_meta_idx is not None:
        svmr_st, svmr_ed, svmr_scores = banded_top_spans_from_probs(
            st_probs[:, V], ed_probs[:, V], cfg.min_pred_l, cfg.max_pred_l,
            cfg.max_before_nms)
        out.update(svmr_st=svmr_st, svmr_ed=svmr_ed, svmr_scores=svmr_scores)
    return out
