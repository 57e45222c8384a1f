"""Exact selection and span ops (port of tvretrieval_tpu/ops/span.py).

Every selection reproduces ``jax.lax.top_k``'s order: value descending,
then index ascending. ``torch.topk`` leaves the order of ties unspecified,
so the primitive here is ``topk_stable``: a stable descending sort, which
keeps equal values in ascending index order. The ``_psort`` functions
select through the sorting kernel instead (ops.sort.topk_transposed, B6),
with equal results. ``banded_topk_spans_grouped_shift_approx`` selects
through the approximate top-k (ops.approx_topk.approx_max_k, B11).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tvretrieval_tpu_torch.ops import approx_topk
from tvretrieval_tpu_torch.ops.sort import topk_transposed


def min_max_length_mask(length: int, min_l: int, max_l: int) -> np.ndarray:
    """(L, L) float mask; (st, ed) valid iff min_l <= ed - st < max_l
    (reference generate_min_max_length_mask, inference.py:170-192)."""
    ones = np.ones((length, length), dtype=np.float32)
    return np.triu(ones, k=min_l) * (1.0 - np.triu(ones, k=max_l))


def topk_stable(x: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: (values, int64 indices), value
    descending, ties by ascending index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def topk_stable_blocked(scores: torch.Tensor, k: int, block: int = 16,
                        select=topk_stable):
    """Exact stable top-k over the last axis by block-max pruning, equal
    to ``topk_stable`` (span.py:88-127): every top-k element lies in one of
    the stable top-min(k, nb) blocks by block max; the selected blocks are
    re-sorted by index so the candidate pool keeps original index order,
    and the pool's stable top-k is the row's. ``select`` is the stable
    top-k both selections run through; short rows (n <= k or n <= 2 *
    block) go to it directly. Returns (values, int32 idx)."""
    nq, n = scores.shape
    if n <= k or n <= 2 * block:
        vals, idx = select(scores, min(k, n))
        return vals, idx.to(torch.int32)
    pad = (-n) % block
    padded = F.pad(scores, (0, pad), value=-float("inf"))
    nb = padded.shape[1] // block
    blocks = padded.view(nq, nb, block)
    return _topk_from_blocks(blocks, blocks.amax(dim=-1), k, n - 1, select)


def topk_from_block_max(scores_padded: torch.Tensor, bmax: torch.Tensor, k: int,
                        block: int = 16):
    """topk_stable_blocked when the block maxima come precomputed, e.g.
    from the B3 video-score kernel (span.py:165-196). scores_padded:
    (Nq, N_pad) with positions past the true count at -inf; bmax:
    (Nq, N_pad / block) exact block maxima."""
    nq, n_pad = scores_padded.shape
    nb = n_pad // block
    if bmax.shape != (nq, nb):
        raise ValueError(f"bmax shape {tuple(bmax.shape)} != {(nq, nb)}")
    blocks = scores_padded.view(nq, nb, block)
    return _topk_from_blocks(blocks, bmax, k, n_pad - 1)


def topk_stable_blocked_psort(scores: torch.Tensor, k: int, block: int = 8):
    """``topk_stable_blocked`` with both selections run by the sorting
    kernel (ops.sort.topk_transposed; span.py:130-161): equal in values and
    indices, since the kernel keeps the stable tie order and the cover
    argument does not depend on how the selection is computed."""
    return topk_stable_blocked(scores, k, block, select=topk_transposed)


def topk_stable_blocked_psort_inplace(scores: torch.Tensor, k: int, block: int = 8):
    """``topk_stable_blocked_psort`` that reads contiguous rows whose length
    is a multiple of ``block`` in place, without the padded copy, and takes
    the block maxima by ``max_pool1d`` (on an H100 1.9 ms for 1,000 rows of
    2^20, where ``amax`` over the last axis of 8 took 7.1); any other row
    goes to ``topk_stable_blocked_psort``."""
    nq, n = scores.shape
    if n % block or n <= k or n <= 2 * block or not scores.is_contiguous():
        return topk_stable_blocked_psort(scores, k, block)
    bmax = F.max_pool1d(scores[:, None, :], block)[:, 0]
    return _topk_from_blocks(scores.view(nq, n // block, block), bmax, k, n - 1,
                             topk_transposed)


def _topk_from_blocks(blocks, bmax, k: int, max_index: int, select=topk_stable):
    nq, nb, block = blocks.shape
    _, bidx = select(bmax, min(k, nb))
    bidx = torch.sort(bidx.long(), dim=1).values
    pool = torch.gather(blocks, 1, bidx[:, :, None].expand(-1, -1, block))
    vals, pos = select(pool.reshape(nq, -1), min(k, bidx.shape[1] * block))
    pos = pos.long()
    src = torch.gather(bidx, 1, pos // block) * block + pos % block
    # finite inputs never select a -inf pad element; the clamp keeps
    # indices in range (as the reference's) if NaNs break the cover argument
    return vals, torch.clamp_max(src, max_index).to(torch.int32)


def _band_indices(L: int, min_l: int, max_l: int):
    """(L, W) end indices of the valid span band and their validity;
    W = max_l - min_l. Span (st=m, ed=n) is valid iff min_l <= n - m < max_l."""
    W = max_l - min_l
    idx = np.arange(L)[:, None] + np.arange(min_l, max_l)[None, :]
    valid = (idx < L).astype(np.float32)
    return np.clip(idx, 0, L - 1), valid, W


def _band_tables(L: int, min_l: int, max_l: int, dev) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_band_indices``'s (L, W) end indices (int64) and validity (f32),
    built on ``dev``: a host table copied to a card would make the host wait
    for the card's queue (a pageable copy synchronises its stream)."""
    ends = (torch.arange(L, device=dev)[:, None]
            + torch.arange(min_l, max_l, device=dev)[None, :])
    return ends.clamp(0, L - 1), (ends < L).to(torch.float32)


def _decode(flat: torch.Tensor, L: int, W: int, min_l: int):
    vid = flat // (L * W)
    rem = flat % (L * W)
    m = rem // W
    n = m + min_l + rem % W
    return vid.to(torch.int32), m.to(torch.int32), n.to(torch.int32)


def banded_topk_spans_grouped_shift(st_probs: torch.Tensor, ed_probs: torch.Tensor,
                                    video_scores: torch.Tensor, min_l: int,
                                    max_l: int, top_n: int,
                                    keep_mask: torch.Tensor | None = None):
    """Exact hierarchical top-N spans over (videos x starts x band ends)
    (span.py:289-471), equal bit for bit to a flat stable top-N over
    ``st[m] * ed[n] * video_score`` under the min/max length band.

    1. Group maximum per (video, start): the window max of ed over the W
       valid ends; f32 multiplication by a non-negative factor is monotone,
       so ``(st * max ed) * vs`` is the group's largest span score.
    2. The stable top-``top_n`` groups by group max hold every selected
       span (cover argument, span.py:302-311); they are re-sorted by flat
       index so the candidate pool is in canonical order.
    3. Each selected group expands to its W spans (the reference's one-hot
       shift reduction adds one value to zeros, so a direct gather of the
       same ed value is identical), and a stable top-N over the pool gives
       (value desc, canonical index asc) — the flat path's order.

    keep_mask: optional (Nq, V) {0, 1}; spans of non-kept videos become
    exactly -1, below any real span (>= 0), in selection and in the pool.
    Returns (video_local_idx, st_idx, ed_idx, scores), each (Nq, top_n).
    """
    return _grouped_shift(st_probs, ed_probs, video_scores, min_l, max_l, top_n, keep_mask,
                          lambda x, k: topk_stable_blocked(x, k, block=8), topk_stable)


def banded_topk_spans_grouped_shift_approx(st_probs: torch.Tensor, ed_probs: torch.Tensor,
                                           video_scores: torch.Tensor, min_l: int,
                                           max_l: int, top_n: int,
                                           keep_mask: torch.Tensor | None = None,
                                           recall: float = 0.99):
    """Engine span top-k mode "grouped_shift_approx" (span.py:548-620):
    ``banded_topk_spans_grouped_shift`` with the group selection over V * L
    and the final selection over the G * W pool made by the approximate
    top-k (ops.approx_topk.approx_max_k, B11) at the recall target
    ``recall``. Not a parity mode: a span whose group, or which itself,
    shares a bin with a better one is lost. Where a row has no more
    elements than the tiling (or recall is 1.0) the selection is exact and
    the outputs equal the exact modes'."""
    select = lambda x, k: approx_topk.approx_max_k(x, k, recall)
    return _grouped_shift(st_probs, ed_probs, video_scores, min_l, max_l, top_n, keep_mask,
                          select, select)


def _grouped_shift(st_probs, ed_probs, video_scores, min_l: int, max_l: int, top_n: int,
                   keep_mask, select_groups, select_pool):
    """The grouped-shift span top-N with its two selections given:
    ``select_groups(gmax rows, k)`` and ``select_pool(pool rows, k)``,
    each returning (values, indices)."""
    nq, v, L = st_probs.shape
    W = max_l - min_l
    dev = st_probs.device

    # max ed[i : i + W) with zero fill (reduce_window, init 0.0), shifted by min_l
    rw = F.pad(ed_probs, (0, W - 1)).unfold(-1, W, 1).amax(dim=-1)
    wmax = F.pad(rw, (0, min_l))[..., min_l:]
    gmax = (st_probs * wmax) * video_scores[:, :, None]                 # (Nq, V, L)
    if keep_mask is not None:
        gmax = gmax * keep_mask[:, :, None] - (1.0 - keep_mask)[:, :, None]

    k_groups = min(top_n, v * L)
    _, gidx = select_groups(gmax.reshape(nq, v * L), k_groups)
    gidx = torch.sort(gidx.long(), dim=1).values                        # (Nq, G)
    g_vid = gidx // L
    g_st = gidx % L

    st_g = torch.gather(st_probs.reshape(nq, v * L), 1, gidx)
    vs_g = torch.gather(video_scores, 1, g_vid)
    ed_rows = torch.gather(ed_probs, 1, g_vid[:, :, None].expand(-1, -1, L))
    ends = g_st[:, :, None] + min_l + torch.arange(W, device=dev)[None, None]
    ed_g = torch.gather(F.pad(ed_rows, (0, max_l)), 2, ends)          # (Nq, G, W)
    valid_g = (ends < L).to(st_probs.dtype)
    vals = ((st_g[:, :, None] * ed_g) * vs_g[:, :, None]) * valid_g
    if keep_mask is not None:
        keep_g = torch.gather(keep_mask, 1, g_vid)
        vals = vals * keep_g[:, :, None] - (1.0 - keep_g)[:, :, None]
    canon = gidx[:, :, None] * W + torch.arange(W, device=dev)[None, None]

    pool = vals.reshape(nq, -1)
    k = min(top_n, pool.shape[1])
    scores, pos = select_pool(pool, k)
    flat = torch.gather(canon.reshape(nq, -1), 1, pos.long())
    if k < top_n:
        scores = F.pad(scores, (0, top_n - k))
        flat = F.pad(flat, (0, top_n - k))
    return (*_decode(flat, L, W, min_l), scores)


def banded_topk_spans_grouped_shift_psort(st_probs: torch.Tensor, ed_probs: torch.Tensor,
                                          video_scores: torch.Tensor, min_l: int,
                                          max_l: int, top_n: int,
                                          keep_mask: torch.Tensor | None = None):
    """Engine span top-k mode "grouped_shift_psort" (span.py:474-545):
    ``banded_topk_spans_grouped_shift`` with the group selection
    (``topk_stable_blocked_psort``: two launches) and the final pool
    selection (one launch) run by the sorting kernel B6. A parity mode:
    the kernel keeps the stable tie order, so the outputs are equal bit for
    bit to the other exact modes'."""
    return _grouped_shift(st_probs, ed_probs, video_scores, min_l, max_l, top_n, keep_mask,
                          lambda x, k: topk_stable_blocked_psort(x, k, block=8),
                          topk_transposed)


def banded_topk_spans_grouped_shift8(st_probs: torch.Tensor, ed_probs: torch.Tensor,
                                     video_scores: torch.Tensor, min_l: int, max_l: int,
                                     top_n: int, keep_mask: torch.Tensor | None = None):
    """Engine span top-k mode "grouped_shift8" (span.py:622-716). The JAX
    function fetches each selected group's ed window from aligned blocks of
    8 of the flat (V * L) ed axis, a gather shaped for the TPU's sublane
    tile; what it reads past a video's end is cancelled by the exact
    ``* valid`` zero. It fetches the values ``banded_topk_spans_grouped_shift``
    fetches, so here the two share the direct gather, like "grouped"."""
    return banded_topk_spans_grouped_shift(st_probs, ed_probs, video_scores, min_l,
                                           max_l, top_n, keep_mask=keep_mask)


def banded_topk_spans_grouped(st_probs: torch.Tensor, ed_probs: torch.Tensor,
                              video_scores: torch.Tensor, min_l: int, max_l: int,
                              top_n: int):
    """Engine span top-k mode "grouped" (span.py:289-383). The JAX package's
    "grouped" and "grouped_shift" differ only in how they fetch the selected
    groups' ed values (a gather from the materialized band against one-hot
    shifts); both fetch the same values, so here they share the direct
    gather of ``banded_topk_spans_grouped_shift``."""
    return banded_topk_spans_grouped_shift(st_probs, ed_probs, video_scores, min_l,
                                           max_l, top_n)


def banded_top_spans_from_probs(st_probs: torch.Tensor, ed_probs: torch.Tensor,
                                min_l: int, max_l: int, top_n: int, select=topk_stable):
    """Top-N banded spans of single videos, (N, L) probs -> (st, ed,
    scores), each (N, top_n) (span.py:720-734; the SVMR row), in
    ``lax.top_k``'s order over the flat (start, end) band: score
    descending, then start, then end ascending; where the band holds fewer
    than ``top_n`` spans, zero scores fill the rest. ``select`` is the
    stable top-k (``topk_transposed``: B6)."""
    n_rows, L = st_probs.shape
    W = max_l - min_l
    idx, valid = _band_tables(L, min_l, max_l, st_probs.device)
    ed_band = ed_probs[:, idx]                                          # (N, L, W)
    joint = st_probs[:, :, None] * ed_band * valid[None]
    k = min(top_n, L * W)
    scores, flat = select(joint.reshape(n_rows, L * W), k)
    flat = flat.long()
    if k < top_n:
        scores = F.pad(scores, (0, top_n - k))
        flat = F.pad(flat, (0, top_n - k))
    m = flat // W
    n = m + min_l + flat % W
    return m.to(torch.int32), n.to(torch.int32), scores


def banded_topk_spans_per_video(st_probs: torch.Tensor, ed_probs: torch.Tensor, min_l: int,
                                max_l: int, per_video: int, top_n: int, select=topk_stable):
    """Two-level span selection of early-fusion VCMR (reference
    excl/inference_with_vcmr.py:72-97): each video's own top ``per_video``
    banded spans (``banded_top_spans_from_probs``), then the stable top
    ``top_n`` of those, in the order of Python's stable sort over the list
    built video by video: score descending, then the video's position,
    then the span's rank within the video. A video keeps at most
    ``per_video`` spans, whatever its rivals score.

    (Nq, V, L) probs, the start probabilities already weighted by their
    video's score -> (video position, st, ed) int32 and scores, each
    (Nq, min(top_n, V * k)) with k = min(per_video, L * W)."""
    nq, v, L = st_probs.shape
    st, ed, sc = banded_top_spans_from_probs(
        st_probs.reshape(nq * v, L), ed_probs.reshape(nq * v, L), min_l, max_l,
        min(per_video, L * (max_l - min_l)), select)
    k = sc.shape[1]
    scores, pos = select(sc.reshape(nq, v * k), min(top_n, v * k))
    pos = pos.long()
    pick = lambda t: torch.gather(t.reshape(nq, v * k), 1, pos)
    return (pos // k).to(torch.int32), pick(st), pick(ed), scores


def _pad_top_n(scores: torch.Tensor, idx: torch.Tensor, top_n: int):
    """Zero-pad a selection narrower than top_n to the advertised width."""
    k = scores.shape[1]
    if k < top_n:
        scores, idx = F.pad(scores, (0, top_n - k)), F.pad(idx, (0, top_n - k))
    return scores, idx


def top_spans_from_probs(st_probs: torch.Tensor, ed_probs: torch.Tensor,
                         length_mask: torch.Tensor, top_n: int):
    """Top-N (st, ed) pairs by st_prob * ed_prob under an (L, L) length
    mask; (N, L) probs -> (st_idx, ed_idx, scores), each (N, top_n)
    (span.py:28-47; reference find_max_triples_from_upper_triangle_product)."""
    n, L = st_probs.shape
    joint = st_probs[:, :, None] * ed_probs[:, None, :] * length_mask[None]
    scores, idx = topk_stable(joint.reshape(n, L * L), top_n)
    return (idx // L).to(torch.int32), (idx % L).to(torch.int32), scores


def chunked_masked_max_scores(queries_n: torch.Tensor, feat1_n: torch.Tensor,
                              mask: torch.Tensor, block: int = 2048) -> torch.Tensor:
    """(M, D) x (Nv, L, D) -> (M, Nv) masked max-over-clips dot scores, one
    block of videos at a time so that only an (M, block, L) tile of the
    similarity exists (span.py:50-84). Equal to ``einsum('md,nld->mln')``,
    mask, max, up to the summation order of the product."""
    nv, L, d = feat1_n.shape
    q = queries_n.to(feat1_n.dtype).float()
    outs = []
    for v0 in range(0, nv, block):
        fb, mb = feat1_n[v0:v0 + block].float(), mask[v0:v0 + block].float()
        s = (q @ fb.reshape(-1, d).T).view(q.shape[0], -1, L)
        outs.append((s * mb[None] + (1.0 - mb[None]) * -1e10).amax(dim=2))
    return torch.cat(outs, dim=1)


def _banded_joint(st_probs, ed_probs, video_scores, min_l: int, max_l: int):
    """(Nq, V, L, W) banded joint st * ed * video_score, invalid ends zero."""
    idx, valid = _band_tables(st_probs.shape[-1], min_l, max_l, st_probs.device)
    ed_band = ed_probs[:, :, idx]
    return (st_probs[:, :, :, None] * ed_band * video_scores[:, :, None, None]
            * valid[None, None])


def banded_topk_spans(st_probs: torch.Tensor, ed_probs: torch.Tensor,
                      video_scores: torch.Tensor, min_l: int, max_l: int, top_n: int,
                      keep_mask: torch.Tensor | None = None):
    """Flat stable top-N over the (videos x starts x band ends) joint, the
    (Nq, V, L, W) band materialized (span.py:241-286): what the grouped
    modes are exact against. keep_mask as in
    ``banded_topk_spans_grouped_shift``."""
    nq, v, L = st_probs.shape
    W = max_l - min_l
    joint = _banded_joint(st_probs, ed_probs, video_scores, min_l, max_l)
    if keep_mask is not None:
        joint = (joint * keep_mask[:, :, None, None]
                 - (1.0 - keep_mask)[:, :, None, None])
    flat = joint.reshape(nq, v * L * W)
    scores, flat_idx = _pad_top_n(*topk_stable(flat, min(top_n, flat.shape[-1])), top_n)
    return (*_decode(flat_idx, L, W, min_l), scores)


def banded_topk_spans_two_stage(st_probs: torch.Tensor, ed_probs: torch.Tensor,
                                video_scores: torch.Tensor, min_l: int, max_l: int,
                                top_n: int):
    """Exact two-stage variant of ``banded_topk_spans`` (span.py:212-238):
    a top-K over each (query, video) band, then a global top-N over the
    V * K candidates; exact because the global top-N holds at most top_n
    spans of one video."""
    nq, v, L = st_probs.shape
    W = max_l - min_l
    joint = _banded_joint(st_probs, ed_probs, video_scores, min_l, max_l)
    k1 = min(top_n, L * W)
    s1, i1 = topk_stable(joint.reshape(nq * v, L * W), k1)
    s1, i1 = s1.reshape(nq, v * k1), i1.reshape(nq, v * k1)
    scores, sel = _pad_top_n(*topk_stable(s1, min(top_n, v * k1)), top_n)
    vid = (sel // k1).to(torch.int32)
    flat = torch.gather(i1, 1, sel)
    m = flat // W
    n = m + min_l + flat % W
    return vid, m.to(torch.int32), n.to(torch.int32), scores


def flat_topk_spans(joint_scores: torch.Tensor, top_n: int):
    """Top-N over (Nq, V, L, L) joint scores flattened over (V, L, L):
    (video_local_idx, st_idx, ed_idx, scores), each (Nq, top_n)
    (span.py:737-750; reference inference.py:378-386, 423-431)."""
    n_q, v, L, _ = joint_scores.shape
    scores, idx = topk_stable(joint_scores.reshape(n_q, v * L * L), top_n)
    vid = idx // (L * L)
    rem = idx % (L * L)
    return (vid.to(torch.int32), (rem // L).to(torch.int32), (rem % L).to(torch.int32),
            scores)
