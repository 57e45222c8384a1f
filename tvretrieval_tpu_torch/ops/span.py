"""Exact selection and span ops (port of tvretrieval_tpu/ops/span.py).

Every selection reproduces ``jax.lax.top_k``'s order: value descending,
then index ascending. ``torch.topk`` leaves the order of ties unspecified,
so the primitive here is ``topk_stable``: a stable descending sort, which
keeps equal values in ascending index order.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


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


def topk_stable_blocked(scores: torch.Tensor, k: int, block: int = 16):
    """Exact stable top-k over the last axis by block-max pruning, equal
    to ``topk_stable`` (span.py:88-127): every top-k element lies in one of
    the stable top-min(k, nb) blocks by block max; the selected blocks are
    re-sorted by index so the candidate pool keeps original index order,
    and the pool's stable top-k is the row's. Returns (values, int32 idx)."""
    nq, n = scores.shape
    if n <= k or n <= 2 * block:
        vals, idx = topk_stable(scores, min(k, n))
        return vals, idx.to(torch.int32)
    pad = (-n) % block
    padded = F.pad(scores, (0, pad), value=-float("inf"))
    nb = padded.shape[1] // block
    blocks = padded.view(nq, nb, block)
    return _topk_from_blocks(blocks, blocks.amax(dim=-1), k, n - 1)


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


def _topk_from_blocks(blocks, bmax, k: int, max_index: int):
    nq, nb, block = blocks.shape
    _, bidx = topk_stable(bmax, min(k, nb))
    bidx = torch.sort(bidx, dim=1).values
    pool = torch.gather(blocks, 1, bidx[:, :, None].expand(-1, -1, block))
    vals, pos = topk_stable(pool.reshape(nq, -1), min(k, bidx.shape[1] * block))
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
    _, gidx = topk_stable_blocked(gmax.reshape(nq, v * L), k_groups, block=8)
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
    scores, pos = topk_stable(pool, k)
    flat = torch.gather(canon.reshape(nq, -1), 1, pos)
    if k < top_n:
        scores = F.pad(scores, (0, top_n - k))
        flat = F.pad(flat, (0, top_n - k))
    return (*_decode(flat, L, W, min_l), scores)


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
                                min_l: int, max_l: int, top_n: int):
    """Top-N banded spans of single videos, (N, L) probs -> (st, ed,
    scores), each (N, top_n) (span.py:720-734; the SVMR row)."""
    n_rows, L = st_probs.shape
    idx_np, valid_np, W = _band_indices(L, min_l, max_l)
    dev = st_probs.device
    ed_band = ed_probs[:, torch.as_tensor(idx_np, device=dev)]          # (N, L, W)
    joint = st_probs[:, :, None] * ed_band * torch.as_tensor(valid_np, device=dev)[None]
    k = min(top_n, L * W)
    scores, flat = topk_stable(joint.reshape(n_rows, L * W), k)
    if k < top_n:
        scores = F.pad(scores, (0, top_n - k))
        flat = F.pad(flat, (0, top_n - k))
    m = flat // W
    n = m + min_l + flat % W
    return m.to(torch.int32), n.to(torch.int32), scores
