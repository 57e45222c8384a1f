"""The stages of XML's query path that the resident engine
(``retrieval.engine``), the sharded engine (``parallel.sharded_retrieval``)
and the streaming engine (``retrieval.streaming``) share, each decided here
once:

- ``flat_layout``: the flat caches of the kernel modes, built once with
  the cache (for the whole corpus or for one shard);
- ``video_scores``: the queries' normalization (and int8 quantization)
  and the video-score kernel (B1, B2, B3) or the einsum, chosen by the
  layout the cache holds;
- ``select_videos``: the top-V videos, by the approximate selection (B11),
  B3's block maxima or the exact one (B6 under ``video_topk_psort``), in
  that precedence;
- ``span_logits``: the span logits of the gathered videos under
  ``span_score_mode``;
- ``span_topk``: the span top-N selection of ``span_topk_mode``.

What differs between the engines stays with them: the external VR
ranking, the sharded engine's pad videos and global merge, the streaming
engine's blocks.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from tvretrieval_tpu_torch.models.xml import XML, l2_normalize
from tvretrieval_tpu_torch.ops import approx_topk
from tvretrieval_tpu_torch.ops.span import (
    banded_topk_spans_grouped,
    banded_topk_spans_grouped_shift,
    banded_topk_spans_grouped_shift8,
    banded_topk_spans_grouped_shift_approx,
    banded_topk_spans_grouped_shift_psort,
    topk_from_block_max,
    topk_stable_blocked,
    topk_stable_blocked_psort,
)
from tvretrieval_tpu_torch.ops.video_score import (
    build_flat_feat1,
    build_flat_feat2_i8,
    flat_lp,
    flat_rows,
    quantize_unit_i8,
    video_scores_flat,
    video_scores_flat_bmax,
    video_scores_flat_i8,
    video_scores_xla,
)

KERNEL_VIDEO_MODES = ("pallas", "pallas_int8")
# span top-k mode -> selection; "grouped_shift_approx" is bound to the
# config's recall by span_topk
SPAN_TOPK = {"grouped": banded_topk_spans_grouped,
             "grouped_shift": banded_topk_spans_grouped_shift,
             "grouped_shift8": banded_topk_spans_grouped_shift8,
             "grouped_shift_psort": banded_topk_spans_grouped_shift_psort,
             "grouped_shift_approx": banded_topk_spans_grouped_shift_approx}


def flat_layout(cfg, parts: Dict[str, Optional[torch.Tensor]], chunk_v: int,
                shard: bool = False) -> Dict[str, Optional[torch.Tensor]]:
    """The flat layouts ``cfg`` asks for, in place on ``parts``: a whole
    corpus's or one shard's "vf1", "sf1", "mask" and "feat2_cat" (a stream
    the model lacks None or absent). Under "simsweep_cat_int8_flat" a float
    feat2_cat becomes its int8 flat rows at flat_lp(L) rows a video and
    "feat2_cat_scale" their scales (``build_flat_feat2_i8``, the videos
    padded to a chunk_v multiple); then under the kernel video modes each
    feat1 stream of a two-stream cache becomes its flat_lp(L) rows a video,
    int8 under "pallas_int8". Each source is popped as its copy is made, so
    it frees then.

    The whole corpus takes ``build_flat_feat1``, which refuses a video
    without a valid clip and pads the videos to a chunk_v multiple by
    repeating the last one. ``shard``: the videos already are a chunk_v
    multiple and the pad videos fully masked, so the rows are
    ``flat_rows``' and the sharded engine restores a pad video's -1e10
    from the mask."""
    lp = flat_lp(parts["mask"].shape[1])
    if parts.get("feat2_cat") is not None and cfg.span_score_mode == "simsweep_cat_int8_flat":
        parts["feat2_cat"], parts["feat2_cat_scale"] = build_flat_feat2_i8(
            parts.pop("feat2_cat"), lp=lp, chunk_v=chunk_v)
    if (cfg.video_score_mode in KERNEL_VIDEO_MODES and parts.get("vf1") is not None
            and parts.get("sf1") is not None):
        for k in ("vf1", "sf1"):
            parts[k] = (flat_rows(parts.pop(k), parts["mask"], lp) if shard else
                        build_flat_feat1(parts.pop(k), parts["mask"], chunk_v=chunk_v))
        if cfg.video_score_mode == "pallas_int8":
            parts["vf1"], parts["sf1"] = quantize_unit_i8(parts["vf1"]), quantize_unit_i8(parts["sf1"])
    return parts


def video_scores(cfg, vq, sq, feat1_v, feat1_s, mask):
    """The (Nq, Nv) pre-exp q2c scores of the encoded queries (vq, sq)
    against one cache's feat1 and its (Nv, L) mask, and B3's (scores of
    every padded video, block maxima) when the fused selection runs, else
    None.

    The cache's layout decides, as it was built: a flat (2-D) feat1 runs
    the kernels, which ignore the mask (B1 on int8, the queries quantized;
    B3 under ``cfg.video_topk_fused``; else B2), the (Nv, L, D) one the
    einsum. The queries are L2-normalized here (the cache already is)."""
    nv, L = mask.shape
    if feat1_v.dim() != 2:
        return video_scores_xla(l2_normalize(vq).to(feat1_v.dtype),
                                l2_normalize(sq).to(feat1_s.dtype), feat1_v, feat1_s, mask), None
    lp = flat_lp(L)
    int8 = feat1_v.dtype == torch.int8
    if int8:
        qvt, qst = (quantize_unit_i8(l2_normalize(q)).T for q in (vq, sq))
    else:
        qvt = l2_normalize(vq).to(feat1_v.dtype).T
        qst = l2_normalize(sq).to(feat1_s.dtype).T
    if cfg.video_topk_fused:
        scores_pad, bmax = video_scores_flat_bmax(qvt, qst, feat1_v, feat1_s, n_videos=nv,
                                                  lp=lp, chunk_v=cfg.video_chunk_v)
        return scores_pad[:, :nv], (scores_pad, bmax)
    score = video_scores_flat_i8 if int8 else video_scores_flat
    return score(qvt, qst, feat1_v, feat1_s, n_videos=nv, lp=lp), None


def select_videos(cfg, q2c: torch.Tensor, k: int,
                  fused: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """The top-k videos of each query: (values, indices, pre_exp). The
    precedence: the approximate top-k (B11) under ``video_topk_approx``,
    then B3's block maxima ``fused`` (from ``video_scores``), both on the
    pre-exp scores; else the exact stable top-k (through B6 under
    ``video_topk_psort``, equal either way) of the pre-exp scores under
    ``video_topk_pre_exp`` or of ``exp(alpha * q2c)``. pre_exp: the values
    are pre-exp scores, which the caller exps."""
    f32 = torch.float32
    if cfg.video_topk_approx:
        return (*approx_topk.approx_max_k(q2c.to(f32), k, cfg.topk_approx_recall), True)
    if fused is not None:
        scores_pad, bmax = fused
        return (*topk_from_block_max(scores_pad, bmax, k,
                                     block=scores_pad.shape[1] // bmax.shape[1]), True)
    exact = (functools.partial(topk_stable_blocked_psort, block=16) if cfg.video_topk_psort
             else topk_stable_blocked)
    if cfg.video_topk_pre_exp:
        return (*exact(q2c.to(f32), k), True)
    return (*exact(torch.exp(cfg.q2c_alpha * q2c.to(f32)), k), False)


def span_logits(model: XML, mode: str, vq, sq, feat2, mask, gather_idx):
    """(st_logits, ed_logits) of the gathered videos ``gather_idx`` (Nq,
    V[+1]) under span score mode ``mode``. feat2: (video_feat2, sub_feat2),
    or under the cat modes (feat2_cat, its per-row scales under the int8
    ones): the int8 sweep on gathered rows ("simsweep_cat_int8"), B5 over
    the flat rows ("simsweep_cat_int8_flat"), the similarity sweep over the
    concatenated cache (bf16 under "simsweep_cat_bf16") or over each stream
    ("simsweep"), or the gathered rows themselves ("gather", at the cache
    dtype: (Nq, V[+1], L, D) a stream)."""
    f2a, f2b = feat2
    if mode == "simsweep_cat_int8":
        return model.merged_st_ed_scores_simgather_cat_i8(vq, sq, f2a, f2b, mask, gather_idx)
    if mode == "simsweep_cat_int8_flat":
        return model.merged_st_ed_scores_pallas_cat_i8(vq, sq, f2a, f2b, mask, gather_idx)
    if mode in ("simsweep_cat", "simsweep_cat_bf16"):
        return model.merged_st_ed_scores_simgather_cat(
            vq, sq, f2a, mask, gather_idx,
            sim_dtype=torch.bfloat16 if mode == "simsweep_cat_bf16" else None)
    if mode == "simsweep":
        return model.merged_st_ed_scores_simgather(vq, f2a, sq, f2b, mask, gather_idx)
    return model.merged_st_ed_scores_gathered(vq, f2a[gather_idx], sq, f2b[gather_idx],
                                              mask[gather_idx])


def span_topk(cfg, mode: Optional[str] = None):
    """The span top-N selection of ``mode`` (``cfg.span_topk_mode`` when
    None), the approximate one at ``cfg.topk_approx_recall``."""
    mode = mode or cfg.span_topk_mode
    if mode == "grouped_shift_approx":
        return functools.partial(SPAN_TOPK[mode], recall=cfg.topk_approx_recall)
    return SPAN_TOPK[mode]
