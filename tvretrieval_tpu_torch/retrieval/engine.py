"""Whole-corpus VCMR / SVMR / VR inference engine, exact modes, in PyTorch.

Port of tvretrieval_tpu/retrieval/engine.py (reference inference.py:32-445).
The corpus is encoded once (``encode_corpus``); each query batch then runs
``_score_query_batch`` on the cache's device:

1. ``XML.encode_query``;
2. q2c video scores against every video — the CUDA video-score kernels
   (ops.video_score) under ``video_score_mode`` "pallas" / "pallas_int8",
   or the einsum path under "einsum";
3. ``exp(alpha * q2c)`` and an exact stable top-V;
4. one corpus-wide similarity sweep over the concatenated feat2 cache,
   the top-V (+ GT) row gather, ConvSE and softmax
   (``XML.merged_st_ed_scores_simgather_cat``);
5. the exact banded span top-N and the SVMR row (ops.span).

``retrieve`` turns the results into the submission the shared evaluator
(tvretrieval_tpu.evaluation) scores. Mode names are the JAX package's so
configurations carry over; "pallas" here means the CUDA kernel. Modes not
ported yet raise ``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from tvretrieval_tpu.data.datasets import CorpusIndex, ExampleBuilder
from tvretrieval_tpu_torch.models.xml import XML
from tvretrieval_tpu_torch.ops.span import (
    banded_top_spans_from_probs,
    banded_topk_spans_grouped_shift,
    topk_from_block_max,
    topk_stable_blocked,
)
from tvretrieval_tpu_torch.ops.video_score import (
    build_flat_feat1,
    flat_lp,
    quantize_unit_i8,
    video_scores_flat,
    video_scores_flat_bmax,
    video_scores_flat_i8,
    video_scores_xla,
)


@dataclass(frozen=True)
class RetrievalConfig:
    """Inference knobs: the JAX package's fields and defaults (reference
    config.py defaults in parens; mode semantics in the JAX engine)."""

    q2c_alpha: float = 20.0          # (162)
    min_pred_l: int = 2              # (154)
    max_pred_l: int = 16             # (158)
    max_before_nms: int = 200        # (167)
    max_vcmr_video: int = 100        # (168)
    query_bsz: int = 50              # eval_query_bsz (61)
    context_bsz: int = 200           # eval_context_bsz (63)
    clip_length: float = 1.5
    cache_dtype_str: str = "float32"  # corpus cache dtype ("bfloat16" halves memory)
    # ported: "simsweep_cat", "simsweep_cat_bf16" (similarity stored bf16)
    span_score_mode: str = "gather"
    # zero-pad the concatenated cache's clip axis to this length (0 = off)
    span_sim_pad_l: int = 0
    # ported: "einsum", "pallas" (B2/B3 CUDA kernel), "pallas_int8" (B1/B3)
    video_score_mode: str = "einsum"
    # upper bound on the videos per block maximum (B3) and the flat-cache
    # video padding multiple
    video_chunk_v: int = 16
    # ported: "grouped_shift"
    span_topk_mode: str = "grouped"
    video_topk_approx: bool = False
    video_topk_psort: bool = False
    topk_approx_recall: float = 0.99
    # TPU interpret switch; kept so configurations carry over, unused here
    pallas_interpret: bool = False
    # top-V on the pre-exp scores, exp only on the V selected values
    video_topk_pre_exp: bool = False
    # B3: the video-score kernel also emits block maxima for the top-V
    video_topk_fused: bool = False

    @property
    def cat_mode(self) -> bool:
        return self.span_score_mode in ("simsweep_cat", "simsweep_cat_bf16",
                                        "simsweep_cat_int8",
                                        "simsweep_cat_int8_flat")

    @property
    def cache_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.cache_dtype_str == "bfloat16" else torch.float32


def check_supported(cfg: RetrievalConfig) -> None:
    """Raise NotImplementedError for engine modes the port does not run yet."""
    if cfg.video_score_mode not in ("einsum", "pallas", "pallas_int8"):
        raise NotImplementedError(f"video_score_mode={cfg.video_score_mode!r}")
    if cfg.span_score_mode in ("simsweep_cat_int8", "simsweep_cat_int8_flat"):
        raise NotImplementedError(
            f"span_score_mode={cfg.span_score_mode!r}: the int8 sweeps are "
            "ROADMAP A11 (kernel B5)")
    if cfg.span_score_mode not in ("simsweep_cat", "simsweep_cat_bf16"):
        raise NotImplementedError(
            f"span_score_mode={cfg.span_score_mode!r}: gather / simsweep are "
            "ROADMAP A15; use 'simsweep_cat' or 'simsweep_cat_bf16'")
    if cfg.span_topk_mode in ("grouped_shift_approx", "grouped_shift_psort"):
        raise NotImplementedError(
            f"span_topk_mode={cfg.span_topk_mode!r}: approximate and psort "
            "selection are ROADMAP A11 (kernel B6)")
    if cfg.span_topk_mode != "grouped_shift":
        raise NotImplementedError(
            f"span_topk_mode={cfg.span_topk_mode!r} is ROADMAP A15; use "
            "'grouped_shift' (bit-equal)")
    if cfg.video_topk_approx or cfg.video_topk_psort:
        raise NotImplementedError(
            "video_topk_approx / video_topk_psort are ROADMAP A11")


@dataclass
class CorpusCache:
    """Encoded corpus on one device (feat1 = retrieval stream, feat2 =
    localization stream; reference compute_context_info, inference.py:32-97).
    Under video_score_mode "pallas" / "pallas_int8" the feat1 slots hold
    the flat mask-free (Nv_pad * flat_lp(L), D) layout (int8 for
    pallas_int8); under the cat span modes feat2_cat = [vf2 ; sf2]
    replaces the two feat2 streams."""

    video_feat1: Optional[torch.Tensor]
    video_feat2: Optional[torch.Tensor]
    sub_feat1: Optional[torch.Tensor]
    sub_feat2: Optional[torch.Tensor]
    mask: torch.Tensor                   # (Nv, L)
    n_videos: int
    metas: List[dict]                    # per-video {vid_name, duration}
    feat2_cat: Optional[torch.Tensor] = None


def _maybe_pad_clip_axis(feat2_cat, cfg: RetrievalConfig):
    """Zero-pad a (Nv, L, 2D) concatenated cache's clip axis to
    cfg.span_sim_pad_l; the pad columns score 0 and are sliced off before
    the conv (a parity mode)."""
    pad_l = cfg.span_sim_pad_l
    if not pad_l:
        return feat2_cat
    if cfg.span_score_mode not in ("simsweep_cat", "simsweep_cat_bf16"):
        raise ValueError(
            "span_sim_pad_l only composes with span_score_mode="
            f"'simsweep_cat'/'simsweep_cat_bf16', got {cfg.span_score_mode!r}")
    if feat2_cat is None:
        return feat2_cat
    L = feat2_cat.shape[1]
    if pad_l < L:
        raise ValueError(f"span_sim_pad_l={pad_l} < cache clip length {L}")
    if pad_l == L:
        return feat2_cat
    return torch.nn.functional.pad(feat2_cat, (0, 0, 0, pad_l - L))


def _video_sel(cfg: RetrievalConfig):
    """The exact video top-V selector of the fast path."""
    if cfg.video_topk_psort:
        raise NotImplementedError("video_topk_psort is ROADMAP A11 (kernel B6)")
    return topk_stable_blocked


def _uses_fast_path(model: XML) -> bool:
    c = model.cfg
    return (c.merge_two_stream and c.use_video and c.use_sub
            and c.span_predictor_type == "conv")


@torch.no_grad()
def encode_corpus(model: XML, builder: ExampleBuilder, corpus: CorpusIndex,
                  cfg: RetrievalConfig) -> CorpusCache:
    """Encode every corpus video once with the context encoders, on the
    model's device. feat1 is L2-normalized here, so query-time cosine
    scoring normalizes only the queries."""
    check_supported(cfg)
    device = next(model.parameters()).device
    dt = cfg.cache_dtype
    n = len(corpus)
    bsz = min(cfg.context_bsz, n)
    chunks: Dict[str, list] = {"vf1": [], "vf2": [], "sf1": [], "sf2": [], "mask": []}
    norm = lambda x: (x / (torch.linalg.norm(x.float(), dim=-1, keepdim=True)
                           + 1e-12)).to(dt)
    on = lambda a: torch.from_numpy(a).to(device)
    for i in range(0, n, bsz):
        batch = builder.build_context_batch(corpus.vid_names[i:i + bsz],
                                            corpus.durations[i:i + bsz])
        vm, sm = on(batch.video_mask), on(batch.sub_mask)
        vf1, vf2, sf1, sf2 = model.encode_context(on(batch.video_feat), vm,
                                                  on(batch.sub_feat), sm)
        chunks["vf1"].append(norm(vf1))
        chunks["vf2"].append(vf2.to(dt))
        chunks["sf1"].append(norm(sf1))
        chunks["sf2"].append(sf2.to(dt))
        chunks["mask"].append(vm)
    cat = {k: torch.cat(v) for k, v in chunks.items()}
    vf2_all, sf2_all = cat["vf2"], cat["sf2"]
    feat2_cat = None
    if cfg.cat_mode:
        feat2_cat = _maybe_pad_clip_axis(torch.cat([vf2_all, sf2_all], dim=-1), cfg)
        vf2_all = sf2_all = None
    vf1_all, sf1_all, mask_all = cat["vf1"], cat["sf1"], cat["mask"]
    if cfg.video_score_mode in ("pallas", "pallas_int8") and _uses_fast_path(model):
        vf1_all = build_flat_feat1(vf1_all, mask_all, chunk_v=cfg.video_chunk_v)
        sf1_all = build_flat_feat1(sf1_all, mask_all, chunk_v=cfg.video_chunk_v)
        if cfg.video_score_mode == "pallas_int8":
            vf1_all, sf1_all = quantize_unit_i8(vf1_all), quantize_unit_i8(sf1_all)
    return CorpusCache(
        video_feat1=vf1_all, video_feat2=vf2_all, sub_feat1=sf1_all,
        sub_feat2=sf2_all, mask=mask_all, n_videos=n,
        metas=[{"vid_name": v, "duration": d}
               for v, d in zip(corpus.vid_names, corpus.durations)],
        feat2_cat=feat2_cat)


def _normalize(q: torch.Tensor) -> torch.Tensor:
    return q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-12)


@torch.no_grad()
def _score_query_batch(model: XML, cfg: RetrievalConfig, query_feat, query_mask,
                       video_feat1, video_feat2, sub_feat1, sub_feat2, ctx_mask,
                       gt_meta_idx, do_svmr: bool, use_external_vr: bool = False,
                       external_idx=None, external_scores=None,
                       feat2_cat=None) -> Dict[str, torch.Tensor]:
    """Score one query batch against the whole cached corpus (fast path:
    merged two-stream ConvSE). Video scores cover every video; span
    probabilities only the gathered top-V (+ GT) rows, exact-equivalent to
    the reference's conv over every video because conv and softmax are
    per row (inference.py:308-374). Returns device tensors keyed like the
    JAX engine's output."""
    check_supported(cfg)
    if not _uses_fast_path(model):
        raise NotImplementedError(
            "the get_pred_from_raw_query branch (non-merged configs) is ROADMAP A8")
    f32 = torch.float32
    nv, L = ctx_mask.shape
    V = min(cfg.max_vcmr_video, nv)
    alpha = cfg.q2c_alpha

    vq, sq = model.encode_query(query_feat, query_mask)          # (Nq, D) x2
    fused_bmax = None
    if cfg.video_score_mode in ("pallas", "pallas_int8"):
        lp = flat_lp(L)
        if cfg.video_score_mode == "pallas_int8":
            qvt, qst = (quantize_unit_i8(_normalize(q)).T for q in (vq, sq))
        else:
            qvt = _normalize(vq).to(video_feat1.dtype).T
            qst = _normalize(sq).to(sub_feat1.dtype).T
        if cfg.video_topk_fused:
            scores_pad, fused_bmax = video_scores_flat_bmax(
                qvt, qst, video_feat1, sub_feat1, n_videos=nv, lp=lp,
                chunk_v=cfg.video_chunk_v)
            q2c = scores_pad[:, :nv]
        else:
            score = (video_scores_flat_i8 if cfg.video_score_mode == "pallas_int8"
                     else video_scores_flat)
            q2c = score(qvt, qst, video_feat1, sub_feat1, n_videos=nv, lp=lp)
    else:
        q2c = video_scores_xla(_normalize(vq).to(video_feat1.dtype),
                               _normalize(sq).to(sub_feat1.dtype),
                               video_feat1, sub_feat1, ctx_mask)

    if use_external_vr:
        # an external VR result replaces the internal video ranking
        # (reference inference.py:346-355)
        topv_idx = external_idx
        topv_scores = torch.exp(alpha * external_scores)
    elif fused_bmax is not None:
        # kernel-emitted block maxima; pre-exp ranking (exp is monotone)
        topv_q2c, topv_idx = topk_from_block_max(
            scores_pad, fused_bmax, V,
            block=scores_pad.shape[1] // fused_bmax.shape[1])
        topv_scores = torch.exp(alpha * topv_q2c)
    elif cfg.video_topk_pre_exp:
        topv_q2c, topv_idx = _video_sel(cfg)(q2c.to(f32), V)
        topv_scores = torch.exp(alpha * topv_q2c)
    else:
        topv_scores, topv_idx = _video_sel(cfg)(torch.exp(alpha * q2c.to(f32)), V)
    topv_idx = topv_idx.long()
    gather_idx = (torch.cat([topv_idx, gt_meta_idx.long()[:, None]], dim=1)
                  if do_svmr else topv_idx)                      # (Nq, V[+1])
    st_logits, ed_logits = model.merged_st_ed_scores_simgather_cat(
        vq, sq, feat2_cat, ctx_mask, gather_idx,
        sim_dtype=(torch.bfloat16 if cfg.span_score_mode == "simsweep_cat_bf16"
                   else None))
    st_probs = torch.softmax(st_logits.to(f32), dim=-1)
    ed_probs = torch.softmax(ed_logits.to(f32), dim=-1)

    vcmr_vid_local, vcmr_st, vcmr_ed, vcmr_scores = banded_topk_spans_grouped_shift(
        st_probs[:, :V], ed_probs[:, :V], topv_scores, cfg.min_pred_l,
        cfg.max_pred_l, cfg.max_before_nms)
    out = dict(topv_scores=topv_scores, topv_idx=topv_idx.to(torch.int32),
               vcmr_vid_local=vcmr_vid_local, vcmr_st=vcmr_st, vcmr_ed=vcmr_ed,
               vcmr_scores=vcmr_scores)
    if do_svmr:
        svmr_st, svmr_ed, svmr_scores = banded_top_spans_from_probs(
            st_probs[:, V], ed_probs[:, V], cfg.min_pred_l, cfg.max_pred_l,
            cfg.max_before_nms)
        out.update(svmr_st=svmr_st, svmr_ed=svmr_ed, svmr_scores=svmr_scores)
    return out


def load_external_vr_submission(path: str, corpus: CorpusIndex,
                                cache_metas: List[dict], top_n: int):
    """VR submission JSON -> {desc_id: (meta_idx_list, score_list)}
    (reference load_external_vr_res2 + meta mapping, inference.py:244-273)."""
    from tvretrieval_tpu.utils.io import load_json

    sub = load_json(path)
    video_idx2meta = {corpus.video2idx[m["vid_name"]]: i
                      for i, m in enumerate(cache_metas)}
    out = {}
    for e in sub["VR"]:
        preds = e["predictions"][:top_n]
        out[e["desc_id"]] = ([video_idx2meta[p[0]] for p in preds],
                             [p[3] for p in preds])
    return out


def retrieve(model: XML, builder: ExampleBuilder, cache: CorpusCache,
             query_rows: List[dict], corpus: CorpusIndex, cfg: RetrievalConfig,
             tasks: Sequence[str] = ("VCMR", "SVMR", "VR"),
             external_vr_path: Optional[str] = None,
             return_arrays: bool = False) -> Dict[str, list]:
    """Score all queries against the cached corpus; return submission
    entries per task (reference compute_query2ctx_info,
    inference.py:252-445), or with ``return_arrays`` the row-aligned numpy
    arrays that ``eval_retrieval_arrays`` reads.

    external_vr_path: a VR submission whose top videos and scores replace
    the internal video ranking (reference --external_inference_vr_res_path).
    """
    do_svmr = "SVMR" in tasks
    device = cache.mask.device
    vid2meta = {m["vid_name"]: i for i, m in enumerate(cache.metas)}
    meta_video_idx = np.asarray(
        [corpus.video2idx[m["vid_name"]] for m in cache.metas], dtype=np.int64)
    external = (load_external_vr_submission(external_vr_path, corpus,
                                            cache.metas, cfg.max_vcmr_video)
                if external_vr_path else None)
    n_q = len(query_rows)
    if n_q == 0:
        return {}
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    collected = []
    # shapes need not be static here: the last batch is not padded
    for i in range(0, n_q, cfg.query_bsz):
        rows = query_rows[i:i + cfg.query_bsz]
        qb = builder.build_query_batch(rows)
        gt_idx = np.asarray([vid2meta.get(r.get("vid_name") or "", 0) for r in rows],
                            dtype=np.int64)
        ext_args = {}
        if external is not None:
            V = min(cfg.max_vcmr_video, len(cache.metas))
            ext_idx = np.zeros((len(rows), V), np.int64)
            ext_scores = np.full((len(rows), V), -1e10, np.float32)
            for qi, r in enumerate(rows):
                idxs, scores = external.get(r["desc_id"], ([], []))
                k = min(len(idxs), V)
                ext_idx[qi, :k] = idxs[:k]
                ext_scores[qi, :k] = scores[:k]
            ext_args = dict(use_external_vr=True, external_idx=on(ext_idx),
                            external_scores=on(ext_scores))
        out = _score_query_batch(
            model, cfg, on(qb.query_feat), on(qb.query_mask),
            cache.video_feat1, cache.video_feat2, cache.sub_feat1, cache.sub_feat2,
            cache.mask, on(gt_idx), do_svmr, feat2_cat=cache.feat2_cat, **ext_args)
        collected.append({k: v.cpu().numpy() for k, v in out.items()})

    res = {k: np.concatenate([c[k] for c in collected], axis=0) for k in collected[0]}
    c = cfg.clip_length
    topv_video_idx = meta_video_idx[res["topv_idx"]]                     # (Nq, V)
    vcmr_meta_idx = np.take_along_axis(res["topv_idx"], res["vcmr_vid_local"], axis=1)
    vcmr_video_idx = meta_video_idx[vcmr_meta_idx]
    vcmr_st_sec = res["vcmr_st"].astype(np.float64) * c
    vcmr_ed_sec = (res["vcmr_ed"].astype(np.float64) + 1) * c

    if return_arrays:
        out = {}
        if "VCMR" in tasks:
            out["VCMR"] = (vcmr_video_idx,
                           np.stack([vcmr_st_sec, vcmr_ed_sec], axis=-1),
                           res["vcmr_scores"])
        if do_svmr:
            gt_vid = np.asarray([corpus.video2idx[r["vid_name"]] for r in query_rows])
            svmr_vid = np.broadcast_to(gt_vid[:, None], res["svmr_st"].shape)
            svmr_spans = np.stack(
                [res["svmr_st"].astype(np.float64) * c,
                 (res["svmr_ed"].astype(np.float64) + 1) * c], axis=-1)
            out["SVMR"] = (svmr_vid, svmr_spans, res["svmr_scores"])
        if "VR" in tasks:
            out["VR"] = (topv_video_idx,
                         np.zeros_like(topv_video_idx[..., None],
                                       dtype=np.float64).repeat(2, -1),
                         res["topv_scores"])
        return out

    def rows4(vid, st, ed, scores):
        return np.stack([vid.astype(np.float64), st, ed,
                         scores.astype(np.float64)], axis=-1).tolist()

    entries: Dict[str, list] = {}
    if "VCMR" in tasks:
        entries["VCMR"] = rows4(vcmr_video_idx, vcmr_st_sec, vcmr_ed_sec,
                                res["vcmr_scores"])
    if do_svmr:
        gt_vid_col = np.asarray([corpus.video2idx[r["vid_name"]] for r in query_rows],
                                dtype=np.float64)
        entries["SVMR"] = rows4(
            np.broadcast_to(gt_vid_col[:, None], res["svmr_st"].shape),
            res["svmr_st"].astype(np.float64) * c,
            (res["svmr_ed"].astype(np.float64) + 1) * c, res["svmr_scores"])
    if "VR" in tasks:
        zeros = np.zeros_like(topv_video_idx[:, :100], dtype=np.float64)
        entries["VR"] = rows4(topv_video_idx[:, :100], zeros, zeros,
                              res["topv_scores"][:, :100])
    out = {}
    for task in ("VCMR", "SVMR", "VR"):
        if task not in entries:
            continue
        out[task] = [
            {"desc_id": row["desc_id"], "desc": row.get("desc", ""),
             "predictions": [[int(p[0]), 0 if task == "VR" else p[1],
                              0 if task == "VR" else p[2], p[3]] for p in preds]}
            for row, preds in zip(query_rows, entries[task])]
    return out
