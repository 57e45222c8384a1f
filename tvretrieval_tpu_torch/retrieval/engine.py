"""Whole-corpus VCMR / SVMR / VR inference engine, exact and int8 modes, in PyTorch.

Port of tvretrieval_tpu/retrieval/engine.py (reference inference.py:32-445).
The corpus is encoded once (``encode_corpus``); each query batch then runs
``_score_query_batch`` on the cache's device:

1. ``XML.encode_query``;
2. q2c video scores against every video — the CUDA video-score kernels
   (ops.video_score) under ``video_score_mode`` "pallas" / "pallas_int8",
   or the einsum path under "einsum";
3. ``exp(alpha * q2c)`` and an exact stable top-V (through the sorting
   kernel, ops.sort, under ``video_topk_psort``), or under
   ``video_topk_approx`` the approximate top-k of the pre-exp scores
   (ops.approx_topk, B11) and ``exp`` of the V selected;
4. span logits of the top-V (+ GT) videos: one corpus-wide similarity
   sweep and a row gather of the similarities, over the concatenated feat2
   cache (``XML.merged_st_ed_scores_simgather_cat``), its int8 forms
   ("simsweep_cat_int8": ``..._simgather_cat_i8``; "simsweep_cat_int8_flat":
   the CUDA span-similarity kernel, ``..._pallas_cat_i8``) or the two
   streams ("simsweep"); or under span mode "gather" the feature rows
   themselves (``XML.merged_st_ed_scores_gathered``); then ConvSE and
   softmax;
5. the banded span top-N (through the sorting kernel under
   "grouped_shift_psort", through the approximate top-k under
   "grouped_shift_approx") and the SVMR row (ops.span).

Steps 2-5 and the flat cache layouts are the stages the sharded engine
shares (retrieval/stages.py).

Configurations without the merged two-stream conv head (the XML variants:
one stream, "w/o merge", ``cat_linear``) take the JAX engine's other
branch (engine.py:658-676): ``XML.get_pred_from_raw_query(cross=True)``
over every video, ``exp(alpha * q2c)``, an exact stable top-V and a gather
of the top-V probability rows, then step 5. Its video and span score modes
do not apply (the JAX package has no kernel there either); its span top-k
mode does, so B6 and B11 run there under "grouped_shift_psort" and
"grouped_shift_approx". It holds (Nq, Nv, L) logits and probabilities,
so ``query_bsz`` bounds its memory.

``encode_corpus_resident`` encodes from the device-resident corpus
(data.device_corpus) instead of host-built batches. ``retrieve`` turns the
results into the submission the evaluator (evaluation.metrics) scores;
given ``streaming_host`` it scores each batch from a corpus in host memory
instead (retrieval.streaming). Mode names are the JAX package's so
configurations carry over; "pallas" here means the CUDA kernel. The
approximate selections compute, on the CPU as on the card, the binned
top-k that ``lax.approx_max_k`` runs on a TPU (ops/approx_topk.py); the
JAX package is exact on the CPU only because XLA sorts there.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from tvretrieval_tpu_torch.data.datasets import CorpusIndex, ExampleBuilder
from tvretrieval_tpu_torch.data.device_corpus import (
    assemble_context_slice,
    assemble_queries,
)
from tvretrieval_tpu_torch.models.xml import XML
from tvretrieval_tpu_torch.ops.span import banded_top_spans_from_probs, topk_stable
from tvretrieval_tpu_torch.ops.video_score import quantize_rows_i8
from tvretrieval_tpu_torch.retrieval import stages
from tvretrieval_tpu_torch.retrieval.streaming import streaming_score_query_batch
from tvretrieval_tpu_torch.utils import trace
from tvretrieval_tpu_torch.utils.io import load_json


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
    # "gather" (feature-row gather); "simsweep" (a similarity sweep per
    # stream, then a gather of similarity rows); "simsweep_cat" (one sweep
    # over the concatenated cache); "simsweep_cat_bf16" (similarity stored
    # bf16); "simsweep_cat_int8" (int8 cache + per-row scales, integer
    # dots, rescale on the gathered rows); "simsweep_cat_int8_flat" (the
    # int8 sweep as the B5 CUDA kernel over the video-major flat cache,
    # similarity stored bf16). The int8 modes are not parity modes.
    span_score_mode: str = "gather"
    # zero-pad the concatenated cache's clip axis to this length (0 = off;
    # "simsweep_cat" / "simsweep_cat_bf16" only)
    span_sim_pad_l: int = 0
    # "einsum"; "pallas" (B2/B3 CUDA kernel); "pallas_int8" (B1/B3)
    video_score_mode: str = "einsum"
    # upper bound on the videos per block maximum (B3) and the flat-cache
    # video padding multiple
    video_chunk_v: int = 16
    # "grouped", "grouped_shift", "grouped_shift8", "grouped_shift_psort"
    # (selections by the B6 sorting kernel): equal bit for bit.
    # "grouped_shift_approx": the two selections by the approximate top-k
    # (B11) at topk_approx_recall; not a parity mode
    span_topk_mode: str = "grouped"
    # video top-V by the approximate top-k (B11) on the pre-exp scores, exp
    # on the V selected only; not a parity mode (the external selection
    # takes precedence, then this one, then the fused one)
    video_topk_approx: bool = False
    # video top-V through the B6 sorting kernel: a parity mode (the
    # external, approximate and fused selections take precedence; composes
    # with pre_exp)
    video_topk_psort: bool = False
    # recall target of every approximate selection
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


SPAN_SCORE_MODES = ("gather", "simsweep", "simsweep_cat", "simsweep_cat_bf16",
                    "simsweep_cat_int8", "simsweep_cat_int8_flat")


def check_supported(cfg: RetrievalConfig) -> None:
    """Raise ValueError for a mode name nobody has."""
    if cfg.video_score_mode not in ("einsum",) + stages.KERNEL_VIDEO_MODES:
        raise ValueError(f"video_score_mode={cfg.video_score_mode!r}")
    if cfg.span_score_mode not in SPAN_SCORE_MODES:
        raise ValueError(f"span_score_mode={cfg.span_score_mode!r}; one of "
                         f"{SPAN_SCORE_MODES}")
    if cfg.span_topk_mode not in stages.SPAN_TOPK:
        raise ValueError(f"span_topk_mode={cfg.span_topk_mode!r}; one of "
                         f"{tuple(stages.SPAN_TOPK)}")


def auto_interpret(cfg: RetrievalConfig) -> RetrievalConfig:
    """cfg unchanged. The JAX engine switches ``pallas_interpret`` on where
    a Pallas mode meets the CPU backend, since Mosaic lowers only on a TPU;
    here a kernel wrapper runs its plain version on CPU tensors and
    launches its CUDA kernel on CUDA tensors, and the kernels have no
    interpret mode, so there is nothing to switch. Kept so that callers of
    the JAX function carry over."""
    return cfg


@dataclass
class CorpusCache:
    """Encoded corpus on one device (feat1 = retrieval stream, feat2 =
    localization stream; reference compute_context_info, inference.py:32-97).
    Under video_score_mode "pallas" / "pallas_int8" the feat1 slots hold
    the flat mask-free (Nv_pad * flat_lp(L), D) layout (int8 for
    pallas_int8); under the cat span modes feat2_cat = [vf2 ; sf2]
    replaces the two feat2 streams: (Nv, L, 2D) at the cache dtype, int8
    under "simsweep_cat_int8", and the video-major flat (Nv_pad * lp, 2D)
    int8 layout, lp = flat_lp(L), under "simsweep_cat_int8_flat"."""

    video_feat1: Optional[torch.Tensor]
    video_feat2: Optional[torch.Tensor]
    sub_feat1: Optional[torch.Tensor]
    sub_feat2: Optional[torch.Tensor]
    mask: torch.Tensor                   # (Nv, L)
    n_videos: int
    metas: List[dict]                    # per-video {vid_name, duration}
    feat2_cat: Optional[torch.Tensor] = None
    # per-row quantization scales of an int8 feat2_cat: (Nv, L) f32, or
    # (Nv_pad, lp) for the flat layout
    feat2_cat_scale: Optional[torch.Tensor] = None


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
            "'simsweep_cat'/'simsweep_cat_bf16' (the int8 flat layout has its "
            f"own flat_lp(L) pad), got {cfg.span_score_mode!r}")
    if feat2_cat is None:
        return feat2_cat
    L = feat2_cat.shape[1]
    if pad_l < L:
        raise ValueError(f"span_sim_pad_l={pad_l} < cache clip length {L}")
    if pad_l == L:
        return feat2_cat
    return torch.nn.functional.pad(feat2_cat, (0, 0, 0, pad_l - L))


@torch.no_grad()
def encode_corpus(model: XML, builder: ExampleBuilder, corpus: CorpusIndex,
                  cfg: RetrievalConfig, batch_cache: Optional[list] = None) -> CorpusCache:
    """Encode every corpus video once with the context encoders, on the
    model's device. feat1 is L2-normalized here, so query-time cosine
    scoring normalizes only the queries.

    batch_cache: optional mutable list. Empty: the host-built context
    batches are appended to it, their features as float16 (half the host
    memory and copy; the model upcasts them); non-empty: they are reused,
    so re-encoding the corpus every epoch skips the host's batch building."""
    check_supported(cfg)
    device = next(model.parameters()).device
    n = len(corpus)
    bsz = min(cfg.context_bsz, n)
    chunks: Dict[str, list] = {}
    on = lambda a: torch.from_numpy(a).to(device)
    reuse = bool(batch_cache)
    for bi, i in enumerate(range(0, n, bsz)):
        if reuse:
            batch = batch_cache[bi]
        else:
            batch = builder.build_context_batch(corpus.vid_names[i:i + bsz],
                                                corpus.durations[i:i + bsz])
            if batch_cache is not None:
                batch.video_feat = batch.video_feat.astype(np.float16)
                batch.sub_feat = batch.sub_feat.astype(np.float16)
                batch_cache.append(batch)
        vm, sm = on(batch.video_mask), on(batch.sub_mask)
        parts = _cache_parts(model, cfg, vm, *model.encode_context(
            on(batch.video_feat).float(), vm, on(batch.sub_feat).float(), sm))
        for k, v in parts.items():
            chunks.setdefault(k, []).append(v)
    return _finish_cache(model, cfg, corpus, {k: torch.cat(v) for k, v in chunks.items()})


def _cache_parts(model: XML, cfg: RetrievalConfig, mask, vf1, vf2, sf1, sf2
                 ) -> Dict[str, torch.Tensor]:
    """One encoded chunk's cache entries: feat1 L2-normalized (query-time
    cosine scoring then normalizes only the queries), everything at the
    cache dtype, a stream the model lacks left out, and on the fast path
    under the cat span modes feat2_cat = [vf2 ; sf2] in place of the two
    feat2 streams."""
    dt = cfg.cache_dtype
    norm = lambda x: (x / (torch.linalg.norm(x.float(), dim=-1, keepdim=True)
                           + 1e-12)).to(dt)
    parts = {"mask": mask}
    for key, x, f in (("vf1", vf1, norm), ("sf1", sf1, norm),
                      ("vf2", vf2, lambda x: x.to(dt)), ("sf2", sf2, lambda x: x.to(dt))):
        if x is not None:
            parts[key] = f(x)
    if cfg.cat_mode and model.cfg.merged_spans:
        parts["feat2_cat"] = torch.cat([parts.pop("vf2"), parts.pop("sf2")], dim=-1)
    return parts


def _finish_cache(model: XML, cfg: RetrievalConfig, corpus: CorpusIndex,
                  bufs: Dict[str, torch.Tensor]) -> CorpusCache:
    """Whole-corpus buffers (mask, the model's streams of vf1 / sf1, and
    either vf2 / sf2 or feat2_cat) -> CorpusCache: the clip-axis pad or the
    int8 layouts of feat2_cat and, on the fast path, the flat layouts of
    the kernel modes (``stages.flat_layout``). A stream the model lacks
    stays None, as in the JAX engine. Buffers are popped as they are
    replaced, so a source frees once its copy exists."""
    bufs["feat2_cat"] = _maybe_pad_clip_axis(bufs.pop("feat2_cat", None), cfg)
    if bufs["feat2_cat"] is not None and cfg.span_score_mode == "simsweep_cat_int8":
        # per-(video, clip) rows; feat2 is not unit-norm, so scales are kept
        bufs["feat2_cat"], bufs["feat2_cat_scale"] = quantize_rows_i8(bufs.pop("feat2_cat"))
    if model.cfg.merged_spans:
        stages.flat_layout(cfg, bufs, cfg.video_chunk_v)
    return CorpusCache(
        video_feat1=bufs.get("vf1"), video_feat2=bufs.get("vf2"), sub_feat1=bufs.get("sf1"),
        sub_feat2=bufs.get("sf2"), mask=bufs["mask"], n_videos=len(corpus),
        metas=[{"vid_name": v, "duration": d}
               for v, d in zip(corpus.vid_names, corpus.durations)],
        feat2_cat=bufs.get("feat2_cat"), feat2_cat_scale=bufs.get("feat2_cat_scale"))


@torch.no_grad()
def encode_corpus_resident(model: XML, device_data, corpus: CorpusIndex,
                           cfg: RetrievalConfig) -> CorpusCache:
    """encode_corpus against the device-resident context block
    (data/device_corpus.py): no host-to-device feature transfer per epoch.

    Equal to encode_corpus: chunks of context_bsz videos are sliced from
    the resident block, assembled on the device (TEF + mask from clip
    counts), encoded, and written in place into PREALLOCATED cache buffers,
    so peak memory is cache + one chunk rather than twice the cache (the
    concatenation in encode_corpus holds both for a moment). The final
    partial chunk overlaps the one before (encoding is deterministic per
    video, so rewriting rows is exact), keeping one chunk shape.
    """
    check_supported(cfg)
    akw = device_data.assemble_kwargs
    ctx = device_data.ctx_device
    nv = len(corpus)
    bsz = min(cfg.context_bsz, nv)
    bufs: Dict[str, torch.Tensor] = {}
    for start in list(range(0, nv - bsz, bsz)) + [nv - bsz]:
        vfeat, mask, sfeat, _ = assemble_context_slice(ctx, start, bsz, **akw)
        parts = _cache_parts(model, cfg, mask,
                             *model.encode_context(vfeat, mask, sfeat, mask))
        for k, v in parts.items():
            if k not in bufs:
                bufs[k] = torch.zeros((nv,) + v.shape[1:], dtype=v.dtype, device=v.device)
            bufs[k][start:start + bsz] = v
    return _finish_cache(model, cfg, corpus, bufs)


@torch.no_grad()
def _score_query_batch(model: XML, cfg: RetrievalConfig, query_feat, query_mask,
                       video_feat1, video_feat2, sub_feat1, sub_feat2, ctx_mask,
                       gt_meta_idx, do_svmr: bool, use_external_vr: bool = False,
                       external_idx=None, external_scores=None,
                       feat2_cat=None, feat2_cat_scale=None) -> Dict[str, torch.Tensor]:
    """Score one query batch against the whole cached corpus. Fast path
    (the merged two-stream conv head): video scores cover every video and
    span probabilities only the gathered top-V (+ GT) rows, exact-equivalent
    to the reference's conv over every video because conv and softmax are
    per row (inference.py:308-374). Other configurations: span
    probabilities for every video, then the top-V rows (JAX
    engine.py:658-676). Returns device tensors keyed like the JAX engine's
    output.

    Under ``torch.profiler`` the call is the span "score_query_batch"
    (utils/trace.py), whose counter ``out_bytes`` sums the returned
    tensors' bytes, and each stage its own span inside it: "encode_query",
    "video_scores", "video_topk", "span_sweep" (with "span_head" inside),
    "span_head", "span_topk", "svmr". No device work is issued between two
    stages: a stage's span starts at the exit event of the one before it.
    The fast path's stages are those of ``retrieval.stages``; the video
    score kernel is the one the cache's layout was built for."""
    check_supported(cfg)
    with trace.span("score_query_batch", query_feat.device) as root:
        f32 = torch.float32
        V = min(cfg.max_vcmr_video, ctx_mask.shape[0])
        alpha = cfg.q2c_alpha

        if model.cfg.merged_spans:
            with trace.span("encode_query"):
                vq, sq = model.encode_query(query_feat, query_mask)      # (Nq, D) x2
            with trace.span("video_scores"):
                q2c, fused = stages.video_scores(cfg, vq, sq, video_feat1, sub_feat1, ctx_mask)
            with trace.span("video_topk"):
                if use_external_vr:
                    # an external VR result replaces the internal video ranking
                    # (reference inference.py:346-355)
                    topv_idx = external_idx
                    topv_scores = torch.exp(alpha * external_scores)
                else:
                    sel, topv_idx, pre_exp = stages.select_videos(cfg, q2c, V, fused)
                    topv_scores = torch.exp(alpha * sel) if pre_exp else sel
                topv_idx = topv_idx.long()
                gather_idx = (torch.cat([topv_idx, gt_meta_idx.long()[:, None]], dim=1)
                              if do_svmr else topv_idx)                  # (Nq, V[+1])
            with trace.span("span_sweep"):
                feat2 = ((feat2_cat, feat2_cat_scale) if cfg.cat_mode
                         else (video_feat2, sub_feat2))
                st_logits, ed_logits = stages.span_logits(
                    model, cfg.span_score_mode, vq, sq, feat2, ctx_mask, gather_idx)
            with trace.span("span_head"):
                st_probs = torch.softmax(st_logits.to(f32), dim=-1)
                ed_probs = torch.softmax(ed_logits.to(f32), dim=-1)
                st_top, ed_top = st_probs[:, :V], ed_probs[:, :V]
                if do_svmr:
                    st_gt, ed_gt = st_probs[:, V], ed_probs[:, V]      # the gathered GT row
        else:
            up = lambda x: None if x is None else x.to(f32)
            q2c, st_logits, ed_logits = model.get_pred_from_raw_query(
                query_feat, query_mask, up(video_feat1), up(video_feat2), ctx_mask,
                up(sub_feat1), up(sub_feat2), ctx_mask, cross=True)  # (Nq, Nv), (Nq, Nv, L)
            with trace.span("span_head"):
                st_probs = torch.softmax(st_logits.to(f32), dim=-1)
                del st_logits
                ed_probs = torch.softmax(ed_logits.to(f32), dim=-1)
                del ed_logits
            with trace.span("video_topk"):
                if use_external_vr:
                    topv_idx = external_idx
                    topv_scores = torch.exp(alpha * external_scores)
                elif cfg.video_topk_pre_exp:
                    topv_q2c, topv_idx = topk_stable(q2c.to(f32), V)
                    topv_scores = torch.exp(alpha * topv_q2c)
                else:
                    topv_scores, topv_idx = topk_stable(torch.exp(alpha * q2c.to(f32)), V)
                topv_idx = topv_idx.long()
                rows = torch.arange(topv_idx.shape[0], device=topv_idx.device)
                st_top = st_probs[rows[:, None], topv_idx]
                ed_top = ed_probs[rows[:, None], topv_idx]
                if do_svmr:
                    # the GT row of the full probabilities (JAX engine.py:718-723)
                    gt = gt_meta_idx.long()
                    st_gt, ed_gt = st_probs[rows, gt], ed_probs[rows, gt]

        with trace.span("span_topk"):
            vcmr_vid_local, vcmr_st, vcmr_ed, vcmr_scores = stages.span_topk(cfg)(
                st_top, ed_top, topv_scores, cfg.min_pred_l, cfg.max_pred_l, cfg.max_before_nms)
            out = dict(topv_scores=topv_scores, topv_idx=topv_idx.to(torch.int32),
                       vcmr_vid_local=vcmr_vid_local, vcmr_st=vcmr_st, vcmr_ed=vcmr_ed,
                       vcmr_scores=vcmr_scores)
        if do_svmr:
            with trace.span("svmr"):
                svmr_st, svmr_ed, svmr_scores = banded_top_spans_from_probs(
                    st_gt, ed_gt, cfg.min_pred_l, cfg.max_pred_l, cfg.max_before_nms)
            out.update(svmr_st=svmr_st, svmr_ed=svmr_ed, svmr_scores=svmr_scores)
        if root is not None:
            root.count(out_bytes=sum(v.nbytes for v in out.values()))
        return out


def load_external_vr_submission(path: str, corpus: CorpusIndex,
                                cache_metas: List[dict], top_n: int):
    """VR submission JSON -> {desc_id: (meta_idx_list, score_list)}
    (reference load_external_vr_res2 + meta mapping, inference.py:244-273)."""
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
             return_arrays: bool = False, query_table=None, streaming_host=None,
             streaming_block_videos: int = 2048, streaming_mesh=None) -> Dict[str, list]:
    """Score all queries against the cached corpus; return submission
    entries per task (reference compute_query2ctx_info,
    inference.py:252-445), or with ``return_arrays`` the row-aligned numpy
    arrays that ``eval_retrieval_arrays`` reads.

    external_vr_path: a VR submission whose top videos and scores replace
    the internal video ranking (reference --external_inference_vr_res_path).
    query_table: optional data.device_corpus.QueryTable row-aligned with
    query_rows; query features then stream quantized and are assembled on
    the device, skipping the host's per-row batch building each epoch.
    streaming_host: a retrieval.streaming.HostCorpusCache; each query batch
    is then scored by the streaming engine on the model's device, from the
    corpus in host memory (``cache`` is read for its video metas only, and
    its device tensors may be gone); streaming_block_videos videos are
    streamed at a time, split over the devices of ``streaming_mesh`` (a
    ``parallel.mesh.Mesh``) when one is given. External VR is not taken on
    the streaming path.
    """
    do_svmr = "SVMR" in tasks
    if streaming_host is not None and external_vr_path:
        raise ValueError("external VR is not supported on the streaming path (score "
                         "the resident cache, or merge externally)")
    device = (next(model.parameters()).device if streaming_host is not None
              else cache.mask.device)
    vid2meta = {m["vid_name"]: i for i, m in enumerate(cache.metas)}
    meta_video_idx = np.asarray(
        [corpus.video2idx[m["vid_name"]] for m in cache.metas], dtype=np.int64)
    external = (load_external_vr_submission(external_vr_path, corpus,
                                            cache.metas, cfg.max_vcmr_video)
                if external_vr_path else None)
    n_q = len(query_rows)
    if n_q == 0:
        return {}
    if query_table is not None and len(query_table.q_len) != n_q:
        raise ValueError("query_table must be row-aligned with query_rows")
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    collected = []
    # shapes need not be static here: the last batch is not padded
    for i in range(0, n_q, cfg.query_bsz):
        rows = query_rows[i:i + cfg.query_bsz]
        if query_table is not None:
            qf, ql, _, _ = query_table.chunk(np.arange(i, i + len(rows)))
            q_feat, q_mask = assemble_queries(
                on(qf), on(ql), dtype_name=query_table.dtype_name,
                max_desc_l=query_table.max_desc_l)
        else:
            qb = builder.build_query_batch(rows)
            q_feat, q_mask = on(qb.query_feat), on(qb.query_mask)
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
        if streaming_host is not None:
            out = streaming_score_query_batch(
                model, cfg, q_feat, q_mask, streaming_host,
                gt_meta_idx=gt_idx if do_svmr else None,
                block_videos=streaming_block_videos, mesh=streaming_mesh)
        else:
            out = _score_query_batch(
                model, cfg, q_feat, q_mask,
                cache.video_feat1, cache.video_feat2, cache.sub_feat1, cache.sub_feat2,
                cache.mask, on(gt_idx), do_svmr, feat2_cat=cache.feat2_cat,
                feat2_cat_scale=cache.feat2_cat_scale, **ext_args)
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


def arrays_to_submission(arrays: Dict[str, tuple], query_rows: List[dict],
                         top_n: int = 100) -> Dict[str, list]:
    """Convert retrieve(return_arrays=True) output into submission dicts
    (only done for the best epoch / final inference)."""
    out: Dict[str, list] = {}
    for task, (vid, spans, scores) in arrays.items():
        out[task] = [
            {"desc_id": row["desc_id"], "desc": row.get("desc", ""),
             "predictions": [[int(v), float(st), float(ed), float(sc)]
                             for v, (st, ed), sc in zip(vid[qi, :top_n], spans[qi, :top_n],
                                                        scores[qi, :top_n])]}
            for qi, row in enumerate(query_rows)]
    return out
