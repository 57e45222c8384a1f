"""ExCL inference engines, and MEE + ExCL two-stage VCMR over a resident
corpus, PyTorch.

Port of tvretrieval_tpu/retrieval/excl_engine.py, and the TVR paper's
two-stage baseline served over a corpus cache.

SVMR (reference excl/inference.py:31-75): span probabilities on the GT
video, joint (st, ed) product under the min/max-length mask, top spans.

VCMR via external VR (reference excl/inference_with_vcmr.py:40-103): the
top-N videos of an external VR submission are fused with their query, st
probs are scaled by exp(alpha * vr_score), each video keeps its top spans
and those of all N videos are merged by score with Python's stable sort.
(As in the JAX package, and unlike the reference, clip indices are
converted to seconds in the predictions; the reference emits raw clip
indices there, which its own evaluator would mis-score.)

In eval mode each stream's first context LSTM does not see the query, so
its outputs (``ctx1``) are encoded once a video (``encode_excl_contexts``)
and one stage serves both first stages (``excl_vcmr_batch``): for a batch
of queries on the device and without a host sync, ExCL's query encoder,
the candidate videos' ``ctx1`` gathered, the second LSTMs and the heads
over every (query, video) pair, and the span selection (``vcmr_spans``)
through the sorting kernel B6 (ops/sort.py). The external-VR path feeds it
the submission's videos; MEE + ExCL over a resident corpus
(``encode_mee_excl_corpus``, ``score_mee_excl_batch``,
``mee_excl_retrieve_vcmr``) feeds it MEE's exact top N of the whole corpus.

The query's and the first context LSTMs are cuDNN's (float32, TF32 off);
in ``excl_vcmr_batch`` the second LSTMs of both streams are one launch of a
hand-written kernel on a card (``ExCL.fused_span_logits`` through
ops/lstm.py), and the start / end heads of both streams with the mask and
the streams' mean another (through ops/excl_head.py); on the CPU the plain
concatenations, LSTMs and heads; the selections are B6 on a card and a
stable sort on the CPU.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from tvretrieval_tpu_torch.data.datasets import CorpusIndex, ExampleBuilder
from tvretrieval_tpu_torch.data.retrieval_datasets import MEEExampleBuilder
from tvretrieval_tpu_torch.models.components import evaluating
from tvretrieval_tpu_torch.models.excl import ExCL
from tvretrieval_tpu_torch.models.mee import MEE
from tvretrieval_tpu_torch.ops.sort import topk_transposed
from tvretrieval_tpu_torch.ops.span import (
    banded_top_spans_from_probs, banded_topk_spans_per_video, min_max_length_mask,
    top_spans_from_probs, topk_stable_blocked_psort)
from tvretrieval_tpu_torch.utils import trace
from tvretrieval_tpu_torch.utils.io import load_json

BATCH_KEYS = ("query_feat", "query_mask", "video_feat", "video_mask", "sub_feat", "sub_mask")


@torch.no_grad()
def span_probs(model: ExCL, batch: Dict[str, torch.Tensor]):
    """(st_probs, ed_probs), each (N, Lc) float32, in eval mode."""
    with evaluating(model):
        st, ed = model.span_logits(*(batch[k] for k in BATCH_KEYS))
    return torch.softmax(st.float(), dim=-1), torch.softmax(ed.float(), dim=-1)


def _top_spans(st_p, ed_p, min_l: int, max_l: int, top_n: int):
    lm = torch.from_numpy(min_max_length_mask(st_p.shape[-1], min_l, max_l)).to(st_p.device)
    return [t.cpu().numpy() for t in top_spans_from_probs(st_p, ed_p, lm, top_n)]


def excl_retrieve_svmr(model: ExCL, builder: ExampleBuilder, corpus: CorpusIndex,
                       query_rows: List[dict], clip_length: float = 1.5, query_bsz: int = 50,
                       min_pred_l: int = 2, max_pred_l: int = 16,
                       max_before_nms: int = 200) -> Dict[str, list]:
    device = next(model.parameters()).device
    svmr_res = []
    bsz = min(query_bsz, len(query_rows))
    for i in range(0, len(query_rows), bsz):
        rows = query_rows[i:i + bsz]
        b = builder.build_train_batch(rows, eval_labels=True)
        batch = {k: torch.from_numpy(getattr(b, k)).to(device) for k in BATCH_KEYS}
        st_i, ed_i, scores = _top_spans(*span_probs(model, batch), min_pred_l, max_pred_l,
                                        max_before_nms)
        for qi, row in enumerate(rows):
            vid_idx = corpus.video2idx[row["vid_name"]]
            preds = [[vid_idx, float(s * clip_length), float((e + 1) * clip_length), float(sc)]
                     for s, e, sc in zip(st_i[qi], ed_i[qi], scores[qi])]
            svmr_res.append({"desc_id": row["desc_id"], "desc": row.get("desc", ""),
                             "predictions": preds})
    return {"SVMR": svmr_res}


def load_external_vr_with_scores(path: str, top_n: int = 100) -> Dict[int, list]:
    """{desc_id: [(vid_idx, score), ...]} from a VR submission JSON."""
    sub = load_json(path)
    return {e["desc_id"]: [(p[0], p[3]) for p in e["predictions"][:top_n]]
            for e in sub["VR"]}


def vcmr_spans(st_probs: torch.Tensor, ed_probs: torch.Tensor, vr_scores: torch.Tensor,
               q2c_alpha: float, min_l: int, max_l: int, per_video: int, top_n: int):
    """The early-fusion VCMR span stage (reference
    excl/inference_with_vcmr.py:72-97) over (Nq, V, L) probabilities of
    each query's V candidate videos and their (Nq, V) VR scores: starts
    weighted by exp(q2c_alpha * vr_score), each video's top ``per_video``
    banded spans, merged to the top ``top_n`` by score, then the video's
    rank, then the span's rank within it (Python's stable sort). Returns
    (video rank, st, ed) int32 and scores, each (Nq, min(top_n, V * k)),
    k = min(per_video, spans in the band); both selections run by B6."""
    weighted = st_probs * torch.exp(q2c_alpha * vr_scores)[:, :, None]
    return banded_topk_spans_per_video(weighted, ed_probs, min_l, max_l, per_video, top_n,
                                       select=topk_transposed)




@dataclass(frozen=True)
class MEEExCLConfig:
    """Retrieval settings of two-stage VCMR (reference
    excl/inference_with_vcmr.py and its config): the top ``top_n_videos``
    videos of the first stage (MEE, or an external VR result), ExCL's spans
    of each weighted by exp(q2c_alpha * vr_score), ``top_n_per_video``
    spans a video in the band min_pred_l <= ed - st < max_pred_l,
    ``max_before_nms`` kept (also the SVMR row's count)."""
    top_n_videos: int = 100
    q2c_alpha: float = 20.0
    min_pred_l: int = 2
    max_pred_l: int = 16
    top_n_per_video: int = 50
    max_before_nms: int = 200


@dataclass
class ExCLContextCache:
    """ExCL's first-LSTM outputs (Nv, L, hidden_size) of each stream of Nv
    encoded videos (None for a stream the model lacks) and their (Nv, L)
    clip mask."""
    ctx1_video: Optional[torch.Tensor]
    ctx1_sub: Optional[torch.Tensor]
    mask: torch.Tensor

    def __len__(self) -> int:
        return self.mask.shape[0]


@dataclass
class MEEExCLCache:
    """The resident corpus of MEE + ExCL: MEE's video-level embeddings
    (Nv, Do) of each stream (None for a stream it lacks) and ExCL's
    ``ExCLContextCache`` of the same videos."""
    mee_video: Optional[torch.Tensor]
    mee_sub: Optional[torch.Tensor]
    excl: ExCLContextCache

    def __len__(self) -> int:
        return len(self.excl)


def _stack_blocks(parts: Iterable[tuple], n_videos: int, who: str) -> list:
    """Fields of ``n_videos`` rows, each allocated once and filled from
    ``parts``, one tuple of (n, ...) tensors (or None) a block."""
    fields, at = None, 0
    for block in parts:
        n = block[-1].shape[0]
        if fields is None:
            fields = [None if t is None else t.new_empty((n_videos,) + t.shape[1:])
                      for t in block]
        for dst, src in zip(fields, block):
            if dst is not None:
                dst[at:at + n] = src
        at += n
    if at != n_videos:
        raise ValueError(f"{who}: the blocks held {at} videos, not {n_videos}")
    return fields


def _excl_parts(excl: ExCL, b: dict) -> tuple:
    return (*excl.encode_context(b["video_feat"], b["mask"], b["sub_feat"], b["mask"]),
            b["mask"].float())


@torch.no_grad()
def encode_excl_contexts(excl: ExCL, blocks: Iterable[dict], n_videos: int) -> ExCLContextCache:
    """ExCL's cache of ``n_videos`` videos from ``blocks``, each a dict of
    one block's ``video_feat`` (n, L, visual_input_size), ``sub_feat``
    (n, L, sub_input_size) and ``mask`` (n, L) on the model's device
    (``excl_context_blocks``). Set-up's peak is the cache and one block."""
    with evaluating(excl):
        return ExCLContextCache(*_stack_blocks((_excl_parts(excl, b) for b in blocks),
                                               n_videos, "encode_excl_contexts"))


@torch.no_grad()
def encode_mee_excl_corpus(mee: MEE, excl: ExCL, blocks: Iterable[dict],
                           n_videos: int) -> MEEExCLCache:
    """The cache of ``n_videos`` videos from ``blocks``: each holds ExCL's
    inputs as ``encode_excl_contexts`` takes them, and MEE's ``mee_video``
    (n, vid_input_size) and ``mee_sub`` (n, sub_input_size)
    (``mee_excl_corpus_blocks``). Set-up's peak is the cache and one block."""
    with evaluating(mee), evaluating(excl):
        mv, ms, *ctx = _stack_blocks(
            ((*mee.encode_context(b["mee_video"], b["mee_sub"]), *_excl_parts(excl, b))
             for b in blocks), n_videos, "encode_mee_excl_corpus")
    return MEEExCLCache(mv, ms, ExCLContextCache(*ctx))


@torch.no_grad()
def excl_vcmr_batch(excl: ExCL, ctx: ExCLContextCache, query_feat: torch.Tensor,
                    query_mask: torch.Tensor, vr_idx: torch.Tensor, vr_scores: torch.Tensor,
                    cfg: MEEExCLConfig,
                    gt: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """ExCL's stage of two-stage VCMR for a batch of queries, (Nq, Lq, Dq)
    features and (Nq, Lq) mask, given each query's V first-stage videos
    ``vr_idx`` (Nq, V) (positions in ``ctx``) and their ``vr_scores``
    (Nq, V), on the cache's device and without a host sync: the query
    encoder, the videos' ``ctx1`` gathered, the second LSTMs and the heads
    over every (query, video) pair, then ``vcmr_spans``. Returns
    ``moments`` (Nq, K, 3) int32 (VR rank, st, ed clip indices) and
    ``moment_scores`` (Nq, K) f32, K = min(max_before_nms, V * k), k =
    min(top_n_per_video, spans in the band); with ``gt`` (Nq,) positions
    also ExCL's SVMR row of each query's GT video, ``svmr`` (Nq,
    max_before_nms, 2) int32 (st, ed) and ``svmr_scores``.

    Under ``torch.profiler`` its spans are "excl_query", "excl_gather"
    (counting ``gathered_bytes``), "excl_lstm" and "excl_head"
    (models/excl.py), "excl_topk". Its working memory is about 0.4 MB a
    (query, video) pair at published widths on a card (each stream's
    gathered ctx1 and its ctx2, 0.1 MB each; the heads' kernel keeps its
    hidden activations in registers), 2 MB on the CPU (where the second
    LSTMs and the heads run over the concatenated inputs)."""
    with evaluating(excl):
        L = ctx.mask.shape[1]
        V = vr_idx.shape[1]
        with trace.span("excl_query"):
            _, q_hidden = excl.query_encoder(query_feat, query_mask.sum(dim=1).int())
        vids = vr_idx.long() if gt is None else torch.cat([vr_idx.long(), gt.long()[:, None]], 1)
        nq, P = vids.shape
        with trace.span("excl_gather") as gather:
            flat = vids.reshape(-1)
            ctx1s = tuple(None if c is None else c.index_select(0, flat)
                          for c in (ctx.ctx1_video, ctx.ctx1_sub))
            mask = ctx.mask.index_select(0, flat)
            if gather is not None:
                gather.count(gathered_bytes=mask.nbytes + sum(
                    c.nbytes for c in ctx1s if c is not None))
        q_pairs = q_hidden[:, None, :].expand(nq, P, q_hidden.shape[-1]).reshape(nq * P, -1)
        st, ed = excl.fused_span_logits(q_pairs, ctx1s, (mask, mask))
        with trace.span("excl_topk"):
            st_p = torch.softmax(st.float(), dim=-1).view(nq, P, L)
            ed_p = torch.softmax(ed.float(), dim=-1).view(nq, P, L)
            vid, m, n, sc = vcmr_spans(st_p[:, :V], ed_p[:, :V], vr_scores, cfg.q2c_alpha,
                                       cfg.min_pred_l, cfg.max_pred_l, cfg.top_n_per_video,
                                       cfg.max_before_nms)
            out = {"moments": torch.stack([vid, m, n], dim=-1), "moment_scores": sc}
            if gt is not None:
                g_st, g_ed, g_sc = banded_top_spans_from_probs(
                    st_p[:, V], ed_p[:, V], cfg.min_pred_l, cfg.max_pred_l,
                    cfg.max_before_nms, select=topk_transposed)
                out.update(svmr=torch.stack([g_st, g_ed], dim=-1), svmr_scores=g_sc)
        return out


@torch.no_grad()
def score_mee_excl_batch(mee: MEE, excl: ExCL, cache: MEEExCLCache, query_feat: torch.Tensor,
                         query_mask: torch.Tensor, cfg: MEEExCLConfig,
                         gt: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """One batch of queries, (Nq, Lq, Dq) features and (Nq, Lq) mask,
    against the cached corpus, on its device and without a host sync:
    MEE's scores of every video and its exact top N = min(top_n_videos,
    Nv) by B6, then ``excl_vcmr_batch`` over them. Returns ``vr_idx``
    (Nq, N) int32 corpus positions and ``vr_scores`` (Nq, N) f32 in
    ``lax.top_k``'s order, and ``excl_vcmr_batch``'s outputs (with ``gt``
    (Nq,) corpus positions, the SVMR row too).

    Under ``torch.profiler`` the call is the span "score_query_batch"
    (utils/trace.py), counting ``pairs`` (query, video) and ``out_bytes``,
    with "mee_vr" and ``excl_vcmr_batch``'s spans inside it."""
    with trace.span("score_query_batch", query_feat.device) as root, evaluating(mee):
        V = min(cfg.top_n_videos, len(cache))
        with trace.span("mee_vr"):
            scores = mee.scores(mee.pool_query(query_feat), cache.mee_video, cache.mee_sub)
            vr_scores, vr_idx = topk_stable_blocked_psort(scores.float(), V)
        out = {"vr_idx": vr_idx, "vr_scores": vr_scores,
               **excl_vcmr_batch(excl, cache.excl, query_feat, query_mask, vr_idx, vr_scores,
                                 cfg, gt)}
        if root is not None:
            root.count(pairs=query_feat.shape[0] * (V + (gt is not None)),
                       out_bytes=sum(v.nbytes for v in out.values()))
        return out


# (query, video) pairs a call of ExCL's stage takes on the external-VR
# path: about 0.4 GB of working memory at published widths on a card, 2 GB on
# the CPU
EXTERNAL_VR_PAIRS = 1000


def excl_retrieve_vcmr_with_external_vr(
        model: ExCL, builder: ExampleBuilder, corpus: CorpusIndex, query_rows: List[dict],
        external_vr_path: str, clip_length: float = 1.5, top_n_videos: int = 100,
        q2c_alpha: float = 20.0, min_pred_l: int = 2, max_pred_l: int = 16,
        top_n_per_video: int = 50, max_before_nms: int = 200) -> Dict[str, list]:
    """VCMR over the external VR submission's top videos: the videos any
    query names are encoded once (``encode_excl_contexts``), then queries
    with the same number of candidates go through ``excl_vcmr_batch`` up
    to ``EXTERNAL_VR_PAIRS`` pairs a call. Each video's spans come from the
    band min_pred_l <= ed - st < max_pred_l in (st, ed) order; where a
    video has fewer than ``top_n_per_video`` spans of positive score
    there, the zero-score ones it fills in with are the band's, where the
    reference's (L, L) product takes any (st, ed) in index order."""
    device = next(model.parameters()).device
    external = load_external_vr_with_scores(external_vr_path, top_n_videos)
    idx2video = {v: k for k, v in corpus.video2idx.items()}
    dur = dict(zip(corpus.vid_names, corpus.durations))
    cands = [external.get(r["desc_id"], [])[:top_n_videos] for r in query_rows]
    vids = sorted({v for c in cands for v, _ in c})
    at = {v: i for i, v in enumerate(vids)}
    names = [idx2video[v] for v in vids]
    ctx = (encode_excl_contexts(model, excl_context_blocks(builder, names, [dur[n] for n in names],
                                                           device), len(vids))
           if vids else None)
    cfg = MEEExCLConfig(top_n_videos, q2c_alpha, min_pred_l, max_pred_l, top_n_per_video,
                        max_before_nms)
    by_count: Dict[int, List[int]] = {}
    for i, c in enumerate(cands):
        if c:
            by_count.setdefault(len(c), []).append(i)
    preds: List[list] = [[] for _ in query_rows]
    for n, members in by_count.items():
        bsz = max(1, EXTERNAL_VR_PAIRS // n)
        for j in range(0, len(members), bsz):
            part = members[j:j + bsz]
            qf, qm = (torch.from_numpy(a).to(device) for a in builder.build_queries(
                [query_rows[i]["desc_id"] for i in part]))
            vr_idx = torch.tensor([[at[v] for v, _ in cands[i]] for i in part], device=device)
            vr_scores = torch.tensor([[s for _, s in cands[i]] for i in part],
                                     dtype=torch.float32, device=device)
            out = excl_vcmr_batch(model, ctx, qf, qm, vr_idx, vr_scores, cfg)
            moments, scores = out["moments"].cpu().numpy(), out["moment_scores"].cpu().numpy()
            for r, i in enumerate(part):
                preds[i] = [[cands[i][v][0], float(s * clip_length),
                             float((e + 1) * clip_length), float(sc)]
                            for (v, s, e), sc in zip(moments[r], scores[r])]
    return {"VCMR": [{"desc_id": row["desc_id"], "desc": row.get("desc", ""), "predictions": p}
                     for row, p in zip(query_rows, preds)]}


def excl_context_blocks(builder: ExampleBuilder, vid_names: List[str], durations: List[float],
                        device, block_videos: int = 256):
    """``encode_excl_contexts``'s blocks: ExCL's per-clip contexts (with
    TEF) of ``vid_names``, ``block_videos`` videos at a time, on ``device``."""
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    for i in range(0, len(vid_names), block_videos):
        v, s, mask, _ = builder.build_contexts(vid_names[i:i + block_videos],
                                               durations[i:i + block_videos])
        yield dict(video_feat=on(v), sub_feat=on(s), mask=on(mask))


def mee_excl_corpus_blocks(excl_builder: ExampleBuilder, mee_builder: MEEExampleBuilder,
                           corpus: CorpusIndex, device, block_videos: int = 256):
    """``encode_mee_excl_corpus``'s blocks from the data layer's builders:
    ``excl_context_blocks`` over the corpus, with MEE's pooled video-level
    features of the same videos."""
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    blocks = excl_context_blocks(excl_builder, corpus.vid_names, corpus.durations, device,
                                 block_videos)
    for i, b in zip(range(0, len(corpus), block_videos), blocks):
        pooled = mee_builder.build_context_batch(corpus.vid_names[i:i + block_videos])
        yield dict(b, mee_video=on(pooled["video_feat"]), mee_sub=on(pooled["sub_feat"]))


def mee_excl_retrieve_vcmr(mee: MEE, excl: ExCL, cache: MEEExCLCache, builder: ExampleBuilder,
                           corpus: CorpusIndex, query_rows: List[dict], cfg: MEEExCLConfig,
                           query_bsz: int = 50, clip_length: float = 1.5) -> Dict[str, list]:
    """{"VR", "VCMR", and where every row names a corpus video "SVMR"}
    submission entries for ``query_rows``, ``query_bsz`` queries a call of
    ``score_mee_excl_batch`` over the cached ``corpus`` (in its order)."""
    device = cache.excl.mask.device
    meta = np.asarray([corpus.video2idx[v] for v in corpus.vid_names])
    pos = {v: i for i, v in enumerate(corpus.vid_names)}
    with_gt = all(r.get("vid_name") in pos for r in query_rows)
    res: Dict[str, list] = {"VR": [], "VCMR": []}
    if with_gt:
        res["SVMR"] = []
    for i in range(0, len(query_rows), query_bsz):
        rows = query_rows[i:i + query_bsz]
        qf, qm = builder.build_queries([r["desc_id"] for r in rows])
        gt = (torch.tensor([pos[r["vid_name"]] for r in rows], device=device)
              if with_gt else None)
        out = {k: v.cpu().numpy() for k, v in score_mee_excl_batch(
            mee, excl, cache, torch.from_numpy(qf).to(device), torch.from_numpy(qm).to(device),
            cfg, gt).items()}
        for qi, row in enumerate(rows):
            head = {"desc_id": row["desc_id"], "desc": row.get("desc", "")}
            vids = meta[out["vr_idx"][qi]]
            res["VR"].append({**head, "predictions": [
                [int(v), 0, 0, float(s)] for v, s in zip(vids, out["vr_scores"][qi])]})
            res["VCMR"].append({**head, "predictions": [
                [int(vids[r]), float(s * clip_length), float((e + 1) * clip_length), float(sc)]
                for (r, s, e), sc in zip(out["moments"][qi], out["moment_scores"][qi])]})
            if with_gt:
                g = int(meta[pos[row["vid_name"]]])
                res["SVMR"].append({**head, "predictions": [
                    [g, float(s * clip_length), float((e + 1) * clip_length), float(sc)]
                    for (s, e), sc in zip(out["svmr"][qi], out["svmr_scores"][qi])]})
    return res
