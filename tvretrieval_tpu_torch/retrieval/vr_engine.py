"""MEE video-retrieval (VR) corpus engine, PyTorch.

Port of tvretrieval_tpu/retrieval/vr_engine.py (reference
mixture_embedding_experts/inference.py:25-104): encode every video once
with the gated embedding units, pool + encode each query batch, score the
full corpus with the MoE-fused similarity, exact top-k videos
(``ops.span.topk_stable_blocked``: ``lax.top_k``'s order, value descending
then index ascending). Runs on the model's device, in eval mode (BatchNorm's
running statistics). No hand kernel lies on this path: the products are
``torch.matmul`` and the selection a stable sort.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from tvretrieval_tpu_torch.data.datasets import CorpusIndex
from tvretrieval_tpu_torch.data.retrieval_datasets import MEEExampleBuilder
from tvretrieval_tpu_torch.models.components import evaluating
from tvretrieval_tpu_torch.models.mee import MEE
from tvretrieval_tpu_torch.ops.span import topk_stable_blocked


@torch.no_grad()
def encode_vr_corpus(model: MEE, builder: MEEExampleBuilder, corpus: CorpusIndex,
                     ctx_bsz: int = 400):
    """(encoded video (Nv, Do) or None, encoded sub (Nv, Do) or None), on
    the model's device."""
    device = next(model.parameters()).device
    enc_v, enc_s = [], []
    n = len(corpus)
    bsz = min(ctx_bsz, n)
    with evaluating(model):
        for i in range(0, n, bsz):
            batch = builder.build_context_batch(corpus.vid_names[i:i + bsz])
            ev, es = model.encode_context(torch.from_numpy(batch["video_feat"]).to(device),
                                          torch.from_numpy(batch["sub_feat"]).to(device))
            if ev is not None:
                enc_v.append(ev)
            if es is not None:
                enc_s.append(es)
    return (torch.cat(enc_v) if enc_v else None, torch.cat(enc_s) if enc_s else None)


@torch.no_grad()
def score_vr_queries(model: MEE, query_feat: torch.Tensor, enc_video, enc_sub, topk: int):
    """(top scores (Nq, topk) f32, corpus positions (Nq, topk) int32)."""
    with evaluating(model):
        scores = model.scores(model.pool_query(query_feat), enc_video, enc_sub)
    return topk_stable_blocked(scores.float(), topk)


def mee_retrieve_vr(model: MEE, builder: MEEExampleBuilder, corpus: CorpusIndex,
                    query_rows: List[dict], ctx_bsz: int = 400, query_bsz: int = 100,
                    topk: int = 100, return_arrays: bool = False):
    """Returns {"VR": [...]} submission entries, or with
    ``return_arrays=True`` the row-aligned (Nq, topk) video-idx and score
    arrays for eval_retrieval_arrays (per-epoch eval skips dict building)."""
    device = next(model.parameters()).device
    topk = min(topk, len(corpus))
    enc_v, enc_s = encode_vr_corpus(model, builder, corpus, ctx_bsz)
    meta_video_idx = np.asarray([corpus.video2idx[v] for v in corpus.vid_names])

    all_scores, all_vid = [], []
    bsz = min(query_bsz, len(query_rows))
    for i in range(0, len(query_rows), bsz):
        qb = builder.build_query_batch(query_rows[i:i + bsz])
        scores, idx = score_vr_queries(model, torch.from_numpy(qb["query_feat"]).to(device),
                                       enc_v, enc_s, topk)
        all_scores.append(scores.cpu().numpy())
        all_vid.append(meta_video_idx[idx.cpu().numpy()])
    scores = np.concatenate(all_scores, axis=0)
    vid_idx = np.concatenate(all_vid, axis=0)
    if return_arrays:
        return {"VR": (vid_idx, scores)}
    return {"VR": [{
        "desc_id": row["desc_id"], "desc": row.get("desc", ""),
        "predictions": [[int(v), 0, 0, float(s)] for v, s in zip(vid_idx[qi], scores[qi])],
    } for qi, row in enumerate(query_rows)]}
