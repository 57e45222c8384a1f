"""CAL/MCN proposal-based corpus retrieval engine, PyTorch.

Port of tvretrieval_tpu/retrieval/proposal_engine.py (reference
clip_alignment_with_language/inference.py:52-185 + 377-500). A proposal's
mean squared-L2 distance decomposes as

    mean_c ||q - m_c||^2 = |q|^2 - 2 q . mean_c(m_c) + mean_c(|m_c|^2)

so per proposal only (mean_embedding, mean_sqnorm) is cached: the corpus
is a (N_videos * max_props, D_o) matrix and query scoring is one product
(``torch.matmul``) plus rank-1 terms. Proposals are generated on the host
per video and padded to a static max_props; padded slots get +1e10
distance. The top-k is ``ops.span.topk_stable_blocked`` (``lax.top_k``'s
order); no hand kernel lies on this path.

SVMR: the JAX engine copies each batch's whole (Nq, Nv * P) distance
matrix to the host and picks each query's ground-truth row there; here
each query's row of P distances is gathered on the device and only those
rows are copied (the same numbers). The ranking stays the host-side
``np.argsort`` of the JAX engine, so its order of ties is the same.

The cache's npz format is the JAX engine's: a cache written by either
package loads in the other.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from tvretrieval_tpu_torch.data.datasets import CorpusIndex
from tvretrieval_tpu_torch.data.proposals import get_proposal_interface
from tvretrieval_tpu_torch.data.retrieval_datasets import CALExampleBuilder
from tvretrieval_tpu_torch.models.cal import CALWithSub, sum_last
from tvretrieval_tpu_torch.models.components import evaluating
from tvretrieval_tpu_torch.ops.span import topk_stable_blocked

CACHE_KEYS = ("mean_emb_video", "mean_sq_video", "mean_emb_sub", "mean_sq_sub")


@dataclass
class ProposalCorpusCache:
    mean_emb_video: Optional[torch.Tensor]   # (Nv, P, Do)
    mean_sq_video: Optional[torch.Tensor]    # (Nv, P)
    mean_emb_sub: Optional[torch.Tensor]
    mean_sq_sub: Optional[torch.Tensor]
    prop_mask: torch.Tensor                  # (Nv, P)
    prop_spans: np.ndarray                   # (Nv, P, 2) seconds, host-side
    n_videos: int


@torch.no_grad()
def encode_proposal_batch(model: CALWithSub, vfeat, sfeat, cmask):
    """vfeat / sfeat: (B, P, C, D); cmask: (B, P, C) -> per stream
    (mean_emb (B, P, Do), mean_sq (B, P)), None for an unused stream."""
    c = model.cfg
    denom = torch.clamp_min(cmask.sum(dim=-1), 1.0)                     # (B, P)

    def one(feat, stream):
        emb = model.encode_moments(feat, stream)
        mean_emb = (emb * cmask[..., None]).sum(dim=-2) / denom[..., None]
        mean_sq = (sum_last(emb ** 2) * cmask).sum(dim=-1) / denom
        return mean_emb, mean_sq

    with evaluating(model):
        ev = one(vfeat, "video") if c.uses_video_mlp else (None, None)
        es = one(sfeat, "sub") if c.use_sub else (None, None)
    return ev[0], ev[1], es[0], es[1]


@torch.no_grad()
def score_proposals(model: CALWithSub, query_feat, query_mask, cache: ProposalCorpusCache,
                    topk: int):
    """Top-k smallest distances over all (video, proposal) pairs: (top
    distances (Nq, topk), flat indices int32 (Nq, topk), all distances
    (Nq, Nv * P)), on the model's device."""
    c = model.cfg
    with evaluating(model):
        q = model.encode_query(query_feat, query_mask)                  # (Nq, Do)
    qsq = sum_last(q ** 2)[:, None]
    qf = q.float()

    def dist(mean_emb, mean_sq):
        d = qf @ mean_emb.reshape(-1, mean_emb.shape[-1]).T             # (Nq, Nv * P)
        return d.mul_(-2).add_(qsq).add_(mean_sq.reshape(1, -1))

    d = None
    for mean_emb, mean_sq, used in ((cache.mean_emb_video, cache.mean_sq_video,
                                     c.uses_video_mlp),
                                    (cache.mean_emb_sub, cache.mean_sq_sub, c.use_sub)):
        if used:
            d = dist(mean_emb, mean_sq) if d is None else d.add_(dist(mean_emb, mean_sq))
    d.div_(c.n_streams)
    d.add_((1.0 - cache.prop_mask.reshape(1, -1)) * 1e10)              # mask pads
    neg_top, idx = topk_stable_blocked(-d, topk)
    return -neg_top, idx, d


def encode_proposal_corpus(model: CALWithSub, builder: CALExampleBuilder,
                           corpus: CorpusIndex, dset_name: str = "tvr",
                           max_props: Optional[int] = None,
                           ctx_bsz: int = 32) -> ProposalCorpusCache:
    """Build every video's proposals and their moment features on the host,
    encode them on the model's device, ``ctx_bsz`` videos at a time."""
    device = next(model.parameters()).device
    proposer = get_proposal_interface(dset_name)
    all_props = [proposer(d) for d in corpus.durations]
    P = max_props or max(len(p) for p in all_props)

    n = len(corpus)
    spans = np.zeros((n, P, 2), np.float32)
    parts = {k: [] for k in CACHE_KEYS + ("prop_mask",)}
    on = lambda xs: torch.from_numpy(np.stack(xs)).to(device)
    for i in range(0, n, ctx_bsz):
        vf, sf, cm, pm = [], [], [], []
        for j in range(i, min(i + ctx_bsz, n)):
            props = all_props[j][:P]
            spans[j, : len(props)] = props
            v, s, c, p = builder.build_proposal_batch(
                corpus.vid_names[j], corpus.durations[j], props, P)
            vf.append(v); sf.append(s); cm.append(c); pm.append(p)
        for key, val in zip(CACHE_KEYS, encode_proposal_batch(model, on(vf), on(sf), on(cm))):
            if val is not None:
                parts[key].append(val)
        parts["prop_mask"].append(on(pm))

    cat = {k: torch.cat(v) if v else None for k, v in parts.items()}
    return ProposalCorpusCache(prop_spans=spans, n_videos=n, **cat)


def save_proposal_cache(cache: ProposalCorpusCache, path: str) -> None:
    """Persist the encoded proposal corpus (reference --use_intermediate
    caching, clip_alignment_with_language/inference.py:534-545), in the JAX
    engine's npz layout."""
    arrays = {"prop_mask": cache.prop_mask.cpu().numpy(), "prop_spans": cache.prop_spans,
              "n_videos": np.asarray(cache.n_videos)}
    for key in CACHE_KEYS:
        val = getattr(cache, key)
        if val is not None:
            arrays[key] = val.cpu().numpy()
    np.savez_compressed(path, **arrays)


def load_proposal_cache(path: str, device="cuda") -> ProposalCorpusCache:
    """A cache written by ``save_proposal_cache`` of either package, its
    tensors on ``device``."""
    z = np.load(path, allow_pickle=False)
    on = lambda k: torch.from_numpy(z[k]).to(device) if k in z.files else None
    return ProposalCorpusCache(prop_mask=on("prop_mask"), prop_spans=z["prop_spans"],
                               n_videos=int(z["n_videos"]), **{k: on(k) for k in CACHE_KEYS})


def cal_retrieve(model: CALWithSub, builder: CALExampleBuilder, cache: ProposalCorpusCache,
                 corpus: CorpusIndex, query_rows: List[dict],
                 tasks: Sequence[str] = ("VCMR", "SVMR"), query_bsz: int = 100,
                 max_before_nms: int = 200, return_arrays: bool = False):
    """VCMR: flat top-k smallest distance over (video, proposal); SVMR:
    rank the proposals of the GT video (reference :377-500). Scores are
    negative distances (larger = better), as in the reference.

    return_arrays: row-aligned numpy arrays {(vid, spans, scores)} for
    eval_retrieval_arrays (the per-epoch eval skips dict building)."""
    device = next(model.parameters()).device
    P = cache.prop_spans.shape[1]
    meta_video_idx = np.asarray([corpus.video2idx[v] for v in corpus.vid_names])
    vid2meta = {v: i for i, v in enumerate(corpus.vid_names)}

    top_ds, top_idxs, svmr_chunks = [], [], []
    bsz = min(query_bsz, len(query_rows))
    topk = min(max_before_nms, cache.n_videos * P)
    do_svmr = "SVMR" in tasks
    for i in range(0, len(query_rows), bsz):
        rows = query_rows[i:i + bsz]
        qb = builder.build_query_batch(rows)
        top_d, top_idx, full_d = score_proposals(
            model, torch.from_numpy(qb["query_feat"]).to(device),
            torch.from_numpy(qb["query_mask"]).to(device), cache, topk)
        top_ds.append(top_d.cpu().numpy())
        top_idxs.append(top_idx.cpu().numpy())
        if do_svmr:
            gt = torch.as_tensor([vid2meta.get(r.get("vid_name"), 0) for r in rows],
                                 device=device)
            rows_d = full_d.view(len(rows), cache.n_videos, P)[
                torch.arange(len(rows), device=device), gt]
            svmr_chunks.append(rows_d.cpu().numpy())                     # (B, P)
        del full_d

    top_d = np.concatenate(top_ds, axis=0)
    top_idx = np.concatenate(top_idxs, axis=0)
    v_meta, p_idx = top_idx // P, top_idx % P
    vcmr_vid = meta_video_idx[v_meta]                                     # (Nq, K)
    vcmr_spans = cache.prop_spans[v_meta, p_idx]                          # (Nq, K, 2)
    vcmr_scores = -top_d

    if do_svmr:
        sd = np.concatenate(svmr_chunks, axis=0)                          # (Nq, P)
        k2 = min(max_before_nms, P)
        order = np.argsort(sd, axis=1)[:, :k2]
        gt_meta = np.asarray([vid2meta.get(r.get("vid_name"), 0) for r in query_rows])
        svmr_vid = np.broadcast_to(meta_video_idx[gt_meta][:, None], order.shape)
        svmr_spans = cache.prop_spans[gt_meta[:, None], order]
        svmr_scores = -np.take_along_axis(sd, order, axis=1)

    if return_arrays:
        out = {}
        if "VCMR" in tasks:
            out["VCMR"] = (vcmr_vid, vcmr_spans, vcmr_scores)
        if do_svmr:
            out["SVMR"] = (svmr_vid, svmr_spans, svmr_scores)
        return out

    vcmr_res, svmr_res = [], []
    for qi, row in enumerate(query_rows):
        head = dict(desc_id=row["desc_id"], desc=row.get("desc", ""))
        if "VCMR" in tasks:
            vcmr_res.append({**head, "predictions": [
                [int(v), float(s0), float(s1), float(sc)] for v, (s0, s1), sc
                in zip(vcmr_vid[qi], vcmr_spans[qi], vcmr_scores[qi])]})
        if do_svmr and row.get("vid_name") in vid2meta:
            svmr_res.append({**head, "predictions": [
                [int(v), float(s0), float(s1), float(sc)] for v, (s0, s1), sc
                in zip(svmr_vid[qi], svmr_spans[qi], svmr_scores[qi])]})
    out = {}
    if vcmr_res:
        out["VCMR"] = vcmr_res
    if svmr_res:
        out["SVMR"] = svmr_res
    return out
