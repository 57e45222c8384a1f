"""CAL/MCN proposal-based corpus retrieval engine, PyTorch.

Port of tvretrieval_tpu/retrieval/proposal_engine.py (reference
clip_alignment_with_language/inference.py:52-185 + 377-500), and CAL
served over the whole corpus resident on the device. A proposal's mean
squared-L2 distance decomposes as

    mean_c ||q - m_c||^2 = |q|^2 - 2 q . mean_c(m_c) + mean_c(|m_c|^2)

so per proposal only (mean_embedding, mean_sqnorm) is cached, a stream at
a time (the npz format of the JAX engine: a cache written by either
package loads in the other); the served cache keeps only its scoring rows.
Proposals are generated per video by the port's generator and padded to a
static P; padded slots score -1e10.

Scoring folds the streams into one row a proposal (``score_rows``): the
mean over the streams of the distances is ``|q|^2 - (2/n) q . E + O/n``
with E and O the streams' summed means and squared norms, so the negated
distance is one product of [q, 1, -|q|^2] with [(2/n) E, -O/n, 1]. A call
(``score_cal_batch``) stays on the device without a host sync: the query
encoder, then over the proposal axis in chunks of ``proposal_chunk`` the
product (span ``cal_dist``) and each chunk's top-k (span ``cal_topk``,
block maxima and the sorting kernel B6 through
``ops.span.topk_stable_blocked_psort_inplace``), the chunks' lists merged
by one more selection: since the chunks come in index order and each list
is in ``lax.top_k``'s order, a stable selection over their concatenation
is ``lax.top_k``'s over the whole row, ties to the lower flat index. The
ground-truth video's row is ranked by a stable sort (span ``cal_svmr``).

``encode_cal_corpus`` builds the cache on the device from the clip
features a block of videos at a time: each proposal's clip range as
``CALExampleBuilder`` aligns it, each clip encoded once
(``CALWithSub.encode_clip_parts`` / ``encode_proposal_means``).
``encode_proposal_corpus`` is the JAX engine's host-built path (every
proposal's features assembled by ``CALExampleBuilder``), which also serves
MCN and TEF rows. ``cal_retrieve`` scores through the same stages; its SVMR
ranking stays the JAX engine's host-side ``np.argsort``, so its order of
ties is the same.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from tvretrieval_tpu_torch.data.datasets import CorpusIndex
from tvretrieval_tpu_torch.data.proposals import PROPOSAL_CONFIGS, get_proposal_interface
from tvretrieval_tpu_torch.data.retrieval_datasets import CALExampleBuilder
from tvretrieval_tpu_torch.models.cal import CALWithSub, sum_last
from tvretrieval_tpu_torch.models.components import evaluating
from tvretrieval_tpu_torch.ops.span import topk_stable_blocked_psort_inplace
from tvretrieval_tpu_torch.utils import trace

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
    # the scoring stages' layout (``prepare_scoring``): one row a proposal,
    # padded to a multiple of ROW_ALIGN rows that score -inf, and the spans
    score_rows: Optional[torch.Tensor] = None    # (ceil8(Nv * P), Do + 2 padded to 4)
    span_table: Optional[torch.Tensor] = None    # (Nv * P, 2) seconds, on the device


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
    engine's npz layout. A cache built by ``encode_cal_corpus`` keeps no
    means and is refused."""
    if all(getattr(cache, key) is None for key in CACHE_KEYS):
        raise ValueError("save_proposal_cache: the cache holds no per-stream means (a served "
                         "cache from encode_cal_corpus); save one from encode_proposal_corpus")
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


@dataclass(frozen=True)
class CALServeConfig:
    """The served path's settings: the dataset's proposal scheme and clip
    length (``data.proposals.PROPOSAL_CONFIGS``), the cap on a proposal's
    clips (``CALBuilderConfig.max_moment_clips``), the proposal slots a
    video (None: the most any video has), the proposals scored at a time
    and the moments kept."""
    dset_name: str = "tvr"
    max_moment_clips: int = 24
    n_proposals: Optional[int] = None
    proposal_chunk: int = 1 << 20
    max_before_nms: int = 200

    @property
    def clip_length(self) -> float:
        return PROPOSAL_CONFIGS[self.dset_name]["clip_length"]


ROW_ALIGN = 8          # the chunks' length and the rows' count: whole blocks of B6's pruning
PAD_DISTANCE = 1e10


def corpus_proposals(durations: Sequence[float], dset_name: str,
                     n_proposals: Optional[int] = None):
    """(spans (Nv, P, 2) float32 seconds, mask (Nv, P) float32): each
    video's proposals by the port's generator (once a distinct duration),
    padded or cut to P slots."""
    proposer = get_proposal_interface(dset_name)
    memo: Dict[float, np.ndarray] = {}
    for d in map(float, durations):
        if d not in memo:
            memo[d] = proposer(d)
    props = [memo[float(d)] for d in durations]
    P = n_proposals or max(len(p) for p in props)
    spans = np.zeros((len(props), P, 2), np.float32)
    mask = np.zeros((len(props), P), np.float32)
    for j, p in enumerate(props):
        n = min(len(p), P)
        spans[j, :n] = p[:n]
        mask[j, :n] = 1.0
    return spans, mask


def clip_ranges(spans: torch.Tensor, n_clips: torch.Tensor, clip_length: float,
                max_moment_clips: int):
    """Each proposal's clips as ``CALExampleBuilder._moment_clip_feats``
    takes them, on the spans' device: spans (n, P, 2) float32 seconds,
    n_clips (n,) -> (first clip, clip count), each (n, P) int64. The
    clips [floor(st / c), ceil(ed / c)) in float32 arithmetic (numpy's for
    a float32 span over a Python float), the last two clips where the
    start lies past the video's clips, at most ``max_moment_clips``, and
    the first clip where nothing is left."""
    st = torch.floor(spans[..., 0] / clip_length).long()
    ed = torch.ceil(spans[..., 1] / clip_length).long()
    n = n_clips.long()[:, None]
    st = torch.where(st >= n, (n - 2).clamp_min(0), st)
    ed = torch.minimum(torch.minimum(ed, n), st + max_moment_clips)
    empty = ed <= st
    return torch.where(empty, 0, st), torch.where(empty, n.clamp_max(1), ed - st)


@torch.no_grad()
def encode_cal_corpus(model: CALWithSub, clip_feats: Iterable[Dict[str, torch.Tensor]],
                      n_clips, cfg: CALServeConfig,
                      durations: Optional[Sequence[float]] = None) -> ProposalCorpusCache:
    """The resident cache of a CAL corpus, built on the model's device.

    ``clip_feats``: the corpus's raw clip features in order, a block of
    videos at a time, each block {stream: (n, L, D)} for the model's
    streams (float32 models only); ``n_clips`` (Nv,): each video's valid
    clips; ``durations`` (Nv,) seconds, by default ``n_clips *
    clip_length``. Per block: the proposals' clip ranges, each clip encoded
    once, the proposals' means folded into their scoring rows
    (``prepare_scoring``); no proposal's features are built on the host,
    and only the scoring rows stay: the cache holds no per-stream means
    (``save_proposal_cache`` refuses it). Peak: the rows and one block."""
    device = next(model.parameters()).device
    n_clips = np.asarray(n_clips, np.int64)
    nv = len(n_clips)
    if durations is None:
        durations = n_clips * cfg.clip_length
    spans_np, pmask_np = corpus_proposals(durations, cfg.dset_name, cfg.n_proposals)
    P = spans_np.shape[1]
    spans = torch.from_numpy(spans_np).to(device)
    pmask = torch.from_numpy(pmask_np).to(device)
    n_dev = torch.from_numpy(n_clips).to(device)
    rows = _empty_rows(nv * P, model.cfg.output_size, device)
    v0 = 0
    with evaluating(model):
        for block in clip_feats:
            n, L = next(iter(block.values())).shape[:2]
            vids = slice(v0, v0 + n)
            cmask = (torch.arange(L, device=device)[None] < n_dev[vids, None]).float()
            parts = model.encode_clip_parts(block, cmask)
            st, cnt = clip_ranges(spans[vids], n_dev[vids], cfg.clip_length,
                                  cfg.max_moment_clips)
            ar = torch.arange(min(cfg.max_moment_clips, L), device=device)
            index = (st[..., None] + ar).clamp_max(L - 1)
            valid = (ar < cnt[..., None]) & (pmask[vids, :, None] > 0)
            means = model.encode_proposal_means(parts, index, valid).values()
            _fold(rows[v0 * P:(v0 + n) * P], [(e.reshape(n * P, -1), q.reshape(-1))
                                              for e, q in means],
                  pmask[vids].reshape(-1) > 0, model.cfg.n_streams)
            del parts, means
            v0 += n
    if v0 != nv:
        raise ValueError(f"encode_cal_corpus: the blocks hold {v0} videos, n_clips {nv}")
    return ProposalCorpusCache(
        prop_mask=pmask, prop_spans=spans_np, n_videos=nv, score_rows=rows,
        span_table=spans.reshape(nv * P, 2), **{k: None for k in CACHE_KEYS})


def _empty_rows(N: int, Do: int, device) -> torch.Tensor:
    """The scoring rows of N proposals, zero, and the alignment rows past N
    [0, -inf, 0] (``prepare_scoring``)."""
    rows = torch.zeros((-(-N // ROW_ALIGN) * ROW_ALIGN, -(-(Do + 2) // 4) * 4),
                       dtype=torch.float32, device=device)
    rows[N:, Do] = -float("inf")
    return rows


def _fold(rows: torch.Tensor, means, valid: torch.Tensor, n_streams: int) -> None:
    """Writes the scoring rows of m proposals into ``rows`` (m, K) from
    ``means``, each used stream's (mean_emb (m, Do), mean_sq (m,)), and
    ``valid`` (m,) (``prepare_scoring``)."""
    emb = sum(e.float() for e, _ in means)
    sq = sum(q.float() for _, q in means)
    Do = emb.shape[1]
    rows[:, :Do] = torch.where(valid[:, None], emb * (2.0 / n_streams), 0.0)
    rows[:, Do] = torch.where(valid, sq / -n_streams, -PAD_DISTANCE)
    rows[:, Do + 1] = 1.0


def prepare_scoring(cache: ProposalCorpusCache, model: CALWithSub) -> ProposalCorpusCache:
    """Sets the cache's ``score_rows`` and ``span_table`` once (module
    docstring): row j is [(2/n) E_j, -O_j / n, 1] for a real proposal,
    [0, -1e10, 1] for a padded slot (its score is then exactly -1e10), and
    the rows past Nv * P, up to a multiple of ROW_ALIGN, [0, -inf, 0]; the
    width is padded with zeros to a multiple of 4 floats. Returns the
    cache."""
    if cache.score_rows is not None:
        return cache
    c = model.cfg
    used = [s for s, on in (("video", c.uses_video_mlp), ("sub", c.use_sub)) if on]
    nv, P, Do = getattr(cache, f"mean_emb_{used[0]}").shape
    N = nv * P
    rows = _empty_rows(N, Do, cache.prop_mask.device)
    _fold(rows[:N], [(getattr(cache, f"mean_emb_{s}").reshape(N, Do),
                      getattr(cache, f"mean_sq_{s}").reshape(N)) for s in used],
          cache.prop_mask.reshape(N) > 0, c.n_streams)
    cache.score_rows = rows
    cache.span_table = torch.from_numpy(cache.prop_spans.reshape(N, 2)).to(rows.device)
    return cache


def _query_rows(model: CALWithSub, q_feat, q_mask, width: int) -> torch.Tensor:
    """(B, width) rows [q, 1, -|q|^2, 0...] of the queries' embeddings."""
    with evaluating(model):
        q = model.encode_query(q_feat, q_mask).float()
    B, Do = q.shape
    one = q.new_ones((B, 1))
    return torch.cat([q, one, -sum_last(q * q)[:, None], q.new_zeros((B, width - Do - 2))], 1)


def _top_moments(a: torch.Tensor, rows: torch.Tensor, n: int, k: int, chunk: int):
    """The top ``k`` of the scores ``a @ rows[:n].T`` in ``lax.top_k``'s
    order, chunked over the rows: (scores (B, k) f32, flat indices (B, k)
    int32)."""
    chunk = -(-chunk // ROW_ALIGN) * ROW_ALIGN
    vals, idxs = [], []
    for c0 in range(0, n, chunk):
        part = rows[c0:c0 + chunk]
        with trace.span("cal_dist"):
            s = a @ part.T
        with trace.span("cal_topk"):
            v, i = topk_stable_blocked_psort_inplace(s, min(k, part.shape[0]))
            vals.append(v)
            idxs.append(i + c0)
        del s
    if len(vals) == 1:
        return vals[0], idxs[0]
    with trace.span("cal_topk"):
        v, pos = topk_stable_blocked_psort_inplace(torch.cat(vals, 1), k)
        return v, torch.gather(torch.cat(idxs, 1), 1, pos.long())


def _gt_scores(a: torch.Tensor, rows: torch.Tensor, nv: int, P: int, gt) -> torch.Tensor:
    """(B, P) scores of each query's ground-truth video's proposals."""
    own = rows[:nv * P].view(nv, P, -1)[gt.long()]
    return torch.bmm(own, a[:, :, None])[..., 0]


@torch.no_grad()
def score_cal_batch(model: CALWithSub, cache: ProposalCorpusCache, q_feat, q_mask, gt_video,
                    cfg: CALServeConfig) -> Dict[str, torch.Tensor]:
    """One call of CAL's served path over the resident ``cache``, on the
    device and without a host sync (module docstring). q_feat (B, Lq, D),
    q_mask (B, Lq), gt_video (B,) corpus positions. Returns ``vcmr_video``,
    ``vcmr_prop`` (B, K) int32, ``vcmr_spans`` (B, K, 2) seconds,
    ``vcmr_scores`` (B, K), K = min(max_before_nms, Nv * P); ``svmr_prop``
    (B, P) int32, ``svmr_spans`` (B, P, 2), ``svmr_scores`` (B, P): the
    ground-truth video's proposals ranked. Scores are negated distances."""
    prepare_scoring(cache, model)
    rows, spans = cache.score_rows, cache.span_table
    nv, P = cache.prop_mask.shape
    n = nv * P
    with trace.span("score_query_batch", q_feat.device) as root:
        with trace.span("cal_query"):
            a = _query_rows(model, q_feat, q_mask, rows.shape[1])
        vals, idx = _top_moments(a, rows, n, min(cfg.max_before_nms, n), cfg.proposal_chunk)
        with trace.span("cal_svmr"):
            flat = idx.long()
            g = gt_video.long()
            g_vals, order = torch.sort(_gt_scores(a, rows, nv, P, g), dim=1, descending=True,
                                       stable=True)
            out = {"vcmr_video": (flat // P).int(), "vcmr_prop": (flat % P).int(),
                   "vcmr_spans": spans[flat], "vcmr_scores": vals,
                   "svmr_prop": order.int(),
                   "svmr_spans": spans[g[:, None] * P + order], "svmr_scores": g_vals}
        if root is not None:
            root.count(proposals=a.shape[0] * n, cache_bytes=rows.nbytes,
                       out_bytes=sum(t.nbytes for t in out.values()))
    return out


@torch.no_grad()
def cal_retrieve(model: CALWithSub, builder: CALExampleBuilder, cache: ProposalCorpusCache,
                 corpus: CorpusIndex, query_rows: List[dict],
                 tasks: Sequence[str] = ("VCMR", "SVMR"), query_bsz: int = 100,
                 max_before_nms: int = 200, return_arrays: bool = False):
    """VCMR: flat top-k smallest distance over (video, proposal); SVMR:
    rank the proposals of the GT video (reference :377-500). Scores are
    negative distances (larger = better), as in the reference. Scored by
    ``score_cal_batch``'s stages; the SVMR rows are ranked on the host.

    return_arrays: row-aligned numpy arrays {(vid, spans, scores)} for
    eval_retrieval_arrays (the per-epoch eval skips dict building)."""
    device = next(model.parameters()).device
    prepare_scoring(cache, model)
    nv, P = cache.prop_mask.shape
    meta_video_idx = np.asarray([corpus.video2idx[v] for v in corpus.vid_names])
    vid2meta = {v: i for i, v in enumerate(corpus.vid_names)}

    top_scores, top_idxs, svmr_chunks = [], [], []
    bsz = min(query_bsz, len(query_rows))
    topk = min(max_before_nms, nv * P)
    do_svmr = "SVMR" in tasks
    for i in range(0, len(query_rows), bsz):
        rows = query_rows[i:i + bsz]
        qb = builder.build_query_batch(rows)
        a = _query_rows(model, torch.from_numpy(qb["query_feat"]).to(device),
                        torch.from_numpy(qb["query_mask"]).to(device),
                        cache.score_rows.shape[1])
        vals, idx = _top_moments(a, cache.score_rows, nv * P, topk,
                                 CALServeConfig.proposal_chunk)
        top_scores.append(vals.cpu().numpy())
        top_idxs.append(idx.cpu().numpy())
        if do_svmr:
            gt = torch.as_tensor([vid2meta.get(r.get("vid_name"), 0) for r in rows],
                                 device=device)
            svmr_chunks.append(-_gt_scores(a, cache.score_rows, nv, P, gt).cpu().numpy())

    top_idx = np.concatenate(top_idxs, axis=0)
    v_meta, p_idx = top_idx // P, top_idx % P
    vcmr_vid = meta_video_idx[v_meta]                                     # (Nq, K)
    vcmr_spans = cache.prop_spans[v_meta, p_idx]                          # (Nq, K, 2)
    vcmr_scores = np.concatenate(top_scores, axis=0)

    if do_svmr:
        sd = np.concatenate(svmr_chunks, axis=0)                          # (Nq, P) distances
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
