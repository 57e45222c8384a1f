"""CAL video corpus moment retrieval in plain PyTorch: every proposal of a
corpus scored against each query, the flat top moments and the
ground-truth video's ranking, at the configuration's stated precision or
one step below it (the control).

Published model: jayleicn/TVRetrieval, baselines/clip_alignment_with_language
(model.py, CALWithSub:136: the moment MLPs :146-150, the query LSTM and
linear, ``compute_cdist_inference`` :213-245; inference.py:
``compute_query_proposal_distance`` :134, ``generate_vcmr_predictions_from_res``
:377, ``generate_svmr_predictions_from_res`` :456; local_utils/proposal.py:
the sliding windows :64-113 and TVR's settings :116-156;
proposal_retrieval_dataset.py: a moment's clips and its [local; global]
rows, ``concat_feat_adv`` :311-345). Escorcia et al. (2019) and the TVR
paper (Lei et al., ECCV 2020) name the model and the pipeline.

Equations, in eval mode:

- Proposals: for each scale s, windows of ``length * s`` seconds every
  ``max(round(s * stride / round_base) * round_base, round_base) *
  length`` seconds from 0 (float32 starts), cut at the video's end, the
  unique rows in sorted order.
- A proposal's clips: [floor(st / c), ceil(ed / c)), the video's last two
  clips where the start lies past its clips, at most ``max_moment_clips``
  of them, the first clip where none is left.
- A clip's row [x / (|x| + 1e-5); g], g the mean of the video's clips
  normed the same way; each stream's moment embedding
  ``L2(W1 ReLU(W0 row + b0) + b1)`` (``x / (|x| + 1e-12)``).
- The query: an LSTM as flax's cell (gates x W_ih + h W_hh + b_hh, no
  input bias, order i, f, g, o) over the padded row, the carry at step
  (length - 1) % L, then ``L2(W h + b)``.
- A proposal's distance: the mean over its clips of |q - m_c|^2, averaged
  over the streams; a padded proposal slot 1e10. Scores are the negated
  distances. VCMR: the top ``max_before_nms`` over every (video,
  proposal); SVMR: the ground-truth video's proposals, best first.

Departures: the distances through the expansion ``|q|^2 - 2 q . mean_c(m_c)
+ mean_c(|m_c|^2)``, exact in real arithmetic; each clip's row is encoded
once, since a clip's row is the same in every proposal that holds it.
What the configuration states in float32 is computed in float64 here, in
blocks of videos and of proposals that fit on a card; TF32 is off. The
control (``precision="control"``) computes the moment MLPs in bfloat16 and
keeps the proposals' means in bfloat16 (the cache), the distances in
float32. Only values enter the compared numbers, so the top moments are
taken by ``torch.topk`` and put in ``lax.top_k``'s order (value, then
flat index) among themselves.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import numpy as np
import torch

STATED, CONTROL = "stated", "control"
PAD_DISTANCE = 1e10


def _l2n(x, eps: float):
    return x / (torch.linalg.norm(x, dim=-1, keepdim=True) + eps)


def sliding_windows(duration: float, length: float, scales, stride: float,
                    round_base: float) -> np.ndarray:
    """(n, 2) float32 [st, ed] seconds, unique rows, sorted."""
    rows = []
    for s in scales:
        step = max(round(s * stride / round_base) * round_base, round_base) * length
        st = np.arange(0.0, duration, step, dtype=np.float32)
        rows.append(np.stack([st, np.minimum(st + length * s, np.float32(duration))], 1))
    return np.unique(np.concatenate(rows).astype(np.float32), axis=0)


def clip_spans(props: np.ndarray, n_clips: int, clip_length: float,
               max_clips: int) -> Tuple[np.ndarray, np.ndarray]:
    """Each proposal's (first clip, clip count)."""
    first, count = [], []
    for st_s, ed_s in props:
        st, ed = math.floor(st_s / clip_length), math.ceil(ed_s / clip_length)
        if st >= n_clips:
            st = max(n_clips - 2, 0)
        ed = min(ed, n_clips, st + max_clips)
        if ed <= st:
            st, ed = 0, min(1, n_clips)
        first.append(st)
        count.append(ed - st)
    return np.asarray(first), np.asarray(count)


class Reference:
    """CAL over a corpus that ``draw(b)`` gives a block of ``block_videos``
    videos at a time: (video clips (n, L, Dv), subtitle clips (n, L, Ds),
    valid clips (n,) ints, durations (n,) seconds). ``weights``: the
    parameters by the names of the port's ``state_dict``."""

    def __init__(self, weights: Dict[str, torch.Tensor], draw: Callable[[int], tuple],
                 corpus: dict, proposals: dict, retrieval: dict,
                 precision: str = STATED, prop_block: int = 1 << 17):
        if precision not in (STATED, CONTROL):
            raise ValueError(precision)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.w, self.draw, self.pc, self.rc = weights, draw, proposals, retrieval
        self.nv, self.bv, self.c = corpus["n_videos"], corpus["block_videos"], corpus["clip_length"]
        self.precision = precision
        self.dt = torch.float64 if precision == STATED else torch.bfloat16
        self.prop_block = prop_block
        self._cache = None

    def _p(self, name, dt=None):
        return self.w[name].to(dt or self.dt)

    # ------------------------------------------------------------ corpus
    def _proposals(self, duration: float, n_clips: int):
        pc = self.pc
        props = sliding_windows(duration, pc["length"], pc["scales"], pc["stride"],
                                pc["round_base"])[:pc["per_video"]]
        return props, clip_spans(props, n_clips, self.c, pc["max_moment_clips"])

    def _embed(self, stream: str, clips, n_clips):
        """(n, L, Do) moment embeddings of every clip's row."""
        m = (torch.arange(clips.shape[1], device=clips.device)[None] < n_clips[:, None]).double()
        x = clips.double()
        g = _l2n((x * m[..., None]).sum(1) / m.sum(1, keepdim=True).clamp_min(1), 1e-5)
        rows = torch.cat([_l2n(x, 1e-5), g[:, None].expand_as(x)], dim=-1).to(self.dt)
        p = f"{stream}_moment_mlp"
        h = torch.relu(rows @ self._p(f"{p}.Dense_0.weight").T + self._p(f"{p}.Dense_0.bias"))
        return _l2n(h @ self._p(f"{p}.Dense_1.weight").T + self._p(f"{p}.Dense_1.bias"), 1e-12)

    def corpus(self):
        """(means {stream: (Nv, P, Do)}, mean squared norms {stream: (Nv,
        P)}, slot mask (Nv, P), spans (Nv, P, 2) float64 seconds), built
        once; the means in float64, or bfloat16 in the control."""
        if self._cache is not None:
            return self._cache
        P = self.pc["per_video"]
        means, sqs, masks, spans = {"video": [], "sub": []}, {"video": [], "sub": []}, [], []
        memo = {}
        for b in range(math.ceil(self.nv / self.bv)):
            video, sub, n_clips, durations = self.draw(b)
            n, L = video.shape[:2]
            dev = video.device
            rows = []
            for i in range(n):
                key = (float(durations[i]), int(n_clips[i]))
                if key not in memo:
                    props, (first, count) = self._proposals(*key)
                    avg = torch.zeros((P, L), dtype=torch.float64)
                    for j, (f, c) in enumerate(zip(first, count)):
                        avg[j, f:f + c] = 1.0 / max(c, 1)
                    span = torch.zeros((P, 2), dtype=torch.float64)
                    span[:len(props)] = torch.from_numpy(props.astype(np.float64))
                    memo[key] = (avg, (torch.arange(P) < len(props)).double(), span)
                rows.append(memo[key])
            avg, mask, span = (torch.stack(t) for t in zip(*rows))
            avg, nc = avg.to(dev), torch.as_tensor(n_clips, device=dev)
            for stream, clips in (("video", video), ("sub", sub)):
                emb = self._embed(stream, clips, nc).double()
                means[stream].append(torch.einsum("npl,nld->npd", avg, emb).to(self.dt))
                sqs[stream].append(torch.einsum("npl,nl->np", avg, (emb * emb).sum(-1)))
            masks.append(mask.to(dev))
            spans.append(span)
        self._cache = ({s: torch.cat(v) for s, v in means.items()},
                       {s: torch.cat(v) for s, v in sqs.items()}, torch.cat(masks),
                       torch.cat(spans))
        return self._cache

    # ------------------------------------------------------------ queries
    def query(self, q_feat, q_mask) -> torch.Tensor:
        """(B, Do) float64 query embeddings."""
        name = "query_lstm.fwd_cell"
        w_ih, w_hh = self._p(f"{name}.weight_ih_l0", torch.float64), self._p(
            f"{name}.weight_hh_l0", torch.float64)
        b = self._p(f"{name}.bias_hh_l0", torch.float64)
        x = q_feat.double()
        n, L, _ = x.shape
        H = w_hh.shape[1]
        xp = x @ w_ih.T
        h = x.new_zeros((n, H))
        c = torch.zeros_like(h)
        outs = []
        for t in range(L):
            i, f, g, o = (xp[:, t] + h @ w_hh.T + b).split(H, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            outs.append(h)
        last = (q_mask.sum(dim=1).long() - 1) % L
        h = torch.stack(outs, 1)[torch.arange(n, device=x.device), last]
        return _l2n(h @ self._p("query_linear.weight", torch.float64).T
                    + self._p("query_linear.bias", torch.float64), 1e-12)

    def _distances(self, q, sl: slice) -> torch.Tensor:
        """(B, n) distances of the queries to flat proposals ``sl``."""
        means, sqs, mask, _ = self.corpus()
        acc = torch.float64 if self.precision == STATED else torch.float32
        q = q.to(acc)
        q2 = (q * q).sum(-1, keepdim=True)
        d = 0
        for stream in ("video", "sub"):
            m = means[stream].flatten(0, 1)[sl].to(acc)
            d = d + q2 - 2 * q @ m.T + sqs[stream].flatten()[sl].to(acc)
        d = d.double() / 2
        return torch.where(mask.flatten()[sl] > 0, d, PAD_DISTANCE)

    def scores_of(self, q, video, prop) -> torch.Tensor:
        """(B, k) float64 scores of the (video, proposal) pairs given as
        (B, k) indices."""
        means, sqs, mask, _ = self.corpus()
        P = mask.shape[1]
        flat = (video.long() * P + prop.long())
        acc = torch.float64 if self.precision == STATED else torch.float32
        qa = q.to(acc)
        d = 0
        for stream in ("video", "sub"):
            m = means[stream].flatten(0, 1)[flat].to(acc)             # (B, k, Do)
            d = d + (qa * qa).sum(-1)[:, None] - 2 * torch.einsum("bd,bkd->bk", qa, m) \
                + sqs[stream].flatten()[flat].to(acc)
        d = d.double() / 2
        return -torch.where(mask.flatten()[flat] > 0, d, PAD_DISTANCE)

    def top(self, q, k: int):
        """The top ``k`` scores over every (video, proposal): (scores (B,
        k) float64, flat indices (B, k)), value descending, then index."""
        _, _, mask, _ = self.corpus()
        N = mask.numel()
        vals, idxs = [], []
        for p0 in range(0, N, self.prop_block):
            s = -self._distances(q, slice(p0, p0 + self.prop_block))
            v, i = torch.topk(s, min(k, s.shape[1]), dim=1)
            vals.append(v)
            idxs.append(i + p0)
        v, pos = torch.topk(torch.cat(vals, 1), k, dim=1)
        idx, by_index = torch.sort(torch.gather(torch.cat(idxs, 1), 1, pos), dim=1)
        v, order = torch.sort(torch.gather(v, 1, by_index), dim=1, descending=True, stable=True)
        return v, torch.gather(idx, 1, order)

    def gt_row(self, q, gt) -> torch.Tensor:
        """(B, P) float64 scores of each query's ground-truth video's
        proposals (padded slots -1e10)."""
        _, _, mask, _ = self.corpus()
        P = mask.shape[1]
        props = torch.arange(P, device=gt.device)[None].expand(len(gt), P)
        return self.scores_of(q, gt.long()[:, None].expand(-1, P), props)

    # ------------------------------------------------------------ the call
    def score_batch(self, q_feat, q_mask, gt) -> Dict[str, torch.Tensor]:
        """What the program's ``score_cal_batch`` returns for one batch,
        computed here."""
        _, _, mask, spans = self.corpus()
        P = mask.shape[1]
        q = self.query(q_feat, q_mask)
        k = min(self.rc["max_before_nms"], mask.numel())
        vals, flat = self.top(q, k)
        g = self.gt_row(q, gt)
        g_vals, order = torch.sort(g, dim=1, descending=True, stable=True)
        sp = spans.to(q.device).flatten(0, 1)
        return {"vcmr_video": (flat // P).int(), "vcmr_prop": (flat % P).int(),
                "vcmr_spans": sp[flat].float(), "vcmr_scores": vals.float(),
                "svmr_prop": order.int(), "svmr_spans": sp[gt.long()[:, None] * P + order].float(),
                "svmr_scores": g_vals.float()}
