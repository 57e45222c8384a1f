"""MEE + ExCL two-stage VCMR in plain PyTorch: MEE's video retrieval over
the whole corpus, then ExCL's spans over each query's top videos, at the
configuration's stated precision or one step below it (the control).

Published models: jayleicn/TVRetrieval, baselines/mixture_embedding_experts
(model.py, model_components.py: NetVLAD :61-103, the gated embedding unit
:7-35, the mixture weights and scores model.py:64-83; inference.py:25-104)
and baselines/excl (model.py:21-165; inference_with_vcmr.py:40-103: the
top-N videos of the VR result re-encoded with the query, start
probabilities times exp(q2c_alpha * vr_score), each video's top spans of
the (st, ed) product under the min / max length mask, all of them merged by
Python's stable sort). The TVR paper (Lei et al., ECCV 2020) names the
pipeline.

Equations, in eval mode (no dropout, BatchNorm on its running statistics):

- MEE. A query's tokens (padded ones included, as the port and the JAX
  package count them) are pooled by NetVLAD with 2 clusters: soft
  assignments softmax(BN(x C)), residuals sum_l a (x - C2), each cluster's
  residual L2-normed, the whole L2-normed. Each side goes through a gated
  embedding unit y = Wx + b, y * sigmoid(BN(W'y + b')), L2-normed: the
  query's once a stream, a video's from its clips' mean, L2-normed. The
  score is w0 <qv, ev> + w1 <qs, es> with (w0, w1) = W_moe q + b_moe.
- ExCL. LSTMs as flax's cells: gates x W_ih + h W_hh + b_hh (no input
  bias), in the order i, f, g, o; the backward direction runs over the
  valid prefix reversed; outputs past a row's length are zero; the final
  hidden is the carry at step (length - 1) % L. The query's final hidden
  q of a bidirectional LSTM; for each stream ctx1 = BiLSTM1([clips; TEF]),
  ctx2 = BiLSTM2([ctx1; q]), start / end logits W2 tanh(W1 [ctx2; ctx1; q]
  + b1) + b2, masked to -1e10 past the video, the two streams' mean, then a
  softmax over the clips.

Departures: none in the arithmetic. The reference re-encodes ctx1 for every
(query, video) pair, as the published script does; it works in blocks of
pairs so that it fits on a card, and draws the corpus a block of videos at
a time through ``draw``. What the configuration states in float32 is
computed in float64 here, so the reference's own rounding stays far below
the program's; TF32 is off. The control (``precision="control"``) computes
MEE's layers, the LSTMs and the heads in bfloat16 (the LSTM carries in
float32, as flax keeps them), the softmax in float32.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import numpy as np
import torch

STATED, CONTROL = "stated", "control"
NEG = -1e10
BN_EPS = 1e-5


def _l2n(x, dim: int = -1, eps: float = 1e-12):
    return x / (torch.linalg.norm(x, dim=dim, keepdim=True) + eps)


def _flip(x, lengths):
    """Each row's valid prefix reversed, then its padding reversed (flax's
    ``flip_sequences``); an involution."""
    L = x.shape[1]
    t = torch.arange(L, device=x.device)[None]
    idx = (L - 1 - t + lengths[:, None]) % L
    return torch.gather(x, 1, idx[:, :, None].expand_as(x))


def length_mask(L: int, min_l: int, max_l: int, device) -> torch.Tensor:
    """(L, L) {0, 1}: (st, ed) is a span iff min_l <= ed - st < max_l."""
    d = torch.arange(L, device=device)[None, :] - torch.arange(L, device=device)[:, None]
    return ((d >= min_l) & (d < max_l)).double()


def top_spans(st, ed, lmask, k: int, rows: int = 2048):
    """Each row's top k spans of the (st, ed) product under ``lmask``, by a
    stable descending sort over the flat (st, ed) index: (R, L) probs ->
    (scores, st, ed), each (R, k); ``rows`` rows at a time."""
    R, L = st.shape
    vals, idx = [], []
    for r0 in range(0, R, rows):
        joint = st[r0:r0 + rows, :, None] * ed[r0:r0 + rows, None, :] * lmask
        v, i = torch.sort(joint.reshape(-1, L * L), dim=1, descending=True, stable=True)
        vals.append(v[:, :k])
        idx.append(i[:, :k])
    vals, idx = torch.cat(vals), torch.cat(idx)
    return vals, idx // L, idx % L


def vcmr_top(st_w, ed, lmask, per_video: int, top_n: int):
    """inference_with_vcmr.py's selection for (Nq, V, L) weighted start and
    end probabilities: each video's top ``per_video`` spans, the list built
    video by video, its stable sort by score, the first ``top_n``. Returns
    (scores, video position, st, ed), each (Nq, top_n)."""
    nq, v, L = st_w.shape
    vals, s, e = top_spans(st_w.reshape(nq * v, L), ed.reshape(nq * v, L), lmask, per_video)
    k = vals.shape[1]
    merged, pos = torch.sort(vals.reshape(nq, v * k), dim=1, descending=True, stable=True)
    pos = pos[:, :top_n]
    take = lambda t: torch.gather(t.reshape(nq, v * k), 1, pos)
    return merged[:, :top_n], pos // k, take(s), take(e)


class Reference:
    """The pipeline over a corpus that ``draw(b)`` gives a block at a time:
    (video clips (n, L, Dv) f32, subtitle clips (n, L, Ds) f32, mask (n, L))
    of videos b * block_videos onwards. ``weights``: the parameters by the
    names of the port's ``state_dict`` (MEE's under ``mee.``, ExCL's under
    ``excl.``)."""

    def __init__(self, weights: Dict[str, torch.Tensor], draw: Callable[[int], tuple],
                 corpus: dict, retrieval: dict, precision: str = STATED,
                 pair_block: int = 512):
        if precision not in (STATED, CONTROL):
            raise ValueError(precision)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.precision = precision
        self.dt = torch.float64 if precision == STATED else torch.bfloat16
        self.carry = torch.float64 if precision == STATED else torch.float32
        self.w = weights
        self.draw = draw
        self.nv, self.bv = corpus["n_videos"], corpus["block_videos"]
        self.rc = retrieval
        self.pair_block = pair_block
        self._videos = None

    # ------------------------------------------------------------ layers
    def _p(self, name):
        return self.w[name].to(self.dt)

    def _dense(self, x, name):
        return x.to(self.dt) @ self._p(f"{name}.weight").T + self._p(f"{name}.bias")

    def _bn(self, x, name):
        w = {k: self.w[f"{name}.{k}"].double()
             for k in ("weight", "bias", "running_mean", "running_var")}
        y = (x.double() - w["running_mean"]) / torch.sqrt(w["running_var"] + BN_EPS)
        return (y * w["weight"] + w["bias"]).to(self.dt)

    def _geu(self, x, name):
        y = self._dense(x, f"{name}.Dense_0")
        g = self._bn(self._dense(y, f"{name}.ContextGating_0.Dense_0"),
                     f"{name}.ContextGating_0.bn")
        return _l2n(y * torch.sigmoid(g))

    def _netvlad(self, x):
        n, L, D = x.shape
        c, c2 = self._p("mee.query_pooling.clusters"), self._p("mee.query_pooling.clusters2")
        a = torch.softmax(self._bn(x.to(self.dt).reshape(n * L, D) @ c,
                                   "mee.query_pooling.bn"), dim=1).reshape(n, L, -1)
        resid = (torch.einsum("nlk,nld->ndk", a, x.to(self.dt))
                 - a.sum(dim=1)[:, None, :] * c2)
        return _l2n(_l2n(resid, dim=1).reshape(n, -1))

    def _lstm(self, x, lengths, name, reverse: bool):
        """One direction over (N, L, D): (outputs (N, L, H) in the row's
        order, final hidden (N, H))."""
        if reverse:
            x = _flip(x, lengths)
        w_ih, w_hh = self._p(f"{name}.weight_ih_l0"), self._p(f"{name}.weight_hh_l0")
        b = self._p(f"{name}.bias_hh_l0")
        xp = x.to(self.dt) @ w_ih.T
        n, L, _ = x.shape
        H = w_hh.shape[1]
        h = torch.zeros((n, H), dtype=self.carry, device=x.device)
        c = torch.zeros_like(h)
        outs = []
        for t in range(L):
            i, f, g, o = (xp[:, t] + h.to(self.dt) @ w_hh.T + b).split(H, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            outs.append(h)
        out = torch.stack(outs, dim=1)
        last = out[torch.arange(n, device=x.device), (lengths - 1) % L]
        return (_flip(out, lengths) if reverse else out), last

    def _bilstm(self, x, mask, name):
        lengths = mask.sum(dim=1).long()
        fo, fh = self._lstm(x, lengths, f"{name}.fwd_cell", False)
        bo, bh = self._lstm(x, lengths, f"{name}.bwd_cell", True)
        return (torch.cat([fo, bo], dim=-1) * mask[:, :, None].to(fo.dtype),
                torch.cat([fh, bh], dim=-1))

    # ------------------------------------------------------------ MEE
    def video_embeddings(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """MEE's (Nv, Do) video and subtitle embeddings of the corpus: each
        video's clips averaged and L2-normed as the published data layer
        does it (``x / (||x|| + 1e-5)``), through its gated unit."""
        if self._videos is None:
            ev, es = [], []
            for b in range(math.ceil(self.nv / self.bv)):
                video, sub, mask = self.draw(b)
                m = mask.double()[:, :, None]
                pool = lambda x: _l2n((x.double() * m).sum(dim=1) / m.sum(dim=1), eps=1e-5)
                ev.append(self._geu(pool(video), "mee.video_gu"))
                es.append(self._geu(pool(sub), "mee.sub_gu"))
            self._videos = torch.cat(ev), torch.cat(es)
        return self._videos

    def vr_scores(self, q_feat) -> torch.Tensor:
        """(Nq, Nv) float64 MEE scores of every video."""
        ev, es = self.video_embeddings()
        pooled = self._netvlad(q_feat)
        qv, qs = self._geu(pooled, "mee.video_query_gu"), self._geu(pooled, "mee.sub_query_gu")
        w = self._dense(pooled, "mee.moe_fc")
        return (w[:, 0:1] * (qv @ ev.T) + w[:, 1:2] * (qs @ es.T)).double()

    # ------------------------------------------------------------ ExCL
    def query_hidden(self, q_feat, q_mask):
        return self._bilstm(q_feat, q_mask, "excl.query_encoder")[1]

    def _pair_probs(self, q, video, sub, mask):
        """(st, ed) float64 probabilities (n, L) of n pairs: the query
        hiddens ``q`` (n, H) with their videos' raw clips."""
        n, L, _ = video.shape
        lengths = mask.sum(dim=1, keepdim=True)
        tef_st = torch.arange(L, device=video.device, dtype=torch.float64)[None] / lengths
        tef = torch.stack([tef_st, tef_st + 1.0 / lengths], dim=-1) * mask[:, :, None]
        q_rep = q[:, None, :].expand(n, L, q.shape[-1])
        logits = []
        for stream, clips in (("video", video), ("sub", sub)):
            ctx = torch.cat([clips.double(), tef], dim=-1)
            ctx1, _ = self._bilstm(ctx, mask, f"excl.{stream}_encoder")
            ctx2, _ = self._bilstm(torch.cat([ctx1, q_rep.to(ctx1.dtype)], dim=-1), mask,
                                   f"excl.{stream}_encoder2")
            feat3 = torch.cat([ctx2, ctx1, q_rep.to(ctx1.dtype)], dim=-1)
            for head in ("st", "ed"):
                name = f"excl.{stream}_{head}_predictor"
                x = self._dense(torch.tanh(self._dense(feat3, f"{name}.Dense_0")),
                                f"{name}.Dense_1")[..., 0].double()
                logits.append(x * mask + (1.0 - mask) * NEG)
        soft = lambda x: torch.softmax(x.to(self.carry), dim=-1).double()
        return soft((logits[0] + logits[2]) / 2), soft((logits[1] + logits[3]) / 2)

    def span_probs(self, q_feat, q_mask, videos) -> Tuple[torch.Tensor, torch.Tensor]:
        """(Nq, P, L) float64 start and end probabilities of each query with
        each of its P videos ``videos`` (Nq, P corpus positions), ctx1
        encoded anew for every pair; the corpus is drawn a block at a time
        and the pairs taken ``pair_block`` at a time."""
        nq, P = videos.shape
        q = self.query_hidden(q_feat, q_mask)
        flat = videos.reshape(-1).long()
        owner = torch.arange(nq * P, device=flat.device) // P
        st = ed = None
        pending = []

        def run(parts):
            nonlocal st, ed
            idx = torch.cat([p[0] for p in parts])
            s, e = self._pair_probs(q[owner[idx]], *(torch.cat([p[i] for p in parts])
                                                      for i in (1, 2, 3)))
            if st is None:
                st = s.new_empty((nq * P, s.shape[1]))
                ed = torch.empty_like(st)
            st[idx], ed[idx] = s, e

        for b in range(math.ceil(self.nv / self.bv)):
            here = ((flat >= b * self.bv) & (flat < (b + 1) * self.bv)).nonzero()[:, 0]
            if not len(here):
                continue
            video, sub, mask = self.draw(b)
            local = flat[here] - b * self.bv
            for p0 in range(0, len(here), self.pair_block):
                sl = slice(p0, p0 + self.pair_block)
                pending.append((here[sl], video[local[sl]], sub[local[sl]],
                                mask[local[sl]].double()))
                if sum(len(p[0]) for p in pending) >= self.pair_block:
                    run(pending)
                    pending = []
        if pending:
            run(pending)
        L = st.shape[1]
        return st.view(nq, P, L), ed.view(nq, P, L)

    # ------------------------------------------------------------ the step
    def score_batch(self, q_feat, q_mask, gt) -> Dict[str, np.ndarray]:
        """What the program's ``score_mee_excl_batch`` returns for one
        query batch, computed here: MEE's top N videos, ExCL over them and
        the GT video, the two-level span selection, the GT video's SVMR."""
        rc = self.rc
        scores = self.vr_scores(q_feat)
        V = min(rc["top_n_videos"], scores.shape[1])
        vr_scores, vr_idx = torch.sort(scores, dim=1, descending=True, stable=True)
        vr_scores, vr_idx = vr_scores[:, :V], vr_idx[:, :V]
        st, ed = self.span_probs(q_feat, q_mask, torch.cat([vr_idx, gt.long()[:, None]], 1))
        lmask = length_mask(st.shape[-1], rc["min_pred_l"], rc["max_pred_l"], st.device)
        top_n = rc["max_before_nms"]
        st_w = st[:, :V] * torch.exp(rc["q2c_alpha"] * vr_scores)[:, :, None]
        vals, vid, s, e = vcmr_top(st_w, ed[:, :V], lmask, rc["top_n_per_video"], top_n)
        g_vals, g_s, g_e = top_spans(st[:, V], ed[:, V], lmask, top_n)
        host = lambda t, dt: t.to(dt).cpu().numpy()
        return {"vr_idx": host(vr_idx, torch.int32), "vr_scores": host(vr_scores, torch.float32),
                "moments": host(torch.stack([vid, s, e], dim=-1), torch.int32),
                "moment_scores": host(vals, torch.float32),
                "svmr": host(torch.stack([g_s, g_e], dim=-1), torch.int32),
                "svmr_scores": host(g_vals, torch.float32)}
