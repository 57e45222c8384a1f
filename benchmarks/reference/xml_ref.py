"""The XML retrieval step in plain PyTorch: query encoder, video scores,
span head and exact selections, at the configuration's stated precision or
one step below it (the control).

What the configuration states (its ``semantics``) is followed exactly where
it rounds: feat1 and the normalized queries as int8 at scale 127 (the video
score is the integer max-over-clips dot of each stream, summed and scaled
by f32(0.5 / 127^2)), feat2 as bf16 (shipped) or as int8 rows with
per-row scales max/127 computed in f32 (int8 exact), the span similarity
rounded once to bf16. Everything else, which the configuration states in
float32 (encoder, query linears, ConvSE, softmax, span products), is
computed in float64 here: the reference's own rounding then stays far
below the program's.

The control (``precision="control"``) computes the same step one precision
below each stated one: the encoder, the query linears, the ConvSE and the
softmax in bf16; feat1 and the queries as int4 with a scale per row
(max/7); bf16 feat2 and the bf16 similarity as fp8 (e4m3), int8 feat2 rows
as int4 rows. Its selections stay exact.

Published model: jayleicn/TVRetrieval, baselines/crossmodal_moment_localization
(model_xml.py: the query encoder :377-423, get_video_level_scores :436-453,
the merged ConvSE span head :455-502; inference.py: exp(alpha * q2c), the
top-V videos, the banded (st, ed) top-N :170-192, 308-386).
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

STATED, CONTROL = "stated", "control"
I8_SCALE = float(np.float32(0.5 / (127.0 * 127.0)))
INV_127 = float(np.float32(1.0 / 127.0))
NEG = -1e10
LN_EPS = 1e-5
F8 = torch.float8_e4m3fn


def _ln(x, w, b):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + LN_EPS) * w + b


def _l2n(x):
    return x / (torch.linalg.norm(x, dim=-1, keepdim=True) + 1e-12)


def quantize_unit_i8(x):
    """int8 of unit rows at scale 127 (round half to even), as float."""
    return torch.clamp(torch.round(x * 127.0), -127, 127)


def quantize_rows_i8_f32(x32):
    """int8 rows with a per-row scale max|row| * f32(1/127) (at least
    1e-12), in float32 arithmetic: (q as float32, scale (..., 1) f32)."""
    s = torch.clamp_min(x32.abs().amax(-1, keepdim=True) * INV_127, 1e-12)
    return torch.clamp(torch.round(x32 / s), -127, 127), s


def quantize_rows_int4(x):
    """The control's int4 rows: a per-row scale max|row| / 7."""
    s = torch.clamp_min(x.abs().amax(-1, keepdim=True) / 7.0, 1e-30)
    return torch.clamp(torch.round(x / s), -7, 7), s


def conv_same(x, w):
    """Single-channel cross-correlation over the last axis, zero padding
    (k-1)//2 left and k//2 right."""
    k = w.numel()
    xp = F.pad(x, ((k - 1) // 2, k // 2))
    return sum(w[j] * xp[..., j:j + x.shape[-1]] for j in range(k))


def band_topn(st, ed, vs, min_l: int, max_l: int, top_n: int):
    """Exact top-N spans of (N, K, L) start / end probabilities weighted by
    (N, K) video scores, over the band min_l <= ed - st < max_l, ed < L:
    (values (N, top_n), video (N, top_n), st, ed), value descending."""
    n, k, L = st.shape
    w = max_l - min_l
    ends = (torch.arange(L, device=st.device)[:, None]
            + torch.arange(min_l, max_l, device=st.device)[None])
    joint = st[..., None] * ed[:, :, ends.clamp(max=L - 1)] * vs[:, :, None, None]
    joint = joint.masked_fill(~(ends < L), -math.inf)
    vals, flat = torch.topk(joint.reshape(n, k * L * w), top_n, dim=1)
    rem = flat % (L * w)
    s = rem // w
    return vals, flat // (L * w), s, s + min_l + rem % w


class Reference:
    """The step for one configuration over one corpus and weight set.

    weights: the float32 tensors of ``benchmarks.synth.make_weights``;
    corpus: ``benchmarks.synth.make_corpus``'s bf16 feat1 streams, bf16
    concatenated feat2 and mask. ``model``, ``retrieval`` and
    ``semantics`` are the configuration file's groups."""

    def __init__(self, weights: Dict[str, torch.Tensor], corpus: Dict[str, torch.Tensor],
                 model: dict, retrieval: dict, semantics: dict, precision: str = STATED):
        if precision not in (STATED, CONTROL):
            raise ValueError(f"precision {precision!r}")
        self.w, self.corpus = weights, corpus
        self.model, self.rc, self.sem = model, retrieval, semantics
        self.precision = precision
        self.dt = torch.float64 if precision == STATED else torch.bfloat16

    # ----------------------------------------------------------- queries
    def encode(self, feat, mask):
        """(video query, sub query), each (N, D): the query projection,
        positional embedding, one self-attention layer and the modular
        attention pooling."""
        w = {k: v.to(self.dt) for k, v in self.w.items()}
        x, m = feat.to(self.dt), mask.to(self.dt)
        p, e = "query_input_proj.", "query_encoder."
        x = torch.relu(_ln(x, w[p + "ln.weight"], w[p + "ln.bias"]) @ w[p + "dense.weight"].T
                       + w[p + "dense.bias"])
        x = _ln(x + w["query_pos_embed.pos_embed"][: x.shape[1]],
                w["query_pos_embed.ln.weight"], w["query_pos_embed.ln.bias"])
        n, length, d = x.shape
        heads = self.model["n_heads"]
        dh = d // heads

        def split(t):
            return t.view(n, length, heads, dh).transpose(1, 2)

        q, k, v = (split(x @ w[f"{e}self.{s}.weight"].T + w[f"{e}self.{s}.bias"])
                   for s in ("query", "key", "value"))
        scores = q @ k.transpose(-1, -2) / math.sqrt(dh) + (1.0 - m[:, None, None, :]) * -1e4
        ctx = (torch.softmax(scores, dim=-1) @ v).transpose(1, 2).reshape(n, length, d)
        x = _ln(ctx @ w[e + "output.dense.weight"].T + w[e + "output.dense.bias"] + x,
                w[e + "output.ln.weight"], w[e + "output.ln.bias"])
        att = x @ w["modular_vector_mapping.weight"].T
        att = torch.softmax(att * m[:, :, None] + (1.0 - m[:, :, None]) * NEG, dim=1)
        pooled = torch.einsum("blm,bld->bmd", att, x)
        return pooled[:, 0], pooled[:, 1]

    # ------------------------------------------------------- video scores
    def video_scores(self, vq, sq, block: int = 1024):
        """(N, Nv) float64 scores of every video: each stream's masked max
        over clips of the cosine, the two streams averaged."""
        c = self.corpus
        nv, L, d = c["vf1"].shape
        n = vq.shape[0]
        if self.precision == STATED:
            qs = [(quantize_unit_i8(_l2n(q.double())), None) for q in (vq, sq)]
        else:
            qs = [quantize_rows_int4(_l2n(q.double())) for q in (vq, sq)]
        out = []
        for v0 in range(0, nv, block):
            valid = c["mask"][v0:v0 + block] > 0
            b = valid.shape[0]
            maxima = []
            for (q, q_s), key in zip(qs, ("vf1", "sf1")):
                f = c[key][v0:v0 + block].double()
                if self.precision == STATED:
                    dots = (q @ quantize_unit_i8(f).reshape(b * L, d).T).view(n, b, L)
                else:
                    f4, f_s = quantize_rows_int4(f)
                    dots = ((q @ f4.reshape(b * L, d).T).view(n, b, L) * q_s[:, :, None]
                            * f_s.reshape(1, b, L))
                maxima.append(dots.masked_fill(~valid[None], -math.inf).amax(dim=-1))
            if self.precision == STATED:
                # integer maxima, exact in f32; one f32 rescale, as stated
                s = (maxima[0].float() + maxima[1].float()) * I8_SCALE
                out.append(s.double())
            else:
                out.append((maxima[0] + maxima[1]) / 2)
        return torch.cat(out, dim=1)

    # ------------------------------------------------------- span head
    def span_probs(self, vq, sq, idx, qblock: int = 8):
        """(N, K, L) float64 start and end probabilities of the videos
        ``idx`` (N, K): the halved concatenated query linears against the
        videos' feat2 rows, the similarity rounded as stated, the ConvSE
        kernels, the mask and a softmax over the clips."""
        w = {k: v.to(self.dt) for k, v in self.w.items()}
        vl = vq.to(self.dt) @ w["video_query_linear.weight"].T + w["video_query_linear.bias"]
        sl = sq.to(self.dt) @ w["sub_query_linear.weight"].T + w["sub_query_linear.bias"]
        qcat = torch.cat([vl, sl], dim=-1) * 0.5
        feat2, mask = self.corpus["feat2_cat"], self.corpus["mask"]
        kst = w["merged_st_predictor.conv.weight"].reshape(-1)
        ked = w["merged_ed_predictor.conv.weight"].reshape(-1)
        sts, eds = [], []
        for q0 in range(0, idx.shape[0], qblock):
            ix = idx[q0:q0 + qblock]
            sim = self._similarity(qcat[q0:q0 + qblock], feat2[ix])
            m = mask[ix].to(sim.dtype)
            for kern, acc in ((kst, sts), (ked, eds)):
                logit = conv_same(sim, kern) * m + (1.0 - m) * NEG
                acc.append(torch.softmax(logit, dim=-1).double())
        return torch.cat(sts), torch.cat(eds)

    def _similarity(self, qcat, rows):
        """(B, 2D) halved queries x (B, K, L, 2D) bf16 feat2 rows -> (B, K,
        L) similarity at the head's dtype, rounded where stated."""
        kind = self.sem["feat2"]
        if self.precision == STATED and kind == "bf16":
            q = qcat.to(torch.bfloat16).double()
            sim = torch.einsum("bd,bkld->bkl", q, rows.double())
            return sim.to(torch.bfloat16).double()
        if self.precision == STATED and kind == "int8_rows":
            q8, q_s = quantize_rows_i8_f32(qcat.float())
            f8, f_s = quantize_rows_i8_f32(rows.float())
            dots = torch.einsum("bd,bkld->bkl", q8.double(), f8.double()).float()
            sim = (dots * q_s[:, :, None]) * f_s[..., 0]
            return sim.to(torch.bfloat16).double()
        if kind == "bf16":
            q, f = qcat.to(F8).double(), rows.to(F8).double()
            sim = torch.einsum("bd,bkld->bkl", q, f)
        elif kind == "int8_rows":
            q4, q_s = quantize_rows_int4(qcat.double())
            f4, f_s = quantize_rows_int4(rows.double())
            sim = torch.einsum("bd,bkld->bkl", q4, f4) * q_s[:, :, None] * f_s[..., 0]
        else:
            raise ValueError(f"feat2 semantics {kind!r}")
        return sim.to(F8).to(torch.bfloat16)

    # ------------------------------------------------------- the step
    def score_batch(self, feat, mask, gt, qblock: int = 64) -> Dict[str, np.ndarray]:
        """The engine's outputs for one query batch, with exact selections:
        what the program's ``_score_query_batch`` returns, computed here."""
        rc = self.rc
        vq, sq = self.encode(feat, mask)
        q2c = self.video_scores(vq, sq)
        V = min(rc["max_vcmr_video"], q2c.shape[1])
        top_q2c, topv = torch.topk(q2c, V, dim=1)
        topv_scores = torch.exp(rc["q2c_alpha"] * top_q2c)
        st, ed = self.span_probs(vq, sq, torch.cat([topv, gt.long()[:, None]], dim=1))
        outs = {k: [] for k in ("vcmr_vid_local", "vcmr_st", "vcmr_ed", "vcmr_scores",
                                "svmr_st", "svmr_ed", "svmr_scores")}
        for q0 in range(0, st.shape[0], qblock):
            sl = slice(q0, q0 + qblock)
            vals, vid, s, e = band_topn(st[sl, :V], ed[sl, :V], topv_scores[sl],
                                        rc["min_pred_l"], rc["max_pred_l"], rc["max_before_nms"])
            for key, t in zip(("vcmr_scores", "vcmr_vid_local", "vcmr_st", "vcmr_ed"),
                              (vals, vid, s, e)):
                outs[key].append(t)
            ones = torch.ones_like(topv_scores[sl, :1])
            vals, _, s, e = band_topn(st[sl, V:], ed[sl, V:], ones, rc["min_pred_l"],
                                      rc["max_pred_l"], rc["max_before_nms"])
            for key, t in zip(("svmr_scores", "svmr_st", "svmr_ed"), (vals, s, e)):
                outs[key].append(t)
        res = {k: torch.cat(v).cpu().numpy() for k, v in outs.items()}
        res.update(topv_scores=topv_scores.float().cpu().numpy(),
                   topv_idx=topv.to(torch.int32).cpu().numpy())
        return res

