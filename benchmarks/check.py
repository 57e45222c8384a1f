"""XML's comparison that decides ``correct`` (the XML program's ``judge``):
the program's answers against the plain reference
(``benchmarks.reference.xml_ref``) at the timed sizes.

Every number is a worst case over the checked queries, larger is worse:

- ``q2c_err``: the widest gap between a returned video's score
  (ln(topv_scores) / alpha) and the reference's score of that video
  (query encoder and video scores);
- ``topv_gap`` (exact selection): by how much the worst returned video
  lies below the reference's V-th best score; ``topv_miss`` (approximate
  selection): one less the mean share of the returned videos at or above
  the reference's V-th best (the video top-V);
- ``span_err``: the widest gap between a returned moment's score and the
  reference's score of that moment (st prob x ed prob x exp(alpha q2c)),
  over the query's best reference score among its returned videos (span
  sweep, row gather, ConvSE, softmax);
- ``vcmr_gap`` / ``vcmr_miss``: as for the videos, against the
  reference's top-N moments among the returned videos (VCMR top-N);
- ``svmr_err``, ``svmr_gap``: the same for the ground-truth video's row
  (SVMR).

A returned index out of range, a repeated video or moment, a span outside
the band or a non-finite score reads ``inf``. The configuration's
``limits`` name the numbers compared and their limits
(``harness.verdict``). Beside them the check gives the share of the
reference's exact top-N moments (over its own exact top-V) that the
program returned, the ``moment_recall_pct`` metric.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from benchmarks.reference.xml_ref import Reference, band_topn

INF = float("inf")


def _distinct(keys: torch.Tensor) -> bool:
    s = torch.sort(keys, dim=1).values
    return bool((s[:, 1:] != s[:, :-1]).all())


def _worst(x: torch.Tensor) -> float:
    return float(x.max()) if x.numel() else 0.0


def judge(ref: Reference, feat, mask, gt, prog: Dict[str, np.ndarray],
          qblock: int = 64) -> Dict[str, float]:
    """Every number of the module docstring for the queries (feat, mask,
    gt) and the program's answers ``prog`` (the engine's output arrays,
    row-aligned with the queries), plus ``moment_recall_pct``."""
    rc = ref.rc
    dev = feat.device
    alpha, min_l, max_l, top_n = (rc["q2c_alpha"], rc["min_pred_l"], rc["max_pred_l"],
                                  rc["max_before_nms"])
    on = lambda a, dt=torch.long: torch.as_tensor(np.asarray(a)).to(dev, dt)
    vq, sq = ref.encode(feat, mask)
    q2c = ref.video_scores(vq, sq)
    n, nv = q2c.shape
    L = ref.corpus["mask"].shape[1]
    sel = on(prog["topv_idx"])
    V = sel.shape[1]
    out: Dict[str, float] = {}
    if V != min(rc["max_vcmr_video"], nv) or bool(((sel < 0) | (sel >= nv)).any()):
        return {k: INF for k in ("q2c_err", "topv_gap", "topv_miss", "span_err", "vcmr_gap",
                                 "vcmr_miss", "svmr_err", "svmr_gap")} | {
                                     "moment_recall_pct": 0.0}
    ref_top, ref_sel = torch.topk(q2c, V, dim=1)
    kth = ref_top[:, -1:]
    got = torch.gather(q2c, 1, sel)
    prog_vs = on(prog["topv_scores"], torch.float64)
    distinct_v = _distinct(sel)
    finite = bool(torch.isfinite(prog_vs).all()) and bool((prog_vs > 0).all())
    out["q2c_err"] = _worst((torch.log(prog_vs) / alpha - got).abs()) if finite else INF
    out["topv_gap"] = _worst((kth - got).clamp_min(0)) if distinct_v else INF
    out["topv_miss"] = (1.0 - float((got >= kth).double().mean())) if distinct_v else INF

    st, ed = ref.span_probs(vq, sq, torch.cat([sel, ref_sel, gt.long()[:, None]], dim=1))
    vs_sel, vs_ref = torch.exp(alpha * got), torch.exp(alpha * ref_top)
    vid, s, e = (on(prog[k]) for k in ("vcmr_vid_local", "vcmr_st", "vcmr_ed"))
    p_score = on(prog["vcmr_scores"], torch.float64)
    g_st, g_ed = on(prog["svmr_st"]), on(prog["svmr_ed"])
    g_score = on(prog["svmr_scores"], torch.float64)

    def in_band(s_, e_):
        return ((s_ >= 0) & (e_ < L) & (e_ - s_ >= min_l) & (e_ - s_ < max_l)).all(dim=1)

    span_err, vcmr_gap, vcmr_hit, svmr_err, svmr_gap, recall = [], [], [], [], [], []
    bad_moment = bad_svmr = False
    for q0 in range(0, n, qblock):
        b = slice(q0, q0 + qblock)
        rows = torch.arange(st[b].shape[0], device=dev)[:, None]
        # moments over the returned videos
        vals, _, _, _ = band_topn(st[b, :V], ed[b, :V], vs_sel[b], min_l, max_l, top_n)
        best, cut = vals[:, :1], vals[:, -1:]
        ok = in_band(s[b], e[b]) & ((vid[b] >= 0) & (vid[b] < V)).all(dim=1)
        bad_moment |= (not bool(ok.all())) or not _distinct(
            (vid[b] * L + s[b]) * L + e[b].clamp(0, L - 1))
        v_, s_, e_ = vid[b].clamp(0, V - 1), s[b].clamp(0, L - 1), e[b].clamp(0, L - 1)
        r_score = (st[b, :V][rows, v_, s_] * ed[b, :V][rows, v_, e_] * vs_sel[b][rows, v_])
        span_err.append(((p_score[b] - r_score).abs() / best).amax(dim=1))
        vcmr_gap.append(((cut - r_score).clamp_min(0) / best).amax(dim=1))
        vcmr_hit.append((r_score >= cut).double().mean(dim=1))
        # the program's moments among the reference's exact top-N over its own top-V
        _, rv, rs, re_ = band_topn(st[b, V:2 * V], ed[b, V:2 * V], vs_ref[b], min_l, max_l,
                                   top_n)
        ref_keys = (torch.gather(ref_sel[b], 1, rv) * L + rs) * L + re_
        got_keys = (torch.gather(sel[b], 1, v_) * L + s_) * L + e_
        hit = (got_keys[:, :, None] == ref_keys[:, None, :]).any(dim=2)
        recall.append(hit.double().sum(dim=1) / top_n)
        # the SVMR row of the ground-truth video
        ones = torch.ones_like(vs_sel[b, :1])
        gvals, _, _, _ = band_topn(st[b, 2 * V:], ed[b, 2 * V:], ones, min_l, max_l, top_n)
        bad_svmr |= (not bool(in_band(g_st[b], g_ed[b]).all())) or not _distinct(
            g_st[b] * L + g_ed[b].clamp(0, L - 1))
        gs, ge = g_st[b].clamp(0, L - 1), g_ed[b].clamp(0, L - 1)
        r_g = st[b, 2 * V][rows, gs] * ed[b, 2 * V][rows, ge]
        svmr_err.append(((g_score[b] - r_g).abs() / gvals[:, :1]).amax(dim=1))
        svmr_gap.append(((gvals[:, -1:] - r_g).clamp_min(0) / gvals[:, :1]).amax(dim=1))
    finite_m = bool(torch.isfinite(p_score).all()) and bool(torch.isfinite(g_score).all())
    out["span_err"] = _worst(torch.cat(span_err)) if finite_m and not bad_moment else INF
    out["vcmr_gap"] = _worst(torch.cat(vcmr_gap)) if not bad_moment else INF
    out["vcmr_miss"] = (1.0 - float(torch.cat(vcmr_hit).mean())) if not bad_moment else INF
    out["svmr_err"] = _worst(torch.cat(svmr_err)) if finite_m and not bad_svmr else INF
    out["svmr_gap"] = _worst(torch.cat(svmr_gap)) if not bad_svmr else INF
    out["moment_recall_pct"] = 100.0 * float(torch.cat(recall).mean())
    return out
