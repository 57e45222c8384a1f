"""Measure the retrieval engine's stage-mode variants at corpus scale, and
run each study kernel beside the engine stage it stands in for.

Port of tvretrieval_tpu/profiling/engine_modes.py. On one card, timed with
CUDA events (one synchronisation before and one after the timed batches):

  * span_score_mode:  "gather" (top-V feature-row gather), "simsweep"
                      (similarity sweep + row gather) and its cat / bf16 /
                      int8 forms
  * video_score_mode: "einsum", "pallas" / "pallas_int8" (the CUDA kernels
                      of ops/video_score.py)

Run:  python -m tvretrieval_tpu_torch.profiling.engine_modes [--nq 200]
      [--n_videos 21818] [--iters 8] [--warmup 2] [--hidden 256]
      [--modes ...] [--chunk_v 16] [--interpret] [--device {cuda,cpu}]
Prints one line per mode combination; the span candidates of every
combination are held to the first one's (indices exactly, scores to
rtol 1e-6) and a difference prints MISMATCH.

--modes entries are span/video[/span_topk[/flags]], e.g.
  simsweep_cat_bf16/pallas_int8/grouped_shift/pad128 (the flagship).
Flags: "preexp" (video top-k on pre-exp scores), "fused" (kernel-emitted
block-max video top-k), "vpsort" (video top-k through the sorting kernel),
"vapprox" (video top-k by the approximate top-k), "rt<r>" (the recall
target of every approximate selection, e.g. rt0.9; default 0.99), "pad128"
(span_sim_pad_l=128). bench.py's shipped configuration is
  simsweep_cat_bf16/pallas_int8/grouped_shift_approx/vapprox/rt0.9/pad128
(the approximate selections are not parity modes: against an exact first
combination they print MISMATCH).

The stage study follows the combinations, on the same caches and the same
query batch: each of the four kernels that no engine mode runs, beside the
stage it is an alternative to, one line each with both times and their
agreement:

  * video_scores_masked (B9)            | the "einsum" video-score stage,
                                        | both on the run's mask with one
                                        | fully and one partly masked
                                        | video planted
  * fused_video_scores_clip_major (B10) | the same stage, one stream, with
                                        | exp(alpha * s) fused and without
  * gathered_similarity (B7)            | span mode "gather": the row gather
                                        | and the two products
  * banded_topk_spans_fused (B8)        | span top-k banded_topk_spans, on
                                        | the batch's own probabilities and
                                        | on peaked ones (logits x 20);
                                        | the engine's grouped_shift stage
                                        | timed beside them

With --device cpu everything runs the kernels' plain versions (a smoke
run: its times are the host's).
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from tvretrieval_tpu_torch.models.xml import XML, XMLConfig, l2_normalize
from tvretrieval_tpu_torch.ops import _build, fused_score, gather, topk
from tvretrieval_tpu_torch.ops import video_score as vs
from tvretrieval_tpu_torch.ops.masking import mask_logits
from tvretrieval_tpu_torch.ops.span import (
    banded_topk_spans, banded_topk_spans_grouped_shift, topk_stable_blocked)
from tvretrieval_tpu_torch.retrieval.engine import (
    RetrievalConfig, _score_query_batch, check_supported)

N_CLIPS = 100
SEED = 0                 # weights, queries and caches are made from it
PEAK_FACTOR = 20.0       # the peaked case of the B8 study: softmax(logits * 20)
STUDY_KERNELS = ("video_scores_masked", "fused_video_scores_clip_major",
                 "gathered_similarity", "banded_topk_spans_fused")


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--nq", type=int, default=200)
    p.add_argument("--n_videos", type=int, default=21818)
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--modes", type=str, nargs="+", default=None,
                   help="subset like gather/einsum simsweep/pallas")
    p.add_argument("--chunk_v", type=int, default=16,
                   help="RetrievalConfig.video_chunk_v: the flat caches' video padding "
                        "multiple and the bound on videos per block maximum (applies to "
                        "every combo: the flat caches are built once)")
    p.add_argument("--interpret", action="store_true",
                   help="RetrievalConfig.pallas_interpret, kept so that the JAX command "
                        "line carries over; the CUDA kernels have no interpret mode, so it "
                        "changes nothing")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="cpu runs the kernels' plain versions (a smoke run)")
    return p


def combo_config(base: RetrievalConfig, combo: str) -> RetrievalConfig:
    """The RetrievalConfig of one ``span/video[/span_topk[/flags]]`` entry."""
    parts = combo.split("/")
    if len(parts) < 2:
        raise ValueError(f"--modes entry {combo!r} is not span/video[/span_topk[/flags]]")
    flags = set(parts[3:])
    unknown = {f for f in flags
               if f not in ("preexp", "fused", "vapprox", "vpsort", "pad128")
               and not f.startswith("rt")}
    if unknown:
        raise ValueError(f"--modes entry {combo!r}: unknown flags {sorted(unknown)}")
    recall = next((float(f[2:]) for f in flags if f.startswith("rt")),
                  base.topk_approx_recall)
    rcfg = dataclasses.replace(
        base, span_score_mode=parts[0], video_score_mode=parts[1],
        span_topk_mode=parts[2] if len(parts) > 2 else "grouped",
        video_topk_pre_exp="preexp" in flags, video_topk_fused="fused" in flags,
        video_topk_approx="vapprox" in flags, video_topk_psort="vpsort" in flags,
        topk_approx_recall=recall, span_sim_pad_l=128 if "pad128" in flags else 0)
    check_supported(rcfg)
    return rcfg


def synthesize(nq: int, n_videos: int, hidden: int, dtype: torch.dtype,
               device) -> Dict[str, torch.Tensor]:
    """The query batch and the corpus caches the JAX file synthesizes: unit
    feat1 and normal feat2 at the cache dtype, an all-ones mask."""
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=device)

    def unit(x):
        return (x / (torch.linalg.norm(x, dim=-1, keepdim=True) + 1e-12)).to(dtype)

    return dict(
        qf=randn(nq, 30, 768), qm=torch.ones((nq, 30), device=device),
        vf1=unit(randn(n_videos, N_CLIPS, hidden)), sf1=unit(randn(n_videos, N_CLIPS, hidden)),
        vf2=randn(n_videos, N_CLIPS, hidden).to(dtype),
        sf2=randn(n_videos, N_CLIPS, hidden).to(dtype),
        mask=torch.ones((n_videos, N_CLIPS), device=device),
        gt=torch.zeros((nq,), dtype=torch.long, device=device))


def _time_ms(fn, iters: int, warmup: int, device: torch.device) -> float:
    """ms per call: CUDA events around ``iters`` calls on the card, one
    synchronisation before and one after; the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize(device)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def in_query_blocks(fn, n: int, block: int):
    """``fn(slice)`` over blocks of queries, concatenated field by field:
    keeps a plain version that materializes what its kernel fuses inside
    the card's memory."""
    outs = [fn(slice(i, i + block)) for i in range(0, n, block)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(x) for x in zip(*outs))
    return torch.cat(outs)


def launch_counts() -> Dict[str, int]:
    """Launches of the four study kernels since the last reset."""
    return {k: _build.LAUNCHES[k] for k in STUDY_KERNELS}


def plant_masked_videos(mask: torch.Tensor):
    """The stage study's mask: the run's ``mask`` with its last video fully
    masked and, where there are two or more videos, its first video masked
    from clip L // 2 on. Returns (mask, (fully masked ids, partly masked
    ids)); the caller's mask is not changed."""
    nv, L = mask.shape
    fully, partly = [nv - 1], ([0] if nv > 1 else [])
    planted = mask.clone()
    planted[fully] = 0.0
    planted[partly, max(1, L // 2):] = 0.0
    return planted, (fully, partly)


@torch.no_grad()
def stage_study(model: XML, rcfg: RetrievalConfig, data: Dict[str, torch.Tensor],
                iters: int, warmup: int) -> List[dict]:
    """Each study kernel beside its engine stage on the run's caches and
    query batch; prints one line each and returns their records.

    B9 and B10 (and the top-V selection after them) see the run's mask with
    one fully and one partly masked video planted (``plant_masked_videos``),
    so that their masked branch runs; their records carry the planted
    counts and ``masked_exact``: the fully masked video scores exactly
    -1e10 (0.0 after exp) in kernel and stage alike."""
    dev = data["mask"].device
    vf1, sf1, vf2, sf2, mask = (data[k] for k in ("vf1", "sf1", "vf2", "sf2", "mask"))
    study_mask, (fully, partly) = plant_masked_videos(mask)
    planted = dict(planted_fully_masked=len(fully), planted_partly_masked=len(partly))
    exact_at = lambda got, ref, value: bool((got[:, fully] == value).all()
                                            and (ref[:, fully] == value).all())
    note = f"; {len(fully)} + {len(partly)} planted masked videos"
    nq = data["qf"].shape[0]
    nv, L = mask.shape
    V = min(rcfg.max_vcmr_video, nv)
    alpha = rcfg.q2c_alpha
    timed = lambda fn: _time_ms(fn, iters, warmup, dev)
    records = []

    def report(kernel: str, stage: str, case: str, kernel_ms: float, stage_ms: float,
               agreement: str, **extra) -> None:
        print(f"study {kernel:30s} {case:10s} {kernel_ms:9.3f} ms  |  {stage:28s} "
              f"{stage_ms:9.3f} ms  [{agreement}]", flush=True)
        records.append(dict(kind="study", kernel=kernel, stage=stage, case=case,
                            kernel_ms=kernel_ms, stage_ms=stage_ms, agreement=agreement,
                            **extra))

    vq, sq = model.encode_query(data["qf"], data["qm"])
    qv, qs = l2_normalize(vq).to(vf1.dtype), l2_normalize(sq).to(sf1.dtype)

    # B9 beside the einsum video-score stage
    stage = lambda: vs.video_scores_xla(qv, qs, vf1, sf1, study_mask)
    kernel = lambda: vs.video_scores_masked(qv, qs, vf1, sf1, study_mask)
    q2c = stage()
    got = kernel()
    err = (got - q2c).abs().max().item()
    report("video_scores_masked", "video_scores_xla (einsum)", str(vf1.dtype)[6:],
           timed(kernel), timed(stage), f"max |d| {err:.3e}{note}", max_abs_err=err,
           masked_exact=exact_at(got, q2c, -1e10), **planted)
    del got

    # B10 beside the same stage, one stream: the clip-major copy is made once
    feat1_t = vf1.transpose(0, 1).contiguous()
    mask_t = study_mask.T[:, None, :].contiguous()
    for a in (alpha, None):
        stage = lambda: fused_score.fused_video_scores_xla(qv, vf1, study_mask, a)
        kernel = lambda: fused_score.fused_video_scores_clip_major(qv, feat1_t, mask_t, a)
        ref, got = stage(), kernel()
        d = (got - ref).abs()
        err = (d / ref.abs().clamp_min(1e-30)).max().item() if a is not None else d.max().item()
        report("fused_video_scores_clip_major", "fused_video_scores_xla",
               f"alpha={a:g}" if a is not None else "alpha=None", timed(kernel), timed(stage),
               f"max {'rel ' if a is not None else ''}|d| {err:.3e}{note}", max_err=err,
               masked_exact=exact_at(got, ref, 0.0 if a is not None else -1e10), **planted)
        del ref, got, d
    del feat1_t, mask_t

    # the engine's top-V selection and its (Nq, V + 1) gather indices
    topv_scores, topv_idx = topk_stable_blocked(torch.exp(alpha * q2c.float()), V)
    gather_idx = torch.cat([topv_idx.long(), data["gt"][:, None]], dim=1)

    # B7 beside span mode "gather": the row gather and the two products
    vql, sql = model.video_query_linear(vq), model.sub_query_linear(sq)
    block_q = 32
    stage = lambda: gather.gathered_similarity_plain(vql, sql, vf2, sf2, gather_idx, block_q)
    kernel = lambda: gather.gathered_similarity(vql, sql, vf2, sf2, gather_idx)
    sim = stage()
    err = ((kernel() - sim).abs().max() / sim.abs().max()).item()
    report("gathered_similarity", "index + two f32 einsums", str(vf2.dtype)[6:],
           timed(kernel), timed(stage), f"max |d| / max |sim| {err:.3e}", max_rel_err=err)
    gather.check_indices(dev)

    # B8 beside the span top-k, on the batch's probabilities and on peaked
    # ones; beside it too the engine's own span top-N stage (grouped_shift)
    mask_g = mask[gather_idx]
    st_logits, ed_logits = (mask_logits(x, mask_g) for x in model._merged_span_conv(sim))
    for case, factor in (("own", 1.0), ("peaked", PEAK_FACTOR)):
        st_p = torch.softmax(st_logits[:, :V].float() * factor, dim=-1).contiguous()
        ed_p = torch.softmax(ed_logits[:, :V].float() * factor, dim=-1).contiguous()
        args = (rcfg.min_pred_l, rcfg.max_pred_l, rcfg.max_before_nms)
        block_q = 125                    # the plain version materializes the joint
        stage = lambda: in_query_blocks(lambda s: banded_topk_spans(
            st_p[s], ed_p[s], topv_scores[s], *args), nq, block_q)
        kernel = lambda: topk.banded_topk_spans_fused(st_p, ed_p, topv_scores, *args,
                                                      return_sorted=True)
        engine = lambda: banded_topk_spans_grouped_shift(st_p, ed_p, topv_scores, *args)
        ref, got = stage(), kernel()
        equal = all(torch.equal(a, b) for a, b in zip(ref, got[:4]))
        engine_equal = all(torch.equal(a, b) for a, b in zip(ref, engine()))
        share = got[4].float().mean().item() / V
        engine_ms = timed(engine)
        report("banded_topk_spans_fused", "banded_topk_spans", case, timed(kernel),
               timed(stage), ("all four outputs equal" if equal else "MISMATCH")
               + f"; {100 * share:.1f}% of the videos hold a selected row; the engine's "
               f"grouped_shift {engine_ms:.3f} ms"
               + ("" if engine_equal else ", MISMATCH"),
               equal=equal and engine_equal, videos_share=share, grouped_shift_ms=engine_ms)
    return records


@torch.no_grad()
def run(args, model: Optional[XML] = None,
        data: Optional[Dict[str, torch.Tensor]] = None) -> List[dict]:
    """Time every combination of ``args.modes``, then run the stage study.
    ``model`` and ``data`` (the dictionary of
    ``synthesize``) default to the flagship XML with seeded random weights
    and the synthesized caches. Returns one record per printed line:
    ``kind`` "combo" (with the span candidates as numpy arrays under
    ``spans``) or "study"."""
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("engine_modes: no CUDA device is available; pass --device cpu "
                         "to run the plain versions on the CPU")
    combos = (list(args.modes) if args.modes else
              ["/".join(c) for c in itertools.product(("gather", "simsweep"),
                                                      ("einsum", "pallas"))])
    base = RetrievalConfig(cache_dtype_str="bfloat16", query_bsz=args.nq,
                           video_chunk_v=args.chunk_v, pallas_interpret=args.interpret)
    cfgs = {c: combo_config(base, c) for c in combos}       # raises before any allocation
    span = lambda c: c.split("/")[0]
    video = lambda c: c.split("/")[1]
    flags = lambda c: c.split("/")[3:]
    bad = [c for c in combos if "pad128" in flags(c)
           and span(c) not in ("simsweep_cat", "simsweep_cat_bf16")]
    if bad:
        raise SystemExit("pad128 flag only valid on simsweep_cat/simsweep_cat_bf16 "
                         f"combos, got: {bad}")

    L, H = N_CLIPS, args.hidden
    if model is None:
        cfg = XMLConfig(ctx_mode="video_sub", visual_input_size=3074, sub_input_size=770,
                        query_input_size=768, hidden_size=H, n_heads=4, max_ctx_l=L,
                        max_desc_l=30)
        model = XML(cfg).init_weights(torch.Generator().manual_seed(SEED))
    model = model.eval().to(dev)
    if data is None:
        data = synthesize(args.nq, args.n_videos, H, base.cache_dtype, dev)
    d, mask = data, data["mask"]

    # the layouts, each built only where a combo reads it
    cat = torch.cat([d["vf2"], d["sf2"]], dim=-1) if any(
        span(c).startswith("simsweep_cat") for c in combos) else None
    cat_pad = None
    if any("pad128" in flags(c) for c in combos):
        cat_pad = F.pad(cat, (0, 0, 0, 128 - L))
    cat_i8 = cat_i8_scale = flat_i8 = flat_i8_scale = None
    if any(span(c) == "simsweep_cat_int8" for c in combos):
        cat_i8, cat_i8_scale = vs.quantize_rows_i8(cat)
    if any(span(c) == "simsweep_cat_int8_flat" for c in combos):
        flat_i8, flat_i8_scale = vs.build_flat_feat2_i8(cat, chunk_v=args.chunk_v)
    if not any(span(c) in ("simsweep_cat", "simsweep_cat_bf16") and "pad128" not in flags(c)
               for c in combos):
        cat = None
    vf1_flat = sf1_flat = vf1_i8 = sf1_i8 = None
    if any(video(c) in ("pallas", "pallas_int8") for c in combos):
        vf1_flat = vs.build_flat_feat1(d["vf1"], mask, chunk_v=args.chunk_v)
        sf1_flat = vs.build_flat_feat1(d["sf1"], mask, chunk_v=args.chunk_v)
        if any(video(c) == "pallas_int8" for c in combos):
            vf1_i8, sf1_i8 = vs.quantize_unit_i8(vf1_flat), vs.quantize_unit_i8(sf1_flat)
            if not any(video(c) == "pallas" for c in combos):
                vf1_flat = sf1_flat = None

    records: List[dict] = []
    ref_spans = ref_name = None
    width = max(18, *(len(c) for c in combos))
    for combo in combos:
        rcfg = cfgs[combo]
        if span(combo) == "simsweep_cat_int8":
            kw = dict(feat2_cat=cat_i8, feat2_cat_scale=cat_i8_scale)
        elif span(combo) == "simsweep_cat_int8_flat":
            kw = dict(feat2_cat=flat_i8, feat2_cat_scale=flat_i8_scale)
        elif span(combo).startswith("simsweep_cat"):
            kw = dict(feat2_cat=cat_pad if "pad128" in flags(combo) else cat)
        else:
            kw = {}
        f1v = {"pallas": vf1_flat, "pallas_int8": vf1_i8}.get(video(combo), d["vf1"])
        f1s = {"pallas": sf1_flat, "pallas_int8": sf1_i8}.get(video(combo), d["sf1"])
        batch = lambda: _score_query_batch(model, rcfg, d["qf"], d["qm"], f1v, d["vf2"], f1s,
                                           d["sf2"], mask, d["gt"], True, **kw)
        t0 = time.perf_counter()
        out = batch()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        first_s = time.perf_counter() - t0          # kernel builds and library set-up
        ms = _time_ms(batch, args.iters, args.warmup, dev)
        spans = tuple(out[k].cpu().numpy() for k in
                      ("vcmr_vid_local", "vcmr_st", "vcmr_ed", "vcmr_scores"))
        if ref_spans is None:
            ref_spans, ref_name, exact = spans, combo, "ref"
        else:
            same = (all(np.array_equal(a, b) for a, b in zip(spans[:3], ref_spans[:3]))
                    and np.allclose(spans[3], ref_spans[3], rtol=1e-6))
            exact = ("bit-exact vs " if same else "MISMATCH vs ") + ref_name
        print(f"{combo:{width}s} {ms:8.2f} ms/batch  {args.nq * 1e3 / ms:8.1f} q/s  "
              f"(first call {first_s:.1f}s)  [{exact}]", flush=True)
        records.append(dict(kind="combo", combo=combo, ms=ms, qps=args.nq * 1e3 / ms,
                            exact=exact, spans=spans))
        del out
    del cat, cat_pad, cat_i8, flat_i8, vf1_flat, sf1_flat, vf1_i8, sf1_i8, kw, f1v, f1s, batch
    records += stage_study(model, base, data, args.iters, args.warmup)
    return records


def main(argv: Optional[List[str]] = None) -> int:
    args = build_arg_parser().parse_args(argv)
    run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
