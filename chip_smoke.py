"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR]

Run from the repository root on a machine with one CUDA card. Phases:

1. the device, and its name and power limit from nvidia-smi;
2. build the CUDA kernels from tvretrieval_tpu_torch/csrc with nvcc;
3. each kernel against its plain PyTorch version at the full-corpus shapes
   (21,818 videos, lp=104, D=256, 1,000 queries): B1 and B3-int8 bit-equal,
   B2 and B3 in bf16 and f32 within f32 summation slack, block maxima exact;
4. end to end through the port's entry points (``encode_corpus``,
   ``retrieve``): the full-width XML with seeded random weights on a
   synthetic corpus, on the card with the kernels and on the CPU with the
   plain versions, compared; the VCMR / SVMR / VR metrics of the card run;
5. full-corpus throughput of ``_score_query_batch`` in the exact flagship
   modes, timed with CUDA events; B1 must launch once per batch;
6. a ``kernels`` JSON line (``launches`` counted over phase 4,
   ``launches_throughput`` over phase 5's warm-up and timed batches);
7. the last line: ``{"ok": true, "device": {...}}``.

Exits non-zero, without that last line, when no CUDA device is present,
when the package is missing, or when any check fails.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

N_VIDEOS_FULL = 21818
N_QUERIES = 1000
E2E_VIDEOS, E2E_QUERIES = 320, 300     # phase 4, kept small for its CPU side
HIDDEN = 256
N_CLIPS = 100
LP = 104
CHUNK_V = 16
B2_ATOL = 1e-5      # f32 summation-order slack of 256-term unit-vector dots
TIMED_RUNS, WARMUP_RUNS = 10, 2


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def alternate_ms(plain, kernel, reps: int = 5):
    """plain, kernel, kernel, plain on one card; the mean of each pair."""
    p1, k1, k2, p2 = cuda_ms(plain, reps), cuda_ms(kernel, reps), \
        cuda_ms(kernel, reps), cuda_ms(plain, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def unit(shape, gen, dev):
    x = torch.randn(shape, generator=gen, device=dev)
    return x / x.norm(dim=-1, keepdim=True)


def phase_kernels(dev, vs):
    """Phase 3: every kernel against its plain version at the main path's
    shapes. Returns the per-kernel record for the kernels line."""
    from tvretrieval_tpu_torch.ops.span import topk_stable
    from tvretrieval_tpu_torch.testing import rank_mismatches

    gen = torch.Generator(device=dev).manual_seed(0)
    nv = N_VIDEOS_FULL
    lengths = torch.randint(1, N_CLIPS + 1, (nv,), generator=gen, device=dev)
    mask = (torch.arange(N_CLIPS, device=dev)[None] < lengths[:, None]).float()
    flat = {}
    for s in ("v", "s"):
        f1 = unit((nv, N_CLIPS, HIDDEN), gen, dev)
        flat[s] = vs.build_flat_feat1(f1, mask, chunk_v=CHUNK_V)
        del f1
    q = {s: unit((N_QUERIES, HIDDEN), gen, dev) for s in ("v", "s")}
    i8 = {s: vs.quantize_unit_i8(flat[s]) for s in flat}
    bf = {s: flat[s].to(torch.bfloat16) for s in flat}
    q8 = {s: vs.quantize_unit_i8(q[s]).T for s in q}
    qb = {s: q[s].to(torch.bfloat16).T for s in q}
    qf = {s: q[s].T.contiguous() for s in q}
    nv_pad = i8["v"].shape[0] // LP
    log("kernels", f"Nq={N_QUERIES} Nv={nv} Nv_pad={nv_pad} lp={LP} D={HIDDEN} "
        f"chunk_v={CHUNK_V}; caches int8 {2 * i8['v'].numel() / 2**30:.2f} GiB, "
        f"bf16 {2 * bf['v'].numel() * 2 / 2**30:.2f} GiB, "
        f"f32 {2 * flat['v'].numel() * 4 / 2**30:.2f} GiB")
    rec = {}

    # B1: bit-equal
    args8 = (q8["v"], q8["s"], i8["v"], i8["s"], nv, LP, CHUNK_V)
    k = vs.video_scores_flat_i8(*args8[:6])
    p = vs.video_scores_flat_plain(*args8[:6])
    if not torch.equal(k, p):
        raise AssertionError(f"B1 differs from its plain version: max |d| "
                             f"{(k - p).abs().max().item()}")
    ms, pms = alternate_ms(lambda: vs.video_scores_flat_plain(*args8[:6]),
                           lambda: vs.video_scores_flat_i8(*args8[:6]))
    rec["B1"] = dict(max_abs_err=0.0, ms=ms, plain_ms=pms)
    log("kernels", f"B1 video_scores_flat_i8: bit-equal; {ms:.3f} ms vs plain {pms:.3f} ms")
    b1_scores = k

    # B2 (bf16, f32): f32 summation slack, identical top-100 outside near-ties
    argsb = (qb["v"], qb["s"], bf["v"], bf["s"], nv, LP)
    argsf = (qf["v"], qf["s"], flat["v"], flat["s"], nv, LP)
    b2_err = 0.0
    for name, args in (("bf16", argsb), ("f32", argsf)):
        k = vs.video_scores_flat(*args)
        p = vs.video_scores_flat_plain(*args)
        err = (k - p).abs().max().item()
        if not err <= B2_ATOL:
            raise AssertionError(f"B2-{name} max |d| {err} > {B2_ATOL}")
        pv, pi = topk_stable(p, 100)
        _, ki = topk_stable(k, 100)
        bad = rank_mismatches(pi.cpu(), pv.cpu(), ki.cpu(), atol=2 * B2_ATOL)
        if bad:
            raise AssertionError(f"B2-{name} top-100 differs at {bad} positions "
                                 "outside near-ties")
        b2_err = max(b2_err, err)
        ms, pms = alternate_ms(lambda: vs.video_scores_flat_plain(*args),
                               lambda: vs.video_scores_flat(*args))
        if name == "bf16":
            rec["B2"] = dict(ms=ms, plain_ms=pms)
        log("kernels", f"B2 video_scores_flat ({name}): max |d| {err:.3e} <= {B2_ATOL}, "
            f"top-100 identical outside near-ties; {ms:.3f} ms vs plain {pms:.3f} ms")
    rec["B2"]["max_abs_err"] = b2_err

    # B3: scores and exact block maxima, int8 (bit-equal), bf16 and f32
    b3_err = 0.0
    for name, args, exact in (("int8", args8, True), ("bf16", argsb + (CHUNK_V,), False),
                              ("f32", argsf + (CHUNK_V,), False)):
        ks, kb = vs.video_scores_flat_bmax(*args)
        ps, pb = vs.video_scores_flat_bmax_plain(*args)
        chunk = math.gcd(nv_pad, CHUNK_V)
        if ks.shape != (N_QUERIES, nv_pad) or kb.shape != (N_QUERIES, nv_pad // chunk):
            raise AssertionError(f"B3 shapes {tuple(ks.shape)} {tuple(kb.shape)}")
        if not bool((ks[:, nv:] == -math.inf).all()):
            raise AssertionError("B3 pad videos are not -inf")
        if not torch.equal(kb, ks.view(N_QUERIES, -1, chunk).amax(dim=2)):
            raise AssertionError(f"B3-{name} bmax is not the max of its blocks")
        err = (ks[:, :nv] - ps[:, :nv]).abs().max().item()
        if exact and not (torch.equal(ks, ps) and torch.equal(kb, pb)
                          and torch.equal(ks[:, :nv], b1_scores)):
            raise AssertionError(f"B3-int8 differs from its plain version / B1: {err}")
        if not exact and not err <= B2_ATOL:
            raise AssertionError(f"B3-{name} max |d| {err} > {B2_ATOL}")
        b3_err = max(b3_err, err)
        ms, pms = alternate_ms(lambda: vs.video_scores_flat_bmax_plain(*args),
                               lambda: vs.video_scores_flat_bmax(*args))
        if name == "int8":
            rec["B3"] = dict(ms=ms, plain_ms=pms)
        log("kernels", f"B3 video_scores_flat_bmax ({name}): max |d| {err:.3e}"
            f"{' (bit-equal)' if exact else ''}, bmax exact, pads -inf; "
            f"{ms:.3f} ms vs plain {pms:.3f} ms")
    rec["B3"]["max_abs_err"] = b3_err
    return rec


def cache_to(cache, dev):
    return dataclasses.replace(cache, **{
        f.name: getattr(cache, f.name).to(dev) for f in dataclasses.fields(cache)
        if isinstance(getattr(cache, f.name), torch.Tensor)})


def phase_end_to_end(dev):
    """Phase 4: encode_corpus + retrieve on the card (kernels) and on the
    CPU (plain versions) with the same seeded weights; returns the card
    run's metrics."""
    from tvretrieval_tpu.data.datasets import ExampleBuilder
    from tvretrieval_tpu.data.synthetic import make_synthetic_world
    from tvretrieval_tpu.evaluation.metrics import eval_retrieval_arrays
    from tvretrieval_tpu_torch.models.xml import XML, XMLConfig
    from tvretrieval_tpu_torch.ops.video_score import quantize_unit_i8
    from tvretrieval_tpu_torch.retrieval.engine import (
        RetrievalConfig, encode_corpus, retrieve)
    from tvretrieval_tpu_torch.testing import rank_mismatches, within

    n_videos, n_queries = E2E_VIDEOS, E2E_QUERIES
    t0 = time.perf_counter()
    world = make_synthetic_world(n_videos=n_videos, n_queries=n_queries,
                                 vid_dim=3072, text_dim=768, query_dim=768,
                                 max_clips=N_CLIPS, seed=0)
    builder = ExampleBuilder(
        query_source=world.query_source, video_source=world.video_source,
        sub_source=world.sub_source, ctx_mode="video_sub_tef", max_desc_l=30,
        max_ctx_l=N_CLIPS, clip_length=world.clip_length)
    cfg = XMLConfig(visual_input_size=3074, sub_input_size=770, query_input_size=768,
                    hidden_size=HIDDEN, n_heads=4, max_ctx_l=N_CLIPS, max_desc_l=30)
    model_cpu = XML(cfg).init_weights(torch.Generator().manual_seed(0)).eval()
    model_gpu = copy.deepcopy(model_cpu).to(dev)
    rows = world.annotations
    log("e2e", f"world {n_videos} videos x {N_CLIPS} clips (3072 / 768 features), "
        f"{n_queries} queries, built in {time.perf_counter() - t0:.1f} s")

    # int8 query rounding: the two devices' encoders differ by ~1e-6, so a
    # query component can round to a neighbouring int8; each such flip
    # moves a q2c score by at most 127 * 0.5 / 127^2 = 0.5 / 127
    qb = builder.build_query_batch(rows)
    q_feat, q_mask = torch.from_numpy(qb.query_feat), torch.from_numpy(qb.query_mask)
    with torch.no_grad():
        flips = 0
        for qc, qg in zip(model_cpu.encode_query(q_feat, q_mask),
                          model_gpu.encode_query(q_feat.to(dev), q_mask.to(dev))):
            n = lambda x: x / (torch.linalg.norm(x, dim=-1, keepdim=True) + 1e-12)
            flips = flips + (quantize_unit_i8(n(qc)) != quantize_unit_i8(n(qg)).cpu()).sum(1)
    int8_tol = 1e-6 + flips.numpy().astype(np.float64) * 0.5 / 127
    log("e2e", f"int8 query flips between devices: {int(flips.sum())} components in "
        f"{int((flips > 0).sum())} of {n_queries} queries")

    # tolerances on the pre-exp video score q2c and, relative, on span
    # scores (two softmax probabilities times exp(alpha * q2c)):
    # - f32 caches: the encoders' f32 summation order; bounds set at ~4x
    #   the readings of earlier H100 runs (q2c 2.6e-7, span rel 1.2e-5);
    # - bf16 caches and the bf16 similarity: that slack can round a value
    #   to the neighbouring bf16 (2^-8 relative), moving a 256-term unit
    #   dot by ~3e-5 per rounding, and a span logit by ~1%;
    # - int8 video scores on identical int8 caches: exact, except the
    #   query flips above (per query).
    base = dict(span_sim_pad_l=128, span_topk_mode="grouped_shift", query_bsz=100)
    runs = [
        # (name, config, q2c tol, span rtol, score the card's cache on the CPU)
        ("int8", RetrievalConfig(video_score_mode="pallas_int8", cache_dtype_str="bfloat16",
                                 span_score_mode="simsweep_cat_bf16", **base),
         int8_tol, 3e-2, True),
        ("int8_fused", RetrievalConfig(video_score_mode="pallas_int8", video_topk_fused=True,
                                       cache_dtype_str="bfloat16",
                                       span_score_mode="simsweep_cat_bf16", **base),
         int8_tol, 3e-2, True),
        ("f32", RetrievalConfig(video_score_mode="pallas", cache_dtype_str="float32",
                                span_score_mode="simsweep_cat", **base),
         1e-6, 3e-5, False),
        ("bf16_fused", RetrievalConfig(video_score_mode="pallas", video_topk_fused=True,
                                       cache_dtype_str="bfloat16",
                                       span_score_mode="simsweep_cat_bf16", **base),
         5e-4, 3e-2, False),
    ]
    clip = world.clip_length
    span_key = lambda v, s: ((v.astype(np.int64) * 1000 + np.rint(s[..., 0] / clip)) * 1000
                             + np.rint(s[..., 1] / clip))
    metrics = None
    for name, rcfg, q2c_tol, span_rtol, share_cache in runs:
        t0 = time.perf_counter()
        cache_gpu = encode_corpus(model_gpu, builder, world.corpus, rcfg)
        gpu = retrieve(model_gpu, builder, cache_gpu, rows, world.corpus, rcfg,
                       return_arrays=True)
        torch.cuda.synchronize()
        t_gpu = time.perf_counter() - t0
        cache_cpu = encode_corpus(model_cpu, builder, world.corpus, rcfg)
        note = ""
        if share_cache:
            # score the card's int8 bytes on the CPU too, so the plain and
            # kernel video scores see identical inputs; report the flips
            n_flip = sum(int((getattr(cache_cpu, k) != getattr(cache_gpu, k).cpu()).sum())
                         for k in ("video_feat1", "sub_feat1"))
            note = f", int8 cache bytes differing between devices: {n_flip}"
            cache_cpu = cache_to(cache_gpu, "cpu")
        cpu = retrieve(model_cpu, builder, cache_cpu, rows, world.corpus, rcfg,
                       return_arrays=True)
        for task, (vid, spans, scores) in gpu.items():
            if not (np.isfinite(scores).all() and np.isfinite(spans).all()):
                raise AssertionError(f"{name} {task}: non-finite output")
            if vid.shape != cpu[task][0].shape:
                raise AssertionError(f"{name} {task}: shape {vid.shape} vs {cpu[task][0].shape}")
        # video ranking, compared on the pre-exp scale log(s) / alpha
        ref_s = np.log(cpu["VR"][2].astype(np.float64)) / rcfg.q2c_alpha
        got_s = np.log(gpu["VR"][2].astype(np.float64)) / rcfg.q2c_alpha
        ok = within(ref_s, got_s, atol=q2c_tol)
        bad_v = rank_mismatches(cpu["VR"][0], ref_s, gpu["VR"][0],
                                atol=2 * np.asarray(q2c_tol))
        # spans: scores to rtol (plus the video score's share), and
        # (video, st, ed) identical outside near-ties
        rtol = span_rtol + np.expm1(rcfg.q2c_alpha * np.asarray(q2c_tol))
        bad_s, span_err = 0, 0.0
        for task in ("VCMR", "SVMR"):
            vid, spans, scores = gpu[task]
            rvid, rspans, rscores = cpu[task]
            span_err = max(span_err, float(np.max(np.abs(scores - rscores)
                                                  / np.maximum(np.abs(rscores), 1e-30))))
            ok = ok and within(rscores, scores, rtol=rtol)
            bad_s += rank_mismatches(span_key(rvid, rspans), rscores,
                                     span_key(vid, spans), rtol=2 * rtol)
        log("e2e", f"{name}: card {t_gpu:.2f} s; top-V q2c max |d| "
            f"{np.abs(got_s - ref_s).max():.3e} (tol {np.max(q2c_tol):.1e}), ranking "
            f"mismatches outside near-ties {bad_v}; span scores max rel |d| "
            f"{span_err:.3e} (rtol {np.max(rtol):.1e}), span mismatches outside "
            f"near-ties {bad_s}{note}")
        if not ok or bad_v or bad_s:
            raise AssertionError(f"end-to-end run {name}: the card disagrees with the CPU")
        if metrics is None:
            metrics = eval_retrieval_arrays(
                rows, world.corpus.video2idx, vcmr=gpu["VCMR"][:2],
                svmr=gpu["SVMR"][:2], vr=gpu["VR"][0])
    return metrics


def phase_throughput(dev, kernel_rec, profile_dir):
    """Phase 5: _score_query_batch at the full corpus in the exact
    flagship modes (the bench.py cache, synthesized on the card)."""
    from tvretrieval_tpu_torch.models.xml import XML, XMLConfig
    from tvretrieval_tpu_torch.ops import video_score as vs
    from tvretrieval_tpu_torch.retrieval.engine import (
        RetrievalConfig, _maybe_pad_clip_axis, _score_query_batch)

    rcfg = RetrievalConfig(cache_dtype_str="bfloat16", span_score_mode="simsweep_cat_bf16",
                           video_score_mode="pallas_int8", span_topk_mode="grouped_shift",
                           span_sim_pad_l=128, video_chunk_v=CHUNK_V)
    nv, nq = N_VIDEOS_FULL, N_QUERIES
    nv_pad = -(-nv // CHUNK_V) * CHUNK_V
    log("throughput", f"memory reckoning: int8 flat feat1 2 x {nv_pad * LP * HIDDEN / 2**30:.2f} GiB, "
        f"bf16 feat2_cat {nv * 128 * 2 * HIDDEN * 2 / 2**30:.2f} GiB, bf16 similarity "
        f"({nq}, {nv}, 128) {nq * nv * 128 * 2 / 2**30:.2f} GiB")
    cfg = XMLConfig(visual_input_size=3074, sub_input_size=770, query_input_size=768,
                    hidden_size=HIDDEN, n_heads=4, max_ctx_l=N_CLIPS, max_desc_l=30)
    model = XML(cfg).init_weights(torch.Generator().manual_seed(0)).eval().to(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    mask = torch.ones((nv, N_CLIPS), device=dev)
    feat1 = []
    for _ in range(2):
        f = vs.build_flat_feat1(unit((nv, N_CLIPS, HIDDEN), gen, dev).to(torch.bfloat16),
                                mask, chunk_v=CHUNK_V)
        feat1.append(vs.quantize_unit_i8(f))
        del f
    feat2_cat = _maybe_pad_clip_axis(torch.cat(
        [torch.randn((nv, N_CLIPS, HIDDEN), generator=gen, device=dev).to(torch.bfloat16)
         for _ in range(2)], dim=-1), rcfg)
    q_feat = torch.randn((nq, 30, 768), generator=gen, device=dev)
    q_mask = torch.ones((nq, 30), device=dev)
    gt = torch.zeros((nq,), dtype=torch.long, device=dev)
    run = lambda: _score_query_batch(model, rcfg, q_feat, q_mask, feat1[0], None, feat1[1],
                                     None, mask, gt, True, feat2_cat=feat2_cat)
    torch.cuda.reset_peak_memory_stats(dev)
    vs.reset_launch_counts()
    for _ in range(WARMUP_RUNS):
        out = run()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(TIMED_RUNS):
        out = run()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / TIMED_RUNS
    launches = dict(vs.LAUNCHES)
    want = {"video_scores_flat_i8": WARMUP_RUNS + TIMED_RUNS, "video_scores_flat": 0,
            "video_scores_flat_bmax": 0}
    if launches != want:
        raise AssertionError(f"throughput run: kernel launches {launches}, expected {want}")
    for k, v in out.items():
        if v.is_floating_point() and not bool(torch.isfinite(v).all()):
            raise AssertionError(f"throughput run: non-finite {k}")
    if (out["vcmr_scores"].shape != (nq, rcfg.max_before_nms)
            or out["topv_idx"].shape != (nq, min(rcfg.max_vcmr_video, nv))):
        raise AssertionError("throughput run: unexpected output shapes")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    log("throughput", f"_score_query_batch Nq={nq} x Nv={nv}: {ms:.2f} ms per batch = "
        f"{nq * 1000.0 / ms:.1f} q/s ({TIMED_RUNS} timed runs after {WARMUP_RUNS}); "
        f"peak memory {peak:.2f} GiB; B1 at this shape {kernel_rec['B1']['ms']:.3f} ms "
        f"vs plain {kernel_rec['B1']['plain_ms']:.3f} ms; launches {launches}")
    if profile_dir:
        from torch.profiler import ProfilerActivity, profile
        os.makedirs(profile_dir, exist_ok=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        prof.export_chrome_trace(os.path.join(profile_dir, "score_query_batch.json"))
        print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25), flush=True)
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", default="", help="write a torch.profiler trace of one "
                    "throughput batch to this directory")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tvretrieval_tpu_torch.ops import _build
    from tvretrieval_tpu_torch.ops import video_score as vs

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log("device", f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    report = _build.build()
    log("build", f"kernels built in {time.perf_counter() - t0:.1f} s")
    for line in report.splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            log("build", line.strip())

    rec = phase_kernels(dev, vs)
    torch.cuda.empty_cache()

    vs.reset_launch_counts()
    metrics = phase_end_to_end(dev)
    launches = dict(vs.LAUNCHES)
    log("e2e", f"kernel launches on the main path: {launches}")
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the main path was not launched: {launches}")
    for task in ("VCMR", "SVMR", "VR"):
        log("e2e", f"{task} metrics (card run, random weights): "
            f"{json.dumps(metrics[task])}")
    torch.cuda.empty_cache()

    launches_tp = phase_throughput(dev, rec, args.profile)

    if any(m in sys.modules for m in ("jax", "flax", "optax")):
        raise AssertionError("JAX was imported")
    src = "tvretrieval_tpu_torch/csrc/video_score.cu"
    table = [("B1", "video_scores_flat_i8", "tvretrieval_tpu/ops/pallas_score.py:363"),
             ("B2", "video_scores_flat", "tvretrieval_tpu/ops/pallas_score.py:133"),
             ("B3", "video_scores_flat_bmax", "tvretrieval_tpu/ops/pallas_score.py:290")]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": where,
         "launches": launches[name], "launches_throughput": launches_tp[name],
         "max_abs_err": rec[b]["max_abs_err"],
         "ms": rec[b]["ms"], "plain_ms": rec[b]["plain_ms"]}
        for b, name, where in table]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
