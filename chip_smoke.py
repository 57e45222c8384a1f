"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR] [--parent DIR] [--int8-repeats N]

Run from the repository root on a machine with one CUDA card. Phases:

1. the device, and its name and power limit from nvidia-smi;
2. build the CUDA kernels from tvretrieval_tpu_torch/csrc with nvcc, one
   compiler per source, side by side; the SASS must hold IGMMA (s8 wgmma)
   and no IMMA, HMMA or HGMMA in the int8 video-score kernels (B1 /
   B3-int8) and in B5, HGMMA (wgmma) all of the BF16 form and no HMMA in
   the bf16 instances of the video scores (B2 / B3) and of the masked
   scores (B9 / B10), HGMMA all of the TF32 form and no HMMA in their f32
   ones (3xTF32) and in ExCL's span heads (csrc/excl_head.cu), no instance
   of those libraries without tensor-core instructions, and no IDP (dp4a);
   then the tensor-core ceilings: s8, bf16
   and tf32 mma.sync products from registers, wgmma s8 m64n256k32 and bf16
   m64n208k16 from shared memory and tf32 m64n104k8 with A from registers,
   on every SM (csrc/mma_probe.cu), in TOPS beside the data sheet's peaks;
3. each kernel against its plain PyTorch version at the full-corpus
   shapes (21,818 videos, 1,000 queries): the video scores (lp=104, D=256)
   B1 and B3-int8 bit-equal, B2 and B3 in bf16 and f32 (caches drawn in
   f32) within f32 summation slack, block maxima exact; the int8 span sweep
   B5 (2,793,472 flat rows, K=512) bit-equal over all its outputs, pads
   exactly zero (B1-B3, B5 as a share of the peak and of the probed wgmma
   and mma.sync ceilings, f32 counted as three TF32 products; B1 and B5
   beside ``torch._int_mm`` over their operands, the s8 GEMM alone, B2
   beside ``torch.matmul`` over one stream's bf16 and f32 operands (TF32
   off), the GEMM alone, and the host
   cost of B1's four tensor-map encodes); the sorting
   top-k B6 at the engine's five row shapes equal in values and indices on
   rows with planted ties; the approximate top-k B11 at the engine's three
   sites (video top-V 21,818, span group select 10,000, final span select
   2,800) at recall 0.90 and 0.99 and, on the video site, 1.0 (more bins
   than one pass holds), equal in values and indices on normal rows,
   int8-grid rows with ties planted at the cut, rows of one value and rows
   with -inf pads, with its measured mean recall beside the formula's, and
   timed at recall 0.90 on the normal and the int8-grid rows;
4. end to end through the port's entry points (``encode_corpus``,
   ``retrieve``): the full-width XML with seeded random weights on a
   synthetic corpus, on the card with the kernels and on the CPU with the
   plain versions, compared, in the bf16 / f32 modes, the int8 span modes,
   the psort selections (which must equal the card's own exact
   selection) and both approximate selections at recall 0.90 (B11 against
   its plain version); the int8 runs' top-V scores on the int8 grid on both
   devices first; the VCMR / SVMR / VR metrics of the card run;
5. full-corpus throughput of ``_score_query_batch``, timed with CUDA
   events, in the exact flagship modes (B1 must launch once per batch), in
   bench.py's shipped configuration (the flagship's with both approximate
   selections at recall 0.90: B1 once, B11 three times per batch; each
   site's mean recall on the batch's own rows at least 0.90; q/s and the
   device's busy share beside the flagship's, and the share of the
   flagship's top-200 moments it returns), in
   the all-int8 psort modes (B1 once, B5 once, B6 five times per batch;
   its device time too), in
   bf16 parity, the flagship's modes with the bf16 video scores over the
   bf16 flat feat1 cache (B2 once per batch, no other kernel), and in f32
   parity, the same over the engine's default f32 caches (feat1 drawn in
   f32, feat2 f32; B2-f32 once per batch, no other kernel);
6. the byte-row gather B4 against ``index_select`` on the full TVR byte
   tables (21,818 rows of 308,224 and of 77,824 bytes, 128 indices with
   duplicates): equal, no copy of the table, timed in turns;
7. training at full width through ``XMLTrainer`` on the GPU-resident
   float8 corpus of a synthetic world: the first batch's loss on the card
   against the CPU, two epochs of optimizer steps (finite, falling losses;
   B4 twice per step), an eval-loss pass, ``encode_corpus_resident`` and
   ``retrieve`` from the resident query table;
8. the four study kernels, which no engine mode runs, against their plain
   versions at the same corpus scale (1,000 queries, 21,818 videos of 100
   clips, D=256, 100 + 1 selected rows, W=14, top_n=200): the masked video
   scores B9 and the one-stream fused scores B10 in bf16 and f32 (drawn in
   f32) within f32 summation slack, planted fully masked videos exactly
   -1e10 (B9 / B10 as a share of the peak and of the probed wgmma and
   mma.sync ceilings, beside ``torch.matmul`` over one stream's bf16 and
   f32 operands, TF32 off, the GEMM alone); the fused
   gather + similarity B7 in bf16 and f32 within 1e-5 of the largest
   similarity; the fused banded top-N B8 equal in all four outputs on
   near-uniform, peaked, tied and all-equal probabilities, with the share
   of rows its row threshold leaves and the elements reaching it;
9. the stage-study path through its entry point
   (``profiling.engine_modes.run``) at full width: the flagship combination
   and its psort variant (equal span candidates), then, with the counts
   set to 0, "gather" / "einsum" combinations; the stage study follows
   each call (B9 / B10 on a mask with one fully and one partly masked video
   planted, the fully masked one exactly -1e10 in kernel and stage), and
   in the second B7-B10 must each launch;
10. the XML variants (LSTM, GRU and CNN encoders, video- and
   subtitle-only, "w/o merge", "w/o cross-att", ``cat_linear``, stacked
   ConvSE, ``no_modular``, bf16 compute) at the flagship's widths with
   seeded weights: (a) each through ``encode_corpus`` + ``retrieve`` on
   phase 4's corpus, card against CPU (phase 4's f32 bounds, wider ones
   stated for the recurrent encoders and bf16), the merged-head variants in
   the f32 kernel modes (B2), the others on the JAX engine's second branch
   (B6 under psort); (b) the "w/o merge" XML through
   ``_score_query_batch`` at 21,818 videos x 1,000 queries, exact, psort
   (B6; equal to the exact run) and approx at recall 0.90 (B11; each
   site's recall), q/s and peak memory; (c) the bf16 and the LSTM XML
   trained on phase 7's resident world: first-batch loss card against
   CPU, a falling loss, ms a step beside phase 7's;
11. the streaming engine (``retrieval.streaming``) at the full corpus
   (21,818 videos of 1-100 clips, one fully masked, f32, pulled from the
   card into pinned host memory) in its three host modes, einsum, flat
   (B2) and flat_int8 (B1): B1 / B2 on a streamed block, the first and the
   last, zero-filled one, against their plain versions (B1 bit-equal, B2
   within 1e-5); 200 queries equal to the resident engine on the card
   (span mode "gather", the matching video mode; flat_int8 exact, the
   others outside near-ties); 1,000 queries in batches of 50 with the
   shipped span selection (B11 at recall 0.90), launches counted from 0
   (B1 / B2 once a block, B11 twice a batch), q/s beside the resident
   engine's, per block copy and score ms from events on the two streams,
   the overlap share, the host-to-device rate against a pinned-copy probe,
   phase 2's host gather and feat2 copy, peak device memory at 10,909 and
   21,818 videos (equal within 5%, below the resident cache), and in
   flat_int8 B11's recall at both span sites; then the flagship forward
   entry point (``tvretrieval_tpu_torch.entry``) on the card against the
   CPU, within 2e-4;
12. the baselines (MEE, CAL / MCN, ExCL; every launch count is set to 0
   before the phase; after (a)-(d) B6 must read twice the card's calls of
   ExCL's span stage ``excl_vcmr_batch`` and every other count 0) at the
   JAX CLIs' full widths with seeded weights: (a) card
   against CPU on phase 4's corpus: ``mee_retrieve_vr`` (phase 4's f32
   bound), ``encode_proposal_corpus`` + ``cal_retrieve`` (VCMR, SVMR) for
   CAL on 16 videos and MCN on 32 (the cached means, and the distances
   within twice phase 10's recurrent q2c bound; encode ms a video),
   ``excl_retrieve_svmr`` on every query and
   ``excl_retrieve_vcmr_with_external_vr`` over the card's MEE submission
   (phase 10's recurrent span rtol), rankings equal outside near-ties;
   (b) serving at 21,818 videos: MEE's scoring of 1,000 queries over its
   encoded corpus (q/s, cache bytes), ``cal_retrieve`` over a synthesized
   21,818 x 170 x 100 two-stream proposal cache (1,000 queries in batches
   of 100: q/s, the SVMR rows' bytes copied to the host, peak memory),
   ExCL's SVMR on 1,000 queries and VCMR over MEE's top-100 for 100 (q/s);
   (c) ``train_mee``, ``train_cal`` and ``train_excl`` at batch 128 on
   phase 7's world: the first batch's loss card against CPU within 2e-4
   (ExCL without dropout), finite and falling step losses, ms a step; (d)
   ``inference_baselines`` on each run directory on the card (``--nms_thd
   0.5``; ExCL with MEE's submission as its external VR), its metrics equal
   to the run's own; (e) MEE + ExCL over 21,818 videos of 100 clips
   through ``score_mee_excl_batch``, the served two-stage path: the cache
   built a block at a time, then calls of 50 queries with their GT videos,
   five B6 launches a call (counted from 0), each equal to
   ``topk_transposed_plain`` on the same inputs, the returned VR scores
   equal to MEE's scores of the returned videos, the outputs' shapes,
   order and per-video cap; one launch a call of the second-LSTM kernel
   and one of the span-head kernel; ms a call, cache bytes, peak memory;
   (f) the second-LSTM kernel
   (``ops/lstm.py::excl_lstm``, csrc/excl_lstm.cu) against its plain
   version (the concatenation and cuDNN) at the cell's call (5,050 pairs
   x 100 clips, both streams) and the external-VR path's (1,000 pairs,
   lengths 1-100, some 0): one launch, the outputs' and the span logits'
   largest differences, its ms beside its bound, the plain version's and
   cuDNN's bidirectional nn.LSTM's; (g) the span-head kernel
   (``ops/excl_head.py::excl_heads``, csrc/excl_head.cu) against its plain
   version (the concatenation, the SpanPredictors, the mask, the mean) and
   the same heads in f64 at the same two shapes: one launch, masked clips
   exactly -1e10, its ms beside its bound, the plain version's and the
   library yardstick's (``F.linear`` heads over the concatenation, which
   the port never calls);
13. the offline feature pipelines and the profiling suite (no hand kernel
   lies on their paths: every launch count is set to 0 before the phase and
   must read 0 after): (a) ResNet-152 (3, 8, 36, 3) on 224 x 224 frames and
   I3D on 23-frame 224 x 224 clips, the card against the CPU on the same
   seeded weights within ``BACKBONE_RTOL`` of the largest feature, then
   frames/s of ``make_resnet152_frame_model`` at batch 32 and clips/s of
   ``make_i3d_clip_model`` at batch 4 (CUDA events) beside their bounds at
   the f32 peak (TF32 is off), and peak memory; (b) both extraction loops
   over synthetic videos of 100 clips, the pooling helpers, the shapes
   (100, 2048) and (100, 1024) read back (HDF5 where h5py imports, else
   the per-video functions the writers call, said on a line of its own);
   (c) ``mask_tokens`` and the learning-rate schedule, and where
   transformers imports, ``finetune_mlm`` on a roberta-base-width RoBERTa
   with random weights (a falling loss) and token features through the
   torch embedder from seeded ids; (d) ``profile_models.main`` as the CLI
   runs it (XML retrieval at 2,000 videos, ``--train`` in f32 and bf16,
   ``--baselines``, ``--data``) and ``search_simulation`` (20,000 x 256,
   128 clusters, nprobe 8 and 128): the JAX key sets, finite positive
   times, recall 1.0 at full probe, k-means card against CPU from the same
   initial rows within ``KMEANS_ATOL`` on separated blobs;
14. several devices (``parallel``), with logical shards on the one card:
   (a) corpus-sharded serving (``parallel.sharded_retrieval``) at the
   flagship's full width, 4 shards against the resident engine on the same
   cache: the bf16 flagship (indices equal outside near-ties), shipped
   (each approximate site's recall on every shard's rows >= 0.90), all-int8
   psort and all-int8 fused (bit-equal); each kernel launched 4 times the
   resident engine's count a batch (B1 / B3, B5, B6, B11); q/s at 1, 2 and
   4 shards beside the resident engine's; (b) the streaming engine with a
   2-shard mesh, flat (B2) and flat_int8 (B1), bit-equal to streaming
   without one; (c) data-parallel XML training on 2 gloo ranks sharing the
   card at phase 7's shape (dropout off): the first step's loss within
   2e-4 of one process's, a falling loss, B4 twice a step in each rank, ms
   a step; (d) the baselines' trainers (MEE, CAL, ExCL with dropout) on 2
   gloo ranks sharing the card at phase 12's widths and flags, 2 x 4
   steps of batch 128: the first step's loss against one process's (MEE
   within 1e-5 relative, CAL and ExCL within phase 10's recurrent 3e-4),
   a falling loss, no hand kernel launched, ms a step beside one
   process's;
15. a ``kernels`` JSON line (``launches`` counted over phases 4 and 10 for
   B1-B3, B5, B6 and B11, over phases 7 and 10 for B4 and over phase 9 for
   B7-B10, ``launches_throughput`` over phase 5, ``launches_streaming``
   over phase 11's timed runs, ``launches_sharded`` over phase 14's (a),
   (b) and (c)'s ranks);
16. the last line: ``{"ok": true, "device": {...}}``.

``--parent DIR`` (a ``git archive`` of another commit, outside the
package directory) runs that commit's phases 3, 5 and 8 in a process of
its own before and after this run, on the same card, its lines prefixed
``[parent 1]`` / ``[parent 2]``, and times that commit's B11 and B8
(built from its sources) beside this one's in phases 3 and 8.
``--int8-repeats N`` runs the card side of phase 4's int8 runs N times,
each held to the grid and to the first.

Exits non-zero, without that last line, when no CUDA device is present,
when the package is missing, or when any check fails.
"""
from __future__ import annotations

import argparse
import copy
import ctypes
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

N_VIDEOS_FULL = 21818
N_QUERIES = 1000
E2E_VIDEOS, E2E_QUERIES = 320, 300     # phase 4, kept small for its CPU side
# the kernels phase 4's card runs must each launch (the study kernels B7-B10
# have their own path, phase 9; B4 and ExCL's kernel are not XML's query path)
MAIN_PATH_KERNELS = ("video_scores_flat_i8", "video_scores_flat", "video_scores_flat_bmax",
                     "span_sim_cat_i8", "topk_transposed", "approx_max_k")
HIDDEN = 256
N_CLIPS = 100
LP = 104
SPAN_LP = 128       # rows per video of the JAX package's flat int8 feat2 cache
CHUNK_V = 16
# the row shapes the engine's psort modes sort at Nv=21,818, V=100, L=100,
# top_n=200: video block maxima, video pool, group block maxima, group
# pool, final span pool
SORT_SHAPES = ((1364, 100), (1600, 100), (1250, 200), (1600, 200), (2800, 200))
# the approximate top-k's sites at Nv=21,818, V=100, L=100, W=14, top_n=200:
# video top-V, span group select (V * L), final span select (top_n * W)
APPROX_SITES = (("video top-V", 21818, 100), ("span group select", 10000, 200),
                ("final span select", 2800, 200))
SHIPPED_RECALL = 0.90       # bench.py's topk_approx_recall
B2_ATOL = 1e-5      # f32 summation-order slack of 256-term unit-vector dots
TIMED_RUNS, WARMUP_RUNS = 10, 2
# TVR's resident float8 byte tables: 100 clips x 3074 (video) / 770 (sub)
# bytes, padded to 1,024-byte multiples and held as (N, 8, W) int8
GATHER_W = {"video": 38528, "sub": 9728}
TRAIN_BSZ, SCAN_STEPS = 128, 8
TRAIN_VIDEOS, TRAIN_QUERIES, TRAIN_EVAL_QUERIES = 1024, 4096, 1024
TRAIN_EPOCHS = 3
TRAIN_LR = 1e-3     # 72 steps must show a falling loss; 1e-4 (the default) is for 100 epochs
LOSS_ATOL = 2e-4    # card vs CPU loss: f32 summation order through the encoders
# published dense peaks of one H100 SXM (NVIDIA data sheet): device memory
# bytes/s, and operations/s by input type (f32 outside the tensor cores;
# "tf32" the tensor cores' TF32 rate, which the f32 kernels' three TF32
# products a multiply-add are counted against)
PEAK_BYTES = 3.35e12
PEAK_OPS = {torch.int8: 1979e12, torch.bfloat16: 989e12, torch.float32: 67e12,
            "tf32": 494.7e12}
TF32X3 = 3          # TF32 products per f32 multiply-add in the 3xTF32 kernels


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, reps: int = 5, blocker=None) -> float:
    """Device time of one ``fn()``, the mean over ``reps`` launches between
    two CUDA events. ``blocker``: a long launch put on the stream first, so
    that the host queues all ``reps`` launches while the device is still
    busy and the events time them back to back; without it a launch shorter
    than the host's time to issue it would measure the host."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    if blocker is not None:
        blocker()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def alternate_ms(plain, kernel, reps: int = 5, blocker=None):
    """plain, kernel, kernel, plain on one card; the mean of each pair."""
    p1, k1, k2, p2 = cuda_ms(plain, reps, blocker), cuda_ms(kernel, reps, blocker), \
        cuda_ms(kernel, reps, blocker), cuda_ms(plain, reps, blocker)
    return (k1 + k2) / 2, (p1 + p2) / 2


def bound(n_bytes: float, n_ops: float, dtype=None) -> dict:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the peak rate of their type."""
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_ops / PEAK_OPS[dtype] * 1e3 if n_ops else 0.0
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def tc_ops(n_ops: float, dtype):
    """Operations of a product on the tensor cores and their peak's key: f32
    multiply-adds as the three TF32 products of the cheapest f32-accurate
    route on this card."""
    return (TF32X3 * n_ops, "tf32") if dtype == torch.float32 else (n_ops, dtype)


def video_score_bound(q, feat, n_out: int) -> dict:
    """B1-B3 at their inputs: two query matrices and two flat caches read
    once, ``n_out`` f32 written; one multiply-add per (query, row, feature)
    and stream (three TF32 products in f32)."""
    n_bytes = 2 * (q.numel() + feat.numel()) * q.element_size() + 4 * n_out
    return bound(n_bytes, *tc_ops(2 * 2 * q.shape[1] * feat.shape[0] * feat.shape[1],
                                  feat.dtype))


def check_tensor_cores(_build) -> str:
    """Phase 2: the kernels run on the tensor cores. In the SASS, each int8
    instance of video_score and each instance of span_sim holds IGMMA (s8
    wgmma) and no IMMA, HMMA or HGMMA; each bf16 instance of video_score
    holds HGMMA (wgmma), every one of the BF16 form, and no HMMA (mma.sync);
    each f32 instance of video_score holds HGMMA, every one of the TF32
    form (the 3xTF32 products, TF32 by no other door), and no HMMA; the
    instances of masked_score the same by kind (every width the wrapper
    takes runs on wgmma, so no mma.sync instance is left there); no
    instance of video_score or masked_score is without tensor-core
    instructions (no FMA kernel is left); the instance of excl_lstm holds
    HMMA (mma.sync), every one of the TF32 form, and no wgmma; that of
    excl_head HGMMA, every one of the TF32 form, and no HMMA; no library
    holds IDP (dp4a)."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    kinds = {"video_score": (("int8", "video_score_wgmma"), ("bf16 wgmma", "Bf16Wg"),
                             ("f32 wgmma", "Tf32x3Wg")),
             "masked_score": (("bf16 wgmma", "MaskedBf16"), ("f32 wgmma", "MaskedTf32x3")),
             "span_sim": (("int8", "span_sim_wgmma"),),
             "excl_lstm": (("f32 mma.sync", "excl_lstm"),),
             "excl_head": (("f32 wgmma", "excl_head"),)}
    # per instance: IGMMA, IMMA, HMMA, HMMA .TF32, HGMMA, HGMMA of the TF32
    # form, HGMMA of the BF16 form
    ok = {"int8": lambda g, i, h, t, w, wt, wb: g > 0 and i == h == w == 0,
          "bf16 wgmma": lambda g, i, h, t, w, wt, wb: w > 0 and wb == w and i == g == h == 0,
          "f32 wgmma": lambda g, i, h, t, w, wt, wb: w > 0 and wt == w and i == g == h == 0,
          "f32 mma.sync": lambda g, i, h, t, w, wt, wb: h > 0 and t == h and i == g == w == 0}
    bad, lines, idp, forms = [], [], 0, set()
    for lib, want in kinds.items():
        sass = subprocess.run([cuobjdump, "-sass", str(_build.library_path(lib))],
                              capture_output=True, text=True, check=True).stdout
        idp += sass.count("IDP")
        functions = [(f.split("\n", 1)[0], f) for f in sass.split("Function : ")[1:]]
        for name, body in functions:
            if not any(key in name for _, key in want):
                bad.append(f"{lib}: {name[:60]} is none of its kinds")
        for what, key in want:
            found = [body for name, body in functions if key in name]
            counts = []
            for body in found:
                hg = [ln.split()[1] for ln in body.splitlines()
                      if "HGMMA" in ln and len(ln.split()) > 1]
                forms.update(op for op in hg if op.startswith("HGMMA"))
                counts.append((body.count("IGMMA"), body.count("IMMA"), body.count("HMMA"),
                               body.count("HMMA.1688.F32.TF32"), len(hg),
                               sum("TF32" in op for op in hg), sum("BF16" in op for op in hg)))
            lines.append(f"{lib} {what}: (IGMMA, IMMA, HMMA, HMMA .TF32, HGMMA, HGMMA TF32, "
                         f"HGMMA BF16) per instance {counts}")
            if not counts or not all(ok[what](*c) for c in counts):
                bad.append(lines[-1])
    if idp or bad:
        raise AssertionError(f"SASS: {'; '.join(bad)}; {idp} IDP; HGMMA forms {sorted(forms)}")
    return f"SASS: {'; '.join(lines)}; {idp} IDP; HGMMA forms {sorted(forms)}"


def probe_mma(dev, _build) -> dict:
    """Phase 2: the tensor-core ceilings on this card (csrc/mma_probe.cu):
    back-to-back mma.sync s8 m16n8k32, bf16 m16n8k16 and tf32 m16n8k8
    products from registers on every SM, at 2 and 4 blocks of 8 warps an
    SM, and wgmma s8 m64n256k32 and bf16 m64n208k16 from shared memory and
    tf32 m64n104k8 with A from registers (B2's instructions at lp = 104), at
    1 and 2 blocks of two warpgroups an SM; the faster of each kept.
    Returns operations/s by input type for mma.sync ("tf32" for the
    third), and "wgmma_s8", "wgmma_bf16" and "wgmma_tf32"."""
    lib = _build.load("mma_probe")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    out = torch.empty(4 * n_sm * 256, device=dev)
    ceiling = {}
    # kind, key, operations a product, products a block and iteration, blocks an SM
    probes = ((0, torch.int8, 16 * 8 * 32 * 2, 8 * 8, (2, 4), "s8 m16n8k32 mma.sync"),
              (1, torch.bfloat16, 16 * 8 * 16 * 2, 8 * 8, (2, 4), "bf16 m16n8k16 mma.sync"),
              (2, "tf32", 16 * 8 * 8 * 2, 8 * 8, (2, 4), "tf32 m16n8k8 mma.sync"),
              (3, "wgmma_s8", 64 * 256 * 32 * 2, 2 * 4, (1, 2), "s8 m64n256k32 wgmma"),
              (4, "wgmma_bf16", 64 * 208 * 16 * 2, 2 * 4, (1, 2), "bf16 m64n208k16 wgmma"),
              (5, "wgmma_tf32", 64 * 104 * 8 * 2, 2 * 4, (1, 2),
               "tf32 m64n104k8 wgmma (A from registers)"))
    iters = 4096            # csrc/mma_probe.cu: 8 warps x 8 chains, or 2 warpgroups x 4 k-steps
    for kind, key, ops, per_iter, per_sms, name in probes:
        rates = []
        for per_sm in per_sms:
            blocks = per_sm * n_sm

            def launch():
                err = lib.tvr_mma_probe(kind, blocks, iters, out.data_ptr(),
                                        torch.cuda.current_stream(dev).cuda_stream)
                if err:
                    raise RuntimeError(f"mma_probe: launch failed with CUDA error {err}")

            ms = cuda_ms(launch, reps=5)
            rates.append(blocks * iters * per_iter * ops / ms * 1e3)
        ceiling[key] = max(rates)
        peak = PEAK_OPS[{"wgmma_s8": torch.int8, "wgmma_bf16": torch.bfloat16,
                         "wgmma_tf32": "tf32"}.get(key, key)]
        log("build", f"{name} probe: {ceiling[key] / 1e12:.1f} TOPS "
            f"({' / '.join(f'{r / 1e12:.1f}' for r in rates)} at "
            f"{' / '.join(map(str, per_sms))} blocks an SM, {n_sm} SMs) = "
            f"{100 * ceiling[key] / peak:.1f}% of the data sheet's {peak / 1e12:.1f}")
    return ceiling


def rate_str(n_ops: float, ms: float, dtype, ceiling) -> str:
    """Operations/s of a kernel as a share of the data sheet's peak and of
    the probed ceilings: of its wgmma probe (int8: s8 m64n256k32, bf16:
    m64n208k16, f32: tf32 m64n104k8) and of its mma.sync probe (f32: TF32
    operations, three a multiply-add)."""
    n_ops, dtype = tc_ops(n_ops, dtype)
    rate = n_ops / ms * 1e3
    probed = ""
    wg_key = {torch.int8: "wgmma_s8", torch.bfloat16: "wgmma_bf16", "tf32": "wgmma_tf32"}
    if ceiling:
        probed = (f", {100 * rate / ceiling[wg_key[dtype]]:.1f}% of the probed wgmma ceiling, "
                  f"{100 * rate / ceiling[dtype]:.1f}% of the probed mma.sync one")
    return (f"{rate / 1e12:.1f} TOPS = {100 * rate / PEAK_OPS[dtype]:.1f}% of the "
            f"{PEAK_OPS[dtype] / 1e12:.1f} peak{probed}")


def gemm_ms(a, rows, chunk: int = 2 ** 18) -> float:
    """Yardstick of a tensor-core kernel: the GEMM alone (no max, no
    rescale) of (M, K) ``a`` by the (R, K) ``rows`` in chunks of ``chunk``
    rows, the chunks' CUDA-event times summed: int8 by ``torch._int_mm``
    (s32 out, 1 GB a chunk at M = 1,000), bf16 and f32 by ``torch.matmul``
    (out in the inputs' type; f32 with TF32 off, a full f32 product). Not
    the kernel's function, so not its library_ms."""
    if a.dtype == torch.float32 and torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("the f32 yardstick needs TF32 off")
    op = torch._int_mm if a.dtype == torch.int8 else torch.matmul
    total = 0.0
    for r0 in range(0, rows.shape[0], chunk):
        bt = rows[r0:r0 + chunk].T
        total += cuda_ms(lambda: op(a, bt), reps=3)
    return total


def bound_str(b: dict) -> str:
    return f"bound {b['bound_ms']:.3f} ms by {b['bound_by']}"


def unit(shape, gen, dev):
    x = torch.randn(shape, generator=gen, device=dev)
    return x / x.norm(dim=-1, keepdim=True)


def phase_kernels(dev, vs, ceiling=None):
    """Phase 3: every kernel against its plain version at the main path's
    shapes. Returns the per-kernel record for the kernels line. ``ceiling``:
    the probed tensor-core rates (phase 2), for the tensor-core kernels'
    share and B1's yardsticks; None when a later commit's ``--parent`` run
    calls this phase alone."""
    from tvretrieval_tpu_torch.ops import _build
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
    rec["B1"] = dict(max_abs_err=0.0, ms=ms, plain_ms=pms, library_ms=None,
                     **video_score_bound(q8["v"], i8["v"], N_QUERIES * nv))
    n_ops = 2 * 2 * N_QUERIES * i8["v"].shape[0] * HIDDEN
    log("kernels", f"B1 video_scores_flat_i8: bit-equal; {ms:.3f} ms "
        f"({rate_str(n_ops, ms, torch.int8, ceiling)}) vs plain {pms:.3f} ms; "
        f"{bound_str(rec['B1'])}, {100 * rec['B1']['bound_ms'] / ms:.1f}% of its rate")
    b1_scores = k
    if ceiling is not None:     # this commit's yardsticks (a --parent run calls this phase too)
        qv8 = q8["v"].T.contiguous()
        ns = ctypes.c_double()
        err = _build.load("video_score").tvr_tensor_map_encode_ns(
            qv8.data_ptr(), i8["v"].data_ptr(), N_QUERIES, i8["v"].shape[0], HIDDEN, 1000,
            ctypes.byref(ns))
        if err:
            raise AssertionError(f"tensor-map encode probe: CUDA error {err}")
        yard = gemm_ms(qv8, i8["v"])
        log("kernels", f"B1 yardstick: torch._int_mm over one stream's operands ((1,000, 256) "
            f"x (2,269,696, 256) int8 -> s32, in row chunks: half of B1's products, written "
            f"out) {yard:.3f} ms = {rate_str(n_ops / 2, yard, torch.int8, None)}; B1's four "
            f"tensor-map encodes {ns.value / 1e3:.2f} us a launch on the host")

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
        bnd = video_score_bound(args[0], args[2], N_QUERIES * nv)
        if name == "bf16":
            rec["B2"] = dict(ms=ms, plain_ms=pms, library_ms=None, **bnd)
        else:
            rec["B2"]["f32"] = dict(max_abs_err=err, ms=ms, plain_ms=pms, **bnd)
        log("kernels", f"B2 video_scores_flat ({name}): max |d| {err:.3e} <= {B2_ATOL}, "
            f"top-100 identical outside near-ties; {ms:.3f} ms "
            f"({rate_str(n_ops, ms, args[2].dtype, ceiling)}) vs plain {pms:.3f} ms; "
            f"{bound_str(bnd)}, {100 * bnd['bound_ms'] / ms:.1f}% of its rate")
    rec["B2"]["max_abs_err"] = b2_err
    if ceiling is not None:     # this commit's yardsticks
        for name, a, rows in (("bf16", qb["v"].T.contiguous(), bf["v"]),
                              ("f32", qf["v"].T.contiguous(), flat["v"])):
            yard = gemm_ms(a, rows)
            log("kernels", f"B2 yardstick ({name}): torch.matmul over one stream's operands "
                f"((1,000, 256) x (2,269,696, 256)^T -> {name}, in row chunks; "
                f"{'TF32 off: full f32 products' if name == 'f32' else 'bf16 out'}: half of "
                f"B2's products, written out, no max) {yard:.3f} ms = "
                f"{rate_str(n_ops / 2, yard, rows.dtype, ceiling)}")

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
        bnd = video_score_bound(args[0], args[2], ks.numel() + kb.numel())
        if name == "int8":
            rec["B3"] = dict(ms=ms, plain_ms=pms, library_ms=None, **bnd)
        else:
            rec["B3"][name] = dict(max_abs_err=err, ms=ms, plain_ms=pms, **bnd)
        log("kernels", f"B3 video_scores_flat_bmax ({name}): max |d| {err:.3e}"
            f"{' (bit-equal)' if exact else ''}, bmax exact, pads -inf; "
            f"{ms:.3f} ms ({rate_str(n_ops, ms, args[2].dtype, ceiling)}) vs plain "
            f"{pms:.3f} ms; {bound_str(bnd)}, "
            f"{100 * bnd['bound_ms'] / ms:.1f}% of its rate")
    rec["B3"]["max_abs_err"] = b3_err
    return rec


def phase_span_sim(dev, vs, ceiling=None):
    """Phase 3, B5: the int8 span sweep at the full corpus against its plain
    version, bit for bit, block of videos by block, in the engine's layout
    (lp = flat_lp(L) = 104 rows a video) and in the JAX package's (lp =
    128)."""
    gen = torch.Generator(device=dev).manual_seed(4)
    nv, nq, k = N_VIDEOS_FULL, N_QUERIES, 2 * HIDDEN
    feat2_cat = torch.randn((nv, N_CLIPS, k), generator=gen, device=dev).to(torch.bfloat16)
    qcat = torch.randn((nq, k), generator=gen, device=dev) * 0.5
    q8, qs = vs.quantize_rows_i8(qcat)
    qs = qs[:, None].contiguous()
    rec = {}
    for lp in (vs.flat_lp(N_CLIPS), SPAN_LP):
        f8, fs = vs.build_flat_feat2_i8(feat2_cat, lp=lp, chunk_v=CHUNK_V)
        nv_pad = fs.shape[0]
        if f8.shape != (nv_pad * lp, k) or nv_pad % CHUNK_V or nv_pad < nv:
            raise AssertionError(f"flat feat2 cache {tuple(f8.shape)} {tuple(fs.shape)}")
        out = vs.span_sim_cat_i8(q8, qs, f8, fs, lp=lp)
        torch.cuda.synchronize()
        if out.shape != (nq, nv_pad, lp) or out.dtype != torch.bfloat16:
            raise AssertionError(f"B5 output {tuple(out.shape)} {out.dtype}")
        block, bad = 512, 0
        for v0 in range(0, nv_pad, block):
            ref = vs.span_sim_int8_xla(q8, qs, f8[v0 * lp:(v0 + block) * lp],
                                       fs[v0:v0 + block], lp=lp)
            bad += int((out[:, v0:v0 + block].view(torch.int16) != ref.view(torch.int16)).sum())
        if bad:
            raise AssertionError(f"B5 (lp={lp}) differs from its plain version at {bad} of "
                                 f"{out.numel()} outputs")
        if bool(out[:, :, N_CLIPS:].any()) or bool(out[:, nv:].any()):
            raise AssertionError(f"B5 (lp={lp}): a pad row or a pad video is not exactly zero")
        if not bool(out[:, :nv, :N_CLIPS].float().abs().amax() > 0):
            raise AssertionError(f"B5 (lp={lp}): the similarity is all zero")
        del out, ref
        kernel = lambda: vs.span_sim_cat_i8(q8, qs, f8, fs, lp=lp)
        if not rec:
            ms, pms = alternate_ms(lambda: vs.span_sim_int8_xla(q8, qs, f8, fs, lp=lp),
                                   kernel, reps=3)
        else:
            ms, pms = cuda_ms(kernel, reps=10), None
        n_out = nq * nv_pad * lp
        n_ops = 2 * nq * f8.shape[0] * k
        bnd = bound(q8.numel() + f8.numel() + 4 * (qs.numel() + fs.numel()) + 2 * n_out,
                    n_ops, torch.int8)
        r = dict(ms=ms, **bnd)
        log("kernels", f"B5 span_sim_cat_i8: Nq={nq} rows={f8.shape[0]} (Nv_pad={nv_pad} x "
            f"{lp}, {100 * (1 - nv * N_CLIPS / f8.shape[0]):.1f}% pad) K={k}: bit-equal over "
            f"{n_out} outputs, pads exactly zero; {ms:.3f} ms "
            f"({rate_str(n_ops, ms, torch.int8, ceiling)})"
            f"{f' vs plain {pms:.3f} ms' if pms is not None else ''}; {bound_str(bnd)}, "
            f"{100 * bnd['bound_ms'] / ms:.1f}% of its rate, "
            f"{2 * n_out / ms / 1e9:.2f} TB/s of bf16 output; caches int8 flat "
            f"{f8.numel() / 1e9:.3f} GB + scales {fs.numel() * 4 / 1e6:.1f} MB")
        if not rec:
            yard = gemm_ms(q8, f8) if ceiling is not None else float("nan")
            if ceiling is not None:
                log("kernels", f"B5 yardstick: torch._int_mm over its operands ((1,000, 512) "
                    f"x ({f8.shape[0]:,}, 512) int8 -> s32, in row chunks: its products, no "
                    f"rescale, 4 bytes an output) {yard:.3f} ms = "
                    f"{rate_str(n_ops, yard, torch.int8, None)}")
            rec = dict(max_abs_err=0.0, plain_ms=pms, library_ms=None, **r)
        else:
            rec[f"lp{lp}"] = r
        del f8, fs
    # the path it replaces: the bf16 sweep of simsweep_cat_bf16 on the same corpus
    flat_bf = torch.nn.functional.pad(feat2_cat, (0, 0, 0, SPAN_LP - N_CLIPS)).reshape(-1, k)
    q_bf = qcat.to(torch.bfloat16)
    rec["replaced_bf16_sweep_ms"] = cuda_ms(lambda: q_bf @ flat_bf.T, reps=3)
    log("kernels", f"B5: the bf16 torch.matmul sweep of simsweep_cat_bf16 on this corpus "
        f"(128 rows a video) {rec['replaced_bf16_sweep_ms']:.3f} ms; its bf16 cache "
        f"{flat_bf.numel() * 2 / 1e9:.3f} GB")
    return rec


def phase_topk_sort(dev, tsort):
    """Phase 3, B6: the sorting top-k at the engine's five row shapes (and a
    small and an n <= k shape) against its plain version, values and
    indices, on rows with planted ties and exact zeros, and on the same rows
    with 0.0 and -0.0 mixed. Times (on the first rows) are summed
    over the five shapes: one query batch's five launches."""
    gen = torch.Generator(device=dev).manual_seed(5)
    big = torch.randn((8192, 8192), generator=gen, device=dev)
    rec = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
               bound_by="bytes", per_shape={})
    for n, k in SORT_SHAPES + ((17, 2), (64, 100)):
        # 65 distinct values, zeros among them: every row is full of ties
        x = torch.round(torch.rand((N_QUERIES, n), generator=gen, device=dev) * 64) / 64
        # and the same rows with half the values negated: 0.0 and -0.0 tie
        flip = torch.rand((N_QUERIES, n), generator=gen, device=dev) < 0.5
        for rows in (x, torch.where(flip, -x, x)):
            kv, ki = tsort.topk_transposed(rows, k)
            torch.cuda.synchronize()
            pv, pi = tsort.topk_transposed_plain(rows, k)
            if kv.shape != (N_QUERIES, min(k, n)) or ki.dtype != torch.int32:
                raise AssertionError(f"B6 ({n}, k={k}): output {tuple(kv.shape)} {ki.dtype}")
            if not (torch.equal(kv, pv) and torch.equal(ki, pi)):
                raise AssertionError(f"B6 ({n}, k={k}) differs from its plain version")
        if (n, k) not in SORT_SHAPES:
            log("kernels", f"B6 topk_transposed ({N_QUERIES}, {n}) k={k}: equal")
            continue
        # launches of tens of microseconds: queued behind a ~20 ms product
        blocker = lambda: torch.mm(big, big)
        ms, pms = alternate_ms(lambda: tsort.topk_transposed_plain(x, k),
                               lambda: tsort.topk_transposed(x, k), reps=32, blocker=blocker)
        lms = cuda_ms(lambda: torch.topk(x, k, dim=-1), reps=32, blocker=blocker)
        bnd = bound(4 * x.numel() + 8 * kv.numel(), 0)
        log("kernels", f"B6 topk_transposed ({N_QUERIES}, {n}) k={k}: values and indices "
            f"equal, ties included; {ms * 1e3:.1f} us vs plain (stable torch.sort) "
            f"{pms * 1e3:.1f} us vs torch.topk {lms * 1e3:.1f} us; bound "
            f"{bnd['bound_ms'] * 1e3:.2f} us by bytes")
        rec["per_shape"][f"{n}_k{k}"] = dict(ms=ms, plain_ms=pms, library_ms=lms,
                                            bound_ms=bnd["bound_ms"])
        for key, val in (("ms", ms), ("plain_ms", pms), ("library_ms", lms),
                         ("bound_ms", bnd["bound_ms"])):
            rec[key] += val
    log("kernels", f"B6, a batch's five launches: {rec['ms'] * 1e3:.1f} us vs plain "
        f"{rec['plain_ms'] * 1e3:.1f} us vs torch.topk {rec['library_ms'] * 1e3:.1f} us; "
        f"bound {rec['bound_ms'] * 1e3:.2f} us, {100 * rec['bound_ms'] / rec['ms']:.1f}% of "
        "its rate")
    return rec


def approx_rows(kind, n, k, gen, dev):
    """Phase 3's B11 inputs, (N_QUERIES, n): random normal; q2c on the int8
    grid with k // 2 values above a level that 3k elements share, so that
    the cut falls among planted ties; one value; normal rows whose last
    third, and whose whole first row, are -inf pads."""
    nq = N_QUERIES
    if kind == "normal":
        return torch.randn((nq, n), generator=gen, device=dev)
    if kind == "int8 grid":
        x = torch.randint(0, 1500, (nq, n), generator=gen, device=dev).float()
        pos = torch.rand((nq, n), generator=gen, device=dev).argsort(dim=1)
        x.scatter_(1, pos[:, :k // 2],
                   torch.randint(1700, 2000, (nq, k // 2), generator=gen, device=dev).float())
        x.scatter_(1, pos[:, k // 2:k // 2 + 3 * k], 1600.0)
        return x * I8_STEP
    if kind == "one value":
        return torch.full((nq, n), 0.375, device=dev)
    x = torch.randn((nq, n), generator=gen, device=dev)
    x[:, n - n // 3:] = -math.inf
    x[0] = -math.inf
    return x


def phase_approx_topk(dev, apx, others=None):
    """Phase 3, B11: the approximate top-k at the engine's three sites
    against its plain version, values (their bits) and indices, on the four
    kinds of ``approx_rows``, at recall 0.90 and 0.99 and, on the video
    site, 1.0 (21,818 bins: more than one pass holds). At recall 0.90 (the
    shipped one), on the normal and on the int8-grid rows: times, queued
    behind a ~20 ms product, against the plain version and the exact
    ``torch.topk``, and on the normal rows the mean tie-aware recall beside
    ((M-1)/M)^(k-1). ``others``: label -> another build of B11 (such as
    ``load_b11``'s), held to the plain version on the timed rows and
    timed in turns with this one; where M = n (the final select), B6 too,
    whose function B11 then is. The record's times are the normal rows',
    summed over the three sites (one batch's three launches); ``per_site``
    holds each site's readings by row kind."""
    from tvretrieval_tpu_torch.ops import sort as tsort
    from tvretrieval_tpu_torch.testing import tie_aware_recall

    others = others or {}
    gen = torch.Generator(device=dev).manual_seed(11)
    big = torch.randn((8192, 8192), generator=gen, device=dev)
    blocker = lambda: torch.mm(big, big)
    rec = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
               bound_by="bytes", library_call="torch.topk (the exact top-k)", per_site={},
               **{f"{label}_ms": 0.0 for label in others})

    def same(got, ref):
        return got[0].shape == ref[0].shape and got[1].dtype == torch.int32 and \
            torch.equal(got[1], ref[1]) and \
            torch.equal(got[0].view(torch.int32), ref[0].view(torch.int32))

    for site, n, k in APPROX_SITES:
        for recall in (0.90, 0.99) + ((1.0,) if n == N_VIDEOS_FULL else ()):
            m = apx.bins(n, k, recall)
            for kind in ("normal", "int8 grid", "one value", "pads"):
                x = approx_rows(kind, n, k, gen, dev)
                kv, ki = apx.approx_max_k(x, k, recall)
                torch.cuda.synchronize()
                if kv.shape != (N_QUERIES, k) or not same((kv, ki),
                                                          apx.approx_max_k_plain(x, k, recall)):
                    raise AssertionError(f"B11 {site} (n={n}, k={k}, recall {recall}, M={m}, "
                                         f"{kind} rows) differs from its plain version")
                if kind == "int8 grid":
                    ties = int((x == kv[:, -1:]).sum(1).min())
                    if ties <= 1:
                        raise AssertionError(f"B11 {site}: no ties planted at the cut")
            x = approx_rows("normal", n, k, gen, dev)
            kv, _ = apx.approx_max_k(x, k, recall)
            got = tie_aware_recall(torch.topk(x, k).values.cpu().numpy(), kv.cpu().numpy())
            predicted = ((m - 1) / m) ** (k - 1)
            note = (f"B11 approx_max_k, {site} ({N_QUERIES}, {n}) k={k} recall {recall}: M={m} "
                    f"bins; values and indices equal on the four kinds of rows (at least {ties} "
                    f"int8-grid elements at the cut); mean recall on normal rows {got:.4f} "
                    + ("(M = n: exact)" if m == n else f"(formula {predicted:.4f})"))
            log("kernels", note)
            if recall != SHIPPED_RECALL:
                continue
            per = rec["per_site"][site] = dict(n=n, k=k, bins=m, recall=got,
                                               recall_formula=predicted)
            for kind in ("normal", "int8 grid"):
                x = x if kind == "normal" else approx_rows(kind, n, k, gen, dev)
                kernel = lambda: apx.approx_max_k(x, k, recall)
                ms, pms = alternate_ms(lambda: apx.approx_max_k_plain(x, k, recall), kernel,
                                       reps=32, blocker=blocker)
                lms = cuda_ms(lambda: torch.topk(x, k, dim=-1), reps=32, blocker=blocker)
                bnd = bound(4 * x.numel() + 8 * N_QUERIES * k, 0)
                r = per[kind] = dict(ms=ms, plain_ms=pms, library_ms=lms,
                                     bound_ms=bnd["bound_ms"],
                                     share_of_bound=bnd["bound_ms"] / ms)
                beside = ""
                b6 = {"B6": lambda x, k, recall: tsort.topk_transposed(x, k)} if m == n else {}
                for label, other in {**others, **b6}.items():
                    if not same(other(x, k, recall), apx.approx_max_k_plain(x, k, recall)):
                        raise AssertionError(f"B11 {site} ({kind} rows): the {label}'s kernel "
                                             "differs from the plain version")
                    this_ms, r[f"{label}_ms"] = alternate_ms(
                        lambda: other(x, k, recall), kernel, reps=32, blocker=blocker)
                    beside += (f"; {label}'s kernel {r[f'{label}_ms'] * 1e3:.1f} us beside this "
                               f"one's {this_ms * 1e3:.1f} (in turns)")
                log("kernels", f"B11 {site} at recall {recall}, {kind} rows: {ms * 1e3:.1f} us "
                    f"vs plain {pms * 1e3:.1f} us vs torch.topk (exact) {lms * 1e3:.1f} us; "
                    f"bound {bnd['bound_ms'] * 1e3:.2f} us by bytes, "
                    f"{100 * r['share_of_bound']:.1f}% of its rate{beside}")
                if kind == "normal":
                    for key, val in r.items():
                        if key in rec:
                            rec[key] += val
    log("kernels", f"B11, a shipped batch's three launches (normal rows): "
        f"{rec['ms'] * 1e3:.1f} us vs plain {rec['plain_ms'] * 1e3:.1f} us vs torch.topk "
        f"{rec['library_ms'] * 1e3:.1f} us; bound {rec['bound_ms'] * 1e3:.2f} us, "
        f"{100 * rec['bound_ms'] / rec['ms']:.1f}% of its rate"
        + "".join(f"; {label}'s kernel {rec[f'{label}_ms'] * 1e3:.1f} us" for label in others))
    return rec


def cache_to(cache, dev):
    return dataclasses.replace(cache, **{
        f.name: getattr(cache, f.name).to(dev) for f in dataclasses.fields(cache)
        if isinstance(getattr(cache, f.name), torch.Tensor)})


I8_STEP = 0.5 / 127 ** 2    # int8 q2c scores are integer multiples of it


def off_grid(name, alpha, outs):
    """The int8 runs' top-V scores lie on the int8 grid on every device:
    log(s) / alpha is a multiple of I8_STEP (the exp / log round trip costs
    ~3e-9 of the 3.1e-5 step). ``outs``: device name -> retrieve arrays.
    Raises, naming the first entry off the grid on each device."""
    bad = []
    for where, out in outs.items():
        n = np.log(out["VR"][2].astype(np.float64)) / alpha / I8_STEP
        off = np.abs(n - np.rint(n))
        if not off.max() <= 1e-2:
            q, r = np.unravel_index(np.argmax(off), off.shape)
            raw = ", ".join(f"{w} video {o['VR'][0][q, r]} score {o['VR'][2][q, r]!r}"
                            for w, o in outs.items())
            bad.append(f"{where}: query {q} rank {r} is {off[q, r]:.3f} of a step off the "
                       f"int8 grid ({raw})")
    for line in bad:
        log("e2e", f"{name}: {line}")
    if bad:
        raise AssertionError(f"end-to-end run {name}: a top-V int8 score is off the grid")


def phase_end_to_end(dev, card_repeats=1):
    """Phase 4: encode_corpus + retrieve on the card (kernels) and on the
    CPU (plain versions) with the same seeded weights; returns the card
    run's metrics. The int8 runs' scores must lie on the int8 grid on both
    devices; ``card_repeats`` > 1 runs each int8 run's card side that many
    times, each on the grid and equal to the first in every array. Also
    returns (world, builder) for phase 10."""
    from tvretrieval_tpu_torch.data.datasets import ExampleBuilder
    from tvretrieval_tpu_torch.data.synthetic import make_synthetic_world
    from tvretrieval_tpu_torch.evaluation.metrics import eval_retrieval_arrays
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
    #   query flips above (per query);
    # - the int8 span modes on identical int8 caches: the integer dots are
    #   exact, so what differs is a quantized span-query component rounding
    #   to its neighbour (one step of 127 in one of 512 components) and, in
    #   the flat mode, the bf16 store: the bf16 tolerance;
    # - the psort selections: a parity mode, exactly equal to the card's own
    #   "f32" run on the same cache, and held to the CPU like it;
    # - the approximate selections at recall 0.90 (B11 on the card, its
    #   plain version on the CPU: one function): the video top-V of 320
    #   videos is exact (M = N), the group select over 100 x 100 starts is
    #   cut into 2,560 bins. On f32 caches, whose 3e-5 slack seldom swaps
    #   the winner of a bin, held to the CPU like the "f32" run.
    base = dict(span_sim_pad_l=128, span_topk_mode="grouped_shift", query_bsz=100)
    psort = dict(span_topk_mode="grouped_shift_psort", video_topk_psort=True, query_bsz=100)
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
        ("int8_all_psort", RetrievalConfig(video_score_mode="pallas_int8",
                                           cache_dtype_str="bfloat16",
                                           span_score_mode="simsweep_cat_int8_flat", **psort),
         int8_tol, 3e-2, True),
        ("int8_span", RetrievalConfig(video_score_mode="pallas_int8", cache_dtype_str="bfloat16",
                                      span_score_mode="simsweep_cat_int8",
                                      span_topk_mode="grouped_shift", query_bsz=100),
         int8_tol, 3e-2, True),
        ("f32_psort", RetrievalConfig(video_score_mode="pallas", cache_dtype_str="float32",
                                      span_score_mode="simsweep_cat", span_sim_pad_l=128,
                                      **psort),
         1e-6, 3e-5, False),
        ("f32_approx", RetrievalConfig(video_score_mode="pallas", cache_dtype_str="float32",
                                       span_score_mode="simsweep_cat", span_sim_pad_l=128,
                                       span_topk_mode="grouped_shift_approx",
                                       video_topk_approx=True,
                                       topk_approx_recall=SHIPPED_RECALL, query_bsz=100),
         1e-6, 3e-5, False),
    ]
    parity = {"f32_psort": "f32"}        # run -> the exact run it must equal on the card
    kept = {}
    clip = world.clip_length
    span_key = lambda v, s: ((v.astype(np.int64) * 1000 + np.rint(s[..., 0] / clip)) * 1000
                             + np.rint(s[..., 1] / clip))
    metrics = None
    for name, rcfg, q2c_tol, span_rtol, share_cache in runs:
        t0 = time.perf_counter()
        cache_gpu = encode_corpus(model_gpu, builder, world.corpus, rcfg)
        if name in parity:
            # score the exact run's own cache, so that only the selection differs
            cache_gpu, ref_out = kept[parity[name]]
        gpu = retrieve(model_gpu, builder, cache_gpu, rows, world.corpus, rcfg,
                       return_arrays=True)
        torch.cuda.synchronize()
        t_gpu = time.perf_counter() - t0
        if name in parity:
            for task, arrays in gpu.items():
                for a, b in zip(arrays, ref_out[task]):
                    if not np.array_equal(a, b):
                        raise AssertionError(f"{name} {task}: the psort selection differs "
                                             f"from the card's own {parity[name]} result")
            note_parity = f"; equal to the card's {parity[name]} run in every array"
        else:
            note_parity = ""
        if name in parity.values():
            kept[name] = (cache_gpu, gpu)
        cache_cpu = encode_corpus(model_cpu, builder, world.corpus, rcfg)
        note = ""
        if share_cache:
            # score the card's int8 bytes on the CPU too, so the plain and
            # kernel video scores see identical inputs; report the flips
            n_flip = sum(int((getattr(cache_cpu, k) != getattr(cache_gpu, k).cpu()).sum())
                         for k in ("video_feat1", "sub_feat1"))
            note = f", int8 feat1 cache bytes differing between devices: {n_flip}"
            cache_cpu = cache_to(cache_gpu, "cpu")
        note += note_parity
        cpu = retrieve(model_cpu, builder, cache_cpu, rows, world.corpus, rcfg,
                       return_arrays=True)
        if rcfg.video_score_mode == "pallas_int8":
            off_grid(name, rcfg.q2c_alpha, {"card": gpu, "CPU": cpu})
            for rep in range(1, card_repeats):
                again = retrieve(model_gpu, builder,
                                 encode_corpus(model_gpu, builder, world.corpus, rcfg), rows,
                                 world.corpus, rcfg, return_arrays=True)
                off_grid(f"{name} (card repeat {rep})", rcfg.q2c_alpha,
                         {"card": again, "CPU": cpu})
                differ = [task for task in gpu
                          if not all(np.array_equal(a, b) for a, b in zip(gpu[task], again[task]))]
                if differ:
                    raise AssertionError(f"{name} card repeat {rep}: {differ} differ from "
                                         "the first card run")
            if card_repeats > 1:
                log("e2e", f"{name}: {card_repeats} card runs, each on the int8 grid and "
                    "equal to the first in every array")
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
            q, r = np.unravel_index(np.argmax(np.abs(got_s - ref_s)), got_s.shape)
            log("e2e", f"{name}: worst top-V entry query {q} rank {r}: card video "
                f"{gpu['VR'][0][q, r]} score {gpu['VR'][2][q, r]!r}, CPU video "
                f"{cpu['VR'][0][q, r]} score {cpu['VR'][2][q, r]!r}")
            raise AssertionError(f"end-to-end run {name}: the card disagrees with the CPU")
        if metrics is None:
            metrics = eval_retrieval_arrays(
                rows, world.corpus.video2idx, vcmr=gpu["VCMR"][:2],
                svmr=gpu["SVMR"][:2], vr=gpu["VR"][0])
    return metrics, (world, builder)


def device_time_ms(prof) -> float:
    """The device's own time in a torch.profiler run: kernels and copies,
    not the operators that launched them nor annotation spans."""
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation) / 1e3


def record_approx(apx, run):
    """``run()`` once with every approx_max_k call's rows, k, recall and
    output recorded: [(x, k, recall, (values, indices))]."""
    calls, original = [], apx.approx_max_k

    def recording(x, k, recall=0.95):
        out = original(x, k, recall)
        calls.append((x, k, recall, out))
        return out

    apx.approx_max_k = recording
    try:
        run()
    finally:
        apx.approx_max_k = original
    return calls


def moments(out):
    """(Nq, top_n) int64 keys of the VCMR moments (global video, st, ed)."""
    vid = torch.gather(out["topv_idx"].long(), 1, out["vcmr_vid_local"].long())
    return (vid * 1000 + out["vcmr_st"].long()) * 1000 + out["vcmr_ed"].long()


def phase_throughput(dev, kernel_rec, profile_dir):
    """Phase 5: _score_query_batch at the full corpus (the bench.py cache,
    synthesized on the card) in five configurations: the exact flagship
    modes over bf16 feat2; bench.py's shipped configuration, the flagship's
    with both approximate selections at recall 0.90 (each site's mean
    tie-aware recall on one batch's own rows against the exact top-k of the
    same rows must reach 0.90; the share of the flagship's top-200 moments
    it returns is reported; both beside their device's busy share); the
    all-int8 psort modes over the int8 flat feat2 cache (beside its busy
    share too), (bf16 parity) the
    flagship's modes with the bf16 video scores B2 over the bf16 flat feat1
    cache in place of B1, and (f32 parity) the same over the engine's
    default f32 caches: the f32 flat feat1 (drawn in f32) scored by B2-f32,
    feat2 f32 as encode_corpus leaves it. Returns the kernel launches summed
    over the five."""
    from tvretrieval_tpu_torch.models.xml import XML, XMLConfig
    from tvretrieval_tpu_torch.ops import _build
    from tvretrieval_tpu_torch.ops import approx_topk as apx
    from tvretrieval_tpu_torch.ops import video_score as vs
    from tvretrieval_tpu_torch.retrieval.engine import (
        RetrievalConfig, _maybe_pad_clip_axis, _score_query_batch)
    from tvretrieval_tpu_torch.testing import tie_aware_recall

    nv, nq = N_VIDEOS_FULL, N_QUERIES
    cfg = XMLConfig(visual_input_size=3074, sub_input_size=770, query_input_size=768,
                    hidden_size=HIDDEN, n_heads=4, max_ctx_l=N_CLIPS, max_desc_l=30)
    model = XML(cfg).init_weights(torch.Generator().manual_seed(0)).eval().to(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    mask = torch.ones((nv, N_CLIPS), device=dev)
    # the bf16 flat caches (the bf16 parity batch) and their int8 quantization
    feat1_bf = [vs.build_flat_feat1(unit((nv, N_CLIPS, HIDDEN), gen, dev).to(torch.bfloat16),
                                    mask, chunk_v=CHUNK_V) for _ in range(2)]
    feat1_i8 = [vs.quantize_unit_i8(f) for f in feat1_bf]
    feat2_raw = torch.cat(
        [torch.randn((nv, N_CLIPS, HIDDEN), generator=gen, device=dev).to(torch.bfloat16)
         for _ in range(2)], dim=-1)
    q_feat = torch.randn((nq, 30, 768), generator=gen, device=dev)
    # the f32 flat caches (f32 parity), drawn in f32 after everything else
    feat1_f32 = [vs.build_flat_feat1(unit((nv, N_CLIPS, HIDDEN), gen, dev), mask,
                                     chunk_v=CHUNK_V) for _ in range(2)]
    feat1_of = {torch.int8: feat1_i8, torch.bfloat16: feat1_bf, torch.float32: feat1_f32}
    q_mask = torch.ones((nq, 30), device=dev)
    gt = torch.zeros((nq,), dtype=torch.long, device=dev)
    n_runs = WARMUP_RUNS + TIMED_RUNS
    no_launch = dict.fromkeys(_build.LAUNCHES, 0)
    configs = [
        ("bf16 flagship",
         RetrievalConfig(cache_dtype_str="bfloat16", span_score_mode="simsweep_cat_bf16",
                         video_score_mode="pallas_int8", span_topk_mode="grouped_shift",
                         span_sim_pad_l=128, video_chunk_v=CHUNK_V),
         {"video_scores_flat_i8": n_runs, "span_sim_cat_i8": 0, "topk_transposed": 0}),
        # bench.py:104-117's defaults
        ("shipped",
         RetrievalConfig(cache_dtype_str="bfloat16", span_score_mode="simsweep_cat_bf16",
                         video_score_mode="pallas_int8", span_topk_mode="grouped_shift_approx",
                         video_topk_approx=True, topk_approx_recall=SHIPPED_RECALL,
                         span_sim_pad_l=128, video_chunk_v=CHUNK_V),
         {"video_scores_flat_i8": n_runs, "approx_max_k": 3 * n_runs, "span_sim_cat_i8": 0,
          "topk_transposed": 0}),
        ("all-int8 psort",
         RetrievalConfig(cache_dtype_str="bfloat16", span_score_mode="simsweep_cat_int8_flat",
                         video_score_mode="pallas_int8", span_topk_mode="grouped_shift_psort",
                         video_topk_psort=True, video_chunk_v=CHUNK_V),
         {"video_scores_flat_i8": n_runs, "span_sim_cat_i8": n_runs,
          "topk_transposed": 5 * n_runs}),
        ("bf16 parity",
         RetrievalConfig(cache_dtype_str="bfloat16", span_score_mode="simsweep_cat_bf16",
                         video_score_mode="pallas", span_topk_mode="grouped_shift",
                         span_sim_pad_l=128, video_chunk_v=CHUNK_V),
         {"video_scores_flat_i8": 0, "video_scores_flat": n_runs, "span_sim_cat_i8": 0,
          "topk_transposed": 0}),
        ("f32 parity",
         RetrievalConfig(cache_dtype_str="float32", span_score_mode="simsweep_cat_bf16",
                         video_score_mode="pallas", span_topk_mode="grouped_shift",
                         span_sim_pad_l=128, video_chunk_v=CHUNK_V),
         {"video_scores_flat_i8": 0, "video_scores_flat": n_runs, "span_sim_cat_i8": 0,
          "topk_transposed": 0}),
    ]
    total, kept = {}, {}
    for name, rcfg, want in configs:
        if rcfg.span_score_mode == "simsweep_cat_int8_flat":
            feat2_cat, feat2_scale = vs.build_flat_feat2_i8(
                feat2_raw, lp=vs.flat_lp(feat2_raw.shape[1]), chunk_v=CHUNK_V)
            feat2_bytes = feat2_cat.numel() + 4 * feat2_scale.numel()
        else:
            # at the cache dtype, as encode_corpus leaves it
            feat2_cat = _maybe_pad_clip_axis(feat2_raw.to(rcfg.cache_dtype), rcfg)
            feat2_scale = None
            feat2_bytes = feat2_cat.numel() * feat2_cat.element_size()
        feat1 = feat1_of[torch.int8 if rcfg.video_score_mode == "pallas_int8"
                         else rcfg.cache_dtype]
        feat1_bytes = sum(f.numel() * f.element_size() for f in feat1)
        run = lambda: _score_query_batch(model, rcfg, q_feat, q_mask, feat1[0], None, feat1[1],
                                         None, mask, gt, True, feat2_cat=feat2_cat,
                                         feat2_cat_scale=feat2_scale)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        # the seeded random feat2 and the other types' feat1 stay on the card
        # beside this configuration's caches; a deployment holds its own alone
        aside = feat2_raw.numel() * 2 + sum(
            f.numel() * f.element_size() for fs in feat1_of.values() if fs is not feat1
            for f in fs)
        held = (torch.cuda.memory_allocated(dev) - aside) / 2**30
        torch.cuda.reset_peak_memory_stats(dev)
        _build.reset_launch_counts()
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
        launches = dict(_build.LAUNCHES)
        if launches != {**no_launch, **want}:
            raise AssertionError(f"throughput run ({name}): kernel launches {launches}, "
                                 f"expected {({**no_launch, **want})}")
        for k, v in out.items():
            if v.is_floating_point() and not bool(torch.isfinite(v).all()):
                raise AssertionError(f"throughput run ({name}): non-finite {k}")
        if (out["vcmr_scores"].shape != (nq, rcfg.max_before_nms)
                or out["topv_idx"].shape != (nq, min(rcfg.max_vcmr_video, nv))):
            raise AssertionError(f"throughput run ({name}): unexpected output shapes")
        peak = (torch.cuda.max_memory_allocated(dev) - aside) / 2**30
        log("throughput", f"{name} ({rcfg.video_score_mode} + {rcfg.span_score_mode} + "
            f"{rcfg.span_topk_mode}{' + video_topk_psort' if rcfg.video_topk_psort else ''}) "
            f"Nq={nq} x Nv={nv}: {ms:.2f} ms per batch = {nq * 1000.0 / ms:.1f} q/s "
            f"({TIMED_RUNS} timed runs after {WARMUP_RUNS}); caches feat1 "
            f"{str(feat1[0].dtype)[6:]} {feat1_bytes / 1e9:.3f} GB + feat2 "
            f"{feat2_bytes / 1e9:.3f} GB; peak memory "
            f"{peak:.2f} GiB ({held:.2f} GiB held before the first batch); launches per "
            f"batch {({k: v // n_runs for k, v in launches.items() if v})}")
        if name in ("bf16 flagship", "shipped", "all-int8 psort"):
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                run()
                torch.cuda.synchronize()
            busy = device_time_ms(prof)
            kept[name] = dict(ms=ms, qps=nq * 1000.0 / ms, device_ms=busy, busy=busy / ms,
                              moments=moments(out))
            log("throughput", f"{name}: {busy:.3f} ms of device time in a batch (profiled) = "
                f"{100 * busy / ms:.1f}% busy of the {ms:.2f} ms measured without the profiler")
        if name == "shipped":
            recalls = []
            for site, (x, k, recall, (vals, _)) in zip(
                    [s for s, _, _ in APPROX_SITES], record_approx(apx, run)):
                m = apx.bins(x.shape[1], k, recall)
                got = tie_aware_recall(torch.topk(x, k).values.cpu().numpy(),
                                       vals.cpu().numpy())
                recalls.append(got)
                log("throughput", f"shipped, {site}: rows ({x.shape[0]}, {x.shape[1]}), k={k}, "
                    f"M={m} bins at recall {recall}: mean tie-aware recall against the exact "
                    f"top-k of the same rows {got:.4f} "
                    + ("(M = n: exact)" if m == x.shape[1]
                       else f"(formula {((m - 1) / m) ** (k - 1):.4f})"))
            flag, ship = kept["bf16 flagship"]["moments"], kept["shipped"]["moments"]
            share = np.mean([len(set(a.tolist()) & set(b.tolist())) / flag.shape[1]
                             for a, b in zip(flag.cpu().numpy(), ship.cpu().numpy())])
            kept["shipped"].update(recalls=recalls, flagship_moments_share=float(share))
            log("throughput", f"shipped vs bf16 flagship: {kept['shipped']['qps']:.1f} vs "
                f"{kept['bf16 flagship']['qps']:.1f} q/s, busy "
                f"{100 * kept['shipped']['busy']:.1f}% vs {100 * kept['bf16 flagship']['busy']:.1f}%; "
                f"the shipped batch returns {100 * share:.2f}% of the flagship's top-"
                f"{flag.shape[1]} moments (video, st, ed)")
            if len(recalls) != 3 or not min(recalls) >= SHIPPED_RECALL:
                raise AssertionError(f"shipped: the approximate sites' mean recalls {recalls} "
                                     f"do not all reach {SHIPPED_RECALL}")
        if profile_dir:
            from torch.profiler import ProfilerActivity, profile
            os.makedirs(profile_dir, exist_ok=True)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                run()
                torch.cuda.synchronize()
            prof.export_chrome_trace(os.path.join(
                profile_dir, f"score_query_batch_{name.replace(' ', '_')}.json"))
            print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25,
                                            max_name_column_width=60), flush=True)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        del feat2_cat, feat2_scale, out, run
    log("throughput", f"B1 at this shape {kernel_rec['B1']['ms']:.3f} ms, B2-bf16 "
        f"{kernel_rec['B2']['ms']:.3f} ms, B2-f32 {kernel_rec['B2']['f32']['ms']:.3f} ms, B5 "
        f"{kernel_rec['B5']['ms']:.3f} ms (lp = {vs.flat_lp(N_CLIPS)}), B6's five "
        f"launches {kernel_rec['B6']['ms']:.3f} ms"
        + (f", B11's three {kernel_rec['B11']['ms']:.3f} ms" if "B11" in kernel_rec else "")
        + f" (phase 3); launches over the {len(configs)} configurations {total}")
    return total


def phase_gather(dev, gt):
    """Phase 6: B4 against index_select on the full TVR byte tables.
    Returns the kernel's record (times summed over the two tables, the two
    launches of one train step)."""
    n, b = N_VIDEOS_FULL, TRAIN_BSZ
    gen = torch.Generator(device=dev).manual_seed(2)
    # a different index set per launch, so no launch finds its rows in the
    # 50 MB L2 left by the one before (a train step gathers fresh rows)
    idx_sets = [torch.randint(0, n, (b,), generator=gen, device=dev, dtype=torch.int32)
                for _ in range(16)]
    idx = idx_sets[0]
    idx[:4] = torch.tensor([0, n - 1, int(idx[5]), int(idx[5])], dtype=torch.int32)
    rec = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
               bound_by="bytes", per_table={})
    big = torch.randn((8192, 8192), generator=gen, device=dev)
    for stream, w in GATHER_W.items():
        table = torch.randint(-128, 128, (n, 8, w), generator=gen, device=dev,
                              dtype=torch.int8)
        row_bytes = 8 * w
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        out = gt.gather_byte_rows(table, idx)
        torch.cuda.synchronize()
        grew = torch.cuda.max_memory_allocated(dev) - held
        if not grew <= b * row_bytes + 2**20:
            raise AssertionError(f"B4 ({stream}): memory rose by {grew} bytes for an "
                                 f"output of {b * row_bytes}: the table was copied")
        ref = gt.gather_byte_rows_plain(table, idx)
        if out.shape != (b, 8, w) or out.dtype != torch.int8 or not torch.equal(out, ref):
            raise AssertionError(f"B4 ({stream}) differs from index_select")
        gt.check_indices(dev)
        del out, ref
        calls = {"plain": 0, "kernel": 0}

        def run(fn, which):
            calls[which] += 1
            return fn(table, idx_sets[calls[which] % len(idx_sets)])

        plain = lambda: run(gt.gather_byte_rows_plain, "plain")
        kernel = lambda: run(gt.gather_byte_rows, "kernel")
        # device time: a launch here is shorter than the host's time to
        # issue it, so the launches queue up behind a ~20 ms product
        ms, pms = alternate_ms(plain, kernel, reps=32, blocker=lambda: torch.mm(big, big))
        # and paced by the host, one call after the other, as a step issues them
        host_ms, host_pms = alternate_ms(plain, kernel, reps=32)
        bnd = bound(2 * b * row_bytes + 4 * b, 0)
        log("gather", f"B4 gather_byte_rows ({stream}): table ({n}, 8, {w}) int8 "
            f"{table.numel() / 2**30:.2f} GiB, B={b}: equal to index_select, memory rose by "
            f"{grew / 2**20:.1f} MiB (output {b * row_bytes / 2**20:.1f} MiB); device time "
            f"{ms * 1e3:.1f} us vs index_select {pms * 1e3:.1f} us; bound "
            f"{bnd['bound_ms'] * 1e3:.1f} us ({2 * b * row_bytes / ms / 1e6:.0f} GB/s of "
            f"{PEAK_BYTES / 1e9:.0f}); issued one by one from the host {host_ms * 1e3:.1f} us "
            f"vs {host_pms * 1e3:.1f} us per call")
        rec["per_table"][stream] = dict(ms=ms, library_ms=pms, bound_ms=bnd["bound_ms"],
                                        host_paced_ms=host_ms, host_paced_library_ms=host_pms)
        rec["ms"] += ms
        rec["plain_ms"] += pms
        rec["library_ms"] += pms
        rec["bound_ms"] += bnd["bound_ms"]
        del table
        torch.cuda.empty_cache()
    return rec


def phase_train(dev, gather_rec, profile_dir):
    """Phase 7: XMLTrainer on the GPU-resident float8 corpus at full width.
    Returns B4's launch count over the train and eval-loss epochs, and the
    resident world and the f32 step time for phase 10."""
    from tvretrieval_tpu_torch.data.datasets import ExampleBuilder
    from tvretrieval_tpu_torch.data.device_corpus import assemble_batch, build_device_data
    from tvretrieval_tpu_torch.data.synthetic import make_synthetic_world
    from tvretrieval_tpu_torch.evaluation.metrics import eval_retrieval_arrays
    from tvretrieval_tpu_torch.models.xml import XML, XMLConfig
    from tvretrieval_tpu_torch.ops import _build
    from tvretrieval_tpu_torch.retrieval.engine import (
        RetrievalConfig, encode_corpus_resident, retrieve)
    from tvretrieval_tpu_torch.training.xml_trainer import (
        LOSS_KEYS, TrainSettings, XMLTrainer)

    t0 = time.perf_counter()
    world = make_synthetic_world(n_videos=TRAIN_VIDEOS, n_queries=TRAIN_QUERIES,
                                 vid_dim=3072, text_dim=768, query_dim=768,
                                 max_clips=N_CLIPS, seed=1)
    builder = ExampleBuilder(
        query_source=world.query_source, video_source=world.video_source,
        sub_source=world.sub_source, ctx_mode="video_sub_tef", max_desc_l=30,
        max_ctx_l=N_CLIPS, clip_length=world.clip_length)
    n_train = TRAIN_QUERIES - TRAIN_EVAL_QUERIES
    train_rows, eval_rows = world.annotations[:n_train], world.annotations[n_train:]
    t1 = time.perf_counter()
    dd = build_device_data(builder, world.corpus, train_rows, eval_rows,
                           dtype_name="float8_e4m3fn", device=dev)
    t2 = time.perf_counter()
    v_bytes, s_bytes = dd.ctx_device["v_bytes"], dd.ctx_device["s_bytes"]
    if (tuple(v_bytes.shape[1:]), tuple(s_bytes.shape[1:])) != \
            ((8, GATHER_W["video"]), (8, GATHER_W["sub"])) or dd.device.type != "cuda":
        raise AssertionError(f"resident tables {tuple(v_bytes.shape)} {tuple(s_bytes.shape)}")
    log("train", f"world {TRAIN_VIDEOS} videos x {N_CLIPS} clips (3072 / 768 features), "
        f"{n_train} + {len(eval_rows)} queries, built in {t1 - t0:.1f} s; resident float8 "
        f"tables {(v_bytes.numel() + s_bytes.numel()) / 2**30:.2f} GiB on the card, built "
        f"and copied in {t2 - t1:.1f} s")

    cfg = XMLConfig(visual_input_size=3074, sub_input_size=770, query_input_size=768,
                    hidden_size=HIDDEN, n_heads=4, max_ctx_l=N_CLIPS, max_desc_l=30)
    settings = TrainSettings(bsz=TRAIN_BSZ, scan_steps=SCAN_STEPS, n_epoch=TRAIN_EPOCHS,
                             lr=TRAIN_LR, seed=0)
    trainer = XMLTrainer(cfg, settings, builder, train_rows, device_data=dd, device=dev)
    steps = trainer.steps_per_epoch
    if steps < 16:
        raise AssertionError(f"{steps} steps per epoch; the phase needs at least 16")

    # the first batch of epoch 0, with the initial weights, dropout off and
    # the same injected negative ranks: the card (B4) against the CPU (plain)
    order = np.arange(n_train)
    np.random.default_rng(settings.seed).shuffle(order)
    chunk = dd.train_queries.chunk(order[:TRAIN_BSZ])
    rank_gen = torch.Generator().manual_seed(3)
    ranks = tuple(torch.randint(1, TRAIN_BSZ, (TRAIN_BSZ,), generator=rank_gen)
                  for _ in range(2))
    model_cpu = XML(cfg).eval()
    model_cpu.load_state_dict(trainer.model.state_dict())
    ctx_cpu = dd.ctx_table.device_arrays("cpu")
    losses = {}
    for name, model, ctx, device in (("card", trainer.model.eval(), dd.ctx_device, dev),
                                     ("cpu", model_cpu, ctx_cpu, "cpu")):
        on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        akw = dd.assemble_kwargs
        _build.reset_launch_counts()
        with torch.no_grad():
            batch = assemble_batch(ctx, *map(on, chunk), max_desc_l=30, **akw)
            _, loss_dict = model(**batch, lw_st_ed=settings.lw_st_ed,
                                 neg_sample_upper=TRAIN_BSZ,
                                 neg_ranks=tuple(r.to(device) for r in ranks))
        if _build.LAUNCHES["gather_byte_rows"] != (2 if name == "card" else 0):
            raise AssertionError(f"first batch on the {name}: B4 launches {_build.LAUNCHES}")
        losses[name] = {k: float(v) for k, v in loss_dict.items()}
    del ctx_cpu, model_cpu
    err = max(abs(losses["card"][k] - losses["cpu"][k]) for k in LOSS_KEYS)
    log("train", f"first batch, initial weights, eval mode: card {losses['card']} vs CPU "
        f"{losses['cpu']}; max |d| {err:.3e} (bound {LOSS_ATOL})")
    if not err <= LOSS_ATOL:
        raise AssertionError(f"first-batch loss on the card differs from the CPU: {err}")

    # training: TRAIN_EPOCHS epochs of `steps` optimizer steps
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launch_counts()
    step_losses, epoch_ms = [], []
    for epoch in range(TRAIN_EPOCHS):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = trainer.train_epoch(epoch)
        end.record()
        end.synchronize()
        epoch_ms.append(start.elapsed_time(end) / steps)
        if out["steps"] != steps:
            raise AssertionError(f"epoch {epoch} ran {out['steps']} of {steps} steps")
        step_losses += [ld["loss_overall"] for ld in trainer.last_step_losses]
    n_steps = TRAIN_EPOCHS * steps
    launches_train = _build.LAUNCHES["gather_byte_rows"]
    if launches_train != 2 * n_steps or trainer.global_step != n_steps:
        raise AssertionError(f"B4 launched {launches_train} times in {n_steps} train steps "
                             f"(global step {trainer.global_step}); expected 2 per step")
    if not np.isfinite(step_losses).all():
        raise AssertionError(f"non-finite train loss: {step_losses}")
    first, last = float(np.mean(step_losses[:4])), float(np.mean(step_losses[-4:]))
    log("train", "loss per step: " + " ".join(f"{x:.4f}" for x in step_losses))
    if not last < first:
        raise AssertionError(f"the loss did not fall: first 4 steps {first}, last 4 {last}")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    step_ms = epoch_ms[-1]
    host_paced = sum(t["host_paced_ms"] for t in gather_rec["per_table"].values())
    log("train", f"{n_steps} steps of batch {TRAIN_BSZ} (scan_steps {SCAN_STEPS}, lr {TRAIN_LR}): "
        f"mean loss {first:.4f} -> {last:.4f}; {step_ms:.2f} ms per step in the last epoch "
        f"(first epoch {epoch_ms[0]:.2f}); B4's two launches take {gather_rec['ms'] * 1e3:.1f} us "
        f"of device time = {100 * gather_rec['ms'] / step_ms:.2f}% of a step, and "
        f"{host_paced * 1e3:.1f} us = {100 * host_paced / step_ms:.2f}% when the host issues "
        f"them one by one; peak memory {peak:.2f} GiB; B4 launches {launches_train}")

    # eval loss over every eval batch: two more launches per batch
    eval_losses = trainer.eval_loss_epoch(eval_rows, TRAIN_EPOCHS - 1)
    n_eval = -(-len(eval_rows) // TRAIN_BSZ)
    launches = _build.LAUNCHES["gather_byte_rows"]
    if launches - launches_train != 2 * n_eval:
        raise AssertionError(f"B4 launched {launches - launches_train} times in {n_eval} "
                             "eval-loss batches; expected 2 per batch")
    if not np.isfinite(list(eval_losses.values())).all():
        raise AssertionError(f"non-finite eval loss: {eval_losses}")
    log("train", f"eval loss over {n_eval} batches: {json.dumps(eval_losses)}")

    # retrieval from the resident corpus, in the trainer's default exact modes
    rcfg = RetrievalConfig(clip_length=world.clip_length)
    t0 = time.perf_counter()
    model = trainer.model.eval()
    cache = encode_corpus_resident(model, dd, world.corpus, rcfg)
    arrays = retrieve(model, builder, cache, eval_rows, world.corpus, rcfg,
                      return_arrays=True, query_table=dd.retrieval_queries)
    torch.cuda.synchronize()
    if cache.video_feat1.shape != (TRAIN_VIDEOS, N_CLIPS, HIDDEN):
        raise AssertionError(f"resident cache shape {tuple(cache.video_feat1.shape)}")
    for task, (vid, spans, scores) in arrays.items():
        if vid.shape[0] != len(eval_rows) or not (np.isfinite(scores).all()
                                                  and np.isfinite(spans).all()):
            raise AssertionError(f"retrieval after training, {task}: bad output")
    metrics = eval_retrieval_arrays(eval_rows, world.corpus.video2idx,
                                    vcmr=arrays["VCMR"][:2], svmr=arrays["SVMR"][:2],
                                    vr=arrays["VR"][0])
    log("train", f"encode_corpus_resident + retrieve ({len(eval_rows)} held-out queries x "
        f"{TRAIN_VIDEOS} videos) in {time.perf_counter() - t0:.2f} s; after {n_steps} steps: "
        + "; ".join(f"{t} {json.dumps(metrics[t])}" for t in ("VCMR", "SVMR", "VR")))
    if _build.LAUNCHES["gather_byte_rows"] != launches:
        raise AssertionError("retrieval from the resident corpus slices; it gathers nothing")
    if profile_dir:
        # one more epoch under the profiler (past t_total the learning rate is 0)
        from torch.profiler import ProfilerActivity, profile
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            trainer.train_epoch(TRAIN_EPOCHS)
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        events = prof.key_averages()
        # the device's own rows: kernels and copies, not the operators that
        # launched them nor the optimizer's annotation span
        kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.is_user_annotation]
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
        log("train", f"profiled epoch of {steps} steps: {busy_ms:.2f} ms of device time and "
            f"{sum(e.count for e in kernels) / steps:.0f} device launches per step; the "
            f"device is busy {100 * busy_ms / step_ms:.1f}% of the {step_ms:.2f} ms step "
            f"measured without the profiler ({wall_ms:.2f} ms per step under it)")
        print(events.table(sort_by="self_cuda_time_total", row_limit=30,
                           max_name_column_width=70), flush=True)
    return launches, dict(builder=builder, dd=dd, train_rows=train_rows, step_ms=step_ms,
                          world=world,
                          settings=settings)


def phase_study_kernels(dev, vs, ceiling=None, parent_b8=None):
    """Phase 8: B7-B10 against their plain versions at corpus scale.
    Returns their records for the kernels line (B9, B10 and B7 in bf16; B9
    and B10 in f32 under "f32"). ``ceiling``: the probed tensor-core rates
    (phase 2), for B9 / B10 as a share of the wgmma and mma.sync ones and
    for their ``torch.matmul`` yardstick; None when a later commit's
    ``--parent`` run calls this phase alone. ``parent_b8``: another
    commit's B8 (``load_parent_b8``), timed beside this one's."""
    from tvretrieval_tpu_torch.ops import fused_score as fsc
    from tvretrieval_tpu_torch.ops import gather as gt
    from tvretrieval_tpu_torch.ops import topk as ttopk
    from tvretrieval_tpu_torch.ops.span import _banded_joint, banded_topk_spans, topk_stable
    from tvretrieval_tpu_torch.profiling.engine_modes import in_query_blocks
    from tvretrieval_tpu_torch.testing import rank_mismatches

    gen = torch.Generator(device=dev).manual_seed(8)
    nv, nq, L, d = N_VIDEOS_FULL, N_QUERIES, N_CLIPS, HIDDEN
    big = torch.randn((8192, 8192), generator=gen, device=dev)
    blocker = lambda: torch.mm(big, big)
    rec = {}

    # ---- B9, B10: random prefix masks, a few fully masked videos planted
    lengths = torch.randint(1, L + 1, (nv,), generator=gen, device=dev)
    mask = (torch.arange(L, device=dev)[None] < lengths[:, None]).float()
    dead = torch.tensor([0, 31, 32, 7777, nv - 1], device=dev)
    mask[dead] = 0.0
    live = torch.ones(nv, dtype=torch.bool, device=dev)
    live[dead] = False
    f32 = {s: unit((nv, L, d), gen, dev) for s in ("v", "s")}
    q32 = {s: unit((nq, d), gen, dev) for s in ("v", "s")}
    mask_t = mask.T[:, None, :].contiguous()

    def same_top100(ref, got, name):
        pv, pi = topk_stable(ref, 100)
        _, ki = topk_stable(got, 100)
        bad = rank_mismatches(pi.cpu(), pv.cpu(), ki.cpu(), atol=2 * B2_ATOL)
        if bad:
            raise AssertionError(f"{name}: top-100 differs at {bad} positions outside near-ties")

    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        fv, fs = f32["v"].to(dtype), f32["s"].to(dtype)
        qv, qs = q32["v"].to(dtype), q32["s"].to(dtype)
        # B9 against the einsum stage, 250 queries at a time (the stage
        # materializes an (Nq, L, Nv) similarity per stream)
        plain = lambda: in_query_blocks(
            lambda sl: vs.video_scores_xla(qv[sl], qs[sl], fv, fs, mask), nq, 250)
        kernel = lambda: vs.video_scores_masked(qv, qs, fv, fs, mask)
        k, p = kernel(), plain()
        torch.cuda.synchronize()
        err = (k[:, live] - p[:, live]).abs().max().item()
        if not err <= B2_ATOL:
            raise AssertionError(f"B9-{tag} max |d| {err} > {B2_ATOL}")
        if not bool((k[:, dead] == -1e10).all()):
            raise AssertionError(f"B9-{tag}: a fully masked video is not exactly -1e10")
        same_top100(p, k, f"B9-{tag}")
        del k, p
        ms, pms = alternate_ms(plain, kernel, reps=3)
        n_ops = 2 * 2 * nq * nv * L * d
        bnd = bound(2 * (qv.numel() + fv.numel()) * qv.element_size() + 4 * mask.numel()
                    + 4 * nq * nv, *tc_ops(n_ops, dtype))
        if dtype == torch.bfloat16:
            rec["B9"] = dict(max_abs_err=err, ms=ms, plain_ms=pms, library_ms=None, **bnd)
        else:
            rec["B9"]["f32"] = dict(max_abs_err=err, ms=ms, plain_ms=pms, **bnd)
        log("study", f"B9 video_scores_masked ({tag}): max |d| {err:.3e} <= {B2_ATOL}, "
            f"{len(dead)} fully masked videos exactly -1e10, top-100 identical outside "
            f"near-ties; {ms:.3f} ms ({rate_str(n_ops, ms, dtype, ceiling)}) vs plain "
            f"(video_scores_xla) {pms:.3f} ms; {bound_str(bnd)}, "
            f"{100 * bnd['bound_ms'] / ms:.1f}% of its rate")
        if ceiling is not None:     # this commit's yardstick
            yard = gemm_ms(qv, fv.view(-1, d))
            log("study", f"B9 / B10 yardstick ({tag}): torch.matmul over one stream's "
                f"operands ((1,000, 256) x (2,181,800, 256)^T -> {tag}, in row chunks; "
                f"{'TF32 off: full f32 products' if tag == 'f32' else 'bf16 out'}: half of "
                f"B9's products, all of B10's, written out, no mask, no max) {yard:.3f} ms = "
                f"{rate_str(n_ops / 2, yard, dtype, ceiling)}")

        # B10: one stream, clip-major copy made once, exp fused and not
        fv_t = fv.transpose(0, 1).contiguous()
        del fs
        for alpha in (20.0, None):
            plain = lambda: fsc.fused_video_scores_xla(qv, fv, mask, alpha)
            kernel = lambda: fsc.fused_video_scores_clip_major(qv, fv_t, mask_t, alpha)
            k, p = kernel(), plain()
            torch.cuda.synchronize()
            if alpha is None:
                err = (k[:, live] - p[:, live]).abs().max().item()
                tol, what, planted = B2_ATOL, "max |d|", -1e10
                same_top100(p, k, f"B10-{tag}")
            else:
                # exp(20 s) turns the 1e-5 slack of s into 2e-4 relative, plus expf's last bits
                err = ((k - p).abs() / p.clamp_min(1e-30))[:, live].max().item()
                tol, what, planted = 3e-4, "max rel |d|", 0.0
            if not err <= tol:
                raise AssertionError(f"B10-{tag} alpha={alpha}: {what} {err} > {tol}")
            if not bool((k[:, dead] == planted).all()):
                raise AssertionError(f"B10-{tag} alpha={alpha}: a fully masked video is not "
                                     f"exactly {planted}")
            del k, p
            ms, pms = alternate_ms(plain, kernel, reps=3)
            n_ops = 2 * nq * nv * L * d
            bnd = bound((qv.numel() + fv.numel()) * qv.element_size() + 4 * mask.numel()
                        + 4 * nq * nv, *tc_ops(n_ops, dtype))
            if alpha is not None:
                # the absolute error is that of alpha=None, filled in below
                r10 = dict(ms=ms, plain_ms=pms, **bnd)
                if dtype == torch.bfloat16:
                    rec["B10"] = dict(library_ms=None, **r10)
                else:
                    rec["B10"]["f32"] = r10
            else:
                (rec["B10"] if dtype == torch.bfloat16 else rec["B10"]["f32"])["max_abs_err"] = err
            log("study", f"B10 fused_video_scores_clip_major ({tag}, alpha={alpha}): {what} "
                f"{err:.3e} <= {tol}, masked videos exactly {planted}; {ms:.3f} ms "
                f"({rate_str(n_ops, ms, dtype, ceiling)}) vs plain (blocked f32 product "
                f"+ max) {pms:.3f} ms; {bound_str(bnd)}, {100 * bnd['bound_ms'] / ms:.1f}% of its rate")
        del fv, fv_t, qv, qs
    del f32, q32, mask, mask_t
    torch.cuda.empty_cache()

    # ---- B7: 101 selected rows a query, duplicates and the boundary rows among them
    v1 = 101
    idx = torch.randint(0, nv, (nq, v1), generator=gen, device=dev)
    idx[0, :3] = torch.tensor([0, nv - 1, nv - 1], device=dev)
    vq, sq = (torch.randn((nq, d), generator=gen, device=dev) * 0.1 for _ in range(2))
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        vf2, sf2 = (torch.randn((nv, L, d), generator=gen, device=dev).to(dtype)
                    for _ in range(2))
        plain = lambda: gt.gathered_similarity_plain(vq, sq, vf2, sf2, idx)
        kernel = lambda: gt.gathered_similarity(vq, sq, vf2, sf2, idx)
        k, p = kernel(), plain()
        torch.cuda.synchronize()
        gt.check_indices(dev)
        if k.shape != (nq, v1, L) or k.dtype != torch.float32:
            raise AssertionError(f"B7-{tag} output {tuple(k.shape)} {k.dtype}")
        err, top = (k - p).abs().max().item(), p.abs().max().item()
        if not err <= 1e-5 * top:
            raise AssertionError(f"B7-{tag} max |d| {err} > 1e-5 x max |sim| {top}")
        del k, p
        ms, pms = alternate_ms(plain, kernel, reps=2)
        n_bytes = (2 * nq * v1 * L * d + 2 * nq * d) * vf2.element_size() \
            + 4 * nq * v1 + 4 * nq * v1 * L
        bnd = bound(n_bytes, 2 * 2 * nq * v1 * L * d, dtype)
        if dtype == torch.bfloat16:
            rec["B7"] = dict(max_abs_err=err, ms=ms, plain_ms=pms, library_ms=None, **bnd)
        log("study", f"B7 gathered_similarity ({tag}): Nq={nq} x {v1} rows of ({L}, {d}) from "
            f"{nv}: max |d| {err:.3e} <= 1e-5 x max |sim| {top:.2f}; {ms:.3f} ms "
            f"({n_bytes / ms / 1e9:.2f} TB/s) vs plain (index, upcast, two f32 einsums, 32 "
            f"queries at a time) {pms:.3f} ms; {bound_str(bnd)}")
        del vf2, sf2
    torch.cuda.empty_cache()

    # ---- B8: near-uniform, peaked, tied and all-equal probabilities
    V, min_l, max_l, top_n = 100, 2, 16, 200
    W = max_l - min_l
    logits = [torch.randn((nq, V, L), generator=gen, device=dev) * 0.3 for _ in range(2)]
    cos = torch.rand((nq, V), generator=gen, device=dev) * 0.2 + 0.3
    vsc = torch.exp(20.0 * torch.sort(cos, dim=1, descending=True).values)
    tied = []
    for x in logits:
        # probabilities on 9 levels with a tail of exact zeros, as softmax
        # underflow leaves at masked clips: every row is full of exact ties
        p = torch.round(torch.softmax(x, -1) * 800) / 800
        p[..., 70:] = 0.0
        tied.append(p)
    # uniform probabilities (softmax of zero logits) and one video score:
    # every in-band joint element holds one value, so every row ties at the
    # row threshold (out-of-band ends stay 0.0)
    flat = torch.softmax(torch.zeros((nq, V, L), device=dev), -1)
    cases = (("near-uniform", [torch.softmax(x, -1) for x in logits], vsc),
             ("peaked", [torch.softmax(x * 20.0, -1) for x in logits], vsc),
             ("tied", tied, vsc),
             ("all-equal", [flat, flat], torch.full_like(vsc, float(vsc[0, 0]))))
    for name, (st, ed), vsc_c in cases:
        plain = lambda: in_query_blocks(lambda sl: banded_topk_spans(
            st[sl], ed[sl], vsc_c[sl], min_l, max_l, top_n), nq, 125)
        kernel = lambda: ttopk.banded_topk_spans_fused(st, ed, vsc_c, min_l, max_l, top_n,
                                                       return_sorted=True)
        k, p = kernel(), plain()
        torch.cuda.synchronize()
        for out_name, a, b in zip(("vid", "st", "ed", "scores"), p, k):
            if b.shape != (nq, top_n) or not torch.equal(a, b):
                raise AssertionError(f"B8 ({name}): {out_name} differs from the plain version")
        share = k[4].float().mean().item() / V
        n_ties = int((k[3][:, 1:] == k[3][:, :-1]).sum())
        # what the row threshold (the top_n-th row best) leaves: rows whose
        # best reaches it, and elements that do
        rows_past = survivors = 0
        for sl in (slice(i, i + 125) for i in range(0, nq, 125)):
            joint = _banded_joint(st[sl], ed[sl], vsc_c[sl], min_l, max_l)
            best = joint.amax(-1).reshape(joint.shape[0], -1)
            cut = torch.topk(best, top_n, dim=1).values[:, -1:]
            rows_past += int((best >= cut).sum())
            survivors += int((joint.reshape(joint.shape[0], -1) >= cut).sum())
            del joint, best
        rows_past, survivors = rows_past / nq, survivors / nq
        del k, p
        ms, pms = alternate_ms(plain, kernel, reps=4, blocker=blocker)
        note = ""
        if parent_b8 is not None:
            pk = parent_b8(st, ed, vsc_c, min_l, max_l, top_n)
            ref = banded_topk_spans(st[:125], ed[:125], vsc_c[:125], min_l, max_l, top_n)
            if not all(torch.equal(a, b[:125]) for a, b in zip(ref, pk)):
                raise AssertionError(f"B8 ({name}): the parent's kernel differs from the plain "
                                     "version")
            par_ms = cuda_ms(lambda: parent_b8(st, ed, vsc_c, min_l, max_l, top_n), reps=4,
                             blocker=blocker)
            ms2 = cuda_ms(kernel, reps=4, blocker=blocker)
            note = f"; parent's kernel {par_ms:.4f} ms beside this one's {ms2:.4f} (in turns)"
        bnd = bound(4 * (2 * st.numel() + vsc_c.numel()) + 16 * nq * top_n, 0)
        if name == "near-uniform":
            rec["B8"] = dict(max_abs_err=0.0, ms=ms, plain_ms=pms, library_ms=None, **bnd)
        log("study", f"B8 banded_topk_spans_fused ({name}): Nq={nq} V={V} L={L} W={W} "
            f"top_n={top_n}: all four outputs equal ({n_ties} adjacent equal scores among the "
            f"selected); rows past the row threshold {rows_past:.1f} of {V * L} "
            f"({100 * rows_past / (V * L):.2f}%), elements reaching it {survivors:.1f} of "
            f"{V * L * W}, videos holding a selected row {100 * share:.1f}%; {ms:.4f} ms vs "
            f"plain (joint + stable torch.sort, 125 queries at a time) {pms:.3f} ms; "
            f"{bound_str(bnd)}, {100 * bnd['bound_ms'] / ms:.1f}% of its rate{note}")
    return rec


# ---------------------------------------------------------------- phase 10
# the XML variants at the flagship's widths (bench.py:62-65): the JAX
# package's encoder choices and ablations, and bf16 compute
VARIANTS = {
    "lstm": dict(encoder_type="lstm"),
    "gru": dict(encoder_type="gru"),
    "cnn": dict(encoder_type="cnn"),
    "video": dict(ctx_mode="video", cross_att=False, merge_two_stream=False),
    "sub": dict(ctx_mode="sub", cross_att=False, merge_two_stream=False),
    "no_merge": dict(merge_two_stream=False),
    "no_cross_att": dict(cross_att=False),
    "cat_linear": dict(span_predictor_type="cat_linear", merge_two_stream=False),
    "stack_conv": dict(stack_conv_predictor_conv_kernel_sizes=(3, 5)),
    "no_modular": dict(no_modular=True),
    "bf16": dict(dtype_str="bfloat16"),
}
# card against CPU on phase 4's corpus, (q2c atol, span rtol): phase 4's
# f32 bounds (1e-6, 3e-5) where the path has the flagship's kinds of ops;
# wider, with the reason:
# - LSTM / GRU: cuDNN sums each recurrent product in its own order, and an
#   error made at one step is carried through the next 99: 10x phase 4's;
# - bf16 compute: a rounding that the card's summation order moves across
#   a bf16 boundary changes the values downstream by about one bf16 step
#   (2^-8 relative): a unit-vector cosine by up to 2^-8, a span logit by a
#   step of itself, its probability by about as much.
VARIANT_TOL = {"lstm": (1e-5, 3e-4), "gru": (1e-5, 3e-4), "bf16": (2.0 ** -8, 0.1)}
# first-batch loss, card against CPU, on phase 7's world: f32 as phase 7;
# bf16 one bf16 step of the loss (a flipped rounding moves a logit by a
# step; the mean over 128 rows does not add such moves up)
BF16_LOSS_RTOL = 2.0 ** -8
VARIANT_STEPS = 16                 # optimizer steps of each trained variant
NO_MERGE_QUERY_BSZ = 100           # the "w/o merge" branch holds (Nq, Nv, L) probabilities


def variant_cfg(name):
    from tvretrieval_tpu_torch.models.xml import XMLConfig
    return XMLConfig(visual_input_size=3074, sub_input_size=770, query_input_size=768,
                     hidden_size=HIDDEN, n_heads=4, max_ctx_l=N_CLIPS, max_desc_l=30,
                     **VARIANTS[name])


def variant_modes(name):
    """A variant's engine modes: with the merged head, phase 4's f32 kernel
    modes (B2-f32 video scores, the f32 concatenated sweep); without it,
    the JAX engine's second branch with an exact span top-k mode (B6 under
    psort). The approximate selection is not held to the CPU here: the
    second branch's one-stream probabilities of random weights are flat,
    so f32 slack swaps bin winners (50 of 600 moments differed on an
    H100); 10b measures its recall instead."""
    from tvretrieval_tpu_torch.retrieval.engine import RetrievalConfig
    if variant_cfg(name).merged_spans:
        return RetrievalConfig(video_score_mode="pallas", cache_dtype_str="float32",
                               span_score_mode="simsweep_cat", span_sim_pad_l=128,
                               span_topk_mode="grouped_shift", query_bsz=100)
    topk = {"video": "grouped_shift_psort", "sub": "grouped",
            "no_merge": "grouped_shift", "cat_linear": "grouped_shift_psort"}[name]
    return RetrievalConfig(span_topk_mode=topk, query_bsz=100)


def phase_variants_e2e(dev, e2e_world):
    """Phase 10a: each variant with seeded weights through encode_corpus +
    retrieve on the card and on the CPU (phase 4's corpus), compared as
    phase 4 compares them; every variant is reported before a failure
    raises."""
    from tvretrieval_tpu_torch.models.xml import XML
    from tvretrieval_tpu_torch.retrieval.engine import encode_corpus, retrieve
    from tvretrieval_tpu_torch.testing import rank_mismatches, within

    world, builder = e2e_world
    rows = world.annotations
    clip = world.clip_length
    span_key = lambda v, s: ((v.astype(np.int64) * 1000 + np.rint(s[..., 0] / clip)) * 1000
                             + np.rint(s[..., 1] / clip))
    def run(model, rcfg):
        with torch.no_grad():
            out = retrieve(model, builder, encode_corpus(model, builder, world.corpus, rcfg),
                           rows, world.corpus, rcfg, return_arrays=True)
        return out, time.perf_counter()

    failed = []
    # the CPU side of a variant runs on a second host thread while the card
    # side runs on this one
    with ThreadPoolExecutor(1) as pool:
        for name in VARIANTS:
            t0 = time.perf_counter()
            rcfg = variant_modes(name)
            model_cpu = XML(variant_cfg(name)).init_weights(
                torch.Generator().manual_seed(0)).eval()
            model_gpu = copy.deepcopy(model_cpu).to(dev)
            cpu_job = pool.submit(run, model_cpu, rcfg)
            gpu, _ = run(model_gpu, rcfg)
            torch.cuda.synchronize()
            t_gpu = time.perf_counter() - t0
            cpu, t_cpu = cpu_job.result()
            q2c_tol, span_rtol = VARIANT_TOL.get(name, (1e-6, 3e-5))
            for task, (vid, spans, scores) in gpu.items():
                if not (np.isfinite(scores).all() and np.isfinite(spans).all()):
                    raise AssertionError(f"variant {name} {task}: non-finite output")
                if vid.shape != cpu[task][0].shape:
                    raise AssertionError(f"variant {name} {task}: shape {vid.shape}")
            ref_s = np.log(cpu["VR"][2].astype(np.float64)) / rcfg.q2c_alpha
            got_s = np.log(gpu["VR"][2].astype(np.float64)) / rcfg.q2c_alpha
            ok = within(ref_s, got_s, atol=q2c_tol)
            bad_v = rank_mismatches(cpu["VR"][0], ref_s, gpu["VR"][0], atol=2 * q2c_tol)
            rtol = span_rtol + np.expm1(rcfg.q2c_alpha * q2c_tol)
            bad_s, span_err = 0, 0.0
            for task in ("VCMR", "SVMR"):
                vid, spans, scores = gpu[task]
                rvid, rspans, rscores = cpu[task]
                span_err = max(span_err, float(np.max(np.abs(scores - rscores)
                                                      / np.maximum(np.abs(rscores), 1e-30))))
                ok = ok and within(rscores, scores, rtol=rtol)
                bad_s += rank_mismatches(span_key(rvid, rspans), rscores, span_key(vid, spans),
                                         rtol=2 * rtol)
            log("variants", f"{name} ({rcfg.video_score_mode} + {rcfg.span_topk_mode}): card "
                f"{t_gpu:.2f} s, CPU {t_cpu - t0:.2f} s (side by side); top-V q2c max |d| "
                f"{np.abs(got_s - ref_s).max():.3e} (tol {q2c_tol:.1e}), ranking mismatches "
                f"outside near-ties {bad_v}; span scores max rel |d| {span_err:.3e} (rtol "
                f"{rtol:.1e}), span mismatches outside near-ties {bad_s}")
            if not ok or bad_v or bad_s:
                failed.append(name)
    if failed:
        raise AssertionError(f"variants {failed}: the card disagrees with the CPU")


def phase_variants_corpus(dev, profile_dir=""):
    """Phase 10b: the "w/o merge" XML through _score_query_batch at the full
    corpus (21,818 videos x 1,000 queries) on the JAX engine's second
    branch: the exact span top-k, grouped_shift_psort (B6; equal to the
    exact run in every output) and grouped_shift_approx at recall 0.90
    (B11; each site's mean tie-aware recall on its own rows). q/s by CUDA
    events over the 1,000 queries in batches of NO_MERGE_QUERY_BSZ, after
    one warm-up batch; peak memory. ``profile_dir``: also a torch.profiler
    table and trace of one batch of the exact run."""
    from tvretrieval_tpu_torch.models.xml import XML
    from tvretrieval_tpu_torch.ops import _build
    from tvretrieval_tpu_torch.ops import approx_topk as apx
    from tvretrieval_tpu_torch.retrieval.engine import RetrievalConfig, _score_query_batch
    from tvretrieval_tpu_torch.testing import tie_aware_recall

    nv, nq, bsz = N_VIDEOS_FULL, N_QUERIES, NO_MERGE_QUERY_BSZ
    model = XML(variant_cfg("no_merge")).init_weights(
        torch.Generator().manual_seed(0)).eval().to(dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    mask = torch.ones((nv, N_CLIPS), device=dev)
    # the cache encode_corpus leaves for this configuration: both streams'
    # feat1 (unit rows) and feat2, f32, unflattened
    vf1, sf1 = (unit((nv, N_CLIPS, HIDDEN), gen, dev) for _ in range(2))
    vf2, sf2 = (torch.randn((nv, N_CLIPS, HIDDEN), generator=gen, device=dev) for _ in range(2))
    q_feat = torch.randn((nq, 30, 768), generator=gen, device=dev)
    q_mask = torch.ones((nq, 30), device=dev)
    gt = torch.randint(0, nv, (nq,), generator=gen, device=dev)
    cache_gb = 4 * (vf1.numel() + sf1.numel() + vf2.numel() + sf2.numel()) / 1e9
    batches = [slice(i, i + bsz) for i in range(0, nq, bsz)]
    out = {}
    for topk in ("grouped_shift", "grouped_shift_psort", "grouped_shift_approx"):
        rcfg = RetrievalConfig(span_topk_mode=topk, topk_approx_recall=SHIPPED_RECALL,
                               query_bsz=bsz)
        run = lambda b: _score_query_batch(model, rcfg, q_feat[b], q_mask[b], vf1, vf2, sf1,
                                           sf2, mask, gt[b], True)
        run(batches[0])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev) / 2**30
        before = dict(_build.LAUNCHES)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        res = [run(b) for b in batches]
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
        launches = {k: v - before[k] for k, v in _build.LAUNCHES.items()}
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        out[topk] = {k: torch.cat([r[k] for r in res]) for k in res[0]}
        for k, v in out[topk].items():
            if v.is_floating_point() and not bool(torch.isfinite(v).all()):
                raise AssertionError(f"w/o merge ({topk}): non-finite {k}")
        want = {"grouped_shift": {"topk_transposed": 0, "approx_max_k": 0},
                "grouped_shift_psort": {"approx_max_k": 0},
                "grouped_shift_approx": {"topk_transposed": 0}}[topk]
        used = "topk_transposed" if topk.endswith("psort") else "approx_max_k"
        if any(launches[k] != n for k, n in want.items()) or (
                topk != "grouped_shift" and not launches[used] > 0):
            raise AssertionError(f"w/o merge ({topk}): kernel launches {launches}")
        if profile_dir and topk == "grouped_shift":
            from torch.profiler import ProfilerActivity, profile
            os.makedirs(profile_dir, exist_ok=True)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                run(batches[0])
                torch.cuda.synchronize()
            prof.export_chrome_trace(os.path.join(profile_dir, "score_query_batch_no_merge.json"))
            log("variants", f"w/o merge: {device_time_ms(prof):.3f} ms of device time in one "
                f"batch of {bsz} (profiled)")
            print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25,
                                            max_name_column_width=60), flush=True)
        log("variants", f"w/o merge, {topk}: Nq={nq} x Nv={nv} in {len(batches)} batches of "
            f"{bsz}: {ms:.1f} ms = {nq * 1000.0 / ms:.1f} q/s; f32 cache {cache_gb:.2f} GB; "
            f"peak memory {peak:.2f} GiB ({held:.2f} GiB held before); launches "
            f"{({k: v for k, v in launches.items() if v})}")
        if topk == "grouped_shift_approx":
            recalls = []
            calls = record_approx(apx, lambda: run(batches[0]))
            for (x, k, recall, (vals, _)), site in zip(calls, ("span group select",
                                                               "final span select")):
                got = tie_aware_recall(torch.topk(x, k).values.cpu().numpy(),
                                       vals.cpu().numpy())
                recalls.append(got)
                m = apx.bins(x.shape[1], k, recall)
                log("variants", f"w/o merge, approx, {site}: rows ({x.shape[0]}, "
                    f"{x.shape[1]}), k={k}, M={m} bins: mean tie-aware recall {got:.4f}")
            if len(calls) != 2 or not min(recalls) >= SHIPPED_RECALL:
                raise AssertionError(f"w/o merge approx: recalls {recalls} of {len(calls)} "
                                     f"sites, target {SHIPPED_RECALL}")
    for k, v in out["grouped_shift"].items():
        if not torch.equal(v, out["grouped_shift_psort"][k]):
            raise AssertionError(f"w/o merge: the psort run's {k} differs from the exact run")
    log("variants", "w/o merge: the psort run equals the exact run in every output")
    del vf1, sf1, vf2, sf2


def phase_variants_train(dev, env):
    """Phase 10c: the bf16 and the LSTM XML trained on phase 7's resident
    float8 world: the first batch's loss on the card against the CPU, two
    epochs of VARIANT_STEPS optimizer steps (finite, falling loss; B4 twice
    a step), ms a step in the second beside phase 7's f32 step."""
    from tvretrieval_tpu_torch.data.device_corpus import assemble_batch
    from tvretrieval_tpu_torch.models.xml import XML
    from tvretrieval_tpu_torch.ops import _build
    from tvretrieval_tpu_torch.training.xml_trainer import LOSS_KEYS, XMLTrainer

    dd, builder, rows = env["dd"], env["builder"], env["train_rows"]
    # phase 7's settings (its learning-rate schedule over 3 epochs), each
    # epoch cut to VARIANT_STEPS steps
    settings = dataclasses.replace(env["settings"], debug_max_steps=VARIANT_STEPS)
    for name in ("bf16", "lstm"):
        trainer = XMLTrainer(variant_cfg(name), settings, builder, rows, device_data=dd,
                             device=dev)
        order = np.arange(len(rows))
        np.random.default_rng(settings.seed).shuffle(order)
        chunk = dd.train_queries.chunk(order[:TRAIN_BSZ])
        rank_gen = torch.Generator().manual_seed(3)
        ranks = tuple(torch.randint(1, TRAIN_BSZ, (TRAIN_BSZ,), generator=rank_gen)
                      for _ in range(2))
        model_cpu = XML(variant_cfg(name)).eval()
        model_cpu.load_state_dict(trainer.model.state_dict())
        ctx_cpu = dd.ctx_table.device_arrays("cpu")
        losses = {}
        for where, model, ctx, device in (("card", trainer.model.eval(), dd.ctx_device, dev),
                                          ("cpu", model_cpu, ctx_cpu, "cpu")):
            on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
            with torch.no_grad():
                batch = assemble_batch(ctx, *map(on, chunk), max_desc_l=30,
                                       **dd.assemble_kwargs)
                _, loss_dict = model(**batch, lw_st_ed=settings.lw_st_ed,
                                     neg_sample_upper=TRAIN_BSZ,
                                     neg_ranks=tuple(r.to(device) for r in ranks))
            losses[where] = {k: float(v) for k, v in loss_dict.items()}
        del ctx_cpu, model_cpu
        err = max(abs(losses["card"][k] - losses["cpu"][k]) for k in LOSS_KEYS)
        tol = (BF16_LOSS_RTOL * max(abs(losses["cpu"][k]) for k in LOSS_KEYS)
               if name == "bf16" else LOSS_ATOL)
        if not err <= tol:
            raise AssertionError(f"{name}: first-batch loss card {losses['card']} vs CPU "
                                 f"{losses['cpu']}: {err} > {tol}")
        b4_before = _build.LAUNCHES["gather_byte_rows"]
        trainer.train_epoch(0)                  # the first epoch warms up; the second is timed
        step_losses = [ld["loss_overall"] for ld in trainer.last_step_losses]
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = trainer.train_epoch(1)
        end.record()
        end.synchronize()
        step_ms = start.elapsed_time(end) / out["steps"]
        step_losses += [ld["loss_overall"] for ld in trainer.last_step_losses]
        first, last = float(np.mean(step_losses[:4])), float(np.mean(step_losses[-4:]))
        if not (np.isfinite(step_losses).all() and last < first):
            raise AssertionError(f"{name}: losses {step_losses}")
        b4 = _build.LAUNCHES["gather_byte_rows"] - b4_before
        if b4 != 4 * VARIANT_STEPS:
            raise AssertionError(f"{name}: B4 launched {b4} times in {2 * VARIANT_STEPS} steps")
        log("variants", f"train {name}: first batch card vs CPU max |d| {err:.3e} (bound "
            f"{tol:.1e}); {len(step_losses)} steps of batch {TRAIN_BSZ}: {step_ms:.2f} ms a step "
            f"in the second epoch vs phase 7's f32 {env['step_ms']:.2f} ms; mean loss of the "
            f"first / last 4 steps "
            f"{first:.4f} -> {last:.4f}")
        del trainer
        torch.cuda.empty_cache()


def phase_variants(dev, e2e_world, train_env, profile_dir=""):
    """Phase 10: the XML variants; returns the kernel launches it made
    (counts set to 0 before it, read after it)."""
    from tvretrieval_tpu_torch.ops import _build

    _build.reset_launch_counts()
    t0 = time.perf_counter()
    phase_variants_e2e(dev, e2e_world)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    phase_variants_corpus(dev, profile_dir)
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    phase_variants_train(dev, train_env)
    launches = dict(_build.LAUNCHES)
    log("variants", f"phase 10 took {time.perf_counter() - t0:.1f} s (10a {t1 - t0:.1f} s, "
        f"10b {t2 - t1:.1f} s, 10c {time.perf_counter() - t2:.1f} s); kernel launches "
        f"{({k: v for k, v in launches.items() if v})}")
    for k in ("video_scores_flat", "topk_transposed", "approx_max_k", "gather_byte_rows"):
        if not launches[k]:
            raise AssertionError(f"phase 10 did not launch {k}: {launches}")
    return launches


# phase 11: the streaming engine at the full corpus (see phase_streaming)
STREAM_BLOCK = 2048                # retrieve's streaming_block_videos default
STREAM_BSZ = 50                    # RetrievalConfig.query_bsz's default
STREAM_CHECK_QUERIES = 200         # held against the resident engine
STREAM_HALF = N_VIDEOS_FULL // 2   # the second corpus size of the memory check
STREAM_MASKED = 7                  # the fully masked video
STREAM_Q2C_ATOL = 1e-6             # phase 4's f32 q2c bound: summation order alone
STREAM_RTOL = 1e-5
STREAM_MEMORY_RTOL = 0.05
PROBE_BYTES = 100 * 2**20          # the pinned host-to-device copy probe: block-sized
PROBE_COPIES = 30                  # the probe's rate is the best of this many copies


def stream_cache(dev):
    """Phase 11's encoded cache as encode_corpus leaves it in video mode
    "einsum" and span mode "gather" (the layout the streaming path pulls to
    host memory), synthesized on the card: 21,818 videos of 1-100 clips,
    f32 unit feat1 rows and N(0, 1) feat2 rows, video STREAM_MASKED fully
    masked with zero feat1 rows."""
    from tvretrieval_tpu_torch.retrieval.engine import CorpusCache

    nv = N_VIDEOS_FULL
    gen = torch.Generator(device=dev).manual_seed(4)
    lengths = torch.randint(1, N_CLIPS + 1, (nv,), generator=gen, device=dev)
    lengths[STREAM_MASKED] = 0
    mask = (torch.arange(N_CLIPS, device=dev)[None] < lengths[:, None]).float()
    vf1, sf1 = (unit((nv, N_CLIPS, HIDDEN), gen, dev) for _ in range(2))
    vf1[STREAM_MASKED] = 0
    sf1[STREAM_MASKED] = 0
    vf2, sf2 = (torch.randn((nv, N_CLIPS, HIDDEN), generator=gen, device=dev) for _ in range(2))
    metas = [{"vid_name": f"v{i}", "duration": 150.0} for i in range(nv)]
    return CorpusCache(vf1, vf2, sf1, sf2, mask, nv, metas)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def compare_streaming(mode, so, ro, alpha):
    """Phase 11's equality of the streaming engine (``so``) with the resident
    engine (``ro``) over the same queries; returns a line for the log.
    flat_int8: top-V indices, order and scores equal (integer video
    scores); otherwise the top-V q2c within STREAM_Q2C_ATOL, the indices
    equal outside near-ties, topv_scores within STREAM_RTOL. Both: VCMR
    scores within STREAM_RTOL, the moments equal outside near-ties, SVMR
    equal (outside near-ties, scores within 1e-6), the fully masked video
    in no top-V."""
    from tvretrieval_tpu_torch.testing import rank_mismatches, within

    so, ro = ({k: v.cpu().numpy() for k, v in o.items()} for o in (so, ro))
    q2c = lambda o: np.log(o["topv_scores"].astype(np.float64)) / alpha
    if mode == "flat_int8":
        ok = (np.array_equal(so["topv_idx"], ro["topv_idx"])
              and np.array_equal(so["topv_scores"], ro["topv_scores"]))
    else:
        ok = (within(q2c(ro), q2c(so), atol=STREAM_Q2C_ATOL)
              and rank_mismatches(ro["topv_idx"], q2c(ro), so["topv_idx"],
                                  atol=2 * STREAM_Q2C_ATOL) == 0
              and within(ro["topv_scores"], so["topv_scores"], rtol=STREAM_RTOL))
    keys = lambda o, task: ((np.take_along_axis(o["topv_idx"], o["vcmr_vid_local"], 1)
                             .astype(np.int64) if task == "vcmr" else 0) * 1000
                            + o[f"{task}_st"].astype(np.int64)) * 1000 + o[f"{task}_ed"]
    ok = ok and within(ro["vcmr_scores"], so["vcmr_scores"], rtol=STREAM_RTOL)
    bad_v = rank_mismatches(keys(ro, "vcmr"), ro["vcmr_scores"], keys(so, "vcmr"),
                            rtol=2 * STREAM_RTOL)
    ok = ok and within(ro["svmr_scores"], so["svmr_scores"], rtol=1e-6)
    bad_s = rank_mismatches(keys(ro, "svmr"), ro["svmr_scores"], keys(so, "svmr"), rtol=2e-6)
    masked = STREAM_MASKED in so["topv_idx"] or STREAM_MASKED in ro["topv_idx"]
    same = [k for k in ro if np.array_equal(ro[k], so[k])]
    line = (f"top-V q2c max |d| {np.abs(q2c(so) - q2c(ro)).max():.3e}, top-V indices equal "
            f"{np.array_equal(so['topv_idx'], ro['topv_idx'])}, VCMR scores max rel |d| "
            f"{np.max(np.abs(so['vcmr_scores'] - ro['vcmr_scores']) / np.abs(ro['vcmr_scores'])):.3e}, "
            f"moment mismatches outside near-ties VCMR {bad_v} / SVMR {bad_s}; bit-equal: "
            f"{same}")
    if not ok or bad_v or bad_s or masked:
        raise AssertionError(f"streaming {mode} differs from the resident engine: {line}; "
                             f"masked video in a top-V: {masked}")
    return line


def compare_shipped(mode, so, ro):
    """Phase 11's equality of the timed runs (the shipped span selection,
    B11 twice a batch), streaming (``so``) against resident (``ro``) over
    the same queries; returns a line for the log. A query whose top-V
    indices and scores are bit-equal in both gives B11 bit-equal rows at
    both sites, so each of its outputs must be bit-equal. flat_int8 (integer
    video scores) must have every query so; the other modes may have a few
    with the top-V apart by summation order or the order of equal scores,
    which the exact-span comparison holds instead."""
    so, ro = ({k: v.cpu().numpy() for k, v in o.items()} for o in (so, ro))
    same_v = ((so["topv_idx"] == ro["topv_idx"]).all(1)
              & (so["topv_scores"] == ro["topv_scores"]).all(1))
    differ = {k: int((~(so[k] == ro[k]).reshape(len(same_v), -1).all(1) & same_v).sum())
              for k in ro}
    line = (f"{int(same_v.sum())} of {len(same_v)} queries with bit-equal top-V; among them "
            f"queries with an output not bit-equal: {differ}")
    if (mode == "flat_int8" and not same_v.all()) or any(differ.values()):
        raise AssertionError(f"streaming {mode}, shipped spans, differs from the resident "
                             f"engine: {line}")
    return line


def phase_streaming(dev):
    """Phase 11: the streaming engine (retrieval.streaming) at the full
    corpus, in its three host modes. For each: the encoded cache (phase 11's
    synthesized one, f32) pulled into pinned host memory; B1 (flat_int8) /
    B2 (flat) on the first and the last, zero-filled streamed block against
    their plain versions; 200 queries against the resident engine on the
    card (span mode "gather", the matching video mode, exact spans); 1,000
    queries in batches of 50 with the shipped span selection (B11 at
    recall 0.90), counts set to 0 before and read after (B1 / B2 once a
    block, B11 twice a batch), q/s beside the resident engine's, per block
    copy and score ms from events on the two streams, the overlap share,
    the host-to-device rate against a pinned-copy probe, phase 2's host
    gather and feat2 copy, peak device memory at 10,909 and 21,818 videos
    (equal within 5%, below the resident cache); the timed runs' first 200
    queries streaming against resident (bit-equal where the top-V is); B11
    at both span sites of a batch bit-equal to its plain version, and its
    recall. Then the flagship forward entry point
    (``tvretrieval_tpu_torch.entry``) on the card against the CPU. Returns
    the kernel launches of the timed runs."""
    from tvretrieval_tpu_torch.entry import entry
    from tvretrieval_tpu_torch.models.xml import XML, XMLConfig, l2_normalize
    from tvretrieval_tpu_torch.ops import _build
    from tvretrieval_tpu_torch.ops import approx_topk as apx
    from tvretrieval_tpu_torch.ops import video_score as vs
    from tvretrieval_tpu_torch.retrieval import streaming as st
    from tvretrieval_tpu_torch.retrieval.engine import RetrievalConfig, _score_query_batch
    from tvretrieval_tpu_torch.testing import tie_aware_recall

    t_phase = time.perf_counter()
    nv, bsz, block = N_VIDEOS_FULL, STREAM_BSZ, STREAM_BLOCK
    n_blocks = -(-nv // block)
    model = XML(XMLConfig(visual_input_size=3074, sub_input_size=770, query_input_size=768,
                          hidden_size=HIDDEN, n_heads=4, max_ctx_l=N_CLIPS, max_desc_l=30)
                ).init_weights(torch.Generator().manual_seed(0)).eval().to(dev)
    cache = stream_cache(dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    q_feat = torch.randn((N_QUERIES, 30, 768), generator=gen, device=dev)
    q_mask = torch.ones((N_QUERIES, 30), device=dev)
    gt = torch.randint(0, nv, (N_QUERIES,), generator=gen, device=dev)
    batches = [slice(i, i + bsz) for i in range(0, N_QUERIES, bsz)]
    check = batches[:STREAM_CHECK_QUERIES // bsz]
    # the rate a host-to-device copy from pinned memory reaches on this card:
    # the best of PROBE_COPIES block-sized copies, each timed by events on a
    # stream of its own, as the streamed blocks are
    probe = torch.empty(PROBE_BYTES, dtype=torch.uint8, pin_memory=True)
    probe_dst = torch.empty(PROBE_BYTES, dtype=torch.uint8, device=dev)
    probe_stream = torch.cuda.Stream(dev)
    probe_ev = [[torch.cuda.Event(enable_timing=True) for _ in range(2)]
                for _ in range(PROBE_COPIES)]
    torch.cuda.synchronize()
    with torch.cuda.stream(probe_stream):
        for a, b in probe_ev:
            a.record()
            probe_dst.copy_(probe, non_blocking=True)
            b.record()
    probe_stream.synchronize()
    probe_all = [a.elapsed_time(b) for a, b in probe_ev]
    probe_ms = min(probe_all)
    probe_gbs = PROBE_BYTES / probe_ms / 1e6
    del probe, probe_dst
    log("streaming", f"pinned host-to-device probe: {PROBE_COPIES} copies of "
        f"{PROBE_BYTES / 2**20:.0f} MiB on a stream of their own, best {probe_ms:.3f} ms = "
        f"{probe_gbs:.2f} GB/s (mean {PROBE_BYTES / np.mean(probe_all) / 1e6:.2f} GB/s, "
        f"worst {PROBE_BYTES / max(probe_all) / 1e6:.2f} GB/s)")
    # the resident flat layout cannot hold a fully masked video: it gets one
    # valid clip there, its zero feat1 rows score 0, far below every top-V of
    # this corpus (held below: it is in no top-V)
    flat_mask = cache.mask.clone()
    flat_mask[STREAM_MASKED, 0] = 1
    no_launch = dict.fromkeys(_build.LAUNCHES, 0)
    kernel = {"flat": "video_scores_flat", "flat_int8": "video_scores_flat_i8"}
    total = dict(no_launch)
    for mode in ("einsum", "flat", "flat_int8"):
        t_mode = time.perf_counter()
        flat, int8 = mode != "einsum", mode == "flat_int8"
        base = dict(span_score_mode="gather", query_bsz=bsz, video_chunk_v=CHUNK_V,
                    video_score_mode={"einsum": "einsum", "flat": "pallas",
                                      "flat_int8": "pallas_int8"}[mode])
        exact_cfg = RetrievalConfig(**base, span_topk_mode="grouped_shift")
        ship_cfg = RetrievalConfig(**base, span_topk_mode="grouped_shift_approx",
                                   topk_approx_recall=SHIPPED_RECALL)
        if flat:
            res_f1 = [vs.build_flat_feat1(f, flat_mask, chunk_v=CHUNK_V)
                      for f in (cache.video_feat1, cache.sub_feat1)]
            if int8:
                res_f1 = [vs.quantize_unit_i8(f) for f in res_f1]
        else:
            res_f1 = [cache.video_feat1, cache.sub_feat1]
        resident_gb = nbytes(*res_f1, cache.video_feat2, cache.sub_feat2, cache.mask) / 1e9
        resident = lambda cfg, b: _score_query_batch(
            model, cfg, q_feat[b], q_mask[b], res_f1[0], cache.video_feat2, res_f1[1],
            cache.sub_feat2, cache.mask, gt[b], True)
        t0 = time.perf_counter()
        host = st.host_cache_from_device(cache, flat=flat, int8=int8)
        host_s = time.perf_counter() - t0
        host_parts = (host.video_feat1, host.sub_feat1, host.video_feat2, host.sub_feat2,
                      host.mask, host.video_valid)
        feat1_batch_bytes = nbytes(host.video_feat1, host.sub_feat1,
                                   host.video_valid if flat else host.mask)
        streamed = lambda cfg, b, h=host, **kw: st.streaming_score_query_batch(
            model, cfg, q_feat[b], q_mask[b], h, gt_meta_idx=gt[b] % h.n_videos,
            block_videos=block, **kw)

        # one streamed block's kernel output against its plain version: the
        # first block and the last, zero-filled one
        block_err = None
        if flat:
            with torch.no_grad():
                vq, sq = model.encode_query(q_feat[check[0]], q_mask[check[0]])
            if int8:
                qv, qs = (vs.quantize_unit_i8(l2_normalize(q)).T for q in (vq, sq))
            else:
                qv, qs = (l2_normalize(q).to(host.video_feat1.dtype).T for q in (vq, sq))
            score = getattr(vs, kernel[mode])
            errs = []
            for off, (fv, fs, _) in st._device_blocks(host, block, dev, None):
                if off in (0, (n_blocks - 1) * block):
                    got = score(qv, qs, fv, fs, n_videos=block, lp=host.lp)
                    want = vs.video_scores_flat_plain(qv, qs, fv, fs, block, host.lp)
                    errs.append(float((got - want).abs().max()))
            block_err = max(errs)
            bound = 0.0 if int8 else B2_ATOL
            log("streaming", f"{mode}: {kernel[mode]} on the first and the last (zero-filled) "
                f"streamed block of {block} videos against its plain version: max |d| "
                f"{errs} (bound {bound:.0e}: {'bit-equal' if int8 else 'f32 summation order'})")
            if not block_err <= bound:
                raise AssertionError(f"streaming {mode}: streamed-block kernel off its plain "
                                     f"version by {errs}")

        # equal to the resident engine on the card
        pairs = [(streamed(exact_cfg, b), resident(exact_cfg, b)) for b in check]
        cat = lambda outs: {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
        line = compare_streaming(mode, cat([p[0] for p in pairs]), cat([p[1] for p in pairs]),
                                 exact_cfg.q2c_alpha)
        log("streaming", f"{mode} against the resident engine ({exact_cfg.video_score_mode} "
            f"+ gather, grouped_shift), {STREAM_CHECK_QUERIES} queries: {line}")
        del pairs

        # the timed run: counts from 0, the shipped span selection
        _build.reset_launch_counts()
        times = []
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        ship_s, ship_r = [], []
        for b in batches:
            times.append(st.StreamTimes())
            out = streamed(ship_cfg, b, times=times[-1])
            if b in check:
                ship_s.append(out)
        end.record()
        end.synchronize()
        stream_ms = start.elapsed_time(end)
        launches = dict(_build.LAUNCHES)
        want = dict(no_launch, approx_max_k=2 * len(batches))
        if flat:
            want[kernel[mode]] = n_blocks * len(batches)
        if launches != want:
            raise AssertionError(f"streaming {mode}: kernel launches {launches}, expected {want}")
        for k, v in out.items():
            if v.is_floating_point() and not bool(torch.isfinite(v).all()):
                raise AssertionError(f"streaming {mode}: non-finite {k}")
        for k, v in launches.items():
            total[k] += v
        start.record()
        for b in batches:
            out_r = resident(ship_cfg, b)
            if b in check:
                ship_r.append(out_r)
        end.record()
        end.synchronize()
        resident_ms = start.elapsed_time(end)
        line = compare_shipped(mode, cat(ship_s), cat(ship_r))
        log("streaming", f"{mode}: the timed runs' first {STREAM_CHECK_QUERIES} queries "
            f"(grouped_shift_approx), streaming against resident: {line}")
        del ship_s, ship_r, out_r
        copy_ms = [c0.elapsed_time(c1) for t in times for c0, c1, _, _ in t.blocks]
        score_ms = [s0.elapsed_time(s1) for t in times for _, _, s0, s1 in t.blocks]
        wall_ms = [t.phase1[0].elapsed_time(t.phase1[1]) for t in times]
        overlap = [1 - w / (sum(c0.elapsed_time(c1) + s0.elapsed_time(s1)
                                for c0, c1, s0, s1 in t.blocks))
                   for w, t in zip(wall_ms, times)]
        gather_ms = [1e3 * t.gather_s for t in times]
        feat2_ms = [t.feat2_copy[0].elapsed_time(t.feat2_copy[1]) for t in times]
        # the gathered (Nq, V + 1) rows of both feat2 streams and of the mask
        feat2_gb = (bsz * (ship_cfg.max_vcmr_video + 1) * N_CLIPS
                    * (2 * HIDDEN * host.video_feat2.element_size() + 4) / 1e9)
        if len(copy_ms) != n_blocks * len(batches):
            raise AssertionError(f"streaming {mode}: {len(copy_ms)} block records")
        log("streaming", f"{mode}: host cache {nbytes(*host_parts) / 1e9:.3f} GB pinned "
            f"(pulled in {host_s:.1f} s), resident cache {resident_gb:.3f} GB; "
            f"{N_QUERIES} queries x {nv} videos in {len(batches)} batches of {bsz}: "
            f"{stream_ms:.1f} ms = {N_QUERIES * 1e3 / stream_ms:.1f} q/s streaming, "
            f"{resident_ms:.1f} ms = {N_QUERIES * 1e3 / resident_ms:.1f} q/s resident "
            f"({ship_cfg.video_score_mode} + gather + grouped_shift_approx, same queries); "
            f"launches a batch {({k: v // len(batches) for k, v in launches.items() if v})}")
        log("streaming", f"{mode}: {n_blocks} blocks a batch; a block's copy {np.mean(copy_ms):.3f} "
            f"ms (copy stream; min {min(copy_ms):.3f}, max {max(copy_ms):.3f}), score + merge "
            f"{np.mean(score_ms):.3f} ms (compute stream; min {min(score_ms):.3f}, max "
            f"{max(score_ms):.3f}); phase 1 {np.mean(wall_ms):.2f} ms a batch (min "
            f"{min(wall_ms):.2f}), overlap 1 - wall / (copy + score) {np.mean(overlap):.3f}; "
            f"host to device {feat1_batch_bytes / 1e9:.3f} GB a batch at "
            f"{feat1_batch_bytes / sum(copy_ms) * len(batches) / 1e6:.2f} GB/s of copy time "
            f"against the probe's {probe_gbs:.2f} GB/s: bound "
            f"{feat1_batch_bytes / probe_gbs / 1e6:.2f} ms a batch, phase 1 at "
            f"{100 * feat1_batch_bytes / probe_gbs / 1e6 / np.mean(wall_ms):.1f}% of the "
            f"bound's rate")
        log("streaming", f"{mode}: phase 2 a batch: host gather of the top-V (+GT) rows "
            f"{np.mean(gather_ms):.2f} ms (min {min(gather_ms):.2f}), feat2 + mask copy "
            f"{np.mean(feat2_ms):.2f} ms ({feat2_gb:.3f} GB, "
            f"{feat2_gb / np.mean(feat2_ms) * 1e3:.2f} GB/s)")

        # peak device memory of one batch at half and at the full corpus
        peaks = {}
        r = host.lp if flat else 1
        half = dataclasses.replace(
            host, n_videos=STREAM_HALF, video_feat1=host.video_feat1[:STREAM_HALF * r],
            sub_feat1=host.sub_feat1[:STREAM_HALF * r],
            video_feat2=host.video_feat2[:STREAM_HALF], sub_feat2=host.sub_feat2[:STREAM_HALF],
            mask=host.mask[:STREAM_HALF],
            video_valid=host.video_valid[:STREAM_HALF] if flat else None)
        for n, h in ((STREAM_HALF, half), (nv, host)):
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            streamed(ship_cfg, batches[0], h=h)
            torch.cuda.synchronize()
            peaks[n] = (torch.cuda.max_memory_allocated(dev) - held) / 1e9
        log("streaming", f"{mode}: peak device memory of a batch above what is held "
            f"{peaks[STREAM_HALF]:.3f} GB at {STREAM_HALF} videos, {peaks[nv]:.3f} GB at {nv}; "
            f"the resident cache {resident_gb:.3f} GB")
        if not (abs(peaks[STREAM_HALF] - peaks[nv]) <= STREAM_MEMORY_RTOL * peaks[nv]
                and peaks[nv] < resident_gb):
            raise AssertionError(f"streaming {mode}: peak memory {peaks} GB against the "
                                 f"resident cache's {resident_gb:.3f} GB")
        # B11 at both span sites of one streamed batch: equal to its plain
        # version on the rows it was given, and its recall
        calls = record_approx(apx, lambda: streamed(ship_cfg, batches[0]))
        recalls, plain_equal = [], []
        for (x, k, recall, (vals, idx)), site in zip(calls, APPROX_SITES[1:]):
            want_v, want_i = apx.approx_max_k_plain(x, k, recall)
            plain_equal.append(bool(torch.equal(vals, want_v) and torch.equal(idx, want_i)))
            got = tie_aware_recall(torch.topk(x, k).values.cpu().numpy(),
                                   vals.cpu().numpy())
            recalls.append(got)
            m = apx.bins(x.shape[1], k, recall)
            log("streaming", f"{mode}, shipped spans, {site[0]}: rows ({x.shape[0]}, "
                f"{x.shape[1]}), k={k}, M={m} bins at recall {recall}: values and indices "
                f"bit-equal to approx_max_k_plain {plain_equal[-1]}, mean tie-aware recall "
                f"{got:.4f} (formula {((m - 1) / m) ** (k - 1):.4f})")
        if len(calls) != 2 or not all(plain_equal) or not min(recalls) >= SHIPPED_RECALL:
            raise AssertionError(f"streaming {mode}: B11 at {len(calls)} sites, bit-equal to "
                                 f"its plain version {plain_equal}, recalls {recalls}, "
                                 f"target {SHIPPED_RECALL}")
        del host, half, res_f1, out, times
        torch.cuda.empty_cache()
        log("streaming", f"{mode} took {time.perf_counter() - t_mode:.1f} s")
    del cache, flat_mask

    # the flagship forward entry point, card against CPU
    fn, args = entry()
    fn_cpu, args_cpu = entry(device="cpu")
    with torch.no_grad():
        card, cpu = fn(*args).item(), fn_cpu(*args_cpu).item()
    log("streaming", f"entry(): flagship forward loss on the card {card:.6f}, on the CPU "
        f"{cpu:.6f}, |d| {abs(card - cpu):.3e} (bound {LOSS_ATOL:.0e})")
    if not (math.isfinite(card) and abs(card - cpu) <= LOSS_ATOL):
        raise AssertionError(f"entry(): card loss {card} vs CPU {cpu}")
    log("streaming", f"phase 11 took {time.perf_counter() - t_phase:.1f} s; kernel launches "
        f"{({k: v for k, v in total.items() if v})}")
    return total


# phase 12: the baselines (see phase_baselines)
BASE_CAL_VIDEOS, BASE_MCN_VIDEOS = 16, 32   # (a) proposal corpora: a CAL video's 170
#                                             proposals x 24 clips x 7,684 features are
#                                             125 MB of host-built moment features
BASE_VCMR_CPU_QUERIES = 5          # (a) ExCL VCMR card vs CPU: 100 videos fused with a query
BASE_PROPS = 170                   # proposals of a 150 s TVR video (data/proposals.py)
BASE_OUT = 100                     # CAL's output width
BASE_BSZ = 100                     # query batch of (b)
BASE_SVMR_QUERIES, BASE_VCMR_QUERIES = 1000, 100
BASE_TRAIN_CAL_EVAL_VIDEOS = 16    # (c) CAL's evaluation corpus, cut as in (a)
BASE_TRAIN_EXCL_EVAL = 10          # (c) ExCL's evaluation queries (its VCMR fuses 100
#                                    videos with each)
# (c) each trainer CLI's own flags: MEE two epochs at 1e-3 (at its default
# 1e-4 the loss moves by 1e-4 in 24 steps); ExCL at TVR's 3,074 / 770
# widths, [features; TEF]
BASE_TRAIN_FLAGS = {"mee": ["--n_epoch", "2", "--lr", "1e-3"], "cal": ["--n_epoch", "1"],
                    "excl": ["--n_epoch", "1", "--ctx_mode", "video_sub_tef"]}
# card against CPU, with the reasons:
# - MEE: phase 4's f32 q2c bound (f32 summation order of unit-vector dots);
# - CAL: phase 10's recurrent q2c bound for the query LSTM, twice (a squared
#   distance between unit vectors moves by 2 |d(q.m)|);
# - ExCL: phase 10's recurrent span rtol (five LSTMs, then two softmaxes).
MEE_ATOL = 1e-6
BASE_MEE_EXCL_BSZ = 50             # (e) the cell meeexcl-b50's batch: 5,050 pairs a call
BASE_MEE_EXCL_REPS = 5             # (e) timed calls
# (f) ExCL's second-LSTM kernel: (name, pairs, ragged lengths): the cell's
# call (5,050 pairs of 100 clips) and the external-VR path's (1,000 pairs,
# lengths 1-100, every seventh 0)
BASE_EXCL_LSTM_SHAPES = (("meeexcl-b50's call", 5050, False), ("external VR", 1000, True))
BASE_EXCL_LSTM_REPS = 5
# (g) ExCL's span-head kernel against its plain version and against the same
# heads in f64: max |difference| of the logits over valid clips (f32 sums of
# K = 512 + 256 and 256 terms in another order than cuBLAS's, each 3xTF32
# product within ~3 2^-22 of f32, each k-step's sum rounded into the
# accumulator toward zero by the tensor cores); the cuda tests' bounds
# (tests/test_torch_excl_head.py)
BASE_EXCL_HEAD_ATOL, BASE_EXCL_HEAD_F64_ATOL = 1e-5, 5e-6
# (f) the kernel's span logits against the plain version's: max |difference|
# (to first order a span probability's relative error) at most a quarter
# of mee_excl_tvr.json's span_err limit (2e-5)
BASE_EXCL_LSTM_LOGIT_ATOL = 5e-6
CAL_ATOL = 2 * VARIANT_TOL["lstm"][0]
EXCL_RTOL = VARIANT_TOL["lstm"][1]


def on_card_and_cpu(pool, dev, model_cpu, run):
    """``run(model)`` with the model on the card (this thread) and on the
    CPU (a second host thread): (card result, CPU result, card s, CPU s)."""
    model_gpu = copy.deepcopy(model_cpu).to(dev)
    t0 = time.perf_counter()
    cpu_job = pool.submit(lambda: (run(model_cpu), time.perf_counter()))
    gpu = run(model_gpu)
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    cpu, t_cpu = cpu_job.result()
    return gpu, cpu, t_gpu, t_cpu - t0


def prediction_arrays(entries):
    """(N, K, 4) [video, st, ed, score] from submission entries of one width."""
    return np.asarray([e["predictions"] for e in entries], np.float64)


def compare_predictions(what, got, ref, clip, atol=0.0, rtol=0.0):
    """Scores within the bound, the ranking equal outside near-ties; logs
    and returns whether they agree."""
    from tvretrieval_tpu_torch.testing import rank_mismatches, within
    g, r = prediction_arrays(got), prediction_arrays(ref)
    if g.shape != r.shape or not np.isfinite(g).all():
        log("baselines", f"{what}: shape {g.shape} against {r.shape}, or non-finite")
        return False
    key = lambda p: ((p[..., 0] * 1000 + np.rint(p[..., 1] / clip)) * 1000
                     + np.rint(p[..., 2] / clip))
    ok = within(r[..., 3], g[..., 3], atol=atol, rtol=rtol)
    bad = rank_mismatches(key(r), r[..., 3], key(g), atol=2 * atol, rtol=2 * rtol)
    err = np.abs(g[..., 3] - r[..., 3])
    log("baselines", f"{what}: scores max |d| {err.max():.3e}, max rel "
        f"{(err / np.maximum(np.abs(r[..., 3]), 1e-30)).max():.3e} (atol {atol:.1e}, rtol "
        f"{rtol:.1e}); ranking mismatches outside near-ties {bad}")
    return ok and bad == 0


def mee_config():
    from tvretrieval_tpu_torch.models.mee import MEEConfig
    return MEEConfig(text_input_size=768, vid_input_size=3072, sub_input_size=768,
                     output_size=256)


def cal_config():
    """train_cal's model at TVR's feature widths: [local; global; TEF] of
    3,072 video / 768 subtitle features."""
    from tvretrieval_tpu_torch.models.cal import CALConfig
    return CALConfig(ctx_mode="video_sub", visual_input_size=2 * 3072 + 2,
                     textual_input_size=2 * 768 + 2, query_feat_size=768)


def excl_config():
    from tvretrieval_tpu_torch.models.excl import ExCLConfig
    return ExCLConfig(visual_input_size=3074, sub_input_size=770, query_input_size=768)


def baselines_card_vs_cpu(dev, e2e_world, tmpdir):
    """12a: each baseline engine on phase 4's corpus, card against CPU;
    returns the card's MEE VR submission's path."""
    from tvretrieval_tpu_torch.data.datasets import CorpusIndex
    from tvretrieval_tpu_torch.data.retrieval_datasets import (
        CALBuilderConfig, CALExampleBuilder, MEEExampleBuilder)
    from tvretrieval_tpu_torch.models.cal import CALWithSub
    from tvretrieval_tpu_torch.models.excl import ExCL
    from tvretrieval_tpu_torch.models.mee import MEE
    from tvretrieval_tpu_torch.retrieval.excl_engine import (
        excl_retrieve_svmr, excl_retrieve_vcmr_with_external_vr)
    from tvretrieval_tpu_torch.retrieval.proposal_engine import (
        cal_retrieve, encode_proposal_corpus)
    from tvretrieval_tpu_torch.retrieval.vr_engine import mee_retrieve_vr
    from tvretrieval_tpu_torch.testing import rank_mismatches, within
    from tvretrieval_tpu_torch.utils.io import save_json

    world, builder = e2e_world
    rows, corpus, clip = world.annotations, world.corpus, world.clip_length
    srcs = (world.query_source, world.video_source, world.sub_source)
    failed = []
    with ThreadPoolExecutor(1) as pool:
        # MEE: VR over the 320 videos
        mee_b = MEEExampleBuilder(*srcs, max_desc_l=30, max_ctx_l=N_CLIPS)
        model = MEE(mee_config()).init_weights(torch.Generator().manual_seed(0)).eval()
        run = lambda m: mee_retrieve_vr(m, mee_b, corpus, rows)["VR"]
        gpu, cpu, t_gpu, t_cpu = on_card_and_cpu(pool, dev, model, run)
        if not compare_predictions(f"MEE VR ({len(rows)} queries x {len(corpus)} videos; card "
                                   f"{t_gpu:.2f} s, CPU {t_cpu:.2f} s)", gpu, cpu, clip,
                                   atol=MEE_ATOL):
            failed.append("MEE")
        vr_path = os.path.join(tmpdir, "mee_vr.json")
        save_json({"VR": gpu, "video2idx": corpus.video2idx}, vr_path)

        # CAL and MCN: encode_proposal_corpus + cal_retrieve (VCMR, SVMR)
        for model_type, nv in (("cal", BASE_CAL_VIDEOS), ("mcn", BASE_MCN_VIDEOS)):
            names = corpus.vid_names[:nv]
            sub = CorpusIndex(vid_names=names, durations=corpus.durations[:nv],
                              video2idx={v: corpus.video2idx[v] for v in names})
            bcfg = CALBuilderConfig(ctx_mode="video_sub_tef", model_type=model_type,
                                    clip_length=clip, max_desc_l=30, max_ctx_l=N_CLIPS)
            cal_b = CALExampleBuilder(bcfg, *srcs, seed=0)
            model = CALWithSub(cal_config()).init_weights(torch.Generator().manual_seed(0))

            def run(m):
                t0 = time.perf_counter()
                cache = encode_proposal_corpus(m, cal_b, sub)
                if m.query_linear.weight.is_cuda:
                    torch.cuda.synchronize()
                t_enc = time.perf_counter() - t0
                return cache, t_enc, cal_retrieve(m, cal_b, cache, sub, rows)

            (gcache, g_enc, gout), (ccache, c_enc, cout), _, _ = on_card_and_cpu(
                pool, dev, model, run)
            P = gcache.prop_spans.shape[1]
            err = max(float((getattr(gcache, k).cpu() - getattr(ccache, k)).abs().max())
                      for k in ("mean_emb_video", "mean_sq_video", "mean_emb_sub", "mean_sq_sub"))
            log("baselines", f"{model_type.upper()}: encode_proposal_corpus over {nv} videos "
                f"({P} proposals, {bcfg.max_moment_clips} clips a proposal): card "
                f"{1e3 * g_enc / nv:.1f} ms a video, CPU {1e3 * c_enc / nv:.1f} ms; cached "
                f"means card vs CPU max |d| {err:.3e} (bound 1e-5)")
            ok = err <= 1e-5
            for task in ("VCMR", "SVMR"):
                ok &= compare_predictions(f"{model_type.upper()} {task}", gout[task], cout[task],
                                          clip, atol=CAL_ATOL)
            if not ok:
                failed.append(model_type)

        # ExCL: SVMR on every query, VCMR over the card's MEE submission
        model = ExCL(excl_config()).init_weights(torch.Generator().manual_seed(0)).eval()
        run = lambda m: excl_retrieve_svmr(m, builder, corpus, rows, clip_length=clip)["SVMR"]
        gpu, cpu, t_gpu, t_cpu = on_card_and_cpu(pool, dev, model, run)
        ok = compare_predictions(f"ExCL SVMR ({len(rows)} queries; card {t_gpu:.2f} s, CPU "
                                 f"{t_cpu:.2f} s)", gpu, cpu, clip, rtol=EXCL_RTOL)
        run = lambda m: excl_retrieve_vcmr_with_external_vr(
            m, builder, corpus, rows[:BASE_VCMR_CPU_QUERIES], vr_path, clip_length=clip)["VCMR"]
        gpu, cpu, t_gpu, t_cpu = on_card_and_cpu(pool, dev, model, run)
        ok &= compare_predictions(f"ExCL VCMR over the card's MEE top-100 "
                                  f"({BASE_VCMR_CPU_QUERIES} queries; card {t_gpu:.2f} s, CPU "
                                  f"{t_cpu:.2f} s)", gpu, cpu, clip, rtol=EXCL_RTOL)
        if not ok:
            failed.append("ExCL")
    if failed:
        raise AssertionError(f"baselines {failed}: the card disagrees with the CPU")
    return vr_path


def baselines_corpus(dev, e2e_world, vr_path):
    """12b: serving at the full TVR corpus (21,818 videos): MEE's scoring
    over its encoded corpus, CAL's over a synthesized proposal cache, ExCL's
    SVMR and its VCMR over MEE's top-100."""
    from tvretrieval_tpu_torch.data.datasets import CorpusIndex
    from tvretrieval_tpu_torch.data.features import MemoryFeatureSource
    from tvretrieval_tpu_torch.data.retrieval_datasets import CALBuilderConfig, CALExampleBuilder
    from tvretrieval_tpu_torch.models.cal import CALWithSub
    from tvretrieval_tpu_torch.models.excl import ExCL
    from tvretrieval_tpu_torch.models.mee import MEE
    from tvretrieval_tpu_torch.retrieval.excl_engine import (
        excl_retrieve_svmr, excl_retrieve_vcmr_with_external_vr)
    from tvretrieval_tpu_torch.retrieval.proposal_engine import (
        ProposalCorpusCache, cal_retrieve)
    from tvretrieval_tpu_torch.retrieval.vr_engine import score_vr_queries

    nv, nq = N_VIDEOS_FULL, N_QUERIES
    gen = torch.Generator(device=dev).manual_seed(12)
    unit_rows = lambda n, d: torch.nn.functional.normalize(
        torch.randn(n, d, device=dev, generator=gen), dim=-1)

    # MEE: the gated units encode 21,818 pooled videos; 1,000 queries in
    # batches of 100 score them all and select the top 100
    model = MEE(mee_config()).init_weights(torch.Generator().manual_seed(0)).to(dev).eval()
    with torch.no_grad():
        pooled_v, pooled_s = unit_rows(nv, 3072), unit_rows(nv, 768)
        ev, es = map(torch.cat, zip(*(model.encode_context(pooled_v[i:i + 400],
                                                           pooled_s[i:i + 400])
                                      for i in range(0, nv, 400))))
    del pooled_v, pooled_s
    queries = torch.randn(nq, 30, 768, device=dev, generator=gen)
    score = lambda: [score_vr_queries(model, queries[i:i + BASE_BSZ], ev, es, 100)
                     for i in range(0, nq, BASE_BSZ)]
    torch.cuda.reset_peak_memory_stats(dev)
    ms = cuda_ms(score, reps=3)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    log("baselines", f"MEE VR at {nv} videos: {nq} queries in batches of {BASE_BSZ}, "
        f"{ms:.2f} ms = {nq / ms * 1e3:.0f} q/s; encoded cache {nbytes(ev, es) / 2**20:.1f} MiB, "
        f"peak {peak:.2f} GiB")
    del ev, es, queries, model

    # CAL: 21,818 videos x 170 proposals x 100 dims in both streams
    n_valid = torch.randint(20, BASE_PROPS + 1, (nv,), device=dev, generator=gen)
    mask = (torch.arange(BASE_PROPS, device=dev)[None] < n_valid[:, None]).float()
    cache = {}
    for stream in ("video", "sub"):
        emb = unit_rows(nv * BASE_PROPS, BASE_OUT).view(nv, BASE_PROPS, BASE_OUT)
        emb.mul_(torch.rand(nv, BASE_PROPS, 1, device=dev, generator=gen).mul_(0.5).add_(0.5))
        cache[f"mean_emb_{stream}"] = emb
        cache[f"mean_sq_{stream}"] = emb.square().sum(-1) + 0.05
    spans = np.zeros((nv, BASE_PROPS, 2), np.float32)
    spans[..., 1] = 1.5 * (1 + np.arange(BASE_PROPS))
    pc = ProposalCorpusCache(prop_mask=mask, prop_spans=spans, n_videos=nv, **cache)
    rng = np.random.default_rng(12)
    names = [f"syn_vid_{i:05d}" for i in range(nv)]
    qsrc = MemoryFeatureSource({str(i): rng.standard_normal((int(rng.integers(5, 20)), 768))
                                .astype(np.float32) for i in range(nq)})
    rows = [{"desc_id": i, "vid_name": names[int(rng.integers(nv))]} for i in range(nq)]
    corpus = CorpusIndex(vid_names=names, durations=[150.0] * nv,
                         video2idx={v: i for i, v in enumerate(names)})
    cal_b = CALExampleBuilder(CALBuilderConfig(ctx_mode="video_sub_tef"), qsrc, seed=0)
    model = CALWithSub(cal_config()).init_weights(torch.Generator().manual_seed(0)).to(dev)
    run = lambda: cal_retrieve(model, cal_b, pc, corpus, rows, query_bsz=BASE_BSZ,
                               return_arrays=True)
    run()                                                   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = run()
    sec = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    for task, (vid, sp, sc) in out.items():
        if not (np.isfinite(sc).all() and vid.shape[0] == nq):
            raise AssertionError(f"CAL at the full corpus, {task}: bad output")
    log("baselines", f"CAL at {nv} videos x {BASE_PROPS} proposals x {BASE_OUT} dims, two "
        f"streams (cache {nbytes(*cache.values(), mask) / 1e9:.2f} GB): {nq} queries in batches "
        f"of {BASE_BSZ}, VCMR + SVMR, {sec * 1e3:.1f} ms = {nq / sec:.0f} q/s (host clock); "
        f"SVMR rows copied to the host {nq * BASE_PROPS * 4 / 2**20:.2f} MiB (the whole "
        f"distance matrix would be {nq * nv * BASE_PROPS * 4 / 1e9:.1f} GB); peak "
        f"{peak:.2f} GiB")
    del pc, cache, mask, model, out

    # ExCL at 100 clips: SVMR on 1,000 queries, VCMR over MEE's top-100
    world, builder = e2e_world
    clip = world.clip_length
    svmr_rows = [world.annotations[i % len(world.annotations)] for i in range(BASE_SVMR_QUERIES)]
    model = ExCL(excl_config()).init_weights(torch.Generator().manual_seed(0)).to(dev).eval()
    for name, run, n in (
            ("SVMR", lambda: excl_retrieve_svmr(model, builder, world.corpus, svmr_rows,
                                                clip_length=clip), BASE_SVMR_QUERIES),
            ("VCMR over MEE's top-100 videos", lambda: excl_retrieve_vcmr_with_external_vr(
                model, builder, world.corpus, world.annotations[:BASE_VCMR_QUERIES], vr_path,
                clip_length=clip), BASE_VCMR_QUERIES)):
        t0 = time.perf_counter()
        out = run()
        sec = time.perf_counter() - t0
        for entries in out.values():
            if not (len(entries) == n and np.isfinite(prediction_arrays(entries)).all()):
                raise AssertionError(f"ExCL {name}: bad output")
        log("baselines", f"ExCL {name}: {n} queries at {N_CLIPS} clips in {sec:.2f} s = "
            f"{n / sec:.0f} q/s (host clock, batch building included)")


def baseline_world(kind, train_world, train_builder):
    """A ``setup_world`` for train_<kind> on phase 7's full-width world
    (1,024 videos x 100 clips, 3,072 / 768 / 768 features; 3,072 + 1,024
    queries), its evaluation cut for CAL (the first 16 videos) and ExCL
    (100 queries)."""
    from tvretrieval_tpu_torch.data.datasets import CorpusIndex
    from tvretrieval_tpu_torch.data.retrieval_datasets import (
        CALBuilderConfig, CALExampleBuilder, MEEExampleBuilder)

    world = train_world
    n_train = TRAIN_QUERIES - TRAIN_EVAL_QUERIES
    train_rows, eval_rows = world.annotations[:n_train], world.annotations[n_train:]
    srcs = (world.query_source, world.video_source, world.sub_source)

    def setup_world(args):
        corpus = world.corpus
        if kind == "mee":
            builder = MEEExampleBuilder(*srcs, ctx_mode=args.ctx_mode, max_desc_l=args.max_desc_l,
                                        max_ctx_l=args.max_ctx_l)
            return train_rows, eval_rows, builder, corpus
        if kind == "excl":
            return train_rows, eval_rows[:BASE_TRAIN_EXCL_EVAL], train_builder, corpus
        names = corpus.vid_names[:BASE_TRAIN_CAL_EVAL_VIDEOS]
        corpus = CorpusIndex(vid_names=names, durations=corpus.durations[:len(names)],
                             video2idx={v: corpus.video2idx[v] for v in names})
        bcfg = CALBuilderConfig(ctx_mode=args.ctx_mode, model_type=args.model_type,
                                clip_length=args.clip_length, max_desc_l=args.max_desc_l,
                                max_ctx_l=args.max_ctx_l, max_moment_clips=args.max_moment_clips)
        return (train_rows, [r for r in eval_rows if r["vid_name"] in corpus.video2idx],
                CALExampleBuilder(bcfg, *srcs, seed=args.seed), corpus)

    return setup_world


def baselines_train_and_cli(dev, train_world, train_builder, tmpdir):
    """12c / 12d: each trainer CLI at full width on phase 7's world (batch
    128, one epoch of 24 steps): the first batch's loss on the card against
    the CPU, finite and falling step losses, ms a step; then
    inference_baselines on each run directory, its metrics equal to the
    run's own from the same checkpoint."""
    from tvretrieval_tpu_torch.data.pipeline import BatchIterator
    from tvretrieval_tpu_torch.retrieval import inference_baselines
    from tvretrieval_tpu_torch.training import generic, train_cal, train_excl, train_mee
    from tvretrieval_tpu_torch.utils.io import load_json

    epochs = []                               # (steps, ms, step losses) of each epoch
    train_epoch = generic.GenericTrainer.train_epoch

    def timed_epoch(self, epoch):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = train_epoch(self, epoch)
        end.record()
        end.synchronize()
        steps = len(self.last_step_losses)
        epochs.append((steps, start.elapsed_time(end) / steps,
                       [r["loss"] for r in self.last_step_losses]))
        return out

    vr_path = None
    runs = (("mee", train_mee), ("cal", train_cal), ("excl", train_excl))
    generic.GenericTrainer.train_epoch = timed_epoch
    saved = {m: m.setup_world for _, m in runs}
    try:
        for kind, module in runs:
            module.setup_world = baseline_world(kind, train_world, train_builder)
            flags = ["--bsz", str(TRAIN_BSZ), "--seed", "0", "--exp_id", kind,
                     "--results_root", tmpdir] + BASE_TRAIN_FLAGS[kind]
            # the first batch, card against CPU (ExCL without dropout)
            args = module.build_arg_parser().parse_args(
                flags + (["--drop", "0"] if kind == "excl" else []))
            train_rows, _, builder, _ = module.setup_world(args)
            trainer = module.make_trainer(args, module.model_config(args, builder), builder,
                                          train_rows)
            it = BatchIterator(train_rows, TRAIN_BSZ, shuffle=True, drop_last=True, seed=0)
            t0 = time.perf_counter()
            batch = trainer.build_fn(next(iter(it)))
            build_ms = (time.perf_counter() - t0) * 1e3
            losses = {}
            for where, device in (("card", dev), ("cpu", "cpu")):
                model = copy.deepcopy(trainer.model).to(device).train()
                on = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                      for k, v in batch.items()}
                with torch.no_grad():
                    losses[where] = float(trainer.loss_apply(model, on, None, True)[0])
            del trainer, model
            err = abs(losses["card"] - losses["cpu"])
            # the CLI run on the card
            t0 = time.perf_counter()
            extra = (["--external_inference_vr_res_path", vr_path] if kind == "excl" else [])
            n_before = len(epochs)
            out = module.start_training(flags + extra)
            sec = time.perf_counter() - t0
            step_losses = sum((e[2] for e in epochs[n_before:]), [])
            steps, step_ms = len(step_losses), epochs[-1][1]
            first, last = float(np.mean(step_losses[:4])), float(np.mean(step_losses[-4:]))
            log("baselines", f"train_{kind}: first batch card {losses['card']:.6f} vs CPU "
                f"{losses['cpu']:.6f}, |d| {err:.2e} (bound {LOSS_ATOL}); {steps} steps of "
                f"batch {TRAIN_BSZ}: {step_ms:.2f} ms a step in the last epoch, the host builds "
                f"a batch in {build_ms:.1f} ms; mean loss of the first / last 4 steps "
                f"{first:.4f} -> {last:.4f}; the CLI took {sec:.1f} s with its evaluations")
            if not (err <= LOSS_ATOL and steps >= 16 and np.isfinite(step_losses).all()
                    and last < first):
                raise AssertionError(f"train_{kind}: first-batch |d| {err}, losses {step_losses}")
            run_dir = out["results_dir"]
            if kind == "mee":
                vr_path = os.path.join(run_dir, "best_predictions.json")
            # the inference CLI on the run directory, on the card
            cli = ["--model_type", kind, "--model_dir", run_dir, "--nms_thd", "0.5"] + extra
            res = inference_baselines.start_inference(cli)
            want = load_json(os.path.join(run_dir, "best_predictions_metrics.json"))
            if kind == "excl":
                want["VCMR"] = load_json(os.path.join(
                    run_dir, "vcmr_external_predictions_metrics.json"))["VCMR"]
            tasks = {"mee": ("VR",), "cal": ("VCMR", "SVMR"), "excl": ("SVMR", "VCMR")}[kind]
            same = all(dict(res["metrics"][t]) == want[t] for t in tasks)
            log("baselines", f"inference_baselines --model_type {kind}: "
                + "; ".join(f"{t} {json.dumps(res['metrics'][t])}" for t in tasks)
                + f"; equal to the run's: {same}; after NMS 0.5: "
                + ("; ".join(f"{t} {json.dumps(res['metrics_nms'][t])}" for t in tasks
                             if t in res["metrics_nms"]) or "no span task"))
            if not same:
                raise AssertionError(f"inference_baselines {kind}: metrics differ from the run's")
    finally:
        generic.GenericTrainer.train_epoch = train_epoch
        for module, fn in saved.items():
            module.setup_world = fn


def baselines_mee_excl(dev, tsort):
    """12e: MEE + ExCL at published widths over 21,818 videos of 100 clips
    through ``score_mee_excl_batch``, 50 queries a call with their GT
    videos: five B6 launches a call (MEE's blocked top 100 two, each
    video's top 50, the merge to 200, the GT video's SVMR row), each equal
    to ``topk_transposed_plain`` on the same inputs, and one of the
    second-LSTM kernel (csrc/excl_lstm.cu) and one of the span-head kernel
    (csrc/excl_head.cu); the outputs checked;
    ms a call, cache bytes, peak memory."""
    from tvretrieval_tpu_torch.models.excl import ExCL
    from tvretrieval_tpu_torch.models.mee import MEE
    from tvretrieval_tpu_torch.ops import _build
    from tvretrieval_tpu_torch.retrieval import excl_engine as ee

    nv, L, bsz, lq = N_VIDEOS_FULL, N_CLIPS, BASE_MEE_EXCL_BSZ, 30
    gen = torch.Generator(device=dev).manual_seed(26)
    unit = lambda *shape: torch.nn.functional.normalize(
        torch.randn(shape, device=dev, generator=gen), dim=-1)
    mee = MEE(mee_config()).init_weights(torch.Generator().manual_seed(0)).to(dev).eval()
    excl = ExCL(excl_config()).init_weights(torch.Generator().manual_seed(0)).to(dev).eval()
    start = torch.arange(L, device=dev, dtype=torch.float32) / L
    tef = torch.stack([start, start + np.float32(1.0 / L)], dim=-1)

    def blocks(bv=512):
        for i in range(0, nv, bv):
            n = min(bv, nv - i)
            video, sub = unit(n, L, 3072), unit(n, L, 768)
            yield dict(video_feat=torch.cat([video, tef.expand(n, L, 2)], dim=-1),
                       sub_feat=torch.cat([sub, tef.expand(n, L, 2)], dim=-1),
                       mask=torch.ones((n, L), device=dev),
                       mee_video=torch.nn.functional.normalize(video.mean(1), dim=-1),
                       mee_sub=torch.nn.functional.normalize(sub.mean(1), dim=-1))

    t0 = time.perf_counter()
    cache = ee.encode_mee_excl_corpus(mee, excl, blocks(), nv)
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t0
    cfg = ee.MEEExCLConfig()
    lens = torch.randint(8, lq + 1, (bsz,), device=dev, generator=gen)
    q_mask = (torch.arange(lq, device=dev)[None] < lens[:, None]).float()
    q_feat = unit(bsz, lq, 768) * q_mask[:, :, None]
    gt = torch.randint(0, nv, (bsz,), device=dev, generator=gen)
    call = lambda: ee.score_mee_excl_batch(mee, excl, cache, q_feat, q_mask, cfg, gt)
    call()                                                  # warm-up
    torch.cuda.synchronize()

    seen, launch = [], tsort._launch

    def recording(x, k):
        vals, idx = launch(x, k)
        seen.append((x.clone(), k, vals, idx))
        return vals, idx

    _build.reset_launch_counts()
    tsort._launch = recording
    try:
        out = call()
        torch.cuda.synchronize()
    finally:
        tsort._launch = launch
    n_launch = _build.LAUNCHES["topk_transposed"]
    if n_launch != 5 or len(seen) != 5:
        raise AssertionError(f"MEE + ExCL: {n_launch} B6 launches a call, not 5")
    for kernel, what in (("excl_lstm", "second-LSTM"), ("excl_head", "span-head")):
        if _build.LAUNCHES[kernel] != 1:
            raise AssertionError(f"MEE + ExCL: {_build.LAUNCHES[kernel]} launches of the "
                                 f"{what} kernel a call, not 1")
    shapes = []
    for x, k, vals, idx in seen:
        pv, pi = tsort.topk_transposed_plain(x, k)
        if not (torch.equal(vals, pv) and torch.equal(idx, pi)):
            raise AssertionError(f"MEE + ExCL: B6 on {tuple(x.shape)} k={k} differs from its "
                                 "plain version")
        shapes.append(f"{tuple(x.shape)} k={k}")
    del seen
    V, K = cfg.top_n_videos, cfg.max_before_nms
    want = {"vr_idx": (bsz, V), "vr_scores": (bsz, V), "moments": (bsz, K, 3),
            "moment_scores": (bsz, K), "svmr": (bsz, K, 2), "svmr_scores": (bsz, K)}
    got = {k: tuple(v.shape) for k, v in out.items()}
    with torch.no_grad():
        scores = mee.scores(mee.pool_query(q_feat), cache.mee_video, cache.mee_sub)
    per_video = torch.zeros((bsz, V), dtype=torch.long, device=dev).scatter_add_(
        1, out["moments"][..., 0].long(), torch.ones_like(out["moments"][..., 0].long()))
    ordered = all(bool((out[k][:, 1:] <= out[k][:, :-1]).all())
                  for k in ("vr_scores", "moment_scores", "svmr_scores"))
    span = out["moments"][..., 2] - out["moments"][..., 1]
    if not (got == want and ordered
            and torch.equal(scores.gather(1, out["vr_idx"].long()), out["vr_scores"])
            and int(per_video.max()) <= cfg.top_n_per_video
            and bool(((span >= cfg.min_pred_l) & (span < cfg.max_pred_l)).all())
            and all(bool(torch.isfinite(out[k]).all()) for k in out)):
        raise AssertionError(f"MEE + ExCL: bad outputs (shapes {got}, ordered {ordered})")
    torch.cuda.reset_peak_memory_stats(dev)
    ms = cuda_ms(call, reps=BASE_MEE_EXCL_REPS)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    c = cache.excl
    log("baselines", f"MEE + ExCL at {nv} videos x {L} clips through score_mee_excl_batch: "
        f"cache {nbytes(cache.mee_video, cache.mee_sub, c.ctx1_video, c.ctx1_sub, c.mask) / 1e9:.2f}"
        f" GB encoded in {t_enc:.1f} s (host clock); {bsz} queries a call with their GT videos "
        f"({bsz * (V + 1)} pairs): {ms:.2f} ms a call = {bsz / ms * 1e3:.0f} q/s; 5 B6 launches "
        f"a call, each equal to its plain version: {'; '.join(shapes)}; 1 second-LSTM and 1 "
        f"span-head kernel launch a call; outputs checked; peak "
        f"{peak:.2f} GiB")


def lstm_f64(enc, ctx1, q, n):
    """``enc(cat([ctx1, q_rep]), n)``'s outputs computed in f64 step by
    step (flax's order: the backward direction over the valid prefix
    reversed; zero past each row's length)."""
    P, L, _ = ctx1.shape
    H = enc.hidden_size
    x = torch.cat([ctx1, q[:, None].expand(P, L, q.shape[-1])], dim=-1).double()
    out = torch.zeros((P, L, 2 * H), dtype=torch.float64, device=ctx1.device)
    rows, n = torch.arange(P, device=ctx1.device), n.long()
    for d, cell in enumerate((enc.fwd_cell, enc.bwd_cell)):
        xp = x @ cell.weight_ih_l0.double().T + (cell.bias_ih_l0 + cell.bias_hh_l0).double()
        w_hh = cell.weight_hh_l0.double().T
        h = torch.zeros((P, H), dtype=torch.float64, device=ctx1.device)
        c = torch.zeros_like(h)
        for t in range(L):
            clip = torch.full_like(n, t) if d == 0 else (L - 1 - t + n) % L
            i, f, g, o = (xp[rows, clip] + h @ w_hh).split(H, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            valid = t < n
            out[rows[valid], clip[valid], d * H:(d + 1) * H] = h[valid]
    return out


@torch.no_grad()
def baselines_excl_lstm(dev):
    """12f: ExCL's second-LSTM kernel (``ops/lstm.py::excl_lstm``,
    csrc/excl_lstm.cu) at published widths against its plain version (the
    concatenation and ``encoder2``: cuDNN) at BASE_EXCL_LSTM_SHAPES, both
    streams, biases drawn away from zero: one launch a call; the max
    absolute difference of the outputs and the same over the plain
    outputs' largest magnitude, and the kernel's and the plain version's
    largest difference from the same LSTM in f64 (``lstm_f64``; the
    kernel's at most twice cuDNN's); the span logits of
    ``fused_span_logits`` with the kernel against those with the plain
    version (max |difference| over valid clips, at most
    BASE_EXCL_LSTM_LOGIT_ATOL); the kernel's ms
    beside its bound (3xTF32 products of the steps the lengths hold; ctx1
    read by each direction, the outputs written), the plain version's ms
    and cuDNN's bidirectional ``nn.LSTM`` over the same [ctx1; q]
    (library_ms, the concatenation included; the same function where every
    row is whole)."""
    from tvretrieval_tpu_torch.models.excl import ExCL
    from tvretrieval_tpu_torch.ops import _build
    from tvretrieval_tpu_torch.ops import lstm

    g = torch.Generator().manual_seed(27)
    excl = ExCL(excl_config()).init_weights(g)
    for name, p in excl.named_parameters():
        if "bias" in name:
            p.normal_(0.0, 0.02, generator=g)
    excl = excl.to(dev).eval()
    encoders = [excl.video_encoder2, excl.sub_encoder2]
    library = []
    for enc in encoders:
        cell = torch.nn.LSTM(enc.fwd_cell.input_size, enc.hidden_size, batch_first=True,
                             bidirectional=True).to(dev)
        for suffix, src in (("", enc.fwd_cell), ("_reverse", enc.bwd_cell)):
            for key in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
                getattr(cell, f"{key}_l0{suffix}").copy_(getattr(src, f"{key}_l0"))
        library.append(cell)
    gd = torch.Generator(device=dev).manual_seed(27)
    L, H = N_CLIPS, lstm.HIDDEN
    for name, P, ragged in BASE_EXCL_LSTM_SHAPES:
        n = torch.full((P,), L, device=dev, dtype=torch.int32)
        if ragged:
            n = torch.randint(1, L + 1, (P,), device=dev, generator=gd, dtype=torch.int32)
            n[::7] = 0
        mask = (torch.arange(L, device=dev)[None] < n[:, None]).float()
        ctx1s = [torch.tanh(torch.randn((P, L, 2 * H), device=dev, generator=gd))
                 * mask[:, :, None] for _ in encoders]
        q = torch.tanh(torch.randn((P, 2 * H), device=dev, generator=gd))
        run = lambda: lstm.excl_lstm(encoders, ctx1s, q, [n, n])
        plain = lambda: lstm.excl_lstm_plain(encoders, ctx1s, q, [n, n])
        _build.reset_launch_counts()
        got = run()
        torch.cuda.synchronize()
        launches = _build.LAUNCHES["excl_lstm"]
        want = plain()
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        scale = max(b.abs().max().item() for b in want)
        pad_zero = all(bool((a[mask == 0] == 0).all()) for a in got)
        exact = [lstm_f64(enc, c, q, n) for enc, c in zip(encoders, ctx1s)]
        err64 = max((a.double() - b).abs().max().item() for a, b in zip(got, exact))
        plain_err64 = max((a.double() - b).abs().max().item() for a, b in zip(want, exact))
        del got, want, exact
        logits_k = excl.fused_span_logits(q, ctx1s, (mask, mask))
        kernel, lstm.excl_lstm = lstm.excl_lstm, lstm.excl_lstm_plain
        try:
            logits_p = excl.fused_span_logits(q, ctx1s, (mask, mask))
        finally:
            lstm.excl_lstm = kernel
        valid = mask > 0
        logit_err = max((a - b)[valid].abs().max().item() for a, b in zip(logits_k, logits_p))
        del logits_k, logits_p
        q_rep = q[:, None, :].expand(P, L, 2 * H)
        lib = lambda: [cell(torch.cat([c, q_rep], dim=-1)) for cell, c in zip(library, ctx1s)]
        p1, k1, l1 = (cuda_ms(f, BASE_EXCL_LSTM_REPS) for f in (plain, run, lib))
        k2, p2, l2 = (cuda_ms(f, BASE_EXCL_LSTM_REPS) for f in (run, plain, lib))
        steps = 2 * 2 * int(n.sum())                  # streams x directions
        ops, dt = tc_ops(steps * (3 * H) * (4 * H) * 2, torch.float32)
        rec = dict(pairs=P, max_abs_err=err, f64_err=err64, plain_f64_err=plain_err64,
                   logit_max_abs_err=logit_err, ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                   library_ms=(l1 + l2) / 2, **bound(3 * nbytes(*ctx1s), ops, dt))
        log("baselines", f"second-LSTM kernel, {name}: {P} pairs x {L} clips x 2 streams x 2 "
            f"directions, {int(n.sum())} steps a stream and direction ({int((n == 0).sum())} "
            f"empty rows): {launches} launch; max |kernel - plain| {err:.3e} ({err / scale:.3e} "
            f"of the largest |plain|), padding zero {pad_zero}; from the f64 LSTM: kernel "
            f"{err64:.3e}, plain (cuDNN, f32) {plain_err64:.3e}; span logits max |kernel - plain| "
            f"{logit_err:.3e} (limit {BASE_EXCL_LSTM_LOGIT_ATOL:g}); kernel {rec['ms']:.3f} ms "
            f"({k1:.3f} / {k2:.3f}), bound {rec['bound_ms']:.3f} ms by {rec['bound_by']} "
            f"({100 * rec['bound_ms'] / rec['ms']:.1f}%); plain (cuDNN stage) "
            f"{rec['plain_ms']:.3f} ms; library (nn.LSTM bidirectional over the concatenation) "
            f"{rec['library_ms']:.3f} ms")
        if (launches != 1 or not pad_zero or logit_err > BASE_EXCL_LSTM_LOGIT_ATOL
                or err64 > 2 * plain_err64):
            raise AssertionError(f"second-LSTM kernel, {name}: {rec}, padding zero {pad_zero}")
        torch.cuda.empty_cache()


def excl_heads_library(heads, ctx2s, ctx1s, q):
    """12g's yardstick: each stream's two heads as ``F.linear`` over the
    concatenation, tanh between (cuBLAS f32, TF32 off); no mask or mean.
    The port never calls it."""
    F = torch.nn.functional
    out = []
    for pair, ctx2, ctx1 in zip(heads, ctx2s, ctx1s):
        feat3 = torch.cat([ctx2, ctx1, q[:, None].expand(-1, ctx1.shape[1], -1)], dim=-1)
        out += [F.linear(torch.tanh(F.linear(feat3, p.Dense_0.weight, p.Dense_0.bias)),
                         p.Dense_1.weight, p.Dense_1.bias) for p in pair]
    return out


@torch.no_grad()
def baselines_excl_head(dev):
    """12g: ExCL's span-head kernel (``ops/excl_head.py::excl_heads``,
    csrc/excl_head.cu) at published widths against its plain version (the
    concatenation, the SpanPredictors, ``mask_logits``, the streams' mean)
    at BASE_EXCL_LSTM_SHAPES, both streams, biases drawn away from zero:
    one launch a call; masked clips exactly -1e10; the largest difference
    from the plain version over valid clips (at most BASE_EXCL_HEAD_ATOL)
    and the kernel's and the plain version's from the same heads in f64
    (the kernel's at most BASE_EXCL_HEAD_F64_ATOL);
    the kernel's ms beside its bound (3xTF32 products of [ctx2 | ctx1] at
    K = 512, N = 512 a stream; ctx2 and ctx1 read, the logits written), the
    plain version's ms and the library yardstick's
    (``excl_heads_library``)."""
    from tvretrieval_tpu_torch.models.excl import ExCL
    from tvretrieval_tpu_torch.ops import _build
    from tvretrieval_tpu_torch.ops import excl_head

    g = torch.Generator().manual_seed(29)
    excl = ExCL(excl_config()).init_weights(g)
    for name, p in excl.named_parameters():
        if "bias" in name:
            p.normal_(0.0, 0.02, generator=g)
    excl = excl.to(dev).eval()
    heads = [(excl.video_st_predictor, excl.video_ed_predictor),
             (excl.sub_st_predictor, excl.sub_ed_predictor)]
    gd = torch.Generator(device=dev).manual_seed(29)
    L, H = N_CLIPS, excl_head.HIDDEN
    for name, P, ragged in BASE_EXCL_LSTM_SHAPES:
        n = torch.full((P,), L, device=dev, dtype=torch.int32)
        if ragged:
            n = torch.randint(1, L + 1, (P,), device=dev, generator=gd, dtype=torch.int32)
            n[::7] = 0
        mask = (torch.arange(L, device=dev)[None] < n[:, None]).float()
        rows = lambda: torch.tanh(torch.randn((P, L, H), device=dev, generator=gd))
        ctx2s = [rows() * mask[:, :, None] for _ in heads]
        ctx1s = [rows() for _ in heads]
        q = torch.tanh(torch.randn((P, H), device=dev, generator=gd))
        masks = [mask, mask]
        run = lambda: excl_head.excl_heads(heads, ctx2s, ctx1s, q, masks)
        plain = lambda: excl_head.excl_heads_plain(heads, ctx2s, ctx1s, q, masks)
        lib = lambda: excl_heads_library(heads, ctx2s, ctx1s, q)
        _build.reset_launch_counts()
        got = run()
        torch.cuda.synchronize()
        launches = _build.LAUNCHES["excl_head"]
        want = plain()
        valid = mask > 0
        err = max((a - b)[valid].abs().max().item() for a, b in zip(got, want))
        masked = all(bool((a[~valid] == -1e10).all()) for a in got)
        exact = [0, 0]
        for pair, ctx2, ctx1 in zip(heads, ctx2s, ctx1s):
            feat3 = torch.cat([ctx2, ctx1, q[:, None].expand(-1, L, -1)], dim=-1).double()
            for i, p in enumerate(pair):
                hid = torch.tanh(feat3 @ p.Dense_0.weight.double().T + p.Dense_0.bias.double())
                exact[i] = exact[i] + (hid @ p.Dense_1.weight.double().T
                                       + p.Dense_1.bias.double())[..., 0]
            del feat3, hid
        err64 = max((a.double() - e / 2)[valid].abs().max().item() for a, e in zip(got, exact))
        plain_err64 = max((b.double() - e / 2)[valid].abs().max().item()
                          for b, e in zip(want, exact))
        del got, want, exact
        torch.cuda.empty_cache()
        p1, k1, l1 = (cuda_ms(f, BASE_EXCL_LSTM_REPS) for f in (plain, run, lib))
        k2, p2, l2 = (cuda_ms(f, BASE_EXCL_LSTM_REPS) for f in (run, plain, lib))
        ops, dt = tc_ops(len(heads) * P * L * excl_head.K * (2 * H) * 2, torch.float32)
        rec = dict(pairs=P, max_abs_err=err, f64_err=err64, plain_f64_err=plain_err64,
                   ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2, library_ms=(l1 + l2) / 2,
                   **bound(nbytes(*ctx2s, *ctx1s) + 2 * 4 * P * L, ops, dt))
        log("baselines", f"span-head kernel, {name}: {P} pairs x {L} clips x 2 streams x 2 "
            f"heads ({int((n == 0).sum())} empty rows): {launches} launch; max |kernel - "
            f"plain| over valid clips {err:.3e} (limit {BASE_EXCL_HEAD_ATOL:g}), masked clips "
            f"-1e10 {masked}; from the f64 heads: kernel {err64:.3e} (limit "
            f"{BASE_EXCL_HEAD_F64_ATOL:g}), plain (cuBLAS, f32) {plain_err64:.3e}; kernel "
            f"{rec['ms']:.3f} ms ({k1:.3f} / {k2:.3f}), bound "
            f"{rec['bound_ms']:.3f} ms by {rec['bound_by']} "
            f"({100 * rec['bound_ms'] / rec['ms']:.1f}%); plain {rec['plain_ms']:.3f} ms; "
            f"library (F.linear heads over the concatenation) {rec['library_ms']:.3f} ms")
        if (launches != 1 or not masked or err > BASE_EXCL_HEAD_ATOL
                or err64 > BASE_EXCL_HEAD_F64_ATOL):
            raise AssertionError(f"span-head kernel, {name}: {rec}, masked {masked}")
        del ctx2s, ctx1s
        torch.cuda.empty_cache()


def phase_baselines(dev, e2e_world, train_world, train_builder):
    """Phase 12: the baselines (see the module docstring). Every count is
    set to 0 before (a)-(d); after them B6 reads twice the card's calls of
    ExCL's span stage (each video's top spans, the merge), the second-LSTM
    and the span-head kernels once each, and every other count 0. (e), (f)
    and (g) count their own."""
    import tempfile

    from tvretrieval_tpu_torch.ops import _build
    from tvretrieval_tpu_torch.ops import sort as tsort

    from tvretrieval_tpu_torch.retrieval import excl_engine as ee

    _build.reset_launch_counts()
    stage, card_calls = ee.excl_vcmr_batch, [0]

    def counted(excl, ctx, *args, **kw):
        card_calls[0] += int(ctx.mask.is_cuda)
        return stage(excl, ctx, *args, **kw)

    t0 = time.perf_counter()
    ee.excl_vcmr_batch = counted
    try:
        with tempfile.TemporaryDirectory() as tmpdir:
            vr_path = baselines_card_vs_cpu(dev, e2e_world, tmpdir)
            torch.cuda.empty_cache()
            t1 = time.perf_counter()
            baselines_corpus(dev, e2e_world, vr_path)
            torch.cuda.empty_cache()
            t2 = time.perf_counter()
            baselines_train_and_cli(dev, train_world, train_builder, tmpdir)
    finally:
        ee.excl_vcmr_batch = stage
    t3 = time.perf_counter()
    launches = dict(_build.LAUNCHES)
    want = {**{k: 0 for k in launches}, "topk_transposed": 2 * card_calls[0],
            "excl_lstm": card_calls[0], "excl_head": card_calls[0]}
    log("baselines", f"12a-d took {t3 - t0:.1f} s (12a {t1 - t0:.1f} s, 12b {t2 - t1:.1f} s, "
        f"12c + 12d {t3 - t2:.1f} s); hand-kernel launches {launches}, B6 for "
        f"{card_calls[0]} card calls of ExCL's span stage")
    if launches != want or not card_calls[0]:
        raise AssertionError(f"hand-kernel launches on the baseline paths {launches}, "
                             f"expected {want}")
    torch.cuda.empty_cache()
    baselines_mee_excl(dev, tsort)
    t4 = time.perf_counter()
    log("baselines", f"12e took {t4 - t3:.1f} s")
    torch.cuda.empty_cache()
    baselines_excl_lstm(dev)
    t5 = time.perf_counter()
    log("baselines", f"12f took {t5 - t4:.1f} s")
    torch.cuda.empty_cache()
    baselines_excl_head(dev)
    log("baselines", f"12g took {time.perf_counter() - t5:.1f} s")


# ---------------------------------------------------------------- phase 13
# the profiling suite and the offline feature pipelines (see phase_features)
FEAT_PX = 224                      # frames and clips at the backbones' published input size
FEAT_FRAME_BSZ = 32                # extract_clip_features' batch
FEAT_CLIP_BSZ = 4                  # extract_i3d_clip_features' batch
FEAT_I3D_T = 23                    # frames a clip (reference extract_i3d_features.py:39-41)
FEAT_FRAMES_A_CLIP = 3             # ResNet frames a 1.5 s clip (video_features.py:28)
FEAT_CLIPS = 100                   # clips a synthetic video of (b)
FEAT_VIDEOS = 2
FEAT_CPU_FRAMES, FEAT_CPU_CLIPS = 4, 1   # (a) card against CPU
FEAT_REPS = 5
# (a) max |card - CPU| over max |CPU|, both f32 (TF32 off): each conv output
# sums K <= 4,608 products in another order on each side (about sqrt(K) *
# 2^-24 = 4e-6 of the sum's scale a layer), carried through 155 convs in
# ResNet-152 (about sqrt(155) * 4e-6 = 5e-5) and 57 in I3D; cuDNN may pick
# Winograd or FFT transforms for the 3x3 convs, whose rounding is an order
# larger. 1e-3 holds all of that; a wrong layer or padding is O(1)
BACKBONE_RTOL = 1e-3
KMEANS_ATOL = 1e-5                 # (d) unit-scale blobs: f32 means of ~156 rows
MLM_STEPS = 8                      # (c) roberta-base fine-tuning steps
MLM_BSZ, MLM_LEN = 32, 64          # MLMSettings' batch and length
# (d) the JAX profilers' key sets (tests/test_torch_profiling.py holds the
# port's dicts equal to theirs)
XML_PROFILE_KEYS = {"encode_context_batch_s", "encode_query_batch_s", "score_query_batch_s",
                    "corpus_encode_total_s", "retrieval_queries_per_sec",
                    "extrapolated_1000000v_retrieval_s_per_query",
                    "extrapolated_1000000v_encode_total_s", "storage_gb"}
TRAIN_PROFILE_KEYS = {"train_step_s", "examples_per_sec", "epoch_s_extrapolated",
                      "full_train_hours_extrapolated"}
BASELINE_PROFILE_KEYS = {
    "mee": {"ctx_encode_batch_s", "query_encode_batch_s", "retrieval_100k_block_s",
            "extrapolated_1000000v_ctx_encode_s",
            "extrapolated_1000000v_retrieval_s_per_100q"},
    "cal": {"moment_encode_batch_s", "query_encode_batch_s", "cdist_10k_proposals_s",
            "extrapolated_1000000v_moment_encode_s", "extrapolated_1000000v_cdist_s_per_100q"},
    "excl": {"span_scores_100pairs_s", "extrapolated_1000000v_s_per_query"}}
DATA_PROFILE_KEYS = {"per_row_build_batch_s", "prebuilt_gather_batch_s",
                     "prebuilt_f16_gather_batch_s", "speedup", "speedup_f16",
                     "prebuild_once_s", "cache_gb", "cache_f16_gb"}
SEARCH_KEYS = {"flat_search_ms", "ivf_search_ms", "ivf_recall_at_topk", "n_videos",
               "n_clusters", "nprobe"}


def conv_flops(module, x) -> int:
    """Operations (2 a multiply-add) of every convolution in one
    ``module(x)``, counted from the shapes of this run."""
    total = [0]

    def hook(m, _inp, out):
        total[0] += 2 * out.numel() * (m.in_channels // m.groups) * math.prod(m.kernel_size)

    handles = [m.register_forward_hook(hook) for m in module.modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d))]
    with torch.no_grad():
        module(x)
    for h in handles:
        h.remove()
    return total[0]


def rel_diff(card, cpu) -> float:
    card, cpu = np.asarray(card, np.float64), np.asarray(cpu, np.float64)
    return float(np.abs(card - cpu).max() / np.abs(cpu).max())


def features_backbones(dev):
    """13a: ResNet-152 and I3D at full size, card against CPU on the same
    seeded weights, then frames/s and clips/s of the frame and clip models
    (CUDA events) beside their f32 bounds, and peak memory."""
    from tvretrieval_tpu_torch.features import video_features as vf

    rng = np.random.default_rng(13)
    out = {}
    for kind, make, bsz, n_cpu, shape in (
            ("resnet152", vf.make_resnet152_frame_model, FEAT_FRAME_BSZ, FEAT_CPU_FRAMES,
             (FEAT_PX, FEAT_PX, 3)),
            ("i3d", vf.make_i3d_clip_model, FEAT_CLIP_BSZ, FEAT_CPU_CLIPS,
             (FEAT_I3D_T, FEAT_PX, FEAT_PX, 3))):
        x = rng.integers(0, 256, (bsz, *shape), np.uint8)
        fn_cpu = make(seed=0, device="cpu")
        t0 = time.perf_counter()
        ref = fn_cpu(x[:n_cpu])
        t_cpu = time.perf_counter() - t0
        fn = make(seed=0, device=dev)
        got = fn(x[:n_cpu])
        err = rel_diff(got, ref)
        del fn_cpu
        xdev = torch.from_numpy(x).to(dev).float()
        flops = conv_flops(fn.module, xdev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        ms = cuda_ms(lambda: fn(x), reps=FEAT_REPS)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        with torch.no_grad():           # the net alone, on a float batch on the card
            ms_net = cuda_ms(lambda: fn.module(xdev), reps=FEAT_REPS)
        del xdev
        weights = sum(t.numel() * t.element_size() for t in fn.module.state_dict().values())
        b = bound(x.nbytes + weights, flops, torch.float32)
        rate, rate_bound = bsz / ms * 1e3, bsz / b["bound_ms"] * 1e3
        unit = "frames" if kind == "resnet152" else "clips"
        log("features", f"13a {kind}: card vs CPU on {n_cpu} {unit} of {shape}: max |d| / "
            f"max |CPU| {err:.3e} (bound {BACKBONE_RTOL:.0e}; CPU {t_cpu:.2f} s); batch {bsz}: "
            f"{ms:.2f} ms, {rate:.1f} {unit}/s (the convolutions' {flops / 1e9:.1f} GFLOP a "
            f"batch at the f32 peak of 67 TFLOP/s: {b['bound_ms']:.2f} ms, {rate_bound:.1f} "
            f"{unit}/s; {b['bound_ms'] / ms:.1%} of it; TF32 off), peak {peak:.2f} GiB; the "
            f"net alone on a float batch on the card {ms_net:.2f} ms "
            f"({b['bound_ms'] / ms_net:.1%} of the bound)")
        if not (np.isfinite(got).all() and err <= BACKBONE_RTOL):
            raise AssertionError(f"13a {kind}: card against CPU {err:.3e} > {BACKBONE_RTOL}")
        out[kind] = fn
    return out


def features_extraction(models):
    """13b: the two extraction loops over synthetic videos of FEAT_CLIPS
    clips, the pooling helpers, the shapes read back. Without h5py the same
    per-video functions the HDF5 writers call run, and writing is held on
    the CPU (tests/test_torch_features.py)."""
    import importlib.util
    import tempfile

    from tvretrieval_tpu_torch.features import pooling
    from tvretrieval_tpu_torch.features import video_features as vf

    rng = np.random.default_rng(14)
    n_frames = FEAT_CLIPS * FEAT_FRAMES_A_CLIP
    n_i3d = FEAT_CLIPS * FEAT_I3D_T
    frames = {f"v{i}": rng.integers(0, 256, (n_frames - 2 * i, FEAT_PX, FEAT_PX, 3), np.uint8)
              for i in range(FEAT_VIDEOS)}
    base = rng.integers(0, 256, (n_i3d, FEAT_PX, FEAT_PX, 3), np.uint8)
    # the second video one frame short: its last clip padded with its final frame
    clips = {f"v{i}": base[:n_i3d - i] for i in range(FEAT_VIDEOS)}
    t0 = time.perf_counter()
    if importlib.util.find_spec("h5py") is not None:
        import h5py
        with tempfile.TemporaryDirectory() as tmp:
            paths = [os.path.join(tmp, n) for n in ("resnet.h5", "i3d.h5")]
            vf.extract_clip_features(frames, models["resnet152"], paths[0],
                                     FEAT_FRAMES_A_CLIP, batch_size=FEAT_FRAME_BSZ)
            vf.extract_i3d_clip_features(clips, models["i3d"], paths[1], FEAT_I3D_T,
                                         batch_size=FEAT_CLIP_BSZ)
            feats = []
            for p in paths:
                with h5py.File(p) as h5:
                    feats.append({k: h5[k][()] for k in h5.keys()})
        how = "written to HDF5 and read back"
    else:
        log("features", "13b h5py does not import on this machine: HDF5 writing is held on "
            "the CPU only (tests/test_torch_features.py); the same per-video functions the "
            "writers call run here")
        feats = [{k: vf.frame_clip_features(v, models["resnet152"], FEAT_FRAMES_A_CLIP,
                                            batch_size=FEAT_FRAME_BSZ)
                  for k, v in frames.items()},
                 {k: vf.i3d_clip_features(v, models["i3d"], FEAT_I3D_T,
                                          batch_size=FEAT_CLIP_BSZ)
                  for k, v in clips.items()}]
        how = "from the per-video functions"
    t_ext = time.perf_counter() - t0
    for (kind, dim), got in zip((("resnet152", 2048), ("i3d", 1024)), feats):
        for k, a in got.items():
            if a.shape != (FEAT_CLIPS, dim) or a.dtype != np.float32 or not np.isfinite(a).all():
                raise AssertionError(f"13b {kind} {k}: {a.shape} {a.dtype}")
    cat = {k: pooling.normalize_and_concat([feats[0][k], feats[1][k]]) for k in frames}
    norms = np.concatenate([np.linalg.norm(c[:, :2048], axis=1) for c in cat.values()]
                           + [np.linalg.norm(c[:, 2048:], axis=1) for c in cat.values()])
    toks = rng.normal(size=(40, 768)).astype(np.float32)
    sub = pooling.tokens_to_clip_features(toks, [(0.0, 4.0), (10.0, 30.0)], [(0, 15), (15, 40)],
                                          FEAT_CLIPS)
    if any(c.shape != (FEAT_CLIPS, 3072) for c in cat.values()) or \
            np.abs(norms - 1).max() > 1e-3 or sub.shape != (FEAT_CLIPS, 768):
        raise AssertionError("13b pooling: shapes or norms")
    log("features", f"13b extraction of {FEAT_VIDEOS} videos x {FEAT_CLIPS} clips "
        f"({n_frames} frames of ResNet-152 and {n_i3d} of I3D a video), {how}: "
        f"{t_ext:.1f} s; shapes ({FEAT_CLIPS}, 2048) and ({FEAT_CLIPS}, 1024); "
        f"normalize_and_concat -> ({FEAT_CLIPS}, 3072), unit norms within "
        f"{np.abs(norms - 1).max():.1e}; tokens_to_clip_features -> {sub.shape}")


def features_text(dev):
    """13c: mask_tokens and the learning-rate schedule; where transformers
    imports, MLM fine-tuning of a roberta-base-width RoBERTa with random
    weights (a falling loss) and its encoder through the torch embedder."""
    import importlib.util

    from tvretrieval_tpu_torch.features import lm_finetune as lm
    from tvretrieval_tpu_torch.features import text_features as tf

    settings = lm.MLMSettings(lr=5e-4, warmup_steps=2, total_steps=MLM_STEPS,
                              batch_size=MLM_BSZ, max_length=MLM_LEN)
    rate = lm.warmup_cosine_lr(settings)
    rates = [rate(s) for s in range(MLM_STEPS + 1)]
    if rates[0] != 0.0 or max(rates) != settings.lr or rates[-1] > 1e-12:
        raise AssertionError(f"13c schedule {rates}")
    rng = np.random.default_rng(15)
    # a regular corpus (each row a shifted run of ids), so a few steps learn
    base = (np.arange(MLM_LEN)[None] + rng.integers(0, 50, (MLM_BSZ, 1))) % 200 + 4
    batches = []
    for _ in range(MLM_STEPS):
        ids, labels = lm.mask_tokens(rng, base, np.ones_like(base), mask_token_id=3,
                                     vocab_size=50265, special_ids=(0, 1, 2))
        batches.append({"input_ids": ids, "attention_mask": np.ones_like(base),
                        "labels": labels})
    picked = np.mean([(b["labels"] != -100).mean() for b in batches])
    if importlib.util.find_spec("transformers") is None:
        log("features", f"13c transformers does not import on this machine: fine-tuning "
            f"and the embedder are held on the CPU only (tests/test_torch_features.py); "
            f"mask_tokens picked {picked:.3f} of the tokens, the schedule {rates}")
        return
    from transformers import RobertaConfig, RobertaForMaskedLM

    torch.manual_seed(0)
    model = RobertaForMaskedLM(RobertaConfig())
    n_params = sum(p.numel() for p in model.parameters())
    t0 = time.perf_counter()
    model, losses = lm.finetune_mlm(model, batches, settings, device=dev)
    torch.cuda.synchronize()
    t_ft = time.perf_counter() - t0
    # texts of 4-64 words; no tokenizer ships in the repository, so
    # encode_fn gives seeded ids, one a word, padded with RoBERTa's pad id 1
    texts = {str(i): " ".join(["w"] * int(n))
             for i, n in enumerate(rng.integers(4, MLM_LEN + 1, 64))}

    def encode_fn(chunk):
        n_words = np.array([len(t.split()) for t in chunk])
        mask = (np.arange(MLM_LEN)[None] < n_words[:, None]).astype(np.int64)
        return np.where(mask == 1, rng.integers(4, 50265, (len(chunk), MLM_LEN)), 1), mask

    embed_fn = tf.make_torch_embed_fn(model.roberta, device=dev)
    t0 = time.perf_counter()
    feats = dict(tf.token_features(texts, encode_fn, embed_fn, batch_size=32))
    t_emb = time.perf_counter() - t0
    hidden = model.config.hidden_size
    shapes_ok = list(feats) == list(texts) and all(
        feats[k].shape == (len(t.split()), hidden) for k, t in texts.items())
    finite = all(np.isfinite(a).all() for a in feats.values())
    log("features", f"13c roberta-base width ({n_params / 1e6:.1f} M parameters, random): "
        f"{MLM_STEPS} MLM steps of {MLM_BSZ} x {MLM_LEN} on the card in {t_ft:.2f} s, losses "
        f"{[round(x, 3) for x in losses]}; mask_tokens picked {picked:.3f} of the tokens; "
        f"token features of {len(texts)} texts through the torch embedder in {t_emb:.2f} s "
        f"(HDF5 writing: the CPU tests)")
    if not (np.isfinite(losses).all() and np.mean(losses[-2:]) < losses[0] and shapes_ok
            and finite):
        raise AssertionError(f"13c: losses {losses}, shapes {shapes_ok}, finite {finite}")


def check_profile(what, res, keys):
    if set(res) != keys:
        raise AssertionError(f"13d {what}: keys {sorted(res)} against {sorted(keys)}")
    times = {k: v for k, v in res.items() if k != "storage_gb"}
    if not all(math.isfinite(v) and v > 0 for v in times.values()):
        raise AssertionError(f"13d {what}: {times}")


def features_profilers(dev):
    """13d: the stage profilers' CLI paths and the search simulation on the
    card, the JAX key sets, full-probe IVF recall 1.0, and the k-means
    centroids card against CPU from the same initial rows."""
    import contextlib
    import io

    from tvretrieval_tpu_torch.profiling import profile_models as pm
    from tvretrieval_tpu_torch.profiling import search_simulation as ss

    def quiet(fn, *a, **k):
        with contextlib.redirect_stdout(io.StringIO()):
            return fn(*a, **k)

    t0 = time.perf_counter()
    xml = quiet(pm.main, [])
    check_profile("xml", xml, XML_PROFILE_KEYS)
    train = {d: quiet(pm.main, ["--train", "--dtype", d]) for d in ("float32", "bfloat16")}
    for d, r in train.items():
        check_profile(f"train {d}", r, TRAIN_PROFILE_KEYS)
    base = quiet(pm.main, ["--baselines"])
    for name, keys in BASELINE_PROFILE_KEYS.items():
        check_profile(name, base[name], keys)
    t1 = time.perf_counter()
    data = quiet(pm.main, ["--data"])
    check_profile("data", data, DATA_PROFILE_KEYS)
    t2 = time.perf_counter()
    sim = quiet(ss.main, [])
    full = ss.simulate(nprobe=128, device=dev)
    for what, r in (("search", sim), ("search full probe", full)):
        if set(r) != SEARCH_KEYS or not (r["flat_search_ms"] > 0 and r["ivf_search_ms"] > 0):
            raise AssertionError(f"13d {what}: {r}")
    if full["ivf_recall_at_topk"] != 1.0:
        raise AssertionError(f"13d IVF recall at full probe {full['ivf_recall_at_topk']}")
    # k-means from the same initial rows, card against CPU: well-separated
    # unit-scale blobs (no assignment near a tie), then the simulation's own
    # unit vectors (which have ties near every boundary: agreement reported)
    rng = np.random.default_rng(16)
    k, n_per, d = 128, 20000 // 128, 256
    blobs = (rng.normal(0, 1, (k, 1, d)) + rng.normal(0, 0.05, (k, n_per, d))).reshape(-1, d)
    blobs = torch.from_numpy(blobs.astype(np.float32))
    idx = torch.arange(k) * n_per
    (cc, ca), (gc, ga) = (ss.lloyd(x, x[idx.to(x.device)], 10)
                          for x in (blobs, blobs.to(dev)))
    km_err = float((gc.cpu() - cc).abs().max())
    sims = rng.normal(size=(20000, d)).astype(np.float32)
    sims /= np.linalg.norm(sims, axis=1, keepdims=True)
    sims = torch.from_numpy(sims)
    init = ss.initial_indices(sims.shape[0], k)
    (sc, sa), (tc, ta) = (ss.lloyd(x, x[init.to(x.device)], 10) for x in (sims, sims.to(dev)))
    n_flip = int((ta.cpu() != sa).sum())
    t3 = time.perf_counter()
    log("features", f"13d profilers on the card: XML retrieval {xml['retrieval_queries_per_sec']:.1f} "
        f"q/s at 2,000 videos (batch 50; {xml['score_query_batch_s'] * 1e3:.2f} ms a batch, "
        f"context encode {xml['encode_context_batch_s'] * 1e3:.2f} ms a batch of 200); train "
        f"step f32 {train['float32']['train_step_s'] * 1e3:.2f} ms, bf16 "
        f"{train['bfloat16']['train_step_s'] * 1e3:.2f} ms (batch 128); MEE "
        f"{json.dumps({k: round(v, 6) for k, v in base['mee'].items()})}; CAL "
        f"{json.dumps({k: round(v, 6) for k, v in base['cal'].items()})}; ExCL "
        f"{json.dumps({k: round(v, 6) for k, v in base['excl'].items()})}; {t1 - t0:.1f} s")
    log("features", f"13d host batch building (--data): per-row "
        f"{data['per_row_build_batch_s'] * 1e3:.1f} ms, prebuilt "
        f"{data['prebuilt_gather_batch_s'] * 1e3:.2f} ms, f16 "
        f"{data['prebuilt_f16_gather_batch_s'] * 1e3:.2f} ms a batch of 128; {t2 - t1:.1f} s")
    log("features", f"13d search simulation (20,000 x 256, 128 clusters): flat "
        f"{sim['flat_search_ms']:.3f} ms, IVF nprobe 8 {sim['ivf_search_ms']:.3f} ms, recall "
        f"{sim['ivf_recall_at_topk']}; nprobe 128 {full['ivf_search_ms']:.3f} ms, recall "
        f"{full['ivf_recall_at_topk']}; k-means card vs CPU on separated blobs: centroids max "
        f"|d| {km_err:.2e} (bound {KMEANS_ATOL:.0e}), assignments equal "
        f"{bool((ga.cpu() == ca).all())}; on the simulation's unit vectors {n_flip} of 20000 "
        f"assignments differ; {t3 - t2:.1f} s")
    if km_err > KMEANS_ATOL or not bool((ga.cpu() == ca).all()):
        raise AssertionError(f"13d k-means card against CPU: {km_err:.2e}")


def phase_features(dev):
    """Phase 13: the offline feature pipelines and the profiling suite (see
    the module docstring). No hand kernel lies on their paths: every count
    is set to 0 before and must read 0 after."""
    from tvretrieval_tpu_torch.ops import _build

    _build.reset_launch_counts()
    t0 = time.perf_counter()
    models = features_backbones(dev)
    t1 = time.perf_counter()
    features_extraction(models)
    del models
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    features_text(dev)
    torch.cuda.empty_cache()
    t3 = time.perf_counter()
    features_profilers(dev)
    launches = dict(_build.LAUNCHES)
    log("features", f"phase 13 took {time.perf_counter() - t0:.1f} s (13a {t1 - t0:.1f} s, "
        f"13b {t2 - t1:.1f} s, 13c {t3 - t2:.1f} s, 13d {time.perf_counter() - t3:.1f} s); "
        f"hand-kernel launches {launches}")
    if any(launches.values()):
        raise AssertionError(f"a hand kernel launched on a feature or profiler path: {launches}")


def checkout_entry(checkout: str, name: str):
    """The entry point of library ``name`` of the commit in ``checkout`` (a
    git archive), built from its csrc source (the same C signature as this
    commit's) with this build's flags into that checkout's _build directory."""
    import ctypes

    from tvretrieval_tpu_torch.ops import _build

    src = os.path.join(checkout, "tvretrieval_tpu_torch", "csrc", f"{name}.cu")
    lib_dir = os.path.join(checkout, "tvretrieval_tpu_torch", "_build")
    os.makedirs(lib_dir, exist_ok=True)
    lib_path = os.path.join(lib_dir, f"lib{name}_parent.so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib_path, src],
                          check=True, capture_output=True, text=True)
    for line in (proc.stdout + proc.stderr).splitlines():
        if "registers" in line or "spill" in line:
            log("build", f"{name} of {checkout}: {line.strip()}")
    (entry, argtypes), = _build.SOURCES[name][1].items()
    fn = getattr(ctypes.CDLL(lib_path), entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def load_parent_b8(parent_dir: str):
    """The B8 of the commit in ``parent_dir`` as a function of this
    wrapper's arguments returning the four outputs."""
    fn = checkout_entry(parent_dir, "banded_topk")

    def call(st, ed, vs, min_l, max_l, top_n):
        nq, v, L = st.shape
        outs = [torch.empty((nq, top_n), dtype=t, device=st.device)
                for t in (torch.int32, torch.int32, torch.int32, torch.float32)]
        videos = torch.empty((nq,), dtype=torch.int32, device=st.device)
        err = fn(st.data_ptr(), ed.data_ptr(), vs.data_ptr(), nq, v, L, min_l, max_l, top_n,
                 *(o.data_ptr() for o in outs), videos.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the parent's B8 failed with CUDA error {err}")
        return outs

    return call


def load_b11(checkout: str):
    """The B11 of the commit in ``checkout`` as a function of
    ``approx_max_k``'s arguments (contiguous f32 rows) returning (values,
    indices)."""
    from tvretrieval_tpu_torch.ops import approx_topk as apx

    fn = checkout_entry(checkout, "approx_topk")

    def call(x, k, recall):
        nq, n = x.shape
        vals = torch.empty((nq, k), dtype=torch.float32, device=x.device)
        idx = torch.empty((nq, k), dtype=torch.int32, device=x.device)
        err = fn(x.data_ptr(), nq, n, apx.bins(n, k, recall), k, vals.data_ptr(),
                 idx.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the B11 of {checkout} failed with CUDA error {err}")
        return vals, idx

    return call


def phase_study_path(dev):
    """Phase 9: the stage-study entry point at full width. Returns the
    launches of B7-B10 counted over its second call."""
    from tvretrieval_tpu_torch.ops import _build
    from tvretrieval_tpu_torch.profiling import engine_modes

    def check(records, what):
        for r in records:
            if "MISMATCH" in r.get("exact", "") + r.get("agreement", ""):
                raise AssertionError(f"{what}: {r.get('combo', r.get('kernel'))}: MISMATCH")
            if r["kind"] == "combo":
                if not all(np.isfinite(a).all() for a in r["spans"]) or \
                        r["spans"][3].shape != (N_QUERIES, 200):
                    raise AssertionError(f"{what}: {r['combo']}: bad span candidates")

    parse = engine_modes.build_arg_parser().parse_args
    common = ["--nq", str(N_QUERIES), "--n_videos", str(N_VIDEOS_FULL), "--hidden", str(HIDDEN),
              "--chunk_v", str(CHUNK_V), "--iters", "4", "--warmup", "1"]
    flagship = "simsweep_cat_bf16/pallas_int8/grouped_shift/pad128"
    records = engine_modes.run(parse(common + ["--modes", flagship,
                               "simsweep_cat_bf16/pallas_int8/grouped_shift_psort/pad128/vpsort"]))
    check(records, "flagship combos")
    exact = [r["exact"] for r in records if r["kind"] == "combo"]
    if exact != ["ref", "bit-exact vs " + flagship]:
        raise AssertionError(f"flagship combos: {exact}")
    torch.cuda.empty_cache()

    _build.reset_launch_counts()
    records = engine_modes.run(parse(common + ["--modes", "gather/einsum/grouped",
                                               "gather/einsum/grouped_shift"]))
    launches = engine_modes.launch_counts()
    check(records, "study combos")
    study = {(r["kernel"], r["case"]): r for r in records if r["kind"] == "study"}
    if len(study) != 6:
        raise AssertionError(f"the stage study printed {sorted(study)}")
    limits = {"max_abs_err": B2_ATOL, "max_rel_err": 1e-5}
    for (kernel, case), r in study.items():
        for key, limit in limits.items():
            if key in r and not r[key] <= limit:
                raise AssertionError(f"stage study {kernel} ({case}): {key} {r[key]} > {limit}")
        if kernel == "fused_video_scores_clip_major" and \
                not r["max_err"] <= (B2_ATOL if case == "alpha=None" else 3e-4):
            raise AssertionError(f"stage study {kernel} ({case}): {r['max_err']}")
        if kernel == "banded_topk_spans_fused" and not r["equal"]:
            raise AssertionError(f"stage study {kernel} ({case}): outputs differ")
        if kernel in ("video_scores_masked", "fused_video_scores_clip_major") and not (
                r["masked_exact"] and r["planted_fully_masked"] == 1
                and r["planted_partly_masked"] == 1):
            raise AssertionError(f"stage study {kernel} ({case}): the planted fully masked "
                                 "video is not exactly -1e10 in kernel and stage")
    log("path", f"kernel launches of the stage-study path: {launches}")
    if not all(launches.values()):
        raise AssertionError(f"a study kernel was not launched on its path: {launches}")
    return launches


# phases 3, 5 and 8 of another commit's chip_smoke.py, run from its checkout
# ---------------------------------------------------------------------------
# phase 14: several devices (see phase_sharded)
SHARD_K = 4                        # logical shards of the serving checks
SHARD_KS = (1, 2, 4)               # shard counts timed beside the resident engine
SHARD_STREAM_K = 2                 # shards of the streaming check
SHARD_STREAM_QUERIES = 100         # two batches of STREAM_BSZ
DP_RANKS = 2                       # gloo ranks of the data-parallel training check
DP_STEPS = 8                       # steps an epoch, two epochs: one chunk of SCAN_STEPS each
SHARD_RTOL = 2.0 ** -8             # bf16 flagship, sharded vs resident: one bf16 rounding


def dp_tables(world, builder):
    """The host tables of phase 7's resident world (its float8 context
    table and the train queries' table) and its train rows, built once by
    phase 14 and handed to its ranks pickled."""
    from tvretrieval_tpu_torch.data.device_corpus import ContextTable, QueryTable

    train_rows = world.annotations[:TRAIN_QUERIES - TRAIN_EVAL_QUERIES]
    ctx = ContextTable.build(builder, world.corpus, "float8_e4m3fn")
    tq = QueryTable.build(builder, train_rows, world.corpus, ctx.ctx_l, "float8_e4m3fn")
    return ctx, tq, train_rows


def dp_train(dev, n_devices: int, tables):
    """Two epochs of DP_STEPS steps of the full-width XML (dropout off) at
    phase 7's batch on its resident float8 world (``dp_tables``), as one
    rank of n_devices (or alone): (the per-step overall losses of both
    epochs, ms a step in the second). The device-resident path reads the
    builder's max_desc_l only, and the train rows' count."""
    import types

    from tvretrieval_tpu_torch.data.device_corpus import DeviceData
    from tvretrieval_tpu_torch.models.xml import XMLConfig
    from tvretrieval_tpu_torch.training.xml_trainer import TrainSettings, XMLTrainer

    ctx, tq, train_rows = tables
    dd = DeviceData(ctx_table=ctx, ctx_device=ctx.device_arrays(dev), train_queries=tq)
    cfg = XMLConfig(visual_input_size=3074, sub_input_size=770, query_input_size=768,
                    hidden_size=HIDDEN, n_heads=4, max_ctx_l=N_CLIPS, max_desc_l=30,
                    input_drop=0.0, drop=0.0, cross_att_drop=0.0)
    settings = TrainSettings(bsz=TRAIN_BSZ, scan_steps=SCAN_STEPS, n_epoch=1, lr=TRAIN_LR,
                             seed=0, debug_max_steps=DP_STEPS)
    trainer = XMLTrainer(cfg, settings, types.SimpleNamespace(max_desc_l=30), train_rows,
                         device_data=dd, device=dev, n_devices=n_devices)
    losses, ms = [], 0.0
    for epoch in range(2):     # the second epoch is timed warm
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = trainer.train_epoch(epoch)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / out["steps"]
        losses += [ld["loss_overall"] for ld in trainer.last_step_losses]
    return losses, ms


def dp_rank(rank: int, port: int, tables_path: str, out_dir: str) -> None:
    """One gloo rank of phase 14's data-parallel check, on cuda:0: writes
    its losses, ms a step and B4 launches to ``out_dir/rank<r>.json``."""
    import pickle

    import torch.distributed as dist

    from tvretrieval_tpu_torch.ops import _build

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    with open(tables_path, "rb") as f:
        tables = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=DP_RANKS, rank=rank)
    try:
        _build.reset_launch_counts()
        losses, ms = dp_train(torch.device("cuda", 0), DP_RANKS, tables)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(dict(losses=losses, ms=ms, b4=_build.LAUNCHES["gather_byte_rows"]), f)
    finally:
        dist.destroy_process_group()


# (d) the baselines' data-parallel trainers: phase 12's widths and flags,
# a world of DPB_VIDEOS videos that each rank makes again from its seed
DPB_STEPS = 4                      # steps an epoch, two epochs
DPB_VIDEOS = 64
# first-step loss, 2 ranks against one process on the card, relative:
# MEE's f32 sums in another order; CAL and ExCL phase 10's recurrent span
# rtol (cuDNN's LSTMs see batches of 64 instead of 128)
DPB_RTOL = {"mee": 1e-5, "cal": VARIANT_TOL["lstm"][1], "excl": VARIANT_TOL["lstm"][1]}


def dpb_world():
    """(d)'s world: phase 7's widths (3,072 / 768 / 768 features, 100
    clips) over DPB_VIDEOS videos, and DPB_STEPS batches of queries."""
    from tvretrieval_tpu_torch.data.datasets import ExampleBuilder
    from tvretrieval_tpu_torch.data.synthetic import make_synthetic_world

    world = make_synthetic_world(n_videos=DPB_VIDEOS, n_queries=TRAIN_BSZ * DPB_STEPS,
                                 vid_dim=3072, text_dim=768, query_dim=768,
                                 max_clips=N_CLIPS, seed=1)
    return world, ExampleBuilder(
        query_source=world.query_source, video_source=world.video_source,
        sub_source=world.sub_source, ctx_mode="video_sub_tef", max_desc_l=30,
        max_ctx_l=N_CLIPS, clip_length=world.clip_length)


def dpb_train(kind: str, dev, n_devices: int, env):
    """Two epochs of DPB_STEPS steps of train_<kind>'s trainer (its CLI's
    flags in phase 12, batch TRAIN_BSZ) on ``env`` (``dpb_world``), as one
    rank of n_devices (or alone): (the per-step losses, ms a step in the
    second epoch)."""
    from tvretrieval_tpu_torch.training import train_cal, train_excl, train_mee

    module = {"mee": train_mee, "cal": train_cal, "excl": train_excl}[kind]
    args = module.build_arg_parser().parse_args(
        ["--bsz", str(TRAIN_BSZ), "--seed", "0"] + BASE_TRAIN_FLAGS[kind])
    rows, _, builder, _ = baseline_world(kind, *env)(args)
    trainer = module.make_trainer(args, module.model_config(args, builder), builder,
                                  rows[:TRAIN_BSZ * DPB_STEPS], dev, n_devices)
    losses, ms = [], 0.0
    for epoch in range(2):     # the second epoch is timed warm
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        trainer.train_epoch(epoch)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / len(trainer.last_step_losses)
        losses += [r["loss"] for r in trainer.last_step_losses]
    return losses, ms


def hand_kernel_counts():
    """Every wrapper's launch count, by kernel (``_build.KERNELS``: the
    span-head kernel ``excl_head`` among them)."""
    from tvretrieval_tpu_torch.ops import _build
    return dict(_build.LAUNCHES)


def dpb_rank(rank: int, port: int, out_dir: str) -> None:
    """One gloo rank of phase 14 (d), on cuda:0: each baseline's losses and
    ms a step, and the hand kernels' launches, to ``out_dir/rank<r>.json``."""
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // DP_RANKS))
    env = dpb_world()
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=DP_RANKS, rank=rank)
    try:
        out = {kind: dpb_train(kind, torch.device("cuda", 0), DP_RANKS, env)
               for kind in ("mee", "cal", "excl")}
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(dict(runs=out, launches=hand_kernel_counts()), f)
    finally:
        dist.destroy_process_group()


def phase_dp_baselines(dev):
    """Phase 14 (d): train_mee's, train_cal's and train_excl's trainers on
    DP_RANKS gloo ranks sharing cuda:0 (one spawn), each rank building the
    global batch of TRAIN_BSZ and training on its half, against one process
    on the card: the first step's loss within DPB_RTOL, the loss falling
    (the second epoch's mean below the first's: the same rows), no hand
    kernel launched, ms a step beside one process's."""
    import socket
    import tempfile

    import torch.multiprocessing as mp

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        mp.start_processes(dpb_rank, args=(port, tmp), nprocs=DP_RANKS, join=True,
                           start_method="spawn")
        t_ranks = time.perf_counter() - t0
        ranks = []
        for r in range(DP_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    launches = {k: n for r in ranks for k, n in r["launches"].items() if n}
    before = hand_kernel_counts()
    env = dpb_world()
    failed = []
    for kind in ("mee", "cal", "excl"):
        (dp_losses, dp_ms), (r1_losses, _) = ranks[0]["runs"][kind], ranks[1]["runs"][kind]
        one_losses, one_ms = dpb_train(kind, dev, 1, env)
        err = abs(dp_losses[0] - one_losses[0]) / abs(one_losses[0])
        first, second = (float(np.mean(dp_losses[i * DPB_STEPS:(i + 1) * DPB_STEPS]))
                         for i in range(2))
        log("sharded", f"data-parallel {kind.upper()}, {DP_RANKS} gloo ranks on {dev}, "
            f"2 x {DPB_STEPS} steps of the global batch {TRAIN_BSZ} at phase 12's widths: "
            f"loss per step " + " ".join(f"{x:.4f}" for x in dp_losses)
            + "; one process: " + " ".join(f"{x:.4f}" for x in one_losses)
            + f"; first step rel |d| {err:.3e} (bound {DPB_RTOL[kind]:.0e}); epoch means "
            f"{first:.4f} -> {second:.4f}; {dp_ms:.2f} ms a step on {DP_RANKS} ranks sharing "
            f"the card against {one_ms:.2f} ms alone (second epoch)")
        if not (np.isfinite(dp_losses).all() and r1_losses == dp_losses
                and err <= DPB_RTOL[kind] and second < first):
            failed.append(kind)
    launches.update({k: n - before[k] for k, n in hand_kernel_counts().items()
                     if n != before[k]})
    log("sharded", f"(d) ranks started and trained in {t_ranks:.1f} s; hand-kernel launches "
        f"{launches}")
    if failed or launches:
        raise AssertionError(f"data-parallel baselines {failed} (first-step loss, equal "
                             f"ranks, falling loss); hand-kernel launches {launches}")


def phase_sharded(dev, dp_env=None):
    """Phase 14: several devices, with SHARD_K logical shards on the one
    card (``make_mesh(k, devices=["cuda:0"] * k)``; each shard's kernels on
    its own slice). (a) corpus-sharded serving at the flagship's full width
    (21,818 videos x 100 clips, 1,000 queries, bench.py's cache synthesized
    on the card) against the resident engine on the same cache, in four
    configurations: the bf16 flagship (B1; indices equal outside near-ties,
    scores within SHARD_RTOL), shipped (B1, B11 at recall 0.90; each site's
    tie-aware recall on every shard's rows >= 0.90), all-int8 psort (B1,
    B5, B6) and all-int8 fused (B3, B5, B6), the last two bit-equal in
    every output; each kernel's launches SHARD_K times the resident
    engine's a batch; one more batch of each under
    ``torch.cuda.set_sync_debug_mode("error")`` (the shard loop never
    waits for the card); q/s of the bf16 flagship and the all-int8 psort at
    SHARD_KS shards beside the resident engine's. (b) the streaming engine
    with a SHARD_STREAM_K-shard mesh at phase 11's corpus, flat (B2) and
    flat_int8 (B1): every output bit-equal to streaming without a mesh, B1
    / B2 SHARD_STREAM_K times a block, q/s beside it. (c) data-parallel
    XML training on DP_RANKS gloo ranks, each on cuda:0, at phase 7's
    shape (batch 128, 1,024 resident videos, dropout off): DP_STEPS steps,
    the first step's loss within LOSS_ATOL of one process training the
    same global batches, the loss falling, ms a step beside it. (d) the
    baselines' data-parallel trainers (``phase_dp_baselines``). NCCL needs
    distinct cards and is not run here. ``dp_env``: phase 7's (world,
    builder), built here when None; its host tables go to the ranks.
    Returns the kernel launches of (a), (b) and (c)'s ranks (B4, counted
    in their processes); (d) launches none."""
    import torch.multiprocessing as mp

    from tvretrieval_tpu_torch.models.xml import XML, XMLConfig
    from tvretrieval_tpu_torch.ops import _build
    from tvretrieval_tpu_torch.ops import approx_topk as apx
    from tvretrieval_tpu_torch.ops import video_score as vs
    from tvretrieval_tpu_torch.parallel.mesh import make_mesh
    from tvretrieval_tpu_torch.parallel import sharded_retrieval as sr
    from tvretrieval_tpu_torch.retrieval import streaming as st
    from tvretrieval_tpu_torch.retrieval.engine import (
        CorpusCache, RetrievalConfig, _maybe_pad_clip_axis, _score_query_batch)
    from tvretrieval_tpu_torch.testing import rank_mismatches, tie_aware_recall, within

    t_phase = time.perf_counter()
    reset, read = _build.reset_launch_counts, lambda: dict(_build.LAUNCHES)
    total = {k: 0 for k in read()}

    # ---- (a) sharded serving at the full corpus
    nv, nq = N_VIDEOS_FULL, N_QUERIES
    model = XML(XMLConfig(visual_input_size=3074, sub_input_size=770, query_input_size=768,
                          hidden_size=HIDDEN, n_heads=4, max_ctx_l=N_CLIPS, max_desc_l=30)
                ).init_weights(torch.Generator().manual_seed(0)).eval().to(dev)
    gen = torch.Generator(device=dev).manual_seed(14)
    mask = torch.ones((nv, N_CLIPS), device=dev)
    vf1, sf1 = (unit((nv, N_CLIPS, HIDDEN), gen, dev).to(torch.bfloat16) for _ in range(2))
    feat2_raw = torch.randn((nv, N_CLIPS, 2 * HIDDEN), generator=gen,
                            device=dev).to(torch.bfloat16)
    q_feat = torch.randn((nq, 30, 768), generator=gen, device=dev)
    q_mask = torch.ones((nq, 30), device=dev)
    gt = torch.randint(0, nv, (nq,), generator=gen, device=dev)
    base = dict(cache_dtype_str="bfloat16", video_chunk_v=CHUNK_V)
    configs = {
        "bf16 flagship": RetrievalConfig(**base, span_score_mode="simsweep_cat_bf16",
                                         video_score_mode="pallas_int8",
                                         span_topk_mode="grouped_shift", span_sim_pad_l=128),
        "shipped": RetrievalConfig(**base, span_score_mode="simsweep_cat_bf16",
                                   video_score_mode="pallas_int8",
                                   span_topk_mode="grouped_shift_approx",
                                   video_topk_approx=True, topk_approx_recall=SHIPPED_RECALL,
                                   span_sim_pad_l=128),
        "all-int8 psort": RetrievalConfig(**base, span_score_mode="simsweep_cat_int8_flat",
                                          video_score_mode="pallas_int8",
                                          span_topk_mode="grouped_shift_psort",
                                          video_topk_psort=True),
        "all-int8 fused": RetrievalConfig(**base, span_score_mode="simsweep_cat_int8_flat",
                                          video_score_mode="pallas_int8",
                                          span_topk_mode="grouped_shift_psort",
                                          video_topk_fused=True),
    }

    def resident(cfg):
        f1 = [vs.build_flat_feat1(f, mask, chunk_v=CHUNK_V) for f in (vf1, sf1)]
        f1 = [vs.quantize_unit_i8(f) for f in f1]
        if cfg.span_score_mode == "simsweep_cat_int8_flat":
            f2, f2s = vs.build_flat_feat2_i8(feat2_raw, lp=vs.flat_lp(feat2_raw.shape[1]),
                                           chunk_v=CHUNK_V)
        else:
            f2, f2s = _maybe_pad_clip_axis(feat2_raw, cfg), None
        return lambda: _score_query_batch(model, cfg, q_feat, q_mask, f1[0], None, f1[1], None,
                                          mask, gt, True, feat2_cat=f2, feat2_cat_scale=f2s)

    def sharded(cfg, k):
        mesh = make_mesh(k, devices=[str(dev)] * k)
        flat8 = cfg.span_score_mode == "simsweep_cat_int8_flat"
        cache = CorpusCache(vf1, None, sf1, None, mask, nv, [],
                            feat2_cat=feat2_raw if flat8 else _maybe_pad_clip_axis(feat2_raw, cfg))
        sc = sr.shard_corpus_cache(cache, mesh, cfg)
        vf2, sf2 = sr.cat_mode_feat2_args(sc)
        models = sr.replicate_model(model, mesh)
        return lambda: sr.score_query_batch_sharded(model, cfg, q_feat, q_mask, sc.video_feat1,
                                                    vf2, sc.sub_feat1, sf2, sc.mask, gt, True,
                                                    mesh, models=models)

    def timed(run):
        for _ in range(WARMUP_RUNS):
            run()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(TIMED_RUNS):
            run()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / TIMED_RUNS

    def host(out):
        o = {k: v.cpu().numpy() for k, v in out.items()}
        if "vcmr_vid_local" in o:
            o["vcmr_vid_global"] = np.take_along_axis(o["topv_idx"], o.pop("vcmr_vid_local"),
                                                      1).astype(np.int32)
        return o

    keys = lambda o, task: ((o["vcmr_vid_global"].astype(np.int64) if task == "vcmr" else 0)
                            * 1000 + o[f"{task}_st"].astype(np.int64)) * 1000 + o[f"{task}_ed"]
    qps = {}
    for name, cfg in configs.items():
        torch.cuda.empty_cache()
        res_run, sh_run = resident(cfg), sharded(cfg, SHARD_K)
        reset()
        ro = host(res_run())
        want = {k: SHARD_K * n for k, n in read().items()}
        reset()
        if name == "shipped":
            calls = record_approx(apx, sh_run)
            so = None
        else:
            so = host(sh_run())
        got = read()
        for k, n in got.items():
            total[k] += n
        if got != want:
            raise AssertionError(f"sharded {name}: kernel launches {got}, expected {SHARD_K} "
                                 f"times the resident engine's, {want}")
        line = f"launches a batch {({k: n for k, n in got.items() if n})}"
        if name == "shipped":
            per_site = {}
            # in call order: every shard's video site, then each shard's two span sites
            sites = ([APPROX_SITES[0][0]] * SHARD_K
                     + [s for _ in range(SHARD_K) for s in (APPROX_SITES[1][0],
                                                            APPROX_SITES[2][0])])
            if len(calls) != 3 * SHARD_K:
                raise AssertionError(f"sharded shipped: {len(calls)} approximate selections")
            for site, (x, k, recall, (vals, _)) in zip(sites, calls):
                r = tie_aware_recall(torch.topk(x, k).values.cpu().numpy(), vals.cpu().numpy())
                per_site.setdefault(site, []).append((r, tuple(x.shape), k,
                                                      apx.bins(x.shape[1], k, recall)))
            line += "; per shard (recall, rows, k, bins): " + json.dumps(per_site)
            if min(r for v in per_site.values() for r, *_ in v) < SHIPPED_RECALL:
                raise AssertionError(f"sharded shipped: a site's recall is below "
                                     f"{SHIPPED_RECALL}: {per_site}")
        elif name.startswith("all-int8"):
            differ = [k for k in ro if not np.array_equal(ro[k], so[k])]
            line += f"; outputs not bit-equal to the resident engine: {differ}"
            if differ or set(ro) != set(so):
                raise AssertionError(f"sharded {name} differs from the resident engine: {line}")
        else:
            ok = (np.array_equal(so["topv_idx"], ro["topv_idx"])
                  and within(ro["topv_scores"], so["topv_scores"], rtol=SHARD_RTOL)
                  and within(ro["vcmr_scores"], so["vcmr_scores"], rtol=SHARD_RTOL)
                  and within(ro["svmr_scores"], so["svmr_scores"], rtol=SHARD_RTOL))
            bad = {t: rank_mismatches(keys(ro, t), ro[f"{t}_scores"], keys(so, t),
                                      rtol=2 * SHARD_RTOL) for t in ("vcmr", "svmr")}
            same = [k for k in ro if np.array_equal(ro[k], so[k])]
            line += (f"; VCMR scores max rel |d| "
                     f"{np.max(np.abs(so['vcmr_scores'] - ro['vcmr_scores']) / ro['vcmr_scores']):.3e}"
                     f", moment mismatches outside near-ties {bad}; bit-equal: {same}")
            if not ok or any(bad.values()):
                raise AssertionError(f"sharded {name} differs from the resident engine: {line}")
        # the shard loop never waits for the card: a synchronising call raises here
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            sh_run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        log("sharded", f"{name}, {SHARD_K} shards on {dev}, Nq={nq} x Nv={nv}: {line}; a "
            "batch under torch.cuda.set_sync_debug_mode('error'): no synchronisation")
        if name in ("bf16 flagship", "all-int8 psort"):
            qps[name] = {"resident": nq * 1000.0 / timed(res_run)}
            del sh_run
            for k in SHARD_KS:
                torch.cuda.empty_cache()
                reset()
                run = sharded(cfg, k)
                qps[name][k] = nq * 1000.0 / timed(run)
                for kk, n in read().items():
                    total[kk] += n
                if k == SHARD_K:
                    from torch.profiler import ProfilerActivity, profile
                    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                        run()
                        torch.cuda.synchronize()
                    busy = device_time_ms(prof)
                    ms = nq * 1000.0 / qps[name][k]
                    log("sharded", f"{name}, {k} shards: {busy:.3f} ms of device time in a "
                        f"batch (profiled) = {100 * busy / ms:.1f}% busy of the {ms:.2f} ms "
                        "measured without the profiler")
                del run
        del res_run
    torch.cuda.empty_cache()
    log("sharded", "q/s, resident engine and 1 / 2 / 4 logical shards on one card "
        f"({TIMED_RUNS} timed batches after {WARMUP_RUNS}): "
        + "; ".join(f"{n}: resident {v['resident']:.1f}, "
                    + ", ".join(f"{k} shards {v[k]:.1f}" for k in SHARD_KS)
                    for n, v in qps.items()))
    del vf1, sf1, feat2_raw, mask, q_feat, q_mask, gt
    torch.cuda.empty_cache()

    # ---- (b) streaming with a mesh at phase 11's corpus
    t_b = time.perf_counter()
    cache = stream_cache(dev)
    sgen = torch.Generator(device=dev).manual_seed(15)
    q_feat = torch.randn((SHARD_STREAM_QUERIES, 30, 768), generator=sgen, device=dev)
    q_mask = torch.ones((SHARD_STREAM_QUERIES, 30), device=dev)
    gt = torch.randint(0, N_VIDEOS_FULL, (SHARD_STREAM_QUERIES,), generator=sgen, device=dev)
    mesh = make_mesh(SHARD_STREAM_K, devices=[str(dev)] * SHARD_STREAM_K)
    n_blocks = -(-N_VIDEOS_FULL // STREAM_BLOCK)
    kernel = {"flat": "video_scores_flat", "flat_int8": "video_scores_flat_i8"}
    scfg = RetrievalConfig(span_score_mode="gather", query_bsz=STREAM_BSZ,
                           span_topk_mode="grouped_shift", video_chunk_v=CHUNK_V)
    for mode in ("flat", "flat_int8"):
        hc = st.host_cache_from_device(cache, flat=True, int8=mode == "flat_int8")
        batches = [slice(i, i + STREAM_BSZ) for i in range(0, SHARD_STREAM_QUERIES, STREAM_BSZ)]
        run = lambda m, b: st.streaming_score_query_batch(
            model, scfg, q_feat[b], q_mask[b], hc, gt_meta_idx=gt[b], block_videos=STREAM_BLOCK,
            mesh=m)
        ms = {}
        for label, m in (("without a mesh", None), (f"{SHARD_STREAM_K} shards", mesh)):
            run(m, batches[0])                            # warm
            torch.cuda.synchronize()
            reset()
            t0 = time.perf_counter()
            outs = [host(run(m, b)) for b in batches]
            ms[label] = (time.perf_counter() - t0) * 1e3 / len(batches)
            got = read()
            want_n = len(batches) * n_blocks * (1 if m is None else SHARD_STREAM_K)
            if got[kernel[mode]] != want_n or sum(got.values()) != want_n:
                raise AssertionError(f"streaming {mode} {label}: launches {got}, expected "
                                     f"{want_n} of {kernel[mode]} and nothing else")
            if m is not None:
                for kk, n in got.items():
                    total[kk] += n
                differ = sorted({k for a, b in zip(outs, ref) for k in a
                                 if not np.array_equal(a[k], b[k])})
                if differ:
                    raise AssertionError(f"streaming {mode} with {SHARD_STREAM_K} shards "
                                         f"differs from streaming without: {differ}")
            ref = outs
        log("sharded", f"streaming {mode}, {N_VIDEOS_FULL} videos in blocks of {STREAM_BLOCK}, "
            f"{SHARD_STREAM_QUERIES} queries in batches of {STREAM_BSZ}: every output "
            f"bit-equal with {SHARD_STREAM_K} shards; {kernel[mode]} {SHARD_STREAM_K} times "
            "a block; host ms a batch " + ", ".join(f"{k} {v:.1f} ({STREAM_BSZ * 1e3 / v:.1f} "
                                                   f"q/s)" for k, v in ms.items()))
        del hc
    del cache, model
    torch.cuda.empty_cache()

    # ---- (c) data-parallel training on DP_RANKS gloo ranks, each on cuda:0
    import pickle
    import socket
    import tempfile
    t_c = time.perf_counter()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    if dp_env is None:
        from tvretrieval_tpu_torch.data.datasets import ExampleBuilder
        from tvretrieval_tpu_torch.data.synthetic import make_synthetic_world

        world = make_synthetic_world(n_videos=TRAIN_VIDEOS, n_queries=TRAIN_QUERIES,
                                     vid_dim=3072, text_dim=768, query_dim=768,
                                     max_clips=N_CLIPS, seed=1)
        dp_env = (world, ExampleBuilder(
            query_source=world.query_source, video_source=world.video_source,
            sub_source=world.sub_source, ctx_mode="video_sub_tef", max_desc_l=30,
            max_ctx_l=N_CLIPS, clip_length=world.clip_length))
    tables = dp_tables(*dp_env)
    with tempfile.TemporaryDirectory() as tmp:
        tables_path = os.path.join(tmp, "tables.pkl")
        with open(tables_path, "wb") as f:
            pickle.dump(tables, f, protocol=pickle.HIGHEST_PROTOCOL)
        t0 = time.perf_counter()
        mp.start_processes(dp_rank, args=(port, tables_path, tmp), nprocs=DP_RANKS,
                           join=True, start_method="spawn")
        t1 = time.perf_counter()
        ranks = []
        for r in range(DP_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    dp_losses, dp_ms = ranks[0]["losses"], ranks[0]["ms"]
    # B4 in the ranks' processes: two gathers of a rank's rows a step
    b4 = [r["b4"] for r in ranks]
    if b4 != [2 * 2 * DP_STEPS] * DP_RANKS or ranks[1]["losses"] != dp_losses:
        raise AssertionError(f"data-parallel ranks: B4 launches {b4} (expected "
                             f"{4 * DP_STEPS} each), losses equal across ranks "
                             f"{ranks[1]['losses'] == dp_losses}")
    total["gather_byte_rows"] += sum(b4)
    one_losses, one_ms = dp_train(dev, 1, tables)
    del tables
    err = abs(dp_losses[0] - one_losses[0])
    first, last = float(np.mean(dp_losses[:2])), float(np.mean(dp_losses[-2:]))
    log("sharded", f"data-parallel XML, {DP_RANKS} gloo ranks on {dev} (ranks started and "
        f"trained in {t1 - t0:.1f} s), 2 x {DP_STEPS} steps of the global batch {TRAIN_BSZ} "
        f"on phase 7's resident world, dropout off: loss per step "
        + " ".join(f"{x:.4f}" for x in dp_losses)
        + f"; one process: " + " ".join(f"{x:.4f}" for x in one_losses)
        + f"; first step |d| {err:.3e} (bound {LOSS_ATOL}); B4 launches by rank {b4}; "
        f"{dp_ms:.2f} ms a step on "
        f"{DP_RANKS} ranks sharing the card against {one_ms:.2f} ms alone (second epoch)")
    if not (np.isfinite(dp_losses).all() and err <= LOSS_ATOL and last < first):
        raise AssertionError(f"data-parallel training: first-step |d| {err}, mean loss of the "
                             f"first two steps {first} -> last two {last}")
    t_d = time.perf_counter()
    phase_dp_baselines(dev)
    t_end = time.perf_counter()
    log("sharded", f"phase 14 took {t_end - t_phase:.1f} s ((a) {t_b - t_phase:.1f} s, (b) "
        f"{t_c - t_b:.1f} s, (c) {t_d - t_c:.1f} s, (d) {t_end - t_d:.1f} s); kernel launches "
        f"{({k: n for k, n in total.items() if n})}")
    return total


PARENT_PHASES = """
import sys
from concurrent.futures import ThreadPoolExecutor
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from tvretrieval_tpu_torch.ops import _build, sort as tsort, video_score as vs
with ThreadPoolExecutor() as pool:
    list(pool.map(_build.build, _build.SOURCES))
dev = torch.device("cuda", 0)
rec = cs.phase_kernels(dev, vs)
torch.cuda.empty_cache()
rec["B5"] = cs.phase_span_sim(dev, vs)
torch.cuda.empty_cache()
rec["B6"] = cs.phase_topk_sort(dev, tsort)
torch.cuda.empty_cache()
cs.phase_throughput(dev, rec, "")
torch.cuda.empty_cache()
cs.phase_study_kernels(dev, vs)
"""


def run_parent(parent_dir: str, label: str) -> None:
    """Phases 3, 5 and 8 of the chip_smoke.py in ``parent_dir`` (a git
    archive of another commit), in a process of its own on this card; its
    lines are printed with ``label``."""
    if not os.path.isfile(os.path.join(parent_dir, "chip_smoke.py")):
        raise AssertionError(f"--parent {parent_dir}: no chip_smoke.py there")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", PARENT_PHASES], cwd=parent_dir,
                          capture_output=True, text=True)
    for line in proc.stdout.splitlines():
        print(f"[{label}] {line}", flush=True)
    if proc.returncode:
        raise AssertionError(f"{label} exited {proc.returncode}: {proc.stderr[-3000:]}")
    log(label, f"phases 3, 5 and 8 of {parent_dir} took {time.perf_counter() - t0:.1f} s")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", default="", help="write a torch.profiler trace of one "
                    "throughput batch to this directory, and print the profile of it "
                    "and of one training epoch")
    ap.add_argument("--parent", default="", help="a checkout of another commit (git "
                    "archive): run its phases 3, 5 and 8 before and after this run's, on "
                    "the same card")
    ap.add_argument("--int8-repeats", type=int, default=1, help="run the card side of "
                    "phase 4's int8 runs this many times, each on the int8 grid and equal "
                    "to the first")
    args = ap.parse_args()
    t_start = time.perf_counter()

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tvretrieval_tpu_torch.ops import _build
    from tvretrieval_tpu_torch.ops import approx_topk as apx
    from tvretrieval_tpu_torch.ops import gather as gt
    from tvretrieval_tpu_torch.ops import sort as tsort
    from tvretrieval_tpu_torch.ops import video_score as vs

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log("device", f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; count {torch.cuda.device_count()}")

    if args.parent:
        run_parent(args.parent, "parent 1")
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with ThreadPoolExecutor() as pool:      # one nvcc per source, side by side
        reports = dict(zip(_build.SOURCES, pool.map(_build.build, _build.SOURCES)))
    log("build", f"{len(reports)} kernel libraries built in {time.perf_counter() - t0:.1f} s")
    log("build", check_tensor_cores(_build))
    ceiling = probe_mma(dev, _build)
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log("build", f"{name}: {line.strip()}")

    rec = phase_kernels(dev, vs, ceiling)
    torch.cuda.empty_cache()
    rec["B5"] = phase_span_sim(dev, vs, ceiling)
    torch.cuda.empty_cache()
    rec["B6"] = phase_topk_sort(dev, tsort)
    torch.cuda.empty_cache()
    rec["B11"] = phase_approx_topk(
        dev, apx, {"parent": load_b11(args.parent)} if args.parent else None)
    torch.cuda.empty_cache()

    _build.reset_launch_counts()
    metrics, e2e_world = phase_end_to_end(dev, args.int8_repeats)
    launches = {k: _build.LAUNCHES[k] for k in MAIN_PATH_KERNELS}
    log("e2e", f"kernel launches on the main path: {launches}")
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the main path was not launched: {launches}")
    for task in ("VCMR", "SVMR", "VR"):
        log("e2e", f"{task} metrics (card run, random weights): "
            f"{json.dumps(metrics[task])}")
    torch.cuda.empty_cache()

    launches_tp = phase_throughput(dev, rec, args.profile)
    torch.cuda.empty_cache()

    rec["B4"] = phase_gather(dev, gt)
    launches["gather_byte_rows"], train_env = phase_train(dev, rec["B4"], args.profile)
    torch.cuda.empty_cache()

    rec.update(phase_study_kernels(dev, vs, ceiling,
                                   load_parent_b8(args.parent) if args.parent else None))
    torch.cuda.empty_cache()
    launches.update(phase_study_path(dev))
    torch.cuda.empty_cache()
    for name, n in phase_variants(dev, e2e_world, train_env, args.profile).items():
        launches[name] = launches.get(name, 0) + n
    # phase 12 reuses the host worlds of phases 4 and 7, not phase 7's device tables
    base_env = (e2e_world, train_env["world"], train_env["builder"])
    del e2e_world, train_env
    torch.cuda.empty_cache()
    launches_stream = phase_streaming(dev)
    torch.cuda.empty_cache()
    phase_baselines(dev, *base_env)
    dp_env = base_env[1:]       # phase 7's host world, for phase 14's training ranks
    del base_env
    torch.cuda.empty_cache()
    phase_features(dev)
    torch.cuda.empty_cache()
    launches_sharded = phase_sharded(dev, dp_env)
    del dp_env

    if args.parent:
        torch.cuda.empty_cache()
        run_parent(args.parent, "parent 2")
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "flax", "optax", "tvretrieval_tpu")]
    if bad:
        raise AssertionError(f"JAX or the JAX package was imported: {bad}")
    vs_src, gt_src, ss_src, ts_src, ms_src, gs_src, bt_src, ax_src = (
        f"tvretrieval_tpu_torch/csrc/{n}.cu" for n in (
            "video_score", "gather", "span_sim", "topk_sort", "masked_score", "gathered_sim",
            "banded_topk", "approx_topk"))
    table = [("B1", "video_scores_flat_i8", vs_src, "tvretrieval_tpu/ops/pallas_score.py:363"),
             ("B2", "video_scores_flat", vs_src, "tvretrieval_tpu/ops/pallas_score.py:133"),
             ("B3", "video_scores_flat_bmax", vs_src, "tvretrieval_tpu/ops/pallas_score.py:290"),
             ("B4", "gather_byte_rows", gt_src, "tvretrieval_tpu/ops/pallas_gather.py:183"),
             ("B5", "span_sim_cat_i8", ss_src, "tvretrieval_tpu/ops/pallas_score.py:437"),
             ("B6", "topk_transposed", ts_src, "tvretrieval_tpu/ops/pallas_sort.py:171"),
             ("B7", "gathered_similarity", gs_src, "tvretrieval_tpu/ops/pallas_gather.py:100"),
             ("B8", "banded_topk_spans_fused", bt_src, "tvretrieval_tpu/ops/pallas_topk.py:197"),
             ("B9", "video_scores_masked", ms_src, "tvretrieval_tpu/ops/pallas_score.py:67"),
             ("B10", "fused_video_scores_clip_major", ms_src,
              "tvretrieval_tpu/ops/pallas_kernels.py:67"),
             # the TPU's hardware approximate top-k, which no Pallas kernel holds
             ("B11", "approx_max_k", ax_src, "tvretrieval_tpu/retrieval/engine.py:597")]
    log("smoke", f"every phase took {time.perf_counter() - t_start:.1f} s, the kernel builds "
        f"included{' and the parent phases' if args.parent else ''}")
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # B2, B3, B9, B10: the bf16 kind (B3: int8) in the keys, the other
    # kinds' readings beside them
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": where,
         "launches": launches[name], "launches_throughput": launches_tp[name],
         "launches_streaming": launches_stream[name],
         "launches_sharded": launches_sharded[name],
         **{k: rec[b][k] for k in keys},
         **{kind: rec[b][kind] for kind in ("bf16", "f32", "library_call", "per_site",
                                            "lp128") if kind in rec[b]}}
        for b, name, src, where in table]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
