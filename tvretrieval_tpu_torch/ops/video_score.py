"""Corpus video-score stage and int8 span sweep: flat feat1 / feat2 caches,
int8 quantizers, and the CUDA kernels with their plain PyTorch versions.

Port of tvretrieval_tpu/ops/pallas_score.py:124-228, 344-619.
The reference ops are model_xml.py:436-453 (``get_video_level_scores``:
einsum -> mask -> max over clips) against the whole corpus per query batch
(inference.py:308-317), and model_xml.py:463-480 (the span similarity).

Kernel wrappers, each beside its plain version:

- ``video_scores_flat_i8``   (B1, replaces ``video_scores_pallas_flat_i8``)
- ``video_scores_flat``      (B2, replaces ``video_scores_pallas_flat``)
- ``video_scores_flat_bmax`` (B3, replaces ``video_scores_pallas_flat_bmax``)
- ``span_sim_cat_i8``        (B5, replaces ``span_sim_pallas_cat_i8``)
- ``video_scores_masked``    (B9, replaces ``video_scores_pallas``: the
  unflattened (Nv, L, D) caches with the mask applied in the kernel; a
  measured alternative to the einsum stage, run by profiling.engine_modes)

B1-B3 are csrc/video_score.cu, B5 is csrc/span_sim.cu, B9 is
csrc/masked_score.cu (which ops.fused_score shares for B10).

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises (``ops._build.launch`` counts the launch
by wrapper name).

What bounds the video-score kernels on the H100 is arithmetic: 2 x Nv_pad
* lp x D x Nq MACs (1.16e12 at the full corpus, Nq=1000) on the tensor
cores through ``wgmma`` fed by TMA (csrc/s8_wgmma.cuh): int8, bf16, and f32
as three TF32 products (a 3xTF32 split that keeps f32 accuracy); the (Nq,
Nv_pad * lp) dot matrix never reaches device memory. B9 does the same on the unflattened caches, the mask applied per
clip. B5 does Nv_pad * lp x 2D x Nq MACs through s8 ``wgmma`` (lp =
flat_lp(L) in the engine's cache) and writes the rescaled similarity as
bf16 by TMA stores (bound by those bytes); its s32 dots never reach device
memory. See the sources for the tiling.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from tvretrieval_tpu_torch.ops import _build
from tvretrieval_tpu_torch.ops.masking import NEG_INF

# f32(0.5 / 127^2), rounded once from double like JAX's weak-typed
# constant; as a Python float it is exact in f32, so the multiply rounds once
I8_SCALE = float(np.float32(0.5 / (127.0 * 127.0)))
_INV_127 = float(np.float32(1.0 / 127.0))

# rows per video of the flat int8 feat2 cache in the JAX package (its
# kernel needs lp % 128 == 0): the default of ``build_flat_feat2_i8`` and
# the plain version, so that the parity tests build the JAX cache's bytes.
# The engines build theirs at flat_lp(L) rows a video (104 at L = 100: 3.9%
# pad rows against 21.9% at 128), which B5 sweeps as flat rows.
SPAN_LP = 128

# the longest feature rows the tensor-core kernels take: query tiles stay
# in the block's shared memory (csrc/video_score.cu::kI8MaxRowBytes,
# Bf16Wg / Tf32x3Wg::kMaxRowBytes; csrc/masked_score.cu::kMaxD)
I8_MAX_D = 384
BF16_MAX_D = 512
F32_MAX_D = 640
MASKED_MAX_D = 768

def flat_lp(L: int) -> int:
    """Rows per video in the flat cache: L rounded up to a multiple of 8."""
    return -(-L // 8) * 8


def build_flat_feat1(feat1: torch.Tensor, mask: torch.Tensor,
                     lp: Optional[int] = None, chunk_v: int = 16) -> torch.Tensor:
    """(Nv, L, D) feat1 + (Nv, L) mask -> mask-free (Nv_pad * lp, D) flat
    cache for the video-score kernels (one-time, at cache build).

    Masked clips and the L -> lp length pad take each video's FIRST VALID
    clip row (a duplicated valid row can never change the per-video max),
    and videos up to a chunk_v multiple repeat the last real video.
    Raises if a video has no valid clip: its einsum-path score is -1e10,
    which a mask-free cache cannot represent.
    """
    nv, L, d = feat1.shape
    if lp is None:
        lp = flat_lp(L)
    if not (lp % 8 == 0 and lp >= L):
        raise ValueError(f"lp={lp} must be >= L={L} and a multiple of 8")
    if not bool((mask > 0).any(dim=1).all()):
        raise ValueError(
            "build_flat_feat1: some video has no valid clip; the mask-free "
            "flat cache cannot represent its -1e10 score — use "
            "video_score_mode='einsum' for corpora with fully-masked rows")
    fixed = flat_rows(feat1, mask, lp).view(nv, lp, d)
    pad_v = (-nv) % chunk_v
    if pad_v:
        fixed = torch.cat([fixed, fixed[-1:].expand(pad_v, lp, d)], dim=0)
    return fixed.reshape((nv + pad_v) * lp, d).contiguous()


def flat_rows(feat1: torch.Tensor, mask: torch.Tensor, lp: int) -> torch.Tensor:
    """The (Nv * lp, D) video-major rows of ``build_flat_feat1`` without its
    checks and video padding: masked clips and the L -> lp pad take each
    video's first valid clip row, and a video with no valid clip repeats
    its row 0 (the streaming engine flags it invalid). Pure data movement,
    on the tensors' device; the port of the JAX streaming engine's
    ``_flat_feat1_np``."""
    nv, L, d = feat1.shape
    valid = mask > 0
    first_valid = valid.to(torch.int8).argmax(dim=1)             # first 1, else 0
    fill = feat1[torch.arange(nv, device=feat1.device), first_valid]  # (Nv, D)
    fixed = torch.where(valid[:, :, None], feat1, fill[:, None])
    if lp > L:
        fixed = torch.cat([fixed, fill[:, None].expand(nv, lp - L, d)], dim=1)
    return fixed.reshape(nv * lp, d)


def quantize_unit_i8(x: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 quantization of unit-norm rows: round(127 x) clipped
    to [-127, 127]; torch.round rounds half to even, as jnp.round does."""
    return torch.clamp(torch.round(x.float() * 127.0), -127, 127).to(torch.int8)


def quantize_rows_i8(x: torch.Tensor, axis: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization of non-unit rows: scale
    s = max|row| / 127 (at least 1e-12), q = round(x / s) clipped.
    Returns (q int8, scales shaped like x without ``axis``).

    The scale multiplies by f32(1/127) where the JAX source divides by
    127: XLA compiles a division by a constant into that multiplication,
    and the port matches its bytes."""
    x = x.float()
    s = torch.clamp_min(x.abs().amax(dim=axis, keepdim=True) * _INV_127, 1e-12)
    q = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
    return q, s.squeeze(axis)


# ---------------------------------------------------------------- plain
def video_scores_xla(qv, qs, feat1_v, feat1_s, mask) -> torch.Tensor:
    """The engine's einsum path on (Nv, L, D) caches (queries already
    normalized and cast): masked max over clips per stream, averaged.
    Port of pallas_score.video_scores_xla, the exactness reference."""
    m = mask.T[None].float()

    def one(q, f):
        s = torch.einsum("md,nld->mln", q.float(), f.float())
        return (s * m + (1.0 - m) * NEG_INF).amax(dim=1)

    return (one(qv, feat1_v) + one(qs, feat1_s)) / 2


def _flat_max_plain(qt: torch.Tensor, f_flat: torch.Tensor, lp: int,
                    block_videos: int = 512) -> torch.Tensor:
    """(D, Nq) queries x (Nv_pad * lp, D) rows -> (Nv_pad, Nq) max over
    each video's lp row dots, in blocks of videos to bound memory.

    bf16 / f32 inputs multiply in f32 (bf16 products are exact there).
    int8 inputs multiply in f32 too, which is exact while D * 127^2 < 2^24
    (every partial sum is an integer below 2^24, D <= 1040), else in f64;
    the int8 maxima come back as int32."""
    d = f_flat.shape[1]
    int8 = f_flat.dtype == torch.int8
    dt = torch.float64 if int8 and d * 127 * 127 >= 2 ** 24 else torch.float32
    q = qt.to(dt)
    nv_pad = f_flat.shape[0] // lp
    outs = []
    for v0 in range(0, nv_pad, block_videos):
        rows = f_flat[v0 * lp:(v0 + block_videos) * lp].to(dt)
        outs.append((rows @ q).view(-1, lp, q.shape[1]).amax(dim=1))
    m = torch.cat(outs)
    return m.to(torch.int32) if int8 else m.float()


def _combine_plain(mv: torch.Tensor, ms: torch.Tensor) -> torch.Tensor:
    if mv.dtype == torch.int32:
        return (mv + ms).float() * I8_SCALE
    return (mv + ms) / 2


def video_scores_flat_plain(qvt, qst, fv_flat, fs_flat, n_videos: int,
                            lp: int = 104) -> torch.Tensor:
    """Plain version of B1 and B2: (Nq, n_videos) f32 scores."""
    s = _combine_plain(_flat_max_plain(qvt, fv_flat, lp),
                       _flat_max_plain(qst, fs_flat, lp))
    return s.T[:, :n_videos].contiguous()


def video_scores_int8_xla(qv_i8, qs_i8, fv_flat_i8, fs_flat_i8, n_videos: int,
                          lp: int) -> torch.Tensor:
    """Port of pallas_score.video_scores_int8_xla ((Nq, D) int8 queries):
    the integer-exact reference of the int8 kernel."""
    return video_scores_flat_plain(qv_i8.T, qs_i8.T, fv_flat_i8, fs_flat_i8,
                                   n_videos, lp)


def video_scores_flat_bmax_plain(qvt, qst, fv_flat, fs_flat, n_videos: int,
                                 lp: int = 104, chunk_v: int = 16):
    """Plain version of B3: ((Nq, Nv_pad) scores with pad videos at -inf,
    (Nq, Nv_pad / chunk) block maxima), chunk = gcd(Nv_pad, chunk_v)."""
    nv_pad = fv_flat.shape[0] // lp
    chunk = math.gcd(nv_pad, chunk_v)
    s = _combine_plain(_flat_max_plain(qvt, fv_flat, lp),
                       _flat_max_plain(qst, fs_flat, lp)).T.contiguous()
    s[:, n_videos:] = -math.inf
    return s, s.view(s.shape[0], nv_pad // chunk, chunk).amax(dim=2)


# -------------------------------------------------------------- kernels
_KIND = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}


def _launch(name: str, qvt, qst, fv_flat, fs_flat, n_videos: int, lp: int,
            chunk: Optional[int] = None):
    """Check the operands, allocate the outputs, launch on the current
    stream, count the launch. chunk=None: scores only (B1, B2); else B3
    with ``chunk`` videos per block maximum."""
    ts = (qvt, qst, fv_flat, fs_flat)
    dev = fv_flat.device
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError(f"{name}: all operands must be on one CUDA device, got "
                         f"{[str(t.device) for t in ts]}")
    if fv_flat.dtype not in _KIND or any(t.dtype != fv_flat.dtype for t in ts):
        raise TypeError(f"{name}: operands must share one of int8 / bfloat16 / "
                        f"float32, got {[t.dtype for t in ts]}")
    rows, d = fv_flat.shape
    nq = qvt.shape[1]
    if (fs_flat.shape != (rows, d) or qvt.shape != (d, nq) or qst.shape != (d, nq)):
        raise ValueError(f"{name}: shapes {[tuple(t.shape) for t in ts]} are not "
                         "(D, Nq), (D, Nq), (rows, D), (rows, D)")
    if lp % 8 or rows % lp:
        raise ValueError(f"{name}: lp={lp} must be a multiple of 8 dividing {rows} rows")
    nv_pad = rows // lp
    if not 0 < n_videos <= nv_pad:
        raise ValueError(f"{name}: n_videos={n_videos} outside (0, {nv_pad}]")
    row_bytes = d * fv_flat.element_size()
    if row_bytes % 16:
        raise ValueError(f"{name}: a feature row is {row_bytes} bytes; the kernel "
                         "loads 16-byte vectors, so D * itemsize must be a multiple of 16")
    if fv_flat.dtype == torch.int8 and d > I8_MAX_D:
        raise ValueError(f"{name}: D={d} int8 features; the tensor-core kernel holds "
                         f"rows of at most {I8_MAX_D} bytes")
    if fv_flat.dtype == torch.bfloat16 and d > BF16_MAX_D:
        raise ValueError(f"{name}: D={d} bf16 features; the tensor-core kernel holds "
                         f"rows of at most {BF16_MAX_D} features")
    if fv_flat.dtype == torch.float32 and d > F32_MAX_D:
        raise ValueError(f"{name}: D={d} f32 features; the tensor-core kernel holds "
                         f"rows of at most {F32_MAX_D} features")
    if not (fv_flat.is_contiguous() and fs_flat.is_contiguous()):
        raise ValueError(f"{name}: feature caches must be contiguous")
    # the kernel reads (Nq, D) query rows
    qv, qs = qvt.t().contiguous(), qst.t().contiguous()
    if any(t.data_ptr() % 16 for t in (qv, qs, fv_flat, fs_flat)):
        raise ValueError(f"{name}: operands must be 16-byte aligned")
    if chunk is None:
        out = torch.empty((nq, n_videos), dtype=torch.float32, device=dev)
        bmax = None
    else:
        out = torch.empty((nq, nv_pad), dtype=torch.float32, device=dev)
        # the kernel folds block maxima in with atomics: start from -inf
        bmax = torch.full((nq, nv_pad // chunk), -math.inf, dtype=torch.float32,
                          device=dev)
    _build.launch(name, dev, _KIND[fv_flat.dtype], qv.data_ptr(), qs.data_ptr(),
                  fv_flat.data_ptr(), fs_flat.data_ptr(), nq, nv_pad, lp, row_bytes // 4,
                  n_videos, out.data_ptr(), out.shape[1],
                  None if bmax is None else bmax.data_ptr(), chunk or 1)
    return out if bmax is None else (out, bmax)


def video_scores_flat_i8(qvt_i8, qst_i8, fv_flat_i8, fs_flat_i8, n_videos: int,
                         lp: int = 104) -> torch.Tensor:
    """B1: q2c scores over int8 flat caches, (Nq, n_videos) f32.

    qvt_i8 / qst_i8: (D, Nq) int8 quantized normalized queries
    (``quantize_unit_i8(q).T``); fv/fs: (Nv_pad * lp, D) int8 flat caches.
    s8 x s8 -> s32 dots on the tensor cores (``wgmma``), exact integer max
    per video, one f32 rescale: bit-equal to ``video_scores_int8_xla``. D
    (a multiple of 16) is at most ``I8_MAX_D``. (The TPU wrapper's chunk_v only tiles
    its grid, so it has no counterpart here.) Replaces
    pallas_score.video_scores_pallas_flat_i8.
    """
    if fv_flat_i8.device.type == "cpu":
        return video_scores_flat_plain(qvt_i8, qst_i8, fv_flat_i8, fs_flat_i8,
                                       n_videos, lp)
    if fv_flat_i8.dtype != torch.int8:
        raise TypeError(f"video_scores_flat_i8: int8 caches expected, got {fv_flat_i8.dtype}")
    return _launch("video_scores_flat_i8", qvt_i8, qst_i8, fv_flat_i8, fs_flat_i8,
                   n_videos, lp)


def video_scores_flat(qvt, qst, fv_flat, fs_flat, n_videos: int,
                      lp: int = 104) -> torch.Tensor:
    """B2: q2c scores over bf16 / f32 flat caches with f32 accumulation,
    (Nq, n_videos) f32. qvt / qst: (D, Nq) normalized queries cast to the
    cache dtype. Equal to the einsum path up to f32 summation order, on
    the tensor cores: bf16 as exact products with f32 sums (D at most
    ``BF16_MAX_D``), f32 as three TF32 products with f32 sums (D at most
    ``F32_MAX_D``), both within 1e-5 of the plain version for unit-norm
    rows. Replaces pallas_score.video_scores_pallas_flat.
    """
    if fv_flat.device.type == "cpu":
        return video_scores_flat_plain(qvt, qst, fv_flat, fs_flat, n_videos, lp)
    if fv_flat.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"video_scores_flat: bf16 / f32 caches expected, got {fv_flat.dtype}")
    return _launch("video_scores_flat", qvt, qst, fv_flat, fs_flat, n_videos, lp)


def video_scores_flat_bmax(qvt, qst, fv_flat, fs_flat, n_videos: int,
                           lp: int = 104, chunk_v: int = 16):
    """B3: B1 or B2 (by cache dtype) with pad videos at -inf, plus the max
    of every block of chunk = gcd(Nv_pad, chunk_v) videos — chunk_v is an
    upper bound, as in the TPU wrapper. Returns (scores (Nq, Nv_pad),
    bmax (Nq, Nv_pad / chunk)); ops.span.topk_from_block_max consumes them.
    Replaces pallas_score.video_scores_pallas_flat_bmax.
    """
    if fv_flat.device.type == "cpu":
        return video_scores_flat_bmax_plain(qvt, qst, fv_flat, fs_flat, n_videos,
                                            lp, chunk_v)
    chunk = math.gcd(fv_flat.shape[0] // lp, chunk_v)
    return _launch("video_scores_flat_bmax", qvt, qst, fv_flat, fs_flat, n_videos,
                   lp, chunk=chunk)


# ------------------------------------------------------- int8 span sweep
def build_flat_feat2_i8(feat2_cat: torch.Tensor, lp: int = SPAN_LP,
                        chunk_v: int = 16) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Nv, L, 2D) concatenated feat2 -> the int8 video-major flat cache of
    ``span_sim_cat_i8``: (f8_flat (Nv_pad * lp, 2D) int8, f_scales
    (Nv_pad, lp) f32).

    Rows are quantized per (video, clip) with ``quantize_rows_i8`` (feat2 is
    not unit-norm, so the scales are kept). The L -> lp pad rows and the
    Nv -> chunk_v-multiple pad videos are zeros with scale zero: they score
    exactly 0 and are sliced off after the engine's row gather. Masked
    clips keep their encoder outputs, as in every other sweep mode: the
    conv runs over them and the mask is applied afterwards. ``lp`` must be
    a multiple of 4 (``span_sim_cat_i8`` stores four similarities at a
    time). The default, ``SPAN_LP``, builds the JAX package's bytes; the
    engines pass ``flat_lp(L)``, the fewest pad rows B5 takes (every row,
    pad or not, is loaded, multiplied, rescaled and stored)."""
    nv, L, k = feat2_cat.shape
    if lp % 4:
        raise ValueError(f"lp={lp} must be a multiple of 4: span_sim_cat_i8 stores "
                         "four bf16 similarities at a time (SPAN_LP)")
    if L > lp:
        raise ValueError(f"max_ctx_l={L} exceeds the span-sweep row pad lp={lp}; use "
                         "span_score_mode='simsweep_cat' for longer contexts")
    q, scales = quantize_rows_i8(feat2_cat)                  # (Nv, L, K), (Nv, L)
    pad_v = (-nv) % chunk_v
    q = torch.nn.functional.pad(q, (0, 0, 0, lp - L, 0, pad_v))
    scales = torch.nn.functional.pad(scales, (0, lp - L, 0, pad_v))
    return q.reshape((nv + pad_v) * lp, k).contiguous(), scales.contiguous()


def _check_span_sim(name: str, q8, q_scale, f8_flat, f_scales, lp: int) -> None:
    nq, k = q8.shape
    rows = f8_flat.shape[0]
    if q8.dtype != torch.int8 or f8_flat.dtype != torch.int8:
        raise TypeError(f"{name}: q8 and f8_flat must be int8, got {q8.dtype}, "
                        f"{f8_flat.dtype}")
    if q_scale.dtype != torch.float32 or f_scales.dtype != torch.float32:
        raise TypeError(f"{name}: scales must be float32, got {q_scale.dtype}, "
                        f"{f_scales.dtype}")
    if lp < 1 or rows % lp:
        raise ValueError(f"{name}: lp={lp} does not divide {rows} rows")
    if (f8_flat.shape != (rows, k) or q_scale.shape != (nq, 1)
            or f_scales.shape != (rows // lp, lp)):
        raise ValueError(
            f"{name}: shapes {[tuple(t.shape) for t in (q8, q_scale, f8_flat, f_scales)]} "
            "are not (Nq, K), (Nq, 1), (Nv_pad * lp, K), (Nv_pad, lp)")


def span_sim_int8_xla(q8, q_scale, f8_flat, f_scales, lp: int = SPAN_LP,
                      block_videos: int = 64) -> torch.Tensor:
    """Plain version of B5 (port of pallas_score.span_sim_int8_xla):
    sim[q, v, l] = bf16((f32(q8[q] . f8[v * lp + l]) * q_scale[q]) * f_scales[v, l]),
    (Nq, Nv_pad, lp) bf16.

    The integer dot runs as an f32 matrix product per block of videos,
    which is exact while K * 127^2 < 2^24 (every partial sum is an integer
    below 2^24; K <= 1040), else in f64. The two f32 multiplications keep
    this association and the result rounds once to bf16."""
    _check_span_sim("span_sim_int8_xla", q8, q_scale, f8_flat, f_scales, lp)
    nq, k = q8.shape
    nv_pad = f_scales.shape[0]
    dt = torch.float64 if k * 127 * 127 >= 2 ** 24 else torch.float32
    q = q8.to(dt)
    out = torch.empty((nq, nv_pad, lp), dtype=torch.bfloat16, device=f8_flat.device)
    for v0 in range(0, nv_pad, block_videos):
        rows = f8_flat[v0 * lp:(v0 + block_videos) * lp].to(dt)
        s = (q @ rows.T).float() * q_scale                   # (Nq, bv * lp)
        out[:, v0:v0 + block_videos] = (
            s.view(nq, -1, lp) * f_scales[None, v0:v0 + block_videos]).to(torch.bfloat16)
    return out


def span_sim_cat_i8(q8, q_scale, f8_flat, f_scales, lp: int = SPAN_LP) -> torch.Tensor:
    """B5: the corpus-wide int8 concatenated span-similarity sweep (engine
    mode ``span_score_mode="simsweep_cat_int8_flat"``), (Nq, Nv_pad, lp)
    bf16, bit-equal to ``span_sim_int8_xla``.

    q8: (Nq, K) int8 quantized halved concatenated query vectors; q_scale:
    (Nq, 1) f32; f8_flat: (Nv_pad * lp, K) int8 and f_scales: (Nv_pad, lp)
    f32 from ``build_flat_feat2_i8``. The layout serves the engine's top-V
    row gather, which reads contiguous lp-runs; the kernel tiles the flat
    rows 256 at a time, whatever lp is (a tile may cut a video: every row
    carries its own scale). The kernel's TMA loads need rows of a multiple
    of 16 bytes and its stores at least four bf16 at a time, so K must be a
    multiple of 16 and lp of 4. (The TPU wrapper's chunk_v and q_tile only
    tile its grid, so they have no counterpart here.) Replaces
    pallas_score.span_sim_pallas_cat_i8."""
    name = "span_sim_cat_i8"
    _check_span_sim(name, q8, q_scale, f8_flat, f_scales, lp)
    if f8_flat.device.type == "cpu":
        return span_sim_int8_xla(q8, q_scale, f8_flat, f_scales, lp)
    ts = (q8, q_scale, f8_flat, f_scales)
    dev = f8_flat.device
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError(f"{name}: all operands must be on one CUDA device, got "
                         f"{[str(t.device) for t in ts]}")
    nq, k = q8.shape
    rows = f8_flat.shape[0]
    if lp % 4:
        raise ValueError(f"{name}: lp={lp} must be a multiple of 4: the kernel stores "
                         "four bf16 similarities at a time")
    if k % 16 or nq == 0 or rows == 0:
        raise ValueError(f"{name}: K={k} must be a positive multiple of 16 (the kernel "
                         f"loads 16-byte vectors), Nq={nq} and rows={rows} positive")
    if not (f8_flat.is_contiguous() and f_scales.is_contiguous()):
        raise ValueError(f"{name}: the flat cache and its scales must be contiguous")
    q8, q_scale = q8.contiguous(), q_scale.contiguous()
    out = torch.empty((nq, rows // lp, lp), dtype=torch.bfloat16, device=dev)
    if any(t.data_ptr() % 16 for t in (q8, f8_flat, f_scales, out)):
        raise ValueError(f"{name}: operands must be 16-byte aligned")
    _build.launch(name, dev, q8.data_ptr(), q_scale.data_ptr(), f8_flat.data_ptr(),
                  f_scales.data_ptr(), nq, rows, k // 4, out.data_ptr())
    return out


# ------------------------------------------------- masked video scores (B9)
def launch_masked_scores(name: str, queries, feats, mask, nv: int, n_clips: int,
                         f_strides, m_strides, init: float,
                         alpha: Optional[float]) -> torch.Tensor:
    """Check the operands of csrc/masked_score.cu and launch it on the
    current stream: one (B10) or two (B9) streams of (Nq, D) ``queries``
    against ``feats`` whose video and clip axes have ``f_strides`` (in
    elements), ``mask`` with ``m_strides``; the running max starts at
    ``init``; ``alpha`` not None applies exp(alpha * score). Returns
    (Nq, nv) f32; the launch is counted under ``name``."""
    ts = (*queries, *feats)
    dev = feats[0].device
    if dev.type != "cuda" or any(t.device != dev for t in (*ts, mask)):
        raise ValueError(f"{name}: all operands must be on one CUDA device, got "
                         f"{[str(t.device) for t in (*ts, mask)]}")
    dt = feats[0].dtype
    if dt not in (torch.bfloat16, torch.float32) or any(t.dtype != dt for t in ts):
        raise TypeError(f"{name}: queries and caches must share bfloat16 or float32, "
                        f"got {[t.dtype for t in ts]}")
    nq, d = queries[0].shape
    if any(q.shape != (nq, d) for q in queries) or any(
            f.shape != feats[0].shape or f.shape[-1] != d for f in feats):
        raise ValueError(f"{name}: shapes {[tuple(t.shape) for t in ts]} do not agree "
                         "on Nq, Nv, L, D")
    row_bytes = d * feats[0].element_size()
    if row_bytes % 16:
        raise ValueError(f"{name}: a feature row is {row_bytes} bytes; the kernel loads "
                         "16-byte vectors, so D * itemsize must be a multiple of 16")
    if d > MASKED_MAX_D:
        raise ValueError(f"{name}: D={d}; the tensor-core kernel holds rows of at most "
                         f"{MASKED_MAX_D} features")
    if not all(f.is_contiguous() for f in feats):
        raise ValueError(f"{name}: feature caches must be contiguous")
    if nq == 0 or nv == 0 or n_clips == 0:
        raise ValueError(f"{name}: Nq={nq}, Nv={nv} and L={n_clips} must be positive")
    queries = [q.contiguous() for q in queries]
    mask = mask.to(torch.float32).contiguous()
    if any(t.data_ptr() % 16 for t in (*queries, *feats)):
        raise ValueError(f"{name}: operands must be 16-byte aligned")
    per_word = 4 // feats[0].element_size()
    out = torch.empty((nq, nv), dtype=torch.float32, device=dev)
    _build.launch(name, dev, _KIND[dt], queries[0].data_ptr(), queries[-1].data_ptr(),
                  feats[0].data_ptr(), feats[-1].data_ptr(), mask.data_ptr(), nq, nv,
                  n_clips, row_bytes // 4, f_strides[0] // per_word, f_strides[1] // per_word,
                  m_strides[0], m_strides[1], len(feats), init,
                  int(alpha is not None), float(alpha or 0.0), out.data_ptr())
    return out


def video_scores_masked(qv, qs, feat1_v, feat1_s, mask) -> torch.Tensor:
    """B9: q2c scores over the unflattened caches, (Nq, Nv) f32, pre-exp.

    qv / qs: (Nq, D) normalized queries cast to the cache dtype; feat1_v /
    feat1_s: (Nv, L, D) normalized caches, bf16 or f32; mask: (Nv, L) float
    clip validity. Per stream the max over clips of ``s * m + (1 - m) *
    -1e10`` with f32-accumulated dots, the two maxima averaged: what
    ``video_scores_xla`` (its plain version, the engine's "einsum" stage)
    computes, up to f32 summation order (the dots on the tensor cores: bf16
    products, or f32 as three TF32 products; D at most ``MASKED_MAX_D``).
    A fully masked video scores exactly -1e10. The (Nq, Nv, L) similarity
    never reaches device memory.
    (The TPU wrapper's chunk_v only tiles its grid, so it has no
    counterpart here.) Replaces pallas_score.video_scores_pallas."""
    if feat1_v.device.type == "cpu":
        return video_scores_xla(qv, qs, feat1_v, feat1_s, mask)
    name = "video_scores_masked"
    if feat1_v.dim() != 3 or mask.shape != feat1_v.shape[:2]:
        raise ValueError(f"{name}: caches must be (Nv, L, D) and mask (Nv, L), got "
                         f"{tuple(feat1_v.shape)}, {tuple(mask.shape)}")
    nv, L, d = feat1_v.shape
    return launch_masked_scores(name, (qv, qs), (feat1_v, feat1_s), mask, nv, L,
                                (L * d, d), (L, 1), -math.inf, None)
