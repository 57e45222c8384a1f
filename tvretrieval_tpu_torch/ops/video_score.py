"""Corpus video-score stage: flat feat1 caches, int8 quantizers, and the
CUDA video-score kernels with their plain PyTorch versions.

Port of tvretrieval_tpu/ops/pallas_score.py:124-228, 344-407, 569-619.
The reference op is model_xml.py:436-453 (``get_video_level_scores``:
einsum -> mask -> max over clips) against the whole corpus per query batch
(inference.py:308-317).

Kernel wrappers (csrc/video_score.cu), each beside its plain version:

- ``video_scores_flat_i8``   (B1, replaces ``video_scores_pallas_flat_i8``)
- ``video_scores_flat``      (B2, replaces ``video_scores_pallas_flat``)
- ``video_scores_flat_bmax`` (B3, replaces ``video_scores_pallas_flat_bmax``)

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises. ``LAUNCHES`` counts kernel launches per
wrapper (plain runs are not counted).

What bounds the kernels on the H100 is arithmetic: 2 x Nv_pad * lp x D x
Nq MACs (1.16e12 at the full corpus, Nq=1000) through dp4a / FMA; the
(Nq, Nv_pad * lp) dot matrix never reaches device memory. See the source
for the tiling.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tvretrieval_tpu_torch.ops.masking import NEG_INF

# f32(0.5 / 127^2), rounded once from double like JAX's weak-typed
# constant; as a Python float it is exact in f32, so the multiply rounds once
I8_SCALE = float(np.float32(0.5 / (127.0 * 127.0)))
_INV_127 = float(np.float32(1.0 / 127.0))

LAUNCHES: Dict[str, int] = {"video_scores_flat_i8": 0, "video_scores_flat": 0,
                            "video_scores_flat_bmax": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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
    valid = mask > 0
    if not bool(valid.any(dim=1).all()):
        raise ValueError(
            "build_flat_feat1: some video has no valid clip; the mask-free "
            "flat cache cannot represent its -1e10 score — use "
            "video_score_mode='einsum' for corpora with fully-masked rows")
    first_valid = valid.to(torch.int8).argmax(dim=1)             # first 1
    fill = feat1[torch.arange(nv, device=feat1.device), first_valid]  # (Nv, D)
    fixed = torch.where(valid[:, :, None], feat1, fill[:, None])
    if lp > L:
        fixed = torch.cat([fixed, fill[:, None].expand(nv, lp - L, d)], dim=1)
    pad_v = (-nv) % chunk_v
    if pad_v:
        fixed = torch.cat([fixed, fixed[-1:].expand(pad_v, lp, d)], dim=0)
    return fixed.reshape((nv + pad_v) * lp, d).contiguous()


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
    from tvretrieval_tpu_torch.ops import _build

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
    fn = _build.load().tvr_video_scores
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(_KIND[fv_flat.dtype], qv.data_ptr(), qs.data_ptr(),
                 fv_flat.data_ptr(), fs_flat.data_ptr(), nq, nv_pad, lp,
                 row_bytes // 4, n_videos, out.data_ptr(), out.shape[1],
                 None if bmax is None else bmax.data_ptr(), chunk or 1, stream)
    if err:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    LAUNCHES[name] += 1
    return out if bmax is None else (out, bmax)


def video_scores_flat_i8(qvt_i8, qst_i8, fv_flat_i8, fs_flat_i8, n_videos: int,
                         lp: int = 104) -> torch.Tensor:
    """B1: q2c scores over int8 flat caches, (Nq, n_videos) f32.

    qvt_i8 / qst_i8: (D, Nq) int8 quantized normalized queries
    (``quantize_unit_i8(q).T``); fv/fs: (Nv_pad * lp, D) int8 flat caches.
    s8 x s8 -> s32 dots, exact integer max per video, one f32 rescale:
    bit-equal to ``video_scores_int8_xla``. (The TPU wrapper's chunk_v
    only tiles its grid, so it has no counterpart here.) Replaces pallas_score.video_scores_pallas_flat_i8.
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
    cache dtype. Equal to the einsum path up to f32 summation order.
    Replaces pallas_score.video_scores_pallas_flat.
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
