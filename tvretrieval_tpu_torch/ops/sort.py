"""Exact stable top-k of every row by a select-then-sort kernel.

``topk_transposed`` (B6, csrc/topk_sort.cu) replaces
tvretrieval_tpu/ops/pallas_sort.py::topk_transposed: the ``k`` best
elements of each row of a 2-D tensor under ``lax.top_k``'s order, value
descending and then index ascending, as (f32 values, int32 indices clamped
to ``n - 1``). The engine's psort modes select through it
(ops.span.topk_stable_blocked_psort,
ops.span.banded_topk_spans_grouped_shift_psort).

``topk_transposed_plain`` is its plain version, a stable descending
``torch.sort`` (``torch.topk`` leaves the order of ties open). The wrapper
given a CPU tensor runs the plain version; given a CUDA tensor it launches
the kernel or raises (``ops._build.launch`` counts the launch).

The name keeps the TPU kernel's, whose layout is transposed (queries along
the lanes); here one thread block takes one row and nothing is transposed:
it radix-selects the k-th largest value on order-preserving u32 keys
(-0.0 tying with 0.0), keeps exactly k survivors (ties at the cut by
index) and sorts only those (csrc/topk_sort.cu; tests/test_torch_sort_select.py
holds a numpy model of the algorithm). The TPU function fails at trace time when
``ceil8(k) > next_pow2(n)`` and leaves ``n <= k`` to ``lax.top_k``; this
kernel has no 8-row alignment and serves both.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from tvretrieval_tpu_torch.ops import _build

# the longest row one launch takes: 16,384 u32 keys (64 KiB) beside up to
# 16,384 survivors (128 KiB) in a block's shared memory
# (csrc/topk_sort.cu::kMaxRow)
MAX_ROW = 16384


def _check(name: str, x: torch.Tensor, k: int) -> None:
    if x.dim() != 2 or not x.is_floating_point():
        raise TypeError(f"{name}: x must be a 2-D floating tensor, got "
                        f"{tuple(x.shape)} {x.dtype}")
    if k < 1 or x.shape[1] < 1:
        raise ValueError(f"{name}: k={k} and n={x.shape[1]} must be positive")


def topk_transposed_plain(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of B6: (Nq, n) -> ((Nq, min(k, n)) f32 values, int32
    indices), value descending, ties by ascending index."""
    _check("topk_transposed_plain", x, k)
    k = min(k, x.shape[1])
    vals, idx = torch.sort(x.float(), dim=-1, descending=True, stable=True)
    return vals[:, :k].contiguous(), idx[:, :k].to(torch.int32)


def _launch(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch over contiguous f32 rows of at most MAX_ROW elements, on
    the current stream."""
    nq, n = x.shape
    dev = x.device
    vals = torch.empty((nq, k), dtype=torch.float32, device=dev)
    idx = torch.empty((nq, k), dtype=torch.int32, device=dev)
    _build.launch("topk_transposed", dev, x.data_ptr(), nq, n, k, vals.data_ptr(),
                  idx.data_ptr())
    return vals, idx


def topk_transposed(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """B6: exact stable top-k along the last axis of (Nq, n) ``x``.

    Returns ((Nq, min(k, n)) f32 values, int32 indices), equal to
    ``topk_transposed_plain`` in values and indices, ties included: a row
    with fewer than ``k`` finite values returns its ``-inf`` elements in
    index order. A row longer than MAX_ROW is sorted in chunks of MAX_ROW, each
    keeping its top ``k`` with their positions in the row, and a second
    launch selects among the survivors; that is exact, because survivors
    of equal value stay in ascending index order. It needs
    ``k <= MAX_ROW / 2``. Replaces pallas_sort.topk_transposed."""
    name = "topk_transposed"
    _check(name, x, k)
    if x.device.type == "cpu":
        return topk_transposed_plain(x, k)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: x on {x.device}; expected cpu or cuda")
    nq, n = x.shape
    k = min(k, n)
    x = x.float().contiguous()
    if nq == 0:
        return x[:, :k], torch.empty((0, k), dtype=torch.int32, device=x.device)
    if n <= MAX_ROW:
        return _launch(x, k)
    if k > MAX_ROW // 2:
        raise ValueError(f"{name}: rows of {n} elements are sorted in chunks of "
                         f"{MAX_ROW}, which needs k <= {MAX_ROW // 2}, got k={k}")
    nc = -(-n // MAX_ROW)
    padded = F.pad(x, (0, nc * MAX_ROW - n), value=-float("inf"))
    vals, idx = _launch(padded.view(nq * nc, MAX_ROW), k)
    offsets = torch.arange(nc, dtype=torch.int32, device=x.device) * MAX_ROW
    idx = (idx.view(nq, nc, k) + offsets[None, :, None]).view(nq, nc * k)
    vals, pos = topk_transposed(vals.view(nq, nc * k), k)
    idx = torch.gather(idx, 1, pos.long())
    return vals, torch.clamp_max(idx, n - 1)
