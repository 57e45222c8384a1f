"""Approximate top-k of every row by bins: the counterpart of ``lax.approx_max_k``.

The JAX package's approximate selections (``video_topk_approx`` and span
mode "grouped_shift_approx") call ``jax.lax.approx_max_k``, which a TPU
runs in hardware as a partial reduce (arXiv:2206.14286): the row is cut
into M bins, each bin keeps its largest element, and an exact top-k is
taken of the M maxima. A bin holding two elements of the true top-k loses
one, which is what makes the result approximate; M follows from the recall
target (``reduction_output_size``). On the CPU XLA sorts the row instead,
so the JAX package is exact there.

``approx_max_k`` (B11, csrc/approx_topk.cu) is a kernel of its own for the
card, written for this function; ``approx_max_k_plain`` is its plain
version. Both compute the same function, on the CPU as on the card:

* bins: bin b holds the elements j with j % M == b (a stride-M map, not
  contiguous windows). Any M consecutive elements then fall in distinct
  bins, so a run of high values, as the span group select sees where the
  neighbouring starts of one video score high together, keeps its members
  (contiguous windows of 4 would keep 50 of a run of 200). The TPU's own
  bin map is not documented in the repository;
* tie rule: a bin keeps its largest value, ties to the lowest element
  index; ties between bins at the cut go to the lower bin index; the
  output is ordered by value descending, then element index ascending;
  -0.0 ties with 0.0 (as in B6). Values are the row's own bits.

Where M equals the row length every bin holds one element and the result
is the exact stable top-k (``lax.top_k`` and B6, element for element,
except that ``lax.top_k`` puts +0.0 before -0.0).

The wrapper given a CPU tensor runs the plain version; given a CUDA tensor
it launches the kernel or raises (``ops._build.launch`` counts the launch).
"""
from __future__ import annotations

import math
import struct
from typing import Tuple

import torch
import torch.nn.functional as F

from tvretrieval_tpu_torch.ops import _build

# the largest k one launch takes (csrc/approx_topk.cu::kMaxK)
MAX_K = 1024


def reduction_output_size(n: int, rank: int, k: int, recall: float) -> Tuple[int, int]:
    """(M, log2 of the reduction) for a reduced axis of ``n`` elements: the
    port's copy of XLA's ``ApproxTopKReductionOutputSize`` without
    aggregation to top-k (jaxlib's ``approx_top_k_reduction_output_size``).

    The tiling is 128 for rank >= 2 and 1,024 for rank 1. M = n when n is
    at most the tiling, or when recall is 1.0 and k > 1. Otherwise, with
    m = (1 - k) / ln(recall) the bin count the recall formula
    ((M - 1) / M)^(k - 1) asks for (at least the tiling, at most n), the
    reduction is floor(log2(n / m)), at most ceil(log2(ceil(n / tiling)))
    (for k = 1 it is that largest one: the maximum survives any binning),
    and M = ceil(ceil(n / tiling) / 2^log2) * tiling; M = n when the
    reduction is 0. The recall is rounded to float32 first, as XLA takes it.
    """
    if not 0.0 < recall <= 1.0:
        raise ValueError(f"recall must be in (0, 1], got {recall}")
    tiling = 128 if rank >= 2 else 1024
    if n <= tiling:
        return n, 0
    tiles = -(-n // tiling)
    largest = (tiles - 1).bit_length()                     # ceil(log2(tiles))
    if k == 1:
        log2 = largest
    else:
        recall = struct.unpack("f", struct.pack("f", recall))[0]
        if recall == 1.0:
            return n, 0
        m = min(max(int((1.0 - k) / math.log(recall)), tiling), n)
        log2 = (n // m).bit_length() - 1                   # floor(log2(n / m))
        if log2 == 0:
            return n, 0
        log2 = min(log2, largest)
    return -(-tiles // (1 << log2)) * tiling, log2


def bins(n: int, k: int, recall: float) -> int:
    """M, the bins of a row of ``n`` elements (rank 2, as the engine calls
    ``lax.approx_max_k``); raises if fewer than ``k``."""
    m = reduction_output_size(n, 2, k, recall)[0]
    if k > m:
        raise ValueError(f"approx_max_k: k={k} exceeds the {m} bins of a row of {n} at "
                         f"recall {recall}")
    return m


def _check(name: str, x: torch.Tensor, k: int) -> None:
    if x.dim() != 2 or not x.is_floating_point():
        raise TypeError(f"{name}: x must be a 2-D floating tensor, got "
                        f"{tuple(x.shape)} {x.dtype}")
    if not 1 <= k <= x.shape[1]:
        raise ValueError(f"{name}: k={k} must be in [1, n={x.shape[1]}]")


def approx_max_k_plain(x: torch.Tensor, k: int,
                       recall: float = 0.95) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of B11: (Nq, n) -> ((Nq, k) f32 values, int32 element
    indices) under the module's bin map and tie rule."""
    _check("approx_max_k_plain", x, k)
    nq, n = x.shape
    m = bins(n, k, recall)
    x = x.float()
    slots = -(-n // m)
    # element (slot s, bin b) is s * m + b; the pads (-inf) come after every
    # real element of their bin, so they never win a tie
    grid = F.pad(x, (0, slots * m - n), value=-math.inf).view(nq, slots, m)
    best = grid.amax(dim=1, keepdim=True)
    slot_ids = torch.arange(slots, device=x.device)[None, :, None]
    slot = torch.where(grid == best, slot_ids, slots).amin(dim=1).clamp_max(slots - 1)
    elem = slot * m + torch.arange(m, device=x.device)[None]
    # the k best bins, ties by bin index (a stable sort of the bins in order)
    top_bins = torch.sort(grid.gather(1, slot[:, None]).squeeze(1), dim=1,
                          descending=True, stable=True).indices[:, :k]
    chosen = torch.sort(elem.gather(1, top_bins), dim=1).values      # element order
    vals, order = torch.sort(x.gather(1, chosen), dim=1, descending=True, stable=True)
    return vals, chosen.gather(1, order).to(torch.int32)


def approx_max_k(x: torch.Tensor, k: int,
                 recall: float = 0.95) -> Tuple[torch.Tensor, torch.Tensor]:
    """B11: the approximate top-k of every row of (Nq, n) ``x`` at the
    recall target ``recall`` (``lax.approx_max_k`` on a TPU).

    Returns ((Nq, k) f32 values, int32 element indices), equal to
    ``approx_max_k_plain`` in values and indices. Needs k <= MAX_K on the
    card and k <= M everywhere. Replaces ``lax.approx_max_k`` at
    tvretrieval_tpu/retrieval/engine.py:597 and ops/span.py:581, 609."""
    name = "approx_max_k"
    _check(name, x, k)
    if x.device.type == "cpu":
        return approx_max_k_plain(x, k, recall)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: x on {x.device}; expected cpu or cuda")
    if k > MAX_K:
        raise ValueError(f"{name}: k={k} > {MAX_K}, the most one launch selects")
    nq, n = x.shape
    m = bins(n, k, recall)
    x = x.float().contiguous()
    vals = torch.empty((nq, k), dtype=torch.float32, device=x.device)
    idx = torch.empty((nq, k), dtype=torch.int32, device=x.device)
    if nq == 0:
        return vals, idx
    _build.launch(name, x.device, x.data_ptr(), nq, n, m, k, vals.data_ptr(), idx.data_ptr())
    return vals, idx
