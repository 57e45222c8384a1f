"""Byte-row gather for the GPU-resident training corpus.

``gather_byte_rows`` (B4, csrc/gather.cu) replaces
tvretrieval_tpu/ops/pallas_gather.py::gather_byte_rows: ``out[b] =
table[idx[b]]`` over an ``(N, 8, W)`` int8 byte table, the indices read on
the device (no host synchronisation), duplicates allowed, any ``B >= 1``,
the only allocation the ``(B, 8, W)`` output. The bytes are data: there is
no gradient.

``gather_byte_rows_plain`` is its plain version (``index_select``). The
wrapper given a CPU table runs the plain version; given a CUDA table it
launches the kernel or raises. ``LAUNCHES`` counts kernel launches (plain
runs are not counted).

The kernel is bound by bytes: a row is read once and written once. An
index outside ``[0, N)`` cannot be reported without waiting for the device,
so the kernel writes zeros for that row and counts it on the device;
``check_indices(device)`` reads the count (one synchronisation) and raises.
"""
from __future__ import annotations

from typing import Dict

import torch

LAUNCHES: Dict[str, int] = {"gather_byte_rows": 0}

# per-device int32 counter of out-of-range indices seen by the kernel
_BAD: Dict[torch.device, torch.Tensor] = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_operands(name: str, table: torch.Tensor, idx: torch.Tensor) -> None:
    if table.dtype != torch.int8 or table.dim() != 3 or table.shape[1] != 8:
        raise TypeError(f"{name}: table must be (N, 8, W) int8, got "
                        f"{tuple(table.shape)} {table.dtype}")
    if idx.dim() != 1 or idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{name}: idx must be a 1-D int32 or int64 tensor, got "
                        f"{tuple(idx.shape)} {idx.dtype}")
    if idx.device != table.device:
        raise ValueError(f"{name}: table on {table.device}, idx on {idx.device}")


def gather_byte_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of B4: (N, 8, W) int8 x (B,) -> (B, 8, W) int8."""
    _check_operands("gather_byte_rows_plain", table, idx)
    return table.index_select(0, idx)


def gather_byte_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """B4: rows ``idx`` of the byte table, (B, 8, W) int8.

    table: (N, 8, W) int8, contiguous, W a multiple of 16 (device_corpus
    pads rows to 1,024 bytes) and 16-byte aligned. idx: (B,) int32, or
    int64 narrowed to int32 on the device; it may be non-contiguous.
    Replaces pallas_gather.gather_byte_rows."""
    name = "gather_byte_rows"
    _check_operands(name, table, idx)
    if table.device.type == "cpu":
        return table.index_select(0, idx)
    if table.device.type != "cuda":
        raise ValueError(f"{name}: table on {table.device}; expected cpu or cuda")
    from tvretrieval_tpu_torch.ops import _build

    n, _, w = table.shape
    if n == 0 or w == 0 or w % 16:
        raise ValueError(f"{name}: table {tuple(table.shape)} needs N > 0 and W a "
                         "positive multiple of 16 (the kernel moves 16-byte vectors)")
    if not table.is_contiguous():
        raise ValueError(f"{name}: the byte table must be contiguous")
    dev = table.device
    if n >= 2 ** 31:
        raise ValueError(f"{name}: {n} rows do not fit the kernel's int32 indices")
    if idx.dtype == torch.int64:
        # narrow on the device; what lies outside the table stays outside it
        idx = idx.clamp(-1, n)
    idx32 = idx.to(torch.int32).contiguous()
    out = torch.empty((idx32.shape[0], 8, w), dtype=torch.int8, device=dev)
    if table.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError(f"{name}: table and output must be 16-byte aligned")
    if idx32.shape[0] == 0:
        return out
    bad = _BAD.get(dev)
    if bad is None:
        bad = _BAD[dev] = torch.zeros((), dtype=torch.int32, device=dev)
    fn = _build.load("gather").tvr_gather_byte_rows
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(table.data_ptr(), idx32.data_ptr(), out.data_ptr(), n,
                 idx32.shape[0], 8 * w, bad.data_ptr(), stream)
    if err:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    LAUNCHES[name] += 1
    return out


def check_indices(device) -> None:
    """Raise IndexError if any ``gather_byte_rows`` launch on ``device``
    since the last check saw an index outside its table (waits for the
    device; call where the host synchronises anyway)."""
    device = torch.device(device)
    for dev, bad in _BAD.items():
        # "cuda" without an index stands for every card
        if dev.type != device.type or device.index not in (None, dev.index):
            continue
        n_bad = int(bad.item())
        if n_bad:
            bad.zero_()
            raise IndexError(f"gather_byte_rows: {n_bad} indices were outside their "
                             f"table on {dev}; their output rows are zeros")
