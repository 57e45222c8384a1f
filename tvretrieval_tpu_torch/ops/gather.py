"""Row gathers: the byte-row gather of the GPU-resident training corpus, and
the gather fused with the span similarity.

``gather_byte_rows`` (B4, csrc/gather.cu) replaces
tvretrieval_tpu/ops/pallas_gather.py::gather_byte_rows: ``out[b] =
table[idx[b]]`` over an ``(N, 8, W)`` int8 byte table, the indices read on
the device (no host synchronisation), duplicates allowed, any ``B >= 1``,
the only allocation the ``(B, 8, W)`` output. The bytes are data: there is
no gradient.

``gather_byte_rows_plain`` is its plain version (``index_select``). The
wrapper given a CPU table runs the plain version; given a CUDA table it
launches the kernel or raises (``ops._build.launch`` counts the launch).

``gathered_similarity`` (B7, csrc/gathered_sim.cu) replaces
tvretrieval_tpu/ops/pallas_gather.py::gathered_similarity: the merged span
similarity of each query's selected corpus rows, ``(vq . vf2[idx] + sq .
sf2[idx]) / 2``, without the gathered rows reaching device memory.
``gathered_similarity_plain`` is its plain version (row gather, two f32
products). No engine mode runs it: it is a measured alternative to span
mode "gather", run beside it by ``profiling.engine_modes``.

Both kernels are bound by bytes: a row is read once (and, for B4, written
once). An index outside ``[0, N)`` cannot be reported without waiting for
the device, so a kernel writes zeros for that row and counts it on the
device; ``check_indices(device)`` reads the count (one synchronisation) and
raises.
"""
from __future__ import annotations

from typing import Dict

import torch

from tvretrieval_tpu_torch.ops import _build

# the longest clip feature row B7 holds in a lane's registers
# (csrc/gathered_sim.cu: 8 x 16-byte pieces a lane)
MAX_CLIP_BYTES = 4096
_KIND = {torch.bfloat16: 1, torch.float32: 2}

# per-device int32 counter of out-of-range indices seen by the kernel
_BAD: Dict[torch.device, torch.Tensor] = {}


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
    _build.launch(name, dev, table.data_ptr(), idx32.data_ptr(), out.data_ptr(), n,
                  idx32.shape[0], 8 * w, _bad_counter(dev).data_ptr())
    return out


def _bad_counter(dev: torch.device) -> torch.Tensor:
    bad = _BAD.get(dev)
    if bad is None:
        bad = _BAD[dev] = torch.zeros((), dtype=torch.int32, device=dev)
    return bad


def gathered_similarity_plain(video_query, sub_query, video_feat2, sub_feat2, gather_idx,
                              block_queries: int = 32) -> torch.Tensor:
    """Plain version of B7: (Nq, D) queries x (N, L, D) corpora x (Nq, V)
    row indices -> (Nq, V, L) f32. The queries are cast to the corpus
    dtype; the gathered rows are upcast and the two products run in f32
    (so a bf16 corpus does not round the output to bf16), ``block_queries``
    queries at a time: the gathered (block, V, L, D) rows exist twice."""
    dt = video_feat2.dtype
    idx = gather_idx.long()
    outs = []
    for q0 in range(0, idx.shape[0], block_queries):
        sl = slice(q0, q0 + block_queries)
        sv = torch.einsum("qd,qvld->qvl", video_query[sl].to(dt).float(),
                          video_feat2[idx[sl]].float())
        ss = torch.einsum("qd,qvld->qvl", sub_query[sl].to(dt).float(),
                          sub_feat2[idx[sl]].float())
        outs.append((sv + ss) / 2)
    return torch.cat(outs)


def gathered_similarity(video_query: torch.Tensor, sub_query: torch.Tensor,
                        video_feat2: torch.Tensor, sub_feat2: torch.Tensor,
                        gather_idx: torch.Tensor) -> torch.Tensor:
    """B7: (Nq, D) queries x (N, L, D) corpora x (Nq, V) row indices ->
    (Nq, V, L) merged similarity, f32.

    The queries are cast to the corpus dtype (bf16 or f32), the dots
    accumulate in f32. gather_idx: int32, or int64 narrowed on the device.
    The TPU function needs ``L % 8 == 0`` and ``D % 128 == 0`` for its DMA
    tiling; this kernel reads 16-byte vectors, so it needs ``D * itemsize``
    to be a multiple of 16 and at most MAX_CLIP_BYTES, and takes any L. An
    index outside the corpus gives a row of zeros and is counted for
    ``check_indices``. Replaces pallas_gather.gathered_similarity."""
    name = "gathered_similarity"
    if (video_feat2.dim() != 3 or sub_feat2.shape != video_feat2.shape
            or gather_idx.dim() != 2
            or video_query.shape != (gather_idx.shape[0], video_feat2.shape[2])
            or sub_query.shape != video_query.shape):
        raise ValueError(
            f"{name}: shapes {[tuple(t.shape) for t in (video_query, sub_query, video_feat2, sub_feat2, gather_idx)]} "
            "are not (Nq, D), (Nq, D), (N, L, D), (N, L, D), (Nq, V)")
    if gather_idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{name}: gather_idx must be int32 or int64, got {gather_idx.dtype}")
    n, L, d = video_feat2.shape
    dt = video_feat2.dtype
    clip_bytes = d * video_feat2.element_size()
    if clip_bytes % 16 or clip_bytes > MAX_CLIP_BYTES:
        raise ValueError(
            f"{name}: a clip's features are {clip_bytes} bytes (D={d}); the kernel reads "
            f"16-byte vectors held in registers, so D * itemsize must be a multiple of "
            f"16 and at most {MAX_CLIP_BYTES}")
    if video_feat2.device.type == "cpu":
        return gathered_similarity_plain(video_query, sub_query, video_feat2, sub_feat2,
                                         gather_idx)
    dev = video_feat2.device
    ts = (video_query, sub_query, video_feat2, sub_feat2, gather_idx)
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError(f"{name}: all operands must be on one CUDA device, got "
                         f"{[str(t.device) for t in ts]}")
    if dt not in _KIND or sub_feat2.dtype != dt:
        raise TypeError(f"{name}: corpora must share bfloat16 or float32, got {dt}, "
                        f"{sub_feat2.dtype}")
    if not (video_feat2.is_contiguous() and sub_feat2.is_contiguous()):
        raise ValueError(f"{name}: the corpora must be contiguous")
    if n == 0 or L == 0 or n >= 2 ** 31:
        raise ValueError(f"{name}: corpus {tuple(video_feat2.shape)} needs 0 < N < 2^31 "
                         "and L > 0")
    nq, v1 = gather_idx.shape
    if gather_idx.dtype == torch.int64:
        gather_idx = gather_idx.clamp(-1, n)     # what lies outside stays outside
    idx32 = gather_idx.to(torch.int32).contiguous()
    qv, qs = video_query.to(dt).contiguous(), sub_query.to(dt).contiguous()
    out = torch.empty((nq, v1, L), dtype=torch.float32, device=dev)
    if nq == 0 or v1 == 0:
        return out
    if any(t.data_ptr() % 16 for t in (qv, qs, video_feat2, sub_feat2)):
        raise ValueError(f"{name}: operands must be 16-byte aligned")
    _build.launch(name, dev, _KIND[dt], qv.data_ptr(), qs.data_ptr(), video_feat2.data_ptr(),
                  sub_feat2.data_ptr(), idx32.data_ptr(), n, nq, v1, L, clip_bytes,
                  out.data_ptr(), _bad_counter(dev).data_ptr())
    return out


def check_indices(device) -> None:
    """Raise IndexError if any gather launch on ``device`` since the last
    check saw an index outside its table (waits for the device; call where
    the host synchronises anyway)."""
    device = torch.device(device)
    for dev, bad in _BAD.items():
        # "cuda" without an index stands for every card
        if dev.type != device.type or device.index not in (None, dev.index):
            continue
        n_bad = int(bad.item())
        if n_bad:
            bad.zero_()
            raise IndexError(f"gather: {n_bad} indices were outside their table on "
                             f"{dev}; their output rows are zeros")
