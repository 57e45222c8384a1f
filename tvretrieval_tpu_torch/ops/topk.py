"""Fused banded joint + exact top-N span selection.

``banded_topk_spans_fused`` (B8, csrc/banded_topk.cu) replaces
tvretrieval_tpu/ops/pallas_topk.py::banded_topk_spans_pallas: a drop-in for
``ops.span.banded_topk_spans`` (its plain version) that never materializes
the (Nq, V, L, W) joint ``st * ed * video_score``. Per query a thread
block takes one key a (video, start) row, its best joint value (exact from
the band's largest and smallest end probability, since f32 multiplication
is monotone), selects the ``top_n`` rows by it, which hold the answer, and
then the ``top_n`` elements of those rows; both selections are the sorting
kernel's radix select and register sort (``csrc/select.cuh``). All four
outputs are equal to the plain version's, ties included: the order is
(value descending, flat index ``v * L * W + st * W + w`` ascending).

The wrapper given CPU tensors runs the plain version; given CUDA tensors
it launches the kernel or raises (``ops._build.launch`` counts the
launch). No engine mode runs it: it is a measured
alternative to the span top-N stage, run beside it by
``profiling.engine_modes``.

The kernel's limits are the TPU kernel's: ``W = max_l - min_l <= 16``,
``L <= 128``, ``top_n <= 256``; both devices raise ``ValueError`` beyond
them, so that the function is the same function everywhere.
"""
from __future__ import annotations

import torch

from tvretrieval_tpu_torch.ops import _build
from tvretrieval_tpu_torch.ops.span import banded_topk_spans

MAX_W, MAX_L, MAX_TOP_N = 16, 128, 256     # csrc/banded_topk.cu: kMaxW, kMaxL, kMaxTop


def banded_topk_spans_fused(st_probs: torch.Tensor, ed_probs: torch.Tensor,
                            video_scores: torch.Tensor, min_l: int, max_l: int, top_n: int,
                            return_sorted: bool = False):
    """B8: exact top-``top_n`` spans over (videos x starts x band ends).

    st_probs / ed_probs: (Nq, V, L) f32; video_scores: (Nq, V) f32, in
    any order. Returns (video_local_idx, st_idx, ed_idx int32, scores f32),
    each (Nq, top_n), equal to ``banded_topk_spans``. With ``return_sorted``
    a fifth (Nq,) int32 tensor counts the videos of each query that
    contributed at least one element past the threshold: those holding one
    of its ``top_n`` selected rows (all ``V`` on the CPU, where the plain
    version sorts the whole joint). Replaces
    pallas_topk.banded_topk_spans_pallas."""
    name = "banded_topk_spans_fused"
    if (st_probs.dim() != 3 or ed_probs.shape != st_probs.shape
            or video_scores.shape != st_probs.shape[:2]):
        raise ValueError(f"{name}: shapes {tuple(st_probs.shape)}, {tuple(ed_probs.shape)}, "
                         f"{tuple(video_scores.shape)} are not (Nq, V, L), (Nq, V, L), (Nq, V)")
    nq, v, L = st_probs.shape
    W = max_l - min_l
    if W > MAX_W or L > MAX_L or top_n > MAX_TOP_N:
        raise ValueError(f"kernel limits: W<={MAX_W}, L<={MAX_L}, top_n<={MAX_TOP_N}; "
                         f"got W={W} L={L} top_n={top_n}")
    if min_l < 0 or W < 1 or top_n < 1 or nq < 1 or v < 1 or L < 1:
        raise ValueError(f"{name}: min_l={min_l}, max_l={max_l}, top_n={top_n} and the "
                         f"shape {tuple(st_probs.shape)} must be positive (min_l >= 0)")
    if v * L * W >= 2 ** 30:
        raise ValueError(f"{name}: V * L * W = {v * L * W} must stay below 2^30")
    dev = st_probs.device
    if dev.type == "cpu":
        out = banded_topk_spans(st_probs.float(), ed_probs.float(), video_scores.float(),
                                min_l, max_l, top_n)
        return (*out, torch.full((nq,), v, dtype=torch.int32)) if return_sorted else out
    ts = (st_probs, ed_probs, video_scores)
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError(f"{name}: all operands must be on one CUDA device, got "
                         f"{[str(t.device) for t in ts]}")
    st, ed, vs = (t.float().contiguous() for t in ts)
    vid, st_idx, ed_idx, videos = (
        torch.empty(shape, dtype=torch.int32, device=dev)
        for shape in ((nq, top_n), (nq, top_n), (nq, top_n), (nq,)))
    scores = torch.empty((nq, top_n), dtype=torch.float32, device=dev)
    _build.launch(name, dev, st.data_ptr(), ed.data_ptr(), vs.data_ptr(), nq, v, L, min_l,
                  max_l, top_n, vid.data_ptr(), st_idx.data_ptr(), ed_idx.data_ptr(),
                  scores.data_ptr(), videos.data_ptr())
    out = (vid, st_idx, ed_idx, scores)
    return (*out, videos) if return_sorted else out
