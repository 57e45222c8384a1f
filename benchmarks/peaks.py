"""Published dense peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its
700 W limit), and the roofline arithmetic the per-layer metrics share."""
from __future__ import annotations

from typing import Optional, Sequence

PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {"int8": 1979e12, "bf16": 989e12, "tf32": 494.7e12, "f32": 67e12}


def bound_s(ops: float, n_bytes: float, precision: str) -> float:
    """The least time the card could take: the larger of the operations at
    their type's peak and the bytes at the memory rate."""
    return max(ops / PEAK_OPS_S[precision], n_bytes / PEAK_BYTES_S)


def roofline_pct(run, patterns: Sequence[str], ops: float, n_bytes: float,
                 precision: str) -> Optional[float]:
    """A kernel's share of its roofline over the traced window: the bound
    of one call's ``ops`` and ``n_bytes``, times the calls traced, over the
    device time of the operations whose names hold ``patterns``; None
    where no trace was taken or no such operation ran."""
    if run.trace is None:
        return None
    seconds = run.trace.kernel_s(patterns)
    if seconds is None:
        return None
    return 100.0 * bound_s(ops, n_bytes, precision) * run.n_calls / seconds
