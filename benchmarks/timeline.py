"""The device timeline of a ``--trace 1`` run, read from ``torch.profiler``.

Device operations are the profiler's CUDA-side events (kernels, copies and
memsets), user annotations left out. The profiler records device activity
only: its host-side recording of every operator doubled the host's time a
call in the engine, which bounds the cells' pace. The harness's own host
spans (the query draw, the call of the engine, the copy of its outputs to
the host) and the window are taken with ``time.time_ns()``, the clock the
profiler's timestamps are given in.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch



def _is_annotation(ev) -> bool:
    flag = getattr(ev, "is_user_annotation", None)
    return bool(flag()) if callable(flag) else False


class Trace:
    """Device intervals of one profiled window and the harness's host spans
    [(name, start, end)], in nanoseconds on the profiler's clock; the window
    is (t0, t1)."""

    def __init__(self, prof, spans: List[Tuple[str, int, int]], t0: int, t1: int):
        self.device: List[Tuple[str, int, int]] = []
        for ev in prof.profiler.kineto_results.events():
            if ev.device_type() == torch.autograd.DeviceType.CUDA and not _is_annotation(ev):
                start = ev.start_ns()
                self.device.append((ev.name(), start, start + ev.duration_ns()))
        self.device.sort(key=lambda d: d[1])
        self.spans = sorted(spans, key=lambda s: s[1])
        self.t0, self.t1 = t0, t1

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of device intervals, clipped to the window."""
        merged: List[List[int]] = []
        for _, a, b in self.device:
            a, b = max(a, self.t0), min(b, self.t1)
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def kernel_s(self, patterns) -> Optional[float]:
        """Seconds of the device operations whose name holds any of
        ``patterns``, inside the window; None if none ran."""
        hits = [min(b, self.t1) - max(a, self.t0) for name, a, b in self.device
                if any(p in name for p in patterns) and b > self.t0 and a < self.t1]
        return sum(hits) / 1e9 if hits else None

    def kernel_names(self, patterns) -> List[str]:
        return sorted({name for name, _, _ in self.device if any(p in name for p in patterns)})

    def device_ops(self, top: int = 10) -> List[list]:
        """The device operations that took the most time: [name, seconds]."""
        total: Dict[str, int] = {}
        for name, a, b in self.device:
            a, b = max(a, self.t0), min(b, self.t1)
            if b > a:
                total[name] = total.get(name, 0) + (b - a)
        ranked = sorted(total.items(), key=lambda kv: -kv[1])[:top]
        return [[name[:160], ns / 1e9] for name, ns in ranked]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """Idle device time by what the host was doing at each gap's
        middle (the innermost harness span), summed: [activity, seconds]."""
        edges = [self.t0] + [t for ab in self.busy_intervals() for t in ab] + [self.t1]
        inner = self.spans
        total: Dict[str, int] = {}
        j = 0
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) // 2
            while j < len(inner) and inner[j][2] < mid:
                j += 1
            name = "between harness spans"
            if j < len(inner) and inner[j][1] <= mid:
                name = "host in " + inner[j][0]
            total[name] = total.get(name, 0) + (b - a)
        ranked = sorted(total.items(), key=lambda kv: -kv[1])[:top]
        return [[name, ns / 1e9] for name, ns in ranked]
