"""The port's own spans in a traced run, as the per-layer metrics read them.

While ``torch.profiler`` records, the port records one span a
``_score_query_batch`` call, "score_query_batch", carrying the counter
``out_bytes``, and inside it one span a stage
(``tvretrieval_tpu_torch/utils/trace.py``). ``records`` takes them from the
program once a run (the program's ``trace.take()`` clears its buffer);
every reader here keeps the calls whose root span lies inside the traced
window and averages over them. A program without the tracer gives no
records, and the readers return None.

A span's self time is its duration less its child spans' durations; its
device time comes from the CUDA events the program records at its entry and
exit, its host time from ``time.time_ns()``, the clock of the profiler's
device timestamps (``benchmarks/timeline.py``). A span's device time is a
distance between two events on the stream, so it holds the device's idle
time inside it too. While the device idles it has run all the host has
issued, so an idle gap seen while the host is in a span's own part lies in
that span's own part on the device: ``busy_ms`` takes the gaps ``idle_ns``
gives each span out of its device self time.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

ROOT = "score_query_batch"
STAGES = ("encode_query", "video_scores", "video_topk", "span_sweep", "span_head",
          "span_topk", "svmr")
_KEY = "program_spans"


def records(run) -> list:
    """Every span record the program kept in the run, taken once and kept
    on ``run``; [] without a trace or without the program's tracer."""
    if run.trace is None:
        return []
    if _KEY not in vars(run):
        try:
            from tvretrieval_tpu_torch.utils import trace
        except ImportError:
            vars(run)[_KEY] = []
        else:
            vars(run)[_KEY] = trace.take()
    return vars(run)[_KEY]


def _window(run) -> Tuple[list, List[int]]:
    """(records, indices of the spans of the calls inside the window)."""
    recs = records(run)
    calls = {r.call for r in recs
             if r.parent is None and r.name == ROOT and r.end_ns is not None
             and run.trace.t0 <= r.start_ns and r.end_ns <= run.trace.t1}
    return recs, [i for i, r in enumerate(recs) if r.call in calls]


def _self(recs: list, duration) -> List[Optional[float]]:
    """Each record's ``duration`` less its children's (None where any of
    them has none)."""
    dur = [duration(r) for r in recs]
    own = list(dur)
    for r, d in zip(recs, dur):
        if r.parent is not None and own[r.parent] is not None:
            own[r.parent] = None if d is None else own[r.parent] - d
    return own


def host_ms(r) -> Optional[float]:
    """A record's host duration (ms)."""
    return None if r.end_ns is None else (r.end_ns - r.start_ns) / 1e6


def device_ms(r) -> Optional[float]:
    """A record's device duration (ms) from its events."""
    return r.device_ms


def n_calls(run) -> int:
    recs, keep = _window(run)
    return sum(1 for i in keep if recs[i].parent is None)


def self_ms(run, duration=device_ms) -> Dict[str, float]:
    """Self time a call (ms) by span name over the window's calls: device
    time by default, host time with ``duration=host_ms``; {} where a span
    has no such time or no call lies in the window."""
    recs, keep = _window(run)
    calls = sum(1 for i in keep if recs[i].parent is None)
    own = _self(recs, duration)
    if not calls or any(own[i] is None for i in keep):
        return {}
    out: Dict[str, float] = {}
    for i in keep:
        out[recs[i].name] = out.get(recs[i].name, 0.0) + own[i] / calls
    return out


def busy_ms(run) -> Dict[str, float]:
    """Device busy self time a call (ms) by span name: the device self time
    less the idle gaps given to the span (``idle_ns``); {} where a span has
    no device time or no call lies in the window."""
    own = self_ms(run)
    if not own:
        return {}
    calls, idle = n_calls(run), idle_ns(run)
    return {name: ms - idle.get(name, 0) / 1e6 / calls for name, ms in own.items()}


def stage_ms(run, name: str) -> Optional[float]:
    """The device busy self time a call of the stage ``name``."""
    return busy_ms(run).get(name)


def misplaced(run) -> Optional[int]:
    """Spans of the window's calls whose device interval, read from the
    call's first event, leaves their parent's by more than ``tol_ms``
    (0.001 ms); None without device times."""
    tol_ms = 1e-3
    recs, keep = _window(run)
    if not keep or any(getattr(recs[i], "device_start_ms", None) is None for i in keep):
        return None
    bad = 0
    for i in keep:
        r = recs[i]
        if r.parent is None:
            continue
        p = recs[r.parent]
        if (r.device_start_ms < p.device_start_ms - tol_ms
                or r.device_start_ms + r.device_ms > p.device_start_ms + p.device_ms + tol_ms):
            bad += 1
    return bad


def root_ms(run, duration=device_ms) -> Optional[float]:
    """The root span's time a call (device by default)."""
    recs, keep = _window(run)
    roots = [duration(recs[i]) for i in keep if recs[i].parent is None]
    if not roots or any(t is None for t in roots):
        return None
    return sum(roots) / len(roots)


def counter(run, key: str) -> Optional[float]:
    """The root span's counter ``key`` a call."""
    recs, keep = _window(run)
    roots = [recs[i] for i in keep if recs[i].parent is None]
    if not roots or any(key not in r.counters for r in roots):
        return None
    return sum(r.counters[key] for r in roots) / len(roots)


def idle_ns(run) -> Dict[str, int]:
    """Idle device time in the window by the innermost program span open
    on the host at each idle gap's midpoint: {span name: ns}. Gaps whose
    midpoint lies outside every program span are left out."""
    recs, keep = _window(run)
    spans = sorted((recs[i] for i in keep), key=lambda r: r.start_ns)
    t0, t1 = run.trace.t0, run.trace.t1
    edges = [t0] + [t for ab in run.trace.busy_intervals() for t in ab] + [t1]
    out: Dict[str, int] = {}
    stack: list = []
    j = 0
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        while j < len(spans) and spans[j].start_ns <= mid:
            while stack and stack[-1].end_ns <= spans[j].start_ns:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1].end_ns < mid:
            stack.pop()
        if stack:
            out[stack[-1].name] = out.get(stack[-1].name, 0) + (b - a)
    return out


def copy_ms(run, span: str = "copy_out", op: str = "Memcpy DtoH") -> Optional[float]:
    """Device time (ms) of the window's copies named ``op`` over the
    harness's spans ``span`` in the window (``run.trace.spans``): one such
    span a call, and the engine issues no copy to the host of its own.
    Matching each copy to its span instead would lean on the device and
    host clocks agreeing to the microsecond, which a run does not always
    give. None where no such copy ran."""
    if run.trace is None:
        return None
    t0, t1 = run.trace.t0, run.trace.t1
    n = sum(1 for name, a, b in run.trace.spans if name == span and t0 <= a and b <= t1)
    sec = run.trace.kernel_s((op,))
    return 1e3 * sec / n if n and sec else None


def copies_astray(run, span: str = "copy_out", op: str = "Memcpy DtoH") -> Tuple[int, int]:
    """(copies named ``op`` in the window that lie outside every harness
    span ``span``, all such copies): a pageable copy runs on the device
    while the host waits in it, so any astray copy shows the device
    trace's clock standing apart from the host's, by which the idle gaps
    are given to the host's spans."""
    t0, t1 = run.trace.t0, run.trace.t1
    hosts = [(a, b) for name, a, b in run.trace.spans if name == span]
    starts = [a for a, _ in hosts]
    astray = total = 0
    for name, a, b in run.trace.device:
        if op not in name or a < t0 or b > t1:
            continue
        total += 1
        j = bisect.bisect_right(starts, a) - 1
        astray += not (j >= 0 and b <= hosts[j][1])
    return astray, total
