"""Spans of the retrieval engine's stages, recorded while ``torch.profiler`` records.

The engine's per-batch entry (``retrieval/engine.py::_score_query_batch``)
opens one span around the call and one around each of its stages; the span
head in ``models/xml.py`` opens its own inside the span sweep's. A span
records only while a ``torch.profiler`` session records in the calling
thread: no flag, variable or configuration field turns it on, so whoever
profiles ``retrieve`` or the engine gets the spans. Off, ``span(name)`` is
one check and returns a shared no-op context; nothing is allocated or kept.

On, each span records
- ``name``, and ``call``: the id every span opened inside one outermost
  span shares (one ``_score_query_batch`` call);
- ``parent``: the index, in ``take()``'s list, of the enclosing span (None
  for an outermost one);
- ``start_ns`` / ``end_ns`` on the host, from ``time.time_ns()``, the clock
  of the profiler's device timestamps;
- ``counters``: integers the code adds with ``count`` (the engine's
  outermost span carries ``out_bytes``, the bytes of the tensors it returns);
- on a CUDA device, a timing event recorded on the stream at entry and one
  at exit. A span opened right after its sibling closed starts at the
  sibling's exit event, so device work issued between the two counts in
  the later span; one call of the engine records 12 events for its 9
  spans. ``device_start_ms`` is the time from the outermost span's entry
  event to the span's own, ``device_ms`` from its entry event to its exit
  event (both None off the card). An outermost span names its device and
  looks up its current stream once; the spans inside it record on the same
  stream.

Under the profiler every CUDA runtime call costs the host several
microseconds (on an H100 machine: an event's creation and first record
~10, ``elapsed_time`` ~10), so the spans make no call they can leave out:
the events are read only by ``take()``.

A stage's self time is its duration less the part its child spans cover.
Records stay in memory until ``take()`` returns them, in the order the
spans were opened, and clears the buffer; call it while no span is open.
Nothing is written to disk.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Optional

import torch

__all__ = ["Span", "span", "take"]

_recording = torch._C._autograd._profiler_enabled
_lock = threading.Lock()
_records: List["Span"] = []
_calls = itertools.count()
_open = threading.local()      # .stack: the spans open in this thread; .last: the last closed


class Span:
    """One span: a context manager while open, a record once taken."""

    __slots__ = ("name", "call", "parent", "start_ns", "end_ns", "device_start_ms",
                 "device_ms", "counters", "_device", "_stream", "_outer", "_start_ev", "_end_ev")

    def __init__(self, name: str, device: Optional[torch.device]):
        self.name = name
        self.call: Optional[int] = None
        self.parent: Optional[int] = None
        self.start_ns = 0
        self.end_ns: Optional[int] = None
        self.device_start_ms: Optional[float] = None
        self.device_ms: Optional[float] = None
        self.counters: Optional[Dict[str, int]] = None      # a dict once taken
        self._device = device
        self._stream = None
        self._outer: Optional[Span] = None
        self._start_ev = self._end_ev = None

    def count(self, **counters: int) -> None:
        """Add to the span's integer counters."""
        if self.counters is None:
            self.counters = {}
        for key, value in counters.items():
            self.counters[key] = self.counters.get(key, 0) + int(value)

    def _event(self):
        """A timing event recorded on the span's stream now (None off the card)."""
        if self._stream is None:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(self._stream)
        return ev

    def __enter__(self) -> "Span":
        local = _open
        stack = getattr(local, "stack", None)
        if stack is None:
            stack = local.stack = []
            local.last = None
        start_ev = None
        if stack:
            self._outer = outer = stack[-1]
            self.call = outer.call
            self._stream = outer._stream
            last = local.last
            if last is not None and last._outer is outer:
                start_ev = last._end_ev
        else:
            self.call = next(_calls)
            if self._device is not None and self._device.type == "cuda":
                self._stream = torch.cuda.current_stream(self._device)
        self.start_ns = time.time_ns()
        self._start_ev = start_ev if start_ev is not None else self._event()
        local.last = None
        with _lock:
            _records.append(self)
        stack.append(self)
        return self

    def __exit__(self, *exc) -> bool:
        self._end_ev = self._event()
        local = _open
        local.stack.pop()
        local.last = self
        self.end_ns = time.time_ns()
        return False


class _Off:
    """The span while no profiler records: enters as None."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def span(name: str, device: Optional[torch.device] = None):
    """A span named ``name`` while a profiler records in this thread (its
    context value is the ``Span``), else the shared no-op (value None).
    ``device``: where an outermost span times the device; inner spans time
    it on their outer span's stream."""
    if not _recording():
        return _OFF
    return Span(name, device)


def take() -> List[Span]:
    """The spans recorded since the last call, in the order they were
    opened, with ``parent`` as an index into this list and the device
    times read; the buffer is cleared."""
    global _records
    with _lock:
        records, _records = _records, []
    index = {id(s): i for i, s in enumerate(records)}
    base = {}                                  # call: its outermost span's entry event
    for s in records:
        s.parent = None if s._outer is None else index.get(id(s._outer))
        s._outer = None
        if s.counters is None:
            s.counters = {}
        if s._end_ev is None:
            continue
        if s.parent is None:
            s._end_ev.synchronize()            # the call's last event
            base[s.call] = s._start_ev
        first = base[s.call]
        s.device_start_ms = 0.0 if s._start_ev is first else first.elapsed_time(s._start_ev)
        s.device_ms = first.elapsed_time(s._end_ev) - s.device_start_ms
        s._start_ev = s._end_ev = s._stream = None
    return records
