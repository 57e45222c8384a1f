"""The readers of the port's own spans (``benchmarks/spans.py`` and the
metrics on it) on synthetic span records and a synthetic ``Trace``: self
times, the calls kept inside the window, idle gaps given to the innermost
span open at their midpoint and taken out of its device time, spans whose
device interval leaves their parent's, ``copy_out_gbps``'s arithmetic on
the device's copies a call; a program without the tracer reads None; and a traced
CPU run of a tiny cell through the harness reads the program's spans."""
from __future__ import annotations

import json
import time
from types import SimpleNamespace

import pytest

from benchmarks import harness, spans
from benchmarks.tests import tiny
from benchmarks.timeline import Trace

NEW = ["engine_host_ms", "encoder_ms", "video_scores_ms", "video_topk_ms", "span_sweep_ms",
       "span_head_ms", "span_topk_ms", "svmr_ms", "call_idle_pct", "copy_out_gbps"]
MS = 1_000_000                     # ns


def metric(name):
    return harness.load_metric(name, tiny.ROOT)


def _rec(name, call, parent, a, b, dev=None, at=None, **counters):
    return SimpleNamespace(name=name, call=call, parent=parent, start_ns=a, end_ns=b,
                           device_ms=dev, device_start_ms=at, counters=counters)


def _call(call, base, at, t, dev=True):
    """One call's spans from ``t`` (ns): root 10 ms on the host, 8 on the
    device, each stage's device interval inside it; the root's index in the
    list is ``base``."""
    d = (lambda x: x) if dev else (lambda x: None)
    return [
        _rec("score_query_batch", call, None, t, t + 10 * MS, d(8.0), d(0.0), out_bytes=4000),
        _rec("encode_query", call, base, t + 1 * MS, t + 2 * MS, d(1.0), d(0.5)),
        _rec("video_scores", call, base, t + 2 * MS, t + 3 * MS, d(2.0), d(1.5)),
        _rec("video_topk", call, base, t + 3 * MS, t + 4 * MS, d(0.25), d(3.5)),
        _rec("span_sweep", call, base, t + 4 * MS, t + 7 * MS, d(3.0), d(3.75)),
        _rec("span_head", call, base + 4, t + 6 * MS, t + 7 * MS, d(0.5), d(6.0)),
        _rec("span_head", call, base, t + 7 * MS, t + 8 * MS, d(0.25), d(6.75)),
        _rec("span_topk", call, base, t + 8 * MS, t + 9 * MS, d(0.5), d(7.0)),
        _rec("svmr", call, base, t + 9 * MS, t + at * MS, d(0.125), d(7.5)),
    ]


def _trace(t0, t1, device=None, harness_spans=()):
    """A trace of the window (t0, t1); without ``device`` the device is
    busy all through it."""
    if device is None:
        device = [("k", t0, t1)]
    tr = Trace.__new__(Trace)
    tr.device = sorted(device, key=lambda d: d[1])
    tr.spans = sorted(harness_spans, key=lambda s: s[1])
    tr.t0, tr.t1 = t0, t1
    return tr


def _run(records, trace, n_calls=2):
    run = harness.Run(cell="shipped-b1000", config={}, traffic={}, seed=0, nq=1000,
                      n_calls=n_calls, trace=trace)
    vars(run)[spans._KEY] = records
    return run


def _two_calls(dev=True):
    """Calls 7 and 8 inside a window of 100 ms from 1,000 ms; call 6 starts
    before it and call 9 ends after it."""
    t0 = 1000 * MS
    recs = []
    for call, t in ((6, t0 - 5 * MS), (7, t0 + 10 * MS), (8, t0 + 40 * MS), (9, t0 + 95 * MS)):
        recs += _call(call, len(recs), 10, t, dev)
    return recs, t0, t0 + 100 * MS


def test_self_times_a_call_inside_the_window():
    recs, t0, t1 = _two_calls()
    run = _run(recs, _trace(t0, t1))
    assert spans.n_calls(run) == 2
    own = spans.self_ms(run)
    assert own["span_sweep"] == pytest.approx(2.5)          # 3.0 less its span head
    assert own["span_head"] == pytest.approx(0.75)          # both spans of a call
    assert own["score_query_batch"] == pytest.approx(8.0 - 1 - 2 - 0.25 - 3 - 0.25 - 0.5
                                                     - 0.125)
    assert spans.misplaced(run) == 0
    want = {"encoder_ms": 1.0, "video_scores_ms": 2.0, "video_topk_ms": 0.25,
            "span_sweep_ms": 2.5, "span_head_ms": 0.75, "span_topk_ms": 0.5, "svmr_ms": 0.125}
    for name, value in want.items():
        assert metric(name).read(run) == pytest.approx(value), name
    host = spans.self_ms(run, spans.host_ms)
    assert host["span_sweep"] == pytest.approx(2.0) and host["svmr"] == pytest.approx(1.0)
    assert host["score_query_batch"] == pytest.approx(1.0)
    assert metric("engine_host_ms").read(run) == pytest.approx(10.0)
    lines = metric("engine_host_ms").describe(run)
    assert any("span_sweep: 2.000000 / 2.500000 / 2.500000" in line for line in lines)
    assert lines[-1].endswith("spans whose events leave their parent's: 0")


def test_calls_past_the_window_and_unfinished_spans_are_left_out():
    recs, t0, t1 = _two_calls()
    recs[-9].end_ns = None                  # call 9's root never closed
    run = _run(recs, _trace(t0, t1))
    assert spans.n_calls(run) == 2
    # the window holding one call's root only keeps that call
    one = _run(recs, _trace(t0 + 30 * MS, t1))
    assert spans.n_calls(one) == 1
    assert metric("engine_host_ms").read(one) == pytest.approx(10.0)
    # a span without device time leaves the stage metrics with nothing to read
    recs[9 + 3].device_ms = None
    run = _run(recs, _trace(t0, t1))
    assert metric("video_topk_ms").read(run) is None
    assert metric("engine_host_ms").read(run) == pytest.approx(10.0)


def test_idle_goes_to_the_innermost_span_at_the_gap_midpoint():
    recs, t0, t1 = _two_calls()
    c = t0 + 10 * MS                        # call 7's root opens here
    busy = [(c - 10 * MS, c + 1 * MS),      # gap 0: from t0's busy start, none
            (c + 2 * MS, c + 4 * MS + MS // 2),
            (c + 6 * MS + MS // 2, c + 100 * MS)]
    dev = [("k", a, b) for a, b in busy]
    run = _run(recs, _trace(t0, t1, dev))
    idle = spans.idle_ns(run)
    # (c+1, c+2): midpoint in encode_query; (c+4.5, c+6.5): midpoint c+5.5
    # in span_sweep, outside its span head (c+6 .. c+7)
    assert idle == {"encode_query": MS, "span_sweep": 2 * MS}
    assert metric("call_idle_pct").read(run) == pytest.approx(100 * 3 * MS / (t1 - t0))
    # the gaps leave the stages' device self times, a call over the window's two
    assert metric("encoder_ms").read(run) == pytest.approx(1.0 - 0.5)
    assert metric("span_sweep_ms").read(run) == pytest.approx(2.5 - 1.0)
    assert metric("video_scores_ms").read(run) == pytest.approx(2.0)
    assert spans.busy_ms(run)["score_query_batch"] == pytest.approx(
        spans.self_ms(run)["score_query_batch"])
    # gaps whose midpoints lie in the inner span head, between calls 7 and
    # 8 (left out), and in call 8's root before its first stage
    busy = [(t0, c + 5 * MS), (c + 7 * MS + MS // 2, t0 + 30 * MS),
            (t0 + 38 * MS, t0 + 40 * MS + MS // 4), (t0 + 40 * MS + 3 * MS // 4, t1)]
    run = _run(recs, _trace(t0, t1, [("k", a, b) for a, b in busy]))
    assert spans.idle_ns(run) == {"span_head": 2 * MS + MS // 2, "score_query_batch": MS // 2}
    lines = metric("call_idle_pct").describe(run)
    assert lines[-2].endswith("all program spans: 0.003000")
    # two calls of 8 device ms less 3 idle, against the trace's 100 ms less 11 idle
    assert lines[-1] == ("device busy in the calls by their events 0.013000 s; "
                         "in the trace, less its copies to the host, 0.089000 s")


def test_spans_leaving_their_parent_on_the_device_are_counted():
    recs, t0, t1 = _two_calls()
    recs[9 + 5].device_start_ms = 3.5       # call 7's inner span head starts before the sweep
    recs[18 + 8].device_ms = 0.75           # call 8's SVMR ends past its root
    recs[27 + 1].device_start_ms = -1.0     # call 9 lies past the window
    run = _run(recs, _trace(t0, t1))
    assert spans.misplaced(run) == 2
    assert metric("engine_host_ms").describe(run)[-1].endswith(
        "spans whose events leave their parent's: 2")
    recs[9 + 5].device_start_ms = None
    assert spans.misplaced(_run(recs, _trace(t0, t1))) is None


def test_copy_out_gbps_is_output_bytes_over_the_device_copies_a_call():
    recs, t0, t1 = _two_calls()
    harness_spans = [("copy_out", t0 + 20 * MS, t0 + 21 * MS),
                     ("copy_out", t0 + 50 * MS, t0 + 51 * MS),
                     ("copy_out", t0 - 3 * MS, t0 - 2 * MS),        # before the window
                     ("queries", t0 + 1 * MS, t0 + 2 * MS)]
    dtoh = "Memcpy DtoH (Device -> Pageable)"
    device = [("k", t0 + 10 * MS, t0 + 20 * MS + 100),             # the call's last kernel
              (dtoh, t0 + 20 * MS + 300, t0 + 20 * MS + 1300),
              (dtoh, t0 + 20 * MS + 1500, t0 + 20 * MS + 2500),
              (dtoh, t0 + 50 * MS + 100, t0 + 50 * MS + 2100),
              (dtoh, t1 - 1000, t1 + 9000),                         # 1,000 ns in the window
              (dtoh, t0 - 3 * MS + 10, t0 - 3 * MS + 9000)]         # before the window
    run = _run(recs, _trace(t0, t1, device, harness_spans))
    assert spans.counter(run, "out_bytes") == 4000
    assert spans.copy_ms(run) == pytest.approx(0.0025)               # 5,000 ns over 2 calls
    assert metric("copy_out_gbps").read(run) == pytest.approx(4000 / 2500)   # bytes / ns
    assert metric("copy_out_gbps").describe(run) == [
        "4000.0 bytes a call; device-to-host copies 0.002500 ms a call",
        "copies outside the host's copy_out spans (clocks apart): 0 of 3"]
    # a device clock 0.5 ms late puts the second call's copy past its span
    late = device[:3] + [(dtoh, t0 + 50 * MS + 600_000, t0 + 51 * MS + 100_000)]
    run = _run(recs, _trace(t0, t1, late, harness_spans))
    assert spans.copies_astray(run) == (1, 3)
    # no copy in the window, or no copy_out span in it: nothing to read
    run = _run(recs, _trace(t0, t1, device[:1] + device[5:], harness_spans))
    assert metric("copy_out_gbps").read(run) is None
    run = _run(recs, _trace(t0, t1, device, harness_spans[2:]))
    assert metric("copy_out_gbps").read(run) is None


@pytest.mark.parametrize("records", [[], None])
def test_a_program_without_spans_reads_none(records):
    _, t0, t1 = _two_calls()
    run = _run(records or [], _trace(t0, t1, [("k", t0, t0 + MS)]))
    if records is None:                     # no trace at all
        run.trace = None
        del vars(run)[spans._KEY]
    for name in NEW:
        module = metric(name)
        assert module.read(run) is None, name
        assert getattr(module, "describe", lambda r: [])(run) == [], name


def test_new_metrics_follow_both_cells():
    spec = harness.load_spec(tiny.ROOT)
    for cell in ("shipped-b1000", "int8exact-b1000"):
        names = [m["name"] for m in harness.cell_metrics(spec, cell, True)]
        assert set(NEW) <= set(names), cell
        assert names[-len(NEW):] == NEW
        assert not set(NEW) & {m["name"] for m in harness.cell_metrics(spec, cell, False)}
    layers = {m["layer"] for m in spec["per_layer"] if m["name"] in NEW}
    assert layers == {"engine: _score_query_batch on the host", "query encoder",
                      "video scores", "selections", "span sweep", "span head", "device"}


def test_a_traced_cpu_run_reads_the_programs_spans(tmp_path):
    root = tiny.make_root(tmp_path)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    for m in spec["per_layer"]:
        if m["name"] in NEW:
            m["workloads"].append("tiny-shipped")
    spec["end_to_end"][0]["workloads"].append("tiny-shipped")        # qps
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    res = harness.run_cell("tiny-shipped", 2 ** 31 + 5, 0.3, True, "cpu", time.perf_counter(),
                           root, log=lambda s: None)
    assert res["correct"], res["checks"]
    got = res["metrics"]
    # host times; no device time, and no device copy, on the CPU
    assert got["engine_host_ms"]["value"] > 0 and got["engine_host_ms"]["unit"] == "ms"
    assert "call_idle_pct" in got
    assert not {"encoder_ms", "span_sweep_ms", "svmr_ms", "copy_out_gbps"} & set(got)
