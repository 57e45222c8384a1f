"""call_idle_pct (%), layer "device": the share of the traced window in
which the device was idle while the host was inside one of the port's spans
(``tvretrieval_tpu_torch/utils/trace.py``; ``benchmarks/spans.py``). The
gaps between the device's busy intervals (``benchmarks/timeline.py``) each
go to the innermost program span open at the gap's midpoint; the program's
spans and the device trace share ``time.time_ns()``'s clock. None where the
program records no spans."""
from benchmarks import spans


def read(run):
    if spans.n_calls(run) == 0:
        return None
    return 100.0 * sum(spans.idle_ns(run).values()) / (run.trace.t1 - run.trace.t0)


def describe(run):
    """Idle seconds and host self ms a call by the stage the host was in,
    and the device's busy time inside the calls by the events against the
    trace's outside the copies."""
    if spans.n_calls(run) == 0:
        return []
    idle, host = spans.idle_ns(run), spans.self_ms(run, spans.host_ms)
    lines = [f"idle s of {run.trace.window_s:.6f} in the window / host self ms a call:"]
    for name in (spans.ROOT,) + spans.STAGES:
        if name in host:
            lines.append(f"  {name}: {idle.get(name, 0) / 1e9:.6f} / {host[name]:.6f}")
    lines.append(f"  all program spans: {sum(idle.values()) / 1e9:.6f}")
    root = spans.root_ms(run)
    if root is not None:
        calls = spans.n_calls(run)
        events_s = (root * calls - sum(idle.values()) / 1e6) / 1e3
        trace_s = run.trace.busy_s - (run.trace.kernel_s(("Memcpy DtoH",)) or 0.0)
        lines.append(f"device busy in the calls by their events {events_s:.6f} s; "
                     f"in the trace, less its copies to the host, {trace_s:.6f} s")
    return lines
