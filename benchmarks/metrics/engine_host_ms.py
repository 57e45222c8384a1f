"""engine_host_ms (ms), layer "engine: _score_query_batch on the host": the
host time a call of the port's root span "score_query_batch"
(``tvretrieval_tpu_torch/utils/trace.py``, opened inside
``retrieval/engine.py::_score_query_batch``), over the traced window's
calls (``benchmarks/spans.py``): ``host_enqueue_ms`` measured from inside
the program. None where the program records no such span."""
from benchmarks import spans


def read(run):
    return spans.root_ms(run, spans.host_ms)


def describe(run):
    """Each stage's host self time, device self time and device busy self
    time a call, and how many spans' device intervals leave their
    parent's."""
    host, device, busy = (spans.self_ms(run, spans.host_ms), spans.self_ms(run),
                          spans.busy_ms(run))
    if not host:
        return []
    lines = [f"{spans.n_calls(run)} calls in the window; self ms a call, "
             "host / device / device busy:"]
    for name in (spans.ROOT,) + spans.STAGES:
        if name in host:
            dev = (f"{device[name]:.6f} / {busy[name]:.6f}" if name in device
                   else "none / none")
            lines.append(f"  {name}: {host[name]:.6f} / {dev}")
    bad = spans.misplaced(run)
    if bad is not None:
        lines.append(f"device: root {spans.root_ms(run):.6f} ms a call; spans whose events "
                     f"leave their parent's: {bad}")
    return lines
