"""host_enqueue_ms (ms), layer "engine: retrieval/engine.py::_score_query_batch
(host side)": the host-clock time from the call of ``_score_query_batch``
to its return, without a sync, summed over the window's calls and divided
by their number."""


def read(run):
    return 1e3 * sum(run.enqueue_s) / len(run.enqueue_s)
