"""batch_ms_p95 (ms): the 95th percentile, over every call of the window,
of the host-clock time from the call of ``_score_query_batch`` to all of
its outputs on the host."""
import numpy as np


def read(run):
    return 1e3 * float(np.percentile(run.latencies_s, 95))
