"""device_idle_pct (%), layer "device: H100": 100 less the union of the
device's kernel, copy and memset intervals over the traced window
(``torch.profiler``)."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
