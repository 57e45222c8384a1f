"""qps (queries/s): every query completed in the measured window over the
window's seconds (host clock; the window ends when its last call's outputs
are on the host)."""


def read(run):
    return run.n_calls * run.nq / run.window_s
