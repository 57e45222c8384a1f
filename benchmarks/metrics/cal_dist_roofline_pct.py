"""cal_dist_roofline_pct (%), layer "CAL distances": the least time the
stage's work could take on the card over the device's busy time a call in
the port's spans "cal_dist" (``cal_dist_ms``): read by span, so it follows
whatever kernel runs the stage.

The work a call is counted in its cheapest exact form, at logical shapes
from the configuration (N = n_videos * per_video proposal slots, Do the
embedding width, B the queries): one product of the queries against the
streams' summed proposal means, 2 * B * N * Do operations, and one read of
an f32 cache of N * (Do + 1) floats (the summed means and one offset a
proposal). The operations count at a third of the TF32 peak, the rate of
3xTF32 products, the card's fastest f32-accurate ones; the bytes at the
memory rate; the larger of the two is the bound, so no implementation that
keeps the stated precision reads above 100%."""
from benchmarks import peaks, spans

F32_RATE = peaks.PEAK_OPS_S["tf32"] / 3


def work(config: dict, nq: int):
    """(operations, bytes) of one call's distances."""
    n = config["corpus"]["n_videos"] * config["proposals"]["per_video"]
    do = config["model"]["output_size"]
    return 2 * nq * n * do, n * (do + 1) * 4


def read(run):
    ms = spans.stage_ms(run, "cal_dist")
    if ms is None or ms <= 0:
        return None
    ops, n_bytes = work(run.config, run.nq)
    return 100.0 * max(ops / F32_RATE, n_bytes / peaks.PEAK_BYTES_S) * 1e3 / ms


def describe(run):
    ms = spans.stage_ms(run, "cal_dist")
    if ms is None:
        return []
    ops, n_bytes = work(run.config, run.nq)
    return [f"{ops:.6e} operations and {n_bytes:.6e} bytes a call: bound "
            f"{1e3 * ops / F32_RATE:.6f} ms by operations, "
            f"{1e3 * n_bytes / peaks.PEAK_BYTES_S:.6f} ms by bytes; busy {ms:.6f} ms a call; "
            f"counted by the program: proposals {spans.counter(run, 'proposals')}"]
