"""excl_lstm_roofline_pct (%), layer "ExCL fused LSTM": the least time the
stage's irreducible work could take on the card over the device's busy
time a call in the port's span "excl_lstm" (``excl_lstm_ms``): read by
span, so it follows whatever kernel runs the stage.

Irreducible work a call, at logical shapes from the configuration: P =
Nq * (N + 1) (query, video) pairs (the top N videos and the ground-truth
video's SVMR row), and for each pair, each of the two streams and each of
the L clips the recurrent products of both directions of the second LSTM,
2 * (2 * h * 4h) operations (h = hidden_size / 2). The input products of
[ctx1; query] are not counted: ctx1's part does not depend on the query
and could be cached, the query's is one product a query. Bytes: the
gathered ctx1 read and ctx2 written, f32. The operations count at a third
of the TF32 peak, the rate of 3xTF32 products, the card's fastest
f32-accurate ones: no implementation that keeps the stated precision reads
above 100%."""
from benchmarks import peaks, spans

F32_RATE = peaks.PEAK_OPS_S["tf32"] / 3


def work(config: dict, nq: int):
    """(operations, bytes) of one call's irreducible LSTM work."""
    e, c = config["model"]["excl"], config["corpus"]
    h, L = e["hidden_size"] // 2, c["n_clips"]
    pairs = nq * (min(config["retrieval"]["top_n_videos"], c["n_videos"]) + 1)
    ops = pairs * 2 * L * 2 * (2 * h * 4 * h)
    n_bytes = pairs * 2 * L * 2 * e["hidden_size"] * 4
    return ops, n_bytes


def read(run):
    ms = spans.stage_ms(run, "excl_lstm")
    if ms is None or ms <= 0:
        return None
    ops, n_bytes = work(run.config, run.nq)
    return 100.0 * max(ops / F32_RATE, n_bytes / peaks.PEAK_BYTES_S) * 1e3 / ms


def describe(run):
    ms = spans.stage_ms(run, "excl_lstm")
    if ms is None:
        return []
    ops, n_bytes = work(run.config, run.nq)
    return [f"{ops:.6e} operations and {n_bytes:.6e} bytes a call: bound "
            f"{1e3 * ops / F32_RATE:.6f} ms by operations, "
            f"{1e3 * n_bytes / peaks.PEAK_BYTES_S:.6f} ms by bytes; busy {ms:.6f} ms a call; "
            f"counted by the program: pairs {spans.counter(run, 'pairs')}"]
