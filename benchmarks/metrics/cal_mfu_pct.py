"""cal_mfu_pct (%), layer "whole step": the time CAL's necessary operations
would take at the card's f32-accurate peak, over the measured time, for the
calls of the traced window.

Necessary operations, at logical shapes: the query LSTM at each query's
token count (the input and recurrent products of its four gates), the
query linear, and the distances in their cheapest exact form, one product
of each query against the N = n_videos * per_video proposals' summed
means (2 * N * Do a query). Everything in f32, at a third of the TF32 peak
(3xTF32, the card's fastest f32-accurate rate). Element-wise work, norms
and the selections are not counted."""
from benchmarks import peaks

F32_RATE = peaks.PEAK_OPS_S["tf32"] / 3


def parts(config: dict, nq: int, token_lens) -> dict:
    """{part: operations} summed over calls whose per-query token lengths
    are ``token_lens`` (one array a call)."""
    m = config["model"]
    D, H, Do = m["query_feat_size"], m["lstm_hidden_size"], m["output_size"]
    n = config["corpus"]["n_videos"] * config["proposals"]["per_video"]
    calls = len(token_lens)
    tokens = float(sum(int(x.sum()) for x in token_lens))
    return {"query_lstm": tokens * 2 * 4 * H * (D + H),
            "query_linear": calls * nq * 2 * H * Do,
            "distances": calls * nq * 2 * n * Do}


def read(run):
    if run.trace is None:
        return None
    ops = sum(parts(run.config, run.nq, run.token_lens).values())
    return 100.0 * ops / F32_RATE / run.trace.window_s


def describe(run):
    if run.trace is None:
        return []
    n = run.n_calls
    p = parts(run.config, run.nq, run.token_lens)
    lines = [f"{name}: {ops / n:.6e} operations a call" for name, ops in p.items()]
    ideal = sum(p.values()) / F32_RATE / n
    lines.append(f"ideal {1e3 * ideal:.6f} ms a call at {F32_RATE / 1e12:g} TFLOP/s against "
                 f"{1e3 * run.trace.window_s / n:.6f} ms measured ({n} calls)")
    return lines
