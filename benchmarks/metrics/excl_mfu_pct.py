"""excl_mfu_pct (%), layer "whole step": the time MEE + ExCL's necessary
operations would take at the card's f32-accurate peak, over the measured
time, for the calls of the traced window.

Necessary operations, at logical shapes (real query tokens, the corpus's
clips): MEE's query side (NetVLAD over the padded tokens it pools, the two
gated units, the mixture weights) and its scores of every video; ExCL's
query LSTM at each query's token count, both directions; and for each of
the Nq * (N + 1) (query, video) pairs, each stream and each clip, the work
no cache can take away: the second LSTM's recurrent products of both
directions, the ctx2 part of the start and end heads' first layers and
their last layers. Everything in f32, at a third of the TF32 peak (3xTF32,
the card's fastest f32-accurate rate). Element-wise work, softmax and the
selections are not counted."""
from benchmarks import peaks

F32_RATE = peaks.PEAK_OPS_S["tf32"] / 3


def parts(config: dict, nq: int, token_lens) -> dict:
    """{part: operations} summed over calls whose per-query token lengths
    are ``token_lens`` (one array a call)."""
    m, e, c = config["model"]["mee"], config["model"]["excl"], config["corpus"]
    D, K, out = m["text_input_size"], m["netvlad_clusters"], m["output_size"]
    lq = config["model"]["max_desc_l"]
    H, h, L = e["hidden_size"], e["hidden_size"] // 2, c["n_clips"]
    calls = len(token_lens)
    tokens = float(sum(int(x.sum()) for x in token_lens))
    pairs = nq * (min(config["retrieval"]["top_n_videos"], c["n_videos"]) + 1)
    mee_query = (2 * 2 * lq * D * K + 2 * (2 * K * D * out + 2 * out * out) + 2 * K * D * 2)
    return {"mee_query": calls * nq * mee_query,
            "mee_scores": calls * nq * 2 * 2 * c["n_videos"] * out,
            "excl_query": tokens * 2 * (2 * e["query_input_size"] * 4 * h + 2 * h * 4 * h),
            "excl_pairs": calls * pairs * 2 * L * (2 * (2 * h * 4 * h) + 2 * (2 * H * H)
                                                   + 2 * (2 * H))}


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
