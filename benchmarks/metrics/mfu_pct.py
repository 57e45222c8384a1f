"""mfu_pct (%), layer "whole step": the time the step's necessary
operations would take at the data-sheet peak of their stated precision, over
the measured time, for the calls of the traced window.

Necessary operations, counted at logical shapes (real query tokens, the
corpus's clips, no padding, and none of the port's choices): the query
encoder in f32 (the input projection, the self-attention layer, the modular
pooling and the two query linears; TF32 is off); the video scores of every
video in int8; the span similarities of the top-V and the ground-truth
videos only, at feat2's stated precision; the two ConvSE convolutions over
those rows in f32. Element-wise work, softmax and the selections are not
counted."""
from benchmarks.peaks import PEAK_OPS_S


def parts(model, retrieval, semantics, corpus, nq, token_lens):
    """{part: (operations, precision)} summed over calls whose per-query
    token lengths are ``token_lens`` (one array a call)."""
    h, qin = model["hidden_size"], model["query_input_size"]
    k, L, nv = model["conv_kernel_size"], corpus["n_clips"], corpus["n_videos"]
    v1 = min(retrieval["max_vcmr_video"], nv) + 1
    calls = len(token_lens)
    t = float(sum(int(x.sum()) for x in token_lens))
    t2 = float(sum(int((x.astype("int64") ** 2).sum()) for x in token_lens))
    encoder = (2 * t * qin * h + 8 * t * h * h + 4 * t2 * h + 8 * t * h
               + calls * 4 * nq * h * h)
    sim = {"bf16": "bf16", "int8_rows": "int8"}[semantics["feat2"]]
    return {"encoder": (encoder, "f32"),
            "video_scores": (calls * 4.0 * nq * nv * L * h, "int8"),
            "span_similarity": (calls * 2.0 * nq * v1 * L * 2 * h, sim),
            "convse": (calls * 4.0 * nq * v1 * L * k, "f32")}


def _window(run):
    return run.trace.window_s if run.trace is not None else None


def read(run):
    window = _window(run)
    if window is None:
        return None
    p = parts(run.model, run.retrieval, run.semantics, run.corpus, run.nq, run.token_lens)
    return 100.0 * sum(ops / PEAK_OPS_S[prec] for ops, prec in p.values()) / window


def describe(run):
    if _window(run) is None:
        return []
    p = parts(run.model, run.retrieval, run.semantics, run.corpus, run.nq, run.token_lens)
    n = run.n_calls
    lines = [f"{name}: {ops / n:.6e} operations a call in {prec} = "
             f"{1e3 * ops / n / PEAK_OPS_S[prec]:.6f} ms at {PEAK_OPS_S[prec] / 1e12:g} T/s"
             for name, (ops, prec) in p.items()]
    ideal = sum(ops / PEAK_OPS_S[prec] for ops, prec in p.values()) / n
    lines.append(f"ideal {1e3 * ideal:.6f} ms a call against {1e3 * run.trace.window_s / n:.6f} "
                 f"ms measured ({n} calls, {run.nq} queries a call)")
    return lines
