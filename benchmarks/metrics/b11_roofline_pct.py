"""b11_roofline_pct (%), layer "selections: ops/approx_topk.py ->
csrc/approx_topk.cu (B11)": the approximate top-k kernel's device time (its
three sites a call) against a bound in bytes at logical shapes: every
video's f32 score read once by the video top-V, and the top-V videos and
the top-N moments written, values and indices. The rows the span sites
read (group maxima, candidate pools) are the grouped algorithm's choice and
are not counted."""
from benchmarks.peaks import roofline_pct

PATTERNS = ("approx_topk_kernel",)


def counts(nq, nv, v, top_n):
    """(operations, bytes) of one call."""
    return 0.0, nq * (4.0 * nv + 8.0 * (v + top_n))


def read(run):
    nv = run.corpus["n_videos"]
    return roofline_pct(run, PATTERNS, *counts(run.nq, nv, min(run.retrieval["max_vcmr_video"], nv),
                                               run.retrieval["max_before_nms"]), "f32")


def describe(run):
    return [f"kernels matched: {run.trace.kernel_names(PATTERNS)}"] if run.trace else []
