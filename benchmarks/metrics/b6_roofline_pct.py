"""b6_roofline_pct (%), layer "selections: ops/sort.py -> csrc/topk_sort.cu
(B6)": the sorting kernel's device time (its five launches a call) against
a bound in bytes: the top-V videos and the top-N moments written, values
and indices. What B6 reads (block maxima, pruned pools) depends on the
selection algorithm around it, so only the outputs count: the share reads
low, and no design of the selections can take it past 100%."""
from benchmarks.peaks import roofline_pct

PATTERNS = ("topk_select_kernel",)


def counts(nq, v, top_n):
    """(operations, bytes) of one call."""
    return 0.0, 8.0 * nq * (v + top_n)


def read(run):
    nv = run.corpus["n_videos"]
    return roofline_pct(run, PATTERNS, *counts(run.nq, min(run.retrieval["max_vcmr_video"], nv),
                                               run.retrieval["max_before_nms"]), "f32")


def describe(run):
    return [f"kernels matched: {run.trace.kernel_names(PATTERNS)}"] if run.trace else []
