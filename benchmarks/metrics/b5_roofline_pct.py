"""b5_roofline_pct (%), layer "span sweep: csrc/span_sim.cu (B5)": the int8
span-similarity kernel's device time against its bound at logical shapes:
Nq x (Nv x L rows) x 2D multiply-adds in int8; the int8 feat2 rows and
their f32 scales, the int8 queries and their scales read, the (Nq, Nv, L)
bf16 similarity written once (no clip or video padding)."""
from benchmarks.peaks import roofline_pct

PATTERNS = ("span_sim_wgmma_kernel",)


def counts(nq, nv, L, d):
    """(operations, bytes) of one call; d is the hidden size, the rows 2d."""
    rows, k = nv * L, 2 * d
    return 2.0 * nq * rows * k, rows * k + 4.0 * rows + nq * k + 4.0 * nq + 2.0 * nq * rows


def read(run):
    return roofline_pct(run, PATTERNS, *counts(run.nq, run.corpus["n_videos"],
                                               run.corpus["n_clips"],
                                               run.model["hidden_size"]), "int8")


def describe(run):
    return [f"kernels matched: {run.trace.kernel_names(PATTERNS)}"] if run.trace else []
