"""b1_roofline_pct (%), layer "video scores: ops/video_score.py ->
csrc/video_score.cu (B1)": the int8 video-score kernel's device time against
its bound at logical shapes: two streams of Nq x Nv x L x D multiply-adds
in int8; the two int8 caches (Nv x L x D each), the int8 queries read and
the (Nq, Nv) f32 scores written once."""
from benchmarks.peaks import roofline_pct

PATTERNS = ("video_score_wgmma_kernel",)


def counts(nq, nv, L, d):
    """(operations, bytes) of one call."""
    return 4.0 * nq * nv * L * d, 2.0 * nv * L * d + 2.0 * nq * d + 4.0 * nq * nv


def read(run):
    return roofline_pct(run, PATTERNS, *counts(run.nq, run.corpus["n_videos"],
                                               run.corpus["n_clips"],
                                               run.model["hidden_size"]), "int8")


def describe(run):
    return [f"kernels matched: {run.trace.kernel_names(PATTERNS)}"] if run.trace else []
