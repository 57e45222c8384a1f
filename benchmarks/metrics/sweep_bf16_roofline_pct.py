"""sweep_bf16_roofline_pct (%), layer "span sweep:
models/xml.py::merged_st_ed_scores_simgather_cat (cuBLAS bf16)": the bf16
GEMM kernels of the corpus-wide span sweep against their bound at logical
shapes: Nq x (Nv x L rows) x 2D multiply-adds in bf16; the bf16 feat2 rows
and queries read, the (Nq, Nv, L) bf16 similarity written once (no clip
padding).

The cells' other GEMMs run in f32 (the encoder, TF32 off), so the sweep's
kernels are told apart by name: cuBLAS 12.8 on the H100 runs it as
``nvjet_tst_*`` kernels (bf16 in and out; ``nvjet_tst_256x144_64x4_2x1_v_bz_coopA_TNT``
at 1,000 queries, ``nvjet_tst_512x56_64x2_2x1_v_bz_coopA_TNT`` with
``nvjet_tst_384x56_64x3_2x1_v_bz_TNT`` at 50), the f32 GEMMs as
``sm80_xmma_gemm_f32f32_*`` and ``cutlass_80_simt_sgemm_*``."""
from benchmarks.peaks import roofline_pct

PATTERNS = ("nvjet_tst",)
GEMM = ("gemm", "nvjet", "xmma", "cutlass", "cublas")


def counts(nq, nv, L, d):
    """(operations, bytes) of one call; d is the hidden size, the rows 2d."""
    rows, k = nv * L, 2 * d
    return 2.0 * nq * rows * k, 2.0 * rows * k + 2.0 * nq * k + 2.0 * nq * rows


def read(run):
    return roofline_pct(run, PATTERNS, *counts(run.nq, run.corpus["n_videos"],
                                               run.corpus["n_clips"],
                                               run.model["hidden_size"]), "bf16")


def describe(run):
    if run.trace is None:
        return []
    return [f"kernels matched: {run.trace.kernel_names(PATTERNS)}",
            f"GEMM-like device operations: {run.trace.kernel_names(GEMM)}"]
