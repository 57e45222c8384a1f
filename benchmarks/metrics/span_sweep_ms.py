"""span_sweep_ms (ms), layer "span sweep": the ``merged_st_ed_scores_*``
call of ``retrieval/engine.py::_score_query_batch`` without the span head
inside it: the query linears or quantisation and the corpus-wide similarity
sweep, whatever runs it (cuBLAS, ``_blocked_sweep`` or B5), so that it
follows a new sweep where the kernel-name rooflines do not.

The device's busy self time a call in the port's span "span_sweep"
(``tvretrieval_tpu_torch/utils/trace.py``): the time between the CUDA
events recorded at the span's entry and exit, less its child spans', less
the device's idle gaps while the host was in the span's own part
(``benchmarks/spans.py::busy_ms``), over the traced window's calls: the
device's work in the stage. A short gap between two kernels of a backlog
falls to the span the host is in then, not always to the one the device
runs. None where the program records no such span."""
from benchmarks import spans

# the sweep's kernels in the benchmark's two deployments, for a cross-check
# printed beside the reading; the reading itself follows no name
SWEEP_KERNELS = ("nvjet_tst", "span_sim_wgmma_kernel")


def read(run):
    return spans.stage_ms(run, "span_sweep")


def describe(run):
    ms = read(run)
    if ms is None:
        return []
    sec = run.trace.kernel_s(SWEEP_KERNELS)
    named = ("none ran" if sec is None
             else f"{1e3 * sec / run.n_calls:.6f} ms a call over {run.n_calls} calls")
    return [f"{ms:.6f} ms a call over {spans.n_calls(run)} calls; "
            f"the device operations named {SWEEP_KERNELS}: {named}"]
