"""cal_dist_ms (ms), layer "CAL distances": the product of the query rows
with every chunk of the resident scoring rows (cuBLAS f32, TF32 off), one
span a chunk, summed, in
``tvretrieval_tpu_torch/retrieval/proposal_engine.py::score_cal_batch``.

The device's busy self time a call in the port's span "cal_dist"
(``tvretrieval_tpu_torch/utils/trace.py``; every such span of a call
summed): the time between the CUDA events at the span's entry and exit,
less its child spans', less the device's idle gaps while the host was in
the span's own part (``benchmarks/spans.py::busy_ms``), over the traced
window's calls. None where the program records no such span."""
from benchmarks import spans


def read(run):
    return spans.stage_ms(run, "cal_dist")
