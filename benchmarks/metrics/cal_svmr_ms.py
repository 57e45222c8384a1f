"""cal_svmr_ms (ms), layer "CAL SVMR": the ground-truth video's proposal
rows gathered, their scores and the stable sort, with the outputs' gathers,
in ``tvretrieval_tpu_torch/retrieval/proposal_engine.py::score_cal_batch``.

The device's busy self time a call in the port's span "cal_svmr"
(``tvretrieval_tpu_torch/utils/trace.py``; every such span of a call
summed): the time between the CUDA events at the span's entry and exit,
less its child spans', less the device's idle gaps while the host was in
the span's own part (``benchmarks/spans.py::busy_ms``), over the traced
window's calls. None where the program records no such span."""
from benchmarks import spans


def read(run):
    return spans.stage_ms(run, "cal_svmr")
