"""cal_topk_ms (ms), layer "CAL selection": each chunk's top moments (block
maxima and B6) and the merge of the chunks' lists, one span a chunk and one
for the merge, summed, in
``tvretrieval_tpu_torch/retrieval/proposal_engine.py::score_cal_batch``.

The device's busy self time a call in the port's span "cal_topk"
(``tvretrieval_tpu_torch/utils/trace.py``; every such span of a call
summed): the time between the CUDA events at the span's entry and exit,
less its child spans', less the device's idle gaps while the host was in
the span's own part (``benchmarks/spans.py::busy_ms``), over the traced
window's calls. None where the program records no such span."""
from benchmarks import spans


def read(run):
    return spans.stage_ms(run, "cal_topk")
