"""excl_head_ms (ms), layer "ExCL span heads": the start / end heads over
[ctx2; ctx1; query], the mask and the streams' mean, in
``tvretrieval_tpu_torch/retrieval/excl_engine.py::excl_vcmr_batch``.

The device's busy self time a call in the port's span "excl_head"
(``tvretrieval_tpu_torch/utils/trace.py``; every such span of a call
summed): the time between the CUDA events at the span's entry and exit,
less its child spans', less the device's idle gaps while the host was in
the span's own part (``benchmarks/spans.py::busy_ms``), over the traced
window's calls. None where the program records no such span."""
from benchmarks import spans


def read(run):
    return spans.stage_ms(run, "excl_head")
