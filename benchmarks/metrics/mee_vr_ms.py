"""mee_vr_ms (ms), layer "MEE video retrieval": MEE's query side (NetVLAD,
the gated units, the mixture weights), its scores of every cached video and
the exact top N through B6 (``topk_stable_blocked_psort``), in
``tvretrieval_tpu_torch/retrieval/excl_engine.py::score_mee_excl_batch``.

The device's busy self time a call in the port's span "mee_vr"
(``tvretrieval_tpu_torch/utils/trace.py``; every such span of a call
summed): the time between the CUDA events at the span's entry and exit,
less its child spans', less the device's idle gaps while the host was in
the span's own part (``benchmarks/spans.py::busy_ms``), over the traced
window's calls. None where the program records no such span."""
from benchmarks import spans


def read(run):
    return spans.stage_ms(run, "mee_vr")
