"""cal_query_ms (ms), layer "CAL query encoder": the query LSTM (cuDNN f32,
every padded step), its linear and norm, and the row [q, 1, -|q|^2] built
for the product, in
``tvretrieval_tpu_torch/retrieval/proposal_engine.py::score_cal_batch``.

The device's busy self time a call in the port's span "cal_query"
(``tvretrieval_tpu_torch/utils/trace.py``; every such span of a call
summed): the time between the CUDA events at the span's entry and exit,
less its child spans', less the device's idle gaps while the host was in
the span's own part (``benchmarks/spans.py::busy_ms``), over the traced
window's calls. None where the program records no such span."""
from benchmarks import spans


def read(run):
    return spans.stage_ms(run, "cal_query")
