"""encoder_ms (ms), layer "query encoder": ``models/xml.py::encode_query``
inside ``retrieval/engine.py::_score_query_batch``: the query projection,
the self-attention layer and the modular pooling.

The device's busy self time a call in the port's span "encode_query"
(``tvretrieval_tpu_torch/utils/trace.py``): the time between the CUDA
events recorded at the span's entry and exit, less its child spans', less
the device's idle gaps while the host was in the span's own part
(``benchmarks/spans.py::busy_ms``), over the traced window's calls: the
device's work in the stage. A short gap between two kernels of a backlog
falls to the span the host is in then, not always to the one the device
runs. None where the program records no such span."""
from benchmarks import spans


def read(run):
    return spans.stage_ms(run, "encode_query")
