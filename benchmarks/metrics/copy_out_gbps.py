"""copy_out_gbps (GB/s), layer "engine: _score_query_batch on the host":
the bytes of ``_score_query_batch``'s outputs a call, the counter
``out_bytes`` on the port's root span "score_query_batch"
(``tvretrieval_tpu_torch/utils/trace.py``), over the device time a call of
the device-to-host copies ("Memcpy DtoH"): those of the traced window over
the harness's spans "copy_out" in it, one a call, in which the harness
copies every output to the host (nine pageable copies)
(``benchmarks/spans.py``). The copies' own time, without the wait for the
call's kernels that the first copy's host call holds. None where the
program records no such counter or no such copy ran."""
from benchmarks import spans


def read(run):
    out_bytes, copy_ms = spans.counter(run, "out_bytes"), spans.copy_ms(run)
    if out_bytes is None or not copy_ms:
        return None
    return out_bytes / (copy_ms * 1e6)


def describe(run):
    out_bytes, copy_ms = spans.counter(run, "out_bytes"), spans.copy_ms(run)
    if out_bytes is None or copy_ms is None:
        return []
    astray, total = spans.copies_astray(run)
    return [f"{out_bytes:.1f} bytes a call; device-to-host copies {copy_ms:.6f} ms a call",
            f"copies outside the host's copy_out spans (clocks apart): {astray} of {total}"]
