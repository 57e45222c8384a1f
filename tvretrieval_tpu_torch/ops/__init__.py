"""Masking, span selection and the kernel wrappers (the port of the JAX
package's ``ops``). Importing builds no kernel: a wrapper builds its CUDA
library on its first launch (``ops._build``)."""
from tvretrieval_tpu_torch.ops.masking import mask_logits
from tvretrieval_tpu_torch.ops.span import (
    min_max_length_mask,
    top_spans_from_probs,
    flat_topk_spans,
)

__all__ = [
    "mask_logits",
    "min_max_length_mask",
    "top_spans_from_probs",
    "flat_topk_spans",
]
