"""Masking primitives shared across models (port of tvretrieval_tpu/ops/masking.py)."""
from __future__ import annotations

import torch

NEG_INF = -1e10


def mask_logits(target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``target * mask + (1 - mask) * -1e10``; mask is float {0, 1}, so
    masked positions become -1e10 and downstream max / softmax ignore them
    (reference model_xml.py:640-641)."""
    return target * mask + (1.0 - mask) * NEG_INF
