"""Host helpers: JSON / pickle IO, normalization, meters (the port's
copies of the JAX package's ``utils``)."""
from tvretrieval_tpu_torch.utils.io import (
    load_json,
    save_json,
    load_jsonl,
    save_jsonl,
    l2_normalize,
    AverageMeter,
    dissect_by_lengths,
)

__all__ = [
    "load_json",
    "save_json",
    "load_jsonl",
    "save_jsonl",
    "l2_normalize",
    "AverageMeter",
    "dissect_by_lengths",
]
