"""The evaluator, temporal NMS and submissions (the port's copies of the
JAX package's ``evaluation``)."""
from tvretrieval_tpu_torch.evaluation.metrics import (
    eval_retrieval,
    temporal_iou,
    TASK_TYPES,
)
from tvretrieval_tpu_torch.evaluation.nms import (
    temporal_nms,
    apply_nms_to_vcmr,
    apply_nms_to_svmr,
)
from tvretrieval_tpu_torch.evaluation.submission import (
    submission_top_n,
    PredictionSet,
)

__all__ = [
    "eval_retrieval",
    "temporal_iou",
    "TASK_TYPES",
    "temporal_nms",
    "apply_nms_to_vcmr",
    "apply_nms_to_svmr",
    "submission_top_n",
    "PredictionSet",
]
