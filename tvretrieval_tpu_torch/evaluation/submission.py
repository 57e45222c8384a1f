"""Prediction-set containers and submission JSON helpers.

The submission contract matches reference standalone_eval/README.md:22-88 and
``get_submission_top_n`` (clip_alignment_with_language/inference.py:503-516).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional


@dataclass
class PredictionSet:
    """In-memory submission: video2idx + per-task ranked prediction lists."""

    video2idx: Dict[str, int]
    vcmr: Optional[List[dict]] = None
    svmr: Optional[List[dict]] = None
    vr: Optional[List[dict]] = None

    def to_submission(self) -> dict:
        sub: dict = {"video2idx": self.video2idx}
        if self.vcmr:
            sub["VCMR"] = self.vcmr
        if self.svmr:
            sub["SVMR"] = self.svmr
        if self.vr:
            sub["VR"] = self.vr
        return sub


def submission_top_n(submission: dict, top_n: int = 100) -> dict:
    """Truncate each query's ranked predictions to ``top_n`` rows."""
    out = {"video2idx": submission["video2idx"]}
    for task, entries in submission.items():
        if task == "video2idx":
            continue
        out[task] = [
            {**e, "predictions": e["predictions"][:top_n]} for e in entries
        ]
    return out
