"""Early-stop bookkeeping shared by the training CLIs.

Mirrors the reference's best-metric gating + patience counter
(train.py:211-236): any strict improvement of the stop metric marks a new
best (checkpoint + best-metrics snapshot); ``max_es_cnt`` epochs without
improvement stop training.

Adds ``min_delta`` on top: the patience counter resets only when the
improvement exceeds it. With 10K+ eval queries the stop metric moves in
~0.01 recall quanta, and under the reference rule those noise-level
upticks reset patience indefinitely once the model has plateaued (observed
on the 21.8K-video TVR-scale synthetic run). ``min_delta=0`` (default) is
exactly the reference behavior.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class EarlyStopper:
    max_es_cnt: int = 10       # -1 disables stopping
    min_delta: float = 0.0

    best: float = float("-inf")
    es_cnt: int = 0

    def update(self, stop_score: float) -> tuple[bool, bool]:
        """Returns (is_new_best, should_stop)."""
        material = stop_score > self.best + self.min_delta
        is_best = stop_score > self.best
        if is_best:
            self.best = stop_score
        if material:
            self.es_cnt = 0
        else:
            self.es_cnt += 1
        should_stop = self.max_es_cnt != -1 and self.es_cnt > self.max_es_cnt
        return is_best, should_stop
