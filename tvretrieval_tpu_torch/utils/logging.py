"""Training observability: TensorBoard scalars + append-only jsonl metrics.

Capability parity with the reference's SummaryWriter usage (train.py:88-90,
196-209, 260) and its text logs (train.log.txt / eval.log.txt), plus a
machine-readable metrics.jsonl stream. TensorBoard is optional — the logger
degrades to jsonl-only when unavailable.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricsLogger:
    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(os.path.join(log_dir, "tensorboard"))
            except Exception:
                self._tb = None

    def scalars(self, tag_prefix: str, values: Dict[str, float], step: int) -> None:
        rec = {"ts": time.time(), "step": step,
               **{f"{tag_prefix}/{k}": float(v) for k, v in values.items()}}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in values.items():
                self._tb.add_scalar(f"{tag_prefix}/{k}", float(v), step)

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
