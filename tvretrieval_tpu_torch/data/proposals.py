"""Temporal proposal generation for proposal-based retrieval (CAL/MCN).

Capability parity with reference baselines/clip_alignment_with_language/
local_utils/proposal.py: multi-scale sliding windows with per-scale strides
rounded to multiples of the base length (SlidingWindowMSRSS:64-113), the
DiDeMo fixed 21-segment search space (DidemoICCV17SS:37-61), and the
per-dataset proposal configs (:116-156) — the TVR entry also pins
clip_length=1.5 used repo-wide.

Proposals are host-side numpy (per-duration, cacheable); the model consumes
them as fixed-shape padded (n_proposals, 2) second-spans. The port's own
copy of the JAX package's ``data/proposals.py``; numpy only.
"""
from __future__ import annotations

import itertools
from typing import Dict, Sequence

import numpy as np

PROPOSAL_CONFIGS: Dict[str, dict] = {
    "didemo": {"proposal_interface": "didemo", "clip_length": 2.5},
    "tvr": {
        "length": 3, "scales": [1, 2, 4, 8], "stride": 0.3, "round_base": 1,
        "min_proposal_length": 3, "clip_length": 1.5,
        "proposal_interface": "sliding_window",
    },
    "anet_cap": {
        "length": 5, "scales": list(range(2, 27, 2)), "stride": 0.3,
        "round_base": 1, "min_proposal_length": 10, "clip_length": 5,
        "proposal_interface": "sliding_window",
    },
    "charades_sta": {
        "length": 3, "scales": [2, 3, 4, 5, 6, 7, 8], "stride": 0.3,
        "round_base": 1, "min_proposal_length": 6, "clip_length": 3,
        "proposal_interface": "sliding_window",
    },
}


def didemo_proposals() -> np.ndarray:
    """The fixed 21-window DiDeMo search space (5s base clips)."""
    clip = 5.0
    indices = [(i, i) for i in range(6)]
    indices += list(itertools.combinations(range(6), 2))
    props = np.asarray(indices, dtype=np.float32) * clip
    props[:, 1] += clip
    return props


class SlidingWindowProposer:
    """Multi-scale sliding windows, strides rounded per scale."""

    def __init__(self, length: float, scales: Sequence[int], stride: float = 0.5,
                 round_base: float = 0.5):
        self.length = length
        self.scales = list(scales)
        assert self.scales, "need at least one scale"
        self.strides = [
            max(round(s * stride / round_base) * round_base, round_base) * length
            for s in self.scales]

    def windows(self, t_end: float, t_start: float = 0.0) -> np.ndarray:
        """(N, 2) [st, ed) spans covering [t_start, t_end], deduplicated +
        sorted (np.unique over rows, like the reference :103-107)."""
        spans = []
        for scale, stride in zip(self.scales, self.strides):
            starts = np.arange(t_start, t_end, stride, dtype=np.float32)
            ends = np.minimum(starts + self.length * scale, t_end)
            spans.append(np.stack([starts, ends], axis=1))
        return np.unique(np.concatenate(spans, axis=0), axis=0)

    def __call__(self, duration: float) -> np.ndarray:
        return self.windows(duration)


def get_proposal_interface(dset_name: str):
    cfg = PROPOSAL_CONFIGS[dset_name]
    if cfg["proposal_interface"] == "didemo":
        fixed = didemo_proposals()
        return lambda duration: fixed
    return SlidingWindowProposer(cfg["length"], cfg["scales"],
                                 cfg["stride"], cfg["round_base"])


def pad_proposals(proposals: np.ndarray, max_n: int) -> tuple[np.ndarray, np.ndarray]:
    """Pad/truncate (N, 2) proposals to (max_n, 2) + validity mask."""
    out = np.zeros((max_n, 2), dtype=np.float32)
    mask = np.zeros((max_n,), dtype=np.float32)
    n = min(len(proposals), max_n)
    out[:n] = proposals[:n]
    mask[:n] = 1.0
    return out, mask
