"""Build the {split: {vid_name: [duration, idx]}} corpus index file.
(The port's own copy of the JAX package's features/video_split.py.)

Capability parity with reference utils/mk_video_split_with_duration.py:4-18:
combine per-split annotation files with a duration table into the
``tvr_video2dur_idx.json`` consumed by every eval dataset; indices are
globally unique across splits.
"""
from __future__ import annotations

from typing import Dict, Mapping, Sequence

from tvretrieval_tpu_torch.utils.io import save_json


def build_video_duration_idx(
    split_to_vid_names: Mapping[str, Sequence[str]],
    durations: Mapping[str, float],
    out_path: str = None,
) -> Dict[str, Dict[str, list]]:
    out: Dict[str, Dict[str, list]] = {}
    idx = 0
    for split, names in split_to_vid_names.items():
        table = {}
        for name in names:
            table[name] = [float(durations[name]), idx]
            idx += 1
        out[split] = table
    if out_path:
        save_json(out, out_path)
    return out
