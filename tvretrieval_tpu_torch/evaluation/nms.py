"""1-D temporal non-maximum suppression.

Capability parity with reference ``utils/temporal_nms.py:25`` and the NMS
post-processing scripts in ``baselines/clip_alignment_with_language/
inference.py:189-265`` (filter_vcmr_by_nms / post_processing_{vcmr,svmr}_nms).

The reference suppresses with an O(n^2) Python pop-loop; we keep the same
keep-order semantics but run the pairwise IoU suppression vectorized in
numpy per kept element (still worst-case O(n^2) but array-at-a-time).
The port's own copy of the JAX package's ``evaluation/nms.py``; its native
path is the port's copy of the C++ source (csrc/temporal_nms.cpp, built by
native/loader.py with the host compiler).
"""
from __future__ import annotations

from collections import defaultdict
from typing import List, Sequence

import numpy as np


def temporal_nms(
    predictions: Sequence[Sequence[float]],
    nms_threshold: float,
    max_after_nms: int = 100,
    use_native: bool = True,
) -> List[List[float]]:
    """Suppress overlapping spans, keeping highest-score representatives.

    Args:
        predictions: rows of [st, ed, score]; larger score is better.
        nms_threshold: spans with IoU > threshold vs. a kept span are dropped.
        max_after_nms: max rows kept.

    Same semantics as reference temporal_non_maximum_suppression
    (utils/temporal_nms.py:25-74): sort by score descending, greedily keep
    the best remaining span and drop everything overlapping it by more than
    the threshold (strict >).
    """
    if len(predictions) <= 1:
        return [list(p) for p in predictions]

    if use_native:
        from tvretrieval_tpu_torch.native.loader import native_available, temporal_nms_native
        if native_available():
            kept = temporal_nms_native(
                np.asarray(predictions, dtype=np.float32)[:, :3],
                nms_threshold, max_after_nms)
            return [[float(a), float(b), float(c)] for a, b, c in kept]

    arr = np.asarray(predictions, dtype=np.float64)  # (n, 3)
    order = np.argsort(-arr[:, 2], kind="stable")
    arr = arr[order]
    st, ed, score = arr[:, 0], arr[:, 1], arr[:, 2]

    alive = np.ones(len(arr), dtype=bool)
    keep: List[int] = []
    while alive.any() and len(keep) < max_after_nms:
        idx = int(np.argmax(alive))  # first alive = best remaining score
        keep.append(idx)
        alive[idx] = False
        inter = np.maximum(0.0, np.minimum(ed[idx], ed) - np.maximum(st[idx], st))
        union = np.maximum(ed[idx], ed) - np.minimum(st[idx], st)
        iou = np.divide(inter, union, out=np.zeros_like(inter), where=union != 0)
        alive &= iou <= nms_threshold

    return [[float(st[i]), float(ed[i]), float(score[i])] for i in keep]


def _nms_grouped_by_video(
    video_predictions: Sequence[Sequence[float]],
    nms_threshold: float,
    max_before_nms: int,
    max_after_nms: int,
) -> List[List[float]]:
    """Group [vid_idx, st, ed, score] rows by video, NMS within each group,
    then globally re-sort by score (reference inference.py:189-226)."""
    groups = defaultdict(list)
    for pred in list(video_predictions)[:max_before_nms]:
        groups[pred[0]].append(list(pred[1:]))

    merged: List[List[float]] = []
    for vid_idx, rows in groups.items():
        for st, ed, score in temporal_nms(rows, nms_threshold):
            merged.append([vid_idx, st, ed, score])
    merged.sort(key=lambda r: r[3], reverse=True)
    return merged[:max_after_nms]


def apply_nms_to_vcmr(
    vcmr_res: List[dict],
    nms_thd: float = 0.6,
    max_before_nms: int = 1000,
    max_after_nms: int = 100,
) -> List[dict]:
    """Per-video NMS then global re-rank for VCMR prediction dicts."""
    out = []
    for e in vcmr_res:
        e = dict(e)
        e["predictions"] = _nms_grouped_by_video(
            e["predictions"], nms_thd, max_before_nms, max_after_nms)
        out.append(e)
    return out


def apply_nms_to_svmr(
    svmr_res: List[dict],
    nms_thd: float = 0.6,
    max_before_nms: int = 1000,
    max_after_nms: int = 100,
) -> List[dict]:
    """Plain NMS for single-video predictions (video idx constant per query)."""
    out = []
    for e in svmr_res:
        e = dict(e)
        rows = [p[1:] for p in e["predictions"][:max_before_nms]]
        kept = temporal_nms(rows, nms_thd, max_after_nms=max_after_nms)
        vid_idx = e["predictions"][0][0] if e["predictions"] else -1
        e["predictions"] = [[vid_idx, st, ed, score] for st, ed, score in kept]
        out.append(e)
    return out


POST_PROCESSING_NMS_FUNC = {
    "SVMR": apply_nms_to_svmr,
    "VCMR": apply_nms_to_vcmr,
}
