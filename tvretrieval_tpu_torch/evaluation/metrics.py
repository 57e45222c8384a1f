"""Standalone VCMR / SVMR / VR retrieval metrics.

Reproduces the metric semantics of the reference evaluator
(``standalone_eval/eval.py``), re-implemented here as a fully vectorized
numpy pipeline (the reference loops per query at eval.py:141-177; we build
the full (n_desc, n_pred) correctness tensors in one shot).

Submission schema (reference standalone_eval/README.md:22-88):

.. code-block:: python

    submission = {
        "video2idx": {vid_name: vid_idx, ...},
        "VCMR": [{"desc_id": int, "desc": str,
                  "predictions": [[vid_idx, st, ed, score], ...]}, ...],
        "SVMR": ...,  # same shape, vid_idx fixed to the GT video
        "VR":   ...,  # same shape, st/ed ignored
    }

Ground truth rows (jsonl): {"desc_id", "desc", "type" in {v,t,vt},
"vid_name", "ts": [st, ed] (or >=4 ts pairs for DiDeMo)}.

A prediction is correct iff (1) its vid_idx matches the GT video and
(2) temporal IoU with the GT span >= threshold (eval.py:83-96). Recall@K
counts queries with >=1 correct prediction in the top-K. SVMR ranks only
among predictions whose video matches the GT video (eval.py:209-218); VR
uses the video match alone (eval.py:233-237).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

TASK_TYPES = ("VCMR", "SVMR", "VR")
DESC_TYPES = ("v", "t", "vt")

_IOU_THDS = (0.5, 0.7)
_RECALL_TOPKS = (1, 5, 10, 100)


def temporal_iou(pred_spans: np.ndarray, gt_span: np.ndarray) -> np.ndarray:
    """Batched 1-D temporal IoU of ``pred_spans`` (..., 2) against ``gt_span`` (2,).

    Uses the same (simplified) union as the reference
    (standalone_eval/eval.py:54-69): union = max(ends) - min(starts); a zero
    union yields IoU 0.
    """
    pred_spans = np.asarray(pred_spans, dtype=np.float32)
    gt_span = np.asarray(gt_span, dtype=np.float32)
    inter = np.maximum(
        0.0, np.minimum(pred_spans[..., 1], gt_span[1]) - np.maximum(pred_spans[..., 0], gt_span[0])
    )
    union = np.maximum(pred_spans[..., 1], gt_span[1]) - np.minimum(pred_spans[..., 0], gt_span[0])
    return np.divide(inter, union, out=np.zeros_like(inter), where=union != 0)


def _round_pct(x: float, n: int = 2) -> float:
    return round(float(x) * 100, n)


def _stack_predictions(
    predictions_by_desc_id: Dict[int, dict],
    gt_rows: List[dict],
    video2idx: Dict[str, int],
    max_pred: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Build fixed-shape prediction tensors over all queries.

    Returns:
        spans: (n_desc, max_pred, 2) float32 [st, ed]
        vid_match: (n_desc, max_pred) bool — prediction video == GT video
        valid: (n_desc, max_pred) bool — slot holds a real prediction
    """
    n_desc = len(gt_rows)
    spans = np.zeros((n_desc, max_pred, 2), dtype=np.float32)
    vid_match = np.zeros((n_desc, max_pred), dtype=bool)
    valid = np.zeros((n_desc, max_pred), dtype=bool)
    for qi, gt in enumerate(gt_rows):
        preds = predictions_by_desc_id[gt["desc_id"]]["predictions"][:max_pred]
        n = len(preds)
        if n == 0:
            continue
        arr = np.asarray([p[:3] for p in preds], dtype=np.float32)  # (n, 3)
        spans[qi, :n] = arr[:, 1:3]
        vid_match[qi, :n] = arr[:, 0] == video2idx[gt["vid_name"]]
        valid[qi, :n] = True
    return spans, vid_match, valid


def _iou_correct_matrix(
    spans: np.ndarray,
    vid_match: np.ndarray,
    gt_rows: List[dict],
    iou_thds: Sequence[float],
) -> np.ndarray:
    """(n_thd, n_desc, n_pred) bool: IoU >= thd AND video matched.

    Handles the DiDeMo multi-annotation convention: when a GT row carries
    >= 4 timestamp pairs, a prediction must overlap at least 2 of them
    (reference eval.py:154-165).
    """
    n_desc, n_pred = vid_match.shape
    out = np.zeros((len(iou_thds), n_desc, n_pred), dtype=bool)
    for qi, gt in enumerate(gt_rows):
        ts = gt["ts"]
        if len(ts) >= 4:
            # DiDeMo: list of [st, ed]; need overlap with >= 2 annotations.
            counts = {ti: np.zeros(n_pred, dtype=np.int32) for ti in range(len(iou_thds))}
            for single_ts in ts:
                ious = temporal_iou(spans[qi], np.asarray(single_ts)) * vid_match[qi]
                for ti, thd in enumerate(iou_thds):
                    counts[ti] += (ious >= thd).astype(np.int32)
            for ti in range(len(iou_thds)):
                out[ti, qi] = counts[ti] >= 2
        else:
            ious = temporal_iou(spans[qi], np.asarray(ts)) * vid_match[qi]
            for ti, thd in enumerate(iou_thds):
                out[ti, qi] = ious >= thd
    return out


def _recall_at_k(hits_sorted: np.ndarray, k: int) -> np.ndarray:
    """hits_sorted: (n_desc, n_pred) bool in rank order -> (n_desc,) bool hit@k."""
    return hits_sorted[:, :k].any(axis=1)


def _svmr_rank_restricted(hits: np.ndarray, vid_match: np.ndarray, k: int) -> np.ndarray:
    """Hit@k counting rank only over video-matched predictions.

    Equivalent to the reference's ``iou_corrects[idx][vid_name_matched[idx]][:k]``
    (eval.py:216-218), vectorized: a prediction is in the top-k *matched* slots
    iff its 1-based rank among matched predictions is <= k.
    """
    rank_among_matched = np.cumsum(vid_match, axis=1)  # 1-based at matched slots
    in_topk = vid_match & (rank_among_matched <= k)
    return (hits & in_topk).any(axis=1)


def eval_by_task_type(
    moment_predictions: List[dict],
    video2idx: Dict[str, int],
    ground_truth: List[dict],
    iou_thds: Sequence[float] = _IOU_THDS,
    recall_topks: Sequence[int] = _RECALL_TOPKS,
    task_type: str = "SVMR",
    max_pred_per_query: int = 100,
    match_number: bool = True,
    use_desc_type: bool = True,
) -> Tuple[OrderedDict, OrderedDict]:
    """Metrics for one task. Mirrors reference eval.py:83-252 outputs."""
    assert task_type in TASK_TYPES, f"task_type must be one of {TASK_TYPES}"
    preds_by_id = {e["desc_id"]: e for e in moment_predictions}
    if match_number:
        gt_ids = {e["desc_id"] for e in ground_truth}
        assert gt_ids == set(preds_by_id.keys()), \
            "desc_ids in predictions and ground_truth must match"
        gt_rows = list(ground_truth)
    else:
        gt_rows = [e for e in ground_truth if e["desc_id"] in preds_by_id]

    spans, vid_match, _valid = _stack_predictions(preds_by_id, gt_rows, video2idx, max_pred_per_query)
    desc_types = np.asarray(
        [DESC_TYPES.index(e.get("type", "v")) for e in gt_rows], dtype=np.int32
    )

    metrics: OrderedDict = OrderedDict()
    metrics_by_type: OrderedDict = OrderedDict()

    if task_type in ("VCMR", "SVMR"):
        iou_correct = _iou_correct_matrix(spans, vid_match, gt_rows, iou_thds)
        hits: dict = {}  # (ti, k) -> per-query hit vector, reused by-type
        for ti, thd in enumerate(iou_thds):
            for k in recall_topks:
                if task_type == "VCMR":
                    hit = _recall_at_k(iou_correct[ti], k)
                else:
                    hit = _svmr_rank_restricted(iou_correct[ti], vid_match, k)
                hits[ti, k] = hit
                metrics[f"{thd}-r{k}"] = _round_pct(hit.mean())
        if use_desc_type:
            for dt_idx, dt in enumerate(DESC_TYPES):
                sel = desc_types == dt_idx
                n_in_type = max(int(sel.sum()), 1)
                for ti, thd in enumerate(iou_thds):
                    for k in recall_topks:
                        metrics_by_type[f"{dt}-{thd}-r{k}"] = _round_pct(
                            float((hits[ti, k] & sel).sum()) / n_in_type
                        )
    elif task_type == "VR":
        vr_hits = {k: _recall_at_k(vid_match, k) for k in recall_topks}
        for k in recall_topks:
            metrics[f"r{k}"] = _round_pct(vr_hits[k].mean())
        if use_desc_type:
            for dt_idx, dt in enumerate(DESC_TYPES):
                sel = desc_types == dt_idx
                n_in_type = max(int(sel.sum()), 1)
                for k in recall_topks:
                    metrics_by_type[f"{dt}-r{k}"] = _round_pct(
                        float((vr_hits[k] & sel).sum()) / n_in_type)

    if use_desc_type:
        n = max(len(desc_types), 1)
        ratios = [_round_pct(float((desc_types == i).sum()) / n) for i in range(len(DESC_TYPES))]
        metrics_by_type["desc_type_ratio"] = "v {} t {} vt {}".format(*ratios)
    return metrics, metrics_by_type


def eval_retrieval(
    submission: dict,
    ground_truth: List[dict],
    iou_thds: Sequence[float] = _IOU_THDS,
    match_number: bool = True,
    use_desc_type: bool = True,
    verbose: bool = False,
) -> OrderedDict:
    """Evaluate all tasks present in ``submission``; reference eval.py:255-276."""
    video2idx = submission["video2idx"]
    task_types = [t for t in TASK_TYPES if t in submission]
    results: OrderedDict = OrderedDict()
    by_type: OrderedDict = OrderedDict()
    for task in task_types:
        m, mbt = eval_by_task_type(
            submission[task], video2idx, ground_truth,
            iou_thds=iou_thds, recall_topks=_RECALL_TOPKS, task_type=task,
            max_pred_per_query=100, match_number=match_number,
            use_desc_type=use_desc_type,
        )
        results[task] = m
        by_type[task + "_by_type"] = mbt
    if use_desc_type:
        results.update(by_type)
    return results


def eval_retrieval_arrays(
    gt_rows: List[dict],
    video2idx: Dict[str, int],
    vcmr: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    svmr: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    vr: Optional[np.ndarray] = None,
    iou_thds: Sequence[float] = _IOU_THDS,
    recall_topks: Sequence[int] = _RECALL_TOPKS,
    max_pred_per_query: int = 100,
    use_desc_type: bool = True,
) -> OrderedDict:
    """Array-path evaluator: same metrics as eval_retrieval without building
    per-query prediction dicts (the in-training eval hot path).

    Args:
        gt_rows: ground-truth rows ALIGNED with the array rows (row i of each
            array holds query gt_rows[i]'s ranked predictions).
        vcmr / svmr: (vid_idx (N, K) int, spans (N, K, 2) float seconds).
        vr: vid_idx (N, K) int.

    Exactness vs the dict path is pinned by a test comparing both on the
    same predictions. Multi-annotation (DiDeMo) rows are not supported here
    — use the dict path for those.
    """
    gt_vid = np.asarray([video2idx[r["vid_name"]] for r in gt_rows])
    gt_spans = np.asarray([r["ts"] for r in gt_rows], dtype=np.float32)
    desc_types = np.asarray(
        [DESC_TYPES.index(r.get("type", "v")) for r in gt_rows], dtype=np.int32)

    def iou_matrix(spans):
        st, ed = spans[..., 0], spans[..., 1]
        g_st, g_ed = gt_spans[:, None, 0], gt_spans[:, None, 1]
        inter = np.maximum(0.0, np.minimum(ed, g_ed) - np.maximum(st, g_st))
        union = np.maximum(ed, g_ed) - np.minimum(st, g_st)
        return np.divide(inter, union, out=np.zeros_like(inter), where=union != 0)

    results: OrderedDict = OrderedDict()
    by_type: OrderedDict = OrderedDict()

    def type_breakdown(prefix_fn):
        out = OrderedDict()
        for dt_idx, dt in enumerate(DESC_TYPES):
            sel = desc_types == dt_idx
            n_in_type = max(int(sel.sum()), 1)
            for key, hit in prefix_fn():
                out[f"{dt}-{key}"] = _round_pct(float((hit & sel).sum()) / n_in_type)
        n = max(len(desc_types), 1)
        ratios = [_round_pct(float((desc_types == i).sum()) / n)
                  for i in range(len(DESC_TYPES))]
        out["desc_type_ratio"] = "v {} t {} vt {}".format(*ratios)
        return out

    for task, data in (("VCMR", vcmr), ("SVMR", svmr)):
        if data is None:
            continue
        vid_idx, spans = data
        vid_idx = np.asarray(vid_idx)[:, :max_pred_per_query]
        spans = np.asarray(spans)[:, :max_pred_per_query]
        match = vid_idx == gt_vid[:, None]
        iou = iou_matrix(spans) * match
        metrics = OrderedDict()
        hits = []
        for thd in iou_thds:
            correct = iou >= thd
            for k in recall_topks:
                if task == "VCMR":
                    hit = _recall_at_k(correct, k)
                else:
                    hit = _svmr_rank_restricted(correct, match, k)
                metrics[f"{thd}-r{k}"] = _round_pct(hit.mean())
                hits.append((f"{thd}-r{k}", hit))
        results[task] = metrics
        if use_desc_type:
            by_type[task + "_by_type"] = type_breakdown(lambda h=hits: h)

    if vr is not None:
        vid_idx = np.asarray(vr)[:, :max_pred_per_query]
        match = vid_idx == gt_vid[:, None]
        metrics = OrderedDict()
        hits = []
        for k in recall_topks:
            hit = _recall_at_k(match, k)
            metrics[f"r{k}"] = _round_pct(hit.mean())
            hits.append((f"r{k}", hit))
        results["VR"] = metrics
        if use_desc_type:
            by_type["VR_by_type"] = type_breakdown(lambda h=hits: h)

    if use_desc_type:
        results.update(by_type)
    return results


def eval_main(argv: Optional[List[str]] = None) -> OrderedDict:
    """CLI mirroring reference eval.py:279-296."""
    import argparse
    import json as _json

    from tvretrieval_tpu_torch.utils.io import load_json, load_jsonl, save_json

    parser = argparse.ArgumentParser(description="TVR retrieval evaluation")
    parser.add_argument("--submission_path", type=str, required=True)
    parser.add_argument("--gt_path", type=str, required=True)
    parser.add_argument("--save_path", type=str, required=True)
    parser.add_argument("--not_verbose", action="store_true")
    args = parser.parse_args(argv)

    submission = load_json(args.submission_path)
    gt = load_jsonl(args.gt_path)
    results = eval_retrieval(submission, gt, iou_thds=(0.5, 0.7), verbose=not args.not_verbose)
    if not args.not_verbose:
        print(_json.dumps(results, indent=4))
    save_json(results, args.save_path, pretty=True)
    return results


if __name__ == "__main__":
    eval_main()
