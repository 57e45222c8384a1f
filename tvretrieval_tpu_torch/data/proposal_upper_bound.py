"""Oracle recall of a proposal scheme against ground truth.

Capability parity with reference clip_alignment_with_language/local_utils/
compute_proposal_upper_bound.py: for each annotated moment, check whether
any generated proposal overlaps it at IoU >= threshold — an upper bound on
what any proposal-based model (CAL/MCN) can achieve — plus proposal-count
statistics. The port's own copy of the JAX package's
``data/proposal_upper_bound.py``; numpy only.

CLI:
    python -m tvretrieval_tpu_torch.data.proposal_upper_bound \
        --dset_name tvr --eval_path data/tvr_val_release.jsonl
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from tvretrieval_tpu_torch.data.proposals import get_proposal_interface
from tvretrieval_tpu_torch.evaluation.metrics import temporal_iou
from tvretrieval_tpu_torch.utils.io import load_jsonl


def proposal_upper_bound(annotations: List[dict], dset_name: str = "tvr",
                         iou_thds: Sequence[float] = (0.5, 0.7)) -> Dict[str, float]:
    proposer = get_proposal_interface(dset_name)
    cache: Dict[float, np.ndarray] = {}
    hits = {thd: 0 for thd in iou_thds}
    n_props = []
    for row in annotations:
        dur = row["duration"]
        if dur not in cache:
            cache[dur] = proposer(dur)
        props = cache[dur]
        n_props.append(len(props))
        ious = temporal_iou(props, np.asarray(row["ts"], np.float32))
        for thd in iou_thds:
            hits[thd] += bool((ious >= thd).any())
    n = max(len(annotations), 1)
    out = {f"upper_bound_recall_iou{thd}": round(100.0 * hits[thd] / n, 2)
           for thd in iou_thds}
    out["avg_n_proposals"] = float(np.mean(n_props)) if n_props else 0.0
    out["max_n_proposals"] = float(np.max(n_props)) if n_props else 0.0
    return out


def main(argv=None):
    import argparse
    import json

    parser = argparse.ArgumentParser(description="proposal oracle recall")
    parser.add_argument("--dset_name", type=str, default="tvr")
    parser.add_argument("--eval_path", type=str, required=True)
    args = parser.parse_args(argv)
    res = proposal_upper_bound(load_jsonl(args.eval_path), args.dset_name)
    print(json.dumps(res, indent=2))
    return res


if __name__ == "__main__":
    main()
