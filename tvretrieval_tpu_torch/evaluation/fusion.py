"""Late-fusion re-ranking of saved prediction files.

Capability parity with reference clip_alignment_with_language/
mix_model_prediction.py: re-rank one model's top-K VCMR predictions by a
second model's (e.g. TEF-variant) ranking — keep the second model's order,
restricted to moments the first model proposed; pad by repetition to
``max_after_nms`` if fewer survive (:48-60). The port's own copy of the
JAX package's ``evaluation/fusion.py``.

CLI:
    python -m tvretrieval_tpu_torch.evaluation.fusion --pred_path a.json \
        --rerank_pred_path b.json --save_path out.json [--gt_path gt.jsonl]
"""
from __future__ import annotations


import numpy as np

from tvretrieval_tpu_torch.utils.io import load_json, load_jsonl, save_json


def mix_predictions(pred_path: str, rerank_pred_path: str, save_path: str,
                    max_after_nms: int = 100) -> dict:
    pred = load_json(pred_path)
    rerank = load_json(rerank_pred_path)
    vcmr = {e["desc_id"]: e for e in pred["VCMR"]}
    rerank_vcmr = {e["desc_id"]: e for e in rerank["VCMR"]}

    out_entries = []
    n_valid = []
    for desc_id, entry in vcmr.items():
        allowed = {tuple(p[:3]) for p in entry["predictions"]}
        reranked = [p for p in rerank_vcmr[desc_id]["predictions"]
                    if tuple(p[:3]) in allowed][:max_after_nms]
        n_valid.append(len(reranked))
        if 0 < len(reranked) < max_after_nms:
            reranked = reranked + reranked[: max_after_nms - len(reranked)]
        out_entries.append({"desc_id": desc_id, "desc": entry.get("desc", ""),
                            "predictions": reranked})
    result = {"VCMR": out_entries, "video2idx": pred["video2idx"]}
    save_json(result, save_path)
    print(f"mean surviving moments per query: {np.mean(n_valid):.1f}")
    return result


def main(argv=None):
    import argparse

    from tvretrieval_tpu_torch.evaluation.metrics import eval_retrieval

    parser = argparse.ArgumentParser(description="late-fusion re-ranking")
    parser.add_argument("--pred_path", type=str, required=True)
    parser.add_argument("--rerank_pred_path", type=str, required=True)
    parser.add_argument("--save_path", type=str, required=True)
    parser.add_argument("--gt_path", type=str, default=None)
    args = parser.parse_args(argv)

    result = mix_predictions(args.pred_path, args.rerank_pred_path, args.save_path)
    if args.gt_path:
        metrics = eval_retrieval(result, load_jsonl(args.gt_path))
        save_json(metrics, args.save_path.replace(".json", "_metrics.json"),
                  pretty=True)
        print(dict(metrics["VCMR"]))
    return result


if __name__ == "__main__":
    main()
