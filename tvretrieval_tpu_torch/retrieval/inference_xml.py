"""Standalone XML inference CLI, PyTorch / CUDA.

Port of tvretrieval_tpu/retrieval/inference_xml.py (reference:
baselines/crossmodal_moment_localization/inference.py ``start_inference``
(:553) + TestOptions (config.py:264)): reload the run's saved opt.json,
override only eval-specific flags, rebuild the model from the checkpoint's
embedded config, run corpus VCMR / SVMR / VR inference and the evaluator
(+ optional NMS).

It reads the run directories that ``training.train_xml`` of this package
writes (``torch.save`` checkpoints). A run directory of the JAX package
holds an orbax checkpoint, which only JAX can read: convert its parameters
with ``convert.flax_params_to_state_dict`` in a program that has JAX, and
save them with ``training.checkpoint.save_checkpoint``.

Usage:
    python -m tvretrieval_tpu_torch.retrieval.inference_xml \\
        --model_dir /tmp/results/tvr-demo --tasks VCMR SVMR VR --nms_thd 0.5

``--streaming einsum|flat|flat_int8`` keeps the encoded corpus in host
memory and streams it to the device (retrieval.streaming).

It runs on the CUDA card unless ``--device cpu`` is given, and exits at
once when there is no card.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
from typing import List, Optional

import torch

from tvretrieval_tpu_torch.models.xml import XML, XMLConfig
from tvretrieval_tpu_torch.training.checkpoint import load_checkpoint
from tvretrieval_tpu_torch.training.train_xml import (
    check_args_supported,
    evaluate_retrieval,
    setup_world,
)
from tvretrieval_tpu_torch.utils.io import load_json

logger = logging.getLogger(__name__)

# flags the eval CLI may override; everything else comes from the saved
# opt.json (reference TestOptions whitelist, config.py:198-206)
EVAL_OVERRIDABLE = (
    "nms_thd", "eval_split_name", "eval_path", "eval_query_bsz",
    "eval_context_bsz", "tasks", "max_pred_l", "min_pred_l",
    "max_before_nms", "max_vcmr_video", "external_inference_vr_res_path",
    "span_score_mode", "video_score_mode", "span_topk_mode", "eval_cache_dtype",
    "video_topk_fused", "video_topk_approx", "video_topk_psort",
    "topk_approx_recall", "span_sim_pad_l", "video_chunk_v", "streaming",
    "streaming_block_videos",
)


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="XML corpus inference (PyTorch / CUDA)")
    p.add_argument("--model_dir", type=str, required=True,
                   help="training results dir containing opt.json + ckpt/")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="where inference runs, whatever device the run trained on")
    p.add_argument("--tasks", type=str, nargs="+", default=["VCMR", "SVMR", "VR"])
    p.add_argument("--eval_split_name", type=str, default=None)
    p.add_argument("--eval_path", type=str, default=None)
    p.add_argument("--span_score_mode", type=str, default=None,
                   choices=["gather", "simsweep", "simsweep_cat",
                            "simsweep_cat_bf16", "simsweep_cat_int8",
                            "simsweep_cat_int8_flat"])
    p.add_argument("--video_score_mode", type=str, default=None,
                   choices=["einsum", "pallas", "pallas_int8"])
    p.add_argument("--span_topk_mode", type=str, default=None,
                   choices=["grouped", "grouped_shift", "grouped_shift8",
                            "grouped_shift_approx", "grouped_shift_psort"])
    p.add_argument("--video_topk_fused", type=int, default=None,
                   help="1: fused video-score -> top-k (block maxima emitted "
                        "by the flat kernel; pre-exp semantics)")
    p.add_argument("--video_topk_approx", type=int, default=None,
                   help="1: video top-V by the approximate top-k on the pre-exp "
                        "scores, at --topk_approx_recall (not a parity mode)")
    p.add_argument("--video_topk_psort", type=int, default=None,
                   help="1: video top-V through the sorting kernel (a parity "
                        "mode, equal to the default selection)")
    p.add_argument("--topk_approx_recall", type=float, default=None,
                   help="recall target for every approximate top-k site")
    p.add_argument("--span_sim_pad_l", type=int, default=None,
                   help="pad the cat cache's clip axis to this length (parity "
                        "mode, simsweep_cat/_bf16 only)")
    p.add_argument("--video_chunk_v", type=int, default=None,
                   help="flat-cache video padding multiple and upper bound on "
                        "the videos per block maximum of the fused top-k")
    p.add_argument("--eval_cache_dtype", type=str, default=None,
                   choices=["float32", "bfloat16"])
    p.add_argument("--eval_query_bsz", type=int, default=None)
    p.add_argument("--eval_context_bsz", type=int, default=None)
    p.add_argument("--nms_thd", type=float, default=None)
    p.add_argument("--min_pred_l", type=int, default=None)
    p.add_argument("--max_pred_l", type=int, default=None)
    p.add_argument("--max_before_nms", type=int, default=None)
    p.add_argument("--max_vcmr_video", type=int, default=None)
    p.add_argument("--external_inference_vr_res_path", type=str, default=None,
                   help="VR submission JSON replacing internal video ranking")
    p.add_argument("--streaming", type=str, default=None,
                   choices=["off", "einsum", "flat", "flat_int8"],
                   help="score through the streaming engine (the corpus in "
                        "host memory, feat1 blocks copied to the device): einsum "
                        "blocks, flat blocks (B2), or int8 flat blocks (B1: half "
                        "the host memory and copy)")
    p.add_argument("--streaming_block_videos", type=int, default=None,
                   help="videos per streamed block (default 2048)")
    p.add_argument("--eval_id", type=str, default="standalone")
    return p


def start_inference(argv: Optional[List[str]] = None) -> dict:
    logging.basicConfig(format="%(asctime)s:%(levelname)s:%(name)s - %(message)s",
                        level=logging.INFO, force=True)
    cli = build_arg_parser().parse_args(argv)

    saved = load_json(os.path.join(cli.model_dir, "opt.json"))
    # TestOptions semantics: saved training opts + eval-only overrides
    for k in EVAL_OVERRIDABLE:
        v = getattr(cli, k, None)
        if v is not None:
            saved[k] = v
    saved["device"] = cli.device     # this call's, never the training run's
    args = argparse.Namespace(**saved)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("inference_xml: no CUDA device is available; pass --device cpu "
                         "to run on the CPU")
    check_args_supported(args)

    _, eval_rows, builder, corpus = setup_world(args)
    params, _, cfg_dict, epoch = load_checkpoint(os.path.join(cli.model_dir, "ckpt"),
                                                 map_location=args.device)
    if cfg_dict.get("stack_conv_predictor_conv_kernel_sizes") is not None:   # a JSON list
        cfg_dict["stack_conv_predictor_conv_kernel_sizes"] = tuple(
            cfg_dict["stack_conv_predictor_conv_kernel_sizes"])
    model = XML(XMLConfig(**cfg_dict)).to(args.device)
    model.load_state_dict(params, strict=True)
    model.eval()
    logger.info("loaded checkpoint from epoch %d; %d eval queries, %d videos",
                epoch, len(eval_rows), len(corpus))

    tag = f"inference_{args.dset_name}_{args.eval_split_name}_{cli.eval_id}"
    metrics, metrics_nms, paths = evaluate_retrieval(
        model, builder, corpus, eval_rows, args, tasks=tuple(cli.tasks),
        results_dir=cli.model_dir, tag=tag, apply_nms=args.nms_thd != -1)
    if metrics is None:
        logger.info("no ground truth for split %s: wrote submission only (%s)",
                    args.eval_split_name, paths[0])
        return {"metrics": None, "metrics_nms": None, "files": paths}
    logger.info("metrics: %s", json.dumps(
        {t: metrics[t] for t in cli.tasks if t in metrics}, indent=2))
    if metrics_nms:
        logger.info("metrics (nms): %s", json.dumps(
            {t: metrics_nms[t] for t in cli.tasks if t in metrics_nms}, indent=2))
    return {"metrics": metrics, "metrics_nms": metrics_nms, "files": paths}


if __name__ == "__main__":
    start_inference()
