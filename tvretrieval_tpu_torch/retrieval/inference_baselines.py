"""Standalone inference CLI for the baseline models, PyTorch / CUDA.

Port of tvretrieval_tpu/retrieval/inference_baselines.py, mirroring each
reference baseline's ``start_inference`` (mixture_embedding_experts/
inference.py, clip_alignment_with_language/inference.py:631,
excl/inference.py + inference_with_vcmr.py): reload the run's opt.json,
rebuild the model from its checkpoint, run the corpus engine and the
evaluator, and with ``--nms_thd`` the port's NMS (evaluation.nms, native
path when built). It reads the run directories that this package's
``train_mee`` / ``train_cal`` / ``train_excl`` write; MEE's BatchNorm
running statistics come back with its ``state_dict``. The JAX CLI's flags
plus ``--device {cuda,cpu}`` (default ``cuda``; without a card it exits at
once).

Usage:
    python -m tvretrieval_tpu_torch.retrieval.inference_baselines \\
        --model_type mee --model_dir results/tvr-mee-demo
    python -m tvretrieval_tpu_torch.retrieval.inference_baselines \\
        --model_type cal --model_dir results/tvr-cal-demo --nms_thd 0.5
    python -m tvretrieval_tpu_torch.retrieval.inference_baselines \\
        --model_type excl --model_dir results/tvr-excl-demo \\
        [--external_inference_vr_res_path vr.json]
"""
from __future__ import annotations

import argparse
import json
import logging
import os
from typing import List, Optional

from tvretrieval_tpu_torch.evaluation.metrics import eval_retrieval
from tvretrieval_tpu_torch.evaluation.nms import POST_PROCESSING_NMS_FUNC
from tvretrieval_tpu_torch.evaluation.submission import submission_top_n
from tvretrieval_tpu_torch.models.cal import CALConfig, CALWithSub
from tvretrieval_tpu_torch.models.excl import ExCL, ExCLConfig
from tvretrieval_tpu_torch.models.mee import MEE, MEEConfig
from tvretrieval_tpu_torch.retrieval.excl_engine import (
    excl_retrieve_svmr,
    excl_retrieve_vcmr_with_external_vr,
)
from tvretrieval_tpu_torch.retrieval.proposal_engine import (
    cal_retrieve,
    encode_proposal_corpus,
    load_proposal_cache,
    save_proposal_cache,
)
from tvretrieval_tpu_torch.retrieval.vr_engine import mee_retrieve_vr
from tvretrieval_tpu_torch.training import train_cal, train_excl, train_mee
from tvretrieval_tpu_torch.training.checkpoint import load_checkpoint
from tvretrieval_tpu_torch.training.generic import require_device
from tvretrieval_tpu_torch.utils.io import load_json, save_json

logger = logging.getLogger(__name__)

MODELS = {"mee": (MEE, MEEConfig, train_mee), "cal": (CALWithSub, CALConfig, train_cal),
          "mcn": (CALWithSub, CALConfig, train_cal), "excl": (ExCL, ExCLConfig, train_excl)}


def build_arg_parser():
    p = argparse.ArgumentParser(description="baseline corpus inference (PyTorch / CUDA)")
    p.add_argument("--model_type", type=str, required=True,
                   choices=["mee", "cal", "mcn", "excl"])
    p.add_argument("--model_dir", type=str, required=True)
    p.add_argument("--eval_split_name", type=str, default=None)
    p.add_argument("--eval_path", type=str, default=None)
    p.add_argument("--nms_thd", type=float, default=-1.0)
    p.add_argument("--external_inference_vr_res_path", type=str, default=None)
    p.add_argument("--proposal_cache_path", type=str, default=None,
                   help="CAL: load/save the encoded proposal corpus here")
    p.add_argument("--eval_id", type=str, default="standalone")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="where the model runs; the default needs a CUDA card")
    return p


def start_inference(argv: Optional[List[str]] = None) -> dict:
    logging.basicConfig(level=logging.INFO, force=True,
                        format="%(asctime)s:%(levelname)s:%(name)s - %(message)s")
    cli = build_arg_parser().parse_args(argv)
    require_device("inference_baselines", cli.device)
    saved = load_json(os.path.join(cli.model_dir, "opt.json"))
    for k in ("eval_split_name", "eval_path"):
        if getattr(cli, k) is not None:
            saved[k] = getattr(cli, k)
    saved["device"] = cli.device     # this call's, never the training run's
    args = argparse.Namespace(**saved)

    model_cls, cfg_cls, trainer_module = MODELS[cli.model_type]
    params, _, cfg_dict, epoch = load_checkpoint(os.path.join(cli.model_dir, "ckpt"),
                                                 map_location=cli.device)
    model = model_cls(cfg_cls(**cfg_dict)).to(cli.device)
    model.load_state_dict(params, strict=True)
    model.eval()
    logger.info("loaded %s checkpoint from epoch %d", cli.model_type, epoch)
    _, eval_rows, builder, corpus = trainer_module.setup_world(args)

    if cli.model_type == "mee":
        raw = mee_retrieve_vr(model, builder, corpus, eval_rows, ctx_bsz=args.eval_ctx_bsz,
                              query_bsz=args.eval_query_bsz)
    elif cli.model_type in ("cal", "mcn"):
        if cli.proposal_cache_path and os.path.exists(cli.proposal_cache_path):
            cache = load_proposal_cache(cli.proposal_cache_path, device=cli.device)
            logger.info("loaded proposal cache from %s", cli.proposal_cache_path)
        else:
            cache = encode_proposal_corpus(model, builder, corpus, dset_name=args.dset_name)
            if cli.proposal_cache_path:
                save_proposal_cache(cache, cli.proposal_cache_path)
        raw = cal_retrieve(model, builder, cache, corpus, eval_rows, tasks=("VCMR", "SVMR"),
                           query_bsz=args.eval_query_bsz, max_before_nms=args.max_before_nms)
    else:  # excl
        raw = excl_retrieve_svmr(model, builder, corpus, eval_rows,
                                 **train_excl.svmr_kw(args))
        ext = (cli.external_inference_vr_res_path
               or getattr(args, "external_inference_vr_res_path", None))
        if ext:
            raw.update(excl_retrieve_vcmr_with_external_vr(
                model, builder, corpus, eval_rows, ext, **train_excl.vcmr_kw(args)))

    raw["video2idx"] = corpus.video2idx
    submission = submission_top_n(raw, 100)
    tag = f"inference_{args.dset_name}_{args.eval_split_name}_{cli.eval_id}"
    sub_path = os.path.join(cli.model_dir, f"{tag}_predictions.json")
    save_json(submission, sub_path)
    use_desc_type = args.dset_name == "tvr"
    metrics = eval_retrieval(submission, eval_rows, use_desc_type=use_desc_type)
    save_json(metrics, sub_path.replace(".json", "_metrics.json"), pretty=True)
    logger.info("metrics: %s", json.dumps(
        {k: v for k, v in metrics.items() if not k.endswith("by_type")}, indent=2))

    metrics_nms = None
    if cli.nms_thd != -1:
        after = {"video2idx": raw["video2idx"]}
        for task, fn in POST_PROCESSING_NMS_FUNC.items():
            if task in raw:
                after[task] = fn(raw[task], nms_thd=cli.nms_thd)
        nms_path = sub_path.replace(".json", f"_nms_{cli.nms_thd}.json")
        save_json(after, nms_path)
        metrics_nms = eval_retrieval(after, eval_rows, use_desc_type=use_desc_type)
        save_json(metrics_nms, nms_path.replace(".json", "_metrics.json"), pretty=True)
    return {"metrics": metrics, "metrics_nms": metrics_nms, "submission_path": sub_path}


if __name__ == "__main__":
    start_inference()
