"""ExCL training CLI (SVMR baseline), PyTorch.

Port of tvretrieval_tpu/training/train_excl.py (reference excl/train.py):
Adam (lr 1e-3), CE span loss only, dropout drawn from the trainer's
generator (seeded from ``--seed``), early stop on SVMR, SVMR inference each
epoch, then VCMR through an external VR submission when
``--external_inference_vr_res_path`` is given. Takes the JAX CLI's flags
plus ``--device {cuda,cpu}`` (default ``cuda``; without a card it exits at
once). On ``--device cuda`` it trains on every card that divides
``--bsz``, one rank a card, or joins the group torchrun (or the caller)
made, as train_mee does (training/generic.py; the dropout masks drawn
for the global batch); rank 0 alone evaluates and writes.

    python -m tvretrieval_tpu_torch.training.train_excl --synthetic --device cpu \\
        --exp_id demo --n_epoch 3 --bsz 12 --results_root /tmp/results
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time
from typing import List, Optional

import torch

from tvretrieval_tpu_torch.data.datasets import CorpusIndex, ExampleBuilder, load_annotations
from tvretrieval_tpu_torch.data.features import H5FeatureSource
from tvretrieval_tpu_torch.data.synthetic import make_synthetic_world
from tvretrieval_tpu_torch.evaluation.metrics import eval_retrieval
from tvretrieval_tpu_torch.evaluation.submission import submission_top_n
from tvretrieval_tpu_torch.models.excl import ExCL, ExCLConfig
from tvretrieval_tpu_torch.retrieval.excl_engine import (
    excl_retrieve_svmr,
    excl_retrieve_vcmr_with_external_vr,
)
from tvretrieval_tpu_torch.training import data_parallel as dp
from tvretrieval_tpu_torch.training.checkpoint import save_checkpoint
from tvretrieval_tpu_torch.training.early_stop import EarlyStopper
from tvretrieval_tpu_torch.training.generic import GenericTrainer, require_device
from tvretrieval_tpu_torch.utils.io import save_json
from tvretrieval_tpu_torch.utils.logging import MetricsLogger

logger = logging.getLogger(__name__)


def build_arg_parser():
    p = argparse.ArgumentParser(description="Train ExCL (PyTorch / CUDA)")
    p.add_argument("--dset_name", type=str, default="tvr")
    p.add_argument("--eval_split_name", type=str, default="val")
    p.add_argument("--results_root", type=str, default="results")
    p.add_argument("--exp_id", type=str, default=None)
    p.add_argument("--seed", type=int, default=2018)
    p.add_argument("--data_ratio", type=float, default=1.0,
                   help="train/eval on a fraction of the data (reference config.py:29-32)")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="where the model lives; the default needs a CUDA card")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic_videos", type=int, default=64)
    p.add_argument("--synthetic_queries", type=int, default=256)
    p.add_argument("--train_path", type=str, default=None)
    p.add_argument("--eval_path", type=str, default=None)
    p.add_argument("--desc_bert_path", type=str, default=None)
    p.add_argument("--sub_bert_path", type=str, default=None)
    p.add_argument("--vid_feat_path", type=str, default=None)
    p.add_argument("--video_duration_idx_path", type=str, default=None)
    p.add_argument("--external_inference_vr_res_path", type=str, default=None)
    p.add_argument("--ctx_mode", type=str, default="video_sub")
    p.add_argument("--clip_length", type=float, default=1.5)
    p.add_argument("--max_desc_l", type=int, default=30)
    p.add_argument("--max_ctx_l", type=int, default=100)
    p.add_argument("--hidden_size", type=int, default=256)
    p.add_argument("--drop", type=float, default=0.5)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--n_epoch", type=int, default=100)
    p.add_argument("--bsz", type=int, default=128)
    p.add_argument("--max_es_cnt", type=int, default=10)
    p.add_argument("--es_min_delta", type=float, default=0.0,
                   help="patience resets only when the stop metric improves "
                        "by MORE than this; 0 = reference behavior")
    p.add_argument("--eval_query_bsz", type=int, default=50)
    p.add_argument("--min_pred_l", type=int, default=2)
    p.add_argument("--max_pred_l", type=int, default=16)
    p.add_argument("--q2c_alpha", type=float, default=20.0)
    return p


def setup_world(args):
    if args.synthetic:
        world = make_synthetic_world(n_videos=args.synthetic_videos,
                                     n_queries=args.synthetic_queries,
                                     clip_length=args.clip_length, seed=args.seed)
        n_train = int(len(world.annotations) * 0.75)
        builder = ExampleBuilder(
            query_source=world.query_source,
            video_source=world.video_source if "video" in args.ctx_mode else None,
            sub_source=world.sub_source if "sub" in args.ctx_mode else None,
            ctx_mode=args.ctx_mode, max_desc_l=args.max_desc_l,
            max_ctx_l=args.max_ctx_l, clip_length=args.clip_length)
        return (world.annotations[:n_train], world.annotations[n_train:],
                builder, world.corpus)
    builder = ExampleBuilder(
        query_source=H5FeatureSource(args.desc_bert_path),
        video_source=(H5FeatureSource(args.vid_feat_path)
                      if "video" in args.ctx_mode else None),
        sub_source=(H5FeatureSource(args.sub_bert_path)
                    if "sub" in args.ctx_mode else None),
        ctx_mode=args.ctx_mode, max_desc_l=args.max_desc_l,
        max_ctx_l=args.max_ctx_l, clip_length=args.clip_length)
    corpus = CorpusIndex.from_video_duration_idx(
        args.video_duration_idx_path, args.eval_split_name)
    return (load_annotations(args.train_path, args.data_ratio),
            load_annotations(args.eval_path, args.data_ratio)
            if args.eval_path else [],
            builder, corpus)


def model_config(args, builder: ExampleBuilder) -> ExCLConfig:
    tef_dims = 2 * builder.use_tef
    return ExCLConfig(
        ctx_mode=args.ctx_mode.replace("_tef", ""),
        visual_input_size=builder.video_source.dim + tef_dims if builder.use_video else 2,
        sub_input_size=builder.sub_source.dim + tef_dims if builder.use_sub else 2,
        query_input_size=builder.query_source.dim,
        hidden_size=args.hidden_size, drop=args.drop)


def make_trainer(args, cfg: ExCLConfig, builder, train_rows, device=None,
                 n_devices: int = 1) -> GenericTrainer:
    """Adam at a constant rate; dropout from the trainer's generator; on
    ``device`` (default ``--device``), one rank of ``n_devices``."""
    return GenericTrainer(ExCL(cfg), lambda ps: torch.optim.Adam(ps, lr=args.lr),
                          lambda rows: builder.build_train_batch(rows).model_inputs(),
                          train_rows, args.bsz, args.seed,
                          device=args.device if device is None else device,
                          n_devices=n_devices)


def svmr_kw(args) -> dict:
    return dict(clip_length=args.clip_length, query_bsz=args.eval_query_bsz,
                min_pred_l=args.min_pred_l, max_pred_l=args.max_pred_l)


def vcmr_kw(args) -> dict:
    return dict(clip_length=args.clip_length, q2c_alpha=args.q2c_alpha,
                min_pred_l=args.min_pred_l, max_pred_l=args.max_pred_l)


def start_training(argv: Optional[List[str]] = None) -> dict:
    logging.basicConfig(level=logging.INFO, force=True,
                        format="%(asctime)s:%(levelname)s:%(name)s - %(message)s")
    args = build_arg_parser().parse_args(argv)
    require_device("train_excl", args.device)
    exp_id = args.exp_id or time.strftime("%Y%m%d_%H%M%S")
    k = dp.baseline_world(args.device, args.bsz)
    spawned = dp.join_or_spawn(start_training, list(sys.argv[1:] if argv is None else argv)
                               + ["--exp_id", exp_id], args.device, k)
    if spawned is not None:
        return spawned
    rank, device = dp.rank_device(args.device, k)
    main = rank == 0
    if not main:
        logging.getLogger().setLevel(logging.WARNING)
    results_dir = os.path.join(args.results_root, f"{args.dset_name}-excl-{exp_id}")
    if main:
        os.makedirs(results_dir, exist_ok=True)
        save_json(vars(args), os.path.join(results_dir, "opt.json"), pretty=True)

    train_rows, eval_rows, builder, corpus = setup_world(args)
    cfg = model_config(args, builder)
    trainer = make_trainer(args, cfg, builder, train_rows, device, k)
    model = trainer.model

    metrics_logger = MetricsLogger(results_dir) if main else None
    stopper = EarlyStopper(max_es_cnt=args.max_es_cnt, min_delta=args.es_min_delta, best=-1.0)
    best_metrics = None
    use_desc_type = args.dset_name == "tvr"
    for epoch in range(args.n_epoch):
        losses = trainer.train_epoch(epoch)
        logger.info("epoch %d loss %.4f", epoch, losses["loss"])
        if main:
            metrics_logger.scalars("train", losses, (epoch + 1) * trainer.steps_per_epoch)
        if not eval_rows:
            continue
        should_stop = False
        if main:
            raw = excl_retrieve_svmr(model, builder, corpus, eval_rows, **svmr_kw(args))
            raw["video2idx"] = corpus.video2idx
            submission = submission_top_n(raw, 100)
            metrics = eval_retrieval(submission, eval_rows, use_desc_type=use_desc_type)
            stop_score = metrics["SVMR"]["0.5-r1"] + metrics["SVMR"]["0.7-r1"]
            logger.info("epoch %d SVMR %s", epoch, json.dumps(metrics["SVMR"]))
            is_best, should_stop = stopper.update(stop_score)
            if is_best:
                best_metrics = metrics
                save_json(submission, os.path.join(results_dir, "best_predictions.json"))
                save_json(metrics, os.path.join(results_dir, "best_predictions_metrics.json"),
                          pretty=True)
                save_checkpoint(os.path.join(results_dir, "ckpt"), model.state_dict(),
                                trainer.optimizer.state_dict(), cfg, epoch)
        if dp.rank0_says(should_stop, k, trainer.device):
            logger.info("early stop at epoch %d", epoch)
            break

    # optional VCMR via external VR results (reference inference_with_vcmr.py)
    if main and eval_rows and args.external_inference_vr_res_path:
        raw = excl_retrieve_vcmr_with_external_vr(
            model, builder, corpus, eval_rows, args.external_inference_vr_res_path,
            **vcmr_kw(args))
        raw["video2idx"] = corpus.video2idx
        submission = submission_top_n(raw, 100)
        metrics = eval_retrieval(submission, eval_rows, use_desc_type=use_desc_type)
        save_json(submission, os.path.join(results_dir, "vcmr_external_predictions.json"))
        save_json(metrics, os.path.join(results_dir, "vcmr_external_predictions_metrics.json"),
                  pretty=True)
        logger.info("VCMR (external VR): %s", json.dumps(metrics.get("VCMR", {})))
    if main:
        metrics_logger.close()
    dp.rank0_says(False, k, trainer.device)         # every rank leaves with rank 0
    return {"results_dir": results_dir, "best_metrics": best_metrics}


if __name__ == "__main__":
    start_training()
