"""MEE training CLI (video retrieval baseline), PyTorch.

Port of tvretrieval_tpu/training/train_mee.py (reference
mixture_embedding_experts/train.py): Adam (AdamW under ``--wd``) with the
learning rate decayed x0.95 every epoch's worth of updates (optax's
staircase ``exponential_decay``, counted per update), early stop on VR
r1 + r5. Takes the JAX CLI's flags plus ``--device {cuda,cpu}`` (default
``cuda``; without a card it exits at once). The run directory holds
``opt.json``, the best submission and its metrics, and ``ckpt/`` in the
port's checkpoint layout; the model's ``state_dict`` there carries
BatchNorm's running statistics.

On ``--device cuda`` it trains on every card that divides ``--bsz`` (the
JAX trainer's data mesh): with k > 1 cards it starts k ranks, rank r on
cuda:r with NCCL, each on its rows of every global batch
(training/generic.py); under ``torchrun`` (or inside an initialised
``torch.distributed`` group, gloo with ``--device cpu``) it joins that
group. Rank 0 alone evaluates and writes the run directory; the early
stop is its decision, sent to every rank.

    python -m tvretrieval_tpu_torch.training.train_mee --synthetic --device cpu \\
        --exp_id demo --n_epoch 5 --bsz 16 --results_root /tmp/results
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

from tvretrieval_tpu_torch.data.datasets import CorpusIndex, load_annotations
from tvretrieval_tpu_torch.data.features import H5FeatureSource
from tvretrieval_tpu_torch.data.retrieval_datasets import MEEExampleBuilder
from tvretrieval_tpu_torch.data.synthetic import make_synthetic_world
from tvretrieval_tpu_torch.evaluation.metrics import eval_retrieval_arrays
from tvretrieval_tpu_torch.evaluation.submission import submission_top_n
from tvretrieval_tpu_torch.models.mee import MEE, MEEConfig
from tvretrieval_tpu_torch.retrieval.vr_engine import mee_retrieve_vr
from tvretrieval_tpu_torch.training import data_parallel as dp
from tvretrieval_tpu_torch.training.checkpoint import save_checkpoint
from tvretrieval_tpu_torch.training.early_stop import EarlyStopper
from tvretrieval_tpu_torch.training.generic import (
    GenericTrainer,
    require_device,
    staircase_decay,
)
from tvretrieval_tpu_torch.utils.io import save_json
from tvretrieval_tpu_torch.utils.logging import MetricsLogger

logger = logging.getLogger(__name__)


def build_arg_parser():
    p = argparse.ArgumentParser(description="Train MEE (PyTorch / CUDA)")
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
    p.add_argument("--ctx_mode", type=str, default="video_sub")
    p.add_argument("--max_desc_l", type=int, default=30)
    p.add_argument("--max_ctx_l", type=int, default=100)
    p.add_argument("--output_size", type=int, default=256)
    p.add_argument("--margin", type=float, default=0.2)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--wd", type=float, default=0.0)
    p.add_argument("--n_epoch", type=int, default=50)
    p.add_argument("--bsz", type=int, default=128)
    p.add_argument("--max_es_cnt", type=int, default=10)
    p.add_argument("--es_min_delta", type=float, default=0.0,
                   help="patience resets only when the stop metric improves "
                        "by MORE than this; 0 = reference behavior")
    p.add_argument("--eval_query_bsz", type=int, default=1000)
    p.add_argument("--eval_ctx_bsz", type=int, default=200)
    return p


def setup_world(args):
    if args.synthetic:
        world = make_synthetic_world(n_videos=args.synthetic_videos,
                                     n_queries=args.synthetic_queries, seed=args.seed)
        n_train = int(len(world.annotations) * 0.75)
        builder = MEEExampleBuilder(
            query_source=world.query_source, video_source=world.video_source,
            sub_source=world.sub_source, ctx_mode=args.ctx_mode,
            max_desc_l=args.max_desc_l, max_ctx_l=args.max_ctx_l)
        return (world.annotations[:n_train], world.annotations[n_train:],
                builder, world.corpus)
    builder = MEEExampleBuilder(
        query_source=H5FeatureSource(args.desc_bert_path),
        video_source=(H5FeatureSource(args.vid_feat_path)
                      if "video" in args.ctx_mode else None),
        sub_source=(H5FeatureSource(args.sub_bert_path)
                    if "sub" in args.ctx_mode else None),
        ctx_mode=args.ctx_mode, max_desc_l=args.max_desc_l,
        max_ctx_l=args.max_ctx_l)
    corpus = CorpusIndex.from_video_duration_idx(
        args.video_duration_idx_path, args.eval_split_name)
    return (load_annotations(args.train_path, args.data_ratio),
            load_annotations(args.eval_path, args.data_ratio)
            if args.eval_path else [],
            builder, corpus)


def model_config(args, builder: MEEExampleBuilder) -> MEEConfig:
    return MEEConfig(
        ctx_mode=args.ctx_mode, text_input_size=builder.query_source.dim,
        vid_input_size=builder.video_source.dim if builder.use_video else 2,
        sub_input_size=builder.sub_source.dim if builder.use_sub else 2,
        output_size=args.output_size, margin=args.margin)


def mee_loss_apply(model, batch, generator, train, shard: dp.Shard = dp.Shard()):
    """MEE's forward returns the loss (the rank's share) alone; BatchNorm's
    running statistics move in its buffers."""
    loss = model(**batch, shard=shard)
    return loss, {"loss_overall": loss}


def make_trainer(args, cfg: MEEConfig, builder, train_rows, device=None,
                 n_devices: int = 1) -> GenericTrainer:
    """Adam (AdamW under --wd) with the per-epoch staircase decay; on
    ``device`` (default ``--device``), one rank of ``n_devices``."""
    steps_per_epoch = max(len(train_rows) // args.bsz, 1)
    if args.wd == 0:
        optimizer_fn = lambda ps: torch.optim.Adam(ps, lr=args.lr)
    else:
        optimizer_fn = lambda ps: torch.optim.AdamW(ps, lr=args.lr, weight_decay=args.wd)
    return GenericTrainer(MEE(cfg), optimizer_fn, builder.build_train_batch, train_rows,
                          args.bsz, args.seed, loss_apply=mee_loss_apply,
                          lr_multiplier=staircase_decay(steps_per_epoch, 0.95),
                          device=args.device if device is None else device,
                          n_devices=n_devices)


def vr_submission(corpus, eval_rows, arrays) -> dict:
    vid_idx, scores = arrays["VR"]
    return {"video2idx": corpus.video2idx, "VR": [
        {"desc_id": r["desc_id"], "desc": r.get("desc", ""),
         "predictions": [[int(v), 0, 0, float(s)] for v, s in zip(vid_idx[qi], scores[qi])]}
        for qi, r in enumerate(eval_rows)]}


def start_training(argv: Optional[List[str]] = None) -> dict:
    logging.basicConfig(level=logging.INFO, force=True,
                        format="%(asctime)s:%(levelname)s:%(name)s - %(message)s")
    args = build_arg_parser().parse_args(argv)
    require_device("train_mee", args.device)
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
    results_dir = os.path.join(args.results_root, f"{args.dset_name}-mee-{exp_id}")
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
    for epoch in range(args.n_epoch):
        losses = trainer.train_epoch(epoch)
        logger.info("epoch %d loss %.4f", epoch, losses["loss"])
        if main:
            metrics_logger.scalars("train", losses, (epoch + 1) * trainer.steps_per_epoch)
        if not eval_rows:
            continue
        should_stop = False
        if main:
            # array-path per-epoch eval (no prediction dicts); the dict
            # submission is built only when a new best is found
            arrays = mee_retrieve_vr(model, builder, corpus, eval_rows,
                                     ctx_bsz=args.eval_ctx_bsz, query_bsz=args.eval_query_bsz,
                                     return_arrays=True)
            metrics = eval_retrieval_arrays(eval_rows, corpus.video2idx, vr=arrays["VR"][0],
                                            use_desc_type=args.dset_name == "tvr")
            stop_score = metrics["VR"]["r1"] + metrics["VR"]["r5"]
            logger.info("epoch %d VR %s", epoch, json.dumps(metrics["VR"]))
            is_best, should_stop = stopper.update(stop_score)
            if is_best:
                best_metrics = metrics
                save_json(submission_top_n(vr_submission(corpus, eval_rows, arrays), 100),
                          os.path.join(results_dir, "best_predictions.json"))
                save_json(metrics, os.path.join(results_dir, "best_predictions_metrics.json"),
                          pretty=True)
                # the state dict holds BatchNorm's running statistics
                save_checkpoint(os.path.join(results_dir, "ckpt"), model.state_dict(),
                                trainer.optimizer.state_dict(), cfg, epoch)
        if dp.rank0_says(should_stop, k, trainer.device):
            logger.info("early stop at epoch %d", epoch)
            break
    if main:
        metrics_logger.close()
    dp.rank0_says(False, k, trainer.device)         # every rank leaves with rank 0
    return {"results_dir": results_dir, "best_metrics": best_metrics}


if __name__ == "__main__":
    start_training()
