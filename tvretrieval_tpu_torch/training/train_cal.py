"""CAL/MCN training CLI (proposal-based moment retrieval baseline), PyTorch.

Port of tvretrieval_tpu/training/train_cal.py (reference
clip_alignment_with_language/train.py): SGD with momentum 0.95 (optax's
``add_decayed_weights`` as SGD's ``weight_decay``) and the learning rate
x0.1 every 30 epochs' worth of updates (optax's staircase
``exponential_decay``, counted per update), triplet sampling per batch,
early stop on VCMR; re-training with MEE-guided inter-video negatives via
--external_train_vr_res_path and a warm start from a port checkpoint via
--init_ckpt_path (scripts/re_train_cal.sh). Takes the JAX CLI's flags plus
``--device {cuda,cpu}`` (default ``cuda``; without a card it exits at
once). On ``--device cuda`` it trains on every card that divides
``--bsz``, one rank a card, or joins the group torchrun (or the caller)
made, as train_mee does (training/generic.py); rank 0 alone evaluates
and writes.

    python -m tvretrieval_tpu_torch.training.train_cal --synthetic --device cpu \\
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

from tvretrieval_tpu_torch.data.datasets import CorpusIndex, load_annotations
from tvretrieval_tpu_torch.data.features import H5FeatureSource
from tvretrieval_tpu_torch.data.retrieval_datasets import CALBuilderConfig, CALExampleBuilder
from tvretrieval_tpu_torch.data.synthetic import make_synthetic_world
from tvretrieval_tpu_torch.evaluation.metrics import eval_retrieval_arrays
from tvretrieval_tpu_torch.evaluation.submission import submission_top_n
from tvretrieval_tpu_torch.models.cal import CALConfig, CALWithSub
from tvretrieval_tpu_torch.retrieval.proposal_engine import cal_retrieve, encode_proposal_corpus
from tvretrieval_tpu_torch.training import data_parallel as dp
from tvretrieval_tpu_torch.training.checkpoint import load_checkpoint, save_checkpoint
from tvretrieval_tpu_torch.training.early_stop import EarlyStopper
from tvretrieval_tpu_torch.training.generic import (
    GenericTrainer,
    require_device,
    staircase_decay,
)
from tvretrieval_tpu_torch.utils.io import load_json, save_json
from tvretrieval_tpu_torch.utils.logging import MetricsLogger

logger = logging.getLogger(__name__)


def build_arg_parser():
    p = argparse.ArgumentParser(description="Train CAL/MCN (PyTorch / CUDA)")
    p.add_argument("--dset_name", type=str, default="tvr")
    p.add_argument("--eval_split_name", type=str, default="val")
    p.add_argument("--results_root", type=str, default="results")
    p.add_argument("--exp_id", type=str, default=None)
    p.add_argument("--seed", type=int, default=2018)
    p.add_argument("--data_ratio", type=float, default=1.0,
                   help="train/eval on a fraction of the data (reference config.py:29-32)")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="where the model lives; the default needs a CUDA card")
    p.add_argument("--model_type", type=str, default="cal", choices=["cal", "mcn"])
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic_videos", type=int, default=64)
    p.add_argument("--synthetic_queries", type=int, default=256)
    p.add_argument("--train_path", type=str, default=None)
    p.add_argument("--eval_path", type=str, default=None)
    p.add_argument("--desc_bert_path", type=str, default=None)
    p.add_argument("--sub_bert_path", type=str, default=None)
    p.add_argument("--vid_feat_path", type=str, default=None)
    p.add_argument("--video_duration_idx_path", type=str, default=None)
    p.add_argument("--external_train_vr_res_path", type=str, default=None,
                   help="VR submission JSON guiding inter-negative sampling")
    p.add_argument("--init_ckpt_path", type=str, default=None,
                   help="warm-start params from a previous run's ckpt dir "
                        "(reference --init_ckpt_path, re_train_cal.sh:7-16: "
                        "re-train with MEE-guided negatives from the "
                        "first-round CAL checkpoint)")
    p.add_argument("--ctx_mode", type=str, default="video_sub_tef")
    p.add_argument("--clip_length", type=float, default=1.5)
    p.add_argument("--max_desc_l", type=int, default=30)
    p.add_argument("--max_ctx_l", type=int, default=100)
    p.add_argument("--max_moment_clips", type=int, default=24)
    p.add_argument("--visual_hidden_size", type=int, default=500)
    p.add_argument("--output_size", type=int, default=100)
    p.add_argument("--lstm_hidden_size", type=int, default=1000)
    p.add_argument("--margin", type=float, default=0.1)
    p.add_argument("--loss_type", type=str, default="hinge", choices=["hinge", "lse"])
    p.add_argument("--inter_loss_weight", type=float, default=0.4)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--momentum", type=float, default=0.95)
    p.add_argument("--wd", type=float, default=0.0)
    p.add_argument("--n_epoch", type=int, default=108)
    p.add_argument("--bsz", type=int, default=128)
    p.add_argument("--max_es_cnt", type=int, default=10)
    p.add_argument("--es_min_delta", type=float, default=0.0,
                   help="patience resets only when the stop metric improves "
                        "by MORE than this; 0 = reference behavior")
    p.add_argument("--eval_query_bsz", type=int, default=100)
    p.add_argument("--max_before_nms", type=int, default=200)
    return p


def _load_external_vr(path: str, corpus, top_n: int = 20):
    """VR submission -> {desc_id: [(vid_name, duration), ...]} for guided
    negative sampling (reference proposal_retrieval_dataset.py:252-280)."""
    sub = load_json(path)
    idx2video = {v: k for k, v in corpus.video2idx.items()}
    dur = dict(zip(corpus.vid_names, corpus.durations))
    out = {}
    for e in sub["VR"]:
        names = [idx2video[p[0]] for p in e["predictions"][:top_n] if p[0] in idx2video]
        out[e["desc_id"]] = [(n, dur.get(n, 100.0)) for n in names]
    return out


def setup_world(args):
    bcfg = CALBuilderConfig(
        ctx_mode=args.ctx_mode, model_type=args.model_type,
        clip_length=args.clip_length, max_desc_l=args.max_desc_l,
        max_ctx_l=args.max_ctx_l, max_moment_clips=args.max_moment_clips)
    if args.synthetic:
        world = make_synthetic_world(n_videos=args.synthetic_videos,
                                     n_queries=args.synthetic_queries,
                                     clip_length=args.clip_length, seed=args.seed)
        n_train = int(len(world.annotations) * 0.75)
        builder = CALExampleBuilder(bcfg, world.query_source, world.video_source,
                                    world.sub_source, seed=args.seed)
        return (world.annotations[:n_train], world.annotations[n_train:],
                builder, world.corpus)
    corpus = CorpusIndex.from_video_duration_idx(
        args.video_duration_idx_path, args.eval_split_name)
    external = (_load_external_vr(args.external_train_vr_res_path, corpus)
                if args.external_train_vr_res_path else None)
    builder = CALExampleBuilder(
        bcfg, H5FeatureSource(args.desc_bert_path),
        H5FeatureSource(args.vid_feat_path) if "video" in args.ctx_mode else None,
        H5FeatureSource(args.sub_bert_path) if "sub" in args.ctx_mode else None,
        external_vr_top_videos=external, seed=args.seed)
    return (load_annotations(args.train_path, args.data_ratio),
            load_annotations(args.eval_path, args.data_ratio)
            if args.eval_path else [],
            builder, corpus)


def model_config(args, builder: CALExampleBuilder) -> CALConfig:
    tef_dims = 2 * builder.use_tef
    return CALConfig(
        ctx_mode=(args.ctx_mode.replace("_tef", "") if builder.use_video or builder.use_sub
                  else args.ctx_mode),
        visual_input_size=(builder.video_source.dim * 2 + tef_dims
                           if builder.use_video else 2),
        textual_input_size=(builder.sub_source.dim * 2 + tef_dims
                            if builder.use_sub else 2),
        query_feat_size=builder.query_source.dim,
        visual_hidden_size=args.visual_hidden_size,
        output_size=args.output_size, lstm_hidden_size=args.lstm_hidden_size,
        margin=args.margin, loss_type=args.loss_type,
        inter_loss_weight=args.inter_loss_weight)


def cal_loss_apply(model, batch, generator, train, shard: dp.Shard = dp.Shard()):
    return model(**batch, shard=shard)


def make_trainer(args, cfg: CALConfig, builder, train_rows, device=None,
                 n_devices: int = 1) -> GenericTrainer:
    """SGD with momentum and weight decay, x0.1 every 30 epochs of updates;
    on ``device`` (default ``--device``), one rank of ``n_devices``."""
    steps_per_epoch = max(len(train_rows) // args.bsz, 1)
    optimizer_fn = lambda ps: torch.optim.SGD(ps, lr=args.lr, momentum=args.momentum,
                                              weight_decay=args.wd)
    return GenericTrainer(CALWithSub(cfg), optimizer_fn,
                          lambda rows: builder.build_train_batch(rows, train_rows),
                          train_rows, args.bsz, args.seed, loss_apply=cal_loss_apply,
                          lr_multiplier=staircase_decay(30 * steps_per_epoch, 0.1),
                          device=args.device if device is None else device,
                          n_devices=n_devices)


def start_training(argv: Optional[List[str]] = None) -> dict:
    logging.basicConfig(level=logging.INFO, force=True,
                        format="%(asctime)s:%(levelname)s:%(name)s - %(message)s")
    args = build_arg_parser().parse_args(argv)
    require_device("train_cal", args.device)
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
    results_dir = os.path.join(args.results_root, f"{args.dset_name}-{args.model_type}-{exp_id}")
    if main:
        os.makedirs(results_dir, exist_ok=True)
        save_json(vars(args), os.path.join(results_dir, "opt.json"), pretty=True)

    train_rows, eval_rows, builder, corpus = setup_world(args)
    cfg = model_config(args, builder)
    trainer = make_trainer(args, cfg, builder, train_rows, device, k)
    model = trainer.model
    if args.init_ckpt_path:
        params, _, _, init_epoch = load_checkpoint(args.init_ckpt_path,
                                                   map_location=trainer.device)
        model.load_state_dict(params, strict=True)
        trainer.broadcast_weights()
        logger.info("warm-started params from %s (epoch %d); optimizer state fresh "
                    "(reference re-train semantics)", args.init_ckpt_path, init_epoch)

    metrics_logger = MetricsLogger(results_dir) if main else None
    stopper = EarlyStopper(max_es_cnt=args.max_es_cnt, min_delta=args.es_min_delta, best=-1.0)
    best_metrics = None
    retrieve_kw = dict(tasks=("VCMR", "SVMR"), query_bsz=args.eval_query_bsz,
                       max_before_nms=args.max_before_nms)
    for epoch in range(args.n_epoch):
        losses = trainer.train_epoch(epoch)
        logger.info("epoch %d loss %.4f", epoch, losses["loss"])
        if main:
            metrics_logger.scalars("train", losses, (epoch + 1) * trainer.steps_per_epoch)
        if not eval_rows:
            continue
        should_stop = False
        if main:
            cache = encode_proposal_corpus(model, builder, corpus, dset_name=args.dset_name)
            # array-path per-epoch eval; dict submission only on a new best
            arrays = cal_retrieve(model, builder, cache, corpus, eval_rows, return_arrays=True,
                                  **retrieve_kw)
            metrics = eval_retrieval_arrays(
                eval_rows, corpus.video2idx, vcmr=arrays["VCMR"][:2], svmr=arrays["SVMR"][:2],
                use_desc_type=args.dset_name == "tvr")
            stop_score = metrics["VCMR"]["0.5-r1"] + metrics["VCMR"]["0.7-r1"]
            logger.info("epoch %d VCMR %s", epoch, json.dumps(metrics["VCMR"]))
            is_best, should_stop = stopper.update(stop_score)
            if is_best:
                best_metrics = metrics
                raw = cal_retrieve(model, builder, cache, corpus, eval_rows, **retrieve_kw)
                raw["video2idx"] = corpus.video2idx
                save_json(submission_top_n(raw, 100),
                          os.path.join(results_dir, "best_predictions.json"))
                save_json(metrics, os.path.join(results_dir, "best_predictions_metrics.json"),
                          pretty=True)
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
