"""XML training CLI, PyTorch / CUDA.

Port of tvretrieval_tpu/training/train_xml.py; mirrors the reference
script's lifecycle (train.py:250-376): build datasets, train with per-epoch
eval-loss + retrieval-metric evaluation, early-stop on the stop-task
metric, keep the best checkpoint + best prediction files, then run full
inference with NMS at the end.

Usage (synthetic smoke, on the CPU):
    python -m tvretrieval_tpu_torch.training.train_xml --synthetic --device cpu \\
        --exp_id demo --n_epoch 3 --bsz 16 --results_root /tmp/results

It runs on the CUDA card unless ``--device cpu`` is given, and exits at
once when there is no card. ``--device_data`` keeps the corpus features
on the device (data/device_corpus.py). Real data: pass --train_path /
--eval_path jsonl annotations, h5 feature paths and
--video_duration_idx_path like the reference scripts/train.sh. Every model
flag of the JAX CLI is taken (the encoder types, single-stream ``--ctx_mode``,
the ablations, the span heads, ``--compute_dtype bfloat16``).

``--n_devices k`` (k > 1) trains data-parallel on k processes, one per
device (training/xml_trainer.py): the command starts them itself (rank r on
cuda:r, NCCL; with ``--device cpu`` k CPU processes, gloo), or, run under
``torchrun --nproc_per_node k``, joins the group torchrun made. Each rank
builds its own rows of every global batch; rank 0 alone evaluates, writes
the run directory and checkpoints, while the others wait at a barrier.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import pickle
import sys
import time
from typing import List, Optional

import torch
import torch.distributed as dist

from tvretrieval_tpu_torch.data.datasets import (
    CorpusIndex,
    ExampleBuilder,
    load_annotations,
)
from tvretrieval_tpu_torch.data.device_corpus import build_device_data
from tvretrieval_tpu_torch.data.features import H5FeatureSource
from tvretrieval_tpu_torch.data.synthetic import make_synthetic_world
from tvretrieval_tpu_torch.evaluation.metrics import eval_retrieval, eval_retrieval_arrays
from tvretrieval_tpu_torch.evaluation.nms import POST_PROCESSING_NMS_FUNC
from tvretrieval_tpu_torch.evaluation.submission import submission_top_n
from tvretrieval_tpu_torch.models.xml import XMLConfig
from tvretrieval_tpu_torch.retrieval.engine import (
    CorpusCache,
    RetrievalConfig,
    arrays_to_submission,
    check_supported,
    encode_corpus,
    encode_corpus_resident,
    retrieve,
)
from tvretrieval_tpu_torch.retrieval.streaming import host_cache_from_device
from tvretrieval_tpu_torch.training import data_parallel as dp
from tvretrieval_tpu_torch.training.checkpoint import load_checkpoint, save_checkpoint
from tvretrieval_tpu_torch.training.early_stop import EarlyStopper
from tvretrieval_tpu_torch.training.xml_trainer import TrainSettings, XMLTrainer
from tvretrieval_tpu_torch.utils.io import (
    count_params,
    dump_pickle_throttled,
    make_code_zip,
    save_json,
)
from tvretrieval_tpu_torch.utils.logging import MetricsLogger

logger = logging.getLogger(__name__)


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train XML (PyTorch / CUDA)")
    # experiment
    p.add_argument("--dset_name", type=str, default="tvr")
    p.add_argument("--eval_split_name", type=str, default="val")
    p.add_argument("--results_root", type=str, default="results")
    p.add_argument("--exp_id", type=str, default=None)
    p.add_argument("--seed", type=int, default=2018)
    p.add_argument("--debug", action="store_true")
    p.add_argument("--data_ratio", type=float, default=1.0)
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="where the model and the resident corpus live; the "
                        "default needs a CUDA card")
    # data
    p.add_argument("--synthetic", action="store_true",
                   help="use a synthetic TVR-shaped world (no h5 needed)")
    p.add_argument("--synthetic_videos", type=int, default=64)
    p.add_argument("--synthetic_queries", type=int, default=256)
    p.add_argument("--synthetic_vid_dim", type=int, default=64)
    p.add_argument("--synthetic_text_dim", type=int, default=32)
    p.add_argument("--synthetic_query_dim", type=int, default=0,
                   help=">0: queries live in their own space (e.g. 768 like "
                        "RoBERTa) with projected planted signal")
    p.add_argument("--synthetic_max_clips", type=int, default=24)
    p.add_argument("--synthetic_signal", type=float, default=2.0)
    p.add_argument("--synthetic_train_frac", type=float, default=0.75,
                   help="train/eval split of the synthetic queries")
    p.add_argument("--synthetic_cache", type=str, default=None,
                   help="pickle path caching the generated world across runs")
    p.add_argument("--train_path", type=str, default=None)
    p.add_argument("--eval_path", type=str, default=None)
    p.add_argument("--desc_bert_path", type=str, default=None)
    p.add_argument("--sub_bert_path", type=str, default=None)
    p.add_argument("--vid_feat_path", type=str, default=None)
    p.add_argument("--video_duration_idx_path", type=str, default=None)
    p.add_argument("--ctx_mode", type=str, default="video_sub_tef")
    p.add_argument("--clip_length", type=float, default=1.5)
    p.add_argument("--max_desc_l", type=int, default=30)
    p.add_argument("--max_ctx_l", type=int, default=100)
    p.add_argument("--no_norm_vfeat", action="store_true")
    p.add_argument("--no_norm_tfeat", action="store_true")
    p.add_argument("--h5_preload", action="store_true",
                   help="load h5 features fully into RAM (reference h5py 'core' mode)")
    p.add_argument("--prebuild_examples", action="store_true",
                   help="cache fixed-shape train examples once; per-batch "
                        "building becomes pure numpy gathers (fastest on "
                        "static feature stores; needs RAM for the cache)")
    p.add_argument("--prebuild_dtype", type=str, default="float32",
                   choices=["float32", "float16"],
                   help="prebuilt-cache feature dtype (float16 halves RAM "
                        "and host copy time)")
    p.add_argument("--prebuild_cache_dir", type=str, default=None,
                   help="directory pickling the prebuilt example arrays "
                        "and the eval context batches across runs")
    p.add_argument("--device_data", action="store_true",
                   help="device-resident corpus training (data/device_corpus.py)"
                        ": context features live on the device (quantized), "
                        "batches assemble there, and only query tokens, slots "
                        "and labels cross PCIe per step")
    p.add_argument("--device_data_dtype", type=str, default="float8_e4m3fn",
                   choices=["float8_e4m3fn", "int8", "float16", "float32"],
                   help="resident-feature storage dtype (float8: 8.4 GB for "
                        "the full TVR corpus; float32 is bit-exact against "
                        "the host path)")
    p.add_argument("--scan_steps", type=int, default=8,
                   help="batches per streamed query chunk in --device_data mode")
    # model
    p.add_argument("--hidden_size", type=int, default=256)
    p.add_argument("--n_heads", type=int, default=4)
    p.add_argument("--conv_kernel_size", type=int, default=5)
    p.add_argument("--input_drop", type=float, default=0.1)
    p.add_argument("--drop", type=float, default=0.1)
    p.add_argument("--cross_att_drop", type=float, default=None,
                   help="dropout inside the cross-attention blocks "
                        "(reference config.py:147); default: same as --drop")
    p.add_argument("--grad_clip", type=float, default=-1,
                   help="global-norm gradient clip on top of BertAdam's "
                        "per-param clip; -1 disables (reference train.py:83)")
    p.add_argument("--margin", type=float, default=0.1)
    p.add_argument("--ranking_loss_type", type=str, default="hinge", choices=["hinge", "lse"])
    p.add_argument("--encoder_type", type=str, default="transformer",
                   choices=["transformer", "cnn", "lstm", "gru"])
    p.add_argument("--span_predictor_type", type=str, default="conv", choices=["conv", "cat_linear"])
    p.add_argument("--stack_conv_predictor_conv_kernel_sizes", type=int,
                   nargs="+", default=None,
                   help="stacked ConvSE kernel sizes (reference config.py "
                        "stack_conv_predictor_conv_kernel_sizes; default single conv)")
    p.add_argument("--no_merge_two_stream", action="store_true")
    p.add_argument("--no_cross_att", action="store_true")
    p.add_argument("--no_modular", action="store_true")
    p.add_argument("--compute_dtype", type=str, default="float32", choices=["float32", "bfloat16"])
    # optimization
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--lr_warmup_proportion", type=float, default=0.01)
    p.add_argument("--wd", type=float, default=0.01)
    p.add_argument("--n_epoch", type=int, default=100)
    p.add_argument("--bsz", type=int, default=128)
    p.add_argument("--max_es_cnt", type=int, default=10)
    p.add_argument("--es_min_delta", type=float, default=0.0,
                   help="early-stop patience resets only when the stop "
                        "metric improves by MORE than this (best checkpoint "
                        "still tracks any improvement); 0 = reference "
                        "behavior (train.py:211-236)")
    p.add_argument("--lw_st_ed", type=float, default=0.01)
    p.add_argument("--lw_neg_q", type=float, default=1.0)
    p.add_argument("--lw_neg_ctx", type=float, default=1.0)
    p.add_argument("--train_span_start_epoch", type=int, default=0)
    p.add_argument("--hard_negtiave_start_epoch", type=int, default=20)
    p.add_argument("--hard_pool_size", type=int, default=20)
    # eval / inference
    p.add_argument("--stop_task", type=str, default="VCMR", choices=["VCMR", "SVMR", "VR"])
    p.add_argument("--eval_tasks_at_training", type=str, nargs="+",
                   default=["VCMR", "SVMR", "VR"])
    p.add_argument("--eval_query_bsz", type=int, default=50)
    p.add_argument("--eval_context_bsz", type=int, default=200)
    p.add_argument("--span_score_mode", type=str, default="gather",
                   choices=["gather", "simsweep", "simsweep_cat", "simsweep_cat_bf16",
                            "simsweep_cat_int8", "simsweep_cat_int8_flat"],
                   help="retrieval-eval span scoring path (engine.py; gather "
                        "is the reference-faithful default; the int8 modes "
                        "store the feat2 cache as int8 and are not parity modes)")
    p.add_argument("--video_score_mode", type=str, default="einsum",
                   choices=["einsum", "pallas", "pallas_int8"],
                   help="retrieval-eval video-level scoring path ('pallas': "
                        "the CUDA video-score kernels)")
    p.add_argument("--span_topk_mode", type=str, default="grouped",
                   choices=["grouped", "grouped_shift", "grouped_shift8",
                            "grouped_shift_approx", "grouped_shift_psort"],
                   help="VCMR span top-k expansion (grouped, grouped_shift, "
                        "grouped_shift8 and grouped_shift_psort are bit-equal; "
                        "grouped_shift_approx selects by the approximate top-k "
                        "at --topk_approx_recall)")
    p.add_argument("--video_topk_fused", type=int, default=0,
                   help="1: the flat video-score kernel emits block maxima "
                        "and video top-k runs fused (pre-exp semantics; "
                        "video_score_mode pallas/pallas_int8 only)")
    p.add_argument("--video_topk_approx", type=int, default=0,
                   help="1: video top-V by the approximate top-k on the pre-exp "
                        "scores, at --topk_approx_recall (not a parity mode)")
    p.add_argument("--video_topk_psort", type=int, default=0,
                   help="1: video top-V through the sorting kernel (a parity "
                        "mode, equal to the default selection)")
    p.add_argument("--topk_approx_recall", type=float, default=0.99,
                   help="recall target for every approximate top-k site")
    p.add_argument("--span_sim_pad_l", type=int, default=0,
                   help="pad the cat cache's clip axis to this length "
                        "(parity mode, simsweep_cat/_bf16 only; 0 = off)")
    p.add_argument("--video_chunk_v", type=int, default=16,
                   help="flat-cache video padding multiple and upper bound on "
                        "the videos per block maximum of the fused top-k")
    p.add_argument("--eval_cache_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="corpus-cache dtype for retrieval eval; bfloat16 "
                        "halves its memory")
    p.add_argument("--q2c_alpha", type=float, default=20.0)
    p.add_argument("--min_pred_l", type=int, default=2)
    p.add_argument("--max_pred_l", type=int, default=16)
    p.add_argument("--max_before_nms", type=int, default=200)
    p.add_argument("--max_vcmr_video", type=int, default=100)
    p.add_argument("--nms_thd", type=float, default=-1.0)
    p.add_argument("--external_inference_vr_res_path", type=str, default=None,
                   help="VR submission JSON replacing internal video ranking")
    p.add_argument("--n_devices", type=int, default=None,
                   help="data-parallel devices: one process per device, started "
                        "here (or by torchrun); --bsz must divide by it")
    p.add_argument("--resume", type=str, default=None,
                   help="checkpoint dir to resume params+optimizer state from")
    p.add_argument("--eval_untrained", action="store_true",
                   help="evaluate before training (reference epoch -1)")
    p.add_argument("--detect_anomaly", action="store_true",
                   help="enable torch.autograd.set_detect_anomaly")
    p.add_argument("--add_pe_rnn", action="store_true")
    return p


def retrieval_config(args, n_videos: int) -> RetrievalConfig:
    return RetrievalConfig(
        q2c_alpha=args.q2c_alpha, min_pred_l=args.min_pred_l,
        max_pred_l=args.max_pred_l, max_before_nms=args.max_before_nms,
        max_vcmr_video=min(args.max_vcmr_video, n_videos),
        query_bsz=args.eval_query_bsz, context_bsz=args.eval_context_bsz,
        clip_length=args.clip_length, cache_dtype_str=args.eval_cache_dtype,
        span_score_mode=args.span_score_mode, video_score_mode=args.video_score_mode,
        span_topk_mode=args.span_topk_mode,
        video_topk_fused=bool(args.video_topk_fused),
        video_topk_approx=bool(args.video_topk_approx),
        video_topk_psort=bool(args.video_topk_psort),
        topk_approx_recall=args.topk_approx_recall,
        span_sim_pad_l=args.span_sim_pad_l, video_chunk_v=args.video_chunk_v)


def model_config(args, builder: Optional[ExampleBuilder]) -> XMLConfig:
    """The XMLConfig the flags ask for; input widths come from ``builder``
    (None: the config's defaults, enough to check the flags)."""
    tef_dims = 2 * ("tef" in args.ctx_mode)
    both = "video" in args.ctx_mode and "sub" in args.ctx_mode
    widths = {}
    if builder is not None:
        widths = dict(
            visual_input_size=(builder.video_source.dim + tef_dims
                               if builder.use_video else 2),
            sub_input_size=(builder.sub_source.dim + tef_dims if builder.use_sub else 2),
            query_input_size=builder.query_source.dim)
    return XMLConfig(
        ctx_mode=args.ctx_mode.replace("_tef", "").replace("tef", "") or "video",
        merge_two_stream=not args.no_merge_two_stream and both,
        cross_att=not args.no_cross_att and both,
        span_predictor_type=args.span_predictor_type,
        stack_conv_predictor_conv_kernel_sizes=(
            tuple(args.stack_conv_predictor_conv_kernel_sizes)
            if args.stack_conv_predictor_conv_kernel_sizes else None),
        encoder_type=args.encoder_type, add_pe_rnn=args.add_pe_rnn,
        hidden_size=args.hidden_size, n_heads=args.n_heads,
        conv_kernel_size=args.conv_kernel_size,
        max_ctx_l=args.max_ctx_l, max_desc_l=args.max_desc_l,
        input_drop=args.input_drop, drop=args.drop,
        cross_att_drop=args.cross_att_drop, margin=args.margin,
        ranking_loss_type=args.ranking_loss_type,
        lw_neg_q=args.lw_neg_q, lw_neg_ctx=args.lw_neg_ctx,
        no_modular=args.no_modular, dtype_str=args.compute_dtype, **widths)


def check_args_supported(args) -> None:
    """Raise ValueError before any data is built: an unknown engine mode,
    or a batch that does not split over --n_devices."""
    n = args.n_devices or 1
    if n < 1 or args.bsz % n:
        raise ValueError(f"--bsz {args.bsz} does not split over --n_devices {n}")
    check_supported(retrieval_config(args, 1))              # mode names


def setup_world(args):
    """Returns (train_rows, eval_rows, builder, corpus)."""
    builder_kw = dict(
        ctx_mode=args.ctx_mode, max_desc_l=args.max_desc_l, max_ctx_l=args.max_ctx_l,
        clip_length=args.clip_length, normalize_vfeat=not args.no_norm_vfeat,
        normalize_tfeat=not args.no_norm_tfeat)
    if args.synthetic:
        cache_path = args.synthetic_cache
        if cache_path and os.path.exists(cache_path):
            # only a cache this program wrote is read back
            logger.info("loading cached synthetic world from %s", cache_path)
            with open(cache_path, "rb") as f:
                world = pickle.load(f)
        else:
            world = make_synthetic_world(
                n_videos=args.synthetic_videos, n_queries=args.synthetic_queries,
                vid_dim=args.synthetic_vid_dim, text_dim=args.synthetic_text_dim,
                query_dim=args.synthetic_query_dim,
                max_clips=args.synthetic_max_clips, signal=args.synthetic_signal,
                clip_length=args.clip_length, seed=args.seed)
            if cache_path:
                dump_pickle_throttled(world, cache_path)
                logger.info("cached synthetic world to %s", cache_path)
        n_train = int(len(world.annotations) * args.synthetic_train_frac)
        builder = ExampleBuilder(
            query_source=world.query_source,
            video_source=world.video_source if "video" in args.ctx_mode else None,
            sub_source=world.sub_source if "sub" in args.ctx_mode else None,
            **builder_kw)
        return (world.annotations[:n_train], world.annotations[n_train:], builder,
                world.corpus)

    if not (args.train_path and args.desc_bert_path and args.video_duration_idx_path):
        raise ValueError("real-data mode needs --train_path --desc_bert_path "
                         "--video_duration_idx_path")
    train_rows = load_annotations(args.train_path, args.data_ratio)
    eval_rows = load_annotations(args.eval_path, args.data_ratio) if args.eval_path else []
    h5 = lambda path: H5FeatureSource(path, preload=args.h5_preload)
    builder = ExampleBuilder(
        query_source=h5(args.desc_bert_path),
        video_source=h5(args.vid_feat_path) if "video" in args.ctx_mode else None,
        sub_source=h5(args.sub_bert_path) if "sub" in args.ctx_mode else None,
        **builder_kw)
    corpus = CorpusIndex.from_video_duration_idx(
        args.video_duration_idx_path, args.eval_split_name)
    return train_rows, eval_rows, builder, corpus


def _encode(model, builder, corpus, rcfg, device_data, batch_cache=None):
    model.eval()
    if device_data is not None:
        return encode_corpus_resident(model, device_data, corpus, rcfg)
    return encode_corpus(model, builder, corpus, rcfg, batch_cache=batch_cache)


def evaluate_retrieval(model, builder, corpus, eval_rows, args, tasks,
                       results_dir: str, tag: str, apply_nms: bool = False,
                       device_data=None):
    """Corpus inference + metrics; returns (metrics, metrics_nms, file_paths)."""
    rcfg = retrieval_config(args, len(corpus))
    # test_public rows carry no GT (no ts/vid_name): generate the submission
    # only, drop SVMR, skip metrics (reference inference.py:494-503)
    has_gt = bool(eval_rows) and "ts" in eval_rows[0]
    if not has_gt:
        tasks = tuple(t for t in tasks if t != "SVMR")
    streaming = getattr(args, "streaming", None) or "off"
    stream_kw = {}
    if streaming != "off":
        # the streaming engine (JAX train_xml.py:299-327): encode the plain
        # (Nv, L, D) layout and both feat2 streams, move the cache to host
        # memory (the host cache builds its own block layout), drop it from
        # the device and score from the host. "flat": B2 blocks;
        # "flat_int8": B1 blocks, half the host memory and copy
        enc_cfg = dataclasses.replace(rcfg, span_score_mode="gather",
                                      video_score_mode="einsum")
        cache = _encode(model, builder, corpus, enc_cfg, device_data)
        host = host_cache_from_device(cache, flat=streaming.startswith("flat"),
                                      int8=streaming == "flat_int8")
        cache = CorpusCache(None, None, None, None, mask=host.mask,
                            n_videos=cache.n_videos, metas=cache.metas)
        stream_kw = dict(streaming_host=host, streaming_block_videos=getattr(
            args, "streaming_block_videos", None) or 2048)
    else:
        cache = _encode(model, builder, corpus, rcfg, device_data)
    raw = retrieve(model, builder, cache, eval_rows, corpus, rcfg, tasks=tasks,
                   external_vr_path=args.external_inference_vr_res_path,
                   query_table=(device_data.retrieval_queries
                                if device_data is not None else None), **stream_kw)
    raw["video2idx"] = corpus.video2idx

    submission = submission_top_n(raw, top_n=100)
    sub_path = os.path.join(results_dir, f"{tag}_predictions.json")
    save_json(submission, sub_path)
    paths = [sub_path]
    metrics = metrics_nms = None
    use_desc_type = args.dset_name == "tvr"
    if has_gt:
        metrics = eval_retrieval(submission, eval_rows, use_desc_type=use_desc_type)
        save_json(metrics, sub_path.replace(".json", "_metrics.json"), pretty=True)
        paths.append(sub_path.replace(".json", "_metrics.json"))

    if apply_nms and args.nms_thd != -1:
        after = {"video2idx": raw["video2idx"]}
        for task, fn in POST_PROCESSING_NMS_FUNC.items():
            if task in raw:
                after[task] = fn(raw[task], nms_thd=args.nms_thd,
                                 max_before_nms=args.max_before_nms, max_after_nms=100)
        nms_path = sub_path.replace(".json", f"_nms_thd_{args.nms_thd}.json")
        save_json(after, nms_path)
        paths.append(nms_path)
        if has_gt:
            metrics_nms = eval_retrieval(after, eval_rows, use_desc_type=use_desc_type)
            save_json(metrics_nms, nms_path.replace(".json", "_metrics.json"), pretty=True)
            paths.append(nms_path.replace(".json", "_metrics.json"))
    return metrics, metrics_nms, paths


def evaluate_retrieval_fast(model, builder, corpus, eval_rows, args, tasks,
                            device_data=None, ctx_batch_cache=None):
    """Array-path per-epoch eval: no prediction dicts, no files. Returns
    (metrics, arrays); a submission is built from the arrays only when
    needed (best epoch). DiDeMo multi-annotation rows need the dict path.
    device_data: the device-resident corpus (encoding and query streaming
    then skip all host feature building). ctx_batch_cache: a list that
    keeps the host-built context batches (float16) from one epoch's corpus
    encoding to the next (``encode_corpus``'s ``batch_cache``)."""
    rcfg = retrieval_config(args, len(corpus))
    cache = _encode(model, builder, corpus, rcfg, device_data, ctx_batch_cache)
    arrays = retrieve(model, builder, cache, eval_rows, corpus, rcfg, tasks=tasks,
                      return_arrays=True,
                      external_vr_path=args.external_inference_vr_res_path,
                      query_table=(device_data.retrieval_queries
                                   if device_data is not None else None))
    metrics = eval_retrieval_arrays(
        eval_rows, corpus.video2idx,
        vcmr=arrays["VCMR"][:2] if "VCMR" in arrays else None,
        svmr=arrays["SVMR"][:2] if "SVMR" in arrays else None,
        vr=arrays["VR"][0] if "VR" in arrays else None,
        use_desc_type=args.dset_name == "tvr")
    return metrics, arrays


def _spawn_ranks(argv: List[str], args) -> dict:
    """Start --n_devices ranks of this command on localhost and return rank
    0's result; the run directory is named once, here, for all of them."""
    n = args.n_devices
    if args.device == "cuda" and torch.cuda.device_count() < n:
        raise SystemExit(f"train_xml: --n_devices {n} needs {n} CUDA cards, found "
                         f"{torch.cuda.device_count()}")
    argv = list(argv) + ["--exp_id", args.exp_id or time.strftime("%Y%m%d_%H%M%S")]
    return dp.spawn_ranks(start_training, argv, n, dp.backend_for(args.device))


def start_training(argv: Optional[List[str]] = None) -> dict:
    logging.basicConfig(format="%(asctime)s:%(levelname)s:%(name)s - %(message)s",
                        level=logging.INFO, force=True)
    argv = list(argv) if argv is not None else None
    args = build_arg_parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train_xml: no CUDA device is available; pass --device cpu "
                         "to train on the CPU")
    check_args_supported(args)
    n_dev = args.n_devices or 1
    if n_dev > 1 and not dist.is_initialized():
        if dp.under_torchrun():
            dist.init_process_group(dp.backend_for(args.device))
        else:
            return _spawn_ranks(sys.argv[1:] if argv is None else argv, args)
    if n_dev > 1 and dist.get_world_size() != n_dev:
        raise ValueError(f"--n_devices {n_dev} in a group of {dist.get_world_size()} ranks")
    rank, device = dp.rank_device(args.device, n_dev)
    main = rank == 0
    if not main:
        logging.getLogger().setLevel(logging.WARNING)
    if args.debug:
        args.n_epoch = min(args.n_epoch, 1)
    if args.detect_anomaly:
        torch.autograd.set_detect_anomaly(True)
    torch.manual_seed(args.seed + rank)   # dropout masks, decorrelated across ranks

    exp_id = args.exp_id or time.strftime("%Y%m%d_%H%M%S")
    results_dir = os.path.join(args.results_root, f"{args.dset_name}-{exp_id}")
    if main:
        os.makedirs(results_dir, exist_ok=True)
        save_json(vars(args), os.path.join(results_dir, "opt.json"), pretty=True)
        # source snapshot per run (reference config.py:219-226 code.zip); a
        # run goes on without it
        try:
            make_code_zip(os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))), os.path.join(results_dir, "code.zip"))
        except OSError:
            logger.warning("code snapshot failed", exc_info=True)

    train_rows, eval_rows, builder, corpus = setup_world(args)
    logger.info("train=%d eval=%d corpus=%d videos",
                len(train_rows), len(eval_rows), len(corpus))
    model_cfg = model_config(args, builder)
    settings = TrainSettings(
        lr=args.lr, lr_warmup_proportion=args.lr_warmup_proportion, wd=args.wd,
        n_epoch=args.n_epoch, bsz=args.bsz, max_es_cnt=args.max_es_cnt,
        lw_st_ed=args.lw_st_ed, train_span_start_epoch=args.train_span_start_epoch,
        hard_negative_start_epoch=args.hard_negtiave_start_epoch,
        hard_pool_size=args.hard_pool_size, seed=args.seed, grad_clip=args.grad_clip,
        prebuild_examples=args.prebuild_examples, prebuild_dtype=args.prebuild_dtype,
        prebuild_cache_dir=args.prebuild_cache_dir or "", scan_steps=args.scan_steps,
        debug_max_steps=4 if args.debug else -1,
        eval_tasks=tuple(args.eval_tasks_at_training), stop_task=args.stop_task)

    device_data = None
    if args.device_data:
        # every rank holds the whole context block (JAX: replicate_sharding)
        device_data = build_device_data(builder, corpus, train_rows, eval_rows,
                                        dtype_name=args.device_data_dtype, device=device)
    trainer = XMLTrainer(model_cfg, settings, builder, train_rows,
                         device_data=device_data, device=device, n_devices=n_dev)
    model = trainer.model
    logger.info("device: %s (%d of %d ranks); %d steps/epoch; %s params", trainer.device,
                rank + 1, n_dev, trainer.steps_per_epoch, f"{count_params(model):,}")

    start_epoch = 0
    if args.resume:
        params, opt_state, _, ckpt_epoch = load_checkpoint(
            args.resume, map_location=trainer.device)
        model.load_state_dict(params, strict=True)
        if opt_state is not None:
            trainer.optimizer.load_state_dict(opt_state)
        start_epoch = ckpt_epoch + 1
        logger.info("resumed from %s at epoch %d", args.resume, ckpt_epoch)

    rank0_says = lambda flag: dp.rank0_says(flag, n_dev, trainer.device)

    stopper = EarlyStopper(max_es_cnt=args.max_es_cnt, min_delta=args.es_min_delta,
                           best=-1.0)
    best_metrics = None
    ckpt_dir = os.path.join(results_dir, "ckpt")
    save = lambda epoch: save_checkpoint(ckpt_dir, model.state_dict(),
                                         trainer.optimizer.state_dict(), model_cfg, epoch)
    eval_kw = dict(tasks=settings.eval_tasks, device_data=device_data)
    # host-built context batches, reused by every epoch's corpus encoding and,
    # under --prebuild_cache_dir, by later runs (eval_ctx_batches.pkl)
    ctx_batch_cache: list = []
    ctx_cache_path = (os.path.join(args.prebuild_cache_dir, "eval_ctx_batches.pkl")
                      if args.prebuild_cache_dir else None)
    if main and ctx_cache_path and os.path.exists(ctx_cache_path):
        logger.info("loading eval context-batch cache from %s", ctx_cache_path)
        with open(ctx_cache_path, "rb") as f:
            ctx_batch_cache = pickle.load(f)

    def save_ctx_cache():
        """Write the batches after the first evaluation that built them."""
        if ctx_cache_path and ctx_batch_cache and not os.path.exists(ctx_cache_path):
            os.makedirs(args.prebuild_cache_dir, exist_ok=True)
            dump_pickle_throttled(ctx_batch_cache, ctx_cache_path)
            logger.info("cached eval context batches to %s", ctx_cache_path)

    fast_kw = dict(eval_kw, ctx_batch_cache=ctx_batch_cache)
    metrics_logger = MetricsLogger(results_dir) if main else None
    logs = ((open(os.path.join(results_dir, "train.log.txt"), "a"),
             open(os.path.join(results_dir, "eval.log.txt"), "a")) if main
            else (open(os.devnull, "w"), open(os.devnull, "w")))
    with logs[0] as train_log, logs[1] as eval_log:
        if args.eval_untrained and eval_rows and main:
            metrics, _ = evaluate_retrieval_fast(model, builder, corpus, eval_rows,
                                                 args, **fast_kw)
            save_ctx_cache()
            eval_log.write(f"[epoch -1] {json.dumps(metrics)}\n")
            eval_log.flush()
            logger.info("untrained eval: %s", json.dumps(
                {t: metrics[t] for t in settings.eval_tasks if t in metrics}))

        for epoch in range(start_epoch, args.n_epoch):
            t0 = time.time()
            losses = trainer.train_epoch(epoch)
            if main:
                train_log.write(f"[epoch {epoch}] "
                                + " ".join(f"{k} {v:.4f}" for k, v in losses.items())
                                + f" ({time.time() - t0:.1f}s)\n")
                train_log.flush()
                metrics_logger.scalars("train", losses, trainer.global_step)
                # per-step scalars (reference writes per step, train.py:88-90);
                # kept on the device during the epoch, written here
                base_step = trainer.global_step - len(trainer.last_step_losses)
                for si, step_loss in enumerate(trainer.last_step_losses):
                    metrics_logger.scalars("train_step", step_loss, base_step + si + 1)
            logger.info("epoch %d train loss %.4f (%.1fs)", epoch,
                        losses["loss_overall"], time.time() - t0)

            if not eval_rows:
                if main:
                    save(epoch)
                rank0_says(False)
                continue

            eval_losses = trainer.eval_loss_epoch(eval_rows, epoch)    # every rank
            should_stop = False
            if main:
                if args.dset_name == "didemo":  # multi-annotation rows need dict path
                    metrics, _, _ = evaluate_retrieval(
                        model, builder, corpus, eval_rows, args, results_dir=results_dir,
                        tag="latest", **eval_kw)
                    eval_arrays = None
                else:
                    metrics, eval_arrays = evaluate_retrieval_fast(
                        model, builder, corpus, eval_rows, args, **fast_kw)
                    save_ctx_cache()    # the first epoch fills it without --eval_untrained
                eval_log.write(f"[epoch {epoch}] {json.dumps(metrics)}\n")
                eval_log.flush()
                if eval_losses:
                    metrics_logger.scalars("eval_loss", eval_losses, trainer.global_step)
                for task in settings.eval_tasks:
                    if task in metrics:
                        metrics_logger.scalars(f"eval/{task}", dict(metrics[task]),
                                               trainer.global_step)

                stop_names = ["r1"] if args.stop_task == "VR" else ["0.5-r1", "0.7-r1"]
                stop_score = sum(metrics[args.stop_task][k] for k in stop_names)
                logger.info("epoch %d eval %s stop_score=%.3f (best %.3f)",
                            epoch, args.stop_task, stop_score, stopper.best)

                is_best, should_stop = stopper.update(stop_score)
                if is_best:
                    best_metrics = metrics
                    save(epoch)
                    if eval_arrays is not None:
                        submission = arrays_to_submission(eval_arrays, eval_rows)
                        submission["video2idx"] = corpus.video2idx
                        save_json(submission_top_n(submission, 100),
                                  os.path.join(results_dir, "best_predictions.json"))
                        save_json(metrics, os.path.join(
                            results_dir, "best_predictions_metrics.json"), pretty=True)
            if rank0_says(should_stop):
                logger.info("early stop at epoch %d", epoch)
                break
    if main:
        metrics_logger.close()

    # final inference with NMS (reference train.py:359-375 chains inference)
    final_metrics = None
    if eval_rows and main:
        final_metrics, _, _ = evaluate_retrieval(
            model, builder, corpus, eval_rows, args, results_dir=results_dir,
            tag="inference", apply_nms=True, **eval_kw)
        logger.info("final metrics: %s",
                    json.dumps({t: final_metrics[t] for t in settings.eval_tasks
                                if t in final_metrics}))
    rank0_says(False)
    return {"results_dir": results_dir, "best_metrics": best_metrics,
            "final_metrics": final_metrics}


if __name__ == "__main__":
    start_training()
