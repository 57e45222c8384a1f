"""Per-stage profiling on synthetic tensors + corpus-scale extrapolation
(port of the JAX package's profiling/profile_models.py).

Capability parity with reference baselines/profiling/profile_main.py (stage
timers with device sync + 1M-video extrapolation, :35-483) and
search_time_performance.py's storage-size calculator (:230-241). Each stage
is timed by ``time_stage``: its runs queued back to back and one
``torch.cuda.synchronize`` after the last (on the CPU the work is done when
the call returns). ``--trace_dir`` writes a ``torch.profiler`` Chrome
trace of the XML stages. The result dicts carry the JAX package's keys and
its extrapolation arithmetic. Every profiler runs on the card unless asked
for the CPU (``device="cpu"``, ``--device cpu``), where its times are the
host's.

CLI:
    python -m tvretrieval_tpu_torch.profiling.profile_models --n_videos 2000 \
        --extrapolate_videos 1000000 [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from tvretrieval_tpu_torch.utils.device import resolve_device


def _sync(x) -> None:
    """Wait for the device work behind ``x`` (a tensor, or a tuple / dict
    holding tensors): on the card one ``torch.cuda.synchronize``."""
    while isinstance(x, (tuple, list, dict)):
        x = next(iter(x.values() if isinstance(x, dict) else x))
    if isinstance(x, torch.Tensor) and x.is_cuda:
        torch.cuda.synchronize(x.device)


def time_stage(fn: Callable, n_warmup: int = 2, n_runs: int = 10) -> float:
    """Mean wall-clock seconds of fn(), pipelined: the n_runs calls queue
    back to back on the device with one fence after the last."""
    for _ in range(n_warmup):
        _sync(fn())
    t0 = time.perf_counter()
    out = None
    for _ in range(n_runs):
        out = fn()
    _sync(out)
    return (time.perf_counter() - t0) / n_runs


def index_storage_gb(hsz: int, n_videos: int, n_clips_per_video: int,
                     n_moments: int = 0, n_total_clips_in_moments: int = 0,
                     dtype_size: int = 4) -> Dict[str, float]:
    """Index sizes per model family (reference search_time_performance.py:230-241).
    XML stores 2 streams x 2 layers of clip features."""
    GB = 1024 ** 3
    return dict(
        mee=n_videos * hsz * dtype_size * 2.0 / GB,
        cal=n_total_clips_in_moments * hsz * dtype_size * 2.0 / GB,
        mcn=n_moments * hsz * dtype_size * 2.0 / GB,
        xml=n_videos * n_clips_per_video * hsz * dtype_size * 2.0 * 2.0 / GB,
    )


def _randn(gen: torch.Generator, dev: torch.device, *shape, dtype=torch.float32):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


class ProfileXML:
    """Stage timings of the XML corpus-retrieval path on synthetic tensors:
    the engine's ``_score_query_batch`` at ``RetrievalConfig``'s default
    modes over unflattened caches of ``cache_dtype``."""

    def __init__(self, n_videos: int = 2000, n_clips: int = 100,
                 hidden: int = 256, query_bsz: int = 50,
                 visual_dim: int = 3074, sub_dim: int = 770,
                 query_dim: int = 768, cache_dtype: str = "bfloat16", device=None):
        from tvretrieval_tpu_torch.models.xml import XML, XMLConfig
        from tvretrieval_tpu_torch.retrieval.engine import RetrievalConfig, _score_query_batch

        dev = resolve_device(device, "ProfileXML")
        self.n_videos = n_videos
        self.query_bsz = query_bsz
        cfg = XMLConfig(ctx_mode="video_sub", visual_input_size=visual_dim,
                        sub_input_size=sub_dim, query_input_size=query_dim,
                        hidden_size=hidden, n_heads=4, max_ctx_l=n_clips,
                        max_desc_l=30)
        self.model = XML(cfg).init_weights(torch.Generator().manual_seed(0)).eval().to(dev)
        self.rcfg = RetrievalConfig(cache_dtype_str=cache_dtype,
                                    max_vcmr_video=min(100, n_videos))
        gen = torch.Generator(device=dev).manual_seed(0)
        ones = lambda *s: torch.ones(s, device=dev)
        dt = self.rcfg.cache_dtype
        self.cache = [_randn(gen, dev, n_videos, n_clips, hidden, dtype=dt) for _ in range(4)]
        self.mask = ones(n_videos, n_clips)
        cb = self.rcfg.context_bsz
        self.ctx_batch = dict(
            video_feat=_randn(gen, dev, cb, n_clips, visual_dim), video_mask=ones(cb, n_clips),
            sub_feat=_randn(gen, dev, cb, n_clips, sub_dim), sub_mask=ones(cb, n_clips))
        self.q_feat = _randn(gen, dev, query_bsz, 30, query_dim)
        self.q_mask = ones(query_bsz, 30)
        self.gt = torch.zeros((query_bsz,), dtype=torch.int32, device=dev)
        self._score = _score_query_batch

    @torch.no_grad()
    def profile(self, extrapolate_videos: Optional[int] = None,
                n_queries: int = 10000) -> Dict[str, float]:
        model, b = self.model, self.ctx_batch
        results: Dict[str, float] = {}
        results["encode_context_batch_s"] = time_stage(
            lambda: model.encode_context(b["video_feat"], b["video_mask"],
                                         b["sub_feat"], b["sub_mask"]))
        results["encode_query_batch_s"] = time_stage(
            lambda: model.encode_query(self.q_feat, self.q_mask))
        results["score_query_batch_s"] = time_stage(
            lambda: self._score(model, self.rcfg, self.q_feat, self.q_mask,
                                *self.cache, self.mask, self.gt, True))

        ctx_bsz = self.ctx_batch["video_mask"].shape[0]
        results["corpus_encode_total_s"] = (
            results["encode_context_batch_s"] * self.n_videos / ctx_bsz)
        results["retrieval_queries_per_sec"] = (
            self.query_bsz / results["score_query_batch_s"])
        if extrapolate_videos:
            scale = extrapolate_videos / self.n_videos
            results[f"extrapolated_{extrapolate_videos}v_retrieval_s_per_query"] = (
                results["score_query_batch_s"] * scale / self.query_bsz)
            results[f"extrapolated_{extrapolate_videos}v_encode_total_s"] = (
                results["corpus_encode_total_s"] * scale)
        return results


class ProfileXMLTrain:
    """Flagship XML train-step timing + full-TVR wall-clock extrapolation:
    the training forward with dropout, its backward and a BertAdam step
    (t_total 681 x 100, warm-up 0.01, as the JAX profiler sets them). TVR's
    train split: 87,175 queries, batch 128 -> 681 steps an epoch; the
    extrapolation takes the JAX profiler's 60 epochs.
    """

    def __init__(self, bsz: int = 128, hidden: int = 256, n_clips: int = 100,
                 visual_dim: int = 3074, sub_dim: int = 770, query_dim: int = 768,
                 dtype_str: str = "float32", device=None):
        from tvretrieval_tpu_torch.models.xml import XML, XMLConfig
        from tvretrieval_tpu_torch.training.optimization import (
            BertAdam, no_decay_mask, param_groups_from_mask)

        dev = resolve_device(device, "ProfileXMLTrain")
        self.bsz = bsz
        rng = np.random.default_rng(0)
        f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
        self.batch = {
            "query_feat": f32(rng.normal(size=(bsz, 30, query_dim))),
            "query_mask": f32(np.ones((bsz, 30))),
            "video_feat": f32(rng.normal(size=(bsz, n_clips, visual_dim))),
            "video_mask": f32(np.ones((bsz, n_clips))),
            "sub_feat": f32(rng.normal(size=(bsz, n_clips, sub_dim))),
            "sub_mask": f32(np.ones((bsz, n_clips))),
            # the JAX profiler's draws, held inside the clips when there are fewer than 50
            "st_ed_indices": torch.from_numpy(
                np.minimum(rng.integers(0, 50, (bsz, 2)), n_clips - 1)).to(dev),
        }
        cfg = XMLConfig(ctx_mode="video_sub", visual_input_size=visual_dim,
                        sub_input_size=sub_dim, query_input_size=query_dim,
                        hidden_size=hidden, n_heads=4, max_ctx_l=n_clips,
                        max_desc_l=30, dtype_str=dtype_str)
        self.model = XML(cfg).init_weights(torch.Generator().manual_seed(0)).to(dev).train()
        self.optimizer = BertAdam(
            param_groups_from_mask(self.model, no_decay_mask(self.model), 0.01),
            lr=1e-4, t_total=681 * 100, warmup=0.01)
        self.generator = torch.Generator().manual_seed(2)    # the negative ranks

    def _step(self) -> torch.Tensor:
        loss, _ = self.model(**self.batch, lw_st_ed=0.01, neg_sample_upper=self.bsz,
                             generator=self.generator)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def profile(self, steps_per_epoch: int = 681, n_epochs: int = 60) -> Dict[str, float]:
        t = time_stage(self._step, n_warmup=2, n_runs=5)
        return {
            "train_step_s": t,
            "examples_per_sec": self.bsz / t,
            "epoch_s_extrapolated": t * steps_per_epoch,
            "full_train_hours_extrapolated": t * steps_per_epoch * n_epochs / 3600,
        }


# Reference profiling constants (profile_main.py:36-53): 1M-video corpus,
# 10K queries, 20 clips/video (5s clips over 100s), 170 proposals/video
# padded to 14 clips, hsz 256, ctx batch 400, query batch 100.
REF_N_VIDEOS = 1_000_000
REF_CTX_BSZ = 400
REF_QUERY_BSZ = 100
REF_CLIPS_PER_VIDEO = 20
REF_PROPOSALS_PER_VIDEO = 170
REF_MAX_CLIPS_PER_PROPOSAL = 14


class ProfileMEE:
    """MEE stage timers (reference ProfileMEE, profile_main.py:231-312):
    context GEU encoding, query pooling+GEU+MoE, and the corpus retrieval
    matmul — extrapolated to the 1M-video corpus."""

    def __init__(self, device=None):
        from tvretrieval_tpu_torch.models.mee import MEE, MEEConfig

        dev = resolve_device(device, "ProfileMEE")
        # a 768-d subtitle feature, as the JAX profiler feeds its MEE
        self.model = MEE(MEEConfig(vid_input_size=3074, text_input_size=768,
                                   output_size=256, sub_input_size=768))
        self.model.init_weights(torch.Generator().manual_seed(3)).eval().to(dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        self.vid = _randn(gen, dev, REF_CTX_BSZ, 3074)
        self.sub = _randn(gen, dev, REF_CTX_BSZ, 768)
        self.query = _randn(gen, dev, REF_QUERY_BSZ, 15, 768)
        # retrieval stage: queries against a 100K-video encoded block
        self.block = 100_000
        self.enc_v = _randn(gen, dev, self.block, 256)
        self.enc_s = _randn(gen, dev, self.block, 256)

    @torch.no_grad()
    def profile(self):
        m = self.model
        pooled = m.pool_query(self.query)
        r = {
            "ctx_encode_batch_s": time_stage(lambda: m.encode_context(self.vid, self.sub)),
            "query_encode_batch_s": time_stage(lambda: m.pool_query(self.query)),
            "retrieval_100k_block_s": time_stage(
                lambda: m.scores(pooled, self.enc_v, self.enc_s)),
        }
        r[f"extrapolated_{REF_N_VIDEOS}v_ctx_encode_s"] = (
            r["ctx_encode_batch_s"] * REF_N_VIDEOS / REF_CTX_BSZ)
        r[f"extrapolated_{REF_N_VIDEOS}v_retrieval_s_per_{REF_QUERY_BSZ}q"] = (
            r["retrieval_100k_block_s"] * REF_N_VIDEOS / self.block)
        return r


class ProfileCAL:
    """CAL stage timers (reference ProfileCAL, profile_main.py:314-375):
    proposal MLP encoding and the corpus cdist rerank over padded proposal
    batches — extrapolated to 1M videos x 170 proposals. ``CALConfig()``'s
    own widths (6,150-d video and 1,540-d subtitle moments), as in the JAX
    profiler."""

    def __init__(self, device=None):
        from tvretrieval_tpu_torch.models.cal import CALConfig, CALWithSub

        dev = resolve_device(device, "ProfileCAL")
        cfg = CALConfig()
        self.model = CALWithSub(cfg).init_weights(torch.Generator().manual_seed(1)).eval().to(dev)
        Lc = REF_MAX_CLIPS_PER_PROPOSAL
        gen = torch.Generator(device=dev).manual_seed(0)
        self.mom_v = _randn(gen, dev, REF_CTX_BSZ, Lc, cfg.visual_input_size)
        self.query = _randn(gen, dev, REF_QUERY_BSZ, 15, 768)
        self.qmask = torch.ones((REF_QUERY_BSZ, 15), device=dev)
        # rerank block: 10K proposals (~59 videos' worth) per call
        self.n_prop = 10_000
        self.emb_v = _randn(gen, dev, self.n_prop, Lc, cfg.output_size)
        self.emb_s = _randn(gen, dev, self.n_prop, Lc, cfg.output_size)
        self.pmask = torch.ones((self.n_prop, Lc), device=dev)
        self.qemb = _randn(gen, dev, REF_QUERY_BSZ, cfg.output_size)

    @torch.no_grad()
    def profile(self):
        m = self.model
        r = {
            "moment_encode_batch_s": time_stage(
                lambda: m.encode_moments(self.mom_v, "video")),
            "query_encode_batch_s": time_stage(
                lambda: m.encode_query(self.query, self.qmask)),
            "cdist_10k_proposals_s": time_stage(
                lambda: m.cdist_from_encoded(self.qemb, self.emb_v, self.emb_s,
                                             self.pmask)),
        }
        total_props = REF_N_VIDEOS * REF_PROPOSALS_PER_VIDEO
        r[f"extrapolated_{REF_N_VIDEOS}v_moment_encode_s"] = (
            r["moment_encode_batch_s"] * 2 * total_props / REF_CTX_BSZ)
        r[f"extrapolated_{REF_N_VIDEOS}v_cdist_s_per_{REF_QUERY_BSZ}q"] = (
            r["cdist_10k_proposals_s"] * total_props / self.n_prop)
        return r


class ProfileExCL:
    """ExCL stage timers (reference ProfileExCL, profile_main.py:377-472):
    per-(query, video) span scoring — ExCL has no pre-encodable context, so
    corpus retrieval costs a full forward per pair (the reference's point:
    early fusion cannot scale; extrapolation shows why)."""

    def __init__(self, device=None):
        from tvretrieval_tpu_torch.models.excl import ExCL, ExCLConfig

        dev = resolve_device(device, "ProfileExCL")
        cfg = ExCLConfig()
        self.model = ExCL(cfg).init_weights(torch.Generator().manual_seed(1)).eval().to(dev)
        L, B = REF_CLIPS_PER_VIDEO, REF_QUERY_BSZ
        gen = torch.Generator(device=dev).manual_seed(0)
        # one query against a batch of 100 candidate videos (a pair batch)
        self.q = _randn(gen, dev, 1, 15, 768).repeat(B, 1, 1)
        self.qm = torch.ones((B, 15), device=dev)
        self.vf = _randn(gen, dev, B, L, cfg.visual_input_size)
        self.sf = _randn(gen, dev, B, L, cfg.sub_input_size)
        self.cm = torch.ones((B, L), device=dev)

    @torch.no_grad()
    def profile(self):
        r = {"span_scores_100pairs_s": time_stage(
            lambda: self.model.span_logits(self.q, self.qm, self.vf, self.cm,
                                           self.sf, self.cm))}
        # VCMR over the full corpus = N_videos pairs per query
        r[f"extrapolated_{REF_N_VIDEOS}v_s_per_query"] = (
            r["span_scores_100pairs_s"] * REF_N_VIDEOS / 100)
        return r


def profile_data_pipeline(bsz: int = 128, n_videos: int = 200,
                          n_queries: int = 1024) -> Dict[str, float]:
    """Host batch-building cost at flagship dims (video 3072-d, sub 768-d,
    ctx 100): the per-row ExampleBuilder loop vs the PrebuiltExamples
    gather (host only; no device)."""
    from tvretrieval_tpu_torch.data.datasets import ExampleBuilder, PrebuiltExamples
    from tvretrieval_tpu_torch.data.synthetic import make_synthetic_world

    world = make_synthetic_world(n_videos=n_videos, n_queries=n_queries,
                                 vid_dim=3072, text_dim=768, max_clips=100,
                                 seed=0)
    builder = ExampleBuilder(
        query_source=world.query_source, video_source=world.video_source,
        sub_source=world.sub_source, ctx_mode="video_sub_tef",
        max_desc_l=30, max_ctx_l=100, clip_length=world.clip_length)
    rows = world.annotations
    batches = [rows[i:i + bsz] for i in range(0, bsz * 4, bsz)]

    def timed(fn, n=3):
        fn(batches[0])  # warm
        ts = []
        for _ in range(n):
            t0 = time.perf_counter()
            for b in batches:
                fn(b)
            ts.append((time.perf_counter() - t0) / len(batches))
        return float(np.median(ts))

    per_row_s = timed(builder.build_train_batch)
    t0 = time.perf_counter()
    pre = PrebuiltExamples(builder, rows)
    prebuild_s = time.perf_counter() - t0
    prebuilt_s = timed(pre.batch_for_rows)
    pre16 = PrebuiltExamples(builder, rows, dtype=np.float16)
    prebuilt16_s = timed(pre16.batch_for_rows)
    return {
        "per_row_build_batch_s": per_row_s,
        "prebuilt_gather_batch_s": prebuilt_s,
        "prebuilt_f16_gather_batch_s": prebuilt16_s,
        "speedup": per_row_s / prebuilt_s,
        "speedup_f16": per_row_s / prebuilt16_s,
        "prebuild_once_s": prebuild_s,
        "cache_gb": pre.nbytes() / 1024 ** 3,
        "cache_f16_gb": pre16.nbytes() / 1024 ** 3,
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description="XML stage profiler")
    parser.add_argument("--n_videos", type=int, default=2000)
    parser.add_argument("--n_clips", type=int, default=100)
    parser.add_argument("--hidden", type=int, default=256)
    parser.add_argument("--query_bsz", type=int, default=50)
    parser.add_argument("--extrapolate_videos", type=int, default=1000000)
    parser.add_argument("--trace_dir", type=str, default=None,
                        help="write a torch.profiler Chrome trace here")
    parser.add_argument("--train", action="store_true",
                        help="profile the flagship train step instead")
    parser.add_argument("--data", action="store_true",
                        help="profile host batch building (no device needed)")
    parser.add_argument("--baselines", action="store_true",
                        help="profile MEE/CAL/ExCL stage timers (reference "
                             "profile_main.py scales)")
    parser.add_argument("--dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    if args.data:
        results = profile_data_pipeline()
        print(json.dumps(results, indent=2))
        return results

    dev = resolve_device(args.device, "profile_models")
    if args.baselines:
        results = {}
        for name, cls in (("mee", ProfileMEE), ("cal", ProfileCAL),
                          ("excl", ProfileExCL)):
            results[name] = cls(dev).profile()
            print(name, json.dumps(results[name]), flush=True)
        print(json.dumps(results, indent=2))
        return results

    if args.train:
        results = ProfileXMLTrain(dtype_str=args.dtype, device=dev).profile()
        print(json.dumps(results, indent=2))
        return results

    prof = ProfileXML(n_videos=args.n_videos, n_clips=args.n_clips,
                      hidden=args.hidden, query_bsz=args.query_bsz, device=dev)
    if args.trace_dir:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=acts) as trace:
            results = prof.profile(args.extrapolate_videos)
        os.makedirs(args.trace_dir, exist_ok=True)
        trace.export_chrome_trace(os.path.join(args.trace_dir, "profile_models_trace.json"))
    else:
        results = prof.profile(args.extrapolate_videos)
    results["storage_gb"] = index_storage_gb(
        args.hidden, args.extrapolate_videos, 20,
        n_moments=170_000_000, n_total_clips_in_moments=1_170_946_944)
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
