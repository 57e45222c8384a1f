"""XML training loop: one train step + the staged loss schedule.

Port of tvretrieval_tpu/training/xml_trainer.py (reference script:
baselines/crossmodal_moment_localization/train.py). Kept: BertAdam with
no-decay groups (train.py:151-164), warmup_linear over
n_epoch * steps_per_epoch, the span loss enabled from
``train_span_start_epoch`` and hard negatives from
``hard_negative_start_epoch`` (train.py:45-48), per-batch eval loss
including the remainder batch.

Two data paths feed the same step: the host path (ExampleBuilder batches
built on background threads and copied to the device) and the
device-resident path (data/device_corpus.py: the corpus lives on the
device, a step gathers its context rows there, and the host streams only
query tokens, slots and labels). Under float32 storage the two give the
same trajectory bit for bit.

Data-parallel training (``n_devices`` k > 1) runs one process per device
under an initialised ``torch.distributed`` group of k ranks (NCCL on cards,
gloo on the CPU; ``train_xml --n_devices`` starts them). Like a step of the
JAX trainer on a k-device mesh, a step computes the GLOBAL-batch function:
every rank builds or assembles only its b = bsz / k rows of the global
batch, ``XML.forward_shard`` computes its share of the global loss (the
in-batch ranking losses over the whole (bsz, bsz) score matrix, from query
vectors and feat1 gathered with autograd, and negative ranks drawn for the
whole batch from a generator every rank holds in the same state), and the
gradients are summed over the ranks in one all-reduce before BertAdam's
per-parameter clip. No DDP wrapper: its gradient average would divide the
summed shares by k a second time (the plumbing is
training/data_parallel.py, which the baselines' trainer shares). The
device-resident path keeps the whole context block on every rank and
assembles the rank's rows with B4.
"""
from __future__ import annotations

import logging
import os
import pickle
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from tvretrieval_tpu_torch.data.datasets import ExampleBuilder, PrebuiltExamples
from tvretrieval_tpu_torch.data.device_corpus import DeviceData, assemble_batch
from tvretrieval_tpu_torch.data.pipeline import BatchIterator, DevicePrefetcher
from tvretrieval_tpu_torch.models.xml import XML, XMLConfig
from tvretrieval_tpu_torch.ops import gather
from tvretrieval_tpu_torch.training.data_parallel import (
    all_reduce_grads,
    broadcast_module,
    gather_rows,
    group_rank,
)
from tvretrieval_tpu_torch.training.optimization import (
    BertAdam,
    no_decay_mask,
    param_groups_from_mask,
)
from tvretrieval_tpu_torch.utils.io import AverageMeter, dump_pickle_throttled

logger = logging.getLogger(__name__)

LOSS_KEYS = ("loss_st_ed", "loss_neg_ctx", "loss_neg_q", "loss_overall")


@dataclass
class TrainSettings:
    """Optimization hyper-parameters (reference config.py defaults)."""

    lr: float = 1e-4
    lr_warmup_proportion: float = 0.01
    wd: float = 0.01
    n_epoch: int = 100
    bsz: int = 128
    max_es_cnt: int = 10
    lw_st_ed: float = 0.01
    train_span_start_epoch: int = 0
    hard_negative_start_epoch: int = 20
    hard_pool_size: int = 20
    grad_clip: float = -1.0          # extra global clip; -1 disables (ref default)
    debug_max_steps: int = -1        # truncate each epoch (reference --debug)
    flush_every_steps: int = 32      # one 1-element read-back per N steps: it
    #                                  only bounds how far the host may run
    #                                  ahead of the device (and with it the
    #                                  batches queued in device memory).
    #                                  <=0 disables (one fence per epoch).
    prefetch_workers: int = 2        # batch-building threads (DataLoader workers)
    prebuild_examples: bool = False  # cache fixed-shape examples once; batch
    #                                  building becomes pure numpy gathers
    #                                  (static feature stores only)
    prebuild_dtype: str = "float32"  # "float16" halves cache RAM + gather time
    prebuild_cache_dir: str = ""     # pickle the prebuilt-example arrays here
    seed: int = 2018
    eval_tasks: Sequence[str] = ("VCMR", "SVMR", "VR")
    stop_task: str = "VCMR"
    # device-resident data: the host streams the query side of scan_steps
    # batches per chunk (one copy, one loss read-back record per chunk); the
    # steps themselves run one after the other. The last
    # steps_per_epoch % scan_steps batches run as chunks of one, so every
    # epoch trains exactly steps_per_epoch steps like the host path.
    scan_steps: int = 8


class XMLTrainer:
    def __init__(self, model_cfg: XMLConfig, settings: TrainSettings,
                 builder: ExampleBuilder, train_rows: List[dict],
                 device_data: Optional[DeviceData] = None, device="cuda",
                 n_devices: int = 1):
        """device_data: optional data.device_corpus.DeviceData; switches
        train / eval-loss epochs to the device-resident corpus path
        (on-device batch assembly). ``device`` is where the model lives
        and must be the device of ``device_data``. n_devices > 1: this
        process is one rank of a data-parallel group of that size, which
        must be initialised (``torch.distributed.init_process_group``)."""
        self.rank = group_rank(n_devices, settings.bsz)
        self.world = n_devices
        self.device = torch.device(device)
        if device_data is not None and device_data.device.type != self.device.type:
            raise ValueError(f"device_data lies on {device_data.device}, the "
                             f"trainer on {self.device}")
        self.cfg = model_cfg
        self.s = settings
        self.builder = builder
        self.train_rows = train_rows
        self.steps_per_epoch = max(len(train_rows) // settings.bsz, 1)
        t_total = self.steps_per_epoch * settings.n_epoch

        self.prebuilt = None
        self._eval_prebuilt = None
        self._eval_prebuilt_key = None
        self.device_data = device_data
        if settings.prebuild_examples and device_data is None:
            self.prebuilt = self._load_or_build_prebuilt(
                "train_prebuilt.pkl", train_rows, eval_labels=False)

        self.model = XML(model_cfg).init_weights(
            torch.Generator().manual_seed(settings.seed)).to(self.device)
        if self.world > 1:
            # every rank seeds the same weights; rank 0's are the ones kept
            broadcast_module(self.model)
        self.optimizer = BertAdam(
            param_groups_from_mask(self.model, no_decay_mask(self.model), settings.wd),
            lr=settings.lr, t_total=t_total, warmup=settings.lr_warmup_proportion,
            schedule="warmup_linear", weight_decay=settings.wd, max_grad_norm=1.0)
        # negative ranks are drawn on the host, so a step never waits for
        # the device; every rank draws the whole batch's from the same state.
        # Dropout uses torch's global generator
        self.neg_generator = torch.Generator().manual_seed(settings.seed + 1)
        #: optional (global_step, batch size, rank upper bound) -> (ctx, query)
        #: rank vectors replacing the draw (differential tests inject ranks)
        self.neg_ranks_fn: Optional[Callable] = None
        self.global_step = 0
        self.last_step_losses: List[Dict[str, float]] = []

    # ------------------------------------------------------------------ build
    def _load_or_build_prebuilt(self, name: str, rows, eval_labels: bool):
        """PrebuiltExamples, pickle-cached under settings.prebuild_cache_dir.
        The cache key is the caller-chosen file name: callers use distinct
        names for distinct row sets. Only caches this program wrote are
        read back."""
        path = (os.path.join(self.s.prebuild_cache_dir, name)
                if self.s.prebuild_cache_dir else None)
        if path and os.path.exists(path):
            logger.info("loading prebuilt examples from %s", path)
            with open(path, "rb") as f:
                return pickle.load(f)
        pre = PrebuiltExamples(self.builder, rows, eval_labels=eval_labels,
                               dtype=np.dtype(self.s.prebuild_dtype))
        if path:
            os.makedirs(self.s.prebuild_cache_dir, exist_ok=True)
            dump_pickle_throttled(pre, path)
            logger.info("cached prebuilt examples to %s", path)
        return pre

    def _build(self, rows) -> Dict[str, torch.Tensor]:
        b = None
        for pre in (self.prebuilt, self._eval_prebuilt):
            if pre is not None and b is None:
                try:
                    b = pre.batch_for_rows(rows)
                except KeyError:  # rows outside this cache
                    b = None
        if b is None:
            b = self.builder.build_train_batch(rows)
        return {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in b.model_inputs().items()}

    def _put(self, batch):
        return {k: v.to(self.device, non_blocking=True) for k, v in batch.items()}

    # ------------------------------------------------------------------ steps
    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        return gather_rows(x, self.rank, self.world)

    def _train_step(self, batch, lw_st_ed: float, neg_upper: int) -> Dict[str, torch.Tensor]:
        """One optimizer step on this rank's rows of the global batch;
        returns the detached global loss dict (on the device)."""
        self.model.train()
        bsz = batch["query_feat"].shape[0] * self.world
        ranks = (self.neg_ranks_fn(self.global_step, bsz, min(neg_upper, bsz))
                 if self.neg_ranks_fn is not None else None)
        batch = dict(batch, video_feat=batch["video_feat"].float(),
                     sub_feat=batch["sub_feat"].float())
        kw = dict(lw_st_ed=lw_st_ed, neg_sample_upper=neg_upper,
                  generator=self.neg_generator, neg_ranks=ranks)
        if self.world == 1:
            loss, loss_dict = self.model(**batch, **kw)
        else:
            loss, loss_dict = self.model.forward_shard(
                **batch, gather=self._gather, rank=self.rank, world=self.world, **kw)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        losses = torch.stack([loss_dict[k].detach().float() for k in LOSS_KEYS])
        if self.world > 1:
            # the sums are the global batch's gradient and losses
            losses = all_reduce_grads(self.model.parameters(), losses)
        if self.s.grad_clip != -1.0:
            # reference train.py:83-85: optional GLOBAL-norm clip on top of
            # BertAdam's per-parameter clip
            torch.nn.utils.clip_grad_norm_(self.model.parameters(), self.s.grad_clip)
        self.optimizer.step()
        self.global_step += 1
        return dict(zip(LOSS_KEYS, losses))

    def _eval_step(self, batch, lw_st_ed: float, neg_upper: int) -> Dict[str, float]:
        """Dropout off, fixed negative sampling (reference eval pass:
        train_epoch(training=False), train.py:178-179)."""
        return dict(zip(LOSS_KEYS, self._eval_values(batch, lw_st_ed, neg_upper).cpu().tolist()))

    @torch.no_grad()
    def _eval_values(self, batch, lw_st_ed: float, neg_upper: int,
                     shard: bool = False) -> torch.Tensor:
        """``_eval_step``'s four losses (LOSS_KEYS order) on the device;
        ``shard``: this rank's share of the global batch's."""
        self.model.eval()
        batch = dict(batch, video_feat=batch["video_feat"].float(),
                     sub_feat=batch["sub_feat"].float())
        if shard:
            _, loss_dict = self.model.forward_shard(
                **batch, gather=self._gather, rank=self.rank, world=self.world,
                lw_st_ed=lw_st_ed, neg_sample_upper=neg_upper)
        else:
            _, loss_dict = self.model(**batch, lw_st_ed=lw_st_ed, neg_sample_upper=neg_upper)
        return torch.stack([loss_dict[k].float() for k in LOSS_KEYS])

    def _eval_loss(self, idx: np.ndarray, make_batch: Callable, lw_st_ed: float,
                   neg_upper: int) -> Dict[str, float]:
        """The eval losses of the batch of rows ``idx``: split over the
        ranks when its size divides, else run whole on rank 0 (a remainder
        batch) and broadcast."""
        n = len(idx)
        if self.world == 1:
            return self._eval_step(make_batch(idx), lw_st_ed, neg_upper)
        if n % self.world == 0:
            b = n // self.world
            vals = self._eval_values(make_batch(idx[self.rank * b:(self.rank + 1) * b]),
                                     lw_st_ed, neg_upper, shard=True)
            dist.all_reduce(vals)
        else:
            vals = (self._eval_values(make_batch(idx), lw_st_ed, neg_upper) if self.rank == 0
                    else torch.zeros(len(LOSS_KEYS), device=self.device))
            dist.broadcast(vals, 0)
        return dict(zip(LOSS_KEYS, vals.cpu().tolist()))

    # ----------------------------------------------------------------- epochs
    def _schedule(self, epoch: int):
        s = self.s
        lw = float(s.lw_st_ed if (s.train_span_start_epoch != -1
                                  and epoch >= s.train_span_start_epoch) else 0.0)
        hard = (s.hard_negative_start_epoch != -1
                and epoch >= s.hard_negative_start_epoch)
        neg_upper = min(1 + s.hard_pool_size, s.bsz) if hard else s.bsz
        return lw, neg_upper

    def _finish_epoch(self, step_losses, data_wait, dispatch) -> Dict[str, float]:
        """One read-back of every step's losses; per-epoch averages."""
        meters = {k: AverageMeter() for k in LOSS_KEYS}
        if step_losses:
            table = torch.stack([torch.stack([ld[k].float() for k in LOSS_KEYS])
                                 for ld in step_losses]).cpu().tolist()
        else:
            table = []
        self.last_step_losses = [dict(zip(LOSS_KEYS, row)) for row in table]
        for ld in self.last_step_losses:
            for k, v in ld.items():
                meters[k].update(v)
        out = {k: m.avg for k, m in meters.items()}
        out["time/data_wait_s"] = data_wait.avg
        out["time/step_dispatch_s"] = dispatch.avg
        return out

    def _train_epoch_device(self, epoch: int) -> Dict[str, float]:
        """Device-resident corpus path: the host streams only (query, slot,
        label) chunks of scan_steps batches; each batch is assembled on
        the device and trained on in turn."""
        lw, neg_upper = self._schedule(epoch)
        K = max(self.s.scan_steps, 1)
        B = self.s.bsz
        dd = self.device_data
        tq, ctx, akw = dd.train_queries, dd.ctx_device, dd.assemble_kwargs
        order = np.arange(len(self.train_rows))
        rng = np.random.default_rng(self.s.seed + epoch)  # = BatchIterator
        rng.shuffle(order)
        n_chunks = self.steps_per_epoch // K
        # the trailing steps_per_epoch % K batches run as chunks of one, so
        # no example is silently dropped
        n_rem = self.steps_per_epoch - n_chunks * K

        def chunks():
            for c in range(n_chunks):
                yield (K, order[c * K * B:(c + 1) * K * B])
            base = n_chunks * K * B
            for r in range(n_rem):
                yield (1, order[base + r * B: base + (r + 1) * B])

        b = B // self.world
        lo = self.rank * b

        def build(item):
            # this rank's b rows of each of the chunk's k global batches
            k, idx = item
            idx = idx.reshape(k, B)[:, lo:lo + b].reshape(-1)
            return tuple(torch.from_numpy(np.ascontiguousarray(a))
                         .reshape((k, b) + a.shape[1:]) for a in tq.chunk(idx))

        def put(arrs):
            return tuple(a.to(self.device, non_blocking=True) for a in arrs)

        prefetch = DevicePrefetcher(chunks(), build_fn=build, put_fn=put,
                                    n_workers=self.s.prefetch_workers)
        step_losses = []
        data_wait, dispatch = AverageMeter(), AverageMeter()
        t0 = time.time()
        done_steps = 0
        flush = max(self.s.flush_every_steps, K)
        for qf, ql, sl, se in prefetch:
            t1 = time.time()
            data_wait.update(t1 - t0)
            k_here = int(qf.shape[0])            # K for full chunks, 1 for the tail
            for i in range(k_here):
                batch = assemble_batch(ctx, qf[i], ql[i], sl[i], se[i],
                                       max_desc_l=self.builder.max_desc_l, **akw)
                step_losses.append(self._train_step(batch, lw, neg_upper))
            done_steps += k_here
            if self.s.flush_every_steps > 0 and done_steps % flush < k_here:
                step_losses[-1]["loss_overall"].item()
            t0 = time.time()
            dispatch.update(t0 - t1)
            if 0 < self.s.debug_max_steps <= done_steps:
                break
        out = self._finish_epoch(step_losses, data_wait, dispatch)
        gather.check_indices(self.device)
        out["steps"] = done_steps
        if self.s.debug_max_steps <= 0 and done_steps != self.steps_per_epoch:
            raise AssertionError(
                f"device epoch ran {done_steps} steps, host path would run "
                f"{self.steps_per_epoch}")
        return out

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        if self.device_data is not None:
            return self._train_epoch_device(epoch)
        lw, neg_upper = self._schedule(epoch)
        it = BatchIterator(self.train_rows, self.s.bsz, shuffle=True,
                           drop_last=True, seed=self.s.seed)
        it.epoch = epoch
        b = self.s.bsz // self.world
        lo = self.rank * b
        prefetch = DevicePrefetcher(it, build_fn=lambda rows: self._build(rows[lo:lo + b]),
                                    put_fn=self._put, n_workers=self.s.prefetch_workers)
        # per-step losses stay on the device; one transfer at epoch end (a
        # host sync per step would stall the queue of launches)
        step_losses = []
        data_wait, dispatch = AverageMeter(), AverageMeter()
        t0 = time.time()
        for batch in prefetch:
            t1 = time.time()
            data_wait.update(t1 - t0)
            step_losses.append(self._train_step(batch, lw, neg_upper))
            if (self.s.flush_every_steps > 0
                    and len(step_losses) % self.s.flush_every_steps == 0):
                step_losses[-1]["loss_overall"].item()
            t0 = time.time()
            dispatch.update(t0 - t1)
            if 0 < self.s.debug_max_steps <= len(step_losses):
                break  # reference --debug truncates epochs (train.py:96-97)
        return self._finish_epoch(step_losses, data_wait, dispatch)

    def eval_loss_epoch(self, eval_rows: List[dict], epoch: int) -> Dict[str, float]:
        """Per-batch unweighted loss average over ALL eval batches,
        including the smaller remainder batch (reference evaluates every
        DataLoader batch, train.py:178-179 with drop_last default False)."""
        lw, neg_upper = self._schedule(epoch)
        meters = {k: AverageMeter() for k in LOSS_KEYS}
        n = len(eval_rows)
        if n == 0:
            return {}
        if self.device_data is not None:
            dd = self.device_data
            on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
            make_batch = lambda idx: assemble_batch(
                dd.ctx_device, *map(on, dd.eval_queries.chunk(idx)),
                max_desc_l=self.builder.max_desc_l, **dd.assemble_kwargs)
        else:
            if self.prebuilt is not None and self._eval_prebuilt_key != id(eval_rows):
                # eval rows recur every epoch: cache them like the train rows
                self._eval_prebuilt = self._load_or_build_prebuilt(
                    "eval_prebuilt.pkl", eval_rows, eval_labels=False)
                self._eval_prebuilt_key = id(eval_rows)
            make_batch = lambda idx: self._put(self._build([eval_rows[i] for i in idx]))
        # every batch in order, the last one smaller (drop_last=False)
        for lo in range(0, n, self.s.bsz):
            idx = np.arange(lo, min(lo + self.s.bsz, n))
            for k, v in self._eval_loss(idx, make_batch, lw, neg_upper).items():
                meters[k].update(v)
        if self.device_data is not None:
            gather.check_indices(self.device)
        return {k: m.avg for k, m in meters.items()}
