"""Generic training loop for the baseline models (MEE / CAL / ExCL).

Port of tvretrieval_tpu/training/generic.py. One optimizer step per batch;
host-built batches on a background thread (the port's
``DevicePrefetcher``, one worker, so a builder that draws from its own
generator, as CAL's does, draws in batch order); the JAX package's
``BatchIterator`` shuffle, epoch by epoch. The per-model loss is injected as

    loss_apply(model, batch, generator, train, shard) -> (loss, aux_dict)

where ``generator`` is the trainer's ``torch.Generator`` on the model's
device (dropout, ExCL), ``train`` is True and ``shard`` the rank's
``data_parallel.Shard``. Model state that a step changes besides the
parameters (MEE's BatchNorm running statistics) lives in module buffers,
which the forward updates in ``model.train()``; the JAX contract returns
it as ``new_model_state`` instead.

Learning rate: ``lr_multiplier(update_count)`` scales the optimizer's base
rate per update, counted as optax counts a schedule (0 for the first
update). Losses stay on the device until the epoch ends (no per-step host
sync), as the JAX loop keeps them.

Data-parallel (``n_devices`` k > 1, one process per device under an
initialised group of k ranks; training/data_parallel.py): like the JAX
trainer's step on a k-device mesh, a step computes the GLOBAL-batch
function. Every rank builds the whole global batch one process would build
and keeps its rows r * b ... (r + 1) * b - 1 (CAL's builder draws every
negative from one generator in row order, so a builder of the rank's rows
alone would draw others); ``loss_apply`` returns the rank's share of the
global loss (MEE: BatchNorm over the global batch and the in-batch loss
over the global confusion matrix; CAL and ExCL: per-row means as shares;
ExCL's dropout masks drawn for the global batch); gradients and loss
shares are summed in one all-reduce before the optimizer step. Rank 0's
initial weights are sent to every rank.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch
from torch import nn

from tvretrieval_tpu_torch.data.pipeline import BatchIterator, DevicePrefetcher
from tvretrieval_tpu_torch.training.data_parallel import (
    Shard,
    all_reduce_grads,
    broadcast_module,
    group_rank,
)
from tvretrieval_tpu_torch.utils.device import require_device  # noqa: F401 (the CLIs' import)
from tvretrieval_tpu_torch.utils.io import AverageMeter


def staircase_decay(transition_steps: int, decay_rate: float) -> Callable[[int], float]:
    """optax ``exponential_decay(..., staircase=True)`` as a multiplier of
    the base rate: ``decay_rate ** (count // transition_steps)``."""
    return lambda count: decay_rate ** (count // transition_steps)


def default_loss_apply(model, batch, generator, train, shard: Shard = Shard()):
    """Models whose forward takes the batch, a dropout generator and the
    rank's shard and returns (loss, aux) of the rank's share (ExCL)."""
    return model(**batch, generator=generator, shard=shard)


class GenericTrainer:
    def __init__(self, model: nn.Module,
                 optimizer_fn: Callable[[Iterable[nn.Parameter]], torch.optim.Optimizer],
                 build_fn: Callable[[List[dict]], Dict[str, np.ndarray]],
                 train_rows: List[dict], bsz: int, seed: int = 2018,
                 loss_apply: Optional[Callable] = None,
                 lr_multiplier: Optional[Callable[[int], float]] = None,
                 device="cuda", n_devices: int = 1):
        """``model``: a module with ``init_weights(generator)``; it is
        initialized from ``seed`` and moved to ``device``. n_devices > 1:
        this process is one rank of a data-parallel group of that size,
        which must be initialised (``torch.distributed.init_process_group``)."""
        self.shard = Shard(group_rank(n_devices, bsz), n_devices)
        self.device = torch.device(device)
        self.model = model.init_weights(torch.Generator().manual_seed(seed)).to(self.device)
        self.broadcast_weights()
        self.optimizer = optimizer_fn(self.model.parameters())
        self.scheduler = (torch.optim.lr_scheduler.LambdaLR(self.optimizer, lr_multiplier)
                          if lr_multiplier is not None else None)
        self.build_fn = build_fn
        self.train_rows = train_rows
        self.bsz = bsz
        self.seed = seed
        self.loss_apply = loss_apply or default_loss_apply
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.steps_per_epoch = max(len(train_rows) // bsz, 1)
        self.global_step = 0
        self.last_step_losses: List[Dict[str, float]] = []

    def broadcast_weights(self) -> None:
        """Rank 0's parameters and buffers on every rank (after init, and
        after a warm start loads weights)."""
        if self.shard.world > 1:
            broadcast_module(self.model)

    def _build(self, rows: List[dict]) -> Dict[str, np.ndarray]:
        """The global batch of ``rows`` as one process builds it; this
        rank's rows of it."""
        batch = self.build_fn(rows)
        if self.shard.world == 1:
            return batch
        mine = self.shard.rows(len(rows))
        return {k: v[mine] for k, v in batch.items()}

    def _put(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def train_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One optimizer step on this rank's rows; returns the detached
        global losses, on the device."""
        self.model.train()
        loss, aux = self.loss_apply(self.model, batch, self.generator, True, self.shard)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        out = {**{k: v.detach() for k, v in aux.items()}, "loss": loss.detach()}
        if self.shard.world > 1:
            # the sums are the global batch's gradient and losses
            summed = all_reduce_grads(self.model.parameters(),
                                      torch.stack([v.float() for v in out.values()]))
            out = dict(zip(out, summed))
        self.optimizer.step()
        if self.scheduler is not None:
            self.scheduler.step()
        self.global_step += 1
        return out

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        it = BatchIterator(self.train_rows, self.bsz, shuffle=True, drop_last=True,
                           seed=self.seed)
        it.epoch = epoch
        prefetch = DevicePrefetcher(it, build_fn=self._build, put_fn=self._put)
        step_losses = [self.train_step(batch) for batch in prefetch]
        # one copy to the host for the epoch
        keys = list(step_losses[0]) if step_losses else []
        host = (torch.stack([torch.stack([rec[k].float() for k in keys])
                             for rec in step_losses]).cpu().tolist() if keys else [])
        self.last_step_losses = [dict(zip(keys, row)) for row in host]
        meters: Dict[str, AverageMeter] = {}
        for rec in self.last_step_losses:
            for k, v in rec.items():
                meters.setdefault(k, AverageMeter()).update(v)
        return {k: m.avg for k, m in meters.items()}
