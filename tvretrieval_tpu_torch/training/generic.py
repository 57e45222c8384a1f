"""Generic training loop for the baseline models (MEE / CAL / ExCL).

Port of tvretrieval_tpu/training/generic.py. One optimizer step per batch
on one device; host-built batches on a background thread (the port's
``DevicePrefetcher``, one worker, so a builder that draws from its own
generator, as CAL's does, draws in batch order); the JAX package's
``BatchIterator`` shuffle, epoch by epoch. The per-model loss is injected as

    loss_apply(model, batch, generator, train) -> (loss, aux_dict)

where ``generator`` is the trainer's ``torch.Generator`` on the model's
device (dropout, ExCL) and ``train`` is True. Model state that a step
changes besides the parameters (MEE's BatchNorm running statistics) lives
in module buffers, which the forward updates in ``model.train()``; the JAX
contract returns it as ``new_model_state`` instead.

Learning rate: ``lr_multiplier(update_count)`` scales the optimizer's base
rate per update, counted as optax counts a schedule (0 for the first
update). Losses stay on the device until the epoch ends (no per-step host
sync), as the JAX loop keeps them. Data-parallel training of the
baselines is ROADMAP A10c (XML's is in training/xml_trainer.py).
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch
from torch import nn

from tvretrieval_tpu_torch.data.pipeline import BatchIterator, DevicePrefetcher
from tvretrieval_tpu_torch.utils.device import require_device  # noqa: F401 (the CLIs' import)
from tvretrieval_tpu_torch.utils.io import AverageMeter


def staircase_decay(transition_steps: int, decay_rate: float) -> Callable[[int], float]:
    """optax ``exponential_decay(..., staircase=True)`` as a multiplier of
    the base rate: ``decay_rate ** (count // transition_steps)``."""
    return lambda count: decay_rate ** (count // transition_steps)


def default_loss_apply(model, batch, generator, train):
    """Models whose forward takes the batch and a dropout generator and
    returns (loss, aux) (ExCL)."""
    return model(**batch, generator=generator)


class GenericTrainer:
    def __init__(self, model: nn.Module,
                 optimizer_fn: Callable[[Iterable[nn.Parameter]], torch.optim.Optimizer],
                 build_fn: Callable[[List[dict]], Dict[str, np.ndarray]],
                 train_rows: List[dict], bsz: int, seed: int = 2018,
                 loss_apply: Optional[Callable] = None,
                 lr_multiplier: Optional[Callable[[int], float]] = None,
                 device="cuda", n_devices: int = 1):
        """``model``: a module with ``init_weights(generator)``; it is
        initialized from ``seed`` and moved to ``device``."""
        if n_devices != 1:
            raise NotImplementedError(
                f"n_devices={n_devices}: data-parallel training of the baselines is "
                "ROADMAP A10c")
        self.device = torch.device(device)
        self.model = model.init_weights(torch.Generator().manual_seed(seed)).to(self.device)
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

    def _put(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def train_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One optimizer step; returns the detached losses, on the device."""
        self.model.train()
        loss, aux = self.loss_apply(self.model, batch, self.generator, True)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        if self.scheduler is not None:
            self.scheduler.step()
        self.global_step += 1
        return {**{k: v.detach() for k, v in aux.items()}, "loss": loss.detach()}

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        it = BatchIterator(self.train_rows, self.bsz, shuffle=True, drop_last=True,
                           seed=self.seed)
        it.epoch = epoch
        prefetch = DevicePrefetcher(it, build_fn=self.build_fn, put_fn=self._put)
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
