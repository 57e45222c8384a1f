"""BertAdam: the reference's vendored BERT optimizer, as a torch optimizer.

Port of tvretrieval_tpu/training/optimization.py (reference
baselines/crossmodal_moment_localization/optimization.py:219-338):

* Adam moments WITHOUT bias correction;
* decoupled weight decay added to the update (not the gradient);
* per-parameter-tensor gradient-norm clipping (default max 1.0) applied
  BEFORE the moment update;
* LR multiplier schedules over progress = step / t_total, warmup_linear by
  default, with ``step`` counted before the increment;
* no weight decay for biases and LayerNorm parameters (train.py:152-156).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional

import torch
from torch import nn


def make_lr_multiplier(schedule: Optional[str] = "warmup_linear", warmup: float = 0.01,
                       t_total: int = -1) -> Callable[[int], float]:
    """Step -> LR multiplier in [0, 1] (reference _LRSchedule.get_lr).
    Progress is taken in float32, as the JAX package takes it, so the
    warm-up knee falls on the same step."""
    f32 = torch.float32
    knee = float(torch.tensor(warmup, dtype=f32))

    def fn(step: int) -> float:
        if t_total < 0:
            return 1.0
        progress = float(torch.tensor(step, dtype=f32) / float(t_total))
        if schedule in (None, "none", "constant"):
            return 1.0
        if schedule == "warmup_constant":
            return progress / warmup if progress < knee else 1.0
        if schedule == "warmup_linear":
            if progress < knee:
                return progress / max(warmup, 1e-9)
            return max((progress - 1.0) / (warmup - 1.0), 0.0)
        if schedule == "warmup_cosine":
            if progress < knee:
                return progress / max(warmup, 1e-9)
            return 0.5 * (1.0 + math.cos(math.pi * (progress - warmup) / (1 - warmup)))
        raise ValueError(f"unknown schedule {schedule}")

    return fn


def no_decay_mask(module: nn.Module) -> Dict[str, bool]:
    """Parameter name -> True where weight decay applies. Excludes biases
    (a recurrent cell's ``bias_ih_l0`` / ``bias_hh_l0`` too, as flax's
    gate biases are ``bias``) and LayerNorm weight / bias (the port's
    LayerNorms are named ``ln`` or ``*_ln``, as the flax modules are),
    matching the reference's no_decay list (train.py:152-156)."""

    def decay(name: str) -> bool:
        keys = name.split(".")
        if keys[-1] == "bias" or keys[-1].startswith("bias_"):
            return False
        return not any(k == "ln" or k.endswith("_ln") for k in keys)

    return {name: decay(name) for name, _ in module.named_parameters()}


def ema_init(module: nn.Module) -> Dict[str, torch.Tensor]:
    """Shadow copy for an exponential moving average of the parameters
    (reference optimization.py:183-216 EMA.register)."""
    return {k: p.detach().clone() for k, p in module.named_parameters()}


@torch.no_grad()
def ema_update(shadow: Dict[str, torch.Tensor], module: nn.Module,
               decay: float = 0.999, step: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """shadow <- d * shadow + (1 - d) * params, in place, with the
    reference's warm-up ramp d = min(decay, (1 + step) / (10 + step))
    (EMA.__call__, optimization.py:196-203)."""
    d = decay if step is None else min(decay, (1.0 + step) / (10.0 + step))
    for k, p in module.named_parameters():
        shadow[k].mul_(d).add_(p.detach(), alpha=1.0 - d)
    return shadow


class BertAdam(torch.optim.Optimizer):
    """The reference BertAdam. ``params`` is an iterable of parameters or
    of parameter groups; a group's ``weight_decay`` overrides the default
    (``param_groups_from_mask`` builds the decay / no-decay groups)."""

    def __init__(self, params: Iterable, lr: float, t_total: int = -1,
                 warmup: float = 0.01, schedule: str = "warmup_linear",
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
                 weight_decay: float = 0.01, max_grad_norm: float = 1.0):
        if lr < 0:
            raise ValueError(f"invalid learning rate {lr}")
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      weight_decay=weight_decay,
                                      max_grad_norm=max_grad_norm))
        self.lr_mult = make_lr_multiplier(schedule, warmup, t_total)
        # one counter for the whole optimizer, read before its increment
        self.state["step"] = 0

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        n = self.state["step"]
        mult = self.lr_mult(n)
        for group in self.param_groups:
            b1, b2, eps = group["b1"], group["b2"], group["eps"]
            wd, max_norm = group["weight_decay"], group["max_grad_norm"]
            step_size = group["lr"] * mult
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if max_norm > 0:
                    norm = torch.sqrt(torch.sum(torch.square(g)))
                    g = g * torch.clamp_max(max_norm / (norm + 1e-6), 1.0)
                st = self.state[p]
                if not st:
                    st["m"] = torch.zeros_like(p)
                    st["v"] = torch.zeros_like(p)
                m, v = st["m"], st["v"]
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).add_(g * g, alpha=1 - b2)
                u = m / (torch.sqrt(v) + eps)
                if wd > 0:
                    u = u + wd * p
                p.add_(u, alpha=-step_size)
        self.state["step"] = n + 1
        return loss


def param_groups_from_mask(module: nn.Module, mask: Optional[Dict[str, bool]],
                           weight_decay: float) -> list:
    """Two parameter groups for BertAdam: decayed and not (``mask`` from
    ``no_decay_mask``; None decays everything)."""
    named = list(module.named_parameters())
    if mask is None:
        return [{"params": [p for _, p in named], "weight_decay": weight_decay}]
    return [{"params": [p for k, p in named if mask[k]], "weight_decay": weight_decay},
            {"params": [p for k, p in named if not mask[k]], "weight_decay": 0.0}]
