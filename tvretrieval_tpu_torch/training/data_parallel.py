"""Data-parallel plumbing shared by the trainers and their CLIs.

One process per device under an initialised ``torch.distributed`` group
of k ranks (NCCL on cards, gloo on the CPU). A step computes the
GLOBAL-batch function, as a step of the JAX trainers on a k-device mesh
does: rank r holds rows r * b ... (r + 1) * b - 1 of the global batch
(b = bsz / k), computes its share of the global loss (the shares sum to
the global loss), and the gradients and loss shares are summed over the
ranks in one all-reduce before the optimizer step. No DDP wrapper: its
gradient average would divide the summed shares by k a second time.

Here: the collectives with autograd that a share needs (``gather_rows``:
every rank's rows; ``all_reduce_sum``: a sum over the ranks, used by
MEE's BatchNorm for the global batch's moments), the one all-reduce of a
step (``all_reduce_grads``), the checks a trainer makes of its group
(``group_rank``), rank 0's weights sent to every rank
(``broadcast_module``), and what a training CLI needs to run as k ranks:
joining the group that is initialised or that torchrun describes, or
starting k ranks on this host (``join_or_spawn``), the rank's device
(``rank_device``), and rank 0's decisions sent to the others
(``rank0_says``).
"""
from __future__ import annotations

import os
import pickle
import socket
import tempfile
from dataclasses import dataclass
from typing import Callable, Iterable, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn


def _wide(dtype: torch.dtype) -> torch.dtype:
    """Sub-f32 tensors travel as f32, which holds them exactly."""
    return dtype if dtype in (torch.float32, torch.float64) else torch.float32


class _GatherRows(torch.autograd.Function):
    """Every rank's (b, ...) tensor concatenated on axis 0 in rank order,
    with autograd: the gradient of each rank's rows is the sum over the
    ranks of the gradient of those rows, an all-reduce of the whole
    gradient of which each rank keeps its slice (gloo has no CUDA
    reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, rank: int, world: int):
        ctx.rank, ctx.b = rank, x.shape[0]
        mine = x.to(_wide(x.dtype)).contiguous()
        parts = [torch.empty_like(mine) for _ in range(world)]
        dist.all_gather(parts, mine)
        return torch.cat(parts).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        g = grad.to(_wide(grad.dtype), copy=True).contiguous()
        dist.all_reduce(g)
        return g[ctx.rank * ctx.b:(ctx.rank + 1) * ctx.b].to(grad.dtype), None, None


def gather_rows(x: torch.Tensor, rank: int, world: int) -> torch.Tensor:
    """Every rank's rows of ``x`` in rank order, with autograd
    (``XML.forward_shard``'s ``gather``)."""
    return _GatherRows.apply(x, rank, world)


class _AllReduceSum(torch.autograd.Function):
    """The sum of ``x`` over the ranks, with autograd: every rank's loss
    share depends on the sum, so the gradient of a rank's ``x`` is the sum
    over the ranks of the gradient of the sum."""

    @staticmethod
    def forward(ctx, x):
        out = x.to(_wide(x.dtype), copy=True).contiguous()
        dist.all_reduce(out)
        return out.to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        g = grad.to(_wide(grad.dtype), copy=True).contiguous()
        dist.all_reduce(g)
        return g.to(grad.dtype)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    return _AllReduceSum.apply(x)


@dataclass(frozen=True)
class Shard:
    """This rank's place in a data-parallel step, handed to a baseline's
    loss: ``Shard()`` is one process on the whole batch, where both
    collectives return their input."""

    rank: int = 0
    world: int = 1

    def gather(self, x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """Every rank's rows of ``x`` (None stays None)."""
        return x if self.world == 1 or x is None else gather_rows(x, self.rank, self.world)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.world == 1 else all_reduce_sum(x)

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n`` rows."""
        b = n // self.world
        return slice(self.rank * b, (self.rank + 1) * b)


def group_rank(n_devices: int, bsz: int) -> int:
    """This process's rank in a data-parallel step over ``n_devices``:
    raises ValueError when the batch does not split and RuntimeError when
    k > 1 without an initialised group of k ranks."""
    if bsz % n_devices:
        raise ValueError(f"bsz {bsz} not divisible by {n_devices} devices")
    if n_devices == 1:
        return 0
    if not (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() == n_devices):
        raise RuntimeError(
            f"n_devices={n_devices}: data-parallel training runs one process per "
            f"device; initialise torch.distributed with {n_devices} ranks first "
            "(the training CLIs start them)")
    return dist.get_rank()


def broadcast_module(module: nn.Module) -> None:
    """Rank 0's parameters and buffers on every rank."""
    for t in module.state_dict().values():
        dist.broadcast(t, 0)


def all_reduce_grads(params: Iterable[nn.Parameter], losses: torch.Tensor) -> torch.Tensor:
    """One all-reduce of every gradient and the loss shares ``losses``
    (a 1-D float32 tensor); the gradients are replaced by their sums, and
    the summed losses returned."""
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1).float() for g in grads] + [losses])
    dist.all_reduce(flat)
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()
    return flat[off:]


# ------------------------------------------------------------- the CLIs
def backend_for(device: str) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def under_torchrun() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def _rank_worker(rank: int, target: Callable[[List[str]], dict], argv: List[str], world: int,
                 port: int, backend: str, result_path: str) -> None:
    """One rank: join the group, run ``target(argv)``, and on rank 0 leave
    its result for the parent."""
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        out = target(argv)
        if rank == 0:
            with open(result_path, "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn_ranks(target: Callable[[List[str]], dict], argv: List[str], n: int,
                backend: str) -> dict:
    """Run ``target(argv)`` (a module-level function) as ``n`` ranks of a
    group on localhost; returns rank 0's result."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        result_path = os.path.join(tmp, "rank0.pkl")
        mp.start_processes(_rank_worker,
                           args=(target, list(argv), n, free_port(), backend, result_path),
                           nprocs=n, join=True, start_method="spawn")
        with open(result_path, "rb") as f:
            return pickle.load(f)


def join_or_spawn(target: Callable[[List[str]], dict], argv: List[str], device: str,
                  n: int) -> Optional[dict]:
    """For a CLI about to train on ``n`` ranks: None when this process is
    to train (n = 1; or a rank of the group that is initialised, or that
    torchrun describes, which it then joins); else starts ``n`` ranks of
    ``target(argv)`` here and returns rank 0's result. ``argv`` should
    name the run directory, so that every rank names the same one."""
    if n <= 1 or dist.is_initialized():
        return None
    if under_torchrun():
        dist.init_process_group(backend_for(device))
        return None
    return spawn_ranks(target, argv, n, backend_for(device))


def rank_device(device: str, world: int) -> Tuple[int, torch.device]:
    """(rank, device) of this process in a group of ``world`` ranks: on
    cards rank r takes cuda:r; on the CPU the ranks share the host's
    cores instead of each taking all of them."""
    dev = torch.device(device)
    if world == 1:
        return 0, dev
    rank = dist.get_rank()
    if dev.type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    else:
        if rank >= torch.cuda.device_count():
            raise ValueError(f"rank {rank} needs cuda:{rank}; there are "
                             f"{torch.cuda.device_count()} cards")
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)        # NCCL's own work goes to the rank's card
    return rank, dev


def rank0_says(flag: bool, world: int, device) -> bool:
    """Rank 0's flag on every rank; the other ranks wait here while rank 0
    evaluates and writes."""
    if world == 1:
        return flag
    t = torch.tensor([float(flag)], device=device)
    dist.broadcast(t, 0)
    return bool(t.item())


def baseline_world(device: str, bsz: int) -> int:
    """How many ranks a baseline CLI trains on (the JAX GenericTrainer
    fits its data mesh to every local device that divides the batch):
    the initialised group's size, or torchrun's; else with ``cuda`` every
    card, lowered until it divides ``bsz``; else (the CPU) 1."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    if under_torchrun():
        return int(os.environ["WORLD_SIZE"])
    if torch.device(device).type != "cuda":
        return 1
    k = max(torch.cuda.device_count(), 1)
    while bsz % k:
        k -= 1
    return k
