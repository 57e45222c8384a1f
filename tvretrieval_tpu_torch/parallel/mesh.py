"""A 1-D device mesh and its two shardings, in PyTorch.

Port of tvretrieval_tpu/parallel/mesh.py. The JAX mesh is a grid of
devices under one controller; here a ``Mesh`` is a tuple of explicit
``torch.device``s on the axis "data", and a tensor sharded over it is a
tuple holding one tensor per shard, each on its shard's device, in shard
order. There are two users:

  * corpus-sharded serving and streaming (``parallel.sharded_retrieval``,
    ``retrieval.streaming``) run all shards from one process, as
    ``shard_map`` does: the corpus's video axis is split over the mesh, and
    the collectives are copies of small tensors to the first device;
  * data-parallel training (``training.xml_trainer``) runs one process per
    device under ``torch.distributed`` instead, each process holding its
    rows of the global batch.

A mesh may name one device several times: ``make_mesh(4,
devices=["cuda:0"] * 4)`` is four logical shards on one card (the twin of
XLA's virtual host devices), and ``devices=["cpu"] * k`` is what the CPU
tests use. Nothing falls back: asking for more cards than there are
raises.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

DeviceLike = Union[str, int, torch.device]


@dataclass(frozen=True)
class Mesh:
    """``devices``: one ``torch.device`` per shard, in shard order."""

    devices: Tuple[torch.device, ...]
    axis_name: str = "data"

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis_name: self.size}


@dataclass(frozen=True)
class Sharding:
    """How a tensor lies on a mesh: axis 0 split into ``mesh.size`` equal
    parts, one per shard (``split``), or a whole copy on every shard."""

    mesh: Mesh
    split: bool

    def put(self, x: torch.Tensor, non_blocking: bool = False) -> Tuple[torch.Tensor, ...]:
        """x -> one tensor per shard on its device (``jax.device_put``)."""
        k = self.mesh.size
        if not self.split:
            return tuple(x.to(d, non_blocking=non_blocking) for d in self.mesh.devices)
        n = x.shape[0]
        if n % k:
            raise ValueError(f"axis 0 of length {n} does not split into {k} equal shards")
        return tuple(part.to(d, non_blocking=non_blocking)
                     for part, d in zip(torch.split(x, n // k), self.mesh.devices))


def _device(d: DeviceLike) -> torch.device:
    return torch.device(f"cuda:{d}" if isinstance(d, int) else d)


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence[DeviceLike]] = None,
              axis_name: str = "data") -> Mesh:
    """A mesh of ``n_devices`` shards. Without ``devices``: cuda:0 ...
    cuda:n-1 (every card when n_devices is None); it raises when there is
    no card or fewer cards than n_devices. With ``devices``: its first
    n_devices entries (all when None), which may repeat a device; a CUDA
    device must exist."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = count if n_devices is None else n_devices
        if count == 0 or n > count:
            raise ValueError(f"a mesh of {n} devices needs {n} CUDA cards, found {count}; "
                             "name the devices (devices=[...]) for logical shards or the CPU")
        devices = range(n)
    devs = tuple(_device(d) for d in devices)
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(f"n_devices={n_devices} but only {len(devs)} devices named")
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    for d in devs:
        if d.type == "cuda":
            if not torch.cuda.is_available():
                raise ValueError(f"{d} named but no CUDA card is available")
            if (d.index or 0) >= torch.cuda.device_count():
                raise ValueError(f"{d} named but there are {torch.cuda.device_count()} cards")
    return Mesh(devs, axis_name)


def batch_sharding(mesh: Mesh, axis_name: str = "data") -> Sharding:
    """Shard axis 0 (batch or corpus-video axis) across the mesh."""
    if axis_name != mesh.axis_name:
        raise ValueError(f"the mesh's axis is {mesh.axis_name!r}, not {axis_name!r}")
    return Sharding(mesh, split=True)


def replicate_sharding(mesh: Mesh) -> Sharding:
    """A whole copy on every shard."""
    return Sharding(mesh, split=False)


def shard_batch(batch: dict, mesh: Mesh, axis_name: str = "data") -> dict:
    """Every tensor of the dict split on axis 0 over the mesh: {key: tuple
    of per-shard tensors}; raises when an axis does not divide."""
    sharding = batch_sharding(mesh, axis_name)
    return {k: sharding.put(torch.as_tensor(v)) for k, v in batch.items()}
