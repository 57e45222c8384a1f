"""The flagship XML's forward step with example inputs.

Port of ``__graft_entry__.py::entry``. ``entry()`` returns ``(fn, args)``:
``fn(*args)`` is the eval-mode training loss of the flagship XML at full
width (``video_sub``, inputs 3,074 / 770 / 768, hidden 256, 4 heads, 100
clips, 30 words) on a batch of 8, with ``lw_st_ed=0.01`` and
``neg_sample_upper=8``. ``args[0]`` is the model's parameters as a state
dict, applied with ``torch.func.functional_call``, so that other weights
(e.g. the JAX package's, through ``convert.flax_params_to_state_dict``)
can be passed in their place. The inputs are drawn from
``numpy.random.default_rng(0)`` in the JAX function's order, so both
functions see the same batch; the weights are seeded here
(``XML.init_weights``).

``dryrun_multichip(n)`` is the port of ``__graft_entry__.py::dryrun_multichip``:
data-parallel XML training on n ranks (a host-path epoch and a
device-resident epoch, float8 corpus) and one corpus-sharded scoring call
on an n-shard mesh, at a tiny size.

Usage:
    from tvretrieval_tpu_torch.entry import entry, dryrun_multichip
    fn, args = entry()            # on the CUDA card; entry(device="cpu") on the CPU
    loss = fn(*args)
    dryrun_multichip(2, device="cpu")

Both run on the CUDA card unless ``device="cpu"`` is given, and exit at
once when there is no card.
"""
from __future__ import annotations

import math
import os
import socket
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from tvretrieval_tpu_torch.models.xml import XML, XMLConfig

B = 8


def entry(device=None):
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("entry: no CUDA device is available; pass device='cpu' to run "
                         "on the CPU")
    cfg = XMLConfig(ctx_mode="video_sub", visual_input_size=3074, sub_input_size=770,
                    query_input_size=768, hidden_size=256, n_heads=4, max_ctx_l=100,
                    max_desc_l=30)
    model = XML(cfg).init_weights(torch.Generator().manual_seed(0)).eval().to(dev)

    rng = np.random.default_rng(0)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    batch = dict(
        query_feat=f32(rng.normal(size=(B, 30, 768))),
        query_mask=f32(np.ones((B, 30))),
        video_feat=f32(rng.normal(size=(B, 100, 3074))),
        video_mask=f32(np.ones((B, 100))),
        sub_feat=f32(rng.normal(size=(B, 100, 770))),
        sub_mask=f32(np.ones((B, 100))),
        st_ed_indices=torch.from_numpy(rng.integers(0, 50, size=(B, 2)).astype(np.int32)).to(dev),
    )

    def forward(params, query_feat, query_mask, video_feat, video_mask, sub_feat, sub_mask,
                st_ed_indices, neg_ranks=None):
        """The eval-mode loss; ``neg_ranks`` as in ``XML.forward``."""
        loss, _ = torch.func.functional_call(
            model, params, (query_feat, query_mask, video_feat, video_mask, sub_feat,
                            sub_mask, st_ed_indices),
            dict(lw_st_ed=0.01, neg_sample_upper=8, neg_ranks=neg_ranks))
        return loss

    params = {k: v.detach() for k, v in model.state_dict().items()}
    return forward, (params, *batch.values())


def _dryrun_world(n_devices: int):
    """The JAX dry run's world, builder and model config (8 videos, hidden 16)."""
    from tvretrieval_tpu_torch.data.datasets import ExampleBuilder
    from tvretrieval_tpu_torch.data.synthetic import make_synthetic_world

    world = make_synthetic_world(n_videos=8, n_queries=4 * n_devices, vid_dim=16,
                                 text_dim=8, max_clips=8, seed=0)
    builder = ExampleBuilder(query_source=world.query_source,
                             video_source=world.video_source, sub_source=world.sub_source,
                             ctx_mode="video_sub_tef", max_desc_l=8, max_ctx_l=8,
                             clip_length=world.clip_length)
    cfg = XMLConfig(ctx_mode="video_sub", visual_input_size=builder.video_source.dim + 2,
                    sub_input_size=builder.sub_source.dim + 2,
                    query_input_size=builder.query_source.dim, hidden_size=16, n_heads=4,
                    max_ctx_l=8, max_desc_l=8)
    return world, builder, cfg


def _dryrun_rank(rank: int, n_devices: int, port: int, devices, backend: str,
                 out_path: str) -> None:
    """One rank of the dry run: a host-path epoch and a device-resident
    epoch of data-parallel training; rank 0 saves the losses and weights."""
    from tvretrieval_tpu_torch.data.device_corpus import build_device_data
    from tvretrieval_tpu_torch.training.xml_trainer import TrainSettings, XMLTrainer

    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=n_devices, rank=rank)
    try:
        dev = torch.device(devices[rank])
        world, builder, cfg = _dryrun_world(n_devices)
        settings = TrainSettings(lr=1e-4, n_epoch=1, bsz=2 * n_devices, seed=0,
                                 prefetch_workers=1)
        trainer = XMLTrainer(cfg, settings, builder, world.annotations, device=dev,
                             n_devices=n_devices)
        losses = trainer.train_epoch(0)
        dd = build_device_data(builder, world.corpus, world.annotations,
                               world.annotations[:3], dtype_name="float8_e4m3fn", device=dev)
        dd_trainer = XMLTrainer(cfg, TrainSettings(lr=1e-4, n_epoch=1, bsz=2 * n_devices,
                                                   seed=0, scan_steps=2, prefetch_workers=1),
                                builder, world.annotations, device_data=dd, device=dev,
                                n_devices=n_devices)
        dd_losses = dd_trainer.train_epoch(0)
        if rank == 0:
            torch.save(dict(train=losses, device_data=dd_losses,
                            state_dict={k: v.cpu() for k, v in
                                        trainer.model.state_dict().items()}), out_path)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """One data-parallel XML epoch on the host path, one on the
    device-resident path (both two steps of batch 2 * n_devices), each on
    n_devices ranks under torch.distributed, then one corpus-sharded
    scoring call with the trained weights on an n_devices-shard mesh.

    device None / "cuda": cuda:0 ... cuda:n-1, NCCL (raises with fewer
    cards); a device name such as "cpu" or "cuda:0": n logical shards and
    ranks on it, gloo. Returns {"train", "device_data": per-epoch losses,
    "sharded": output shapes}; raises if a loss or score is not finite."""
    from tvretrieval_tpu_torch.parallel.mesh import make_mesh
    from tvretrieval_tpu_torch.parallel.sharded_retrieval import (
        score_query_batch_sharded,
        shard_corpus_cache,
    )
    from tvretrieval_tpu_torch.retrieval.engine import RetrievalConfig, encode_corpus
    import torch.multiprocessing as mp

    if device in (None, "cuda"):
        if not torch.cuda.is_available():
            raise SystemExit("dryrun_multichip: no CUDA device is available; pass "
                             "device='cpu' to run on the CPU")
        mesh = make_mesh(n_devices)
    else:
        mesh = make_mesh(n_devices, devices=[device] * n_devices)
    distinct = len(set(mesh.devices)) == mesh.size
    backend = "nccl" if distinct and mesh.devices[0].type == "cuda" else "gloo"
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "rank0.pt")
        mp.start_processes(_dryrun_rank, nprocs=n_devices, join=True, start_method="spawn",
                           args=(n_devices, port, [str(d) for d in mesh.devices], backend,
                                 out_path))
        res = torch.load(out_path)
    for name in ("train", "device_data"):
        bad = {k: v for k, v in res[name].items() if not math.isfinite(v)}
        if bad:
            raise AssertionError(f"{name}: non-finite losses {bad}")

    world, builder, cfg = _dryrun_world(n_devices)
    model = XML(cfg).eval().to(mesh.devices[0])
    model.load_state_dict(res["state_dict"])
    rcfg = RetrievalConfig(max_vcmr_video=4, max_before_nms=16, min_pred_l=1, max_pred_l=6,
                           context_bsz=8, query_bsz=4)
    cache = shard_corpus_cache(encode_corpus(model, builder, world.corpus, rcfg), mesh, rcfg)
    qb = builder.build_query_batch(world.annotations[:4])
    on = lambda a: torch.from_numpy(a).to(mesh.devices[0])
    out = score_query_batch_sharded(
        model, rcfg, on(qb.query_feat), on(qb.query_mask), cache.video_feat1,
        cache.video_feat2, cache.sub_feat1, cache.sub_feat2, cache.mask,
        torch.arange(4) % len(world.corpus), True, mesh)
    for k, v in out.items():
        if v.is_floating_point() and not bool(torch.isfinite(v).all()):
            raise AssertionError(f"sharded {k}: non-finite values")
    return dict(train=res["train"], device_data=res["device_data"],
                sharded={k: tuple(v.shape) for k, v in out.items()})
