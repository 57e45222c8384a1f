"""Data-parallel training runs shared by tests/test_torch_ddp.py and the
processes it spawns: the same tiny world, weights and injected negative
ranks, trained on one process (the global batch) or as one rank of a gloo
group on the CPU. Imports only torch and the port, so a spawned rank
starts quickly."""
import functools
import os

import numpy as np
import torch
import torch.distributed as dist

from tvretrieval_tpu_torch.data.datasets import ExampleBuilder
from tvretrieval_tpu_torch.data.device_corpus import build_device_data
from tvretrieval_tpu_torch.data.synthetic import make_synthetic_world
from tvretrieval_tpu_torch.models.xml import XML, XMLConfig
from tvretrieval_tpu_torch.training.xml_trainer import TrainSettings, XMLTrainer, gather_rows

BSZ, STEPS, N_EVAL = 8, 2, 13          # 13 eval rows: batches of 8 and a remainder of 5
MODEL = dict(ctx_mode="video_sub", hidden_size=16, n_heads=4, max_ctx_l=12, max_desc_l=16,
             input_drop=0.0, drop=0.0, cross_att_drop=0.0)


def world_and_builder():
    w = make_synthetic_world(n_videos=19, n_queries=BSZ * STEPS + N_EVAL, vid_dim=16,
                             text_dim=12, max_clips=12, seed=5)
    builder = ExampleBuilder(query_source=w.query_source, video_source=w.video_source,
                             sub_source=w.sub_source, ctx_mode="video_sub_tef",
                             max_desc_l=16, max_ctx_l=12, clip_length=w.clip_length)
    return w, builder


def model_config(builder) -> XMLConfig:
    return XMLConfig(visual_input_size=builder.video_source.dim + 2,
                     sub_input_size=builder.sub_source.dim + 2,
                     query_input_size=builder.query_source.dim, **MODEL)


def step_ranks(seed: int = 11):
    """(STEPS, 2, BSZ) injected (ctx, query) ranks of the global batches,
    in [1, BSZ): both packages draw their own, so the tests fix them."""
    return np.random.default_rng(seed).integers(1, BSZ, size=(STEPS, 2, BSZ))


def train(n_devices: int, device_data: bool) -> dict:
    """STEPS optimizer steps on the global batches, then the eval losses
    (their last batch a remainder that no rank count divides). Returns the
    per-step losses, the last step's (summed) gradients, the parameters and
    the eval losses, as CPU tensors / floats."""
    w, builder = world_and_builder()
    train_rows, eval_rows = w.annotations[:BSZ * STEPS], w.annotations[BSZ * STEPS:]
    s = TrainSettings(n_epoch=1, bsz=BSZ, seed=3, hard_negative_start_epoch=-1,
                      prefetch_workers=1, scan_steps=STEPS)
    dd = (build_device_data(builder, w.corpus, train_rows, eval_rows, dtype_name="float32",
                            device="cpu") if device_data else None)
    tr = XMLTrainer(model_config(builder), s, builder, train_rows, device_data=dd,
                    device="cpu", n_devices=n_devices)
    ranks = step_ranks()
    tr.neg_ranks_fn = lambda step, n, upper: tuple(torch.from_numpy(r) for r in ranks[step])
    tr.train_epoch(0)
    return dict(losses=tr.last_step_losses,
                grads={k: p.grad.clone() for k, p in tr.model.named_parameters()},
                params={k: v.clone() for k, v in tr.model.state_dict().items()},
                eval=tr.eval_loss_epoch(eval_rows, 0))


def shard_grads(rank: int, world: int, state_dict, batch: dict, ranks, lw: float) -> dict:
    """The summed gradients of every rank's share of the global-batch loss
    (eval mode: no dropout) at ``state_dict``, with the given global ranks."""
    _, builder = world_and_builder()
    m = XML(model_config(builder)).eval()
    m.load_state_dict(state_dict)
    b = len(batch["query_feat"]) // world
    mine = {k: torch.from_numpy(np.ascontiguousarray(v[rank * b:(rank + 1) * b]))
            for k, v in batch.items()}
    gather = functools.partial(gather_rows, rank=rank, world=world)
    loss, _ = m.forward_shard(**mine, gather=gather, rank=rank, world=world,
                              lw_st_ed=lw, neg_ranks=tuple(torch.from_numpy(r) for r in ranks))
    loss.backward()
    out = {}
    for k, p in m.named_parameters():
        g = p.grad.clone()
        dist.all_reduce(g)
        out[k] = g
    return out


def run_rank(rank: int, world: int, port: int, job: dict, out_dir: str) -> None:
    """One gloo rank: every run of ``job``; rank 0 saves the results."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        res = {name: train(world, **kw) for name, kw in job.get("train", {}).items()}
        if "grads" in job:
            res["grads"] = shard_grads(rank, world, **job["grads"])
        if rank == 0:
            torch.save(res, os.path.join(out_dir, f"world{world}.pt"))
    finally:
        dist.destroy_process_group()

