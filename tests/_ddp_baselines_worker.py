"""Data-parallel baseline runs shared by tests/test_torch_ddp_baselines.py
and the processes it spawns: the baseline CLIs' own worlds, builders and
trainers at tiny widths, trained on one process (the global batch) or as
one rank of a gloo group on the CPU. Imports only torch and the port, so
a spawned rank starts quickly."""
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from tvretrieval_tpu_torch.models import mee as tm
from tvretrieval_tpu_torch.training import train_cal, train_excl, train_mee
from tvretrieval_tpu_torch.training.data_parallel import Shard

BSZ, STEPS = 8, 2
WORLD = ["--synthetic", "--device", "cpu", "--synthetic_videos", "10",
         "--synthetic_queries", "48", "--seed", "3", "--bsz", str(BSZ)]
_CAL = ["--visual_hidden_size", "16", "--output_size", "8", "--lstm_hidden_size", "12",
        "--max_ctx_l", "24", "--max_desc_l", "20", "--max_moment_clips", "8", "--lr", "0.02"]
RUNS = {
    "mee": (train_mee, ["--output_size", "8", "--lr", "1e-3"]),
    "cal": (train_cal, _CAL),
    "cal_lse": (train_cal, _CAL + ["--loss_type", "lse"]),
    "mcn": (train_cal, _CAL + ["--model_type", "mcn"]),
    "excl": (train_excl, ["--hidden_size", "16", "--max_ctx_l", "24", "--max_desc_l", "20",
                          "--drop", "0.5", "--lr", "1e-4"]),
}
# the MEE CLI end to end: one epoch of 4 steps, then its evaluation
MEE_CLI = WORLD + ["--n_epoch", "1", "--output_size", "8", "--eval_query_bsz", "12",
                   "--eval_ctx_bsz", "10", "--lr", "1e-3", "--exp_id", "dp"]
# MEE against jax.grad: the widths of tests/test_torch_baselines.py
DQ, DV, DS, OUT, LQ = 12, 10, 6, 8, 5


def train(kind: str, n_devices: int) -> dict:
    """STEPS steps of the CLI's trainer on the first BSZ * STEPS train rows
    of its synthetic world; the per-step losses and the state dict after
    them (parameters and MEE's BatchNorm buffers)."""
    module, flags = RUNS[kind]
    args = module.build_arg_parser().parse_args(WORLD + flags)
    train_rows, _, builder, _ = module.setup_world(args)
    tr = module.make_trainer(args, module.model_config(args, builder), builder,
                             train_rows[:BSZ * STEPS], "cpu", n_devices)
    tr.train_epoch(0)
    return dict(losses=tr.last_step_losses,
                state={k: v.clone() for k, v in tr.model.state_dict().items()})


def mee_config() -> tm.MEEConfig:
    return tm.MEEConfig(text_input_size=DQ, vid_input_size=DV, sub_input_size=DS,
                        output_size=OUT)


def mee_shard_grads(rank: int, world: int, state_dict, batch: dict) -> dict:
    """Train mode at ``state_dict``: every rank's share of the global
    batch's loss, its gradients summed over the ranks, and the running
    statistics after the forward."""
    model = tm.MEE(mee_config()).train()
    model.load_state_dict(state_dict)
    shard = Shard(rank, world)
    mine = {k: torch.from_numpy(np.ascontiguousarray(v[shard.rows(len(v))]))
            for k, v in batch.items()}
    loss = model(**mine, shard=shard)
    loss.backward()
    grads = {}
    for k, p in model.named_parameters():
        grads[k] = p.grad.clone()
        dist.all_reduce(grads[k])
    total = loss.detach().clone()
    dist.all_reduce(total)
    return dict(loss=float(total), grads=grads,
                state={k: v.clone() for k, v in model.state_dict().items()})


def mee_cli(results_root: str) -> list:
    """train_mee's CLI; the train scalars it logged."""
    out = train_mee.start_training(MEE_CLI + ["--results_root", results_root])
    with open(os.path.join(out["results_dir"], "metrics.jsonl")) as f:
        return [rec for rec in map(json.loads, f) if "train/loss" in rec]


def run_rank(rank: int, world: int, port: int, job: dict, out_dir: str) -> None:
    """One gloo rank: every run of ``job``; rank 0 saves the results."""
    torch.set_num_threads(1)
    sys.modules["torch.utils.tensorboard"] = None    # the CLI's logger writes its jsonl alone
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        res = {kind: train(kind, world) for kind in job["train"]}
        res["mee_grads"] = mee_shard_grads(rank, world, **job["mee_grads"])
        res["mee_cli"] = mee_cli(job["cli_root"])
        if rank == 0:
            torch.save(res, os.path.join(out_dir, f"world{world}.pt"))
    finally:
        dist.destroy_process_group()
