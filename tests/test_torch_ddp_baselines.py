"""Data-parallel training of the baselines (training/generic.py with
n_devices = 2, training/data_parallel.py) against one process training on
the global batch, and MEE against ``jax.grad`` of the JAX package's
global-batch loss.

Two gloo ranks on the CPU, started once for the file
(``torch.multiprocessing``, tests/_ddp_baselines_worker.py), each build
the global batch of 8 one process builds and train on their 4 rows. What
is held:
- two optimizer steps of each CLI's trainer (MEE; CAL with the hinge and
  the log loss; MCN; ExCL with dropout on, its masks drawn for the global
  batch): the per-step losses and the state dict after them (parameters,
  MEE's BatchNorm running statistics) equal the single-process run's
  within 1e-5. Two kinds of parameter have no gradient but round-off,
  which Adam turns into steps of about its rate either way (as
  tests/test_torch_baselines.py says of MEE's): a bias right before MEE's
  train-mode BatchNorm (and the running mean, which averages it in) and
  the bias of ExCL's start / end logits (a shift the softmax ignores);
  they are held within Adam's largest move, 2 * lr a step;
- MEE's summed shard gradients at JAX's weights on a batch of 8 equal
  ``jax.grad`` of the JAX train-mode loss (``mutable=["batch_stats"]``, as
  the JAX train_mee's ``loss_apply``) within 2e-4 of each gradient's
  largest entry, the summed loss shares its loss, and the running
  statistics after the step JAX's new ``batch_stats``, within 1e-5;
- the MEE CLI inside the two ranks (``--synthetic --device cpu``, one
  epoch) logs one process's train loss;
- a batch that does not split over the ranks is refused, k > 1 without a
  process group raises, and ``--device cuda`` takes every card that
  divides ``--bsz``.
The JAX scan-LSTM is not compiled here: CAL and ExCL are held against the
port's own single process, which tests/test_torch_cal.py and
tests/test_torch_excl.py hold against JAX.
"""
import os
import sys

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import _ddp_baselines_worker as W
from _baseline_pairs import one_torch_thread  # noqa: F401
from tvretrieval_tpu.models import mee as jm
from tvretrieval_tpu_torch.convert import flax_params_to_state_dict, flax_variables_to_state_dict
from tvretrieval_tpu_torch.training import data_parallel as dp

TOL = 1e-5
N = 8                                   # MEE's global batch against JAX
# parameters whose gradient is round-off only (see the module docstring)
NO_GRADIENT = ("ContextGating_0.Dense_0.bias", "ContextGating_0.bn.running_mean",
               "_predictor.Dense_1.bias")


def _mee_batch(seed=0):
    rng = np.random.default_rng(seed)
    qm = (np.arange(W.LQ)[None] < rng.integers(1, W.LQ + 1, size=N)[:, None]).astype(np.float32)
    return dict(query_feat=rng.normal(size=(N, W.LQ, W.DQ)).astype(np.float32), query_mask=qm,
                video_feat=rng.normal(size=(N, W.DV)).astype(np.float32),
                sub_feat=rng.normal(size=(N, W.DS)).astype(np.float32))


@pytest.fixture(scope="module")
def jax_mee():
    """Seeded numpy variables in the JAX MEE's tree (off flax's init: unit
    BatchNorm scales perturbed, running statistics not fresh), a batch of
    8, and JAX's train-mode loss, gradients and new ``batch_stats``."""
    jcfg = jm.MEEConfig(text_input_size=W.DQ, vid_input_size=W.DV, output_size=W.OUT)
    batch = _mee_batch()
    shapes = jax.eval_shape(lambda b: jm.MEE(jcfg).init(jax.random.PRNGKey(0), **b), batch)
    rng = np.random.default_rng(1)

    def fill(path, leaf):
        name, n = path[-1].key, rng.standard_normal(leaf.shape).astype(np.float32)
        if name == "kernel":
            return n / np.sqrt(leaf.shape[0])
        if name in ("clusters", "clusters2"):
            return n / np.sqrt(W.DQ)
        if name == "scale":
            return 1.0 + 0.1 * n
        if name == "var":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return 0.1 * n

    variables = jax.tree_util.tree_map_with_path(fill, shapes)

    def loss_apply(params):
        loss, new_state = jm.MEE(jcfg).apply({**variables, "params": params}, **batch,
                                             train=True, mutable=["batch_stats"])
        return loss, new_state

    (loss, new_state), grads = jax.value_and_grad(loss_apply, has_aux=True)(
        variables["params"])
    new_stats = flax_variables_to_state_dict(
        {"params": variables["params"], **jax.device_get(new_state)})
    return dict(state_dict=flax_variables_to_state_dict(variables), batch=batch,
                loss=float(loss), grads=flax_params_to_state_dict(jax.device_get(grads)),
                stats={k: v for k, v in new_stats.items()
                       if k.endswith(("running_mean", "running_var"))})


@pytest.fixture(scope="module")
def two_ranks(jax_mee, tmp_path_factory):
    """Rank 0's results of every run of the two gloo ranks."""
    out = str(tmp_path_factory.mktemp("ddp_baselines"))
    job = {"train": list(W.RUNS), "cli_root": os.path.join(out, "cli"),
           "mee_grads": dict(state_dict=jax_mee["state_dict"], batch=jax_mee["batch"])}
    mp.start_processes(W.run_rank, args=(2, dp.free_port(), job, out), nprocs=2, join=True,
                       start_method="spawn")
    return torch.load(os.path.join(out, "world2.pt"))


def _lr(kind: str) -> float:
    flags = W.RUNS[kind][1]
    return float(flags[flags.index("--lr") + 1])


@pytest.mark.parametrize("kind", list(W.RUNS))
def test_two_ranks_train_like_one_process(two_ranks, kind):
    want, got = W.train(kind, 1), two_ranks[kind]
    assert len(want["losses"]) == len(got["losses"]) == W.STEPS
    for a, b in zip(want["losses"], got["losses"]):
        assert a.keys() == b.keys()
        for k in a:
            assert abs(a[k] - b[k]) <= TOL, (k, a[k], b[k])
    assert want["losses"][0]["loss"] != want["losses"][1]["loss"]
    assert want["state"].keys() == got["state"].keys()
    moved = 0.0
    for k, v in want["state"].items():
        err = float((v.double() - got["state"][k].double()).abs().max())
        bound = 2 * W.STEPS * _lr(kind) if k.endswith(NO_GRADIENT) else TOL
        assert err <= bound, (k, err, bound)
        if k.endswith(("running_mean", "running_var")):
            moved += 1
    if kind == "mee":
        assert moved == 2 * 5                  # NetVLAD's and four gated units' BatchNorms
        assert all(int(v) == W.STEPS for k, v in got["state"].items()
                   if k.endswith("num_batches_tracked"))


def test_mee_shard_gradients_match_jax_grad(jax_mee, two_ranks):
    got = two_ranks["mee_grads"]
    assert abs(got["loss"] - jax_mee["loss"]) <= TOL
    assert set(got["grads"]) == set(jax_mee["grads"])
    for k, g in got["grads"].items():
        want = jax_mee["grads"][k].numpy()
        scale = np.abs(want).max()
        if k.endswith("ContextGating_0.Dense_0.bias"):
            # train-mode BatchNorm subtracts the batch mean: round-off only
            assert scale < 1e-6 and float(g.abs().max()) < 1e-6, k
            continue
        assert scale > 1e-6, k
        assert np.abs(g.numpy() - want).max() <= 2e-4 * scale, k


def test_mee_running_statistics_match_jax_batch_stats(jax_mee, two_ranks):
    got, want = two_ranks["mee_grads"]["state"], jax_mee["stats"]
    assert len(want) == 2 * 5
    before = jax_mee["state_dict"]
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=TOL, err_msg=k)
        assert np.abs(v.numpy() - before[k].numpy()).max() > 1e-3, k


def test_mee_cli_in_two_ranks_logs_one_process_train_loss(two_ranks, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)   # jsonl alone
    want = W.mee_cli(str(tmp_path))
    got = two_ranks["mee_cli"]
    assert len(want) == len(got) == 1
    assert want[0]["step"] == got[0]["step"] == 36 // W.BSZ
    assert abs(want[0]["train/loss"] - got[0]["train/loss"]) <= TOL


def test_a_batch_that_does_not_split_and_a_missing_group_are_refused():
    module, flags = W.RUNS["mee"]
    args = module.build_arg_parser().parse_args(W.WORLD + flags)
    rows, _, builder, _ = module.setup_world(args)
    cfg = module.model_config(args, builder)
    with pytest.raises(ValueError, match="not divisible by 3"):
        module.make_trainer(args, cfg, builder, rows, "cpu", 3)
    with pytest.raises(RuntimeError, match="torch.distributed"):
        module.make_trainer(args, cfg, builder, rows, "cpu", 2)


@pytest.mark.parametrize("cards, bsz, k", [(1, 128, 1), (2, 128, 2), (3, 128, 2),
                                           (4, 12, 4), (4, 10, 2), (8, 7, 7)])
def test_cuda_takes_every_card_that_divides_the_batch(monkeypatch, cards, bsz, k):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert dp.baseline_world("cuda", bsz) == k
    assert dp.baseline_world("cpu", bsz) == 1
