"""Data-parallel XML training (training/xml_trainer.py with n_devices = 2,
``XML.forward_shard``) against one process training on the global batch,
and against ``jax.grad`` of the JAX package's global-batch loss.

Two gloo ranks on the CPU, started once for the file
(``torch.multiprocessing``, tests/_ddp_worker.py), each build or assemble
their 4 rows of every batch of 8; dropout is off and the negative ranks of
each global batch are injected (the two packages draw their own). What is
held:
- two optimizer steps on the host path and on the device-resident path
  (float32 storage, B4's plain version): the per-step losses, the last
  step's summed gradients and the parameters after it equal the
  single-process run's within 1e-5, and so do the eval losses, whose last
  batch (5 rows) does not split over the ranks and runs whole on rank 0;
- the ranks' summed gradients of their loss shares on JAX's converted
  weights and a batch of 8 equal ``jax.grad`` of the JAX global-batch loss
  with the JAX ranks, within 2e-4 of each gradient's largest entry (the
  bound of tests/test_torch_xml_train.py), and the port's single-process
  gradient within 1e-5 of it;
- a batch that does not split over the ranks is refused, and
  ``entry.dryrun_multichip(2, device="cpu")`` trains and scores (its own
  two ranks) to finite values.
"""
import os
import socket

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import _ddp_worker as W
from tvretrieval_tpu.data.datasets import ExampleBuilder as JExampleBuilder
from tvretrieval_tpu.data.synthetic import make_synthetic_world as j_make_world
from tvretrieval_tpu.models import xml as jx
from tvretrieval_tpu_torch.convert import flax_params_to_state_dict
from tvretrieval_tpu_torch.entry import dryrun_multichip
from tvretrieval_tpu_torch.models.xml import XML
from tvretrieval_tpu_torch.training.xml_trainer import TrainSettings, XMLTrainer

TOL = 1e-5
LW = 0.5                        # weigh the span loss in


def _free_port():
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


@pytest.fixture(scope="module")
def jax_pair():
    """JAX weights (seeded, perturbed off flax's init) for both packages, a
    global batch of 8 and the ranks JAX draws for it."""
    w = j_make_world(n_videos=19, n_queries=W.BSZ, vid_dim=16, text_dim=12, max_clips=12,
                     seed=5)
    jb = JExampleBuilder(query_source=w.query_source, video_source=w.video_source,
                         sub_source=w.sub_source, ctx_mode="video_sub_tef", max_desc_l=16,
                         max_ctx_l=12, clip_length=w.clip_length)
    batch = jb.build_train_batch(w.annotations[:W.BSZ]).model_inputs()
    kw = {k: v for k, v in W.MODEL.items() if k not in ("input_drop", "drop", "cross_att_drop")}
    jm = jx.XML(jx.XMLConfig(visual_input_size=18, sub_input_size=14, query_input_size=28,
                             **kw))
    variables = jax.jit(lambda r, b: jm.init(r, **b, deterministic=True))(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
         "negatives": jax.random.PRNGKey(2)}, batch)
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(x.shape).astype(np.float32),
        jax.device_get(variables["params"]))
    k_ctx, k_q = jax.random.split(jax.random.PRNGKey(0))
    draw = lambda k: np.array(jax.random.randint(k, (W.BSZ,), 1, W.BSZ))
    ranks = (draw(k_ctx), draw(k_q))
    jgrads = flax_params_to_state_dict(jax.device_get(jax.grad(
        lambda p: jm.apply({"params": p}, **batch, lw_st_ed=LW, deterministic=True)[0])(
        params)))
    return flax_params_to_state_dict(params), batch, ranks, jgrads


@pytest.fixture(scope="module")
def two_ranks(jax_pair, tmp_path_factory):
    """Rank 0's results of every run of the two gloo ranks."""
    state_dict, batch, ranks, _ = jax_pair
    out = str(tmp_path_factory.mktemp("ddp"))
    job = {"train": {"host": dict(device_data=False), "device": dict(device_data=True)},
           "grads": dict(state_dict=state_dict, batch=batch, ranks=ranks, lw=LW)}
    mp.start_processes(W.run_rank, args=(2, _free_port(), job, out), nprocs=2, join=True,
                       start_method="spawn")
    return torch.load(os.path.join(out, "world2.pt"))


def _close(a: torch.Tensor, b: torch.Tensor, tol=TOL) -> bool:
    return float((a - b).abs().max()) <= tol


@pytest.mark.parametrize("path", ["host", "device"])
def test_two_ranks_train_like_one_process(two_ranks, path):
    torch.set_num_threads(1)
    want, got = W.train(1, device_data=path == "device"), two_ranks[path]
    assert len(want["losses"]) == len(got["losses"]) == W.STEPS
    for a, b in zip(want["losses"], got["losses"]):
        assert a.keys() == b.keys()
        for k in a:
            assert abs(a[k] - b[k]) <= TOL, (k, a[k], b[k])
    assert want["grads"].keys() == got["grads"].keys()
    for k in want["grads"]:
        assert float(want["grads"][k].abs().max()) > 0 or k.endswith(".key.bias"), k
        assert _close(want["grads"][k], got["grads"][k]), k
    for k in want["params"]:
        assert _close(want["params"][k], got["params"][k]), k
    assert want["eval"].keys() == got["eval"].keys()
    for k in want["eval"]:
        assert abs(want["eval"][k] - got["eval"][k]) <= TOL, k


def test_shard_gradients_match_jax_grad(jax_pair, two_ranks):
    state_dict, batch, ranks, jgrads = jax_pair
    _, builder = W.world_and_builder()
    tm = XML(W.model_config(builder)).eval()
    tm.load_state_dict(state_dict)
    loss, _ = tm(**{k: torch.from_numpy(v) for k, v in batch.items()}, lw_st_ed=LW,
                 neg_ranks=tuple(torch.from_numpy(r) for r in ranks))
    loss.backward()
    got = two_ranks["grads"]
    assert set(got) == set(jgrads) == {k for k, _ in tm.named_parameters()}
    for k, p in tm.named_parameters():
        want = jgrads[k].numpy()
        scale = np.abs(want).max()
        if k.endswith(".key.bias"):
            # softmax ignores a shift of all its scores: round-off on both sides
            assert scale < 1e-8 and float(got[k].abs().max()) < 1e-8, k
            continue
        assert np.abs(got[k].numpy() - want).max() <= 2e-4 * scale, k
        assert _close(got[k], p.grad, TOL * max(scale, 1.0)), k


def test_a_batch_that_does_not_split_is_refused():
    w, builder = W.world_and_builder()
    with pytest.raises(ValueError, match="not divisible by 3"):
        XMLTrainer(W.model_config(builder), TrainSettings(bsz=W.BSZ), builder,
                   w.annotations, device="cpu", n_devices=3)


def test_dryrun_multichip_on_the_cpu():
    out = dryrun_multichip(2, device="cpu")
    for name in ("train", "device_data"):
        assert all(np.isfinite(v) for v in out[name].values()), name
    assert out["device_data"]["steps"] == 2
    assert out["sharded"]["vcmr_vid_global"] == (4, 16)
    assert out["sharded"]["svmr_scores"] == (4, 16)
