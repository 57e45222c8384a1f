"""Interop of the port with the JAX package (ROADMAP A18).

- ``tvretrieval_tpu_torch.entry.entry`` against ``__graft_entry__.entry``:
  the same seeded inputs, the JAX model's parameters converted with
  ``convert.flax_params_to_state_dict``, the negative ranks JAX draws
  injected through ``neg_ranks``; the loss within 2e-4 (the bound of
  tests/test_torch_xml_train.py).
- A JAX run directory, written in the layout of the JAX ``train_xml``
  (its own argument parser's ``opt.json`` and its orbax checkpoint of
  seeded flax parameters for a tiny synthetic world), converted here into
  the port's ``training.checkpoint.save_checkpoint`` layout; both packages'
  ``inference_xml --streaming flat_int8`` (the JAX one with its kernel in
  interpret mode) give equal submissions: the VR videos and their order
  equal (int8 video scores are exact), every score within 2e-4, the
  VCMR / SVMR moments equal outside near-ties, the same metrics. The run
  directory is not trained: a one-epoch JAX ``train_xml`` run takes over a
  minute of XLA compilation on one core.
"""
import dataclasses
import json
import os
import shutil

import jax
import numpy as np
import torch

import __graft_entry__
from tvretrieval_tpu.models.xml import XML as JXML
from tvretrieval_tpu.models.xml import XMLConfig as JXMLConfig
from tvretrieval_tpu.retrieval import inference_xml as j_inference
from tvretrieval_tpu.training import checkpoint as j_checkpoint
from tvretrieval_tpu.training import train_xml as j_train
from tvretrieval_tpu_torch.convert import flax_params_to_state_dict
from tvretrieval_tpu_torch.entry import entry
from tvretrieval_tpu_torch.retrieval import inference_xml
from tvretrieval_tpu_torch.testing import rank_mismatches
from tvretrieval_tpu_torch.training import train_xml
from tvretrieval_tpu_torch.training.checkpoint import save_checkpoint

TOL = 2e-4


def jax_ranks(key, n: int, upper: int):
    """The (ctx, query) negative ranks the JAX model draws from ``key``
    (tvretrieval_tpu/models/xml.py:714-720)."""
    k_ctx, k_q = jax.random.split(key)
    draw = lambda k: np.array(jax.random.randint(k, (n,), 1, max(min(upper, n), 2)))
    return draw(k_ctx), draw(k_q)


def test_entry_matches_the_jax_entry():
    jfn, jargs = __graft_entry__.entry()
    want = float(jax.jit(jfn)(*jargs))
    fn, args = entry(device="cpu")
    assert len(args) == len(jargs) == 8
    for a, b in zip(jargs[1:], args[1:]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    params = flax_params_to_state_dict(jax.device_get(jargs[0]))
    assert params.keys() == args[0].keys()
    ranks = tuple(torch.from_numpy(r) for r in jax_ranks(jax.random.PRNGKey(0), 8, 8))
    with torch.no_grad():
        got = fn(params, *args[1:], neg_ranks=ranks)
        own = fn(*args)
    assert abs(got.item() - want) <= TOL, (got.item(), want)
    assert own.dim() == 0 and torch.isfinite(own)


TINY = ["--synthetic", "--synthetic_videos", "16", "--synthetic_queries", "48",
        "--synthetic_vid_dim", "32", "--synthetic_text_dim", "16", "--synthetic_max_clips", "12",
        "--max_ctx_l", "12", "--bsz", "16", "--hidden_size", "32", "--n_heads", "2",
        "--eval_query_bsz", "8", "--eval_context_bsz", "8", "--max_vcmr_video", "8"]


def write_jax_run(results_root: str) -> str:
    """A run directory as the JAX train_xml writes it: opt.json from its
    parser, ckpt/ from its orbax writer, parameters from ``XML.init``."""
    args = j_train.build_arg_parser().parse_args(TINY + ["--results_root", results_root,
                                                         "--exp_id", "jax"])
    run_dir = os.path.join(results_root, f"{args.dset_name}-{args.exp_id}")
    os.makedirs(run_dir)
    with open(os.path.join(run_dir, "opt.json"), "w") as f:
        json.dump(vars(args), f)
    train_rows, _, builder, _ = j_train.setup_world(args)
    cfg = JXMLConfig(**dataclasses.asdict(train_xml.model_config(args, builder)))
    batch = builder.build_train_batch(train_rows[:4]).model_inputs()
    variables = jax.jit(lambda r, b: JXML(cfg).init(r, **b, deterministic=True))(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
         "negatives": jax.random.PRNGKey(2)}, batch)
    j_checkpoint.save_checkpoint(os.path.join(run_dir, "ckpt"), variables["params"], None,
                                 cfg, 0)
    return run_dir


def jax_run_to_port(jax_dir: str, port_dir: str) -> None:
    """Convert a JAX run directory into the port's: opt.json as it is, the
    flax parameters mapped by ``flax_params_to_state_dict`` into
    ``save_checkpoint``'s layout with the same model config and epoch."""
    params, _, model_cfg, epoch = j_checkpoint.load_checkpoint(os.path.join(jax_dir, "ckpt"))
    os.makedirs(port_dir)
    shutil.copy(os.path.join(jax_dir, "opt.json"), port_dir)
    save_checkpoint(os.path.join(port_dir, "ckpt"), flax_params_to_state_dict(params), None,
                    model_cfg, epoch)


def _moment_keys(preds):
    p = np.asarray(preds, np.float64)
    return ((p[:, 0] * 1000 + np.rint(p[:, 1] / 1.5)) * 1000 + np.rint(p[:, 2] / 1.5)), p[:, 3]


def test_jax_run_directory_streams_equally_in_both_packages(tmp_path):
    jax_dir = write_jax_run(str(tmp_path / "jax"))
    port_dir = str(tmp_path / "port" / "tvr-port")
    jax_run_to_port(jax_dir, port_dir)
    flags = ["--streaming", "flat_int8", "--streaming_block_videos", "5", "--eval_id", "s8"]
    want = j_inference.start_inference(["--model_dir", jax_dir] + flags)
    got = inference_xml.start_inference(["--model_dir", port_dir, "--device", "cpu"] + flags)
    jsub = json.load(open(want["files"][0]))
    tsub = json.load(open(got["files"][0]))
    assert os.path.basename(want["files"][0]) == os.path.basename(got["files"][0])
    assert jsub["video2idx"] == tsub["video2idx"]
    for task in ("VCMR", "SVMR", "VR"):
        assert len(jsub[task]) == len(tsub[task]) == 12
        for a, b in zip(jsub[task], tsub[task]):
            assert a["desc_id"] == b["desc_id"]
            pa, pb = np.asarray(a["predictions"]), np.asarray(b["predictions"])
            assert pa.shape == pb.shape
            np.testing.assert_allclose(pb[:, 3], pa[:, 3], rtol=TOL, err_msg=task)
            if task == "VR":
                np.testing.assert_array_equal(pb[:, :3], pa[:, :3])
            else:
                (ka, sa), (kb, _) = _moment_keys(pa), _moment_keys(pb)
                assert rank_mismatches(ka, sa, kb, rtol=2 * TOL) == 0, task
    assert got["metrics"] == want["metrics"]
