"""The port's public surface against the JAX package's: every CLI module's
options, every subpackage's ``__all__``, and the public names that had no
twin (``temporal_nms_batch_native``, ``sinusoidal_position_encoding``,
``auto_interpret``).

- CLIs: each pair's parser is caught at ``parse_args`` (both packages build
  some parsers inside ``main``) and its option strings compared: the port
  takes every JAX option and adds ``--device`` at most;
- ``__all__``: every name the JAX subpackage exports resolves in the
  port's, under the port's name where the idiom differs (RENAMED);
- the batched native NMS: equal to the JAX package's wrapper on seeded
  rows with ties, queries with no rows among them; the PE table equal to
  the JAX package's bit for bit; ``auto_interpret`` the identity.
"""
import argparse
import dataclasses
import importlib
import sys
from unittest import mock

import numpy as np
import pytest

from tvretrieval_tpu.models.components import sinusoidal_position_encoding as j_pe
from tvretrieval_tpu.native import loader as jloader
from tvretrieval_tpu_torch.models.components import sinusoidal_position_encoding
from tvretrieval_tpu_torch.native import loader
from tvretrieval_tpu_torch.retrieval.engine import RetrievalConfig, auto_interpret

# module (same path in both packages) -> the function that parses its command line
CLI_PAIRS = {
    "data.proposal_upper_bound": "main",
    "evaluation.fusion": "main",
    "evaluation.metrics": "eval_main",
    "features.lm_finetune": "main",
    "features.text_features": "main",
    "profiling.engine_modes": "main",
    "profiling.profile_models": "main",
    "profiling.search_simulation": "main",
    "retrieval.inference_baselines": "start_inference",
    "retrieval.inference_xml": "start_inference",
    "training.train_cal": "start_training",
    "training.train_excl": "start_training",
    "training.train_mee": "start_training",
    "training.train_xml": "start_training",
}
SUBPACKAGES = ("data", "evaluation", "features", "models", "native", "ops", "parallel",
               "profiling", "retrieval", "training", "utils")
# JAX name -> port name, where the port's idiom differs
RENAMED = {"training": {"bert_adam": "BertAdam"}}


class _Parsed(Exception):
    pass


def _options(package: str, module: str, entry: str) -> set:
    """The option strings of the parser ``entry`` builds."""
    mod = importlib.import_module(f"{package}.{module}")

    def catch(parser, args=None, namespace=None):
        raise _Parsed({s for a in parser._actions for s in a.option_strings})

    with mock.patch.object(argparse.ArgumentParser, "parse_args", catch), \
            mock.patch.object(sys, "argv", ["cli"]):
        fn = getattr(mod, entry)
        try:
            fn([]) if fn.__code__.co_argcount else fn()
        except _Parsed as caught:
            return caught.args[0]
    raise AssertionError(f"{package}.{module}.{entry} parsed no command line")


def test_every_cli_module_is_paired():
    import pkgutil

    import tvretrieval_tpu
    mods = {m.name.split(".", 1)[1] for m in pkgutil.walk_packages(
        tvretrieval_tpu.__path__, "tvretrieval_tpu.") if m.name.count(".") == 2}
    with_parser = {m for m in mods if "argparse" in open(
        importlib.util.find_spec(f"tvretrieval_tpu.{m}").origin).read()}
    assert with_parser == set(CLI_PAIRS)


@pytest.mark.parametrize("module", list(CLI_PAIRS))
def test_cli_takes_the_jax_options(module):
    jax_opts = _options("tvretrieval_tpu", module, CLI_PAIRS[module])
    port_opts = _options("tvretrieval_tpu_torch", module, CLI_PAIRS[module])
    assert jax_opts <= port_opts, sorted(jax_opts - port_opts)
    assert port_opts - jax_opts <= {"--device"}, sorted(port_opts - jax_opts)


def test_engine_modes_interpret_maps_to_the_config(monkeypatch):
    """--interpret (C1) reaches RetrievalConfig.pallas_interpret."""
    from tvretrieval_tpu_torch.profiling import engine_modes

    seen = {}

    def run(args):
        seen["interpret"] = args.interpret
        return []

    monkeypatch.setattr(engine_modes, "run", run)
    engine_modes.main(["--interpret", "--device", "cpu"])
    assert seen == {"interpret": True}
    assert not engine_modes.build_arg_parser().parse_args([]).interpret


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_every_jax_export_resolves(sub):
    jax_all = importlib.import_module(f"tvretrieval_tpu.{sub}").__all__
    port = importlib.import_module(f"tvretrieval_tpu_torch.{sub}")
    names = [RENAMED.get(sub, {}).get(n, n) for n in jax_all]
    assert sorted(port.__all__) == sorted(names)
    for n in names:
        assert getattr(port, n) is not None, n


def _rows(rng, n):
    st = rng.integers(0, 160, n) / 4
    return np.stack([st, st + rng.integers(1, 60, n) / 4, rng.integers(0, 12, n) / 16], 1)


@pytest.mark.parametrize("thd,max_after", [(0.0, 3), (0.5, 10), (0.7, 200), (1.0, 5)])
def test_temporal_nms_batch_equals_the_jax_wrapper(thd, max_after):
    if not (loader.native_available() and jloader.native_available()):
        pytest.skip("no host C++ compiler: the numpy path is the only one")
    rng = np.random.default_rng(int(thd * 10) + max_after)
    counts = [0, 7, 40, 0, 1, 120, 25, 0]
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    preds = _rows(rng, int(offsets[-1])).astype(np.float32)
    out, kept = loader.temporal_nms_batch_native(preds, offsets, thd, max_after)
    jout, jkept = jloader.temporal_nms_batch_native(preds, offsets, thd, max_after)
    assert out.shape == (len(counts), max_after, 3) and kept.dtype == np.int32
    np.testing.assert_array_equal(kept, jkept)
    assert all(kept[q] == 0 for q, c in enumerate(counts) if c == 0)
    for q, n in enumerate(kept):
        np.testing.assert_array_equal(out[q, :n], jout[q, :n])
        lo, hi = offsets[q], offsets[q + 1]
        np.testing.assert_array_equal(
            out[q, :n], loader.temporal_nms_native(preds[lo:hi], thd, max_after))
    with pytest.raises(ValueError, match="non-decreasing"):
        loader.temporal_nms_batch_native(preds, offsets[::-1], thd, max_after)


@pytest.mark.parametrize("length,dim", [(1, 2), (30, 7), (100, 256), (128, 3)])
def test_sinusoidal_position_encoding_equals_jax(length, dim):
    pe = sinusoidal_position_encoding(length, dim)
    assert pe.dtype.is_floating_point and tuple(pe.shape) == (length, dim)
    np.testing.assert_array_equal(pe.numpy(), j_pe(length, dim))


def test_auto_interpret_is_the_identity():
    for cfg in (RetrievalConfig(), RetrievalConfig(video_score_mode="pallas_int8",
                                                   span_score_mode="simsweep_cat_int8_flat",
                                                   video_topk_psort=True)):
        assert auto_interpret(cfg) is cfg
    assert dataclasses.replace(RetrievalConfig(), pallas_interpret=True).pallas_interpret
