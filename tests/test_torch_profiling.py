"""The port's stage profilers (tvretrieval_tpu_torch.profiling.
profile_models) against the JAX package's: with ``time_stage`` replaced by
one constant in both modules, every profiler's dict is the JAX one, key
for key and value for value (the extrapolation arithmetic); then one real
``time_stage`` run of each on the CPU at small sizes, and the host batch
pipeline's cache sizes.

Under the constant, a dict depends on the profilers' sizes only, not on
their tensors' values; the JAX profilers are built with flax ``init``
traced abstractly (zeros of its shapes) and ``jax.random.normal`` giving
zeros: run for real on one core, their ``init``s and the reference-size
draws take a minute."""
import json
import math
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import pytest
import torch

from tvretrieval_tpu.profiling import profile_models as jpm
from tvretrieval_tpu_torch.profiling import profile_models as tpm
from _baseline_pairs import one_torch_thread  # noqa: F401


SMALL_XML = dict(n_videos=8, n_clips=12, hidden=32, query_bsz=4, visual_dim=20,
                 sub_dim=12, query_dim=16)
SMALL_TRAIN = dict(bsz=8, hidden=32, n_clips=12, visual_dim=20, sub_dim=12, query_dim=16)
STAGE_S = 0.0123


def _constant_stage(fn, n_warmup=2, n_runs=10):
    return STAGE_S


@pytest.fixture(scope="module")
def jax_dicts():
    """Every JAX profiler's dict under the constant stage time."""
    init = fnn.Module.init

    def abstract_init(self, *args, **kwargs):
        shapes = jax.eval_shape(lambda *a: init(self, *a, **kwargs), *args)
        return jax.tree_util.tree_map(lambda t: jnp.zeros(t.shape, t.dtype), shapes)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpm, "time_stage", _constant_stage)
        mp.setattr(fnn.Module, "init", abstract_init)
        mp.setattr(jax.random, "normal",
                   lambda key, shape=(), dtype=jnp.float32: jnp.zeros(shape, dtype))
        xml = jpm.ProfileXML(**SMALL_XML)
        return {"xml": {e: xml.profile(e) for e in (1_000_000, None)},
                **{f"train_{d}": jpm.ProfileXMLTrain(**SMALL_TRAIN, dtype_str=d).profile()
                   for d in ("float32", "bfloat16")},
                **{name: getattr(jpm, name)().profile()
                   for name in ("ProfileMEE", "ProfileCAL", "ProfileExCL")}}


@pytest.fixture
def constant_time(monkeypatch):
    monkeypatch.setattr(tpm, "time_stage", _constant_stage)


def _finite_positive(d):
    return all(math.isfinite(v) and v > 0 for v in d.values())


@pytest.mark.parametrize("args", [
    (256, 1_000_000, 20, 170_000_000, 1_170_946_944, 4),
    (384, 21_818, 100, 0, 0, 2),
])
def test_index_storage_gb_equal_jax(args):
    assert tpm.index_storage_gb(*args) == jpm.index_storage_gb(*args)


@pytest.mark.parametrize("extrapolate", [1_000_000, None])
def test_xml_dict_equals_jax(constant_time, jax_dicts, extrapolate):
    got = tpm.ProfileXML(**SMALL_XML, device="cpu").profile(extrapolate)
    assert got == jax_dicts["xml"][extrapolate]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xml_train_dict_equals_jax(constant_time, jax_dicts, dtype):
    got = tpm.ProfileXMLTrain(**SMALL_TRAIN, dtype_str=dtype, device="cpu").profile()
    assert got == jax_dicts[f"train_{dtype}"]


@pytest.mark.parametrize("name", ["ProfileMEE", "ProfileCAL", "ProfileExCL"])
def test_baseline_dicts_equal_jax(constant_time, jax_dicts, name):
    """At the reference constants, as the JAX profilers run them."""
    assert getattr(tpm, name)("cpu").profile() == jax_dicts[name]


def test_xml_profilers_time_on_the_cpu(jax_dicts):
    """One real ``time_stage`` run of each XML profiler at small sizes: the
    JAX key sets, finite, positive values."""
    xml = tpm.ProfileXML(**SMALL_XML, device="cpu").profile(1_000_000)
    assert set(xml) == set(jax_dicts["xml"][1_000_000]) and _finite_positive(xml)
    train = tpm.ProfileXMLTrain(**SMALL_TRAIN, device="cpu").profile()
    assert set(train) == set(jax_dicts["train_float32"]) and _finite_positive(train)


@pytest.mark.parametrize("name", ["ProfileMEE", "ProfileCAL", "ProfileExCL"])
def test_baseline_profilers_time_on_the_cpu(jax_dicts, name):
    """One real ``time_stage`` run of each baseline profiler, at the
    reference sizes they take (3-12 s each on one core)."""
    r = getattr(tpm, name)("cpu").profile()
    assert set(r) == set(jax_dicts[name]) and _finite_positive(r)


def test_train_profiler_steps_the_optimizer():
    prof = tpm.ProfileXMLTrain(**SMALL_TRAIN, device="cpu")
    before = {k: p.detach().clone() for k, p in prof.model.named_parameters()}
    loss = prof._step()
    assert torch.isfinite(loss) and prof.optimizer.state["step"] == 1
    # the first BertAdam step has rate 0 (warm-up from 0); the second moves
    prof._step()
    moved = [k for k, p in prof.model.named_parameters() if not torch.equal(p, before[k])]
    assert moved


def test_data_pipeline_cache_sizes_equal_jax():
    kw = dict(bsz=4, n_videos=6, n_queries=20)
    got, ref = tpm.profile_data_pipeline(**kw), jpm.profile_data_pipeline(**kw)
    assert set(got) == set(ref)
    assert got["cache_gb"] == ref["cache_gb"]
    assert got["cache_f16_gb"] == ref["cache_f16_gb"]
    assert _finite_positive(got)


def test_time_stage_runs_and_fences():
    calls = []
    t = tpm.time_stage(lambda: calls.append(1) or (torch.ones(2), {"a": torch.zeros(1)}),
                       n_warmup=2, n_runs=3)
    assert len(calls) == 5 and t >= 0


def test_cli_on_the_cpu_with_trace(tmp_path, capsys):
    res = tpm.main(["--device", "cpu", "--n_videos", "8", "--n_clips", "12",
                    "--hidden", "32", "--query_bsz", "4", "--trace_dir", str(tmp_path)])
    assert res["storage_gb"] == jpm.index_storage_gb(
        32, 1000000, 20, n_moments=170_000_000, n_total_clips_in_moments=1_170_946_944)
    assert _finite_positive({k: v for k, v in res.items() if k != "storage_gb"})
    with open(os.path.join(tmp_path, "profile_models_trace.json")) as f:
        assert json.load(f)["traceEvents"]
    assert '"retrieval_queries_per_sec"' in capsys.readouterr().out


def test_cli_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for flags in ([], ["--train"], ["--baselines"]):
        with pytest.raises(SystemExit, match="no CUDA device"):
            tpm.main(flags)
