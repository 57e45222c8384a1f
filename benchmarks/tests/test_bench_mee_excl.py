"""The MEE + ExCL program (``benchmarks/programs/mee_excl.py``) through the
harness on the CPU, at toy widths: a run is correct against the plain
reference, and not correct under the control or a planted fault; adding it
edits no file the benchmark had, and its per-layer metrics read nothing,
without failing, where no device times exist."""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from benchmarks import harness, readings_mee_excl
from benchmarks.tests import tiny, tiny_mee_excl

SEED = 2 ** 34 + 11
NEW_METRICS = {"mee_vr_ms", "excl_query_ms", "excl_gather_ms", "excl_lstm_ms", "excl_head_ms",
               "excl_topk_ms", "excl_lstm_roofline_pct", "excl_mfu_pct"}


def _digests(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "benchmarks").rglob("*") if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture(scope="module")
def mee_root(tmp_path_factory):
    torch.set_num_threads(2)
    root = tiny.make_root(tmp_path_factory.mktemp("mee"))
    before = _digests(root)
    tiny_mee_excl.add_to(root, per_layer=True)
    after = _digests(root)
    assert all(after[p] == d for p, d in before.items())
    return root


def _run(root, score_fn=None, trace=False):
    return harness.run_cell(tiny_mee_excl.CELL, SEED, 0.3, trace, "cpu", time.perf_counter(),
                            root, score_fn=score_fn, log=lambda s: None)


def test_a_run_is_correct_and_reads_its_metrics(mee_root):
    res = _run(mee_root, trace=True)
    assert res["correct"], res["checks"]
    limits = tiny_mee_excl.config()["limits"]
    assert {k: c["limit"] for k, c in res["checks"].items()} == limits
    assert res["attempted"] % 8 == 0 and res["attempted"] >= 16
    assert "breakdown" in res
    spec = harness.load_spec(mee_root)
    listed = {m["name"] for m in harness.cell_metrics(spec, tiny_mee_excl.CELL, True)}
    assert NEW_METRICS | {"device_idle_pct", "call_idle_pct"} <= listed
    # no device times on the CPU: the span readers have nothing to read
    assert not NEW_METRICS - {"excl_mfu_pct"} & set(res["metrics"])
    untraced = harness.cell_metrics(spec, tiny_mee_excl.CELL, False)
    assert {m["name"] for m in untraced} == {"qps", "batch_ms_p95", "peak_mem_gib", "setup_s"}


@pytest.mark.parametrize("fault", sorted(readings_mee_excl.FAULTS))
def test_planted_faults_are_not_correct(mee_root, fault):
    _, config, _ = harness.resolve(harness.load_spec(mee_root), tiny_mee_excl.CELL, mee_root)
    program = harness.load_program(config, mee_root)
    number = readings_mee_excl.FAULTS[fault]
    res = _run(mee_root, readings_mee_excl.stand_in(fault, program, config, "cpu", SEED))
    assert not res["correct"]
    assert res["checks"][number]["value"] > res["checks"][number]["limit"], res["checks"]


def test_control_is_not_correct(mee_root):
    _, config, _ = harness.resolve(harness.load_spec(mee_root), tiny_mee_excl.CELL, mee_root)
    program = harness.load_program(config, mee_root)
    res = _run(mee_root, program.control_score_fn(config, "cpu", SEED))
    assert not res["correct"]
    assert res["checks"]["span_err"]["value"] > res["checks"]["span_err"]["limit"]


def test_the_reference_loads_nothing_of_the_port():
    code = ("import sys, json; sys.path.insert(0, %r)\n"
            "from benchmarks.reference import mee_excl_ref\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))" % str(tiny.ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=tiny.ROOT, capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"jax", "jaxlib", "flax", "tvretrieval_tpu", "tvretrieval_tpu_torch"}
