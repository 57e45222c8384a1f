"""The CAL program (``benchmarks/programs/cal.py``) through the harness on
the CPU, at toy widths: a run is correct against the plain reference, and
not correct under the control or a planted fault; adding it edits no file
the benchmark had, and its per-layer metrics read nothing, without
failing, where no device times exist."""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from benchmarks import harness, readings_cal
from benchmarks.tests import tiny, tiny_cal

SEED = 2 ** 34 + 11
NEW_METRICS = {"cal_query_ms", "cal_dist_ms", "cal_topk_ms", "cal_svmr_ms",
               "cal_dist_roofline_pct", "cal_mfu_pct"}


def _digests(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "benchmarks").rglob("*") if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture(scope="module")
def cal_root(tmp_path_factory):
    torch.set_num_threads(2)
    root = tiny.make_root(tmp_path_factory.mktemp("cal"))
    before = _digests(root)
    tiny_cal.add_to(root, per_layer=True)
    after = _digests(root)
    assert all(after[p] == d for p, d in before.items())
    return root


def _run(root, score_fn=None, trace=False):
    return harness.run_cell(tiny_cal.CELL, SEED, 0.3, trace, "cpu", time.perf_counter(),
                            root, score_fn=score_fn, log=lambda s: None)


def test_a_run_is_correct_and_reads_its_metrics(cal_root):
    res = _run(cal_root, trace=True)
    assert res["correct"], res["checks"]
    limits = tiny_cal.config()["limits"]
    assert {k: c["limit"] for k, c in res["checks"].items()} == limits
    assert res["attempted"] % 8 == 0 and res["attempted"] >= 16
    assert "breakdown" in res
    spec = harness.load_spec(cal_root)
    listed = {m["name"] for m in harness.cell_metrics(spec, tiny_cal.CELL, True)}
    host = {"host_enqueue_ms", "engine_host_ms", "copy_out_gbps"}
    assert NEW_METRICS | host | {"device_idle_pct", "call_idle_pct"} <= listed
    # the host's clock and the root span's host time read on the CPU too
    assert res["metrics"]["host_enqueue_ms"]["value"] > 0
    assert res["metrics"]["engine_host_ms"]["value"] > 0
    # no device times on the CPU: the span readers have nothing to read
    assert not NEW_METRICS - {"cal_mfu_pct"} & set(res["metrics"])
    assert 0 < res["metrics"]["cal_mfu_pct"]["value"] < 100
    untraced = harness.cell_metrics(spec, tiny_cal.CELL, False)
    assert {m["name"] for m in untraced} == {"qps", "batch_ms_p95", "peak_mem_gib", "setup_s"}


@pytest.mark.parametrize("fault", sorted(readings_cal.FAULTS))
def test_planted_faults_are_not_correct(cal_root, fault):
    _, config, _ = harness.resolve(harness.load_spec(cal_root), tiny_cal.CELL, cal_root)
    program = harness.load_program(config, cal_root)
    number = readings_cal.FAULTS[fault]
    res = _run(cal_root, readings_cal.stand_in(fault, program, config, "cpu", SEED))
    assert not res["correct"]
    assert res["checks"][number]["value"] > res["checks"][number]["limit"], res["checks"]


def test_control_is_not_correct(cal_root):
    _, config, _ = harness.resolve(harness.load_spec(cal_root), tiny_cal.CELL, cal_root)
    program = harness.load_program(config, cal_root)
    res = _run(cal_root, program.control_score_fn(config, "cpu", SEED))
    assert not res["correct"]
    assert res["checks"]["q2c_err"]["value"] > res["checks"]["q2c_err"]["limit"]


def test_the_reference_loads_nothing_of_the_port():
    code = ("import sys, json; sys.path.insert(0, %r)\n"
            "from benchmarks.reference import cal_ref\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))" % str(tiny.ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=tiny.ROOT, capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"jax", "jaxlib", "flax", "tvretrieval_tpu", "tvretrieval_tpu_torch"}
