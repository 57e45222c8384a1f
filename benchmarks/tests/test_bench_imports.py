"""What a run loads, checked in fresh processes: nothing of JAX or the JAX
package (whole top-level names: the port's name begins with the JAX
package's), and nothing of the port in the reference; and the command's
refusals without a card."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from benchmarks.tests import tiny

FORBIDDEN = ["jax", "jaxlib", "flax", "optax", "orbax", "tvretrieval_tpu"]
ENV = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "2"}


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=tiny.ROOT, env=ENV, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_whole_run_loads_no_jax(tmp_path):
    code = f"""
import sys, time, pathlib
sys.path.insert(0, {str(tiny.ROOT)!r})
from benchmarks import harness, readings, timeline, peaks
from benchmarks.tests import tiny
root = tiny.make_root(pathlib.Path({str(tmp_path)!r}))
for name in [p.stem for p in (root / "benchmarks" / "metrics").glob("*.py")]:
    harness.load_metric(name, root)
for trace in (False, True):
    assert harness.run_cell("tiny-shipped", 3, 0.2, trace, "cpu", time.perf_counter(), root,
                            log=lambda s: None)["correct"]
"""
    loaded = _loaded(code)
    assert not loaded & set(FORBIDDEN)
    assert "tvretrieval_tpu_torch" in loaded


def test_the_reference_loads_nothing_of_the_port():
    loaded = _loaded(f"import sys; sys.path.insert(0, {str(tiny.ROOT)!r})\n"
                     "from benchmarks.reference import xml_ref\n"
                     "from benchmarks import check, synth, peaks, timeline")
    assert not loaded & set(FORBIDDEN + ["tvretrieval_tpu_torch"])


@pytest.mark.parametrize("workload", ["shipped-b1000", "int8exact-b1000"])
def test_run_refuses_without_a_card(workload):
    out = subprocess.run([sys.executable, "benchmarks/run.py", "--workload", workload,
                          "--seed", str(2 ** 31 + 9), "--seconds", "1", "--trace", "0"],
                         cwd=tiny.ROOT, env=ENV, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())
    assert "CUDA card" in out.stderr


def test_run_fails_without_the_program(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's
    folder: no result."""
    root = tiny.make_root(tmp_path)
    out = subprocess.run([sys.executable, "benchmarks/run.py", "--workload", "shipped-b1000",
                          "--seed", "1", "--seconds", "1"], cwd=root, env=ENV,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())
