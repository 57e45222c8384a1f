"""The harness finds a configuration, a traffic mix and a metric by name: a
later change adds them as files and entries, and edits no file."""
from __future__ import annotations

import hashlib
import json
import time

from benchmarks import harness
from benchmarks.tests import tiny


def _digests(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "benchmarks").rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_are_found_without_an_edit(tmp_path):
    root = tiny.make_root(tmp_path)
    before = _digests(root)
    cfg = tiny.tiny_config("xml_tvr_int8_exact")
    cfg["name"] = "tiny_new"
    cfg["retrieval"]["max_vcmr_video"] = 12
    (root / "benchmarks/configs/tiny_new.json").write_text(json.dumps(cfg))
    (root / "benchmarks/traffic/tiny_b8.json").write_text(json.dumps(
        dict(tiny.TRAFFIC, queries_per_call=8, check_queries=16)))
    (root / "benchmarks/metrics/calls_per_s.py").write_text(
        '"""calls_per_s: calls a second."""\n\n\ndef read(run):\n'
        '    return run.n_calls / run.window_s\n')
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny_new", "source": "test", "reduced": [],
                            "file": "benchmarks/configs/tiny_new.json", "why": "test"})
    spec["workloads"].append({"name": "tiny-new", "config": "tiny_new", "traffic": "tiny_b8",
                              "chips": 1, "why": "test"})
    spec["end_to_end"].append({"name": "calls_per_s", "unit": "calls/s", "better": "higher",
                               "bound": 0.05, "source": "host_clock", "workloads": ["tiny-new"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    after = _digests(root)
    assert all(after[p] == d for p, d in before.items())
    names = [m["name"] for m in harness.cell_metrics(spec, "tiny-new", False)]
    assert "calls_per_s" in names and "moment_recall_pct" not in names
    res = harness.run_cell("tiny-new", 5, 0.3, False, "cpu", time.perf_counter(), root,
                           log=lambda s: None)
    assert res["correct"], res["checks"]
    assert res["metrics"]["calls_per_s"]["unit"] == "calls/s"
    assert res["metrics"]["calls_per_s"]["value"] > 0
    assert res["attempted"] % 8 == 0


def test_per_layer_metrics_follow_their_cells():
    spec = harness.load_spec(tiny.ROOT)
    shipped = {m["name"] for m in harness.cell_metrics(spec, "shipped-b1000", True)}
    exact = {m["name"] for m in harness.cell_metrics(spec, "int8exact-b1000", True)}
    assert "b5_roofline_pct" in exact and "b5_roofline_pct" not in shipped
    assert "b11_roofline_pct" in shipped and "b6_roofline_pct" not in shipped
    assert {"mfu_pct", "device_idle_pct", "host_enqueue_ms", "b1_roofline_pct"} <= shipped & exact
    e2e = {m["name"] for m in harness.cell_metrics(spec, "int8exact-b1000", False)}
    assert e2e == {"qps", "batch_ms_p95", "peak_mem_gib", "setup_s"}
