"""The harness finds a configuration, a traffic mix, a metric and a program
by name: a later change adds them as files and entries, and edits no
file."""
from __future__ import annotations

import hashlib
import json
import time

import pytest

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


TOY = '''"""toy: a resident corpus of random rows; a call scores its queries
against every row and keeps each query's top k."""
import torch

from benchmarks import synth


def _corpus(corpus, device, seed):
    return torch.randn((corpus["n_videos"], corpus["dim"]), device=device,
                       generator=synth.generator(device, seed, "toy corpus"))


def build(config, device, seed):
    return _corpus(config["corpus"], device, seed), config["corpus"]["top_k"]


def queries(traffic, config, n_videos, device, seed, i):
    return (torch.randn((traffic["queries_per_call"], config["corpus"]["dim"]), device=device,
                        generator=synth.generator(device, seed, "toy queries", i)),)


def call(state, queries):
    rows, k = state
    scores, idx = torch.topk(queries[0] @ rows.T, k, dim=1)
    # fault
    return {"scores": scores, "idx": idx}


def judge(config, traffic, device, seed, queries, outputs):
    ref = torch.cat([q[0] for q in queries]).double() @ _corpus(
        config["corpus"], device, seed).double().T
    kth = torch.topk(ref, config["corpus"]["top_k"], dim=1).values[:, -1:]
    got = torch.gather(ref, 1, torch.as_tensor(outputs["idx"]))
    return {"score_err": float((torch.as_tensor(outputs["scores"]).double() - got).abs().max()),
            "topk_gap": float((kth - got).clamp_min(0).max())}
'''
TOY_LIMITS = {"score_err": 1e-4, "topk_gap": 1e-4}


def _toy_root(tmp_path, fault: str = ""):
    """The tiny root with a program of another model added as files and
    entries: its module, a configuration naming it, a traffic mix and a
    cell. Returns (root, the digests of the files there before)."""
    root = tiny.make_root(tmp_path)
    before = _digests(root)
    (root / "benchmarks/programs/toy.py").write_text(TOY.replace("# fault", fault or "pass"))
    (root / "benchmarks/configs/toy_rows.json").write_text(json.dumps(
        {"name": "toy_rows", "program": "toy", "corpus": {"n_videos": 500, "dim": 16, "top_k": 5},
         "limits": TOY_LIMITS}))
    (root / "benchmarks/traffic/toy_q8.json").write_text(json.dumps(
        {"loop": "closed", "callers": 1, "queries_per_call": 8, "check_queries": 16}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "toy_rows", "source": "test", "reduced": [],
                            "file": "benchmarks/configs/toy_rows.json", "why": "test"})
    spec["workloads"].append({"name": "toy-rows", "config": "toy_rows", "traffic": "toy_q8",
                              "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root, before


def _toy_run(root):
    return harness.run_cell("toy-rows", 2 ** 33 + 3, 0.2, False, "cpu", time.perf_counter(),
                            root, log=lambda s: None)


def test_a_program_of_another_model_runs_without_an_edit(tmp_path):
    root, before = _toy_root(tmp_path)
    res = _toy_run(root)
    assert res["correct"], res["checks"]
    assert {k: c["limit"] for k, c in res["checks"].items()} == TOY_LIMITS
    assert res["attempted"] % 8 == 0 and res["attempted"] >= 16
    assert res["metrics"]["setup_s"]["value"] > 0
    assert "qps" not in res["metrics"] and "moment_recall_pct" not in res["metrics"]
    after = _digests(root)
    assert all(after[p] == d for p, d in before.items())


@pytest.mark.parametrize("fault, number", [
    ("scores[3, 0] += 0.5", "score_err"),
    ("idx[2, 0] = (idx[2, 0] + 1) % 500", "topk_gap"),
])
def test_a_fault_in_another_programs_outputs_is_not_correct(tmp_path, fault, number):
    res = _toy_run(_toy_root(tmp_path, fault)[0])
    assert not res["correct"]
    check = res["checks"][number]
    assert check["limit"] == TOY_LIMITS[number] and check["value"] > check["limit"]
