"""``BENCHMARK.json`` against the contract's static rules, and every name it
gives backed by its file."""
from __future__ import annotations

import json
import re

from benchmarks import harness
from benchmarks.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_names_and_limits():
    spec = harness.load_spec(tiny.ROOT)
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert len(json.dumps(spec)) < 64 * 1024
    assert spec["paths"] == ["benchmarks"] and spec["command"][1] == "benchmarks/run.py"
    assert 1 <= spec["run_seconds"] <= 51
    for group, keys in KEYS.items():
        names = [e["name"] for e in spec[group]]
        assert len(names) == len(set(names))
        for e in spec[group]:
            assert set(e) - {"workloads"} == keys, e
            assert NAME.match(e["name"])
    cells = {w["name"]: w for w in spec["workloads"]}
    configs = {c["name"]: c for c in spec["configs"]}
    assert len({(w["config"], w["traffic"]) for w in cells.values()}) == len(cells)
    for w in cells.values():
        assert w["config"] in configs and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] == 1
        assert (tiny.ROOT / "benchmarks" / "traffic" / f"{w['traffic']}.json").is_file()
    for c in configs.values():
        assert _line(c["source"]) and _line(c["why"]) and c["reduced"] == []
        cfg = json.loads((tiny.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert any(w["config"] == c["name"] for w in cells.values())
    metrics = spec["end_to_end"] + spec["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
        assert (tiny.ROOT / "benchmarks" / "metrics" / f"{m['name']}.py").is_file()
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"] for m in spec["end_to_end"]} >= {"setup_s", "qps"}
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    for m in spec["per_layer"]:
        assert _line(m["layer"]) and m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", cells)
    for cell in cells:
        reported = harness.cell_metrics(spec, cell, False)
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        assert harness.cell_metrics(spec, cell, True)


def test_configurations_name_every_compared_number():
    spec = harness.load_spec(tiny.ROOT)
    for c in spec["configs"]:
        cfg = json.loads((tiny.ROOT / c["file"]).read_text())
        exact = cfg["semantics"]["video_selection"] == "exact"
        want = {"q2c_err", "span_err", "svmr_err", "svmr_gap",
                "topv_gap" if exact else "topv_miss", "vcmr_gap" if exact else "vcmr_miss"}
        assert set(cfg["limits"]) == want
