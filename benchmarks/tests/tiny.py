"""A tiny copy of the benchmark for CPU tests: the real folder and
``BENCHMARK.json`` copied into a temporary root, with two cells
(``tiny-shipped``, ``tiny-int8exact``) whose configurations keep every mode,
semantics and limit of the real ones at toy widths and corpus size."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent

MODEL = {"visual_input_size": 40, "sub_input_size": 24, "query_input_size": 48,
         "hidden_size": 32, "n_heads": 4, "max_ctx_l": 24, "max_desc_l": 12}
CORPUS = {"n_videos": 300, "n_clips": 24, "clip_length": 1.5}
RETRIEVAL = {"max_vcmr_video": 20, "max_before_nms": 30}
TRAFFIC = {"loop": "closed", "callers": 1, "queries_per_call": 16, "token_len": [4, 12],
           "gt_video": "uniform", "check_queries": 32}
CELLS = {"tiny-shipped": "xml_tvr_shipped", "tiny-int8exact": "xml_tvr_int8_exact"}


def tiny_config(name: str) -> dict:
    with open(BENCH_DIR / "configs" / f"{name}.json") as f:
        cfg = json.load(f)
    cfg["model"].update(MODEL)
    cfg["corpus"].update(CORPUS)
    cfg["retrieval"].update(RETRIEVAL)
    if "span_sim_pad_l" in cfg["retrieval"]:
        cfg["retrieval"]["span_sim_pad_l"] = 32
    cfg["name"] = f"tiny_{name}"
    return cfg


def make_root(tmp: Path) -> Path:
    """A checkout-like root holding the benchmark with the tiny cells."""
    root = Path(tmp) / "root"
    shutil.copytree(BENCH_DIR, root / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    with open(ROOT / "BENCHMARK.json") as f:
        spec = json.load(f)
    for cell, config in CELLS.items():
        cfg = tiny_config(config)
        path = f"benchmarks/configs/{cfg['name']}.json"
        (root / path).write_text(json.dumps(cfg, indent=1))
        spec["configs"].append({"name": cfg["name"], "source": cfg["source"], "file": path,
                                "reduced": [], "why": "toy widths for the CPU tests"})
        spec["workloads"].append({"name": cell, "config": cfg["name"], "traffic": "tiny",
                                  "chips": 1, "why": "toy size for the CPU tests"})
    (root / "benchmarks" / "traffic" / "tiny.json").write_text(json.dumps(TRAFFIC))
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root
