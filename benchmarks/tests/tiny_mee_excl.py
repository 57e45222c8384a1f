"""A tiny MEE + ExCL configuration for CPU tests: ``mee_excl_tvr`` with
every setting, semantics and limit kept and toy widths, corpus and batch,
added to a tiny root as files and entries (the cell ``tiny-meeexcl``)."""
from __future__ import annotations

import json
from pathlib import Path

from benchmarks.tests import tiny

CELL = "tiny-meeexcl"
TRAFFIC = {"loop": "closed", "callers": 1, "queries_per_call": 8, "token_len": [4, 12],
           "gt_video": "uniform", "check_queries": 16}


def config() -> dict:
    with open(tiny.BENCH_DIR / "configs" / "mee_excl_tvr.json") as f:
        cfg = json.load(f)
    cfg["model"]["mee"].update(text_input_size=48, vid_input_size=40, sub_input_size=24,
                               output_size=16)
    cfg["model"]["excl"].update(visual_input_size=42, sub_input_size=26, query_input_size=48,
                                hidden_size=16)
    cfg["model"]["max_desc_l"] = 12
    cfg["corpus"].update(n_videos=300, n_clips=24, block_videos=64)
    cfg["retrieval"].update(top_n_videos=20, top_n_per_video=5, max_before_nms=30,
                            max_pred_l=8)
    cfg["name"] = "tiny_mee_excl"
    return cfg


def add_to(root: Path, per_layer: bool = False) -> None:
    """The tiny configuration, its traffic mix and its cell added to the
    tiny ``root``; with ``per_layer`` the cell also joins the per-layer
    metrics of ``meeexcl-b50``."""
    cfg = config()
    path = f"benchmarks/configs/{cfg['name']}.json"
    (root / path).write_text(json.dumps(cfg, indent=1))
    (root / "benchmarks" / "traffic" / "tiny_b8.json").write_text(json.dumps(TRAFFIC))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": cfg["name"], "source": cfg["source"], "file": path,
                            "reduced": [], "why": "toy widths for the CPU tests"})
    spec["workloads"].append({"name": CELL, "config": cfg["name"], "traffic": "tiny_b8",
                              "chips": 1, "why": "toy size for the CPU tests"})
    if per_layer:
        for m in spec["end_to_end"] + spec["per_layer"]:
            if "meeexcl-b50" in m.get("workloads", []):
                m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
