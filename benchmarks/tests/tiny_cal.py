"""A tiny CAL configuration for CPU tests: ``cal_tvr`` with every setting,
semantics and limit kept and toy widths, corpus and batch, added to a tiny
root as files and entries (the cell ``tiny-cal``). Its videos last 60 s
but hold 24 clips of 1.5 s: the proposals that start past the clips all
take the last two (the data layer's edge), so many tie exactly, and the
proposal axis is scored in chunks of 40 that cut through them."""
from __future__ import annotations

import json
from pathlib import Path

from benchmarks.tests import tiny

CELL = "tiny-cal"
TRAFFIC = {"loop": "closed", "callers": 1, "queries_per_call": 8, "token_len": [4, 12],
           "gt_video": "uniform", "check_queries": 16}


def config() -> dict:
    with open(tiny.BENCH_DIR / "configs" / "cal_tvr.json") as f:
        cfg = json.load(f)
    cfg["model"].update(query_feat_size=48, lstm_hidden_size=32, visual_hidden_size=24,
                        output_size=16, visual_input_size=40, textual_input_size=24,
                        max_desc_l=12, max_ctx_l=24)
    cfg["corpus"].update(n_videos=300, n_clips=24, block_videos=64, duration=60.0)
    cfg["proposals"].update(per_video=65)
    cfg["retrieval"].update(proposal_chunk=40)
    cfg["name"] = "tiny_cal"
    return cfg


def add_to(root: Path, per_layer: bool = False) -> None:
    """The tiny configuration, its traffic mix and its cell added to the
    tiny ``root``; with ``per_layer`` the cell also joins the metrics of
    ``cal-b1000``."""
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
            if "cal-b1000" in m.get("workloads", []):
                m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
