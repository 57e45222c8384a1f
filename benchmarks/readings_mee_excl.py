"""The readings ``mee_excl_tvr``'s limits are set from, many seeds in one
process, and the runs that must not be correct.

    python3 benchmarks/readings_mee_excl.py --workload meeexcl-b50 --seconds 2 \
        --seeds 11 12 13 [--stand-in control|moment_score_nudged|...]

Each seed is a whole run of the cell (set-up, a short window at the cell's
own load, the check against the reference) through ``harness.run_cell``;
one JSON line a seed gives its compared numbers. A stand-in takes the
place of the program's ``score_mee_excl_batch``: ``control`` is the
reference one precision below the stated one (``programs/mee_excl.py::
control_score_fn``), whose numbers are the upper readings, which have to
fail the limits; ``moment_score_nudged`` scales one returned moment's score
by 1.01, ``video_swapped`` replaces one returned video by another and
``svmr_start_altered`` moves one SVMR span's start, faults the check has
to catch (``FAULTS``; ``benchmarks/tests/test_bench_mee_excl.py`` plants
them on the CPU). Not run by the benchmark's own runs.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def _altered(key, fn):
    from tvretrieval_tpu_torch.retrieval.excl_engine import score_mee_excl_batch

    def score(*args, **kw):
        out = score_mee_excl_batch(*args, **kw)
        out[key] = fn(out[key].clone())
        return out
    return score


def _nudge(v):
    v[2, 4] *= 1.01
    return v


def _later_start(v):
    v[5, 0, 0] += 1
    return v


# each planted fault, and the compared number it has to push past its limit
FAULTS = {"moment_score_nudged": "span_err", "video_swapped": "q2c_err",
          "svmr_start_altered": "svmr_err"}


def stand_in(name: str, program, config: dict, device, seed: int):
    """The stand-in for ``score_mee_excl_batch`` named ``name``: "control"
    or one of ``FAULTS``."""
    if name == "control":
        return program.control_score_fn(config, device, seed)
    nv = config["corpus"]["n_videos"]

    def swap(v):
        v[3, 0] = (v[3, 0] + 7) % nv
        return v

    return {"moment_score_nudged": _altered("moment_scores", _nudge),
            "video_swapped": _altered("vr_idx", swap),
            "svmr_start_altered": _altered("svmr", _later_start)}[name]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", default="meeexcl-b50")
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--stand-in", choices=("control", *FAULTS))
    args = parser.parse_args()
    sys.path[0] = str(ROOT)
    from benchmarks import harness

    torch.set_num_threads(1)
    _, config, _ = harness.resolve(harness.load_spec(ROOT), args.workload, ROOT)
    program = harness.load_program(config, ROOT)
    for seed in args.seeds:
        t = time.perf_counter()
        fn = stand_in(args.stand_in, program, config, "cuda:0", seed) if args.stand_in else None
        res = harness.run_cell(args.workload, seed, args.seconds, False, "cuda:0", t, ROOT,
                               score_fn=fn, log=lambda s: print(s, file=sys.stderr))
        print(json.dumps({"workload": args.workload, "seed": seed, "stand_in": args.stand_in,
                          "correct": res["correct"], "queries": res["attempted"],
                          "checks": {k: v["value"] for k, v in res["checks"].items()},
                          "metrics": {k: v["value"] for k, v in res["metrics"].items()},
                          "seconds": time.perf_counter() - t}), flush=True)
        del fn
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
