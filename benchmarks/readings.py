"""The readings a cell's limits are set from, many seeds in one process.

    python3 benchmarks/readings.py --workload shipped-b1000 --seconds 2 \
        --seeds 11 12 13 [--control]

Each seed is a whole run of the cell (set-up, a short window at the cell's
own load, the check against the reference) through ``harness.run_cell``;
one JSON line a seed gives its compared numbers. With ``--control`` the
reference computed one precision below the configuration's
(``xml_ref.CONTROL``) stands in the program's place: its numbers are the
upper readings, which have to fail the limits. Not run by the benchmark's
own runs.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def control_score_fn(config: dict, device, seed: int):
    """A stand-in for ``_score_query_batch``: the control reference over the
    seed's own weights and corpus, with the engine's signature."""
    from benchmarks import synth
    from benchmarks.reference.xml_ref import CONTROL, Reference

    ref = Reference(synth.make_weights(config["model"], device, seed),
                    synth.make_corpus(config["corpus"], config["model"], device, seed),
                    config["model"], config["retrieval"], config["semantics"], CONTROL)

    def score(model, rcfg, q_feat, q_mask, vf1, vf2, sf1, sf2, mask, gt, do_svmr, **_):
        return {k: torch.as_tensor(v) for k, v in ref.score_batch(q_feat, q_mask, gt).items()}

    return score


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--control", action="store_true")
    args = parser.parse_args()
    sys.path[0] = str(ROOT)
    from benchmarks import harness

    _, config, _ = harness.resolve(harness.load_spec(ROOT), args.workload, ROOT)
    for seed in args.seeds:
        t = time.perf_counter()
        fn = control_score_fn(config, "cuda:0", seed) if args.control else None
        res = harness.run_cell(args.workload, seed, args.seconds, False, "cuda:0", t, ROOT,
                               score_fn=fn, log=lambda s: print(s, file=sys.stderr))
        print(json.dumps({"workload": args.workload, "seed": seed, "control": args.control,
                          "correct": res["correct"], "calls": res["attempted"],
                          "checks": {k: v["value"] for k, v in res["checks"].items()},
                          "moment_recall_pct": res["metrics"].get("moment_recall_pct", {}).get(
                              "value"),
                          "seconds": time.perf_counter() - t}), flush=True)
        del fn
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
