"""The readings ``cal_tvr``'s limits are set from, many seeds in one
process, and the runs that must not be correct.

    python3 benchmarks/readings_cal.py --workload cal-b1000 --seconds 2 \
        --seeds 11 12 13 [--stand-in control|sq_dropped|stream_dropped|merge_reversed]

Each seed is a whole run of the cell (set-up, a short window at the cell's
own load, the check against the reference) through ``harness.run_cell``;
one JSON line a seed gives its compared numbers. A stand-in takes the
place of the program's ``score_cal_batch``: ``control`` is the reference
one precision below the stated one (``programs/cal.py::control_score_fn``),
whose numbers are the upper readings, which have to fail the limits;
``sq_dropped`` scores without the proposals' mean squared norms,
``stream_dropped`` with the video stream alone and ``merge_reversed``
merges the chunks' top lists last chunk first, so that ties across a
chunk's edge come out of ``lax.top_k``'s order: faults the check has to
catch (``FAULTS``; ``benchmarks/tests/test_bench_cal.py`` plants them on
the CPU). Not run by the benchmark's own runs.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent

# each planted fault, and the compared number it has to push past its limit
FAULTS = {"sq_dropped": "q2c_err", "stream_dropped": "q2c_err", "merge_reversed": "vcmr_gap"}


def _refolded(fold):
    """A stand-in scoring a copy of the cache whose scoring rows ``fold``
    made from the cache's own."""
    from tvretrieval_tpu_torch.retrieval.proposal_engine import score_cal_batch
    done = {}

    def score(model, cache, *args):
        if id(cache) not in done:
            done.clear()
            done[id(cache)] = dataclasses.replace(cache, score_rows=fold(model, cache))
        return score_cal_batch(model, done[id(cache)], *args)
    return score


def _sq_dropped(model, cache):
    rows = cache.score_rows.clone()
    Do = model.cfg.output_size
    keep = rows[:, Do] <= -1e10          # padded and alignment slots keep theirs
    rows[:, Do] = torch.where(keep, rows[:, Do], 0.0)
    return rows


def _stream_dropped(program, config: dict, seed: int):
    """A stand-in scoring with the video stream alone: a second cache built
    by ``encode_cal_corpus`` from the seed's corpus through a video-only
    copy of the model (its moment MLP and query encoder the same)."""
    from tvretrieval_tpu_torch.models.cal import CALWithSub
    from tvretrieval_tpu_torch.retrieval.proposal_engine import (encode_cal_corpus,
                                                                 score_cal_batch)
    done = {}

    def score(model, cache, q_feat, q_mask, gt, cfg):
        if id(cache) not in done:
            done.clear()
            device = next(model.parameters()).device
            video = CALWithSub(dataclasses.replace(model.cfg, ctx_mode="video")).eval().to(device)
            video.load_state_dict({k: v for k, v in model.state_dict().items()
                                   if not k.startswith("sub_moment_mlp.")}, strict=True)
            blocks, n_clips, durations = program.corpus(config, device, seed)
            done[id(cache)] = (video, encode_cal_corpus(video, blocks, n_clips, cfg, durations))
        return score_cal_batch(*done[id(cache)], q_feat, q_mask, gt, cfg)
    return score


def _merge_reversed():
    from tvretrieval_tpu_torch.ops.span import topk_stable_blocked_psort_inplace as select
    from tvretrieval_tpu_torch.retrieval import proposal_engine as pe

    @torch.no_grad()
    def score(model, cache, q_feat, q_mask, gt, cfg):
        out = pe.score_cal_batch(model, cache, q_feat, q_mask, gt, cfg)
        rows = cache.score_rows
        nv, P = cache.prop_mask.shape
        n, k = nv * P, out["vcmr_scores"].shape[1]
        a = pe._query_rows(model, q_feat, q_mask, rows.shape[1])
        chunk = -(-cfg.proposal_chunk // pe.ROW_ALIGN) * pe.ROW_ALIGN
        vals, idxs = [], []
        for c0 in range(0, n, chunk):
            v, i = select(a @ rows[c0:c0 + chunk].T, min(k, rows[c0:c0 + chunk].shape[0]))
            vals.insert(0, v)
            idxs.insert(0, i + c0)
        v, pos = select(torch.cat(vals, 1), k)
        flat = torch.gather(torch.cat(idxs, 1), 1, pos.long()).long()
        out.update(vcmr_video=(flat // P).int(), vcmr_prop=(flat % P).int(),
                   vcmr_spans=cache.span_table[flat], vcmr_scores=v)
        return out
    return score


def stand_in(name: str, program, config: dict, device, seed: int):
    """The stand-in for ``score_cal_batch`` named ``name``: "control" or
    one of ``FAULTS``."""
    if name == "control":
        return program.control_score_fn(config, device, seed)
    return {"sq_dropped": lambda: _refolded(_sq_dropped),
            "stream_dropped": lambda: _stream_dropped(program, config, seed),
            "merge_reversed": _merge_reversed}[name]()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", default="cal-b1000")
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
                          "peak_gib": res["device"]["memory_peak_bytes"] / 2 ** 30,
                          "seconds": time.perf_counter() - t}), flush=True)
        del fn
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
