"""``correct`` comes out false where it must: the control (the reference one
precision below the configuration's, in the program's place) and the
faults a retrieval cell can have, planted under a run that skips only the
harness's look for a card."""
from __future__ import annotations

import time

import pytest
import torch

from benchmarks import harness
from benchmarks.readings import control_score_fn
from benchmarks.tests import tiny
from tvretrieval_tpu_torch.retrieval.engine import _score_query_batch

SEED = 2 ** 35 + 1


def _run(root, cell, device, score_fn):
    return harness.run_cell(cell, SEED, 0.3, False, device, time.perf_counter(), root,
                            score_fn=score_fn, log=lambda s: None)


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_control_is_not_correct(tiny_root, device, cell):
    _, config, _ = harness.resolve(harness.load_spec(tiny_root), cell, tiny_root)
    res = _run(tiny_root, cell, device, control_score_fn(config, device, SEED))
    assert not res["correct"]
    failed = [k for k, c in res["checks"].items() if not c["value"] <= c["limit"]]
    # the lower precision shows at every stage the check compares
    assert {"q2c_err", "span_err"} <= set(failed), res["checks"]


def _half_batch(*args, **kw):
    """Half of the batch left out: the second half's answers copied from
    the first half's."""
    out = _score_query_batch(*args, **kw)
    half = out["topv_idx"].shape[0] // 2
    return {k: torch.cat([v[:half], v[:v.shape[0] - half]]) for k, v in out.items()}


def _altered(key, fn):
    def score(*args, **kw):
        out = _score_query_batch(*args, **kw)
        out[key] = fn(out[key].clone())
        return out
    return score


def _shift(v):
    v[3, 0] = (v[3, 0] + 7) % 300
    return v


def _later_start(v):
    v[5, 0] += 1
    return v


def _scaled(v):
    v[2, 4] *= 1.5
    return v


FAULTS = {
    "half_batch_left_out": _half_batch,
    "video_altered": _altered("topv_idx", _shift),
    "video_score_altered": _altered("topv_scores", _scaled),
    "moment_start_altered": _altered("vcmr_st", _later_start),
    "moment_score_altered": _altered("vcmr_scores", _scaled),
    "svmr_start_altered": _altered("svmr_st", _later_start),
}


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_faults_are_not_correct(tiny_root, cell, fault):
    assert not _run(tiny_root, cell, "cpu", FAULTS[fault])["correct"]
