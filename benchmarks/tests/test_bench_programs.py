"""XML through the program seam answers as the harness's own order of calls
does: a run of each tiny XML cell against the XML program's ``build``,
``queries``, ``call`` and ``judge`` driven directly, in that order, over as
many calls as the run made."""
from __future__ import annotations

import math
import random
import re
import time

import numpy as np
import pytest

from benchmarks import harness, synth
from benchmarks.tests import tiny

SEED = 2 ** 33 + 7


def _direct(program, config, traffic, seed, n_calls):
    """(the numbers of ``judge``, the kept calls' indices) of a run of
    ``n_calls`` window calls, written out step by step."""
    nq, nv = traffic["queries_per_call"], config["corpus"]["n_videos"]
    state = program.build(config, "cpu", seed)
    for w in range(harness.WARMUP_CALLS):
        program.call(state, program.queries(traffic, config, nv, "cpu", seed, ("warmup", w)))
    n_keep = math.ceil(traffic["check_queries"] / nq)
    pick = random.Random(synth.sub_seed(seed, "check sample"))
    kept = []
    for i in range(n_calls):
        out = program.call(state, program.queries(traffic, config, nv, "cpu", seed, i))
        host = {k: v.cpu().numpy() for k, v in out.items()}
        if len(kept) < n_keep:
            kept.append((i, host))
        else:
            j = pick.randrange(i + 1)
            if j < n_keep:
                kept[j] = (i, host)
    del state
    kept.sort(key=lambda t: t[0])
    qs = [program.queries(traffic, config, nv, "cpu", seed, i) for i, _ in kept]
    outputs = {k: np.concatenate([h[k] for _, h in kept]) for k in kept[0][1]}
    return program.judge(config, traffic, "cpu", seed, qs, outputs), [i for i, _ in kept]


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_xml_through_the_seam_answers_as_before(tiny_root, cell):
    lines = []
    res = harness.run_cell(cell, SEED, 0.3, False, "cpu", time.perf_counter(), tiny_root,
                           log=lines.append)
    _, config, traffic = harness.resolve(harness.load_spec(tiny_root), cell, tiny_root)
    program = harness.load_program(config, tiny_root)
    assert "program" not in config and program.__file__.endswith("programs/xml.py")
    nq = traffic["queries_per_call"]
    assert res["attempted"] % nq == 0 and res["attempted"] >= nq
    numbers, kept = _direct(program, config, traffic, SEED, res["attempted"] // nq)
    assert {k: c["value"] for k, c in res["checks"].items()} == {
        k: numbers[k] for k in config["limits"]}
    logged = next(re.match(r"\[check\] \d+ calls \(([\d, ]+)\)", s) for s in lines
                  if s.startswith("[check]"))
    assert [int(i) for i in logged.group(1).split(", ")] == kept
