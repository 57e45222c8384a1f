"""One run of one cell: set-up, the measured window, the check, the metrics.

Everything a cell needs is found by name. ``BENCHMARK.json`` names the
cell's configuration and traffic mix and lists the metrics; the
configuration is the file its entry names (``benchmarks/configs/``), the
traffic mix ``benchmarks/traffic/<traffic>.json``, each metric
``benchmarks/metrics/<metric>.py``, a module whose ``read(run)`` returns
the metric's value or None where it has nothing to read (and whose optional
``describe(run)`` returns lines printed before the result), and the
configuration's program ``benchmarks/programs/<program>.py``, where
``<program>`` is the configuration's key ``"program"``, or ``xml`` without
it. A new configuration, traffic mix, metric or program is a new file and
a new entry: no file here changes.

A program is the system under test's side of a cell. Its module defines:

- ``build(config, device, seed) -> state``: the model with the seed's
  weights and its resident corpus, made by the port's own entry points.
  Called once, first thing in set-up.
- ``queries(traffic, config, n_videos, device, seed, i) -> tuple``: one
  call's inputs, drawn from the seed; ``i`` is the call's number in the
  window, or ``("warmup", w)``. Called before each warm-up call, before
  each call of the window (span ``queries``), and again after the window
  for the calls the check samples.
- ``call(state, queries) -> {name: tensor}``: one call of the port's
  per-batch entry, on ``queries``'s tuple. Called for each warm-up call
  and in the window (span ``score_query_batch``); the harness then copies
  every output to the host (span ``copy_out``). A program whose ``call``
  takes ``score_fn`` lets ``run_cell(score_fn=...)`` stand in for its
  entry (the tests plant faults and the control through it).
- ``judge(config, traffic, device, seed, queries, outputs) -> {name:
  number}``: builds the program's own plain reference and returns the
  numbers that the configuration's ``limits`` hold (larger is worse);
  ``queries`` is the list of the sampled calls' tuples in call order,
  ``outputs`` their host outputs concatenated by rows. Called once, after
  the window, with ``state`` dropped and the CUDA cache emptied.
- optionally ``token_lengths(traffic, device, seed, calls)``: each call's
  query token lengths, which ``Run.token_lens`` holds in a traced run.

The window drives ``call`` in a closed loop with one caller; every call
is followed by the copy of all its outputs to the host.
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import random
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from benchmarks import synth

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tvretrieval_tpu")
WARMUP_CALLS = 3
DEFAULT_PROGRAM = "xml"


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def resolve(spec: dict, cell_name: str, root: Path = ROOT):
    """(cell entry, configuration file's dict, traffic file's dict)."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if cell_name not in cells:
        raise KeyError(f"no workload {cell_name!r} in BENCHMARK.json; have {sorted(cells)}")
    cell = cells[cell_name]
    entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    with open(root / entry["file"]) as f:
        config = json.load(f)
    with open(root / "benchmarks" / "traffic" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)
    return cell, config, traffic


def cell_metrics(spec: dict, cell_name: str, trace: bool) -> List[dict]:
    """The metric entries a run of ``cell_name`` reports: its end-to-end
    metrics, or with ``trace`` its per-layer ones (a per-layer metric
    without ``workloads`` goes with every cell that reports what it
    moves)."""
    e2e = [m for m in spec["end_to_end"] if cell_name in m.get("workloads", [cell_name])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def _load(module_name: str, path: Path):
    """The module at ``path``, registered in ``sys.modules`` as
    ``module_name`` while it loads, as an import would."""
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[module_name] = module
    spec.loader.exec_module(module)
    return module


def load_metric(name: str, root: Path = ROOT):
    return _load(f"benchmarks.metrics.{name}", root / "benchmarks" / "metrics" / f"{name}.py")


def load_program(config: dict, root: Path = ROOT):
    """The configuration's program, ``benchmarks/programs/<name>.py``."""
    name = config.get("program", DEFAULT_PROGRAM)
    return _load(f"benchmarks.programs.{name}",
                 root / "benchmarks" / "programs" / f"{name}.py")


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def verdict(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, [(name, value, limit)]) over the numbers ``limits`` names;
    a number the program's judge did not give reads inf."""
    rows = [(k, numbers.get(k, math.inf), float(lim)) for k, lim in limits.items()]
    ok = all(math.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows


@dataclass
class Run:
    """What a metric reads of one run."""

    cell: str
    config: dict
    traffic: dict
    seed: int
    nq: int
    n_calls: int = 0
    window_s: float = 0.0
    setup_s: float = 0.0
    latencies_s: List[float] = field(default_factory=list)
    enqueue_s: List[float] = field(default_factory=list)
    token_lens: List[np.ndarray] = field(default_factory=list)
    peak_bytes: int = 0
    numbers: Dict[str, float] = field(default_factory=dict)
    trace: Optional[object] = None

    @property
    def model(self) -> dict:
        return self.config["model"]

    @property
    def retrieval(self) -> dict:
        return self.config["retrieval"]

    @property
    def corpus(self) -> dict:
        return self.config["corpus"]

    @property
    def semantics(self) -> dict:
        return self.config["semantics"]


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, root: Path = ROOT,
             score_fn: Optional[Callable] = None, log=print) -> dict:
    """One run; returns the result object (the last line's JSON) with
    the compared numbers under ``checks``. ``score_fn`` stands in for the
    program's per-batch entry (the tests plant faults through it)."""
    spec = load_spec(root)
    cell, config, traffic = resolve(spec, cell_name, root)
    if traffic.get("loop") != "closed" or traffic.get("callers") != 1:
        raise ValueError(f"traffic {cell['traffic']}: only a closed loop with one caller")
    device = torch.device(device)
    on_card = device.type == "cuda"
    program = load_program(config, root)
    stand_in = {} if score_fn is None else {"score_fn": score_fn}
    nq = traffic["queries_per_call"]
    run = Run(cell=cell_name, config=config, traffic=traffic, seed=seed, nq=nq)
    nv = config["corpus"]["n_videos"]

    # ---------------------------------------------------------------- set-up
    state = program.build(config, device, seed)

    def call(queries):
        return program.call(state, queries, **stand_in)

    for w in range(WARMUP_CALLS):
        queries = program.queries(traffic, config, nv, device, seed, ("warmup", w))
        {k: v.cpu().numpy() for k, v in call(queries).items()}
    if on_card:
        torch.cuda.synchronize(device)
    run.setup_s = time.perf_counter() - t_start
    log(f"[setup] {run.setup_s:.3f} s to the first timed call")

    # ---------------------------------------------------------------- window
    n_keep = math.ceil(traffic["check_queries"] / nq)
    pick = random.Random(synth.sub_seed(seed, "check sample"))
    kept: List[tuple] = []
    spans: List[tuple] = []

    @contextlib.contextmanager
    def span(name):
        if not trace:
            yield
            return
        a = time.time_ns()
        yield
        spans.append((name, a, time.time_ns()))

    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CUDA] if on_card else [ProfilerActivity.CPU])
        prof.__enter__()
    try:
        w0 = time.time_ns()
        start = time.perf_counter()
        deadline = start + seconds
        i = 0
        while i == 0 or time.perf_counter() < deadline:
            with span("queries"):
                queries = program.queries(traffic, config, nv, device, seed, i)
            t0 = time.perf_counter()
            with span("score_query_batch"):
                out = call(queries)
            t1 = time.perf_counter()
            with span("copy_out"):
                host = {k: v.cpu().numpy() for k, v in out.items()}
            t2 = time.perf_counter()
            run.latencies_s.append(t2 - t0)
            run.enqueue_s.append(t1 - t0)
            # a uniform sample of the calls, drawn from the seed
            if len(kept) < n_keep:
                kept.append((i, host))
            else:
                j = pick.randrange(i + 1)
                if j < n_keep:
                    kept[j] = (i, host)
            i += 1
        end = time.perf_counter()
        w1 = time.time_ns()
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    run.n_calls, run.window_s = i, end - start
    if on_card:
        run.peak_bytes = torch.cuda.max_memory_allocated(device)
    lat = np.sort(np.asarray(run.latencies_s)) * 1e3
    log(f"[window] {i} calls in {run.window_s:.3f} s; ms a call: min {lat[0]:.3f}, "
        f"median {np.median(lat):.3f}, p95 {np.percentile(lat, 95):.3f}, max {lat[-1]:.3f}; "
        f"host enqueue median {1e3 * np.median(run.enqueue_s):.3f}")
    if prof is not None:
        from benchmarks.timeline import Trace
        run.trace = Trace(prof, spans, w0, w1)
        del prof
        if hasattr(program, "token_lengths"):
            run.token_lens = program.token_lengths(traffic, device, seed, i)

    # ------------------------------------------------- the program's state goes
    del state, call, queries, out
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # ------------------------------------------------------------- the check
    t_check = time.perf_counter()
    kept.sort(key=lambda t: t[0])
    qs = [program.queries(traffic, config, nv, device, seed, i) for i, _ in kept]
    outputs = {k: np.concatenate([h[k] for _, h in kept]) for k in kept[0][1]}
    run.numbers = program.judge(config, traffic, device, seed, qs, outputs)
    correct, rows = verdict(run.numbers, config["limits"])
    log(f"[check] {len(kept)} calls ({', '.join(str(i) for i, _ in kept)}), "
        f"{len(kept) * nq} queries against the reference in "
        f"{time.perf_counter() - t_check:.2f} s")
    del qs, outputs, kept
    gc.collect()

    # ------------------------------------------------------------- metrics
    metrics = {}
    for entry in cell_metrics(spec, cell_name, trace):
        module = load_metric(entry["name"], root)
        for line in getattr(module, "describe", lambda r: [])(run):
            log(f"[{entry['name']}] {line}")
        value = module.read(run)
        if value is not None:
            metrics[entry["name"]] = {"value": float(value), "unit": entry["unit"]}
    dev_info = {"platform": "gpu" if on_card else "cpu",
                "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                "count": 1, "memory_peak_bytes": int(run.peak_bytes)}
    result = {"correct": bool(correct), "attempted": run.n_calls * nq, "failed": 0,
              "metrics": metrics, "device": dev_info}
    if run.trace is not None:
        dev_info.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        result["breakdown"] = {"device_ops": run.trace.device_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    result["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in rows}
    return result
