"""One run of one cell: set-up, the measured window, the check, the metrics.

Everything a cell needs is found by name. ``BENCHMARK.json`` names the
cell's configuration and traffic mix and lists the metrics; the
configuration is the file its entry names (``benchmarks/configs/``), the
traffic mix ``benchmarks/traffic/<traffic>.json``, and each metric
``benchmarks/metrics/<metric>.py``, a module whose ``read(run)`` returns
the metric's value or None where it has nothing to read (and whose optional
``describe(run)`` returns lines printed before the result). A new
configuration, traffic mix or metric is a new file and a new entry: no
file here changes.

The window drives the engine's per-batch entry,
``tvretrieval_tpu_torch.retrieval.engine._score_query_batch``, in a closed
loop with one caller; every call is followed by the copy of all its
outputs to the host, as the engine's ``retrieve`` does.
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

from benchmarks import check, synth
from benchmarks.reference.xml_ref import Reference

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tvretrieval_tpu")
WARMUP_CALLS = 3


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


def load_metric(name: str, root: Path = ROOT):
    path = root / "benchmarks" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmarks.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


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


def _port():
    """The system under test: the port's model and engine entry points."""
    from tvretrieval_tpu_torch.models.xml import XML, XMLConfig
    from tvretrieval_tpu_torch.retrieval.engine import (
        RetrievalConfig, _finish_cache, _score_query_batch)
    return XML, XMLConfig, RetrievalConfig, _finish_cache, _score_query_batch


def build_program(config: dict, device, seed: int):
    """Set-up of the system under test: the model with the seed's weights,
    and the corpus cache made by the engine's own ``_finish_cache`` from the
    seed's encoder outputs. Returns (model, retrieval config, cache)."""
    XML, XMLConfig, RetrievalConfig, finish_cache, _ = _port()
    model = XML(XMLConfig(**config["model"])).eval().to(device)
    weights = synth.make_weights(config["model"], device, seed)
    missing, unexpected = model.load_state_dict(weights, strict=False)
    context_side = ("video_input_proj", "sub_input_proj", "video_encoder", "sub_encoder",
                    "video_cross", "sub_cross", "ctx_pos_embed")
    if unexpected or any(not k.startswith(context_side) for k in missing):
        raise RuntimeError(f"weights do not fit the model: missing {missing}, "
                           f"unexpected {unexpected}")
    rcfg = RetrievalConfig(**config["retrieval"])
    corpus = config["corpus"]
    bufs = synth.make_corpus(corpus, config["model"], device, seed)
    cache = finish_cache(model, rcfg, synth.CorpusNames(
        corpus["n_videos"], corpus["n_clips"] * corpus["clip_length"]), bufs)
    del bufs
    return model, rcfg, cache


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, root: Path = ROOT,
             score_fn: Optional[Callable] = None, log=print) -> dict:
    """One run; returns the result object (the last line's JSON) with
    the compared numbers under ``checks``. ``score_fn`` stands in for the
    engine's ``_score_query_batch`` (the tests plant faults through it)."""
    spec = load_spec(root)
    cell, config, traffic = resolve(spec, cell_name, root)
    if traffic.get("loop") != "closed" or traffic.get("callers") != 1:
        raise ValueError(f"traffic {cell['traffic']}: only a closed loop with one caller")
    device = torch.device(device)
    on_card = device.type == "cuda"
    if score_fn is None:
        score_fn = _port()[4]
    nq = traffic["queries_per_call"]
    run = Run(cell=cell_name, config=config, traffic=traffic, seed=seed, nq=nq)
    nv = config["corpus"]["n_videos"]

    # ---------------------------------------------------------------- set-up
    model, rcfg, cache = build_program(config, device, seed)

    def call(q_feat, q_mask, gt):
        return score_fn(model, rcfg, q_feat, q_mask, cache.video_feat1, cache.video_feat2,
                        cache.sub_feat1, cache.sub_feat2, cache.mask, gt, True,
                        feat2_cat=cache.feat2_cat, feat2_cat_scale=cache.feat2_cat_scale)

    for w in range(WARMUP_CALLS):
        q_feat, q_mask, gt = synth.make_queries(traffic, config["model"], nv, device, seed,
                                                ("warmup", w))
        {k: v.cpu().numpy() for k, v in call(q_feat, q_mask, gt).items()}
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
                q_feat, q_mask, gt = synth.make_queries(
                    traffic, config["model"], nv, device, seed, i)
            t0 = time.perf_counter()
            with span("score_query_batch"):
                out = call(q_feat, q_mask, gt)
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
        run.token_lens = synth.token_lengths(traffic, device, seed, i)

    # ------------------------------------------------- the program's state goes
    del model, cache, call, out
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # ------------------------------------------------------------- the check
    t_check = time.perf_counter()
    ref = Reference(synth.make_weights(config["model"], device, seed),
                    synth.make_corpus(config["corpus"], config["model"], device, seed),
                    config["model"], config["retrieval"], config["semantics"])
    kept.sort(key=lambda t: t[0])
    qs = [synth.make_queries(traffic, config["model"], nv, device, seed, i) for i, _ in kept]
    prog = {k: np.concatenate([h[k] for _, h in kept]) for k in kept[0][1]}
    run.numbers = check.judge(ref, torch.cat([q[0] for q in qs]), torch.cat([q[1] for q in qs]),
                              torch.cat([q[2] for q in qs]), prog)
    correct, rows = check.verdict(run.numbers, config["limits"])
    log(f"[check] {len(kept)} calls ({', '.join(str(i) for i, _ in kept)}), "
        f"{sum(len(q[2]) for q in qs)} queries against the reference in "
        f"{time.perf_counter() - t_check:.2f} s")
    del ref, qs, prog, kept
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
