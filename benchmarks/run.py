"""Run one cell of the port's benchmark once, on the machine it starts on.

    python3 benchmarks/run.py --workload shipped-b1000 --seed 7 --seconds 10 --trace 0

Prints progress and the compared numbers, each beside its limit, and ends
with one JSON line on standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``. Exits 1 and prints no result without a
CUDA card, or if JAX or the JAX package got loaded.

The system under test is the program that the cell's configuration names
(key ``"program"``, ``xml`` without it): ``benchmarks/programs/<name>.py``,
which defines ``build`` (called once in set-up), ``queries`` and ``call``
(each warm-up call and each call of the window; ``queries`` again after
the window for the sampled calls), ``judge`` (once, after the window, with
the program's state freed) and optionally ``token_lengths`` (traced runs).
``harness.py``'s docstring gives their signatures.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BUILD = ROOT / "benchmarks" / ".cache"


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args()
    # a library that would load JAX by itself is kept from it, and every
    # kernel cache of the process stays at a fixed path in the checkout
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_TF", "0")
    os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(BUILD / "nv")
    # the repository's root in place of this script's folder, whose module
    # names are the package's
    sys.path[0] = str(ROOT)
    import torch

    from benchmarks import harness

    # one host thread: the engine's host work is one thread issuing to the
    # card, and idle pool threads would only compete with it
    torch.set_num_threads(1)

    spec = harness.load_spec(ROOT)
    cell, _, _ = harness.resolve(spec, args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"run.py: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              "cuda:0", T_START, ROOT, log=lambda s: print(s, flush=True))
    found = harness.forbidden_modules()
    if found:
        print(f"run.py: modules loaded that the port must not load: {found}", file=sys.stderr)
        return 1
    for name, c in result["checks"].items():
        ok = c["value"] <= c["limit"]
        if c["value"] == float("inf"):
            c["value"] = "inf"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {'ok' if ok else 'FAIL'}",
              file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
