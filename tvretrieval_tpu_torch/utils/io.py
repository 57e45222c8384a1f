"""Small host-side IO / math helpers (the port's own copy of the JAX
package's ``utils/io.py``; numpy only).

Capability parity with reference ``utils/basic_utils.py`` (load/save json(l),
l2_normalize_np_array:82, AverageMeter:118, dissect_by_lengths:146), written
fresh for this framework.
"""
from __future__ import annotations

import json
import os
from typing import Any, Iterable, List, Sequence

import numpy as np


def load_json(path: str) -> Any:
    with open(path, "r") as f:
        return json.load(f)


class _FsyncThrottledFile:
    """File wrapper fsyncing every ``chunk`` written bytes.

    Dumping tens of GB of large numpy buffers with pickle outruns slow
    disks by GB/s; the kernel accumulates dirty pages up to vm.dirty_ratio
    (~20% of RAM) which cannot be reclaimed, and on a RAM-full host the OOM
    killer fires mid-dump (observed killing the TVR-scale run at its 17GB
    cache write). Bounding un-synced bytes keeps reclaimable headroom."""

    def __init__(self, f, chunk: int = 256 * 1024 * 1024):
        self._f = f
        self._chunk = chunk
        self._since_sync = 0

    def write(self, data) -> int:
        n = self._f.write(data)
        self._since_sync += n
        if self._since_sync >= self._chunk:
            self._f.flush()
            os.fsync(self._f.fileno())
            self._since_sync = 0
        return n

    def flush(self) -> None:
        self._f.flush()


def dump_pickle_throttled(obj: Any, path: str,
                          chunk: int = 256 * 1024 * 1024) -> None:
    """pickle.dump with bounded dirty-page footprint (see _FsyncThrottledFile)."""
    import pickle

    with open(path, "wb") as f:
        pickle.dump(obj, _FsyncThrottledFile(f, chunk), protocol=5)
        f.flush()
        os.fsync(f.fileno())


def save_json(obj: Any, path: str, pretty: bool = False, sort_keys: bool = False) -> None:
    with open(path, "w") as f:
        if pretty:
            json.dump(obj, f, indent=4, sort_keys=sort_keys)
        else:
            json.dump(obj, f)


def load_jsonl(path: str) -> List[Any]:
    with open(path, "r") as f:
        return [json.loads(line) for line in f if line.strip()]


def save_jsonl(rows: Iterable[Any], path: str) -> None:
    with open(path, "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")


def l2_normalize(x: np.ndarray, axis: int = -1, eps: float = 1e-5) -> np.ndarray:
    """L2-normalize along ``axis``.

    Matches reference utils/basic_utils.py:82 (``x / norm(x, axis=-1)``,
    eps=1e-5 added to the denominator).
    """
    norm = np.linalg.norm(x, axis=axis, keepdims=True)
    return x / (norm + eps)


def dissect_by_lengths(arr: np.ndarray, lengths: Sequence[int]) -> List[np.ndarray]:
    """Split the first axis of ``arr`` into consecutive chunks of ``lengths``."""
    assert int(np.sum(lengths)) == arr.shape[0], "lengths must sum to arr length"
    out = []
    offset = 0
    for n in lengths:
        out.append(arr[offset:offset + n])
        offset += n
    return out


_TV_SHOWS = ("friends", "met", "castle", "house", "grey")


def get_show_name(vid_name: str) -> str:
    """TV-show name from a TVR clip name; unprefixed clips are bbt
    (reference utils/basic_utils.py:172-181)."""
    prefix = vid_name.split("_")[0]
    return prefix if prefix in _TV_SHOWS else "bbt"


def count_params(module) -> int:
    """Total parameter count of an ``nn.Module`` (reference
    utils/model_utils.py:91)."""
    return sum(p.numel() for p in module.parameters())


def make_code_zip(repo_root: str, out_path: str,
                  include_dirs=("tvretrieval_tpu_torch", "tests", "scripts")) -> None:
    """Snapshot the framework source into a zip next to the run's results
    (reference utils/basic_utils.py:87 make_zipfile, config.py:219-226)."""
    import zipfile

    with zipfile.ZipFile(out_path, "w", zipfile.ZIP_DEFLATED) as zf:
        for d in include_dirs:
            base = os.path.join(repo_root, d)
            if not os.path.isdir(base):
                continue
            for root, _dirs, files in os.walk(base):
                if "__pycache__" in root:
                    continue
                for fname in files:
                    if fname.endswith((".py", ".cu", ".cuh", ".sh")):
                        full = os.path.join(root, fname)
                        zf.write(full, os.path.relpath(full, repo_root))


class AverageMeter:
    """Track min / max / avg / sum / count of a scalar stream."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0
        self.min = float("inf")
        self.max = float("-inf")

    def update(self, val: float, n: int = 1) -> None:
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)
        self.min = min(self.min, val)
        self.max = max(self.max, val)
