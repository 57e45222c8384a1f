"""ctypes loader for the port's native host helper, temporal NMS
(csrc/temporal_nms.cpp), one query or a batch of queries by offsets: the
port's copy of tvretrieval_tpu/native/loader.py.

The library is built with the host C++ compiler (``$CXX``, else ``g++``) on
first use into ``tvretrieval_tpu_torch/_build/``, under a name keyed on a
hash of the source and the flags. Where no compiler is found, or the build
fails, ``native_available()`` is False and callers keep their numpy path.
Nothing is built at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "temporal_nms.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-shared"]

_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libtemporal_nms_{digest.hexdigest()[:16]}.so"


def _build(lib: Path) -> bool:
    cxx = shutil.which(os.environ.get("CXX") or "g++")
    if cxx is None:
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)], check=True,
                       capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        os.unlink(tmp)
        return False
    os.replace(tmp, lib)          # atomic: concurrent builds agree
    return True


def get_native_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if missing; None without a compiler."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    path = library_path()
    if not path.exists() and not _build(path):
        _load_failed = True
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        _load_failed = True
        return None
    lib.temporal_nms.restype = ctypes.c_int
    lib.temporal_nms.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.POINTER(ctypes.c_float)]
    lib.temporal_nms_batch.restype = None
    lib.temporal_nms_batch.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)]
    _lib = lib
    return _lib


def native_available() -> bool:
    return get_native_lib() is not None


def temporal_nms_native(preds: np.ndarray, nms_threshold: float,
                        max_after_nms: int) -> np.ndarray:
    """preds: (n, 3) float32 [st, ed, score] -> (kept, 3) float32."""
    lib = get_native_lib()
    if lib is None:
        raise RuntimeError("the native NMS library is unavailable (no host C++ compiler)")
    preds = np.ascontiguousarray(preds, dtype=np.float32)
    if preds.ndim != 2 or preds.shape[1] != 3:
        raise ValueError(f"preds must be (n, 3) [st, ed, score] rows, got {preds.shape}")
    out = np.empty((max_after_nms, 3), dtype=np.float32)
    kept = lib.temporal_nms(
        preds.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(preds),
        ctypes.c_float(nms_threshold), max_after_nms,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out[:kept]


def temporal_nms_batch_native(preds: np.ndarray, offsets: np.ndarray,
                              nms_threshold: float, max_after_nms: int):
    """preds: (sum_n, 3) float32 [st, ed, score] rows of all queries;
    offsets: (n_queries + 1,) int64, non-decreasing, query q's rows are
    preds[offsets[q]:offsets[q + 1]] (an empty range keeps nothing) ->
    (out (n_queries, max_after_nms, 3) float32, n_kept (n_queries,) int32);
    only out[q, :n_kept[q]] is written."""
    lib = get_native_lib()
    if lib is None:
        raise RuntimeError("the native NMS library is unavailable (no host C++ compiler)")
    preds = np.ascontiguousarray(preds, dtype=np.float32).reshape(-1, 3)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    if offsets.ndim != 1 or len(offsets) < 1 or offsets[0] < 0 \
            or offsets[-1] > len(preds) or np.any(np.diff(offsets) < 0):
        raise ValueError("offsets must be non-decreasing within [0, number of rows]")
    n_q = len(offsets) - 1
    out = np.empty((n_q, max_after_nms, 3), dtype=np.float32)
    n_kept = np.empty((n_q,), dtype=np.int32)
    lib.temporal_nms_batch(
        preds.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n_q, ctypes.c_float(nms_threshold), max_after_nms,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n_kept.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    return out, n_kept
