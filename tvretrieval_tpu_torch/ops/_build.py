"""Build and load the port's CUDA kernels (``csrc/video_score.cu``).

The source compiles alone with ``nvcc`` into a shared library with a
plain C interface, loaded with ``ctypes`` (no PyTorch headers: a build
takes seconds). The library goes to ``tvretrieval_tpu_torch/_build/``
under a name keyed on a hash of the source and the flags, so an edited
source rebuilds and an unchanged one is reused. Nothing compiles at
import: ``load()`` builds on first use.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "video_score.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# tvr_video_scores(kind, qv, qs, fv, fs, nq, nv_pad, lp, d_words, n_videos,
#                  out, out_cols, bmax, chunk, stream) -> cudaError_t
_P, _I = ctypes.c_void_p, ctypes.c_int
ENTRY_ARGTYPES = [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _P, _I, _P]


class KernelBuildError(RuntimeError):
    pass


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelBuildError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libvideo_score_{digest.hexdigest()[:16]}.so"


def build() -> str:
    """Compile the library if it is missing; return the compiler output
    (ptxas register / spill report), empty if it was already built.
    Raises KernelBuildError if nvcc fails."""
    lib = library_path()
    if lib.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        os.unlink(tmp)
        raise KernelBuildError(f"nvcc exit {proc.returncode}\n{proc.stdout}")
    os.replace(tmp, lib)          # atomic: concurrent builds agree
    return proc.stdout


@functools.cache
def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if missing."""
    build()
    lib = ctypes.CDLL(str(library_path()))
    lib.tvr_video_scores.argtypes = ENTRY_ARGTYPES
    lib.tvr_video_scores.restype = ctypes.c_int
    return lib
