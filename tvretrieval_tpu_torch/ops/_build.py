"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source compiles alone with ``nvcc`` into a shared library of its own
with a plain C interface, loaded with ``ctypes`` (no PyTorch headers: a
build takes seconds). A library goes to ``tvretrieval_tpu_torch/_build/``
under a name keyed on a hash of its source, the headers it includes from
``csrc/`` and the flags, so an edited source or header rebuilds and an
unchanged one is reused. Nothing compiles at import: ``load(name)`` builds
on first use.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List

_PKG = Path(__file__).resolve().parent.parent
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# library name -> (source, {entry point: argtypes}); every entry returns cudaError_t
SOURCES: Dict[str, tuple] = {
    # tvr_video_scores(kind, qv, qs, fv, fs, nq, nv_pad, lp, d_words, n_videos,
    #                  out, out_cols, bmax, chunk, stream);
    # tvr_tensor_map_encode_ns(q, f, nq, rows, d, n, ns): the int8 launch's
    # host cost of its tensor maps (chip_smoke.py phase 3; no kernel)
    "video_score": (_PKG / "csrc" / "video_score.cu", {
        "tvr_video_scores": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _P, _I, _P],
        "tvr_tensor_map_encode_ns": [_P, _P, _I, _L, _I, _I, _P]}),
    # tvr_gather_byte_rows(table, idx, out, n_rows, n_idx, row_bytes, bad, stream)
    "gather": (_PKG / "csrc" / "gather.cu", {
        "tvr_gather_byte_rows": [_P, _P, _P, _L, _I, _L, _P, _P]}),
    # tvr_span_sim_i8(q8, q_scale, f8, f_scale, nq, rows, k_words, out, stream)
    "span_sim": (_PKG / "csrc" / "span_sim.cu", {
        "tvr_span_sim_i8": [_P, _P, _P, _P, _I, _L, _I, _P, _P]}),
    # tvr_topk_sort(x, nq, n, k, out_v, out_i, stream)
    "topk_sort": (_PKG / "csrc" / "topk_sort.cu", {
        "tvr_topk_sort": [_P, _I, _I, _I, _P, _P, _P]}),
    # tvr_masked_scores(kind, qv, qs, fv, fs, mask, nq, nv, n_clips, d_words, f_video,
    #                   f_clip, m_video, m_clip, n_streams, init, use_exp, alpha, out, stream)
    "masked_score": (_PKG / "csrc" / "masked_score.cu", {
        "tvr_masked_scores": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _L, _I,
                              _F, _I, _F, _P, _P]}),
    # tvr_gathered_similarity(kind, qv, qs, vf2, sf2, idx, n_rows, nq, v1, n_clips,
    #                         clip_bytes, out, bad, stream)
    "gathered_sim": (_PKG / "csrc" / "gathered_sim.cu", {
        "tvr_gathered_similarity": [_I, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _P, _P, _P]}),
    # tvr_banded_topk(st, ed, vs, nq, V, L, min_l, max_l, top_n, out_vid, out_st, out_ed,
    #                 out_score, videos, stream)
    "banded_topk": (_PKG / "csrc" / "banded_topk.cu", {
        "tvr_banded_topk": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P]}),
    # tvr_approx_topk(x, nq, n, m, k, out_v, out_i, stream)
    "approx_topk": (_PKG / "csrc" / "approx_topk.cu", {
        "tvr_approx_topk": [_P, _I, _I, _I, _I, _P, _P, _P]}),
    # tvr_mma_probe(kind, blocks, iters, out, stream): the mma.sync and the
    # s8 wgmma ceilings (chip_smoke.py phase 2; no engine path runs it)
    "mma_probe": (_PKG / "csrc" / "mma_probe.cu", {
        "tvr_mma_probe": [_I, _I, _I, _P, _P]}),
}


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


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def sources_of(name: str) -> List[Path]:
    """Library ``name``'s source and, transitively, the headers it includes
    with quotes (looked up beside the including file), in include order."""
    seen: List[Path] = []
    todo = [SOURCES[name][0]]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        todo += [path.parent / m.decode() for m in _INCLUDE.findall(path.read_bytes())]
    return seen


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in sources_of(name):
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build(name: str) -> str:
    """Compile library ``name`` if it is missing; return the compiler output
    (ptxas register / spill report), empty if it was already built.
    Raises KernelBuildError if nvcc fails."""
    lib = library_path(name)
    if lib.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCES[name][0])],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        os.unlink(tmp)
        raise KernelBuildError(f"{name}: nvcc exit {proc.returncode}\n{proc.stdout}")
    os.replace(tmp, lib)          # atomic: concurrent builds agree
    return proc.stdout


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if missing."""
    build(name)
    lib = ctypes.CDLL(str(library_path(name)))
    for entry, argtypes in SOURCES[name][1].items():
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
