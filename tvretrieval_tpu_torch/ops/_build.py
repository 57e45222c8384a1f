"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source compiles alone with ``nvcc`` into a shared library of its own
with a plain C interface, loaded with ``ctypes`` (no PyTorch headers: a
build takes seconds). A library goes to ``tvretrieval_tpu_torch/_build/``
under a name keyed on a hash of its source, the headers it includes from
``csrc/`` and the flags, so an edited source or header rebuilds and an
unchanged one is reused. Nothing compiles at import: ``load(name)`` builds
on first use.

Every kernel wrapper in ``ops/`` launches through ``launch``, which takes
the current stream, raises on a CUDA error and counts the launch in
``LAUNCHES`` by kernel name (plain runs are not counted; ``KERNELS`` names
each counted kernel's library and entry point). A wrapper that lays a
model's weights out for its kernel keeps them through ``prepared``.
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
import weakref
from pathlib import Path
from typing import Callable, Dict, List, Sequence, Tuple

import torch

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
    # tvr_excl_lstm(ctx1_0, ctx1_1, len_0, len_1, w, gq, gq_stride, out_0, out_1,
    #               n_pairs, n_clips, n_streams, stream)
    "excl_lstm": (_PKG / "csrc" / "excl_lstm.cu", {
        "tvr_excl_lstm": [_P, _P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _P]}),
    # tvr_excl_heads(ctx2_0, ctx1_0, len_0, ctx2_1, ctx1_1, len_1, w, u, u_stride, w1, b1,
    #                out_st, out_ed, n_pairs, n_clips, n_streams, stream)
    "excl_head": (_PKG / "csrc" / "excl_head.cu", {
        "tvr_excl_heads": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _P]}),
    # tvr_mma_probe(kind, blocks, iters, out, stream): the mma.sync and the
    # s8 wgmma ceilings (chip_smoke.py phase 2; no engine path runs it)
    "mma_probe": (_PKG / "csrc" / "mma_probe.cu", {
        "tvr_mma_probe": [_I, _I, _I, _P, _P]}),
}


# counted kernel -> (library, entry point)
KERNELS: Dict[str, Tuple[str, str]] = {
    "video_scores_flat_i8": ("video_score", "tvr_video_scores"),                  # B1
    "video_scores_flat": ("video_score", "tvr_video_scores"),                     # B2
    "video_scores_flat_bmax": ("video_score", "tvr_video_scores"),                # B3
    "gather_byte_rows": ("gather", "tvr_gather_byte_rows"),                       # B4
    "span_sim_cat_i8": ("span_sim", "tvr_span_sim_i8"),                           # B5
    "topk_transposed": ("topk_sort", "tvr_topk_sort"),                            # B6
    "gathered_similarity": ("gathered_sim", "tvr_gathered_similarity"),           # B7
    "banded_topk_spans_fused": ("banded_topk", "tvr_banded_topk"),                # B8
    "video_scores_masked": ("masked_score", "tvr_masked_scores"),                 # B9
    "fused_video_scores_clip_major": ("masked_score", "tvr_masked_scores"),       # B10
    "approx_max_k": ("approx_topk", "tvr_approx_topk"),                           # B11
    "excl_lstm": ("excl_lstm", "tvr_excl_lstm"),
    "excl_head": ("excl_head", "tvr_excl_heads"),
}

# launches of each counted kernel since the last reset_launch_counts()
LAUNCHES: Dict[str, int] = dict.fromkeys(KERNELS, 0)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_PREPARED: "weakref.WeakKeyDictionary[torch.nn.Module, dict]" = weakref.WeakKeyDictionary()


def prepared(kernel: str, modules: Sequence[torch.nn.Module], build: Callable[[], tuple]):
    """``build()``, kernel ``kernel``'s weights laid out from ``modules``'
    parameters, computed without autograd and kept on the first module
    until one of those parameters changes its storage or its version
    counter (``load_state_dict`` and optimizer steps bump it)."""
    key = tuple(id(m) for m in modules) + tuple(
        (p.data_ptr(), p._version) for m in modules for p in m.parameters())
    kept = _PREPARED.setdefault(modules[0], {})
    hit = kept.get(kernel)
    if hit is not None and hit[0] == key:
        return hit[1]
    with torch.no_grad():
        value = build()
    kept[kernel] = (key, value)
    return value


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


def launch(name: str, device, *args) -> None:
    """Launch kernel ``name`` of ``KERNELS`` on ``device``'s current stream:
    its entry point takes ``args`` and then the stream. Raises RuntimeError
    if the launch returns a CUDA error; counts it otherwise."""
    lib, entry = KERNELS[name]
    fn = getattr(load(lib), entry)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    LAUNCHES[name] += 1
