"""Feature sources: pre-extracted query / subtitle / video clip features.

The reference reads HDF5 files keyed by ``vid_name`` (context features,
(n_clips, D)) and ``str(desc_id)`` (query token features, (n_tokens, 768)) —
see reference start_end_dataset.py:110/119/165. We expose a small
``FeatureSource`` protocol with HDF5- and memory-backed implementations so
the rest of the stack is storage-agnostic, and cache reads host-side: the
pipeline wants whole fixed-shape numpy batches, not per-item tensors from
worker processes. The port's own copy of the JAX package's
``data/features.py``; ``h5py`` is imported only when an HDF5 file is opened.
"""
from __future__ import annotations

from typing import Dict, Optional, Protocol

import numpy as np


class FeatureSource(Protocol):
    """Maps a string key to a (length, dim) float32 feature array."""

    def get(self, key: str) -> np.ndarray: ...

    @property
    def dim(self) -> int: ...


class MemoryFeatureSource:
    """In-memory dict of key -> (L, D) arrays."""

    def __init__(self, table: Dict[str, np.ndarray]):
        if not table:
            raise ValueError("empty feature table")
        self._table = table
        self._dim = next(iter(table.values())).shape[-1]

    def get(self, key: str) -> np.ndarray:
        return np.asarray(self._table[key], dtype=np.float32)

    @property
    def dim(self) -> int:
        return self._dim

    def keys(self):
        return self._table.keys()


class H5FeatureSource:
    """HDF5-backed features with an optional whole-file RAM preload.

    ``preload=True`` replaces the reference's h5py in-memory ("core") file mode
    (config.py:243, ~60GB RAM): we materialize into plain numpy once so the
    training loop never touches HDF5 again.
    """

    def __init__(self, path: str, preload: bool = False):
        import h5py  # lazy: keeps h5py optional for synthetic runs

        self._h5 = h5py.File(path, "r")
        self._cache: Optional[Dict[str, np.ndarray]] = None
        if preload:
            self._cache = {k: np.asarray(self._h5[k], dtype=np.float32) for k in self._h5.keys()}
        first = next(iter(self._h5.keys()))
        self._dim = self._h5[first].shape[-1]

    def get(self, key: str) -> np.ndarray:
        if self._cache is not None:
            return self._cache[key]
        return np.asarray(self._h5[key], dtype=np.float32)

    @property
    def dim(self) -> int:
        return self._dim
