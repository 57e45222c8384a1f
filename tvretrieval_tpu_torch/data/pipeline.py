"""Host-side batching + device prefetch.

Replaces the reference's DataLoader(num_workers=8) (train.py:136-141) with a
background thread that builds fixed-shape numpy batches and eagerly puts
them on the device (``put_fn``), overlapping the host's batch building and
the host-to-device copy with the device's compute. The port's own copy of
the JAX package's ``data/pipeline.py``.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, List, Optional

import numpy as np


class BatchIterator:
    """Yields lists of annotation rows in fixed-size batches.

    shuffle=True reshuffles each epoch with an epoch-dependent seed
    (deterministic given base seed). drop_last keeps every batch the same size.
    """

    def __init__(self, rows: List[dict], batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0):
        self.rows = rows
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.rows) // self.batch_size
        if not self.drop_last and len(self.rows) % self.batch_size:
            n += 1
        return n

    def __iter__(self) -> Iterator[List[dict]]:
        order = np.arange(len(self.rows))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(order)
        self.epoch += 1
        for i in range(len(self)):
            idx = order[i * self.batch_size:(i + 1) * self.batch_size]
            yield [self.rows[j] for j in idx]


class DevicePrefetcher:
    """Wraps a batch-producing iterator; builds + device_puts batches on
    background threads, keeping ``buffer_size`` batches in flight.

    With ``n_workers > 1`` batches are built by a thread pool (numpy releases
    the GIL for the heavy ops) while a coordinator preserves order —
    replacing the reference's multi-process DataLoader workers
    (train.py:136-141).
    """

    _DONE = object()

    def __init__(self, batch_iter, build_fn: Callable, put_fn: Optional[Callable] = None,
                 buffer_size: int = 2, n_workers: int = 1):
        self._batch_iter = batch_iter
        self._build_fn = build_fn
        self._put_fn = put_fn
        self._n_workers = max(n_workers, 1)
        self._q: queue.Queue = queue.Queue(maxsize=max(buffer_size, self._n_workers))
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            if self._n_workers == 1:
                for rows in self._batch_iter:
                    batch = self._build_fn(rows)
                    if self._put_fn is not None:
                        batch = self._put_fn(batch)
                    self._q.put(batch)
            else:
                from concurrent.futures import ThreadPoolExecutor
                with ThreadPoolExecutor(self._n_workers) as pool:
                    # executor.map preserves input order
                    for batch in pool.map(self._build_fn, self._batch_iter):
                        if self._put_fn is not None:
                            batch = self._put_fn(batch)
                        self._q.put(batch)
        except BaseException as e:  # surfaced on the consumer thread
            self._err = e
        finally:
            self._q.put(self._DONE)

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._DONE:
                if self._err is not None:
                    raise self._err
                return
            yield item
