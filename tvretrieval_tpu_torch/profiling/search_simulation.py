"""Corpus-scale search simulation: exact flat search vs IVF-style ANN (port
of the JAX package's profiling/search_simulation.py).

Capability parity with reference baselines/profiling/
search_time_performance.py, which simulates MEE/XML video retrieval with a
FAISS ``IVF4096,Flat`` index (:97-133) and brute-force rerank timings. The
IVF structure is built here on the device: a k-means coarse quantizer
(Lloyd steps), buckets padded to one capacity, and a two-stage search
(top-nprobe centroids -> bucket products -> global top-k), all with
``torch.matmul`` and ``torch.topk``.

The initial centroids come from a CPU ``torch.Generator`` seeded from
``seed`` (the JAX package draws them with its own PRNG), so the card and
the CPU start from the same centroids; ``lloyd`` runs the steps from any
given centroids. Times are CUDA-event times on the card, host times on the
CPU.

CLI:
    python -m tvretrieval_tpu_torch.profiling.search_simulation \
        --n_videos 20000 --dim 256 --n_clusters 128 --nprobe 8 [--device cpu]
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from tvretrieval_tpu_torch.utils.device import resolve_device


def _sq_dists(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return (x ** 2).sum(1)[:, None] - 2 * x @ c.T + (c ** 2).sum(1)[None]


@torch.no_grad()
def lloyd(x: torch.Tensor, centroids: torch.Tensor, iters: int = 10):
    """``iters`` Lloyd steps from ``centroids`` (k, D) over ``x`` (n, D):
    assign each row to its nearest centroid (the first on a tie), move each
    centroid to its rows' mean (a centroid without rows stays). Returns
    (centroids, assignments (n,) int64). The sums are one-hot products, as
    in the JAX scan."""
    k = centroids.shape[0]
    c = centroids
    for _ in range(iters):
        onehot = F.one_hot(torch.argmin(_sq_dists(x, c), dim=1), k).to(x.dtype)
        sums = onehot.T @ x
        counts = onehot.sum(0)[:, None]
        c = torch.where(counts > 0, sums / counts.clamp_min(1), c)
    return c, torch.argmin(_sq_dists(x, c), dim=1)


def initial_indices(n: int, k: int, seed: int = 0) -> torch.Tensor:
    """k distinct row indices of n, from a CPU generator seeded ``seed``."""
    return torch.randperm(n, generator=torch.Generator().manual_seed(seed))[:k]


def kmeans(x: torch.Tensor, k: int, iters: int = 10, seed: int = 0):
    """Lloyd's k-means on x's device; returns (centroids (k, D), assignments)."""
    idx = initial_indices(x.shape[0], k, seed).to(x.device)
    return lloyd(x, x[idx], iters)


@dataclass
class IVFIndex:
    """Static-shape inverted-file index: buckets padded to one capacity."""

    centroids: torch.Tensor    # (k, D)
    buckets: torch.Tensor      # (k, cap, D)
    bucket_ids: torch.Tensor   # (k, cap) int64, -1 for padding
    bucket_mask: torch.Tensor  # (k, cap)

    @classmethod
    def build(cls, vectors: np.ndarray, n_clusters: int, iters: int = 10, device=None):
        dev = resolve_device(device, "IVFIndex.build")
        x = torch.from_numpy(np.asarray(vectors, np.float32)).to(dev)
        centroids, assign = kmeans(x, n_clusters, iters)
        assign = assign.cpu().numpy()
        counts = np.bincount(assign, minlength=n_clusters)
        cap = int(counts.max())
        k, d = n_clusters, vectors.shape[1]
        buckets = np.zeros((k, cap, d), np.float32)
        ids = np.full((k, cap), -1, np.int64)
        mask = np.zeros((k, cap), np.float32)
        fill = np.zeros(k, np.int64)
        for i, c in enumerate(assign):
            buckets[c, fill[c]] = vectors[i]
            ids[c, fill[c]] = i
            mask[c, fill[c]] = 1.0
            fill[c] += 1
        to = lambda a: torch.from_numpy(a).to(dev)
        return cls(centroids=centroids, buckets=to(buckets), bucket_ids=to(ids),
                   bucket_mask=to(mask))

    @torch.no_grad()
    def search(self, queries: torch.Tensor, nprobe: int, topk: int):
        """Two-stage ANN search; returns (scores, global ids), (Nq, topk)."""
        _, probe = torch.topk(queries @ self.centroids.T, nprobe)    # (Nq, nprobe)
        cand_vecs = self.buckets[probe]                              # (Nq, np, cap, D)
        cand_ids = self.bucket_ids[probe]                            # (Nq, np, cap)
        scores = torch.einsum("qd,qpcd->qpc", queries, cand_vecs)
        scores = scores + (1.0 - self.bucket_mask[probe]) * -1e10
        nq = queries.shape[0]
        top_scores, flat_idx = torch.topk(scores.reshape(nq, -1), topk)
        return top_scores, torch.gather(cand_ids.reshape(nq, -1), 1, flat_idx)


@torch.no_grad()
def flat_search(queries: torch.Tensor, vectors: torch.Tensor, topk: int):
    return torch.topk(queries @ vectors.T, topk)


def simulate(n_videos: int = 20000, n_queries: int = 100, dim: int = 256,
             n_clusters: int = 128, nprobe: int = 8, topk: int = 100,
             seed: int = 0, device=None) -> dict:
    dev = resolve_device(device, "search_simulation")
    rng = np.random.default_rng(seed)
    vectors = rng.normal(size=(n_videos, dim)).astype(np.float32)
    vectors /= np.linalg.norm(vectors, axis=1, keepdims=True)
    queries = torch.from_numpy(
        rng.normal(size=(n_queries, dim)).astype(np.float32)).to(dev)

    index = IVFIndex.build(vectors, n_clusters, device=dev)
    vecs = torch.from_numpy(vectors).to(dev)

    def timed(fn, reps: int = 5):
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(reps):
                out = fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3 / reps, out
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        return (time.perf_counter() - t0) / reps, out

    t_flat, (_, flat_ids) = timed(lambda: flat_search(queries, vecs, topk))
    t_ivf, (_, ivf_ids) = timed(lambda: index.search(queries, nprobe, topk))

    flat_ids = flat_ids.cpu().numpy()
    ivf_ids = ivf_ids.cpu().numpy()
    recall = np.mean([
        len(set(flat_ids[q]) & set(ivf_ids[q])) / topk
        for q in range(n_queries)])
    return {
        "flat_search_ms": round(t_flat * 1e3, 3),
        "ivf_search_ms": round(t_ivf * 1e3, 3),
        "ivf_recall_at_topk": round(float(recall), 4),
        "n_videos": n_videos, "n_clusters": n_clusters, "nprobe": nprobe,
    }


def main(argv=None):
    import argparse
    parser = argparse.ArgumentParser(description="corpus search simulation")
    parser.add_argument("--n_videos", type=int, default=20000)
    parser.add_argument("--n_queries", type=int, default=100)
    parser.add_argument("--dim", type=int, default=256)
    parser.add_argument("--n_clusters", type=int, default=128)
    parser.add_argument("--nprobe", type=int, default=8)
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    res = simulate(args.n_videos, args.n_queries, args.dim, args.n_clusters,
                   args.nprobe, device=args.device)
    print(json.dumps(res, indent=2))
    return res


if __name__ == "__main__":
    main()
