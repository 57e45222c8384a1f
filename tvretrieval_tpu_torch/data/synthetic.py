"""Synthetic TVR-shaped worlds with a planted retrieval signal.

The real 33GB feature release (reference README.md:67) is not present in
this environment, so tests and benches run on synthetic fixtures shaped
exactly like the release: query features (n_tokens<=30, 768-d), subtitle
clip features (n_clips, 768-d), video clip features (n_clips, vid_dim).

Signal construction: each video has a random topic vector; each query has a
content vector. The GT video's clips carry a scaled copy of the query
content *inside the GT span only*, and a weaker copy everywhere in the GT
video, so (a) video retrieval and (b) span localization are both learnable
and an end-to-end train->inference->eval smoke test can assert real recall.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from tvretrieval_tpu_torch.data.datasets import CorpusIndex
from tvretrieval_tpu_torch.data.features import MemoryFeatureSource


@dataclass
class SyntheticWorld:
    annotations: List[dict]           # TVR-format rows (desc_id, desc, vid_name, duration, ts, type)
    corpus: CorpusIndex
    query_source: MemoryFeatureSource
    video_source: MemoryFeatureSource
    sub_source: MemoryFeatureSource
    clip_length: float = 1.5


def make_synthetic_world(
    n_videos: int = 32,
    n_queries: int = 64,
    vid_dim: int = 64,
    text_dim: int = 32,
    max_clips: int = 24,
    clip_length: float = 1.5,
    signal: float = 2.0,
    noise: float = 1.0,
    seed: int = 0,
    query_dim: int = 0,
) -> SyntheticWorld:
    """query_dim=0 (legacy): query tokens live in the concatenated
    (text_dim + vid_dim) space. query_dim>0: queries live in their OWN
    space (e.g. RoBERTa's 768-d like the real release) and the planted
    signal reaches the video/subtitle spaces through fixed random linear
    maps — a learnable relationship at real TVR feature dimensions."""
    rng = np.random.default_rng(seed)
    vid_names = [f"syn_vid_{i:05d}" for i in range(n_videos)]
    n_clips = rng.integers(max(4, max_clips // 2), max_clips + 1, size=n_videos)
    durations = (n_clips * clip_length).astype(np.float64)

    topics = rng.normal(size=(n_videos, text_dim)).astype(np.float32)
    vid_topics = rng.normal(size=(n_videos, vid_dim)).astype(np.float32)
    if query_dim:
        # fixed projections query-space -> context spaces (scaled to keep
        # planted components ~unit variance)
        proj_v = (rng.normal(size=(query_dim, vid_dim))
                  / np.sqrt(query_dim)).astype(np.float32)
        proj_s = (rng.normal(size=(query_dim, text_dim))
                  / np.sqrt(query_dim)).astype(np.float32)

    # Everything below is fully vectorized: at TVR scale (21,818 videos x 100
    # clips x 3072-d + 109K queries) the per-video/per-query Python loops this
    # replaces took ~1h on a 1-core host; the bulk draws + segment adds take
    # ~1 min. Per-video features are views into one (n_videos, max_clips, D)
    # block (rows beyond each video's n_clips are never exposed).
    big_v = rng.standard_normal((n_videos, max_clips, vid_dim), dtype=np.float32)
    if noise != 1.0:
        big_v *= np.float32(noise)
    big_v += vid_topics[:, None, :]
    big_s = rng.standard_normal((n_videos, max_clips, text_dim), dtype=np.float32)
    if noise != 1.0:
        big_s *= np.float32(noise)
    big_s += topics[:, None, :]

    # per-query draws (same distributions as the original per-query loop)
    vi = rng.integers(0, n_videos, size=n_queries)
    Lq = n_clips[vi]
    st = rng.integers(0, np.maximum(Lq - 2, 1))
    ed = rng.integers(st + 1, np.minimum(st + 8, Lq) + 1)
    if query_dim:
        content_q = rng.standard_normal((n_queries, query_dim), dtype=np.float32)
        content = content_q @ proj_s
        vid_content = content_q @ proj_v
        q_center = content_q
    else:
        content = rng.standard_normal((n_queries, text_dim), dtype=np.float32)
        vid_content = rng.standard_normal((n_queries, vid_dim), dtype=np.float32)
        q_center = np.concatenate([content, vid_content], axis=1)

    # plant, weak across the whole GT video: sum each video's query contents
    acc_v = np.zeros((n_videos, vid_dim), dtype=np.float32)
    acc_s = np.zeros((n_videos, text_dim), dtype=np.float32)
    np.add.at(acc_v, vi, vid_content)
    np.add.at(acc_s, vi, content)
    big_v += (0.3 * np.float32(signal)) * acc_v[:, None, :]
    big_s += (0.3 * np.float32(signal)) * acc_s[:, None, :]

    # plant, strong inside the GT span: expand spans to flat clip rows and
    # segment-add (duplicates accumulate, matching the sequential loop)
    span_len = (ed - st).astype(np.int64)
    rep = np.repeat(np.arange(n_queries), span_len)
    offs = np.arange(len(rep)) - np.repeat(np.cumsum(span_len) - span_len, span_len)
    rows = vi[rep] * max_clips + st[rep] + offs
    flat_v = big_v.reshape(-1, vid_dim)
    flat_s = big_s.reshape(-1, text_dim)
    sig = np.float32(signal)
    for lo in range(0, len(rows), 1 << 18):  # chunk the (K, D) temps
        sl = slice(lo, lo + (1 << 18))
        np.add.at(flat_v, rows[sl], sig * vid_content[rep[sl]])
        np.add.at(flat_s, rows[sl], sig * content[rep[sl]])

    video_feats: Dict[str, np.ndarray] = {}
    sub_feats: Dict[str, np.ndarray] = {}
    for i, name in enumerate(vid_names):
        L = int(n_clips[i])
        video_feats[name] = big_v[i, :L]
        sub_feats[name] = big_s[i, :L]

    # query token features: center + 0.5 * noise, n_tokens in [5, 19]
    n_tokens = rng.integers(5, 20, size=n_queries)
    q_all = rng.standard_normal((n_queries, 19, q_center.shape[1]),
                                dtype=np.float32)
    q_all *= np.float32(0.5)
    q_all += q_center[:, None, :]

    annotations: List[dict] = []
    query_feats: Dict[str, np.ndarray] = {}
    for qi in range(n_queries):
        desc_id = 90000 + qi
        query_feats[str(desc_id)] = q_all[qi, : n_tokens[qi]]
        annotations.append({
            "desc_id": desc_id,
            "desc": f"synthetic query {qi}",
            "vid_name": vid_names[vi[qi]],
            "duration": float(durations[vi[qi]]),
            "ts": [float(st[qi]) * clip_length, float(ed[qi]) * clip_length],
            "type": ["v", "t", "vt"][qi % 3],
        })

    corpus = CorpusIndex(
        vid_names=vid_names,
        durations=[float(d) for d in durations],
        video2idx={v: i for i, v in enumerate(vid_names)},
    )
    return SyntheticWorld(
        annotations=annotations,
        corpus=corpus,
        query_source=MemoryFeatureSource(query_feats),
        video_source=MemoryFeatureSource(video_feats),
        sub_source=MemoryFeatureSource(sub_feats),
        clip_length=clip_length,
    )
