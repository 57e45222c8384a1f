"""Example builders for the retrieval baselines (MEE, CAL/MCN).

MEE (reference mixture_embedding_experts/retrieval_dataset.py:94-113):
video/sub features are mean-pooled over clips to one vector per video, then
L2-normalized; queries stay token-level for NetVLAD pooling.

CAL/MCN (reference clip_alignment_with_language/proposal_retrieval_dataset.py):
each training example is a triplet (positive moment, intra-video negative,
inter-video negative). A moment's features are the per-clip concat
[local_clip_feat; global_ctx_feat; TEF] (concat_feat_adv :311-345); the
intra negative is the min-IoU of 5 random clip-aligned spans (:216-250); the
inter negative re-uses the positive's normalized span on another video,
optionally sampled from external VR results with exp-decay rank sampling
(:252-280). MCN mean-pools a moment's clips to one pseudo-clip.

The port's own copy of the JAX package's ``data/retrieval_datasets.py``;
numpy only, the CAL builder's ``np.random.default_rng(seed)`` draws
unchanged, so the same seed gives the same batches.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tvretrieval_tpu_torch.data.features import FeatureSource
from tvretrieval_tpu_torch.evaluation.metrics import temporal_iou
from tvretrieval_tpu_torch.utils.io import l2_normalize


# ---------------------------------------------------------------------------
# MEE
# ---------------------------------------------------------------------------

class MEEExampleBuilder:
    def __init__(self, query_source: FeatureSource,
                 video_source: Optional[FeatureSource] = None,
                 sub_source: Optional[FeatureSource] = None,
                 ctx_mode: str = "video_sub", max_desc_l: int = 30,
                 max_ctx_l: int = 100,
                 normalize_vfeat: bool = True, normalize_tfeat: bool = True):
        self.query_source = query_source
        self.video_source = video_source
        self.sub_source = sub_source
        self.use_video = "video" in ctx_mode
        self.use_sub = "sub" in ctx_mode
        self.max_desc_l = max_desc_l
        self.max_ctx_l = max_ctx_l
        self.normalize_vfeat = normalize_vfeat
        self.normalize_tfeat = normalize_tfeat

    def _pooled_ctx(self, vid_name: str) -> Tuple[np.ndarray, np.ndarray]:
        v = s = None
        if self.use_video:
            v = self.video_source.get(vid_name)[: self.max_ctx_l].mean(axis=0)
            if self.normalize_vfeat:
                v = l2_normalize(v)
        if self.use_sub:
            s = self.sub_source.get(vid_name)[: self.max_ctx_l].mean(axis=0)
            if self.normalize_tfeat:
                s = l2_normalize(s)
        dim_v = self.video_source.dim if self.use_video else 2
        dim_s = self.sub_source.dim if self.use_sub else 2
        return (v if v is not None else np.zeros(dim_v, np.float32),
                s if s is not None else np.zeros(dim_s, np.float32))

    def build_train_batch(self, rows: List[dict]) -> Dict[str, np.ndarray]:
        B = len(rows)
        q = np.zeros((B, self.max_desc_l, self.query_source.dim), np.float32)
        qm = np.zeros((B, self.max_desc_l), np.float32)
        v = np.zeros((B, self.video_source.dim if self.use_video else 2), np.float32)
        s = np.zeros((B, self.sub_source.dim if self.use_sub else 2), np.float32)
        for i, row in enumerate(rows):
            feat = self.query_source.get(str(row["desc_id"]))[: self.max_desc_l]
            if self.normalize_tfeat:
                feat = l2_normalize(feat)
            q[i, : len(feat)] = feat
            qm[i, : len(feat)] = 1.0
            v[i], s[i] = self._pooled_ctx(row["vid_name"])
        return dict(query_feat=q, query_mask=qm, video_feat=v, sub_feat=s)

    def build_context_batch(self, vid_names: List[str]) -> Dict[str, np.ndarray]:
        B = len(vid_names)
        v = np.zeros((B, self.video_source.dim if self.use_video else 2), np.float32)
        s = np.zeros((B, self.sub_source.dim if self.use_sub else 2), np.float32)
        for i, name in enumerate(vid_names):
            v[i], s[i] = self._pooled_ctx(name)
        return dict(video_feat=v, sub_feat=s)

    def build_query_batch(self, rows: List[dict]) -> Dict[str, np.ndarray]:
        B = len(rows)
        q = np.zeros((B, self.max_desc_l, self.query_source.dim), np.float32)
        qm = np.zeros((B, self.max_desc_l), np.float32)
        for i, row in enumerate(rows):
            feat = self.query_source.get(str(row["desc_id"]))[: self.max_desc_l]
            if self.normalize_tfeat:
                feat = l2_normalize(feat)
            q[i, : len(feat)] = feat
            qm[i, : len(feat)] = 1.0
        return dict(query_feat=q, query_mask=qm)


# ---------------------------------------------------------------------------
# CAL / MCN
# ---------------------------------------------------------------------------

@dataclass
class CALBuilderConfig:
    ctx_mode: str = "video_sub"
    model_type: str = "cal"          # "cal" | "mcn" (mcn pools moment clips)
    clip_length: float = 1.5
    max_desc_l: int = 30
    max_ctx_l: int = 100
    max_moment_clips: int = 24       # >= length * max(scale) / clip_length
    normalize_vfeat: bool = True
    normalize_tfeat: bool = True


class CALExampleBuilder:
    def __init__(self, cfg: CALBuilderConfig, query_source: FeatureSource,
                 video_source: Optional[FeatureSource] = None,
                 sub_source: Optional[FeatureSource] = None,
                 external_vr_top_videos: Optional[Dict[int, List[Tuple[str, float]]]] = None,
                 seed: int = 0):
        self.cfg = cfg
        self.query_source = query_source
        self.video_source = video_source
        self.sub_source = sub_source
        self.use_video = "video" in cfg.ctx_mode
        self.use_sub = "sub" in cfg.ctx_mode
        self.use_tef = "tef" in cfg.ctx_mode
        self.external_vr = external_vr_top_videos
        self.rng = np.random.default_rng(seed)
        if cfg.model_type == "mcn":
            self.cfg.max_moment_clips = 1

    # ------------------------------------------------------------- sampling
    def align_to_clips(self, duration: float, ts: Sequence[float]) -> np.ndarray:
        c = self.cfg.clip_length
        out = np.array([math.floor(ts[0] / c), math.ceil(ts[1] / c)], np.float64) * c
        out[1] = min(out[1], duration)
        return out

    def sample_clip_spans(self, duration: float, n: int) -> np.ndarray:
        """n random clip-aligned spans with >= 2 clips (reference :243-250)."""
        c = self.cfg.clip_length
        hi = max(int(math.ceil(duration / c)), 2)
        spans = np.sort(self.rng.integers(0, hi, size=(n, 2)), axis=1) * c
        short = spans[:, 1] - spans[:, 0] <= c
        at_zero = spans[:, 0] == 0
        spans[:, 1][short & at_zero] += c
        spans[:, 0][short & ~at_zero] -= c
        return spans

    def sample_intra_negative(self, duration: float, ts: Sequence[float]) -> np.ndarray:
        spans = self.sample_clip_spans(duration, 5)
        ious = temporal_iou(spans, np.asarray(ts, np.float32))
        return spans[int(np.argmin(ious))]

    def sample_inter_negative(self, rows: List[dict], pos_vid: str,
                              norm_span: np.ndarray, desc_id=None):
        """Another video + same normalized span; exp-decay rank sampling when
        external VR results are given (reference :252-280)."""
        for _ in range(100):
            if self.external_vr is not None and desc_id in self.external_vr:
                top = self.external_vr[desc_id]
                idx = min(len(top) - 1, int(self.rng.exponential(scale=10.0)))
                name, dur = top[idx]
            else:
                cand = rows[int(self.rng.integers(len(rows)))]
                name, dur = cand["vid_name"], cand["duration"]
            if name != pos_vid:
                return self.align_to_clips(dur, dur * norm_span), name, dur
        raise RuntimeError("could not sample an inter-video negative")

    # ------------------------------------------------------------- features
    def _moment_clip_feats(self, feats: np.ndarray, span: np.ndarray,
                           normalize: bool) -> np.ndarray:
        c = self.cfg.clip_length
        st = math.floor(span[0] / c)
        ed = math.ceil(span[1] / c)
        if st >= len(feats):
            st = max(len(feats) - 2, 0)
        local = feats[st:ed][: self.cfg.max_moment_clips]
        if len(local) == 0:
            local = feats[:1]
        if self.cfg.model_type == "mcn":
            local = local.mean(axis=0, keepdims=True)
        if normalize:
            local = l2_normalize(local)
        return local

    def _assemble(self, local: np.ndarray, global_feat: np.ndarray,
                  tef: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """[local; global; tef] per clip, padded to max_moment_clips."""
        n = local.shape[0]
        parts = [local, np.broadcast_to(global_feat, (n, global_feat.shape[-1]))]
        if self.use_tef:
            parts.append(np.broadcast_to(tef, (n, 2)))
        feat = np.concatenate(parts, axis=1)
        out = np.zeros((self.cfg.max_moment_clips, feat.shape[1]), np.float32)
        mask = np.zeros((self.cfg.max_moment_clips,), np.float32)
        out[:n] = feat
        mask[:n] = 1.0
        return out, mask

    def _stream_moment(self, source: FeatureSource, vid_name: str,
                       span: np.ndarray, duration: float, normalize: bool):
        feats = source.get(vid_name)[: self.cfg.max_ctx_l]
        local = self._moment_clip_feats(feats, span, normalize)
        global_feat = l2_normalize(feats.mean(axis=0))
        tef = np.asarray(span, np.float32) / max(duration, 1e-6)
        return self._assemble(local, global_feat, tef)

    def moment_features(self, vid_name: str, span: np.ndarray, duration: float):
        """Returns (video_feat, sub_feat, mask) for one moment, fixed shape."""
        v = s = None
        mask = None
        if self.use_video:
            v, mask = self._stream_moment(self.video_source, vid_name, span,
                                          duration, self.cfg.normalize_vfeat)
        if self.use_sub:
            s, mask = self._stream_moment(self.sub_source, vid_name, span,
                                          duration, self.cfg.normalize_tfeat)
        if not self.use_video and not self.use_sub and self.use_tef:
            tef = np.asarray(span, np.float32) / max(duration, 1e-6)
            v = np.zeros((self.cfg.max_moment_clips, 2), np.float32)
            v[0] = tef
            mask = np.zeros((self.cfg.max_moment_clips,), np.float32)
            mask[0] = 1.0
        dim_v = v.shape[1] if v is not None else 2
        dim_s = s.shape[1] if s is not None else 2
        return (v if v is not None else np.zeros((self.cfg.max_moment_clips, dim_v), np.float32),
                s if s is not None else np.zeros((self.cfg.max_moment_clips, dim_s), np.float32),
                mask)

    # --------------------------------------------------------------- batches
    def build_train_batch(self, rows: List[dict], all_rows: List[dict]):
        B = len(rows)
        out: Dict[str, np.ndarray] = {}
        q = np.zeros((B, self.cfg.max_desc_l, self.query_source.dim), np.float32)
        qm = np.zeros((B, self.cfg.max_desc_l), np.float32)
        slots = {k: [] for k in ("pos", "intra", "inter")}
        masks = {k: [] for k in ("pos", "intra", "inter")}
        for i, row in enumerate(rows):
            feat = self.query_source.get(str(row["desc_id"]))[: self.cfg.max_desc_l]
            if self.cfg.normalize_tfeat:
                feat = l2_normalize(feat)
            q[i, : len(feat)] = feat
            qm[i, : len(feat)] = 1.0

            dur = row["duration"]
            pos_span = self.align_to_clips(dur, row["ts"])
            intra_span = self.sample_intra_negative(dur, row["ts"])
            norm_span = np.asarray(pos_span, np.float64) / max(dur, 1e-6)
            inter_span, inter_vid, inter_dur = self.sample_inter_negative(
                all_rows, row["vid_name"], norm_span, row["desc_id"])

            for key, (vid, span, d) in {
                "pos": (row["vid_name"], pos_span, dur),
                "intra": (row["vid_name"], intra_span, dur),
                "inter": (inter_vid, inter_span, inter_dur),
            }.items():
                v, s, m = self.moment_features(vid, span, d)
                slots[key].append((v, s))
                masks[key].append(m)

        out["query_feat"] = q
        out["query_mask"] = qm
        for key in ("pos", "intra", "inter"):
            out[f"{key}_video_feat"] = np.stack([vs[0] for vs in slots[key]])
            out[f"{key}_sub_feat"] = np.stack([vs[1] for vs in slots[key]])
            out[f"{key}_mask"] = np.stack(masks[key])
        return out

    def build_query_batch(self, rows: List[dict]):
        B = len(rows)
        q = np.zeros((B, self.cfg.max_desc_l, self.query_source.dim), np.float32)
        qm = np.zeros((B, self.cfg.max_desc_l), np.float32)
        for i, row in enumerate(rows):
            feat = self.query_source.get(str(row["desc_id"]))[: self.cfg.max_desc_l]
            if self.cfg.normalize_tfeat:
                feat = l2_normalize(feat)
            q[i, : len(feat)] = feat
            qm[i, : len(feat)] = 1.0
        return dict(query_feat=q, query_mask=qm)

    def build_proposal_batch(self, vid_name: str, duration: float,
                             proposals: np.ndarray, max_n_proposals: int):
        """Fixed-shape (max_n_proposals, max_moment_clips, D) features + masks
        for one video's proposals (reference eval dataset :455-520)."""
        n = min(len(proposals), max_n_proposals)
        dim_v = (self.video_source.dim if self.use_video else 0)
        dim_s = (self.sub_source.dim if self.use_sub else 0)
        v0, s0, _ = self.moment_features(vid_name, proposals[0], duration)
        vfeat = np.zeros((max_n_proposals,) + v0.shape, np.float32)
        sfeat = np.zeros((max_n_proposals,) + s0.shape, np.float32)
        cmask = np.zeros((max_n_proposals, self.cfg.max_moment_clips), np.float32)
        pmask = np.zeros((max_n_proposals,), np.float32)
        for pi in range(n):
            v, s, m = self.moment_features(vid_name, proposals[pi], duration)
            vfeat[pi], sfeat[pi], cmask[pi] = v, s, m
            pmask[pi] = 1.0
        return vfeat, sfeat, cmask, pmask
