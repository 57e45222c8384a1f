"""CAL / MCN — proposal-based moment retrieval baseline, PyTorch.

Port of tvretrieval_tpu/models/cal.py (reference baselines/
clip_alignment_with_language/model.py, CALWithSub:136): per-stream MLP
moment encoders (L2-normalized), a unidirectional-LSTM query encoder
(models.rnn, the final carry at each row's length), mean squared-L2 clip
distance per proposal, and triplet losses with intra-video + inter-video
negatives. ``model_type="mcn"`` mean-pools the clips inside a proposal
before encoding; the data layer (data.retrieval_datasets) feeds one pooled
"clip" per proposal, so the model is the same.

Compute dtype: under ``dtype_str="bfloat16"`` the Dense layers and the
LSTM compute at bf16 (models.components.Dense, models.rnn), the moment and
query embeddings are bf16 (their norms as models.xml.l2_normalize takes
them), a sum over the embedding axis accumulates float32 and rounds back
to bf16 (jnp's sum of a bf16 array), and the masked means and products
with float32 operands are float32, where jnp promotes them.

Data-parallel training (``shard``, a ``training.data_parallel.Shard`` of
world k > 1): the triplet losses are per-query means, so a rank's share
is the sum over its rows divided by the global count, its mean over k.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from tvretrieval_tpu_torch.models.components import Dense, init_like_flax
from tvretrieval_tpu_torch.models.rnn import RNNEncoder
from tvretrieval_tpu_torch.models.xml import l2_normalize


@dataclass(frozen=True)
class CALConfig:
    """Same fields and defaults as tvretrieval_tpu.models.cal.CALConfig."""
    ctx_mode: str = "video_sub"
    visual_input_size: int = 3074 * 2 + 2   # [local; global; TEF] concat
    textual_input_size: int = 770 * 2
    query_feat_size: int = 768
    visual_hidden_size: int = 500
    output_size: int = 100
    lstm_hidden_size: int = 1000
    margin: float = 0.1
    loss_type: str = "hinge"
    inter_loss_weight: float = 0.4
    dtype_str: str = "float32"

    @property
    def use_video(self) -> bool:
        return "video" in self.ctx_mode

    @property
    def use_sub(self) -> bool:
        return "sub" in self.ctx_mode

    @property
    def use_tef_only(self) -> bool:
        return "tef" in self.ctx_mode and not (self.use_video or self.use_sub)

    @property
    def uses_video_mlp(self) -> bool:
        return self.use_video or self.use_tef_only

    @property
    def n_streams(self) -> int:
        return int(self.uses_video_mlp) + int(self.use_sub)

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype_str == "bfloat16" else torch.float32


def sum_last(x: torch.Tensor) -> torch.Tensor:
    """``jnp.sum(x, axis=-1)``: at a dtype narrower than float32 the sum
    accumulates float32 and rounds back."""
    if x.dtype == torch.float32:
        return x.sum(dim=-1)
    return x.sum(dim=-1, dtype=torch.float32).to(x.dtype)


class MomentMLP(nn.Module):
    """Dense -> ReLU -> Dense, then L2 norm (reference model.py:146-150)."""

    def __init__(self, in_dim: int, hidden: int, out: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Dense_0 = Dense(in_dim, hidden, dtype=dtype)
        self.Dense_1 = Dense(hidden, out, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return l2_normalize(self.Dense_1(torch.relu(self.Dense_0(x))))


class CALWithSub(nn.Module):
    def __init__(self, cfg: CALConfig):
        super().__init__()
        self.cfg = c = cfg
        if c.loss_type not in ("hinge", "lse"):
            raise NotImplementedError(c.loss_type)
        dt = c.dtype
        if c.uses_video_mlp:
            self.video_moment_mlp = MomentMLP(c.visual_input_size, c.visual_hidden_size,
                                              c.output_size, dt)
        if c.use_sub:
            self.sub_moment_mlp = MomentMLP(c.textual_input_size, c.visual_hidden_size,
                                            c.output_size, dt)
        self.query_lstm = RNNEncoder(c.query_feat_size, c.lstm_hidden_size, "lstm",
                                     bidirectional=False, dtype=dt)
        self.query_linear = Dense(c.lstm_hidden_size, c.output_size, dtype=dt)

    def init_weights(self, generator: torch.Generator) -> "CALWithSub":
        """Seeded initialization with the JAX package's initializers."""
        init_like_flax(self, generator)
        return self

    # ----------------------------------------------------------------- encode
    def encode_query(self, query_feat, query_mask):
        _, hidden = self.query_lstm(query_feat, query_mask.sum(dim=1))
        return l2_normalize(self.query_linear(hidden))                    # (N, Do)

    def encode_moments(self, moment_feat, stream: str):
        return getattr(self, f"{stream}_moment_mlp")(moment_feat)       # (..., Lc, Do)

    # ------------------------------------------------------ corpus encoding
    def streams(self):
        """The streams whose moment MLPs read clip features."""
        c = self.cfg
        if c.use_tef_only:
            raise ValueError("a TEF-only CAL has no clip features to encode")
        return [s for s, on in (("video", c.use_video), ("sub", c.use_sub)) if on]

    @torch.no_grad()
    def encode_clip_parts(self, clip_feat, clip_mask):
        """Eval only. ``clip_feat``: {stream: (n, L, D) raw clip features},
        ``clip_mask``: (n, L) -> {stream: (local (n, L, H), global (n,
        H))}: ``Dense_0`` of the moment MLP split by linearity over a
        clip's row [local; global], the local part ``W_l x`` once a clip and
        the global part ``W_g g + b`` once a video, as
        ``CALExampleBuilder._stream_moment`` builds the row with its
        default normalization: ``x`` the clip L2-normed (``x / (|x| +
        1e-5)``), ``g`` the mean of the video's raw clips L2-normed the
        same way. Rows with a TEF are not split."""
        if self.cfg.dtype is not torch.float32:
            raise NotImplementedError("the split corpus encoder runs in float32")
        m = clip_mask.float()
        out = {}
        for stream in self.streams():
            x = clip_feat[stream].float()
            dense = getattr(self, f"{stream}_moment_mlp").Dense_0
            d = x.shape[-1]
            if dense.in_features != 2 * d:
                raise ValueError(f"{stream}: Dense_0 takes {dense.in_features} inputs, not "
                                 f"[local; global] = 2 x {d} (a TEF is not split)")
            g = (x * m[:, :, None]).sum(dim=1) / m.sum(dim=1, keepdim=True).clamp_min(1.0)
            g = g / (torch.linalg.norm(g, dim=-1, keepdim=True) + 1e-5)
            x = x / (torch.linalg.norm(x, dim=-1, keepdim=True) + 1e-5)
            out[stream] = (x @ dense.weight[:, :d].T,
                           torch.addmm(dense.bias, g, dense.weight[:, d:].T))
        return out

    @torch.no_grad()
    def encode_proposal_means(self, parts, clip_index, clip_mask):
        """Eval only. ``parts`` from ``encode_clip_parts``; ``clip_index``
        (n, P, C) int64 clip positions of each proposal's clips,
        ``clip_mask`` (n, P, C) -> {stream: (mean_emb (n, P, Do), mean_sq
        (n, P))}: the mean over a proposal's clips of the embedding
        ``L2(Dense_1(ReLU(local + global)))`` and of its squared norm. A
        clip's row is the same in every proposal that holds it, so each
        clip is encoded once and gathered."""
        m = clip_mask.float()
        denom = m.sum(dim=-1).clamp_min(1.0)                              # (n, P)
        n, P, C = clip_index.shape
        flat = clip_index.reshape(n, P * C)
        out = {}
        for stream, (local, glob) in parts.items():
            mlp = getattr(self, f"{stream}_moment_mlp")
            emb = l2_normalize(mlp.Dense_1(torch.relu(local + glob[:, None])))  # (n, L, Do)
            sq = sum_last(emb ** 2)                                       # (n, L)
            e = torch.gather(emb, 1, flat[:, :, None].expand(-1, -1, emb.shape[-1]))
            mean_emb = (e.view(n, P, C, -1) * m[..., None]).sum(dim=-2) / denom[..., None]
            mean_sq = (torch.gather(sq, 1, flat).view(n, P, C) * m).sum(dim=-1) / denom
            out[stream] = (mean_emb, mean_sq)
        return out

    # -------------------------------------------------------------- distances
    def _pdist(self, query_embed, moment_feat, moment_mask, stream):
        """Mean squared-L2 distance over a proposal's clips (model.py:186-196)."""
        emb = self.encode_moments(moment_feat, stream)                    # (N, Lc, Do)
        d = sum_last((emb - query_embed[:, None, :]) ** 2)                # (N, Lc)
        return (d * moment_mask).sum(dim=1) / torch.clamp_min(moment_mask.sum(dim=1), 1.0)

    def compute_pdist(self, query_embed, video_feat, sub_feat, moment_mask):
        c = self.cfg
        dv = self._pdist(query_embed, video_feat, moment_mask, "video") if c.uses_video_mlp else 0
        ds = self._pdist(query_embed, sub_feat, moment_mask, "sub") if c.use_sub else 0
        return (dv + ds) / c.n_streams

    def cdist_from_encoded(self, query_embeds, video_moment_emb, sub_moment_emb, moment_mask):
        """All queries x all proposals (reference compute_cdist_inference
        :213-245), with pre-encoded proposal embeddings.

        query_embeds: (Nq, Do); *_moment_emb: (Np, Lc, Do); mask: (Np, Lc).
        """
        c = self.cfg
        denom = torch.clamp_min(moment_mask.sum(dim=1), 1.0)[None]

        def one(emb):
            # ||q - m||^2 = |q|^2 - 2 q.m + |m|^2: one product + rank-1 terms
            q2 = sum_last(query_embeds ** 2)[:, None, None]               # (Nq, 1, 1)
            m2 = sum_last(emb ** 2)[None]                                 # (1, Np, Lc)
            qm = torch.einsum("qd,pld->qpl", query_embeds.float(), emb.float())
            d = q2 - 2 * qm + m2                                          # (Nq, Np, Lc)
            return (d * moment_mask[None]).sum(dim=-1) / denom            # (Nq, Np)

        dv = one(video_moment_emb) if c.uses_video_mlp else 0
        ds = one(sub_moment_emb) if c.use_sub else 0
        return (dv + ds) / c.n_streams

    # ------------------------------------------------------------------ train
    def _rank_loss(self, pos_dist, neg_dist):
        c = self.cfg
        if c.loss_type == "hinge":
            return torch.relu(c.margin + pos_dist - neg_dist).mean()
        return torch.log1p(torch.exp(pos_dist - neg_dist)).mean()

    def forward(self, query_feat, query_mask,
                pos_video_feat, pos_sub_feat, pos_mask,
                intra_video_feat, intra_sub_feat, intra_mask,
                inter_video_feat, inter_sub_feat, inter_mask, shard=None):
        """Triplet loss: pos vs intra-video negative + weighted inter-video
        negative (reference forward :247-286); under a ``shard`` of world
        > 1, this rank's share of the global batch's."""
        q = self.encode_query(query_feat, query_mask)
        pos = self.compute_pdist(q, pos_video_feat, pos_sub_feat, pos_mask)
        intra = self.compute_pdist(q, intra_video_feat, intra_sub_feat, intra_mask)
        loss = self._rank_loss(pos, intra)
        if self.cfg.inter_loss_weight != 0:
            inter = self.compute_pdist(q, inter_video_feat, inter_sub_feat, inter_mask)
            loss = loss + self.cfg.inter_loss_weight * self._rank_loss(pos, inter)
        if shard is not None and shard.world > 1:
            loss = loss / shard.world
        return loss, {"loss_overall": loss}
