"""MEE — Mixture of Embedding Experts (video-retrieval baseline), PyTorch.

Port of tvretrieval_tpu/models/mee.py (reference baselines/
mixture_embedding_experts/model.py + model_components.py): NetVLAD query
pooling (2 clusters), Gated Embedding Units per stream, learned MoE weights
fusing the per-stream similarity matrices, and the bidirectional max-margin
ranking loss over the in-batch confusion matrix.

BatchNorm is flax's, not torch's (``BatchNorm`` below): the running
statistics move by ``ra = 0.99 ra + 0.01 batch_stat`` (torch momentum
0.01), the running variance takes the biased batch variance
(``E[x^2] - E[x]^2``, clipped at 0, as flax's fast variance computes it),
statistics are float32 whatever the input's dtype, and eps is 1e-5.
``model.train()`` normalizes with the batch statistics and updates the
running ones; ``model.eval()`` normalizes with the running ones. The
running statistics are module buffers, so they live in ``state_dict``.

Data-parallel training (``shard``, a ``training.data_parallel.Shard`` of
world k > 1; each rank holds its rows of the global batch) computes the
global batch's function, as the JAX step does on a k-device mesh: in
training, BatchNorm normalizes with the global batch's moments (Σx, Σx²
and the row count summed over the ranks, their gradient summed back), so
the running statistics move as one process's do; ``forward`` returns the
rank's share of the max-margin loss over the global (N, N) confusion
matrix, from the gathered query embeddings and MoE weights (its columns)
and the gathered video / subtitle embeddings (its rows).

Padded query tokens count: NetVLAD pools over all N * L tokens, pads
included, and ``forward`` takes ``query_mask`` and ignores it, as the JAX
model does. ``_l2norm`` is ``x / (||x|| + 1e-12)``.

Compute dtype: under ``dtype_str="bfloat16"`` the Dense layers compute at
bf16 (models.components.Dense); BatchNorm returns float32 (flax promotes
to its float32 parameters), so the gating, the norms and the scores are
float32; NetVLAD ignores the compute dtype, as the flax module does.
Module attributes carry the flax names (``Dense_0``, ``ContextGating_0``,
``bn``), so ``convert.flax_variables_to_state_dict`` loads by name.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from tvretrieval_tpu_torch.models.components import Dense, init_like_flax

BN_MOMENTUM = 0.99       # flax BatchNorm's default: ra = 0.99 ra + 0.01 stat
BN_EPS = 1e-5


@dataclass(frozen=True)
class MEEConfig:
    """The fields of tvretrieval_tpu.models.mee.MEEConfig, plus
    ``sub_input_size``: flax's Dense infers the subtitle width, the port
    builds ``nn.Linear`` from it."""
    ctx_mode: str = "video_sub"
    text_input_size: int = 768
    vid_input_size: int = 3072
    output_size: int = 256
    margin: float = 0.2
    dtype_str: str = "float32"
    sub_input_size: int = 768

    @property
    def use_video(self) -> bool:
        return "video" in self.ctx_mode

    @property
    def use_sub(self) -> bool:
        return "sub" in self.ctx_mode

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype_str == "bfloat16" else torch.float32


def _l2norm(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return x / (torch.linalg.norm(x, dim=dim, keepdim=True) + 1e-12)


class BatchNorm(nn.BatchNorm1d):
    """flax ``nn.BatchNorm`` over the last axis of any-rank input (see the
    module docstring); returns float32."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=BN_EPS, momentum=1.0 - BN_MOMENTUM)

    def forward(self, x: torch.Tensor, shard=None) -> torch.Tensor:
        x = x.float()
        if self.training:
            rows = x.reshape(-1, x.shape[-1])
            if shard is None or shard.world == 1:
                mean = rows.mean(dim=0)
                var = torch.clamp_min((rows * rows).mean(dim=0) - mean * mean, 0.0)
            else:
                # the global batch's moments: (Σx, Σx², rows) over every rank
                d = rows.shape[1]
                sums = shard.all_reduce(torch.cat([rows.sum(dim=0), (rows * rows).sum(dim=0),
                                                   rows.new_tensor([rows.shape[0]])]))
                mean = sums[:d] / sums[-1]
                var = torch.clamp_min(sums[d:2 * d] / sums[-1] - mean * mean, 0.0)
            with torch.no_grad():
                self.running_mean.mul_(BN_MOMENTUM).add_(self.momentum * mean)
                self.running_var.mul_(BN_MOMENTUM).add_(self.momentum * var)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


class NetVLAD(nn.Module):
    """(reference model_components.py:61-103)"""

    def __init__(self, dim: int, cluster_size: int = 2):
        super().__init__()
        self.clusters = nn.Parameter(torch.zeros(dim, cluster_size))
        self.clusters2 = nn.Parameter(torch.zeros(1, dim, cluster_size))
        self.bn = BatchNorm(cluster_size)

    def forward(self, x: torch.Tensor, shard=None) -> torch.Tensor:
        n, L, D = x.shape
        K = self.clusters.shape[1]
        assignment = self.bn(x.reshape(-1, D) @ self.clusters, shard)       # (NL, K)
        assignment = torch.softmax(assignment, dim=1).reshape(n, L, K)
        a = assignment.sum(dim=1, keepdim=True) * self.clusters2          # (N, D, K)
        vlad = torch.einsum("nlk,nld->nkd", assignment, x).transpose(1, 2) - a
        vlad = _l2norm(vlad, dim=1).reshape(n, -1)                         # intra-norm
        return _l2norm(vlad)


class ContextGating(nn.Module):
    """x * sigmoid(BN(Wx)) (reference :21-35)."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Dense_0 = Dense(dim, dim, dtype=dtype)
        self.bn = BatchNorm(dim)

    def forward(self, x: torch.Tensor, shard=None) -> torch.Tensor:
        return x * torch.sigmoid(self.bn(self.Dense_0(x), shard))


class GatedEmbeddingUnit(nn.Module):
    """Dense -> ContextGating -> L2 norm (reference :7-18)."""

    def __init__(self, in_dim: int, output_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Dense_0 = Dense(in_dim, output_dim, dtype=dtype)
        self.ContextGating_0 = ContextGating(output_dim, dtype)

    def forward(self, x: torch.Tensor, shard=None) -> torch.Tensor:
        return _l2norm(self.ContextGating_0(self.Dense_0(x), shard))


def max_margin_ranking_loss(scores: torch.Tensor, margin: float) -> torch.Tensor:
    """Bidirectional max-margin over the (N, N) confusion matrix
    (reference MaxMarginRankingLoss :38-58): mean over all (pos, other)
    pairs of relu(margin - pos + other), row-wise and column-wise."""
    diag = torch.diagonal(scores)
    row = torch.relu(margin - diag[:, None] + scores)   # query -> all videos
    col = torch.relu(margin - diag[None, :] + scores)   # video -> all queries
    return (row.mean() + col.mean()) / 2


def max_margin_ranking_loss_share(rows: torch.Tensor, cols: torch.Tensor, lo: int,
                                  margin: float) -> torch.Tensor:
    """A rank's share of ``max_margin_ranking_loss`` over the global (N, N)
    matrix: ``rows`` (b, N) are its queries' rows, ``cols`` (N, b) its
    contexts' columns (global rows and columns lo ... lo + b - 1). The
    share is its rows' row terms plus its columns' column terms, each over
    2 N^2; the shares sum over the ranks to the global loss."""
    b, n = rows.shape
    idx = torch.arange(b, device=rows.device)
    diag = rows[idx, lo + idx]
    row = torch.relu(margin - diag[:, None] + rows).sum()
    col = torch.relu(margin - diag[None, :] + cols).sum()
    return (row + col) / (2 * n * n)


class MEE(nn.Module):
    def __init__(self, cfg: MEEConfig):
        super().__init__()
        self.cfg = c = cfg
        dt, out = c.dtype, c.output_size
        self.query_pooling = NetVLAD(c.text_input_size, cluster_size=2)
        pooled = 2 * c.text_input_size
        if c.use_sub:
            self.sub_query_gu = GatedEmbeddingUnit(pooled, out, dt)
            self.sub_gu = GatedEmbeddingUnit(c.sub_input_size, out, dt)
        if c.use_video:
            self.video_query_gu = GatedEmbeddingUnit(pooled, out, dt)
            self.video_gu = GatedEmbeddingUnit(c.vid_input_size, out, dt)
        if c.use_video and c.use_sub:
            self.moe_fc = Dense(pooled, 2, dtype=dt)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "MEE":
        """Seeded initialization with the JAX package's initializers: Dense
        N(0, 0.02) with zero bias, the NetVLAD clusters N(0, 1/D), BatchNorm
        scale 1, bias 0 and fresh running statistics."""
        init_like_flax(self, generator)
        std = self.cfg.text_input_size ** -0.5
        for p in (self.query_pooling.clusters, self.query_pooling.clusters2):
            p.normal_(0.0, std, generator=generator)
        for m in self.modules():
            if isinstance(m, BatchNorm):
                m.reset_parameters()
        return self

    def encode_context(self, video_feat, sub_feat, shard=None):
        """video_feat / sub_feat: (N, D) mean-pooled video-level features."""
        c = self.cfg
        ev = self.video_gu(video_feat, shard) if c.use_video else None
        es = self.sub_gu(sub_feat, shard) if c.use_sub else None
        return ev, es

    def pool_query(self, query_feat, shard=None):
        return self.query_pooling(query_feat, shard)

    def query_embeddings(self, pooled_query, shard=None):
        """(video query embedding, subtitle query embedding, MoE weights
        (Nq, 2)); None for a stream or a fusion the model lacks."""
        c = self.cfg
        qv = self.video_query_gu(pooled_query, shard) if c.use_video else None
        qs = self.sub_query_gu(pooled_query, shard) if c.use_sub else None
        w = self.moe_fc(pooled_query) if c.use_video and c.use_sub else None
        return qv, qs, w

    @staticmethod
    def fuse(qv, qs, w, encoded_video, encoded_sub):
        """(Nq, Nc) fused similarity of the query embeddings and weights
        against the encoded contexts."""
        v = qv @ encoded_video.T if qv is not None else 0
        s = qs @ encoded_sub.T if qs is not None else 0
        if w is not None:
            return w[:, 0:1] * v + w[:, 1:2] * s
        return v + s

    def scores(self, pooled_query, encoded_video, encoded_sub):
        """(Nq, Nc) fused similarity (reference model.py:64-83)."""
        return self.fuse(*self.query_embeddings(pooled_query), encoded_video, encoded_sub)

    def forward(self, query_feat, query_mask, video_feat, sub_feat, shard=None):
        """The training loss, or under a ``shard`` of world > 1 the rank's
        share of the global batch's; ``query_mask`` is taken and ignored."""
        pooled = self.pool_query(query_feat, shard)
        ev, es = self.encode_context(video_feat, sub_feat, shard)
        if shard is None or shard.world == 1:
            return max_margin_ranking_loss(self.scores(pooled, ev, es).float(),
                                           self.cfg.margin)
        qv, qs, w = self.query_embeddings(pooled, shard)
        rows = self.fuse(qv, qs, w, shard.gather(ev), shard.gather(es)).float()   # (b, N)
        cols = self.fuse(shard.gather(qv), shard.gather(qs), shard.gather(w), ev,
                         es).float()                                               # (N, b)
        return max_margin_ranking_loss_share(rows, cols, shard.rank * len(pooled),
                                             self.cfg.margin)
