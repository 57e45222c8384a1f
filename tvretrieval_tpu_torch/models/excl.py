"""ExCL — Extractive Clip Localization (SVMR baseline), PyTorch.

Port of tvretrieval_tpu/models/excl.py (reference baselines/excl/
model.py:21-165): a bidirectional-LSTM query encoder pooled to its final
hidden, two stacked bidirectional context LSTMs per stream with the query
vector concatenated between them, and MLP(tanh) start/end predictors over
[ctx2; ctx1; query]. Cross-entropy span loss only (SVMR task).

The five LSTMs are models.rnn.RNNEncoder (cuDNN under float32; the
served second LSTMs of ``fused_span_logits`` a kernel, below). Dropout
is on in ``model.train()`` and draws from the ``generator`` passed to
``forward`` / ``span_logits`` (the global generator when None), never
from JAX's PRNG: parity with the JAX model holds with ``drop=0`` or in
eval mode. Compute dtype: under ``dtype_str="bfloat16"`` the LSTMs and the
predictors' Dense layers compute at bf16 (the LSTM outputs stay float32,
flax's carry dtype), and the masked logits are float32.

In eval mode (no dropout) each stream's first context LSTM does not see
the query, so ``encode_context`` gives its outputs (``ctx1``) once per
video and ``fused_span_logits`` runs the query-dependent rest (the second
LSTM over ``[ctx1; query]``, the heads, the mask) for any pairing of
queries with encoded videos: together they are ``span_logits`` in eval
mode. At float32 the second LSTMs of both streams are one call of
``ops/lstm.py::excl_lstm`` (the query's part of their input products split
off by linearity; on a card one kernel launch, on the CPU the plain
concatenation and ``encoder2``); under bfloat16 compute each stream's
``encoder2`` over the concatenation, as ``span_logits`` runs it. Under
``torch.profiler`` the second LSTMs are the span "excl_lstm" and the heads
the span "excl_head" (utils/trace.py).

Data-parallel training (``shard``, a ``training.data_parallel.Shard`` of
world k > 1; the rank holds its rows of the global batch): each dropout
mask is drawn for the global batch from the generator, which holds the
same state on every rank, and the rank keeps its rows (JAX draws one key
for the whole sharded batch); the start / end cross-entropy, a per-row
mean, becomes the rank's share, its mean over k.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from tvretrieval_tpu_torch.models.components import Dense, init_like_flax
from tvretrieval_tpu_torch.models.rnn import RNNEncoder
from tvretrieval_tpu_torch.models.xml import _cross_entropy
from tvretrieval_tpu_torch.ops import lstm
from tvretrieval_tpu_torch.ops.masking import mask_logits
from tvretrieval_tpu_torch.utils import trace


@dataclass(frozen=True)
class ExCLConfig:
    """Same fields and defaults as tvretrieval_tpu.models.excl.ExCLConfig."""
    ctx_mode: str = "video_sub"
    visual_input_size: int = 3074
    sub_input_size: int = 770
    query_input_size: int = 768
    hidden_size: int = 256
    drop: float = 0.5
    initializer_range: float = 0.02
    dtype_str: str = "float32"

    @property
    def use_video(self) -> bool:
        return "video" in self.ctx_mode

    @property
    def use_sub(self) -> bool:
        return "sub" in self.ctx_mode

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype_str == "bfloat16" else torch.float32


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: Optional[torch.Generator], shard=None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - p, kept values
    scaled by 1 / (1 - p); the mask drawn from ``generator``. Under a
    ``shard``, ``x`` holds the rank's rows: the mask is drawn for the
    global batch and the rank's rows kept."""
    if not training or p == 0.0:
        return x
    world = 1 if shard is None else shard.world
    keep = torch.empty((x.shape[0] * world,) + tuple(x.shape[1:]), device=x.device)
    keep.bernoulli_(1.0 - p, generator=generator)
    if world > 1:
        keep = keep[shard.rows(len(keep))]
    return x * keep / (1.0 - p)


class SpanPredictor(nn.Module):
    """Linear -> tanh -> Linear(1) (reference excl/model.py:57-60)."""

    def __init__(self, in_dim: int, hidden_size: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Dense_0 = Dense(in_dim, hidden_size, dtype=dtype)
        self.Dense_1 = Dense(hidden_size, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_1(torch.tanh(self.Dense_0(x)))[..., 0]


class ExCL(nn.Module):
    def __init__(self, cfg: ExCLConfig):
        super().__init__()
        self.cfg = c = cfg
        h, dt = c.hidden_size // 2, c.dtype
        self.query_encoder = RNNEncoder(c.query_input_size, h, "lstm", True, dt)
        for stream, in_dim, used in (("video", c.visual_input_size, c.use_video),
                                     ("sub", c.sub_input_size, c.use_sub)):
            if not used:
                continue
            add = lambda name, module: setattr(self, f"{stream}_{name}", module)
            add("encoder", RNNEncoder(in_dim, h, "lstm", True, dt))
            add("encoder2", RNNEncoder(4 * h, h, "lstm", True, dt))
            add("st_predictor", SpanPredictor(6 * h, c.hidden_size, dt))
            add("ed_predictor", SpanPredictor(6 * h, c.hidden_size, dt))

    def init_weights(self, generator: torch.Generator) -> "ExCL":
        """Seeded initialization with the JAX package's initializers."""
        init_like_flax(self, generator)
        return self

    def _single_stream(self, encoded_query, ctx_feat, ctx_mask, stream, generator, shard=None):
        """(reference get_prob_single_stream, excl/model.py:110-123)"""
        lengths = ctx_mask.sum(dim=1).int()
        drop = lambda x: dropout(x, self.cfg.drop, self.training, generator, shard)
        ctx1, _ = getattr(self, f"{stream}_encoder")(drop(ctx_feat), lengths)
        ctx2, _ = getattr(self, f"{stream}_encoder2")(
            drop(torch.cat([ctx1, encoded_query], dim=-1)), lengths)
        feat3 = torch.cat([ctx2, ctx1, encoded_query], dim=-1)
        st = getattr(self, f"{stream}_st_predictor")(feat3)
        ed = getattr(self, f"{stream}_ed_predictor")(feat3)
        return mask_logits(st, ctx_mask), mask_logits(ed, ctx_mask)

    def span_logits(self, query_feat, query_mask, video_feat, video_mask, sub_feat, sub_mask,
                    generator: Optional[torch.Generator] = None, shard=None):
        """(st_logits, ed_logits), each (N, Lc); ``shard``: the rows are a
        rank's of a global batch (the dropout masks)."""
        c = self.cfg
        _, q_hidden = self.query_encoder(query_feat, query_mask.sum(dim=1).int())  # (N, D)
        Lc = (video_feat if c.use_video else sub_feat).shape[1]
        q_rep = q_hidden[:, None, :].expand(q_hidden.shape[0], Lc, q_hidden.shape[-1])
        vst, ved = (self._single_stream(q_rep, video_feat, video_mask, "video", generator, shard)
                    if c.use_video else (0, 0))
        sst, sed = (self._single_stream(q_rep, sub_feat, sub_mask, "sub", generator, shard)
                    if c.use_sub else (0, 0))
        n = int(c.use_video) + int(c.use_sub)
        return (vst + sst) / n, (ved + sed) / n

    def _streams(self):
        c = self.cfg
        return [s for s, used in (("video", c.use_video), ("sub", c.use_sub)) if used]

    def _eval_only(self, name: str) -> None:
        if self.training:
            raise RuntimeError(f"ExCL.{name} is for eval mode: in training, dropout draws "
                               "make each stream's first LSTM depend on the pairing")

    def encode_context(self, video_feat, video_mask, sub_feat, sub_mask):
        """Eval mode: each stream's first context LSTM, which the query does
        not reach, over its (N, Lc, D) features: (video ctx1, sub ctx1),
        each (N, Lc, hidden_size), None for a stream the model lacks."""
        self._eval_only("encode_context")
        inputs = {"video": (video_feat, video_mask), "sub": (sub_feat, sub_mask)}
        out = {s: getattr(self, f"{s}_encoder")(inputs[s][0], inputs[s][1].sum(dim=1).int())[0]
               for s in self._streams()}
        return out.get("video"), out.get("sub")

    def fused_span_logits(self, q_hidden, ctx1s, masks):
        """Eval mode: (st_logits, ed_logits), each (N, Lc), of N pairs of a
        query's final hidden (``q_hidden``, (N, hidden_size)) with a video's
        ``encode_context`` outputs ``ctx1s`` = (video ctx1, sub ctx1) under
        ``masks`` = (video mask, sub mask): each stream's second LSTM over
        [ctx1; query], the start / end heads over [ctx2; ctx1; query], the
        mask, the streams' mean. Equal to ``span_logits`` in eval mode."""
        self._eval_only("fused_span_logits")
        streams = [(s, ctx1, mask) for s, ctx1, mask in zip(("video", "sub"), ctx1s, masks)
                   if s in self._streams()]
        kernel = self.cfg.dtype == torch.float32
        with trace.span("excl_lstm"):
            ctx2s = (lstm.excl_lstm if kernel else lstm.excl_lstm_plain)(
                [getattr(self, f"{stream}_encoder2") for stream, _, _ in streams],
                [ctx1 for _, ctx1, _ in streams], q_hidden,
                [mask.sum(dim=1).int() for _, _, mask in streams])
        st = ed = 0
        with trace.span("excl_head"):
            for (stream, ctx1, mask), ctx2 in zip(streams, ctx2s):
                q_rep = q_hidden[:, None, :].expand(q_hidden.shape[0], ctx1.shape[1],
                                                    q_hidden.shape[-1])
                feat3 = torch.cat([ctx2, ctx1, q_rep], dim=-1)
                st = st + mask_logits(getattr(self, f"{stream}_st_predictor")(feat3), mask)
                ed = ed + mask_logits(getattr(self, f"{stream}_ed_predictor")(feat3), mask)
        return st / len(streams), ed / len(streams)

    def forward(self, query_feat, query_mask, video_feat, video_mask, sub_feat, sub_mask,
                st_ed_indices, generator: Optional[torch.Generator] = None, shard=None):
        """The span loss, or under a ``shard`` of world > 1 this rank's
        share of the global batch's."""
        st, ed = self.span_logits(query_feat, query_mask, video_feat, video_mask,
                                  sub_feat, sub_mask, generator, shard)
        loss = (_cross_entropy(st.float(), st_ed_indices[:, 0])
                + _cross_entropy(ed.float(), st_ed_indices[:, 1]))
        if shard is not None and shard.world > 1:
            loss = loss / shard.world
        return loss, {"loss_st_ed": loss}
