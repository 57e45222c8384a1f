"""Shared neural blocks (port of tvretrieval_tpu/models/components.py).

Attribute names follow the flax modules' parameter names (``ln``,
``dense``, ``query``/``key``/``value``, ``self``/``output``, ``conv``,
``pos_embed``) so ``convert.flax_params_to_state_dict`` maps a flax tree
onto these modules by name. LayerNorm eps is torch's 1e-5 (the JAX package
sets the same), and attention masking is the reference's additive
``(1 - m) * -1e4`` (reference model_components.py:277).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-5


class LinearLayer(nn.Module):
    """Optional LayerNorm -> dropout -> dense -> optional ReLU
    (reference model_components.py:141-163)."""

    def __init__(self, in_dim: int, out_dim: int, layer_norm: bool = True,
                 dropout: float = 0.1, relu: bool = True):
        super().__init__()
        self.ln = nn.LayerNorm(in_dim, eps=LN_EPS) if layer_norm else None
        self.drop = nn.Dropout(dropout)
        self.dense = nn.Linear(in_dim, out_dim)
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.ln is not None:
            x = self.ln(x)
        x = self.dense(self.drop(x))
        return F.relu(x) if self.relu else x


class TrainablePositionalEncoding(nn.Module):
    """x + learned positional embedding, then LN + dropout
    (reference model_components.py:67-89)."""

    def __init__(self, max_len: int, dim: int, dropout: float = 0.1):
        super().__init__()
        self.pos_embed = nn.Parameter(torch.zeros(max_len, dim))
        self.ln = nn.LayerNorm(dim, eps=LN_EPS)
        self.drop = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        L = x.shape[-2]
        return self.drop(self.ln(x + self.pos_embed[:L]))


class BertSelfAttention(nn.Module):
    """Multi-head attention over separate q/k/v inputs with a float mask
    broadcastable to (N, Lq, Lk); used as self-attention and as the
    video<->subtitle cross-attention (reference model_components.py:244-303,
    model_xml.py:349-354)."""

    def __init__(self, dim: int, num_heads: int, dropout: float = 0.1):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"hidden size {dim} not divisible by {num_heads} heads")
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.drop = nn.Dropout(dropout)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        n, length, _ = x.shape
        return x.view(n, length, self.num_heads, self.head_dim).transpose(1, 2)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        qh = self._heads(self.query(q))                      # (N, H, Lq, dh)
        kh = self._heads(self.key(k))
        vh = self._heads(self.value(v))
        scores = qh @ kh.transpose(-1, -2) / math.sqrt(self.head_dim)
        if mask.dim() == 2:                                  # (N, Lk)
            mask = mask[:, None, :]
        scores = scores + (1.0 - mask[:, None].to(scores.dtype)) * -1e4
        probs = self.drop(torch.softmax(scores, dim=-1))
        ctx = probs @ vh                                     # (N, H, Lq, dh)
        n, _, lq, _ = ctx.shape
        return ctx.transpose(1, 2).reshape(n, lq, self.num_heads * self.head_dim)


class BertSelfOutput(nn.Module):
    """dense -> dropout -> LN(x + residual) (reference :306-317)."""

    def __init__(self, dim: int, dropout: float = 0.1):
        super().__init__()
        self.dense = nn.Linear(dim, dim)
        self.drop = nn.Dropout(dropout)
        self.ln = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, hidden: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        return self.ln(self.drop(self.dense(hidden)) + residual)


class BertAttention(nn.Module):
    """Self-attention + residual output block: the XML "encoder layer"
    (reference model_components.py:201-216; XML uses it without an FFN)."""

    def __init__(self, dim: int, num_heads: int, att_dropout: float = 0.1,
                 hidden_dropout: float = 0.1):
        super().__init__()
        self.self = BertSelfAttention(dim, num_heads, att_dropout)
        self.output = BertSelfOutput(dim, hidden_dropout)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return self.output(self.self(x, x, x, mask), x)


class Conv1dSame(nn.Module):
    """Single-channel 1-D conv over the last axis of any (..., L) tensor,
    stride 1, zero 'SAME' padding ((k-1)//2 left, k//2 right, as flax pads),
    no bias: the ConvSE start/end predictor (reference model_xml.py:95-100,
    162-165)."""

    def __init__(self, kernel_size: int):
        super().__init__()
        self.kernel_size = kernel_size
        self.conv = nn.Conv1d(1, 1, kernel_size, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kernel_size
        rows = F.pad(x.reshape(-1, 1, x.shape[-1]), ((k - 1) // 2, k // 2))
        return self.conv(rows).reshape(x.shape)


@torch.no_grad()
def init_like_flax(module: nn.Module, generator: torch.Generator) -> None:
    """Re-draw every parameter of ``module`` from ``generator`` with the
    JAX package's initializers: dense and positional weights N(0, 0.02),
    zero biases, unit LayerNorm scales, and the ConvSE kernel
    U(-1/sqrt(k), 1/sqrt(k)) (components.py:28-29, 197-202)."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            m.weight.normal_(0.0, 0.02, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, TrainablePositionalEncoding):
            m.pos_embed.normal_(0.0, 0.02, generator=generator)
        elif isinstance(m, Conv1dSame):
            bound = 1.0 / math.sqrt(m.kernel_size)
            m.conv.weight.uniform_(-bound, bound, generator=generator)
