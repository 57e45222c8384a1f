"""Shared neural blocks (port of tvretrieval_tpu/models/components.py).

Attribute names follow the flax modules' parameter names (``ln``,
``dense``, ``query``/``key``/``value``, ``self``/``output``, ``conv``,
``depthwise``/``pointwise``, ``pos_embed``) so
``convert.flax_params_to_state_dict`` maps a flax tree onto these modules
by name. LayerNorm eps is torch's 1e-5 (the JAX package sets the same), and
attention masking is the reference's additive ``(1 - m) * -1e4``
(reference model_components.py:277).

Compute dtype: every block takes the ``dtype`` the flax module takes
(``XMLConfig.dtype_str``). Parameters stay float32; ``Dense``, ``Conv`` and
``LayerNorm`` cast their inputs and parameters to ``dtype`` and return
``dtype``, as flax's ``promote_dtype`` does, and every other cast sits where
the flax source puts it (the attention scores and context accumulate f32).
Under float32 each block computes exactly what it computed before.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-5


class Dense(nn.Linear):
    """flax ``nn.Dense(dtype=...)``: input, kernel and bias cast to
    ``dtype``; the product rounds to ``dtype``, then the bias add does.
    Under float32 it is ``nn.Linear``."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_dim, out_dim, bias=bias)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is torch.float32:
            return F.linear(x if x.dtype is torch.float32 else x.float(), self.weight, self.bias)
        y = x.to(self.dtype) @ self.weight.to(self.dtype).T
        return y if self.bias is None else y + self.bias.to(self.dtype)


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm(dtype=...)``: statistics and normalization in
    float32 whatever the input's dtype, the result cast to ``dtype``."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__(dim, eps=LN_EPS)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype is not torch.float32:
            x = x.float()
        y = F.layer_norm(x, self.normalized_shape, self.weight, self.bias, self.eps)
        return y if self.dtype is torch.float32 else y.to(self.dtype)


class Conv(nn.Conv1d):
    """flax ``nn.Conv(kernel_size=(k,), padding="SAME", dtype=...)`` over
    channels-last (N, L, C) rows: zero padding (k-1)//2 left and k//2
    right, as flax pads; input and kernel cast to ``dtype``, the product
    rounds to ``dtype``, then the bias add does."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, groups: int = 1,
                 bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__(in_ch, out_ch, kernel_size, groups=groups, bias=bias)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kernel_size[0]
        rows = F.pad(x.to(self.dtype).transpose(1, 2), ((k - 1) // 2, k // 2))
        y = F.conv1d(rows, self.weight.to(self.dtype), None, groups=self.groups)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)[:, None]
        return y.transpose(1, 2)


class LinearLayer(nn.Module):
    """Optional LayerNorm -> dropout -> dense -> optional ReLU
    (reference model_components.py:141-163)."""

    def __init__(self, in_dim: int, out_dim: int, layer_norm: bool = True,
                 dropout: float = 0.1, relu: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ln = LayerNorm(in_dim, dtype) if layer_norm else None
        self.drop = nn.Dropout(dropout)
        self.dense = Dense(in_dim, out_dim, dtype=dtype)
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.ln is not None:
            x = self.ln(x)
        x = self.dense(self.drop(x))
        return F.relu(x) if self.relu else x


class TrainablePositionalEncoding(nn.Module):
    """x + learned positional embedding, then LN + dropout
    (reference model_components.py:67-89). The sum is taken in the
    promoted dtype (the embedding is a float32 parameter), as in flax."""

    def __init__(self, max_len: int, dim: int, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pos_embed = nn.Parameter(torch.zeros(max_len, dim))
        self.ln = LayerNorm(dim, dtype)
        self.drop = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        L = x.shape[-2]
        return self.drop(self.ln(x + self.pos_embed[:L]))


def sinusoidal_position_encoding(length: int, dim: int) -> torch.Tensor:
    """Static sine / cosine PE table, (length, dim) float32 (reference
    PositionEncoding:105-125): even columns sin(pos * f), odd columns
    cos(pos * f), f = exp(-ln(10000) * 2i / dim). Built on the host with
    numpy's float32 sin / cos, as the JAX package builds it (torch's differ
    by up to 8e-6 at position 100), so the two tables are equal."""
    position = np.arange(length, dtype=np.float32)[:, None]
    div_term = np.exp(np.arange(0, dim, 2, dtype=np.float32) * -(math.log(10000.0) / dim))
    pe = np.zeros((length, dim), dtype=np.float32)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term[: pe[:, 1::2].shape[1]])
    return torch.from_numpy(pe)


class BertSelfAttention(nn.Module):
    """Multi-head attention over separate q/k/v inputs with a float mask
    broadcastable to (N, Lq, Lk); used as self-attention and as the
    video<->subtitle cross-attention (reference model_components.py:244-303,
    model_xml.py:349-354). Scores, softmax and the context accumulate in
    float32; the probabilities enter the context product at ``dtype`` and
    the context is returned at ``dtype``, as in the flax module."""

    def __init__(self, dim: int, num_heads: int, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"hidden size {dim} not divisible by {num_heads} heads")
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.dtype = dtype
        self.query = Dense(dim, dim, dtype=dtype)
        self.key = Dense(dim, dim, dtype=dtype)
        self.value = Dense(dim, dim, dtype=dtype)
        self.drop = nn.Dropout(dropout)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        n, length, _ = x.shape
        return x.view(n, length, self.num_heads, self.head_dim).transpose(1, 2)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        qh = self._heads(self.query(q))                      # (N, H, Lq, dh)
        kh = self._heads(self.key(k))
        vh = self._heads(self.value(v))
        low = self.dtype is not torch.float32
        if low:
            qh, kh = qh.float(), kh.float()
        scores = qh @ kh.transpose(-1, -2) / math.sqrt(self.head_dim)
        if mask.dim() == 2:                                  # (N, Lk)
            mask = mask[:, None, :]
        scores = scores + (1.0 - mask[:, None].to(scores.dtype)) * -1e4
        probs = self.drop(torch.softmax(scores, dim=-1))
        if low:
            probs, vh = probs.to(self.dtype).float(), vh.float()
        ctx = probs @ vh                                     # (N, H, Lq, dh)
        n, _, lq, _ = ctx.shape
        ctx = ctx.transpose(1, 2).reshape(n, lq, self.num_heads * self.head_dim)
        return ctx.to(self.dtype) if low else ctx


class BertSelfOutput(nn.Module):
    """dense -> dropout -> LN(x + residual) (reference :306-317)."""

    def __init__(self, dim: int, dropout: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dense = Dense(dim, dim, dtype=dtype)
        self.drop = nn.Dropout(dropout)
        self.ln = LayerNorm(dim, dtype)

    def forward(self, hidden: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        return self.ln(self.drop(self.dense(hidden)) + residual)


class BertAttention(nn.Module):
    """Self-attention + residual output block: the XML "encoder layer"
    (reference model_components.py:201-216; XML uses it without an FFN)."""

    def __init__(self, dim: int, num_heads: int, att_dropout: float = 0.1,
                 hidden_dropout: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.self = BertSelfAttention(dim, num_heads, att_dropout, dtype)
        self.output = BertSelfOutput(dim, hidden_dropout, dtype)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return self.output(self.self(x, x, x, mask), x)


class DepthwiseSeparableConv(nn.Module):
    """1-D depthwise conv (k, ``groups=D``) + pointwise conv (1x1) +
    optional ReLU over (N, L, D) (reference model_components.py:7-48)."""

    def __init__(self, dim: int, kernel_size: int, relu: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.depthwise = Conv(dim, dim, kernel_size, groups=dim, dtype=dtype)
        self.pointwise = Conv(dim, dim, 1, dtype=dtype)
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.pointwise(self.depthwise(x))
        return F.relu(x) if self.relu else x


class ConvEncoder(nn.Module):
    """LN(dropout(conv(x)) + x) (reference model_components.py:51-64); the
    mask is not used, as in the reference."""

    def __init__(self, dim: int, kernel_size: int = 7, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = DepthwiseSeparableConv(dim, kernel_size, dtype=dtype)
        self.drop = nn.Dropout(dropout)
        self.ln = LayerNorm(dim, dtype)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.ln(self.drop(self.conv(x)) + x)


class Conv1dSame(nn.Module):
    """Single-channel 1-D conv over the last axis of any (..., L) tensor,
    stride 1, zero 'SAME' padding ((k-1)//2 left, k//2 right, as flax pads),
    no bias: the ConvSE start/end predictor (reference model_xml.py:95-100,
    162-165). Input and kernel are cast to ``dtype``; so is the result."""

    def __init__(self, kernel_size: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel_size = kernel_size
        self.dtype = dtype
        self.conv = nn.Conv1d(1, 1, kernel_size, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kernel_size
        rows, w = x.reshape(-1, 1, x.shape[-1]), self.conv.weight
        if self.dtype is not torch.float32 or rows.dtype is not torch.float32:
            rows, w = rows.to(self.dtype), w.to(self.dtype)
        return F.conv1d(F.pad(rows, ((k - 1) // 2, k // 2)), w).reshape(x.shape)


def lecun_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax's ``lecun_normal``: a normal truncated at two standard
    deviations, its deviation scaled so the variance is 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=generator)


@torch.no_grad()
def init_like_flax(module: nn.Module, generator: torch.Generator) -> None:
    """Re-draw every parameter of ``module`` from ``generator`` with the
    JAX package's initializers: dense and positional weights N(0, 0.02),
    zero biases, unit LayerNorm scales, the ConvSE kernel
    U(-1/sqrt(k), 1/sqrt(k)) (components.py:28-29, 197-202), flax's
    default ``lecun_normal`` for the encoder convolutions, and for the
    recurrent cells ``lecun_normal`` input kernels, an ``orthogonal``
    recurrent kernel per gate and zero biases (flax's cell defaults)."""
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
        elif isinstance(m, Conv):
            lecun_normal_(m.weight, m.weight.shape[1] * m.weight.shape[2], generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.RNNBase):
            h = m.hidden_size
            for name, p in m.named_parameters():
                if name.startswith("weight_ih"):
                    lecun_normal_(p, p.shape[1], generator)
                elif name.startswith("weight_hh"):
                    for g in range(p.shape[0] // h):
                        nn.init.orthogonal_(p[g * h:(g + 1) * h], generator=generator)
                else:
                    p.zero_()


@contextlib.contextmanager
def evaluating(module: nn.Module):
    """``module.eval()`` inside the block, its former mode restored after:
    the engines' counterpart of flax's ``train=False`` /
    ``deterministic=True`` (BatchNorm's running statistics, no dropout)."""
    was_training = module.training
    module.eval()
    try:
        yield module
    finally:
        module.train(was_training)
