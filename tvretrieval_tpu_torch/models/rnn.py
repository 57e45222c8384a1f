"""Masked (bi)directional RNN encoder (port of tvretrieval_tpu/models/rnn.py).

Same semantics as the flax scan (``nn.RNN(seq_lengths=...)``, and for the
backward direction ``reverse=True, keep_order=True``; reference
utils/model_utils.py:10-72): LSTM or GRU, one or two directions, outputs
past each row's length zeroed, the final hidden taken at each row's true
end, the backward direction run over the valid prefix reversed.

No packing and no host sync: each direction runs over the whole padded row
(a step's output depends only on the steps before it, so the valid
positions are exact). The backward direction runs over the row as flax's
``flip_sequences`` orders it: the valid prefix reversed, then the padding
reversed. The final hidden is the carry at step ``(length - 1) % L`` of the
run, as flax's ``_select_last_carry`` indexes it; for a row of length 0
that is the carry after the whole padded row, not zero (the outputs are
zero).

Parameters are torch's ``nn.LSTM`` / ``nn.GRU`` ones (``fwd_cell`` and
``bwd_cell``, one direction each; ``convert.flax_params_to_state_dict``
maps flax's per-gate kernels onto them). The flax cells have fewer biases
than torch's: the LSTM has only the recurrent ones, the GRU no recurrent
bias on its r and z gates. Those torch biases stay zero, since their
gradients are zeroed, so a step trains what flax trains.

Under float32 the recurrences are torch's LSTM / GRU (cuDNN on the card).
Under bfloat16 compute a plain loop over the steps keeps the flax cells' cast
points: both products and the gates at bf16, the carry (c, h) and the
outputs float32 (flax's carry is float32 whatever the compute dtype).
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn


def _zero_grad_rows(p: nn.Parameter, lo: int, hi: int) -> None:
    """Keep rows [lo, hi) of ``p`` at their value: zero their gradient."""
    def hook(g):
        g = g.clone()
        g[lo:hi] = 0
        return g
    p.register_hook(hook)


def _cell(rnn_type: str, in_dim: int, hidden: int) -> nn.RNNBase:
    if rnn_type == "lstm":
        cell = nn.LSTM(in_dim, hidden, batch_first=True)
        _zero_grad_rows(cell.bias_ih_l0, 0, 4 * hidden)        # flax: no input bias
    elif rnn_type == "gru":
        cell = nn.GRU(in_dim, hidden, batch_first=True)
        _zero_grad_rows(cell.bias_hh_l0, 0, 2 * hidden)        # flax: no hr / hz bias
    else:
        raise NotImplementedError(rnn_type)
    with torch.no_grad():
        for p in (cell.bias_ih_l0, cell.bias_hh_l0):
            p.zero_()
    return cell


def _flip(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """flax ``flip_sequences`` on (N, L, ...) rows: step t takes step
    (L - 1 - t + length) % L, so the valid prefix is reversed and so is the
    padding after it. An involution."""
    L = x.shape[1]
    t = torch.arange(L, device=x.device)[None]
    idx = (L - 1 - t + lengths[:, None]) % L
    return torch.gather(x, 1, idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand_as(x))


def _loop(cell: nn.RNNBase, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The flax cell's scan at compute ``dtype``: the products and the
    gates at ``dtype``, the carry and the (N, L, H) outputs float32."""
    n, L, _ = x.shape
    H = cell.hidden_size
    lstm = isinstance(cell, nn.LSTM)
    xp = x.to(dtype) @ cell.weight_ih_l0.to(dtype).T             # (N, L, G*H)
    if not lstm:
        xp = xp + cell.bias_ih_l0.to(dtype)
    w_hh = cell.weight_hh_l0.to(dtype).T
    b_hh = cell.bias_hh_l0.to(dtype)
    h = x.new_zeros((n, H), dtype=torch.float32)
    c = torch.zeros_like(h)
    outs = []
    for t in range(L):
        hp = h.to(dtype) @ w_hh
        if lstm:
            i, f, g, o = ((hp + b_hh) + xp[:, t]).split(H, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
        else:
            ir, iz, i_n = xp[:, t].split(H, dim=-1)
            hr, hz, hn = hp.split(H, dim=-1)
            r = torch.sigmoid(ir + hr)
            z = torch.sigmoid(iz + hz)
            h = (1.0 - z) * torch.tanh(i_n + r * (hn + b_hh[2 * H:])) + z * h
        outs.append(h)
    return torch.stack(outs, dim=1)


class RNNEncoder(nn.Module):
    """Returns (outputs (N, L, dirs*H), final_hidden (N, dirs*H)); outputs
    at positions >= length are zero (pad_packed_sequence parity)."""

    def __init__(self, in_dim: int, hidden_size: int, rnn_type: str = "lstm",
                 bidirectional: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden_size = hidden_size           # per direction
        self.dtype = dtype
        self.fwd_cell = _cell(rnn_type, in_dim, hidden_size)
        self.bwd_cell = _cell(rnn_type, in_dim, hidden_size) if bidirectional else None

    def _run(self, cell: nn.RNNBase, x: torch.Tensor, lengths: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(outputs in the run's own order, the carry at step (length-1) % L)."""
        out = (cell(x.float())[0] if self.dtype == torch.float32
               else _loop(cell, x, self.dtype))
        last = (lengths - 1) % x.shape[1]
        return out, out[torch.arange(x.shape[0], device=x.device), last]

    def forward(self, x: torch.Tensor, lengths: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        lengths = lengths.long()
        out, hid = self._run(self.fwd_cell, x, lengths)
        outs, hiddens = [out], [hid]
        if self.bwd_cell is not None:
            out, hid = self._run(self.bwd_cell, _flip(x, lengths), lengths)
            outs.append(_flip(out, lengths))
            hiddens.append(hid)
        L = x.shape[1]
        mask = (torch.arange(L, device=x.device)[None] < lengths[:, None]).float()
        outputs = torch.cat(outs, dim=-1) if len(outs) > 1 else outs[0]
        hidden = torch.cat(hiddens, dim=-1) if len(hiddens) > 1 else hiddens[0]
        return outputs * mask[:, :, None], hidden


def max_pool_masked(outputs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Max over valid time steps (reference pool_across_time, model_utils.py:75)."""
    return (outputs + (1.0 - mask)[:, :, None] * -1e10).amax(dim=1)


def mean_pool_masked(outputs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    denom = torch.clamp_min(mask.sum(dim=1, keepdim=True), 1.0)
    return (outputs * mask[:, :, None]).sum(dim=1) / denom
