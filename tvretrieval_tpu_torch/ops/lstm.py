"""ExCL's second bidirectional LSTM over [ctx1; query], split by linearity.

``excl_lstm`` runs each stream's ``encoder2`` of ``models/excl.py`` over
``[ctx1; q_rep]``, where ``q_rep`` repeats the pair's query vector on every
clip, as ``ExCL.fused_span_logits`` needs it: the outputs of
``RNNEncoder.forward`` (models/rnn.py) in eval mode at f32. Since
``W_ih . [ctx1; q] = W_c . ctx1 + W_q . q``, the query's part and both
biases are one f32 product a pair (``g_q``, one ``torch.addmm`` for every
stream and direction), and the recurrence takes ``ctx1`` (256 wide) alone:
csrc/excl_lstm.cu, one launch for both streams and both directions, with
the backward direction walked by index (no reversed copies, no
concatenation, no mask pass). That kernel replaces no TPU kernel (the JAX
package's RNNs are a ``lax.scan``); its source note says why it was added.

``excl_lstm_plain`` is the plain version: the concatenation, then
``encoder2`` (cuDNN on a card). The wrapper given CPU tensors runs it; given
CUDA tensors it launches the kernel or raises: it takes f32, bidirectional
LSTM encoders of 128 units a direction over ctx1 rows of 256 and query rows
of 256, the published ExCL widths (``ops._build.launch`` counts the
launch).

The kernel's weights are prepared once per model and kept until a parameter
changes (``_build.prepared``: its storage or its version counter, which
``load_state_dict`` and optimizer steps bump): ``W_c`` and ``W_hh`` side by side in f32 in the order
the kernel's lanes read them (``pack_weights``; the kernel splits them into
TF32 halves as it loads them: stored split, twice the bytes, ran slower),
``W_q`` of every stream and direction stacked, and ``b_ih + b_hh``.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch import nn

from tvretrieval_tpu_torch.ops import _build

HIDDEN = 128            # units a direction the kernel takes (csrc/excl_lstm.cu::kH)
CTX = 2 * HIDDEN        # ctx1's width: the first LSTM's two directions
WARPS = HIDDEN // 8     # the kernel's warps: 8 units each


def excl_lstm_plain(encoders: Sequence[nn.Module], ctx1s: Sequence[torch.Tensor],
                    q_hidden: torch.Tensor, lengths: Sequence[torch.Tensor]
                    ) -> List[torch.Tensor]:
    """Plain version: for each stream, ``encoder(cat([ctx1, q_rep]), n)``'s
    outputs, (P, L, 2 * hidden) each."""
    out = []
    for enc, ctx1, n in zip(encoders, ctx1s, lengths):
        q_rep = q_hidden[:, None, :].expand(q_hidden.shape[0], ctx1.shape[1], q_hidden.shape[-1])
        out.append(enc(torch.cat([ctx1, q_rep], dim=-1), n)[0])
    return out


def pack_weights(w_c: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """[W_c | W_hh] (512, 384) of one direction in the order the kernel's
    lanes read it: (warp w, k-step s, lane, n-tile j, register b) holds
    W[j * 128 + 8 w + lane // 4, 8 s + lane % 4 + 4 b], the mma.sync
    m16n8k8 B fragment (b0 = B[t][g], b1 = B[t + 4][g], g = lane // 4, t =
    lane % 4) of warp w's n-tile j, whose 8 columns are gate j of units
    8w .. 8w + 7. Returns (WARPS, 48, 32, 8), contiguous."""
    w = torch.cat([w_c, w_hh], dim=1)                       # (512, 384)
    k_steps = w.shape[1] // 8
    return (w.reshape(4, WARPS, 8, k_steps, 2, 4)           # (j, w, g, s, b, t)
            .permute(1, 3, 2, 5, 0, 4)                      # (w, s, g, t, j, b)
            .reshape(WARPS, k_steps, 32, 8).contiguous())


def split_weights(encoder: nn.Module) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One bidirectional encoder's (packed [W_c | W_hh] (2, WARPS, 48, 32,
    8), W_q (2 * 512, 256), b_ih + b_hh (2 * 512)), forward then backward."""
    packed, w_q, bias = [], [], []
    for cell in (encoder.fwd_cell, encoder.bwd_cell):
        w_ih = cell.weight_ih_l0.detach().float()
        packed.append(pack_weights(w_ih[:, :CTX], cell.weight_hh_l0.detach().float()))
        w_q.append(w_ih[:, CTX:])
        bias.append((cell.bias_ih_l0 + cell.bias_hh_l0).detach().float())
    return torch.stack(packed), torch.cat(w_q), torch.cat(bias)


def _prepared(encoders: Sequence[nn.Module]):
    """The kernel's weights of ``encoders`` (streams in order), kept until
    a parameter changes (``_build.prepared``)."""
    def build():
        parts = [split_weights(enc) for enc in encoders]
        return tuple(torch.cat(p).contiguous() for p in zip(*parts))
    return _build.prepared("excl_lstm", encoders, build)


def _check(encoders, ctx1s, q_hidden, lengths) -> None:
    name = "excl_lstm"
    if not 1 <= len(encoders) == len(ctx1s) == len(lengths) <= 2:
        raise ValueError(f"{name}: one or two streams, each with an encoder, ctx1 and lengths")
    for enc in encoders:
        cells = (getattr(enc, "fwd_cell", None), getattr(enc, "bwd_cell", None))
        if not all(isinstance(c, nn.LSTM) for c in cells) or enc.dtype != torch.float32:
            raise TypeError(f"{name}: takes float32 bidirectional LSTM encoders")
        if any(p.device != q_hidden.device for p in enc.parameters()):
            raise ValueError(f"{name}: the encoders' weights are not on {q_hidden.device}")
        if enc.hidden_size != HIDDEN or cells[0].input_size != CTX + q_hidden.shape[-1]:
            raise ValueError(f"{name}: takes {HIDDEN} units a direction over [ctx1 ({CTX}); "
                             f"query ({CTX})], got {enc.hidden_size} over "
                             f"{cells[0].input_size}")
    if q_hidden.dtype != torch.float32 or q_hidden.dim() != 2 or q_hidden.shape[1] != CTX:
        raise ValueError(f"{name}: q_hidden must be (P, {CTX}) float32, got "
                         f"{tuple(q_hidden.shape)} {q_hidden.dtype}")
    P = q_hidden.shape[0]
    for ctx1, n in zip(ctx1s, lengths):
        if (ctx1.dtype != torch.float32 or ctx1.dim() != 3 or ctx1.shape[0] != P
                or ctx1.shape[2] != CTX or ctx1.shape[1] != ctx1s[0].shape[1]):
            raise ValueError(f"{name}: ctx1 must be (P={P}, L, {CTX}) float32 alike in every "
                             f"stream, got {tuple(ctx1.shape)} {ctx1.dtype}")
        if n.shape != (P,) or n.is_floating_point():
            raise ValueError(f"{name}: lengths must be ({P},) integers, got "
                             f"{tuple(n.shape)} {n.dtype}")
    for t in (q_hidden, *ctx1s, *lengths):
        if t.device != q_hidden.device:
            raise ValueError(f"{name}: tensors on {t.device} and {q_hidden.device}")


def excl_lstm(encoders: Sequence[nn.Module], ctx1s: Sequence[torch.Tensor],
              q_hidden: torch.Tensor, lengths: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each stream's ``encoder(cat([ctx1, q_rep]), lengths)`` outputs, (P,
    L, 256): ``encoders`` (one or two streams) with their ``ctx1s`` (P, L,
    256) and ``lengths`` (P,) integers, ``q_hidden`` (P, 256) the pairs'
    query vectors. CPU tensors run ``excl_lstm_plain``; CUDA tensors one
    launch of csrc/excl_lstm.cu, or a ValueError / TypeError for what it
    does not take."""
    if q_hidden.device.type == "cpu":
        return excl_lstm_plain(encoders, ctx1s, q_hidden, lengths)
    if q_hidden.device.type != "cuda":
        raise ValueError(f"excl_lstm: tensors on {q_hidden.device}; expected cpu or cuda")
    _check(encoders, ctx1s, q_hidden, lengths)
    P, L = ctx1s[0].shape[:2]
    dev = q_hidden.device
    outs = [torch.empty((P, L, CTX), dtype=torch.float32, device=dev) for _ in ctx1s]
    if P == 0 or L == 0:
        return [o.zero_() for o in outs]
    w, w_q, bias = _prepared(encoders)
    gq = torch.addmm(bias, q_hidden, w_q.T)             # (P, streams * 2 * 512)
    ctx1s = [c.contiguous() for c in ctx1s]
    lens = [n.to(torch.int32).contiguous() for n in lengths]
    second = lambda xs: xs[-1].data_ptr()
    _build.launch("excl_lstm", dev, ctx1s[0].data_ptr(), second(ctx1s), lens[0].data_ptr(),
                  second(lens), w.data_ptr(), gq.data_ptr(), gq.shape[1], outs[0].data_ptr(),
                  second(outs), P, L, len(ctx1s))
    return outs
