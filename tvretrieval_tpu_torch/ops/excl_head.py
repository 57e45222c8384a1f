"""ExCL's start / end span heads over [ctx2; ctx1; query], split by linearity.

``excl_heads`` runs each stream's ``st_predictor`` and ``ed_predictor`` of
``models/excl.py`` (``Dense_0`` 768 -> 256, tanh, ``Dense_1`` 256 -> 1) over
``[ctx2; ctx1; q_rep]``, where ``q_rep`` repeats the pair's query vector on
every clip, masks each stream's logits with ``mask_logits`` and averages the
streams, as ``ExCL.fused_span_logits`` needs it in eval mode at f32. Since
``W0 . [ctx2; ctx1; q] + b0 = W0_c . [ctx2; ctx1] + (W0_q . q + b0)``, the
query's part and the bias are one f32 product a pair (``u``, one
``torch.addmm`` for every stream and head), and the rows take K = 512:
csrc/excl_head.cu, one launch for both streams and both heads, the tanh,
``Dense_1``, the mask and the streams' mean in its epilogue (no
concatenation, no hidden activations in device memory). That kernel
replaces no TPU kernel (the JAX package's heads are ``nn.Dense`` under
XLA); its source note says why it was added.

``excl_heads_plain`` is the plain version: the concatenation, each
stream's two ``SpanPredictor`` modules, ``mask_logits`` and the mean. The
wrapper given CPU tensors runs it; given CUDA tensors it launches the
kernel or raises: it takes f32 predictors of ``Dense_0`` 768 -> 256 and ``Dense_1``
256 -> 1 over contiguous ctx2 and ctx1 rows of 256 and query rows of 256,
the published ExCL widths (``ops._build.launch`` counts the launch). The
masks are prefix masks (a video's valid clips first, as the cache holds
them): the kernel reads each row's length, ``mask.sum(1)``.

The kernel's weights are prepared once per model and kept until a parameter
changes (``_build.prepared``): ``W0_c`` of st and ed of every stream
stacked, (streams * 512, 512), its columns permuted within each chunk of 32
(``CHUNK_PERM``: the kernel loads each thread's A fragments of a chunk as 8
contiguous floats of a row); ``W0_q`` stacked the same way and ``b0``;
``Dense_1``'s weights and biases.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from tvretrieval_tpu_torch.ops import _build
from tvretrieval_tpu_torch.ops.masking import mask_logits

HIDDEN = 256            # ctx1, ctx2 and query widths, a head's units (csrc/excl_head.cu::kHidden)
K = 2 * HIDDEN          # the rows' part of Dense_0's input: [ctx2 | ctx1]
CHUNK = 32              # f32 columns of a K chunk (128 bytes)


def _chunk_perm() -> torch.Tensor:
    """Column l = 8 kk + t + 4 e of a chunk (k-step kk, lane t % 4, A
    register pair e) is read from column 8 t + 2 kk + e of a row."""
    l = torch.arange(CHUNK)
    kk, t, e = l // 8, l % 4, (l % 8) // 4
    return 8 * t + 2 * kk + e


CHUNK_PERM = _chunk_perm()


def excl_heads_plain(heads: Sequence[Tuple[nn.Module, nn.Module]], ctx2s: Sequence[torch.Tensor],
                     ctx1s: Sequence[torch.Tensor], q_hidden: torch.Tensor,
                     masks: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: for each stream's (st, ed) predictors, ctx2, ctx1 and
    mask, the heads over ``cat([ctx2, ctx1, q_rep])`` masked by
    ``mask_logits``; the streams' mean of each, (P, L)."""
    st = ed = 0
    for (st_pred, ed_pred), ctx2, ctx1, mask in zip(heads, ctx2s, ctx1s, masks):
        q_rep = q_hidden[:, None, :].expand(q_hidden.shape[0], ctx1.shape[1], q_hidden.shape[-1])
        feat3 = torch.cat([ctx2, ctx1, q_rep], dim=-1)
        st = st + mask_logits(st_pred(feat3), mask)
        ed = ed + mask_logits(ed_pred(feat3), mask)
    return st / len(heads), ed / len(heads)


def split_weights(heads: Sequence[Tuple[nn.Module, nn.Module]]):
    """The kernel's weights of ``heads`` (streams in order, st then ed):
    (W0_c (streams * 512, 512) with columns permuted by CHUNK_PERM, W0_q
    (streams * 512, 256), b0 (streams * 512), w1 (streams * 2, 256), b1
    (streams * 2)), f32."""
    preds = [p for pair in heads for p in pair]
    w0 = torch.cat([p.Dense_0.weight.detach().float() for p in preds])       # (.., 768)
    w_c = w0[:, :K].reshape(len(preds) * HIDDEN, K // CHUNK, CHUNK)[:, :, CHUNK_PERM]
    return (w_c.reshape(-1, K).contiguous(), w0[:, K:].contiguous(),
            torch.cat([p.Dense_0.bias.detach().float() for p in preds]),
            torch.cat([p.Dense_1.weight.detach().float() for p in preds]),
            torch.cat([p.Dense_1.bias.detach().float() for p in preds]))


def _prepared(heads):
    """``split_weights(heads)``, kept until a parameter changes
    (``_build.prepared``)."""
    return _build.prepared("excl_head", [p for pair in heads for p in pair],
                           lambda: split_weights(heads))


def _check(heads, ctx2s, ctx1s, q_hidden, masks) -> None:
    name = "excl_heads"
    if not 1 <= len(heads) == len(ctx2s) == len(ctx1s) == len(masks) <= 2:
        raise ValueError(f"{name}: one or two streams, each with its heads, ctx2, ctx1 and mask")
    dev = q_hidden.device
    for pair in heads:
        for pred in pair:
            d0, d1 = getattr(pred, "Dense_0", None), getattr(pred, "Dense_1", None)
            if not (isinstance(d0, nn.Linear) and isinstance(d1, nn.Linear)):
                raise TypeError(f"{name}: takes SpanPredictors (Dense_0, tanh, Dense_1)")
            if any(getattr(d, "dtype", torch.float32) != torch.float32 for d in (d0, d1)):
                raise TypeError(f"{name}: takes float32 predictors")
            if (d0.in_features, d0.out_features, d1.in_features, d1.out_features) != (
                    K + HIDDEN, HIDDEN, HIDDEN, 1):
                raise ValueError(f"{name}: takes Dense_0 {K + HIDDEN} -> {HIDDEN} and Dense_1 "
                                 f"{HIDDEN} -> 1, got {d0.in_features} -> {d0.out_features} and "
                                 f"{d1.in_features} -> {d1.out_features}")
            if any(p.device != dev or p.dtype != torch.float32 for p in pred.parameters()):
                raise ValueError(f"{name}: the predictors' weights are not float32 on {dev}")
    if q_hidden.dtype != torch.float32 or q_hidden.dim() != 2 or q_hidden.shape[1] != HIDDEN:
        raise ValueError(f"{name}: q_hidden must be (P, {HIDDEN}) float32, got "
                         f"{tuple(q_hidden.shape)} {q_hidden.dtype}")
    P, L = ctx1s[0].shape[:2]
    if P != q_hidden.shape[0]:
        raise ValueError(f"{name}: {q_hidden.shape[0]} query rows for {P} pairs")
    for c in (*ctx2s, *ctx1s):
        if c.dtype != torch.float32 or c.shape != (P, L, HIDDEN) or not c.is_contiguous():
            raise ValueError(f"{name}: ctx2 and ctx1 must be contiguous (P={P}, L={L}, "
                             f"{HIDDEN}) float32, got {tuple(c.shape)} {c.dtype}")
    for m in masks:
        if m.shape != (P, L):
            raise ValueError(f"{name}: masks must be ({P}, {L}), got {tuple(m.shape)}")
    for t in (*ctx2s, *ctx1s, *masks):
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")


def excl_heads(heads: Sequence[Tuple[nn.Module, nn.Module]], ctx2s: Sequence[torch.Tensor],
               ctx1s: Sequence[torch.Tensor], q_hidden: torch.Tensor,
               masks: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(st_logits, ed_logits), each (P, L) f32: the streams' mean of each
    head over ``[ctx2; ctx1; q_rep]`` under ``mask_logits``. ``heads``: one
    or two streams' (st_predictor, ed_predictor); ``ctx2s``, ``ctx1s``: (P,
    L, 256) each; ``q_hidden``: (P, 256) the pairs' query vectors;
    ``masks``: (P, L) prefix masks. CPU tensors run ``excl_heads_plain``;
    CUDA tensors one launch of csrc/excl_head.cu, or a ValueError /
    TypeError for what it does not take."""
    if q_hidden.device.type == "cpu":
        return excl_heads_plain(heads, ctx2s, ctx1s, q_hidden, masks)
    if q_hidden.device.type != "cuda":
        raise ValueError(f"excl_heads: tensors on {q_hidden.device}; expected cpu or cuda")
    _check(heads, ctx2s, ctx1s, q_hidden, masks)
    P, L = ctx1s[0].shape[:2]
    dev = q_hidden.device
    st, ed = (torch.empty((P, L), dtype=torch.float32, device=dev) for _ in range(2))
    if P == 0 or L == 0:
        return st, ed
    w_c, w_q, b0, w1, b1 = _prepared(heads)
    u = torch.addmm(b0, q_hidden, w_q.T)                # (P, streams * 512)
    lens = [m.sum(dim=1).to(torch.int32) for m in masks]
    last = lambda xs: xs[-1].data_ptr()
    _build.launch("excl_head", dev, ctx2s[0].data_ptr(), ctx1s[0].data_ptr(), lens[0].data_ptr(),
                  last(ctx2s), last(ctx1s), last(lens), w_c.data_ptr(), u.data_ptr(),
                  u.shape[1], w1.data_ptr(), b1.data_ptr(), st.data_ptr(), ed.data_ptr(), P, L,
                  len(heads))
    return st, ed
