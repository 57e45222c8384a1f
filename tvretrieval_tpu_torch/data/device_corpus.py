"""Device-resident training / eval data: the GPU-resident corpus.

Port of tvretrieval_tpu/data/device_corpus.py. The corpus context features
live in device memory once, quantized to float8 with a fixed scale
(21.8K videos x 100 clips x 3074-d + 770-d subtitles = 8.4 GB), so that

  * each train step gathers its batch's context rows ON THE DEVICE by
    video slot (the byte-row gather kernel, ops/gather.py), recomputes the
    TEF dims exactly from clip counts, and masks from lengths;
  * only per-query data crosses PCIe per step: float8 query tokens and
    int32 slots / labels, about 2 MB for a batch of 128, where a built
    float32 batch would be 200 MB (128 x 100 x (3074 + 770) x 4 B);
  * per-epoch corpus re-encoding (engine.encode_corpus_resident) slices the
    same resident block and copies nothing from the host.

Quantization: features are l2-normalized per clip row (so |x| <= 1);
float8_e4m3fn stores x * 64 (well inside e4m3's normal range: values
around 1/sqrt(3072) = 0.018 would otherwise land in subnormals). TEF dims
are stored too but recomputed exactly in f32 at assembly, so their
quantization error never reaches the model. "float16" / "float32" storage
exist for differential tests (f32 is bit-exact against the host
ExampleBuilder path) and small worlds.

Host arrays are numpy; numpy has no float8, so float8 features are held
on the host as their uint8 bytes and viewed as ``torch.float8_e4m3fn`` on
the device.
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from tvretrieval_tpu_torch.data.datasets import (
    CorpusIndex,
    ExampleBuilder,
    eval_st_ed_label,
    resolve_ts,
    train_st_ed_label,
)
from tvretrieval_tpu_torch.ops.gather import gather_byte_rows

logger = logging.getLogger(__name__)

#: storage name -> (torch dtype on the device, numpy dtype of the host
#: array, fixed quantization scale)
_STORAGE = {
    "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8, 64.0),
    "int8": (torch.int8, np.int8, 100.0),
    "float16": (torch.float16, np.float16, 1.0),
    "float32": (torch.float32, np.float32, 1.0),
}
#: largest magnitude that rounds to e4m3fn's largest finite value, 448;
#: anything above becomes NaN, as ml_dtypes converts it
_F8_ROUNDS_TO_MAX = 464.0


def storage_dtype(name: str) -> Tuple[torch.dtype, float]:
    """(torch dtype, scale) for a storage-dtype name."""
    if name not in _STORAGE:
        raise ValueError(f"unknown storage dtype {name!r}")
    return _STORAGE[name][0], _STORAGE[name][2]


def host_dtype(name: str) -> np.dtype:
    """numpy dtype of a host array in this storage (uint8 bytes for float8)."""
    storage_dtype(name)
    return np.dtype(_STORAGE[name][1])


def quantize(x: np.ndarray, dtype_name: str) -> np.ndarray:
    """f32 features -> host array in storage dtype: x * scale, rounded to
    nearest even (int8 also clipped to [-127, 127]). float8 comes back as
    its uint8 bytes, equal to ml_dtypes' ``astype(float8_e4m3fn)``."""
    _, scale = storage_dtype(dtype_name)
    hdt = host_dtype(dtype_name)
    if scale == 1.0:
        return x.astype(hdt)
    y = x.astype(np.float32) * np.float32(scale)
    if dtype_name == "int8":
        return np.clip(np.rint(y), -127, 127).astype(hdt)
    t = torch.from_numpy(np.ascontiguousarray(y))
    q = t.to(torch.float8_e4m3fn).view(torch.uint8)
    # e4m3fn has no infinity: whatever rounds past 448 is NaN, sign kept
    # (some torch builds saturate instead)
    over = ~(t.abs() <= _F8_ROUNDS_TO_MAX)
    if bool(over.any()):
        sign = (torch.signbit(t).to(torch.uint8) << 7)
        q = torch.where(over, sign | 0x7F, q)
    return q.numpy()


def dequantize(x: torch.Tensor, dtype_name: str) -> torch.Tensor:
    """Storage-dtype tensor -> f32: one multiply by 1 / scale."""
    _, scale = storage_dtype(dtype_name)
    y = x.float()
    return y if scale == 1.0 else y * (1.0 / scale)


# --------------------------------------------------------------------------
# byte-flat device tables
#
# Device tables are stored as raw BYTES, (N, 8, W) int8 with W % 128 == 0,
# so a row is a multiple of 1,024 bytes: one layout serves every storage
# dtype, the gather kernel moves aligned 16-byte vectors whatever the
# feature width is, and rows bitcast back to the storage dtype after the
# copy. Random-row batches gather through the kernel; contiguous encode
# chunks are plain slices (views).
# --------------------------------------------------------------------------

def to_byte_table(arr: np.ndarray) -> np.ndarray:
    """(N, L, D) any fixed-width dtype -> (N, 8, W) int8, W % 128 == 0."""
    n = arr.shape[0]
    flat = np.ascontiguousarray(arr).reshape(n, -1).view(np.int8)
    nbytes = flat.shape[1]
    w = -(-nbytes // 1024) * 1024          # pad to 8 * 128-multiple
    if w != nbytes:
        flat = np.pad(flat, ((0, 0), (0, w - nbytes)))
    return flat.reshape(n, 8, w // 8)


def from_byte_rows(rows: torch.Tensor, L: int, D: int, dtype_name: str) -> torch.Tensor:
    """(B, 8, W) int8 -> (B, L, D) storage dtype (a bitcast; the row pad
    is sliced off first, which copies only when there is one)."""
    dt, _ = storage_dtype(dtype_name)
    B = rows.shape[0]
    n = L * D * dt.itemsize
    flat = rows.reshape(B, -1)[:, :n]
    if not flat.is_contiguous():
        flat = flat.contiguous()
    return flat.view(dt).reshape(B, L, D)


@dataclass
class ContextTable:
    """Host-built, corpus-ordered context feature block.

    v_feats / s_feats are ExampleBuilder's padded per-video context features
    (normalized, TEF dims appended when active) in storage dtype; slot i is
    corpus video i (``corpus.vid_names[i]``).
    """

    v_feats: np.ndarray     # (Nv, L, Dv) host storage dtype
    s_feats: np.ndarray     # (Nv, L, Ds)
    ctx_l: np.ndarray       # (Nv,) int32
    dtype_name: str
    use_video: bool
    use_sub: bool
    use_tef: bool

    @classmethod
    def build(cls, builder: ExampleBuilder, corpus: CorpusIndex,
              dtype_name: str = "float8_e4m3fn", chunk: int = 512) -> "ContextTable":
        """Chunks of videos go through the batched
        ExampleBuilder.build_contexts (bit-identical to the per-row path)
        and quantize as whole blocks; ``chunk`` bounds the transient f32
        chunk in host RAM."""
        nv = len(corpus)
        v0, s0, _, _ = builder.context(corpus.vid_names[0], corpus.durations[0])
        dt = host_dtype(dtype_name)
        v_feats = np.empty((nv,) + v0.shape, dt)
        s_feats = np.empty((nv,) + s0.shape, dt)
        ctx_l = np.empty((nv,), np.int32)
        for i in range(0, nv, chunk):
            v, s, _, cl = builder.build_contexts(
                corpus.vid_names[i:i + chunk], corpus.durations[i:i + chunk])
            v_feats[i:i + chunk] = quantize(v, dtype_name)
            s_feats[i:i + chunk] = quantize(s, dtype_name)
            ctx_l[i:i + chunk] = cl
            if i and i % 5120 < chunk:
                logger.info("context table: %d/%d videos", i, nv)
        return cls(v_feats=v_feats, s_feats=s_feats, ctx_l=ctx_l,
                   dtype_name=dtype_name, use_video=builder.use_video,
                   use_sub=builder.use_sub, use_tef=builder.use_tef)

    def device_arrays(self, device="cuda") -> Dict[str, torch.Tensor]:
        """The table on ``device`` as byte-flat (N, 8, W) int8 blocks (see
        the byte-table note above) and the int32 clip counts."""
        put = lambda a: torch.from_numpy(a).to(device)
        return {"v_bytes": put(to_byte_table(self.v_feats)),
                "s_bytes": put(to_byte_table(self.s_feats)),
                "ctx_l": put(self.ctx_l)}

    @property
    def shapes(self) -> dict:
        """Static per-stream (L, D) needed to debyte gathered rows."""
        return dict(v_shape=self.v_feats.shape[1:], s_shape=self.s_feats.shape[1:])

    def nbytes(self) -> int:
        return self.v_feats.nbytes + self.s_feats.nbytes


@dataclass
class QueryTable:
    """Host-side per-rowset query features + labels, slots into the corpus.

    Queries are trimmed to the longest real token count (q_feats.shape[1]
    <= builder.max_desc_l); device assembly zero-pads back to max_desc_l.
    """

    q_feats: np.ndarray     # (Nq, Lq_eff, Dq) host storage dtype
    q_len: np.ndarray       # (Nq,) int32
    slot: np.ndarray        # (Nq,) int32, corpus video index
    st_ed: np.ndarray       # (Nq, 2) int32
    dtype_name: str
    max_desc_l: int

    @classmethod
    def build(cls, builder: ExampleBuilder, rows: List[dict], corpus: CorpusIndex,
              ctx_l: np.ndarray, dtype_name: str = "float8_e4m3fn",
              eval_labels: bool = False, chunk: int = 4096) -> "QueryTable":
        """Chunks of rows go through the batched
        ExampleBuilder.build_queries and quantize as blocks."""
        nq = len(rows)
        vid2slot = {v: i for i, v in enumerate(corpus.vid_names)}
        dt = host_dtype(dtype_name)
        q_full = np.empty((nq, builder.max_desc_l, builder.query_source.dim), dt)
        q_len = np.empty((nq,), np.int32)
        slot = np.empty((nq,), np.int32)
        st_ed = np.empty((nq, 2), np.int32)
        label_fn = eval_st_ed_label if eval_labels else train_st_ed_label
        for i in range(0, nq, chunk):
            qf, qm = builder.build_queries([r["desc_id"] for r in rows[i:i + chunk]])
            q_full[i:i + chunk] = quantize(qf, dtype_name)
            q_len[i:i + chunk] = qm.sum(axis=1).astype(np.int32)
            if i and i % 20480 < chunk:
                logger.info("query table: %d/%d rows", i, nq)
        for i, row in enumerate(rows):
            s = vid2slot[row["vid_name"]]
            slot[i] = s
            ts = resolve_ts(row, builder.dset_name)
            st_ed[i] = label_fn(ts, builder.clip_length, max_idx=int(ctx_l[s]) - 1)
        l_eff = max(int(q_len.max()), 1) if nq else 1
        return cls(q_feats=np.ascontiguousarray(q_full[:, :l_eff]), q_len=q_len,
                   slot=slot, st_ed=st_ed, dtype_name=dtype_name,
                   max_desc_l=builder.max_desc_l)

    def chunk(self, idx: np.ndarray):
        """Host gather of the streaming arrays for a step / chunk of rows."""
        return (self.q_feats[idx], self.q_len[idx], self.slot[idx], self.st_ed[idx])


# --------------------------------------------------------------------------
# device-side assembly
# --------------------------------------------------------------------------

def _finish_context(v, s, n, *, use_video: bool, use_sub: bool, use_tef: bool):
    """Shared tail of context assembly: mask from clip counts + exact TEF
    recompute (datasets.tef_features) overwriting the quantized TEF dims."""
    L = v.shape[1]
    pos = torch.arange(L, dtype=torch.float32, device=v.device)
    mask = (pos[None, :] < n[:, None].float()).float()
    if use_tef:
        nf = torch.clamp_min(n, 1).float()[:, None]
        st = pos[None, :] / nf
        tef = torch.stack([st, st + 1.0 / nf], dim=-1) * mask[..., None]
        if use_video:
            v = torch.cat([v[..., :-2], tef], dim=-1)
        if use_sub:
            s = torch.cat([s[..., :-2], tef], dim=-1)
        if not use_video and not use_sub:
            v = tef
    return v, mask, s, mask


def assemble_context(ctx: Dict[str, torch.Tensor], slots: torch.Tensor, *,
                     dtype_name: str, use_video: bool, use_sub: bool, use_tef: bool,
                     v_shape, s_shape):
    """Gather + dequantize context rows for ``slots`` (B,), recomputing TEF
    exactly and the mask from clip counts. Returns (video_feat, video_mask,
    sub_feat, sub_mask) matching ExampleBuilder.context + _pad_to output
    bit for bit under float32 storage. The rows are gathered by
    ``ops.gather.gather_byte_rows``: the CUDA kernel for tables on a card,
    its plain version on the CPU."""
    v = dequantize(from_byte_rows(
        gather_byte_rows(ctx["v_bytes"], slots), *v_shape, dtype_name), dtype_name)
    s = dequantize(from_byte_rows(
        gather_byte_rows(ctx["s_bytes"], slots), *s_shape, dtype_name), dtype_name)
    n = ctx["ctx_l"][slots.long()]
    return _finish_context(v, s, n, use_video=use_video, use_sub=use_sub, use_tef=use_tef)


def assemble_context_slice(ctx: Dict[str, torch.Tensor], start: int, size: int, *,
                           dtype_name: str, use_video: bool, use_sub: bool,
                           use_tef: bool, v_shape, s_shape):
    """Contiguous-chunk variant for corpus encoding: a slice of the byte
    tables (a view, no gather)."""
    sl = lambda t: t[start:start + size]
    v = dequantize(from_byte_rows(sl(ctx["v_bytes"]), *v_shape, dtype_name), dtype_name)
    s = dequantize(from_byte_rows(sl(ctx["s_bytes"]), *s_shape, dtype_name), dtype_name)
    return _finish_context(v, s, sl(ctx["ctx_l"]), use_video=use_video,
                           use_sub=use_sub, use_tef=use_tef)


def assemble_queries(q_feat: torch.Tensor, q_len: torch.Tensor, *, dtype_name: str,
                     max_desc_l: int):
    """Dequantize + zero-pad queries back to (B, max_desc_l, Dq) + mask.
    ``q_feat`` holds host-storage values (uint8 bytes for float8)."""
    dt, _ = storage_dtype(dtype_name)
    q = dequantize(q_feat.view(dt), dtype_name)              # (B, Lq_eff, Dq)
    l_eff = q.shape[1]
    if l_eff < max_desc_l:
        q = torch.nn.functional.pad(q, (0, 0, 0, max_desc_l - l_eff))
    pos = torch.arange(max_desc_l, dtype=torch.float32, device=q.device)
    q_mask = (pos[None, :] < q_len[:, None].float()).float()
    return q, q_mask


def assemble_batch(ctx: Dict[str, torch.Tensor], q_feat, q_len, slots, st_ed, *,
                   dtype_name: str, use_video: bool, use_sub: bool, use_tef: bool,
                   max_desc_l: int, v_shape, s_shape) -> Dict[str, torch.Tensor]:
    """Full on-device train / eval-loss batch (ExampleBuilder.build_train_batch
    equivalent; exactness-tested under float32 storage)."""
    v, mask, s, _ = assemble_context(
        ctx, slots, dtype_name=dtype_name, use_video=use_video, use_sub=use_sub,
        use_tef=use_tef, v_shape=v_shape, s_shape=s_shape)
    q, q_mask = assemble_queries(q_feat, q_len, dtype_name=dtype_name,
                                 max_desc_l=max_desc_l)
    return dict(query_feat=q, query_mask=q_mask, video_feat=v, video_mask=mask,
                sub_feat=s, sub_mask=mask, st_ed_indices=st_ed)


@dataclass
class DeviceData:
    """Bundle threaded through the trainer and train_xml for device-resident runs."""

    ctx_table: ContextTable
    ctx_device: Dict[str, torch.Tensor]
    train_queries: Optional[QueryTable] = None
    eval_queries: Optional[QueryTable] = None       # train-style labels (loss)
    retrieval_queries: Optional[QueryTable] = None  # same features; labels unused

    @property
    def device(self) -> torch.device:
        return self.ctx_device["v_bytes"].device

    @property
    def assemble_kwargs(self) -> dict:
        t = self.ctx_table
        return dict(dtype_name=t.dtype_name, use_video=t.use_video, use_sub=t.use_sub,
                    use_tef=t.use_tef, **t.shapes)


def build_device_data(builder: ExampleBuilder, corpus: CorpusIndex,
                      train_rows: List[dict], eval_rows: List[dict],
                      dtype_name: str = "float8_e4m3fn", device="cuda") -> DeviceData:
    """Build all host tables and put the context block on ``device``."""
    t0 = time.time()
    ctx = ContextTable.build(builder, corpus, dtype_name)
    logger.info("context table built: %.1f GB in %.0fs", ctx.nbytes() / 1e9,
                time.time() - t0)
    t0 = time.time()
    tq = QueryTable.build(builder, train_rows, corpus, ctx.ctx_l, dtype_name) \
        if train_rows else None
    eq = QueryTable.build(builder, eval_rows, corpus, ctx.ctx_l, dtype_name) \
        if eval_rows else None
    logger.info("query tables built in %.0fs", time.time() - t0)
    t0 = time.time()
    dev = ctx.device_arrays(device)
    if dev["v_bytes"].device.type == "cuda":
        torch.cuda.synchronize(dev["v_bytes"].device)
    logger.info("context block resident on %s (%.1f GB, %.0fs)", dev["v_bytes"].device,
                ctx.nbytes() / 1e9, time.time() - t0)
    return DeviceData(ctx_table=ctx, ctx_device=dev, train_queries=tq, eval_queries=eq,
                      retrieval_queries=eq)
