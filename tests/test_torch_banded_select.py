"""The selection algorithm of the banded top-N kernel B8
(tvretrieval_tpu_torch/csrc/banded_topk.cu) as a small numpy model, step
for step as the kernel runs it, held exactly on the CPU to the kernel's
plain version (``ops.span.banded_topk_spans``) and to the JAX package's XLA
reference (``tvretrieval_tpu/ops/span.py::banded_topk_spans``).

The model: one u32 order key a (video, start) row, its best joint value
taken at the band's largest and smallest end probability (0.0 standing for
out-of-band ends); per chunk of rows a floor, the top_n-th largest of the
256 threads' row maxima (thread t holds the runs of four rows that start
at 4t, 4t + 1,024, ...); an MSD radix select of the top_n-th row key over
the carried rows and the chunk, keys below the floor left out, with the
early stop of csrc/select.cuh; exactly
top_n rows, ties at the cut in row order, put back into row order; then
the selected rows' W elements each, keys below the least selected row key
left out, the same select, and the survivors sorted as (key, ~position).

``jax.lax.top_k`` orders +0.0 before -0.0 whatever their indices, where the
plain version and B8 let them tie and fall to the index: where zeros of
both signs are selected, the model is held to the plain version in all
four outputs and to the JAX reference in values.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tvretrieval_tpu.ops import span as jspan
from tvretrieval_tpu_torch.ops.span import banded_topk_spans

THREADS = 256          # csrc/select.cuh::kThreads
RUN = 4                # csrc/banded_topk.cu::kRun: consecutive rows a thread
MAX_CHUNK = 16384      # csrc/banded_topk.cu::kMaxChunk


def order_keys(x):
    u = np.asarray(x, np.float32).view(np.uint32).copy()
    u[u == 0x80000000] = 0
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def band_values(st, ed, vs, min_l, W):
    """(V, L, W) joint of one query, 0.0 at out-of-band ends: the kernel's
    two f32 products."""
    V, L = st.shape
    ends = np.arange(L)[:, None] + min_l + np.arange(W)[None]
    inband = ends < L
    e = ed[:, np.minimum(ends, L - 1)]
    val = (st[:, :, None] * e) * vs[:, None, None]
    return np.where(inband[None], val, np.float32(0)).astype(np.float32)


def row_best_keys(st, ed, vs, min_l, W):
    """Each row's best key from the extremes of its band's end values."""
    V, L = st.shape
    ends = np.arange(L)[:, None] + min_l + np.arange(W)[None]
    inband = ends < L
    e = ed[:, np.minimum(ends, L - 1)]
    zero = np.float32(0)
    hi = np.where(inband[None], e, -np.inf).max(-1)
    lo = np.where(inband[None], e, np.inf).min(-1)
    hi = np.where(inband.all(-1)[None], hi, np.maximum(hi, zero))
    lo = np.where(inband.all(-1)[None], lo, np.minimum(lo, zero))
    f = lambda x: (st * x.astype(np.float32)) * vs[:, None]
    return np.maximum(order_keys(f(hi)), order_keys(f(lo))).reshape(-1)


def radix_select(keys, k, floor):
    """(prefix, mask, need, passes) of the k-th largest key at or above the
    floor, as select.cuh::radix_select."""
    prefix = mask = 0
    need = k
    counted = keys >= np.uint32(floor)
    for passes, shift in enumerate((24, 16, 8, 0), start=1):
        match = ((keys & np.uint32(mask)) == prefix) & counted
        hist = np.bincount((keys[match] >> np.uint32(shift)) & 255, minlength=256)
        at_least = np.cumsum(hist[::-1])[::-1]
        above = at_least - hist
        b = int(np.flatnonzero((above < need) & (need <= at_least))[0])
        prefix |= b << shift
        mask |= 255 << shift
        need -= int(above[b])
        if hist[b] == need:
            break
    return prefix, mask, need, passes


def compact(keys, k, floor, prefix, mask, need):
    """Survivor positions in slot order: those above the prefix, then the
    first ``need`` equal to it at or above the floor, each in position order."""
    m = keys & np.uint32(mask)
    gt = np.flatnonzero(m > prefix)
    eq = np.flatnonzero((m == prefix) & (keys >= np.uint32(floor)))[:need]
    assert len(gt) == k - need and len(eq) == need
    return np.concatenate([gt, eq])


def thread_floor(chunk_keys, top_n):
    """The top_n-th largest of the threads' maxima; 0 for a short chunk."""
    if len(chunk_keys) < top_n:
        return 0
    t_max = np.zeros(THREADS, np.uint32)
    np.maximum.at(t_max, np.arange(len(chunk_keys)) // RUN % THREADS, chunk_keys)
    return int(np.sort(t_max)[::-1][top_n - 1])


def select_rows(row_keys, top_n, chunk):
    """The top_n rows under (key descending, row ascending), in row order,
    chunk by chunk; and the rows each chunk's floor let into its select."""
    rows = np.zeros(0, np.int64)
    keys = np.zeros(0, np.uint32)
    past_floor = 0
    for c0 in range(0, len(row_keys), chunk):
        ck = row_keys[c0:c0 + chunk]
        keys = np.concatenate([keys, ck])
        rows = np.concatenate([rows, np.arange(c0, c0 + len(ck))])
        if len(keys) <= top_n:
            continue
        floor = thread_floor(ck, top_n)
        past_floor += int((keys >= np.uint32(floor)).sum())
        prefix, mask, need, _ = radix_select(keys, top_n, floor)
        pos = np.sort(compact(keys, top_n, floor, prefix, mask, need))
        rows, keys = rows[pos], keys[pos]
    return rows, keys, past_floor


def model_banded(st, ed, vs, min_l, max_l, top_n, chunk=MAX_CHUNK):
    """B8 on (Nq, V, L) inputs: (vid, st, ed, scores) and per query
    (videos holding a selected row, rows past the floors, survivors)."""
    nq, V, L = st.shape
    W = max_l - min_l
    outs = [np.zeros((nq, top_n), np.int32) for _ in range(3)] + [
        np.zeros((nq, top_n), np.float32)]
    outs[2][:] = min_l
    stats = []
    for q in range(nq):
        vals = band_values(st[q], ed[q], vs[q], min_l, W).reshape(V * L, W)
        rows, rkeys, past = select_rows(row_best_keys(st[q], ed[q], vs[q], min_l, W),
                                        top_n, chunk)
        floor = int(rkeys.min()) if len(rows) == top_n else 0
        el_vals = vals[rows].reshape(-1)                    # position j * W + w
        el_keys = order_keys(el_vals)
        k = min(top_n, len(el_keys))
        if len(el_keys) > k:
            prefix, mask, need, _ = radix_select(el_keys, k, floor)
            surv = compact(el_keys, k, floor, prefix, mask, need)
        else:
            surv = np.arange(len(el_keys))
        surv = surv[np.lexsort((surv, ~el_keys[surv]))]     # key descending, position ascending
        row, w = rows[surv // W], surv % W
        outs[0][q, :k] = row // L
        outs[1][q, :k] = row % L
        outs[2][q, :k] = row % L + min_l + w
        outs[3][q, :k] = el_vals[surv]
        stats.append((len(np.unique(rows // L)), past,
                      int((el_keys >= np.uint32(floor)).sum())))
    return outs, stats


def _case(kind, nq, V, L, seed):
    rng = np.random.default_rng(seed)
    st, ed = (rng.random((nq, V, L), dtype=np.float32) for _ in range(2))
    vs = np.exp(4.0 * rng.random((nq, V))).astype(np.float32)
    if kind == "negative":
        st = st - 0.5
        vs = vs * np.where(rng.random((nq, V)) < 0.3, -1, 1).astype(np.float32)
    elif kind == "signed_zeros":
        # few positive values: the selection reaches zeros of both signs
        st = np.round(st * 2) / 2 - 0.5                     # -0.5, 0.0, 0.5
        ed = np.where(rng.random((nq, V, L)) < 0.9, -0.0, ed).astype(np.float32)
        vs = vs * np.where(rng.random((nq, V)) < 0.5, -1, 1).astype(np.float32)
    elif kind == "all_equal":
        st = np.zeros_like(st)                              # every joint element 0.0
    elif kind == "masked_tail":
        st[..., L - L // 3:] = 0.0
        ed[..., L - L // 3:] = 0.0
        st, ed = np.round(st * 3) / 3, np.round(ed * 3) / 3
    elif kind == "peaked":
        st, ed = (np.exp(20 * x) / np.exp(20 * x).sum(-1, keepdims=True) for x in (st, ed))
    return st.astype(np.float32), ed.astype(np.float32), vs.astype(np.float32)


CASES = [
    # kind, nq, V, L, min_l, max_l, top_n, chunk
    ("uniform", 2, 9, 40, 2, 16, 200, MAX_CHUNK),
    ("peaked", 2, 12, 30, 1, 9, 64, MAX_CHUNK),
    ("negative", 2, 6, 20, 1, 7, 50, MAX_CHUNK),
    ("signed_zeros", 2, 6, 20, 1, 7, 120, MAX_CHUNK),
    ("all_equal", 1, 5, 30, 2, 16, 200, MAX_CHUNK),
    ("masked_tail", 2, 7, 24, 2, 10, 100, MAX_CHUNK),
    ("uniform", 1, 3, 10, 2, 6, 40, MAX_CHUNK),            # V * L < top_n
    ("uniform", 1, 2, 4, 1, 3, 10, MAX_CHUNK),             # V * L * W < top_n
    ("uniform", 2, 30, 1, 0, 1, 1, MAX_CHUNK),             # L = 1, W = 1, top_n = 1
    ("uniform", 1, 40, 9, 0, 1, 256, MAX_CHUNK),           # W = 1, top_n = 256
    ("uniform", 1, 11, 128, 2, 18, 256, MAX_CHUNK),        # L = 128, W = 16, top_n = 256
    ("peaked", 2, 10, 50, 2, 16, 100, 96),                 # chunks of 96 rows carried
    ("all_equal", 1, 6, 40, 2, 16, 50, 64),
]


@pytest.mark.parametrize("kind,nq,V,L,min_l,max_l,top_n,chunk", CASES)
def test_model_equals_the_plain_version_and_the_jax_reference(kind, nq, V, L, min_l, max_l,
                                                              top_n, chunk):
    st, ed, vs = _case(kind, nq, V, L, seed=V * 31 + L + top_n)
    got, _ = model_banded(st, ed, vs, min_l, max_l, top_n, chunk)
    plain = banded_topk_spans(*map(torch.from_numpy, (st, ed, vs)), min_l, max_l, top_n)
    ref = jspan.banded_topk_spans(*map(jnp.asarray, (st, ed, vs)), min_l, max_l, top_n)
    for name, g, p, r in zip(("vid", "st", "ed", "scores"), got, plain, ref):
        np.testing.assert_array_equal(g, p.numpy(), err_msg=name)
        if name == "scores" or kind != "signed_zeros":
            np.testing.assert_array_equal(g, np.asarray(r), err_msg=name)
    if kind == "all_equal":                 # the answer is the top_n lowest flat indices
        W = max_l - min_l
        flat = (got[0] * L + got[1]) * W + got[2] - got[1] - min_l
        assert flat.tolist() == [list(range(top_n))] * nq


@pytest.mark.parametrize("kind", ["uniform", "negative", "signed_zeros", "masked_tail"])
def test_row_best_from_the_band_extremes_is_exact(kind):
    """The key from the band's largest and smallest end value equals the
    row's largest element key, whatever the signs."""
    st, ed, vs = _case(kind, 3, 8, 40, seed=7)
    for q in range(3):
        keys = order_keys(band_values(st[q], ed[q], vs[q], 3, 12)).reshape(-1, 12)
        np.testing.assert_array_equal(row_best_keys(st[q], ed[q], vs[q], 3, 12),
                                      keys.max(-1))


def test_the_floors_leave_most_rows_out_and_ties_in():
    """On near-uniform probabilities the threads' floor lets a small share
    of the rows into the row select and few elements reach the element
    floor; on an all-equal joint every row and element reaches both."""
    st, ed, vs = _case("uniform", 1, 100, 100, seed=3)
    vs = -np.sort(-vs, axis=1)
    (_, stats) = model_banded(st, ed, vs, 2, 16, 200)
    videos, past, survivors = stats[0]
    assert 200 <= past < 0.15 * 100 * 100 and 200 <= survivors < 0.2 * 200 * 14
    assert 1 <= videos <= 100
    st, ed, vs = _case("all_equal", 1, 20, 100, seed=3)
    (_, stats) = model_banded(st, ed, vs, 2, 16, 200)
    assert stats[0] == (2, 20 * 100, 200 * 14)


def test_the_wrapper_holds_v_l_w_below_2_30_on_every_device():
    """V * L * W < 2^30 (flat indices in int32) is checked before the device
    is looked at: shapes alone, no memory (meta tensors), no card."""
    from tvretrieval_tpu_torch.ops import topk

    V, L = 2 ** 30 // (128 * 16), 128
    st = torch.empty((1, V, L), device="meta")
    vs = torch.empty((1, V), device="meta")
    with pytest.raises(ValueError, match="below 2"):
        topk.banded_topk_spans_fused(st, st, vs, 2, 18, 200)
    with pytest.raises(ValueError, match="one CUDA device"):     # one video fewer passes
        topk.banded_topk_spans_fused(st[:, 1:], st[:, 1:], vs[:, 1:], 2, 18, 200)
