"""The select-then-sort algorithm of the sorting top-k kernel B6
(tvretrieval_tpu_torch/csrc/topk_sort.cu) as a small numpy model, step for
step as the kernel runs it, held on the CPU against the kernel's plain
version (``ops.sort.topk_transposed_plain``, a stable descending sort) and
against ``jax.lax.top_k``.

The model: u32 order keys (-0.0 made +0.0 first), an MSD radix select of
the k-th key in up to four 8-bit passes with the kernel's early stop,
compaction of exactly k survivors through per-thread contiguous stretches
and an exclusive scan of their (above, equal) counts, and the kernel's
bitonic network over (key, ~index) composites. Rows are seeded numpy draws
with 5-value ties, 0.0 and -0.0 mixed, and -inf.

``jax.lax.top_k`` orders floats totally: +0.0 before -0.0 whatever their
indices, where the TPU kernel's ``_compound_gt``, the plain version and B6
let them tie and break the tie by index. On rows holding -0.0 the model is
held to the plain version in values and indices and to ``lax.top_k`` in
values.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tvretrieval_tpu_torch.ops.sort import topk_transposed_plain

THREADS = 256          # csrc/topk_sort.cu::kThreads, and the register sort's width


def order_keys(row):
    u = row.astype(np.float32).view(np.uint32).copy()
    u[u == 0x80000000] = 0
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def radix_select(keys, k):
    """(prefix, mask, need, passes): the kept keys are those with
    (key & mask) > prefix and the first ``need`` with (key & mask) == prefix."""
    prefix = mask = 0
    need = k
    for passes, shift in enumerate((24, 16, 8, 0), start=1):
        match = (keys & np.uint32(mask)) == prefix
        hist = np.bincount((keys[match] >> np.uint32(shift)) & 255, minlength=256)
        at_least = np.cumsum(hist[::-1])[::-1]            # keys with digit >= b
        above = at_least - hist
        b = int(np.flatnonzero((above < need) & (need <= at_least))[0])
        prefix |= b << shift
        mask |= 255 << shift
        need -= int(above[b])
        if hist[b] == need:
            break
    return prefix, mask, need, passes


def compact(keys, prefix, mask, need, k):
    """Survivor composites in slot order, as the block writes them."""
    n = len(keys)
    per = -(-n // THREADS)
    starts = np.minimum(np.arange(THREADS) * per, n)
    m = keys & np.uint32(mask)
    gt, eq = (m > prefix).astype(np.int64), (m == prefix).astype(np.int64)
    stretch = np.searchsorted(starts, np.arange(n), side="right") - 1
    count = lambda f: np.bincount(stretch, weights=f, minlength=THREADS).astype(np.int64)
    before_gt = np.cumsum(count(gt)) - count(gt)          # the exclusive scan
    before_eq = np.cumsum(count(eq)) - count(eq)
    n_gt = int(gt.sum())
    assert n_gt == k - need
    local = lambda f: np.cumsum(f) - f - (np.cumsum(f) - f)[starts[stretch]]
    slot_gt = before_gt[stretch] + local(gt)
    rank_eq = before_eq[stretch] + local(eq)
    surv = np.zeros(max(THREADS, 1 << (k - 1).bit_length()), np.uint64)
    comp = ((keys.astype(np.uint64) << np.uint64(32))
            | (~np.arange(n, dtype=np.uint32)).astype(np.uint64))
    take_eq = (eq == 1) & (rank_eq < need)
    surv[slot_gt[gt == 1]] = comp[gt == 1]
    surv[n_gt + rank_eq[take_eq]] = comp[take_eq]
    return surv


def bitonic_desc(c, span):
    """The kernel's network: position t keeps the max of (t, t ^ j) when
    (t & size == 0) == (t & j == 0); the first ``span`` come out descending."""
    c = c.copy()
    t = np.arange(len(c))
    size = 2
    while size <= span:
        j = size >> 1
        while j:
            o = c[t ^ j]
            keep_max = ((t & size) == 0) == ((t & j) == 0)
            c = np.where(keep_max, np.maximum(c, o), np.minimum(c, o))
            j >>= 1
        size <<= 1
    return c


def model_topk(x, k):
    vals, idx, passes = [], [], []
    for row in x:
        keys = order_keys(row)
        prefix, mask, need, p = radix_select(keys, k)
        surv = compact(keys, prefix, mask, need, k)
        span = 1 << (k - 1).bit_length()
        out = bitonic_desc(surv, span)[:k]
        i = (~(out & np.uint64(0xFFFFFFFF)).astype(np.uint32)).astype(np.int64)
        vals.append(row[i])
        idx.append(np.minimum(i, len(row) - 1))
        passes.append(p)
    return np.stack(vals), np.stack(idx).astype(np.int32), passes


def _rows(kind, nq, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.random((nq, n), dtype=np.float32)
    if kind == "distinct":
        return x - 0.5
    x = np.round(x * 4) / 4                              # 5 values, exact zeros
    if kind == "signed_zeros":
        x = np.where(rng.random((nq, n)) < 0.5, -x, x)   # 0.0 and -0.0, ties of both signs
    if kind == "neg_inf":
        x[rng.random((nq, n)) < 0.3] = -np.inf
        x[0, :] = -np.inf                                # a row of -inf alone
    return x.astype(np.float32)


SHAPES = [(1, 1), (7, 3), (17, 2), (300, 120), (600, 300), (1025, 1024), (1364, 100),
          (2800, 200)]


@pytest.mark.parametrize("kind", ["distinct", "ties", "signed_zeros", "neg_inf"])
@pytest.mark.parametrize("n,k", SHAPES)
def test_model_equals_the_plain_version_and_lax_top_k(kind, n, k):
    x = _rows(kind, 4, n, seed=n * 7 + k)
    mv, mi, _ = model_topk(x, k)
    pv, pi = topk_transposed_plain(torch.from_numpy(x), k)
    assert np.array_equal(mv.view(np.uint32), pv.numpy().view(np.uint32))
    assert np.array_equal(mi, pi.numpy())
    jv, ji = jax.lax.top_k(jnp.asarray(x), k)
    assert np.array_equal(mv, np.asarray(jv))             # == : 0.0 equals -0.0
    if kind != "signed_zeros":
        assert np.array_equal(mi, np.asarray(ji))


def test_ties_across_the_cut_keep_the_first_in_index_order():
    """The k-th value is 0.0, held by more elements of both signs than the
    cut keeps: the survivors are the first of them, -0.0 and 0.0 alike."""
    x = np.full((1, 64), -1.0, np.float32)
    x[0, [5, 40]] = 2.0
    zeros = [3, 9, 10, 20, 33, 50, 63]
    x[0, zeros] = 0.0
    x[0, zeros[::2]] = -0.0
    keys = order_keys(x[0])
    prefix, mask, need, passes = radix_select(keys, 5)
    assert (mask, need, passes) == (0xFFFFFFFF, 3, 4) and prefix == order_keys(np.zeros(1))[0]
    mv, mi, _ = model_topk(x, 5)
    assert mi[0].tolist() == [5, 40, 3, 9, 10]
    assert np.signbit(mv[0]).tolist() == [False, False, True, False, True]


def test_early_stop_and_the_selected_key():
    """Distinct values pin the k-th key before the last pass; a row of 5
    values needs all four; the selected prefix is the k-th largest key."""
    for kind, most in (("distinct", 3), ("ties", 4)):
        x = _rows(kind, 3, 2800, seed=1)
        for row in x:
            keys = order_keys(row)
            prefix, mask, need, passes = radix_select(keys, 200)
            kth = np.sort(keys)[::-1][199]
            assert (kth & np.uint32(mask)) == prefix and passes <= most
            if kind == "ties":
                assert passes == 4 and need < int((keys == kth).sum())


def test_order_keys_order_like_the_values():
    v = np.array([-np.inf, -3e38, -1.0, -1e-45, -0.0, 0.0, 1e-45, 1.0, 3e38, np.inf],
                 np.float32)
    keys = order_keys(v).astype(np.int64)
    assert keys[4] == keys[5] and np.all(np.diff(np.delete(keys, 4)) > 0)
