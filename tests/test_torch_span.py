"""Exact selection and span ops (tvretrieval_tpu_torch.ops.span) against
the JAX package (tvretrieval_tpu.ops.span) on identical inputs: indices
and values identical, including planted ties (lax.top_k's order is value
descending, then index ascending)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tvretrieval_tpu.ops import span as js
from tvretrieval_tpu_torch.ops import span as ts

T = torch.from_numpy


def _eq(j, t):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _scores(rng, shape, ties):
    x = rng.random(shape).astype(np.float32)
    return np.round(x * 4) / 4 if ties else x          # ties: 5 distinct values


@pytest.mark.parametrize("ties", [False, True])
def test_topk_stable_matches_lax(ties):
    x = _scores(np.random.default_rng(0), (5, 300), ties)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 40)
    tv, ti = ts.topk_stable(T(x), 40)
    _eq(jv, tv)
    _eq(ji, ti)


@pytest.mark.parametrize("n,k,block,ties", [
    (2100, 100, 16, False), (333, 100, 16, True), (120, 100, 8, False),
    (90, 100, 16, True),                # n <= k: plain top_k branch
    (30, 10, 16, True),                 # n <= 2 * block
    (1000, 200, 8, True)])
def test_topk_stable_blocked_matches(n, k, block, ties):
    x = _scores(np.random.default_rng(n), (6, n), ties)
    jv, ji = js.topk_stable_blocked(jnp.asarray(x), k, block=block)
    tv, ti = ts.topk_stable_blocked(T(x), k, block=block)
    assert ti.dtype == torch.int32
    _eq(jv, tv)
    _eq(ji, ti)


@pytest.mark.parametrize("n,k,block,ties", [(2100, 100, 16, False), (333, 100, 16, True),
                                            (120, 100, 8, False)])
def test_topk_from_block_max_matches(n, k, block, ties):
    x = _scores(np.random.default_rng(n + 1), (6, n), ties)
    xp = np.pad(x, ((0, 0), (0, (-n) % block)), constant_values=-np.inf)
    bmax = xp.reshape(6, -1, block).max(axis=2)
    jv, ji = js.topk_from_block_max(jnp.asarray(xp), jnp.asarray(bmax), k, block=block)
    tv, ti = ts.topk_from_block_max(T(xp), T(bmax), k, block=block)
    _eq(jv, tv)
    _eq(ji, ti)
    rv, ri = ts.topk_stable_blocked(T(x), k, block=block)
    _eq(rv.numpy(), tv)
    _eq(ri.numpy(), ti)


def _probs(rng, nq, v, L, ties):
    st = rng.random((nq, v, L)).astype(np.float32)
    ed = rng.random((nq, v, L)).astype(np.float32)
    if ties:
        st, ed = np.round(st * 4) / 4, np.round(ed * 4) / 4
    st /= st.sum(-1, keepdims=True) + 1e-6
    ed /= ed.sum(-1, keepdims=True) + 1e-6
    vs = np.sort(rng.random((nq, v)).astype(np.float32), axis=1)[:, ::-1].copy()
    if ties:
        vs = np.round(vs * 2) / 2 + 0.5
    return st, ed, vs


@pytest.mark.parametrize("nq,v,L,min_l,max_l,top_n,ties,keep", [
    (3, 9, 14, 1, 8, 50, False, False),
    (2, 7, 12, 2, 6, 40, True, False),     # planted ties: canonical order
    (3, 9, 14, 1, 8, 50, True, True),      # keep_mask: excluded videos at -1
    (2, 2, 5, 1, 4, 30, False, False),     # pool smaller than top_n: zero pad
])
def test_banded_topk_spans_grouped_shift_matches(nq, v, L, min_l, max_l, top_n, ties, keep):
    rng = np.random.default_rng(nq * 100 + v)
    st, ed, vs = _probs(rng, nq, v, L, ties)
    km = (rng.random((nq, v)) < 0.6).astype(np.float32) if keep else None
    jo = js.banded_topk_spans_grouped_shift(
        jnp.asarray(st), jnp.asarray(ed), jnp.asarray(vs), min_l, max_l, top_n,
        keep_mask=None if km is None else jnp.asarray(km))
    to = ts.banded_topk_spans_grouped_shift(
        T(st), T(ed), T(vs), min_l, max_l, top_n, keep_mask=None if km is None else T(km))
    for a, b in zip(jo, to):
        _eq(a, b)
    # and the flat banded top-k it is exact against
    flat = js.banded_topk_spans(jnp.asarray(st), jnp.asarray(ed), jnp.asarray(vs),
                                min_l, max_l, top_n,
                                keep_mask=None if km is None else jnp.asarray(km))
    for a, b in zip(flat, to):
        _eq(a, b)


@pytest.mark.parametrize("L,min_l,max_l,top_n,ties", [(14, 1, 8, 50, False),
                                                       (12, 2, 16, 200, True)])
def test_banded_top_spans_from_probs_matches(L, min_l, max_l, top_n, ties):
    rng = np.random.default_rng(L)
    st, ed, _ = _probs(rng, 1, 5, L, ties)
    st, ed = st[0], ed[0]
    jo = js.banded_top_spans_from_probs(jnp.asarray(st), jnp.asarray(ed), min_l, max_l,
                                        top_n)
    to = ts.banded_top_spans_from_probs(T(st), T(ed), min_l, max_l, top_n)
    for a, b in zip(jo, to):
        _eq(a, b)


def test_band_helpers_match():
    np.testing.assert_array_equal(ts.min_max_length_mask(10, 2, 6),
                                  js.min_max_length_mask(10, 2, 6))
    for a, b in zip(ts._band_indices(10, 2, 6), js._band_indices(10, 2, 6)):
        np.testing.assert_array_equal(a, b)
