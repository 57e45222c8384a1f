"""The sorting-kernel selections of the port (tvretrieval_tpu_torch.ops.sort,
and the psort functions of ops.span built on it) against the JAX package's
(ops.pallas_sort.topk_transposed in interpret mode, ops.span) on identical
numpy inputs. Everything here is exactly equal, values and indices, with
planted ties (5 distinct values) and exact zeros: the order is value
descending, then index ascending. On the CPU the port's wrapper runs its
plain version, a stable descending sort; the CUDA kernel is held to the same
plain version on the card (tests/test_torch_kernels_cuda.py, chip_smoke.py).

Interpret-mode rows stay at n <= 512 to keep the file fast.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tvretrieval_tpu.ops import span as js
from tvretrieval_tpu.ops.pallas_sort import topk_transposed as j_topk_transposed
from tvretrieval_tpu_torch.ops import _build
from tvretrieval_tpu_torch.ops import sort as tsort
from tvretrieval_tpu_torch.ops import span as ts

T = torch.from_numpy


def _eq(j, t):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _scores(seed, shape, ties):
    x = np.random.default_rng(seed).random(shape).astype(np.float32)
    if ties:
        x = np.round(x * 4) / 4             # 5 distinct values, exact zeros among them
    return x


@pytest.mark.parametrize("n,k,ties", [
    (300, 40, False), (300, 40, True), (512, 100, True), (129, 128, True),
    (127, 8, False), (64, 64, True),        # n <= k: the lax.top_k branch
    (40, 100, True)])                       # k > n: min(k, n) columns
def test_topk_transposed_matches_jax(n, k, ties):
    x = _scores(n + k, (5, n), ties)
    jv, ji = j_topk_transposed(jnp.asarray(x), k, interpret=True)
    _build.reset_launch_counts()
    tv, ti = tsort.topk_transposed(T(x), k)
    assert tv.dtype == torch.float32 and ti.dtype == torch.int32
    assert tv.shape == ti.shape == (5, min(k, n))
    _eq(jv, tv)
    _eq(ji, ti)
    lv, li = jax.lax.top_k(jnp.asarray(x), min(k, n))
    _eq(lv, tv)
    _eq(li, ti)
    assert _build.LAUNCHES["topk_transposed"] == 0       # CPU: the plain version


@pytest.mark.parametrize("n,k", [(17, 2), (5, 3), (9, 9), (3, 1)])
def test_topk_transposed_serves_shapes_the_jax_kernel_refuses(n, k):
    """ceil8(k) > next_pow2(n) fails at trace time in the JAX kernel; the
    port serves those shapes, held here to lax.top_k and to the plain
    version."""
    x = _scores(n, (4, n), True)
    tv, ti = tsort.topk_transposed(T(x), k)
    lv, li = jax.lax.top_k(jnp.asarray(x), k)
    _eq(lv, tv)
    _eq(li, ti)
    pv, pi = tsort.topk_transposed_plain(T(x), k)
    assert torch.equal(pv, tv) and torch.equal(pi, ti)


def test_topk_transposed_minus_inf_rows_and_checks():
    """Real -inf elements come back in index order once the finite ones
    are used up (the pads of the kernel rank after them), and an all-equal
    row keeps index order."""
    x = np.full((3, 20), -np.inf, np.float32)
    x[0, [3, 7, 11]] = [1.0, 1.0, 2.0]
    x[1] = 0.0
    x[2, 19] = -0.0
    tv, ti = tsort.topk_transposed(T(x), 6)
    lv, li = jax.lax.top_k(jnp.asarray(x), 6)
    _eq(lv, tv)
    _eq(li, ti)
    assert ti[0].tolist() == [11, 3, 7, 0, 1, 2] and ti[1].tolist() == [0, 1, 2, 3, 4, 5]
    with pytest.raises(TypeError):
        tsort.topk_transposed(T(x)[0], 2)
    with pytest.raises(TypeError):
        tsort.topk_transposed(T(x).long(), 2)
    with pytest.raises(ValueError):
        tsort.topk_transposed(T(x), 0)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tsort.topk_transposed(T(x).to("meta"), 2)


@pytest.mark.parametrize("n,k,block,ties", [
    (500, 40, 8, True), (333, 100, 16, True), (512, 60, 16, False),
    (120, 100, 8, True),
    (90, 100, 16, True),                    # n <= k
    (30, 10, 16, True)])                    # n <= 2 * block
def test_topk_stable_blocked_psort_matches(n, k, block, ties):
    x = _scores(n * 3 + k, (6, n), ties)
    tv, ti = ts.topk_stable_blocked_psort(T(x), k, block=block)
    assert ti.dtype == torch.int32
    rv, ri = ts.topk_stable_blocked(T(x), k, block=block)
    assert torch.equal(tv, rv) and torch.equal(ti, ri)
    lv, li = jax.lax.top_k(jnp.asarray(x), min(k, n))
    _eq(lv, tv)
    _eq(li, ti)
    if n > k and n > 2 * block:             # else the JAX function is lax.top_k itself
        jv, ji = js.topk_stable_blocked_psort(jnp.asarray(x), k, block=block,
                                              interpret=True)
        _eq(jv, tv)
        _eq(ji, ti)


def test_topk_stable_blocked_psort_small_row_the_jax_function_refuses():
    """x (4, 17), k=2 reaches ceil8(k) > next_pow2(n) inside the JAX
    function; the port is held to its own plain selection."""
    x = _scores(17, (4, 17), True)
    tv, ti = ts.topk_stable_blocked_psort(T(x), 2, block=4)
    rv, ri = ts.topk_stable_blocked(T(x), 2, block=4)
    assert torch.equal(tv, rv) and torch.equal(ti, ri)


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
    (2, 6, 10, 1, 5, 24, True, True),
])
@pytest.mark.parametrize("mode", ["grouped_shift_psort", "grouped_shift8"])
def test_banded_topk_spans_modes_match(mode, nq, v, L, min_l, max_l, top_n, ties, keep):
    rng = np.random.default_rng(nq * 100 + v)
    st, ed, vs = _probs(rng, nq, v, L, ties)
    km = (rng.random((nq, v)) < 0.6).astype(np.float32) if keep else None
    jkm = None if km is None else jnp.asarray(km)
    tkm = None if km is None else T(km)
    jargs = (jnp.asarray(st), jnp.asarray(ed), jnp.asarray(vs), min_l, max_l, top_n)
    targs = (T(st), T(ed), T(vs), min_l, max_l, top_n)
    if mode == "grouped_shift_psort":
        jo = js.banded_topk_spans_grouped_shift_psort(*jargs, keep_mask=jkm, interpret=True)
        to = ts.banded_topk_spans_grouped_shift_psort(*targs, keep_mask=tkm)
    else:
        jo = js.banded_topk_spans_grouped_shift8(*jargs, keep_mask=jkm)
        to = ts.banded_topk_spans_grouped_shift8(*targs, keep_mask=tkm)
    for a, b in zip(jo, to):
        _eq(a, b)
    ref = ts.banded_topk_spans_grouped_shift(*targs, keep_mask=tkm)
    for a, b in zip(ref, to):
        assert torch.equal(a, b)
