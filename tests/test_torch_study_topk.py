"""The fused banded top-N of the port (B8: ops.topk.banded_topk_spans_fused)
against the JAX function it replaces, on identical numpy inputs.

On the CPU the port's wrapper runs its kernel's plain version
(``ops.span.banded_topk_spans``); the JAX Pallas kernel runs as its own test
runs it (``interpret=True``), beside its XLA reference. All four outputs
are exactly equal to both, at the six cases of tests/test_pallas_topk.py
(ties, masked tails, top_n above the span count, the kernel's limits). The
CUDA kernel is held to the same plain version on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tvretrieval_tpu.ops import span as jspan
from tvretrieval_tpu.ops.pallas_topk import banded_topk_spans_pallas as j_banded_topk
from tvretrieval_tpu_torch.ops import span as tspan
from tvretrieval_tpu_torch.ops import _build, topk

T = torch.from_numpy


def _span_case(nq, V, L, seed, masked_tail=0, flat_ties=False):
    rng = np.random.default_rng(seed)
    st = rng.random((nq, V, L)).astype(np.float32)
    ed = rng.random((nq, V, L)).astype(np.float32)
    if masked_tail:
        st[..., L - masked_tail:] = 0.0
        ed[..., L - masked_tail:] = 0.0
    if flat_ties:
        st, ed = np.round(st * 2) / 2, np.round(ed * 2) / 2
    vsc = np.exp(4.0 * rng.random((nq, V))).astype(np.float32)
    return st, ed, -np.sort(-vsc, axis=1)


SPAN_CASES = [
    (3, 9, 20, 1, 7, 50, {}),
    (2, 5, 33, 2, 16, 200, {}),
    (2, 6, 20, 1, 9, 64, {"masked_tail": 8}),
    (2, 7, 16, 1, 5, 100, {"flat_ties": True}),
    (1, 3, 10, 2, 6, 120, {}),       # top_n exceeds the positive span count
    (2, 4, 128, 2, 18, 256, {}),     # L = 128, W = 16, top_n = 256: the limits
]


@pytest.mark.parametrize("nq,V,L,min_l,max_l,top_n,kw", SPAN_CASES)
def test_banded_topk_spans_fused_equals_jax_kernel_exactly(nq, V, L, min_l, max_l, top_n, kw):
    st, ed, vsc = _span_case(nq, V, L, seed=nq * 100 + V, **kw)
    _build.reset_launch_counts()
    got = topk.banded_topk_spans_fused(T(st), T(ed), T(vsc), min_l, max_l, top_n)
    assert _build.LAUNCHES["banded_topk_spans_fused"] == 0         # CPU: the plain version
    jk = j_banded_topk(*map(jnp.asarray, (st, ed, vsc)), min_l, max_l, top_n, interpret=True)
    jr = jspan.banded_topk_spans(*map(jnp.asarray, (st, ed, vsc)), min_l, max_l, top_n)
    for name, g, k, r in zip(("vid", "st", "ed", "scores"), got, jk, jr):
        assert g.shape == (nq, top_n), name
        np.testing.assert_array_equal(g.numpy(), np.asarray(k), err_msg=name)
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
    assert got[0].dtype == got[1].dtype == got[2].dtype == torch.int32


@pytest.mark.parametrize("nq,V,L,min_l,max_l,top_n,kw", SPAN_CASES[:4])
def test_banded_topk_spans_fused_is_a_drop_in_for_the_engine_modes(nq, V, L, min_l, max_l,
                                                                  top_n, kw):
    st, ed, vsc = (T(a) for a in _span_case(nq, V, L, seed=nq * 37 + V, **kw))
    *got, n_sorted = topk.banded_topk_spans_fused(st, ed, vsc, min_l, max_l, top_n,
                                                  return_sorted=True)
    assert n_sorted.tolist() == [V] * nq and n_sorted.dtype == torch.int32
    for fn in (tspan.banded_topk_spans, tspan.banded_topk_spans_grouped_shift):
        for a, b in zip(fn(st, ed, vsc, min_l, max_l, top_n), got):
            assert torch.equal(a, b)


@pytest.mark.parametrize("min_l,max_l,top_n,L", [
    (1, 18 + 1, 50, 12),             # W = 18 (the JAX kernel's own guard test)
    (2, 16, 257, 12),                # top_n above the buffer
    (2, 16, 50, 129)])               # L above the tile
def test_banded_topk_spans_fused_limits(min_l, max_l, top_n, L):
    st, ed, vsc = _span_case(1, 2, L, seed=0)
    with pytest.raises(ValueError, match="kernel limits"):
        topk.banded_topk_spans_fused(T(st), T(ed), T(vsc), min_l, max_l, top_n)
    if L <= 128:
        with pytest.raises(ValueError):
            j_banded_topk(*map(jnp.asarray, (st, ed, vsc)), min_l, max_l, top_n, interpret=True)


def test_banded_topk_spans_fused_checks_operands():
    st, ed, vsc = (T(a) for a in _span_case(2, 3, 12, seed=1))
    with pytest.raises(ValueError, match=r"\(Nq, V\)"):
        topk.banded_topk_spans_fused(st, ed, vsc[:, :2], 1, 5, 10)
    with pytest.raises(ValueError, match="min_l"):
        topk.banded_topk_spans_fused(st, ed, vsc, 5, 5, 10)
    with pytest.raises(ValueError, match="one CUDA device"):     # no plain run off the CPU
        topk.banded_topk_spans_fused(st.to("meta"), ed.to("meta"), vsc.to("meta"), 1, 5, 10)
