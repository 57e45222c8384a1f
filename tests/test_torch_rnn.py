"""The port's RNN encoder (tvretrieval_tpu_torch/models/rnn.py) against the
flax scan (tvretrieval_tpu/models/rnn.py) on converted weights: LSTM and
GRU, one and two directions, rows of full, middle, unit and zero length;
then the XML with LSTM and GRU encoders, with and without the positional
embedding (add_pe_rnn), through tests/_xml_pairs.py.

The JAX scan-RNN is compiled at one tiny shape, once per cell type and
dtype, in a module-scoped fixture: XLA:CPU has been seen to crash
compiling it in long processes (VERDICT.md), and a file of its own keeps
such a crash to this file. Float32 tolerance: 2e-4, the bound the JAX
package meets against the original torch model (tests/test_xml.py).

bfloat16 compute: the flax scan is compiled with
``xla_allow_excess_precision=False``, so it rounds to bf16 where the cell
casts (XLA:CPU otherwise keeps fused bf16 chains in float32). A step has 8
bf16 roundings (the two products, the bias add, the gate sum, the gate
functions, the i*g product); each moves a value by at most u = 2^-8 times
a magnitude <= 1 (gates and tanh are bounded by 1, and a rounding of a
pre-activation a passes through a slope s with |a| s(a) < 1/2), the carry
stays float32, and the gates (|f|, |z| <= 1) do not grow an error carried
from the step before (the recurrent kernels are near-orthogonal). Over L
steps: |port - flax| <= 8 * L * u. XLA:CPU expands the logistic gate as
1 / (1 + exp(-x)) with a rounding after each op, where torch rounds the
sigmoid once, so single gates differ by a bf16 step and the recurrence
carries that on: the two do not agree bit for bit, and the float32 encoder
sits as close to the flax bf16 scan as the port's bf16 does. The bf16
negative control is therefore made on the XML, whose bf16 path agrees
with the JAX model's almost bit for bit (tests/test_torch_xml_bf16.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _xml_pairs import SIZES, assert_outputs_close, flax_params, jax_outputs, make_batch
from _xml_pairs import port_model, port_outputs
from tvretrieval_tpu.models import rnn as jr
from tvretrieval_tpu.models import xml as jx
from tvretrieval_tpu_torch.convert import flax_params_to_state_dict
from tvretrieval_tpu_torch.models import rnn as tr

N, L, IN, H = 4, 8, 6, 8
LENGTHS = np.array([8, 3, 1, 0], np.int32)        # full, middle, unit, an empty padded row


def _inputs():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(N, L, IN)).astype(np.float32)
    return x


@pytest.fixture(scope="module", params=["lstm", "gru"])
def flax_run(request):
    """(rnn_type, perturbed flax params, {dtype_str: (outputs, hidden)})
    for the bidirectional flax encoder; its forward half is the
    unidirectional encoder with the same cell."""
    rnn_type = request.param
    x = _inputs()
    out = {}
    params = None
    for dtype_str, dt in (("float32", jnp.float32), ("bfloat16", jnp.bfloat16)):
        m = jr.RNNEncoder(H, rnn_type, True, dt)
        if params is None:
            p = m.init(jax.random.PRNGKey(3), x, LENGTHS)["params"]
            rng = np.random.default_rng(1)
            # perturb so the zero biases are not trivial
            params = jax.tree_util.tree_map(
                lambda a: np.asarray(a) + 0.2 * rng.standard_normal(a.shape).astype(np.float32),
                jax.device_get(p))
        run = jax.jit(m.apply).lower({"params": params}, x, LENGTHS).compile(
            compiler_options={"xla_allow_excess_precision": False})
        o, h = run({"params": params}, x, LENGTHS)
        out[dtype_str] = (np.asarray(o, np.float32), np.asarray(h, np.float32))
    return rnn_type, params, out


def _port(rnn_type, params, bidirectional, dtype):
    m = tr.RNNEncoder(IN, H, rnn_type, bidirectional, dtype)
    sd = flax_params_to_state_dict(params)
    if not bidirectional:
        sd = {k: v for k, v in sd.items() if k.startswith("fwd_cell.")}
    m.load_state_dict(sd, strict=True)
    return m


def _run(m, x=None):
    x = _inputs() if x is None else x
    with torch.no_grad():
        o, h = m(torch.from_numpy(x), torch.from_numpy(LENGTHS))
    return o.numpy(), h.numpy()


@pytest.mark.parametrize("bidirectional", [True, False])
def test_rnn_encoder_matches_flax(flax_run, bidirectional):
    rnn_type, params, out = flax_run
    want_o, want_h = out["float32"]
    if not bidirectional:
        want_o, want_h = want_o[..., :H], want_h[..., :H]
    got_o, got_h = _run(_port(rnn_type, params, bidirectional, torch.float32))
    assert got_o.shape == (N, L, H * (1 + bidirectional)) and got_o.dtype == np.float32
    np.testing.assert_allclose(got_o, want_o, rtol=0, atol=2e-4)
    np.testing.assert_allclose(got_h, want_h, rtol=0, atol=2e-4)
    # outputs past each length are exactly zero; the empty row's final
    # hidden is the carry after its whole padded row, as flax indexes it
    assert (got_o[np.arange(L)[None] >= LENGTHS[:, None]] == 0).all()
    assert np.abs(got_h[3]).max() > 1e-3


def test_rnn_encoder_backward_runs_over_the_valid_prefix(flax_run):
    """Changing a row's padding leaves its outputs and final hidden
    unchanged, in both directions (rows of length >= 1)."""
    rnn_type, params, _ = flax_run
    m = _port(rnn_type, params, True, torch.float32)
    x = _inputs()
    y = x.copy()
    for i, n in enumerate(LENGTHS):
        y[i, n:] = 5.0
    a, b = _run(m, x), _run(m, y)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1][:3], b[1][:3])


def test_rnn_encoder_bf16_matches_flax_bf16(flax_run):
    rnn_type, params, out = flax_run
    want_o, want_h = out["bfloat16"]
    got_o, got_h = _run(_port(rnn_type, params, True, torch.bfloat16))
    assert got_o.dtype == np.float32          # flax's carry and outputs stay float32
    bound = 8 * L * 2.0 ** -8
    err = max(np.abs(got_o - want_o).max(), np.abs(got_h - want_h).max())
    assert 0 < err <= bound, err
    assert (got_o[np.arange(L)[None] >= LENGTHS[:, None]] == 0).all()


def test_rnn_biases_flax_lacks_stay_zero_in_training(flax_run):
    rnn_type, params, _ = flax_run
    m = _port(rnn_type, params, True, torch.float32)
    o, h = m(torch.from_numpy(_inputs()), torch.from_numpy(LENGTHS))
    (o.square().sum() + h.sum()).backward()
    for cell in (m.fwd_cell, m.bwd_cell):
        if rnn_type == "lstm":
            assert (cell.bias_ih_l0.grad == 0).all() and cell.bias_hh_l0.grad.abs().max() > 0
        else:
            assert (cell.bias_hh_l0.grad[:2 * H] == 0).all()
            assert cell.bias_hh_l0.grad[2 * H:].abs().max() > 0
            assert cell.bias_ih_l0.grad.abs().max() > 0


def test_pools_match():
    rng = np.random.default_rng(4)
    out = rng.normal(size=(3, 5, 4)).astype(np.float32)
    mask = (np.arange(5)[None] < np.array([5, 2, 0])[:, None]).astype(np.float32)
    for jf, tf in ((jr.max_pool_masked, tr.max_pool_masked),
                   (jr.mean_pool_masked, tr.mean_pool_masked)):
        np.testing.assert_allclose(tf(torch.from_numpy(out), torch.from_numpy(mask)).numpy(),
                                   np.asarray(jf(jnp.asarray(out), jnp.asarray(mask))),
                                   rtol=1e-6, atol=1e-6)


def test_rnn_init_is_flax_like_and_seeded():
    from tvretrieval_tpu_torch.models.components import init_like_flax
    make = lambda seed: init_like_flax(m := tr.RNNEncoder(16, 8, "lstm"),
                                       torch.Generator().manual_seed(seed)) or m
    a, b, c = make(0), make(0), make(1)
    for (k, p), q, r in zip(a.state_dict().items(), b.state_dict().values(),
                            c.state_dict().values()):
        assert torch.equal(p, q), k
        if k.startswith("fwd_cell.weight"):
            assert not torch.equal(p, r), k
    w_hh = a.fwd_cell.weight_hh_l0
    for g in range(4):                         # one orthogonal block per gate
        blk = w_hh[g * 8:(g + 1) * 8]
        torch.testing.assert_close(blk @ blk.T, torch.eye(8), atol=1e-5, rtol=0)
    w_ih = a.fwd_cell.weight_ih_l0             # lecun_normal: truncated at 2 sigma
    sigma = (1 / 16) ** 0.5 / 0.87962566103423978
    assert w_ih.abs().max() <= 2 * sigma
    assert (a.fwd_cell.bias_ih_l0 == 0).all() and (a.fwd_cell.bias_hh_l0 == 0).all()


@pytest.mark.parametrize("encoder_type,add_pe_rnn", [("lstm", False), ("gru", True)])
def test_xml_rnn_encoders_match_jax(encoder_type, add_pe_rnn):
    """The forward loss and loss dict (the in-batch predictions inside
    it), encode_context and get_pred_from_raw_query across the corpus,
    within 2e-4. Each cell type once and each add_pe_rnn setting once: the
    switch adds or drops the positional embeddings before the encoder,
    whatever the cell (without it neither model has them), and each
    combination costs seconds, the JAX side compiled as one program (op by
    op, each scan traces and compiles anew). visualization_data does not
    depend on the encoder type: tests/test_torch_xml_variants.py holds it
    against JAX."""
    kw = dict(SIZES, encoder_type=encoder_type, add_pe_rnn=add_pe_rnn)
    batch = make_batch()
    params = flax_params(jx.XMLConfig(**kw), batch)
    assert ("query_pos_embed" in params) == add_pe_rnn
    parts = ("loss", "ctx", "pred.True")
    assert_outputs_close(port_outputs(port_model(kw, params), batch, parts),
                         jax_outputs(jx.XMLConfig(**kw), params, batch, {}, parts),
                         rtol=2e-4, atol=2e-4)
