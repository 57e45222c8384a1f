"""ExCL's second LSTM split by linearity (ops/lstm.py, csrc/excl_lstm.cu).

On the CPU, with no JAX:
- ``pack_weights`` puts every element of [W_c | W_hh] where the kernel's
  lanes read their mma.sync m16n8k8 B fragments;
- a plain-PyTorch walk of the kernel's algebra, built from the same
  prepared weights the kernel takes (W unpacked through the fragment map,
  ``g_q = q . W_q^T + b_ih + b_hh`` once a query and broadcast over its
  pairs, the backward direction's index walk, the write of each valid step
  into zeroed outputs) equals today's path (``excl_lstm_plain``: the
  concatenation, then ``encoder2``) within f32 rounding, for both streams,
  with both biases away from zero and lengths 0, 1, ragged and L; a walk
  that drops the query's term, or walks the backward direction over the
  whole row, does not;
- routing: CPU tensors take the plain version (bit-equal, nothing
  launched, no ``kernel_sequences`` on the span "excl_lstm"), and a
  bfloat16 ExCL keeps its step loop (``rnn._loop``).

On a card (marker ``cuda``; the ``dev`` fixture skips without one): the
kernel against the plain version at shapes off its 64-sequence blocks,
ragged lengths with zeros, one and two streams, one launch a call, the
span's ``kernel_sequences`` (pairs x streams x 2); and the refusals of
what it does not take. On the card machine, with no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_excl_lstm.py
"""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tvretrieval_tpu_torch.models import rnn
from tvretrieval_tpu_torch.models.excl import ExCL, ExCLConfig
from tvretrieval_tpu_torch.ops import lstm
from tvretrieval_tpu_torch.utils import trace

H = lstm.HIDDEN
# |split walk - plain| on h in (-1, 1): both sum the same f32 products of
# K = 512 (plain) and 256 + 128 + the query's 256 (split) terms in another
# order, each step's rounding (~sqrt(K) 2^-24 ~ 1e-6 of a gate) carried
# through at most L = 9 steps of contracting sigmoid / tanh gates; these
# cases read 1.9e-7 to 3.7e-7, the controls above 1e-3
SPLIT_ATOL = 1e-5


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _excl(seed=0, dtype_str="float32"):
    """An ExCL at the published hidden size (128 units a direction) with
    small inputs, every bias drawn away from zero."""
    g = torch.Generator().manual_seed(seed)
    excl = ExCL(ExCLConfig(visual_input_size=12, sub_input_size=10, query_input_size=9,
                           dtype_str=dtype_str)).init_weights(g)
    with torch.no_grad():
        for name, p in excl.named_parameters():
            if "bias" in name:
                p.normal_(0.0, 0.1, generator=g)
    return excl.eval()


def _pairs(excl, seed=1, lengths=(0, 1, 5, 9, 9, 3), L=9, n_queries=2):
    """ctx1 of both streams from ``encode_context`` over random clips, each
    pair's query one of ``n_queries`` hidden vectors; returns (ctx1s,
    q_query (Q, 256), pair_query (P,), lengths (P,))."""
    g = torch.Generator().manual_seed(seed)
    n = torch.tensor(lengths)
    P = len(lengths)
    mask = (torch.arange(L)[None] < n[:, None]).float()
    v = torch.randn((P, L, 12), generator=g) * mask[:, :, None]
    s = torch.randn((P, L, 10), generator=g) * mask[:, :, None]
    with torch.no_grad():
        ctx1s = excl.encode_context(v, mask, s, mask)
    q_query = torch.tanh(torch.randn((n_queries, 2 * H), generator=g))
    pair_query = torch.arange(P) % n_queries
    return list(ctx1s), q_query, pair_query, n


def _unpack(packed):
    """[W_c | W_hh] (512, 384) read back through the kernel's fragment map:
    warp w, k-step s, lane, n-tile j, register b -> W[j * 128 + 8 w + lane
    // 4, 8 s + lane % 4 + 4 b]."""
    warps, k_steps = packed.shape[:2]
    w, s, lane, j, b = torch.meshgrid(
        *(torch.arange(k, device=packed.device) for k in (warps, k_steps, 32, 4, 2)),
        indexing="ij")
    out = torch.empty((4 * H, 8 * k_steps), dtype=packed.dtype, device=packed.device)
    out[j * H + 8 * w + lane // 4, 8 * s + lane % 4 + 4 * b] = packed.reshape(
        warps, k_steps, 32, 4, 2)
    return out


def _split_walk(encoders, ctx1s, q_query, pair_query, lengths, keep_query=True,
                index_walk=True, dtype=torch.float32):
    """The kernel's algebra in plain PyTorch from the prepared weights, in
    ``dtype`` on the inputs' device; ``keep_query`` / ``index_walk`` False
    are the controls (no query term; the backward direction over the whole
    row reversed)."""
    P, L = ctx1s[0].shape[:2]
    dev = ctx1s[0].device
    rows, lengths = torch.arange(P, device=dev), lengths.long()
    q_query = q_query.to(dtype)
    outs = []
    for enc, ctx1 in zip(encoders, ctx1s):
        packed, w_q, bias = (t.to(dtype) for t in lstm.split_weights(enc))
        ctx1 = ctx1.to(dtype)
        out = torch.zeros((P, L, 2 * H), dtype=dtype, device=dev)
        for d in range(2):
            w = _unpack(packed[d])
            w_c, w_hh = w[:, :2 * H], w[:, 2 * H:]
            g_q = q_query @ w_q[d * 4 * H:(d + 1) * 4 * H].T + bias[d * 4 * H:(d + 1) * 4 * H]
            g_q = g_q[pair_query] if keep_query else bias[d * 4 * H:(d + 1) * 4 * H].expand(P, -1)
            h = torch.zeros((P, H), dtype=dtype, device=dev)
            c = torch.zeros_like(h)
            for t in range(L):
                if d == 0:
                    clip = torch.full((P,), t, device=dev)
                elif index_walk:
                    clip = (L - 1 - t + lengths) % L
                else:
                    clip = torch.full((P,), L - 1 - t, device=dev)
                gates = ctx1[rows, clip] @ w_c.T + h @ w_hh.T + g_q
                i, f, gg, o = gates.split(H, dim=-1)
                c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
                h = torch.sigmoid(o) * torch.tanh(c)
                valid = t < lengths
                out[rows[valid], clip[valid], d * H:(d + 1) * H] = h[valid]
        outs.append(out)
    return outs


def _encoders(excl):
    return [excl.video_encoder2, excl.sub_encoder2]


def test_pack_weights_is_the_b_fragment_order():
    g = torch.Generator().manual_seed(4)
    w_c, w_hh = torch.randn((4 * H, 2 * H), generator=g), torch.randn((4 * H, H), generator=g)
    packed = lstm.pack_weights(w_c, w_hh)
    assert packed.shape == (lstm.WARPS, 48, 32, 8) and packed.is_contiguous()
    assert torch.equal(_unpack(packed), torch.cat([w_c, w_hh], dim=1))
    # lane 5 of warp 3, k-step 33 (the h part), n-tile 2 (gate g), register 1
    assert packed[3, 33, 5, 2 * 2 + 1] == w_hh[2 * H + 8 * 3 + 5 // 4, 8 * 33 - 2 * H + 5 % 4 + 4]


@pytest.mark.parametrize("lengths,L", [((0, 1, 5, 9, 9, 3), 9), ((4, 0, 4, 2), 4)])
def test_split_walk_equals_the_plain_path(lengths, L):
    excl = _excl()
    ctx1s, q_query, pair_query, n = _pairs(excl, lengths=lengths, L=L)
    with torch.no_grad():
        want = lstm.excl_lstm_plain(_encoders(excl), ctx1s, q_query[pair_query], [n, n])
        got = _split_walk(_encoders(excl), ctx1s, q_query, pair_query, n)
        no_query = _split_walk(_encoders(excl), ctx1s, q_query, pair_query, n, keep_query=False)
        whole_row = _split_walk(_encoders(excl), ctx1s, q_query, pair_query, n,
                                index_walk=False)
    for stream in range(2):
        err = (got[stream] - want[stream]).abs().max().item()
        assert err <= SPLIT_ATOL, (stream, err)
        assert (want[stream][n == 0] == 0).all() and (got[stream][n == 0] == 0).all()
        assert (no_query[stream] - want[stream]).abs().max() > 100 * SPLIT_ATOL
        if (n < L).any() and (n > 1).any():
            assert (whole_row[stream] - want[stream]).abs().max() > 100 * SPLIT_ATOL


def test_cpu_takes_the_plain_version_and_bf16_its_step_loop(monkeypatch):
    excl = _excl()
    ctx1s, q_query, pair_query, n = _pairs(excl)
    q = q_query[pair_query]
    lstm.reset_launch_counts()
    with torch.no_grad():
        got = lstm.excl_lstm(_encoders(excl), ctx1s, q, [n, n])
        want = lstm.excl_lstm_plain(_encoders(excl), ctx1s, q, [n, n])
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert lstm.LAUNCHES["excl_lstm"] == 0

    bf16 = _excl(dtype_str="bfloat16")
    steps = []
    loop = rnn._loop
    monkeypatch.setattr(rnn, "_loop", lambda *a: steps.append(1) or loop(*a))
    monkeypatch.setattr(lstm, "excl_lstm", lambda *a: pytest.fail("bf16 took the split op"))
    mask = (torch.arange(ctx1s[0].shape[1])[None] < n[:, None]).float()
    with torch.no_grad():
        st, ed = bf16.fused_span_logits(q, ctx1s, (mask, mask))
    assert len(steps) == 4 and st.shape == ed.shape == mask.shape


def _traced_lstm_counters(excl, ctx1s, q, n):
    """The counters of the span "excl_lstm" of one ``fused_span_logits``
    under ``torch.profiler``, opened inside a root span on ``q``'s device
    as the engine opens it."""
    mask = (torch.arange(ctx1s[0].shape[1], device=q.device)[None] < n[:, None]).float()
    trace.take()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]):
        with trace.span("score_query_batch", q.device):
            excl.fused_span_logits(q, ctx1s, (mask, mask))
    return {s.name: s.counters for s in trace.take()}["excl_lstm"]


def test_span_counts_no_kernel_sequences_on_the_plain_path():
    excl = _excl()
    ctx1s, q_query, pair_query, n = _pairs(excl)
    assert _traced_lstm_counters(excl, ctx1s, q_query[pair_query], n) == {}


# ---------------------------------------------------------------- on a card
@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _card_pairs(dev, P, L, seed, empty_rows=True):
    g = torch.Generator(device=dev).manual_seed(seed)
    n = torch.randint(1, L + 1, (P,), generator=g, device=dev)
    if empty_rows:
        n[::7] = 0
        n[1::5] = L
    mask = (torch.arange(L, device=dev)[None] < n[:, None]).float()
    ctx1s = [torch.tanh(torch.randn((P, L, 2 * H), generator=g, device=dev)) * mask[:, :, None]
             for _ in range(2)]
    q = torch.tanh(torch.randn((P, 2 * H), generator=g, device=dev))
    return ctx1s, q, n.int()


# |kernel - f64| and |plain (cuDNN, f32) - f64| on h: f32 sums of K = 384
# (512) products (3xTF32 keeps each product within ~3 2^-22 of f32) carried
# through up to 100 steps; at the benchmark cell's call on an H100 the
# kernel read 1.1e-5 and cuDNN 9.6e-6, so the kernel may be at most twice
# as far from f64 as cuDNN, and within CARD_ATOL
CARD_ATOL = 3e-5


@pytest.mark.cuda
@pytest.mark.parametrize("P,L,streams", [(1, 1, 2), (63, 7, 2), (65, 100, 2), (130, 33, 1),
                                         (129, 100, 1)])
def test_kernel_equals_plain_version(dev, P, L, streams):
    excl = _excl().to(dev)
    ctx1s, q, n = _card_pairs(dev, P, L, seed=P + L)
    encoders = _encoders(excl)[:streams]
    lstm.reset_launch_counts()
    with torch.no_grad():
        got = lstm.excl_lstm(encoders, ctx1s[:streams], q, [n] * streams)
        torch.cuda.synchronize()
        want = lstm.excl_lstm_plain(encoders, ctx1s[:streams], q, [n] * streams)
        exact = _split_walk(encoders, ctx1s[:streams], q, torch.arange(P, device=dev), n,
                            dtype=torch.float64)
    assert lstm.LAUNCHES["excl_lstm"] == 1
    pad = torch.arange(L, device=dev)[None] >= n[:, None]
    for a, b, e in zip(got, want, exact):
        assert a.shape == b.shape and torch.isfinite(a).all()
        err, plain_err = ((x.double() - e).abs().max().item() for x in (a, b))
        assert err <= min(CARD_ATOL, max(2 * plain_err, 1e-6)), (err, plain_err)
        assert (a[pad] == 0).all()


@pytest.mark.cuda
def test_span_counts_the_kernels_sequences(dev):
    excl = _excl().to(dev)
    ctx1s, q, n = _card_pairs(dev, 70, 9, seed=5)
    lstm.reset_launch_counts()
    counters = _traced_lstm_counters(excl, ctx1s, q, n)
    assert counters == {"kernel_sequences": 2 * 2 * 70} and lstm.LAUNCHES["excl_lstm"] == 1


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(dev):
    excl = _excl().to(dev)
    ctx1s, q, n = _card_pairs(dev, 8, 5, seed=3)
    narrow = ExCL(ExCLConfig(visual_input_size=12, sub_input_size=10, query_input_size=9,
                             hidden_size=64)).eval().to(dev)
    with pytest.raises(ValueError, match="units a direction"):
        lstm.excl_lstm([narrow.video_encoder2], [ctx1s[0][..., :64]], q[:, :64], [n])
    with pytest.raises(ValueError, match="float32"):
        lstm.excl_lstm(_encoders(excl), [c.double() for c in ctx1s], q, [n, n])
    with pytest.raises(ValueError, match="lengths"):
        lstm.excl_lstm(_encoders(excl), ctx1s, q, [n.float(), n.float()])
