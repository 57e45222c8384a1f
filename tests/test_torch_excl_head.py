"""ExCL's span heads split by linearity (ops/excl_head.py, csrc/excl_head.cu).

On the CPU, with no JAX:
- ``CHUNK_PERM`` and the prepared ``W0_c`` pair each A register of the
  kernel's lanes (8 contiguous floats of a row a chunk, k-steps 0-1 from
  the first 16 bytes, 2-3 from the second) with the weight of the same
  physical column: the product through that map equals ``X . W^T``;
- the split by linearity (``u = q . W0_q^T + b0`` once a pair, plus the
  product of [ctx2 | ctx1] with the prepared ``W0_c``, tanh, ``Dense_1``,
  the mask from each row's length, the streams' mean) equals the heads over
  the concatenation: in float64 within 1e-12, in float32 within SPLIT_ATOL;
  without the query's term it does not;
- ``fused_span_logits`` equals ``span_logits`` in eval mode with two streams
  and with each stream alone;
- masked clips and an empty video read exactly -1e10;
- routing: CPU tensors take the plain version (bit-equal, nothing
  launched), a bfloat16 ExCL keeps it too; the prepared weights follow a
  parameter's change; the wrapper's checks refuse a wrong dtype, width,
  layout or device.

On a card (marker ``cuda``; the ``dev`` fixture skips without one): the
kernel against the plain version at the benchmark cell's shape (5,050 pairs
x 100 clips x 2 streams) and at the external-VR path's (1,000 pairs,
lengths 1-100, empty videos), at shapes off its 128-row tiles and with one
stream, and against the same heads in float64; one launch a call of
``score_mee_excl_batch``. On the card machine, with no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_excl_head.py
"""
import pytest
import torch

from tvretrieval_tpu_torch.models.excl import ExCL, ExCLConfig
from tvretrieval_tpu_torch.ops import _build, excl_head
from tvretrieval_tpu_torch.ops.masking import NEG_INF

H = excl_head.HIDDEN
# |split - plain| in float32 on logits of |x| < ~1: both sum the same
# products of K = 768 (plain) and 512 + the query's 256 (split) terms, and
# Dense_1's 256, in another order (~sqrt(K) 2^-24 of sum |x_i w_i| each);
# these cases read 2.6e-8 to 7.5e-8, the control without the query's term
# 2.9e-2 and above
SPLIT_ATOL = 1e-6


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _excl(seed=0, ctx_mode="video_sub", dtype_str="float32"):
    """An ExCL at the published hidden size (256) with small inputs, every
    bias drawn away from zero."""
    g = torch.Generator().manual_seed(seed)
    excl = ExCL(ExCLConfig(ctx_mode=ctx_mode, visual_input_size=12, sub_input_size=10,
                           query_input_size=9, dtype_str=dtype_str)).init_weights(g)
    with torch.no_grad():
        for name, p in excl.named_parameters():
            if "bias" in name:
                p.normal_(0.0, 0.1, generator=g)
    return excl.eval()


def _heads(excl):
    return [(getattr(excl, f"{s}_st_predictor"), getattr(excl, f"{s}_ed_predictor"))
            for s in excl._streams()]


def _rows(seed=1, lengths=(0, 1, 5, 9, 9, 3), L=9, streams=2):
    """ctx2s, ctx1s (P, L, 256) in (-1, 1) (LSTM outputs), q (P, 256), the
    prefix masks and their lengths."""
    g = torch.Generator().manual_seed(seed)
    n = torch.tensor(lengths)
    mask = (torch.arange(L)[None] < n[:, None]).float()
    rows = lambda: torch.tanh(torch.randn((len(lengths), L, H), generator=g))
    ctx2s, ctx1s = [rows() for _ in range(streams)], [rows() for _ in range(streams)]
    q = torch.tanh(torch.randn((len(lengths), H), generator=g))
    return ctx2s, ctx1s, q, [mask] * streams, n


def _concat_heads(heads, ctx2s, ctx1s, q, masks, dtype):
    """The heads over the concatenation, computed in ``dtype`` from the
    predictors' parameters."""
    st = ed = 0
    for pair, ctx2, ctx1, mask in zip(heads, ctx2s, ctx1s, masks):
        feat3 = torch.cat([ctx2, ctx1, q[:, None].expand(-1, ctx1.shape[1], -1)], -1).to(dtype)
        out = []
        for pred in pair:
            p = {k: v.detach().to(dtype) for k, v in pred.named_parameters()}
            hid = torch.tanh(feat3 @ p["Dense_0.weight"].T + p["Dense_0.bias"])
            x = (hid @ p["Dense_1.weight"].T + p["Dense_1.bias"])[..., 0]
            out.append(x * mask.to(dtype) + (1.0 - mask.to(dtype)) * NEG_INF)
        st, ed = st + out[0], ed + out[1]
    return st / len(heads), ed / len(heads)


def _split_heads(heads, ctx2s, ctx1s, q, lengths, dtype, keep_query=True):
    """The kernel's algebra in plain PyTorch from the prepared weights, in
    ``dtype``: the rows' columns read in CHUNK_PERM's order against W0_c,
    plus u; tanh, Dense_1, + b1; -1e10 from each row's length on; the
    streams' mean. ``keep_query`` False is the control (u = b0)."""
    w_c, w_q, b0, w1, b1 = (t.to(dtype) for t in excl_head.split_weights(heads))
    P, L = ctx1s[0].shape[:2]
    u = q.to(dtype) @ w_q.T + b0 if keep_query else b0.expand(P, -1)
    valid = torch.arange(L)[None] < lengths[:, None]
    sums = [0, 0]
    for s, (ctx2, ctx1) in enumerate(zip(ctx2s, ctx1s)):
        rows = torch.cat([ctx2, ctx1], -1).to(dtype).reshape(P, L, -1, excl_head.CHUNK)
        rows = rows[..., excl_head.CHUNK_PERM].reshape(P, L, -1)
        for h in range(2):
            i = 2 * s + h
            hid = rows @ w_c[i * H:(i + 1) * H].T + u[:, None, i * H:(i + 1) * H]
            x = torch.tanh(hid) @ w1[i] + b1[i]
            sums[h] = sums[h] + torch.where(valid, x, torch.tensor(NEG_INF, dtype=dtype))
    return sums[0] / len(ctx2s), sums[1] / len(ctx2s)


def test_chunk_perm_pairs_each_lane_register_with_its_column():
    g = torch.Generator().manual_seed(3)
    x = torch.randn((16, excl_head.K), generator=g, dtype=torch.float64)
    w = torch.randn((24, excl_head.K), generator=g, dtype=torch.float64)
    w_c = w.reshape(24, -1, excl_head.CHUNK)[:, :, excl_head.CHUNK_PERM].reshape(24, -1)
    # lane t's registers of k-step kk: a0 / a2 (logical columns t, t + 4)
    # = its row's physical columns 8 t + 2 kk, 8 t + 2 kk + 1 of the chunk
    logical = torch.empty_like(x)
    for c in range(excl_head.K // excl_head.CHUNK):
        for t in range(4):
            for kk in range(4):
                for e in range(2):
                    logical[:, 32 * c + 8 * kk + t + 4 * e] = x[:, 32 * c + 8 * t + 2 * kk + e]
    assert sorted(excl_head.CHUNK_PERM.tolist()) == list(range(excl_head.CHUNK))
    assert torch.allclose(logical @ w_c.T, x @ w.T, rtol=0, atol=1e-12)
    assert not torch.allclose(x @ w_c.T, x @ w.T, rtol=0, atol=1e-3)


@pytest.mark.parametrize("ctx_mode,lengths,L", [
    ("video_sub", (0, 1, 5, 9, 9, 3), 9), ("video_sub", (4, 0, 4, 2), 4),
    ("video", (3, 7, 7), 7), ("sub", (2, 0, 5), 5)])
def test_split_by_linearity_equals_the_concatenated_heads(ctx_mode, lengths, L):
    excl = _excl(ctx_mode=ctx_mode)
    heads = _heads(excl)
    ctx2s, ctx1s, q, masks, n = _rows(lengths=lengths, L=L, streams=len(heads))
    with torch.no_grad():
        exact = _concat_heads(heads, ctx2s, ctx1s, q, masks, torch.float64)
        split64 = _split_heads(heads, ctx2s, ctx1s, q, n, torch.float64)
        split32 = _split_heads(heads, ctx2s, ctx1s, q, n, torch.float32)
        plain = excl_head.excl_heads_plain(heads, ctx2s, ctx1s, q, masks)
        no_query = _split_heads(heads, ctx2s, ctx1s, q, n, torch.float32, keep_query=False)
    valid = masks[0] > 0
    for a, e, s, p, c in zip(split64, exact, split32, plain, no_query):
        assert (a - e).abs().max().item() <= 1e-12
        assert (s - p).abs().max().item() <= SPLIT_ATOL
        assert (s[~valid] == NEG_INF).all() and (p[~valid] == NEG_INF).all()
        assert (c - p)[valid].abs().max() > 1e-2


@pytest.mark.parametrize("ctx_mode", ["video_sub", "video", "sub"])
def test_fused_span_logits_equals_span_logits(ctx_mode):
    excl = _excl(seed=2, ctx_mode=ctx_mode)
    g = torch.Generator().manual_seed(4)
    lengths = torch.tensor([9, 1, 6, 0])
    L, Lq = 9, 5
    mask = (torch.arange(L)[None] < lengths[:, None]).float()
    q_mask = (torch.arange(Lq)[None] < torch.tensor([5, 2, 1, 4])[:, None]).float()
    q = torch.randn((4, Lq, 9), generator=g) * q_mask[:, :, None]
    v = torch.randn((4, L, 12), generator=g) * mask[:, :, None]
    s = torch.randn((4, L, 10), generator=g) * mask[:, :, None]
    with torch.no_grad():
        st, ed = excl.span_logits(q, q_mask, v, mask, s, mask)
        _, q_hidden = excl.query_encoder(q, q_mask.sum(1).int())
        got = excl.fused_span_logits(q_hidden, excl.encode_context(v, mask, s, mask),
                                     (mask, mask))
    assert torch.equal(got[0], st) and torch.equal(got[1], ed)
    assert (st[mask == 0] == NEG_INF).all() and (st[3] == NEG_INF).all()


def test_masked_clips_and_an_empty_video_read_minus_1e10():
    excl = _excl(seed=5)
    ctx2s, ctx1s, q, masks, n = _rows(seed=6, lengths=(0, 4, 9, 2), L=9)
    with torch.no_grad():
        st, ed = excl_head.excl_heads(_heads(excl), ctx2s, ctx1s, q, masks)
        split = _split_heads(_heads(excl), ctx2s, ctx1s, q, n, torch.float32)
    for x in (st, ed, *split):
        assert (x[0] == NEG_INF).all()                       # the empty video
        assert (x[masks[0] == 0] == NEG_INF).all()
        assert (x[masks[0] > 0] > NEG_INF / 2).all()
    assert x.dtype == torch.float32 and NEG_INF == -1e10


def test_cpu_takes_the_plain_version_and_bf16_keeps_it(monkeypatch):
    excl = _excl()
    ctx2s, ctx1s, q, masks, _ = _rows()
    _build.reset_launch_counts()
    with torch.no_grad():
        got = excl_head.excl_heads(_heads(excl), ctx2s, ctx1s, q, masks)
        want = excl_head.excl_heads_plain(_heads(excl), ctx2s, ctx1s, q, masks)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert _build.LAUNCHES["excl_head"] == 0

    bf16 = _excl(dtype_str="bfloat16")
    monkeypatch.setattr(excl_head, "excl_heads", lambda *a: pytest.fail("bf16 took the split op"))
    with torch.no_grad():
        st, ed = bf16.fused_span_logits(q, ctx1s, masks)
    assert st.shape == ed.shape == masks[0].shape and st.dtype == torch.float32


def test_prepared_weights_follow_a_parameter_change():
    excl = _excl()
    heads = _heads(excl)
    first = excl_head._prepared(heads)
    assert excl_head._prepared(heads) is first
    with torch.no_grad():
        excl.sub_ed_predictor.Dense_1.bias.add_(1.0)
    second = excl_head._prepared(heads)
    assert second is not first and torch.equal(second[4][3], first[4][3] + 1.0)
    assert torch.equal(second[0], first[0])


def test_wrapper_refuses_what_the_kernel_does_not_take():
    excl = _excl()
    heads = _heads(excl)
    ctx2s, ctx1s, q, masks, _ = _rows()
    excl_head._check(heads, ctx2s, ctx1s, q, masks)                 # takes the published widths
    with pytest.raises(ValueError, match="float32"):
        excl_head._check(heads, [c.double() for c in ctx2s], ctx1s, q, masks)
    with pytest.raises(ValueError, match="q_hidden"):
        excl_head._check(heads, ctx2s, ctx1s, q.double(), masks)
    with pytest.raises(ValueError, match="contiguous"):
        excl_head._check(heads, ctx2s, [c.transpose(0, 1).contiguous().transpose(0, 1)
                                        for c in ctx1s], q, masks)
    narrow = ExCL(ExCLConfig(visual_input_size=12, sub_input_size=10, query_input_size=9,
                             hidden_size=128)).eval()
    with pytest.raises(ValueError, match="Dense_0 768 -> 256"):
        excl_head._check(_heads(narrow), [c[..., :128].contiguous() for c in ctx2s],
                         [c[..., :128].contiguous() for c in ctx1s], q[:, :128].contiguous(),
                         masks)
    with pytest.raises(TypeError, match="float32 predictors"):
        excl_head._check(_heads(_excl(dtype_str="bfloat16")), ctx2s, ctx1s, q, masks)
    with pytest.raises(ValueError, match="one or two streams"):
        excl_head._check(heads, ctx2s, ctx1s[:1], q, masks)
    meta = lambda ts: [t.to("meta") for t in ts]
    with pytest.raises(ValueError, match="tensors on meta"):
        excl_head._check(heads, ctx2s, meta(ctx1s), q, masks)
    with pytest.raises(ValueError, match="expected cpu or cuda"):
        excl_head.excl_heads(heads, meta(ctx2s), meta(ctx1s), q.to("meta"), meta(masks))


# ---------------------------------------------------------------- on a card
@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _card_rows(dev, P, L, streams, seed, ragged):
    g = torch.Generator(device=dev).manual_seed(seed)
    n = torch.full((P,), L, device=dev)
    if ragged:
        n = torch.randint(1, L + 1, (P,), generator=g, device=dev)
        n[::7] = 0
    mask = (torch.arange(L, device=dev)[None] < n[:, None]).float()
    rows = lambda: torch.tanh(torch.randn((P, L, H), generator=g, device=dev))
    ctx2s = [rows() * mask[:, :, None] for _ in range(streams)]
    ctx1s = [rows() for _ in range(streams)]
    q = torch.tanh(torch.randn((P, H), generator=g, device=dev))
    return ctx2s, ctx1s, q, [mask] * streams


# |kernel - plain| and |kernel - f64| on the logits: 3xTF32 keeps each
# product within ~3 2^-22 of f32, and the kernel's f32 sums of 512 (+ u's
# 256) and 256 terms run in another order than cuBLAS's of 768 and 256; the
# tensor cores also round each k-step's sum into the accumulator toward
# zero (3 x 64 k-steps a head), a bias that cuBLAS's FMA, rounding to
# nearest, does not have
CARD_ATOL = 1e-5
F64_ATOL = 5e-6


@pytest.mark.cuda
@pytest.mark.parametrize("P,L,streams,ragged", [
    (5050, 100, 2, False),                # the benchmark cell's call
    (1000, 100, 2, True),                 # the external-VR path's call
    (1, 1, 2, False), (3, 43, 2, True), (129, 7, 1, False), (70, 100, 1, True)])
def test_kernel_equals_plain_version(dev, P, L, streams, ragged):
    excl = _excl(ctx_mode="video_sub" if streams == 2 else "sub").to(dev)
    heads = _heads(excl)
    ctx2s, ctx1s, q, masks = _card_rows(dev, P, L, streams, seed=P + L, ragged=ragged)
    _build.reset_launch_counts()
    with torch.no_grad():
        got = excl_head.excl_heads(heads, ctx2s, ctx1s, q, masks)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["excl_head"] == 1
        want = excl_head.excl_heads_plain(heads, ctx2s, ctx1s, q, masks)
        exact = _concat_heads(heads, ctx2s, ctx1s, q, masks, torch.float64)
    valid = masks[0] > 0
    for a, b, e in zip(got, want, exact):
        assert a.shape == b.shape == (P, L) and torch.isfinite(a).all()
        assert (a[~valid] == NEG_INF).all()
        err = (a - b).abs().max().item()
        err64, plain64 = ((x.double() - e).abs().max().item() for x in (a, b))
        print(f"P={P} L={L} streams={streams}: |kernel - plain| {err:.3e}, from f64: kernel "
              f"{err64:.3e}, plain {plain64:.3e}")
        assert err <= CARD_ATOL and err64 <= F64_ATOL, (err, err64, plain64)


@pytest.mark.cuda
def test_one_launch_a_call_of_score_mee_excl_batch(dev):
    from tvretrieval_tpu_torch.models.mee import MEE, MEEConfig
    from tvretrieval_tpu_torch.retrieval import excl_engine as ee

    g = torch.Generator().manual_seed(7)
    excl = _excl(seed=7).to(dev)
    mee = MEE(MEEConfig(text_input_size=9, vid_input_size=10, sub_input_size=8,
                        output_size=16)).init_weights(g).to(dev).eval()
    gd = torch.Generator(device=dev).manual_seed(7)
    nv, L, nq, lq = 40, 20, 6, 5
    n = torch.randint(1, L + 1, (nv,), generator=gd, device=dev)
    mask = (torch.arange(L, device=dev)[None] < n[:, None]).float()
    block = dict(video_feat=torch.randn((nv, L, 12), generator=gd, device=dev) * mask[..., None],
                 sub_feat=torch.randn((nv, L, 10), generator=gd, device=dev) * mask[..., None],
                 mask=mask, mee_video=torch.randn((nv, 10), generator=gd, device=dev),
                 mee_sub=torch.randn((nv, 8), generator=gd, device=dev))
    cache = ee.encode_mee_excl_corpus(mee, excl, [block], nv)
    q_mask = torch.ones((nq, lq), device=dev)
    q_feat = torch.randn((nq, lq, 9), generator=gd, device=dev)
    gt = torch.arange(nq, device=dev)
    cfg = ee.MEEExCLConfig(top_n_videos=10)
    for calls in (1, 2):
        _build.reset_launch_counts()
        for _ in range(calls):
            out = ee.score_mee_excl_batch(mee, excl, cache, q_feat, q_mask, cfg, gt)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["excl_head"] == calls
        assert _build.LAUNCHES["excl_lstm"] == calls
    assert all(bool(torch.isfinite(v.float()).all()) for v in out.values())
