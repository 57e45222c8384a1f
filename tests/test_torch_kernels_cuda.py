"""The CUDA kernels against their plain PyTorch versions on the card, at
edge shapes the full-size checks in chip_smoke.py do not reach.

Video scores (B1-B3, csrc/video_score.cu): query and video counts off the
64 x 32 block tile, feature rows shorter than one 128-byte stage or with a
tail, lp = 8, and block maxima whose chunk is not a power of two or spans
several warps. Byte-row gather (B4, csrc/gather.cu): one index to a
thousand, rows of one to nineteen 16 KiB segments, duplicate and boundary
indices, a strided and an int64 index tensor, an index outside the table.

Every test carries the ``cuda`` marker and skips (its ``dev`` fixture)
without a CUDA card. Imports no JAX, so on a machine with the card it runs
as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""
import math

import pytest
import torch

from tvretrieval_tpu_torch.ops import gather as gt
from tvretrieval_tpu_torch.ops import video_score as vs

F32_ATOL = 1e-5     # f32 summation order of unit-vector dots

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _caches(dev, nq, nv, L, d, lp, chunk_v, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    unit = lambda *s: torch.nn.functional.normalize(
        torch.randn(*s, generator=g, device=dev), dim=-1)
    lengths = torch.randint(1, L + 1, (nv,), generator=g, device=dev)
    mask = (torch.arange(L, device=dev)[None] < lengths[:, None]).float()
    f = [vs.build_flat_feat1(unit(nv, L, d), mask, lp=lp, chunk_v=chunk_v) for _ in range(2)]
    q = [unit(nq, d) for _ in range(2)]
    if dtype == torch.int8:
        f = [vs.quantize_unit_i8(x) for x in f]
        q = [vs.quantize_unit_i8(x).T for x in q]
    else:
        f = [x.to(dtype) for x in f]
        q = [x.to(dtype).T for x in q]
    return q[0], q[1], f[0], f[1]


SHAPES = [  # nq, nv, L, d, lp, chunk_v
    (1, 5, 7, 16, 8, 4),
    (70, 33, 12, 64, 16, 8),
    (130, 100, 100, 256, 104, 16),
    (65, 40, 20, 272, 24, 8),        # feature axis with a tail past 128 bytes
]


@pytest.mark.parametrize("nq,nv,L,d,lp,chunk_v", SHAPES)
def test_b1_int8_bit_equal(dev, nq, nv, L, d, lp, chunk_v):
    qv, qs, fv, fs = _caches(dev, nq, nv, L, d, lp, chunk_v, torch.int8)
    n0 = vs.LAUNCHES["video_scores_flat_i8"]
    out = vs.video_scores_flat_i8(qv, qs, fv, fs, nv, lp=lp)
    torch.cuda.synchronize()
    assert vs.LAUNCHES["video_scores_flat_i8"] == n0 + 1
    assert out.shape == (nq, nv) and out.dtype == torch.float32
    assert torch.equal(out, vs.video_scores_flat_plain(qv, qs, fv, fs, nv, lp))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nq,nv,L,d,lp,chunk_v", SHAPES)
def test_b2_float_close(dev, dtype, nq, nv, L, d, lp, chunk_v):
    qv, qs, fv, fs = _caches(dev, nq, nv, L, d, lp, chunk_v, dtype)
    out = vs.video_scores_flat(qv, qs, fv, fs, nv, lp=lp)
    ref = vs.video_scores_flat_plain(qv, qs, fv, fs, nv, lp)
    assert out.shape == ref.shape == (nq, nv)
    assert (out - ref).abs().max().item() <= F32_ATOL


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("nv,build_chunk,chunk_v", [
    (21, 8, 8), (24, 24, 12),        # chunk 12: not a power of two
    (100, 128, 64),                  # a block maximum spanning two warps
    (70, 16, 48)])                   # gcd(80, 48) = 16: chunk_v is an upper bound
def test_b3_block_maxima(dev, dtype, nv, build_chunk, chunk_v):
    nq, L, d, lp = 70, 12, 64, 16
    qv, qs, fv, fs = _caches(dev, nq, nv, L, d, lp, build_chunk, dtype, seed=nv)
    scores, bmax = vs.video_scores_flat_bmax(qv, qs, fv, fs, nv, lp=lp, chunk_v=chunk_v)
    ps, pb = vs.video_scores_flat_bmax_plain(qv, qs, fv, fs, nv, lp, chunk_v)
    nv_pad = fv.shape[0] // lp
    chunk = math.gcd(nv_pad, chunk_v)
    assert scores.shape == (nq, nv_pad) and bmax.shape == (nq, nv_pad // chunk)
    assert bool((scores[:, nv:] == -math.inf).all())
    assert torch.equal(bmax, scores.view(nq, -1, chunk).amax(dim=2))
    if dtype == torch.int8:
        assert torch.equal(scores, ps) and torch.equal(bmax, pb)
    else:
        assert (scores[:, :nv] - ps[:, :nv]).abs().max().item() <= F32_ATOL


def test_wrappers_reject_what_the_kernel_does_not_take(dev):
    qv, qs, fv, fs = _caches(dev, 8, 10, 7, 16, 8, 4, torch.int8)
    with pytest.raises(TypeError):
        vs.video_scores_flat_i8(qv.float(), qs.float(), fv.float(), fs.float(), 10, lp=8)
    with pytest.raises(TypeError):
        vs.video_scores_flat(qv, qs, fv, fs, 10, lp=8)
    with pytest.raises(ValueError, match="lp"):
        vs.video_scores_flat_i8(qv, qs, fv, fs, 10, lp=12)
    with pytest.raises(ValueError, match="n_videos"):
        vs.video_scores_flat_i8(qv, qs, fv, fs, 13, lp=8)
    q4, s4, f4, g4 = _caches(dev, 8, 10, 7, 4, 8, 4, torch.bfloat16)   # 8-byte rows
    with pytest.raises(ValueError, match="16"):
        vs.video_scores_flat(q4, s4, f4, g4, 10, lp=8)
    with pytest.raises(ValueError, match="one CUDA device"):
        vs.video_scores_flat_i8(qv.cpu(), qs.cpu(), fv, fs, 10, lp=8)


def _table(dev, n, w, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(-128, 128, (n, 8, w), generator=g, device=dev, dtype=torch.int8), g


@pytest.mark.parametrize("w", [128, 9728, 38528])
@pytest.mark.parametrize("b", [1, 5, 128, 1000])
def test_b4_gather_equals_index_select(dev, b, w):
    n = 257
    table, g = _table(dev, n, w, seed=b)
    idx = torch.randint(0, n, (b,), generator=g, device=dev, dtype=torch.int32)
    idx[0] = n - 1                                  # boundary rows, and duplicates
    if b >= 5:
        idx[1], idx[2], idx[3] = 0, n - 1, 0
    n0 = gt.LAUNCHES["gather_byte_rows"]
    out = gt.gather_byte_rows(table, idx)
    torch.cuda.synchronize()
    assert gt.LAUNCHES["gather_byte_rows"] == n0 + 1
    assert out.shape == (b, 8, w) and out.dtype == torch.int8
    assert torch.equal(out, gt.gather_byte_rows_plain(table, idx))
    gt.check_indices(dev)


def test_b4_takes_strided_and_int64_indices(dev):
    """A non-contiguous index tensor is compacted; int64 indices are
    accepted and narrowed to int32 on the device."""
    n, w = 100, 256
    table, g = _table(dev, n, w)
    wide = torch.randint(0, n, (40, 2), generator=g, device=dev, dtype=torch.int32)
    strided = wide[:, 1]
    assert not strided.is_contiguous()
    assert torch.equal(gt.gather_byte_rows(table, strided), table[strided.long()])
    idx64 = strided.long()
    assert torch.equal(gt.gather_byte_rows(table, idx64), table[idx64])
    assert gt.gather_byte_rows(table, idx64[:0]).shape == (0, 8, w)
    gt.check_indices(dev)


def test_b4_reports_an_index_outside_the_table(dev):
    """No wait for the device at the launch: the row comes back as zeros and
    check_indices raises at the next read-back."""
    n, w = 10, 128
    table, _ = _table(dev, n, w)
    gt.check_indices(dev)
    for bad in (torch.tensor([3, n, 4], dtype=torch.int32),
                torch.tensor([3, -1, 4], dtype=torch.int32),
                torch.tensor([3, 2 ** 32 + 4, 4], dtype=torch.int64)):   # no wrap-around
        out = gt.gather_byte_rows(table, bad.to(dev))
        assert torch.equal(out[0], table[3]) and torch.equal(out[2], table[4])
        assert not bool(out[1].any())
        with pytest.raises(IndexError, match="1 indices"):
            gt.check_indices(dev)
        gt.check_indices(dev)                        # the count starts over


def test_b4_wrapper_rejects_what_the_kernel_does_not_take(dev):
    table, _ = _table(dev, 10, 128)
    idx = torch.zeros(4, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        gt.gather_byte_rows(table.to(torch.uint8), idx)
    with pytest.raises(TypeError):
        gt.gather_byte_rows(table.view(10, 4, 256), idx)
    with pytest.raises(TypeError):
        gt.gather_byte_rows(table, idx.float())
    with pytest.raises(ValueError, match="idx on"):
        gt.gather_byte_rows(table, idx.cpu())
    with pytest.raises(ValueError, match="multiple of 16"):
        gt.gather_byte_rows(_table(dev, 10, 24)[0], idx)
    with pytest.raises(ValueError, match="contiguous"):
        gt.gather_byte_rows(_table(dev, 10, 256)[0][:, :, ::2], idx)
    with pytest.raises(ValueError, match="aligned"):
        gt.gather_byte_rows(_table(dev, 11, 136)[0].view(-1)[8:8 + 10 * 8 * 128]
                            .view(10, 8, 128), idx)
