"""The CUDA video-score kernels (B1-B3, csrc/video_score.cu) against
their plain PyTorch versions on the card, at edge shapes the full-corpus
check in chip_smoke.py does not reach: query and video counts off the
64 x 32 block tile, feature rows shorter than one 128-byte stage or with a
tail, lp = 8, and block maxima whose chunk is not a power of two or spans
several warps. Every test carries the ``cuda`` marker and skips (its
``dev`` fixture) without a CUDA card. Imports no JAX, so on a machine with
the card it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""
import math

import pytest
import torch

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
