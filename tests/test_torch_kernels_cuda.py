"""The CUDA kernels against their plain PyTorch versions on the card, at
edge shapes the full-size checks in chip_smoke.py do not reach.

Video scores (B1-B3, csrc/video_score.cu, all on wgmma: 128 queries x a
tile of whole videos; f32 rows past 1,024 bytes 64 queries): query and
video counts off the tiles (nq 1, 63, 65, 129, 130, 1,000), lp = 8 to 264
(a video over segments), d = 16 to the widest row of each type (int8 384,
bf16 512, f32 640), the streaming block and a shard's corpus, ties across
the videos of a tile, feature rows shorter than one 32-byte k-step or
with a tail, int8 bytes all +-127, f32 values exact in TF32 (bit-equal),
and block maxima whose chunk is not a power of two or spans several
tiles. Byte-row
gather (B4, csrc/gather.cu): one index to a thousand, rows of one to
nineteen 16 KiB segments, duplicate and boundary
indices, a strided and an int64 index tensor, an index outside the table.
Span similarity (B5, csrc/span_sim.cu, on wgmma): query counts on and off
the 64-query warpgroups and the 128-query tile, 1,000 queries, row counts
off the 256-row tile and not a multiple of 8 (8-byte stores instead of the
TMA store), K with a tail inside and past one 128-byte chunk, K = 16, 512
and past 512 (query chunks streamed), lp = 4 to 256, the engine's layout
at lp = 104 with rows ending inside a tile, bytes all +-127,
bit-equal. Sorting top-k (B6, csrc/topk_sort.cu): n one above
and one below a power of two, k = 1, k = n - 1, k = n, k >= n, rows of one
repeated value, ties across the cut with 0.0 and -0.0 mixed, the engine's
five shapes with 65-value ties, rows with fewer than k finite values, rows
past one launch's limit. Masked video
scores (B9, B10, csrc/masked_score.cu on wgmma: 128 queries x 128 videos a
tile; rows past 1,024 bytes 64 queries, f32 rows past 2,560 bytes 64
videos): query and video counts one off each tile, clip counts 1, 7, 8,
100, 129, D = 8 to 768 with a tail (72), 1,000 queries at L = 100,
fractional masks, fully masked videos exactly -1e10, the exp fused and
not, values exact in TF32 bit-equal in both layouts. Gathered similarity (B7, csrc/gathered_sim.cu): one
selected row, clip counts off the 8 warps, one to eight 16-byte pieces a
lane, indices outside the corpus. Banded top-N (B8, csrc/banded_topk.cu):
one query, one video, L = 128 with W = 16 and top_n = 256, top_n above the
span count, rows full of ties and masked tails, an all-equal joint (the
top_n lowest flat indices), negative values and 0.0 / -0.0, V = L = W = 1,
top_n = 1 and 256, 131 and 4,000 queries, rows past one chunk (V = 2,000),
unsorted video scores. Approximate top-k (B11, csrc/approx_topk.cu): the
engine's three sites at recall 0.9 and 0.99, M above one pass's 16,384 bins
(recall 1.0 at 21,818 and a bucketed 100,096), M = n (exact, equal to B6 in
value bits and indices, odd n among them), k = 1, k = M = 256, k above 256
(the shared-memory sort), rows of ties on the int8 score grid, one repeated
value, 0.0 / -0.0 and -inf pads, a strided and a bf16 input; the bin pass
on odd n (one bin a thread, 4-byte loads) beside the paired one, on rows
that start 4 bytes past an 8-byte boundary (a compacted x[:, 1:] and a
contiguous view one element in), on bins of 2 and 3-4 elements carried
across chunks, and on bins of more than 65,536 elements (32-bit steps).

Every test carries the ``cuda`` marker and skips (its ``dev`` fixture)
without a CUDA card. Imports no JAX, so on a machine with the card it runs
as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""
import math

import pytest
import torch

from tvretrieval_tpu_torch.ops import _build
from tvretrieval_tpu_torch.ops import approx_topk as apx
from tvretrieval_tpu_torch.ops import fused_score as fsc
from tvretrieval_tpu_torch.ops import gather as gt
from tvretrieval_tpu_torch.ops import sort as tsort
from tvretrieval_tpu_torch.ops import span as tspan
from tvretrieval_tpu_torch.ops import topk as ttopk
from tvretrieval_tpu_torch.ops import video_score as vs

F32_ATOL = 1e-5     # f32 summation order of unit-vector dots
# test_b9_masked_scores_close's video 1 where a whole clip is its max: the
# tensor cores' order (3xTF32 in f32) against the plain version read at most
# 3.6e-7 (f32) and 7.5e-8 (bf16) on an H100 at MASKED_SHAPES
WHOLE_CLIP_ATOL = 1e-6

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
    n0 = _build.LAUNCHES["video_scores_flat_i8"]
    out = vs.video_scores_flat_i8(qv, qs, fv, fs, nv, lp=lp)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["video_scores_flat_i8"] == n0 + 1
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


def _flat_i8(dev, nq, nv_pad, lp, d, seed, extremes=False):
    g = torch.Generator(device=dev).manual_seed(seed)
    draw = lambda *s: torch.randint(-127, 128, s, generator=g, device=dev, dtype=torch.int8)
    q = [draw(d, nq) for _ in range(2)]
    f = [draw(nv_pad * lp, d) for _ in range(2)]
    if extremes:                                    # every byte +-127
        q, f = ([torch.where(x >= 0, 127, -127).to(torch.int8) for x in xs] for xs in (q, f))
    return q[0], q[1], f[0], f[1]


@pytest.mark.parametrize("lp", [8, 104, 128, 256])
@pytest.mark.parametrize("nq", [1, 129])
def test_b1_b3_int8_off_the_query_tile(dev, nq, lp):
    """One query and one past the 128-query tile; lp from one n8 fragment
    a video to 32; 37 real videos of 40, off the 16-video tile."""
    nv, nv_pad, d = 37, 40, 256
    qv, qs, fv, fs = _flat_i8(dev, nq, nv_pad, lp, d, seed=nq + lp)
    out = vs.video_scores_flat_i8(qv, qs, fv, fs, nv, lp=lp)
    assert torch.equal(out, vs.video_scores_flat_plain(qv, qs, fv, fs, nv, lp))
    scores, bmax = vs.video_scores_flat_bmax(qv, qs, fv, fs, nv, lp=lp, chunk_v=8)
    ps, pb = vs.video_scores_flat_bmax_plain(qv, qs, fv, fs, nv, lp, 8)
    assert torch.equal(scores, ps) and torch.equal(bmax, pb)
    assert torch.equal(scores[:, :nv], out)


def test_b1_b3_int8_extremes(dev):
    """Every byte +-127 at D = 256: s32 dots up to 256 x 127^2 = 4,129,024,
    maxima of both signs, many equal dots."""
    nq, nv, lp, d = 200, 48, 104, 256
    qv, qs, fv, fs = _flat_i8(dev, nq, nv, lp, d, seed=7, extremes=True)
    out = vs.video_scores_flat_i8(qv, qs, fv, fs, nv, lp=lp)
    ref = vs.video_scores_flat_plain(qv, qs, fv, fs, nv, lp)
    assert torch.equal(out, ref)
    qv[:, 0] = fv[0]                                # query 0 is video 0's first row
    qs[:, 0] = fs[0]
    out = vs.video_scores_flat_i8(qv, qs, fv, fs, nv, lp=lp)
    top = torch.tensor(2 * d * 127 * 127, dtype=torch.float32) * vs.I8_SCALE
    assert out[0, 0].item() == top.item()          # the one f32 rescale of 8,258,048
    assert torch.equal(out, vs.video_scores_flat_plain(qv, qs, fv, fs, nv, lp))
    scores, bmax = vs.video_scores_flat_bmax(qv, qs, fv, fs, nv, lp=lp, chunk_v=16)
    ps, pb = vs.video_scores_flat_bmax_plain(qv, qs, fv, fs, nv, lp, 16)
    assert torch.equal(scores, ps) and torch.equal(bmax, pb)


def test_b1_b3_b6_at_the_end_to_end_int8_shapes(dev):
    """B1, B3-int8 and the psort video top-V (B6) at the end-to-end phase's
    shapes (100 queries, 320 videos: off the 128-query tile), 20 times over,
    every run bit-equal to the plain version (integer maxima, one f32
    rescale)."""
    nq, nv, lp, d = 100, 320, 104, 256
    qv, qs, fv, fs = _flat_i8(dev, nq, nv, lp, d, seed=4)
    ref = vs.video_scores_flat_plain(qv, qs, fv, fs, nv, lp)
    ps, pb = vs.video_scores_flat_bmax_plain(qv, qs, fv, fs, nv, lp, 16)
    pv, pi = tspan.topk_stable_blocked(ref, 100)
    for _ in range(20):
        out = vs.video_scores_flat_i8(qv, qs, fv, fs, nv, lp=lp)
        scores, bmax = vs.video_scores_flat_bmax(qv, qs, fv, fs, nv, lp=lp, chunk_v=16)
        kv, ki = tspan.topk_stable_blocked_psort(out, 100)
        torch.cuda.synchronize()
        assert torch.equal(out, ref) and torch.equal(scores, ps) and torch.equal(bmax, pb)
        assert torch.equal(kv, pv) and torch.equal(ki, pi)


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
    wide = _flat_i8(dev, 4, 16, 8, vs.I8_MAX_D + 16, seed=1)
    with pytest.raises(ValueError, match=str(vs.I8_MAX_D)):
        vs.video_scores_flat_i8(*wide, 16, lp=8)


@pytest.mark.parametrize("nq,nv,L,d,lp,chunk_v", SHAPES + [
    (70, 50, 20, 384, 24, 8),        # bf16 D = 384: three 128-byte K chunks a tile row
    (129, 33, 20, 256, 24, 16),      # D = 256; ten 24-row videos a 256-row tile (16 rows
                                     # unused); a query past the 128-query tile
])
def test_b2_b3_bf16_tensor_cores(dev, nq, nv, L, d, lp, chunk_v):
    """B2 and B3 in bf16 (the tensor-core instance) within F32_ATOL of
    their plain versions, pads -inf, block maxima the max of the kernel's
    own scores; one launch each."""
    qv, qs, fv, fs = _caches(dev, nq, nv, L, d, lp, chunk_v, torch.bfloat16, seed=d + lp)
    n2, n3 = _build.LAUNCHES["video_scores_flat"], _build.LAUNCHES["video_scores_flat_bmax"]
    out = vs.video_scores_flat(qv, qs, fv, fs, nv, lp=lp)
    scores, bmax = vs.video_scores_flat_bmax(qv, qs, fv, fs, nv, lp=lp, chunk_v=chunk_v)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["video_scores_flat"] == n2 + 1
    assert _build.LAUNCHES["video_scores_flat_bmax"] == n3 + 1
    ref = vs.video_scores_flat_plain(qv, qs, fv, fs, nv, lp)
    assert out.shape == ref.shape == (nq, nv)
    assert (out - ref).abs().max().item() <= F32_ATOL
    ps, _ = vs.video_scores_flat_bmax_plain(qv, qs, fv, fs, nv, lp, chunk_v)
    nv_pad = fv.shape[0] // lp
    chunk = math.gcd(nv_pad, chunk_v)
    assert torch.equal(scores[:, :nv], out)
    assert bool((scores[:, nv:] == -math.inf).all())
    assert (scores[:, :nv] - ps[:, :nv]).abs().max().item() <= F32_ATOL
    assert torch.equal(bmax, scores.view(nq, -1, chunk).amax(dim=2))


def test_b2_bf16_rejects_rows_past_the_tile(dev):
    wide = _caches(dev, 4, 4, 3, vs.BF16_MAX_D + 8, 8, 4, torch.bfloat16)
    with pytest.raises(ValueError, match=str(vs.BF16_MAX_D)):
        vs.video_scores_flat(*wide, 4, lp=8)
    assert vs.video_scores_flat(*(t.float() for t in wide), 4, lp=8).shape == (4, 4)


def _flat_tf32_exact(dev, nq, nv_pad, lp, d, seed):
    """Flat f32 caches and queries of small integers x 2^-4 (|x| <= 1/2):
    exact in TF32, so the split's low halves are zero, and every partial
    sum is a multiple of 2^-8 below 2^10, exact in f32 in any order."""
    g = torch.Generator(device=dev).manual_seed(seed)
    draw = lambda *s: torch.randint(-8, 9, s, generator=g, device=dev).float() / 16
    return draw(d, nq), draw(d, nq), draw(nv_pad * lp, d), draw(nv_pad * lp, d)


@pytest.mark.parametrize("nq,nv,nv_pad,lp,d", [
    (5, 7, 8, 8, 8), (70, 37, 40, 16, 64), (130, 48, 48, 104, 256), (65, 20, 24, 24, 384),
    (129, 20, 24, 16, 256), (63, 9, 9, 264, 256), (65, 6, 6, 128, 128), (3, 5, 5, 8, 640)])
def test_b2_b3_f32_fragment_layout_bit_equal(dev, nq, nv, nv_pad, lp, d):
    """The fragment-layout claim of csrc/s8_wgmma.cuh for the TF32 product
    with A from registers: on values exact in TF32 the kernel's sums are
    exact, so B2 and B3-f32 equal their plain versions bit for bit, which a
    wrong pairing of A and B elements (or rows and queries) would not."""
    qv, qs, fv, fs = _flat_tf32_exact(dev, nq, nv_pad, lp, d, seed=nq + d)
    n2, n3 = _build.LAUNCHES["video_scores_flat"], _build.LAUNCHES["video_scores_flat_bmax"]
    out = vs.video_scores_flat(qv, qs, fv, fs, nv, lp=lp)
    scores, bmax = vs.video_scores_flat_bmax(qv, qs, fv, fs, nv, lp=lp, chunk_v=8)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["video_scores_flat"] == n2 + 1
    assert _build.LAUNCHES["video_scores_flat_bmax"] == n3 + 1
    assert torch.equal(out, vs.video_scores_flat_plain(qv, qs, fv, fs, nv, lp))
    ps, pb = vs.video_scores_flat_bmax_plain(qv, qs, fv, fs, nv, lp, 8)
    assert torch.equal(scores, ps) and torch.equal(bmax, pb)


@pytest.mark.parametrize("nq,nv,L,d,lp,chunk_v", SHAPES + [
    (70, 50, 20, 384, 24, 8),        # f32 D = 384: the 64-query tile, twelve 128-byte K
                                     # chunks a tile row
    (65, 33, 20, 320, 24, 16),       # D = 320 (64-query tile); one query past it; five
                                     # 24-row videos a 128-row tile (8 rows unused)
    (129, 33, 20, 256, 24, 16),      # D = 256 (128-query tile); one query past it
    (127, 17, 9, 256, 104, 16),      # one query short of the tile; a video past 16
    (3, 5, 4, 640, 8, 4),            # the widest f32 row the kernel takes
])
def test_b2_b3_f32_tensor_cores(dev, nq, nv, L, d, lp, chunk_v):
    """B2 and B3 in f32 (3xTF32 on the tensor cores) within F32_ATOL of
    their plain versions on unit rows of full 24-bit mantissas, pads -inf,
    block maxima the max of the kernel's own scores; one launch each."""
    qv, qs, fv, fs = _caches(dev, nq, nv, L, d, lp, chunk_v, torch.float32, seed=d + lp + nq)
    n2, n3 = _build.LAUNCHES["video_scores_flat"], _build.LAUNCHES["video_scores_flat_bmax"]
    out = vs.video_scores_flat(qv, qs, fv, fs, nv, lp=lp)
    scores, bmax = vs.video_scores_flat_bmax(qv, qs, fv, fs, nv, lp=lp, chunk_v=chunk_v)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["video_scores_flat"] == n2 + 1
    assert _build.LAUNCHES["video_scores_flat_bmax"] == n3 + 1
    ref = vs.video_scores_flat_plain(qv, qs, fv, fs, nv, lp)
    assert out.shape == ref.shape == (nq, nv)
    assert (out - ref).abs().max().item() <= F32_ATOL
    nv_pad = fv.shape[0] // lp
    chunk = math.gcd(nv_pad, chunk_v)
    assert torch.equal(scores[:, :nv], out)
    assert bool((scores[:, nv:] == -math.inf).all())
    assert torch.equal(bmax, scores.view(nq, -1, chunk).amax(dim=2))


def test_b2_f32_rejects_rows_past_the_tile(dev):
    wide = _caches(dev, 4, 4, 3, vs.F32_MAX_D + 16, 8, 4, torch.float32)
    n0 = _build.LAUNCHES["video_scores_flat"]
    with pytest.raises(ValueError, match=str(vs.F32_MAX_D)):
        vs.video_scores_flat(*wide, 4, lp=8)
    assert _build.LAUNCHES["video_scores_flat"] == n0


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
    n0 = _build.LAUNCHES["gather_byte_rows"]
    out = gt.gather_byte_rows(table, idx)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["gather_byte_rows"] == n0 + 1
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



# nq, nv_pad, n_videos, lp, d, chunk_v: the wgmma kernel's edges. Query
# counts around its two 64-query warpgroups and its 128-query tile; lp = 8
# (32 videos a tile), 104 (the compile-time fold, 2 videos, N = 208), 128,
# 264 (a video over two 256-row segments); d = 16 (one K chunk, mostly
# TMA's zero fill), 256, 384 (three chunks); pad videos; the streaming
# block (50 x 2,048) and one of 4 shards of the engine's corpus
# (21,824 / 4 videos); chunks of 3, 7 and 16 videos across tile ranges.
WGMMA_B1_SHAPES = [
    (1, 40, 37, 8, 16, 8),
    (63, 33, 30, 104, 256, 16),
    (65, 20, 20, 128, 384, 4),
    (130, 9, 7, 264, 256, 3),
    (129, 7, 5, 16, 16, 7),
    (64, 17, 16, 104, 384, 16),
    (50, 2048, 2048, 104, 256, 16),
    (1000, 5456, 5450, 104, 256, 16),
]


@pytest.mark.parametrize("nq,nv_pad,n_videos,lp,d,chunk_v", WGMMA_B1_SHAPES)
def test_b1_b3_wgmma_edges_bit_equal(dev, nq, nv_pad, n_videos, lp, d, chunk_v):
    qv, qs, fv, fs = _flat_i8(dev, nq, nv_pad, lp, d, seed=nq + nv_pad + lp + d)
    n0 = _build.LAUNCHES["video_scores_flat_i8"]
    out = vs.video_scores_flat_i8(qv, qs, fv, fs, n_videos, lp=lp)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["video_scores_flat_i8"] == n0 + 1
    assert torch.equal(out, vs.video_scores_flat_plain(qv, qs, fv, fs, n_videos, lp))
    scores, bmax = vs.video_scores_flat_bmax(qv, qs, fv, fs, n_videos, lp=lp, chunk_v=chunk_v)
    ps, pb = vs.video_scores_flat_bmax_plain(qv, qs, fv, fs, n_videos, lp, chunk_v)
    assert torch.equal(scores, ps) and torch.equal(bmax, pb)


@pytest.mark.parametrize("lp", [8, 104, 128])
def test_b1_b3_wgmma_ties_across_the_videos_of_a_tile(dev, lp):
    """Every pair of neighbouring videos holds the same rows, so each
    query's maxima tie across the videos of a tile (and of a block)."""
    nq, nv_pad, d = 70, 24, 256
    qv, qs, fv, fs = _flat_i8(dev, nq, nv_pad, lp, d, seed=lp)
    for f in (fv, fs):
        f3 = f.view(nv_pad, lp, d)
        f3[1::2] = f3[0::2]
    out = vs.video_scores_flat_i8(qv, qs, fv, fs, nv_pad, lp=lp)
    assert torch.equal(out, vs.video_scores_flat_plain(qv, qs, fv, fs, nv_pad, lp))
    assert torch.equal(out[:, 0::2], out[:, 1::2])
    scores, bmax = vs.video_scores_flat_bmax(qv, qs, fv, fs, nv_pad, lp=lp, chunk_v=2)
    ps, pb = vs.video_scores_flat_bmax_plain(qv, qs, fv, fs, nv_pad, lp, 2)
    assert torch.equal(scores, ps) and torch.equal(bmax, pb)

# nq, nv_pad, n_videos, lp, d, chunk_v: the bf16 / f32 wgmma kernel's
# edges (d None: the widest row of the type, BF16_MAX_D / F32_MAX_D). Query
# counts around its warpgroups and its 128-query tile (64 for f32 rows past
# 1,024 bytes: D = 384, 512, 640); lp = 8 (bf16 32 / f32 16 videos a tile),
# 104 (the compile-time fold: bf16 N = 208 two videos, f32 N = 104 one), 128,
# 264 (a video over two / three segments); d = 16 (one 32-byte k-step, the
# rest TMA's zero fill), 256, 384; pad videos; the streaming block (50 x
# 2,048) and one of 4 shards of the engine's corpus (21,824 / 4 videos);
# chunks of 3, 7 and 16 videos across tile ranges.
WGMMA_B2_SHAPES = [
    (1, 40, 37, 8, 16, 8),
    (63, 33, 30, 104, 256, 16),
    (65, 20, 20, 128, 384, 4),
    (130, 9, 7, 264, 256, 3),
    (129, 7, 5, 16, 16, 7),
    (64, 17, 16, 104, 384, 16),
    (50, 2048, 2048, 104, 256, 16),
    (1000, 5456, 5450, 104, 256, 16),
    (3, 6, 5, 8, None, 2),
    (70, 12, 10, 24, None, 4),
]


def _flat_float(dev, nq, nv_pad, lp, d, dtype, seed):
    """Unit query and flat rows drawn in f32 (full 24-bit mantissas), cast."""
    g = torch.Generator(device=dev).manual_seed(seed)
    unit = lambda *s: torch.nn.functional.normalize(
        torch.randn(*s, generator=g, device=dev), dim=-1).to(dtype)
    return unit(nq, d).T, unit(nq, d).T, unit(nv_pad * lp, d), unit(nv_pad * lp, d)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("nq,nv_pad,n_videos,lp,d,chunk_v", WGMMA_B2_SHAPES)
def test_b2_b3_wgmma_edges_close(dev, dtype, nq, nv_pad, n_videos, lp, d, chunk_v):
    """B2 and B3 in bf16 / f32 within F32_ATOL of their plain versions, B3's
    scores equal to B2's, pads -inf, block maxima the max of the kernel's
    own scores; one launch each."""
    if d is None:
        d = vs.BF16_MAX_D if dtype == torch.bfloat16 else vs.F32_MAX_D
    qv, qs, fv, fs = _flat_float(dev, nq, nv_pad, lp, d, dtype, seed=nq + nv_pad + lp + d)
    n2, n3 = _build.LAUNCHES["video_scores_flat"], _build.LAUNCHES["video_scores_flat_bmax"]
    out = vs.video_scores_flat(qv, qs, fv, fs, n_videos, lp=lp)
    scores, bmax = vs.video_scores_flat_bmax(qv, qs, fv, fs, n_videos, lp=lp, chunk_v=chunk_v)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["video_scores_flat"] == n2 + 1
    assert _build.LAUNCHES["video_scores_flat_bmax"] == n3 + 1
    ref = vs.video_scores_flat_plain(qv, qs, fv, fs, n_videos, lp)
    assert out.shape == ref.shape == (nq, n_videos)
    assert (out - ref).abs().max().item() <= F32_ATOL
    chunk = math.gcd(nv_pad, chunk_v)
    assert scores.shape == (nq, nv_pad) and bmax.shape == (nq, nv_pad // chunk)
    assert torch.equal(scores[:, :n_videos], out)
    assert bool((scores[:, n_videos:] == -math.inf).all())
    assert torch.equal(bmax, scores.view(nq, -1, chunk).amax(dim=2))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("lp", [8, 104, 128])
def test_b2_b3_wgmma_ties_across_the_videos_of_a_tile(dev, dtype, lp):
    """Every pair of neighbouring videos holds the same rows, of values
    exact in bf16 and TF32 (sums exact in any order), so each query's
    maxima tie across the videos of a tile and the kernel equals its plain
    version bit for bit."""
    nq, nv_pad, d = 70, 24, 256
    qv, qs, fv, fs = (t.to(dtype) for t in _flat_tf32_exact(dev, nq, nv_pad, lp, d, seed=lp))
    for f in (fv, fs):
        f3 = f.view(nv_pad, lp, d)
        f3[1::2] = f3[0::2]
    out = vs.video_scores_flat(qv, qs, fv, fs, nv_pad, lp=lp)
    assert torch.equal(out, vs.video_scores_flat_plain(qv, qs, fv, fs, nv_pad, lp))
    assert torch.equal(out[:, 0::2], out[:, 1::2])
    scores, bmax = vs.video_scores_flat_bmax(qv, qs, fv, fs, nv_pad, lp=lp, chunk_v=2)
    ps, pb = vs.video_scores_flat_bmax_plain(qv, qs, fv, fs, nv_pad, lp, 2)
    assert torch.equal(scores, ps) and torch.equal(bmax, pb)


# ------------------------------------------------------------------ B5
@pytest.mark.parametrize("nq,nv,L,k,lp,chunk_v", [
    (1, 3, 7, 16, 8, 1),             # one query, 24 rows, one 16-byte piece of K
    (70, 37, 12, 32, 128, 8),        # queries and rows off the block tile
    (130, 16, 100, 512, 128, 16),    # the flagship row shape
    (65, 9, 20, 80, 24, 3),          # K = 80: a tail past one 64-byte stage
    (64, 5, 3, 64, 4, 1),            # lp = 4: 20 rows
    (33, 4, 100, 48, 256, 4),
])
def test_b5_span_sim_bit_equal(dev, nq, nv, L, k, lp, chunk_v):
    g = torch.Generator(device=dev).manual_seed(nq + nv)
    feat2 = torch.randn(nv, L, k, generator=g, device=dev) * 3.0
    feat2[nv // 2, L // 2] = 0.0                       # an all-zero row
    f8, fs = vs.build_flat_feat2_i8(feat2, lp=lp, chunk_v=chunk_v)
    q8, qs = vs.quantize_rows_i8(torch.randn(nq, k, generator=g, device=dev))
    n0 = _build.LAUNCHES["span_sim_cat_i8"]
    out = vs.span_sim_cat_i8(q8, qs[:, None], f8, fs, lp=lp)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["span_sim_cat_i8"] == n0 + 1
    ref = vs.span_sim_int8_xla(q8, qs[:, None], f8, fs, lp=lp)
    assert out.shape == ref.shape == (nq, f8.shape[0] // lp, lp) and out.dtype == torch.bfloat16
    assert torch.equal(out.view(torch.int16), ref.view(torch.int16))
    assert not out[:, :, L:].any() and not out[:, nv:].any()
    # extreme bytes: every product 127 * 127, the largest sum K * 127^2
    q8.fill_(127)
    f8[:lp].fill_(-127)
    out = vs.span_sim_cat_i8(q8, qs[:, None], f8, fs, lp=lp)
    ref = vs.span_sim_int8_xla(q8, qs[:, None], f8, fs, lp=lp)
    assert torch.equal(out.view(torch.int16), ref.view(torch.int16))


def _span_sim_case(dev, nq, nv, L, k, lp, chunk_v, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    feat2 = torch.randn(nv, L, k, generator=g, device=dev) * 3.0
    f8, fs = vs.build_flat_feat2_i8(feat2, lp=lp, chunk_v=chunk_v)
    q8, qs = vs.quantize_rows_i8(torch.randn(nq, k, generator=g, device=dev))
    return q8, qs[:, None].contiguous(), f8, fs


def _span_equal(q8, qs, f8, fs, lp):
    n0 = _build.LAUNCHES["span_sim_cat_i8"]
    out = vs.span_sim_cat_i8(q8, qs, f8, fs, lp=lp)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["span_sim_cat_i8"] == n0 + 1
    ref = vs.span_sim_int8_xla(q8, qs, f8, fs, lp=lp)
    assert out.shape == ref.shape == (q8.shape[0], f8.shape[0] // lp, lp)
    assert torch.equal(out.view(torch.int16), ref.view(torch.int16))
    return out


@pytest.mark.parametrize("lp", [4, 24, 104, 128])
@pytest.mark.parametrize("nq", [1, 63, 64, 65, 127, 129])
def test_b5_off_the_tiles(dev, nq, lp):
    """Query counts around the 64-query warp groups and the 128-query
    tile; 37 videos of lp rows: 148 rows (not a multiple of 8: 8-byte
    stores), 888, 3,848 and 4,736 (whole 128-row tiles); K = 144, one
    128-byte chunk and a 16-byte tail."""
    L = max(1, lp - 3)
    q8, qs, f8, fs = _span_sim_case(dev, nq, 37, L, 144, lp, 1, seed=nq * 1000 + lp)
    out = _span_equal(q8, qs, f8, fs, lp)
    assert not out[:, :, L:].any()


@pytest.mark.parametrize("k", [16, 48, 80, 512, 528, 1040])
def test_b5_k_axis_and_extremes(dev, k):
    """K from one 16-byte piece to past one chunk, 512 (the model's, the
    query tile resident), 528 and 1,040 (the query chunks streamed through
    the ring); then every byte +-127: dots up to K * 127^2, past 2^24 at
    K = 1,040, where the f32 conversion rounds."""
    nq, lp = 130, 24
    q8, qs, f8, fs = _span_sim_case(dev, nq, 13, 20, k, lp, 4, seed=k)
    _span_equal(q8, qs, f8, fs, lp)
    g = torch.Generator(device=dev).manual_seed(k + 1)
    sign = lambda *s: torch.where(torch.rand(*s, generator=g, device=dev) < 0.5, 127, -127)
    q8 = sign(*q8.shape).to(torch.int8)
    f8 = sign(*f8.shape).to(torch.int8)
    q8[0] = 127
    f8[:lp] = -127                                  # query 0 x video 0: -K * 127^2
    out = _span_equal(q8, qs, f8, fs, lp)
    assert out[0, 0, 0].item() < 0


@pytest.mark.parametrize("k", [16, 512, 528])
@pytest.mark.parametrize("nq,nv,lp", [
    (1, 3, 8),                 # 24 rows: one short 256-row tile
    (63, 37, 4),               # 148 rows: not a multiple of 8 (8-byte stores, no TMA store)
    (65, 21, 128),             # 2,688 rows: a tile past the last row
    (130, 9, 104),             # 936 rows; queries past the 128-query tile
    (1000, 16, 128)])          # the engine's query count
def test_b5_wgmma_edges_bit_equal(dev, nq, nv, lp, k):
    """B5 on wgmma: K = 16 (one chunk, mostly TMA's zero fill), 512 (the
    model's: the query tile resident) and 528 (query chunks streamed through
    the ring), on and off its 256-row tiles and 64-query warpgroups."""
    q8, qs, f8, fs = _span_sim_case(dev, nq, nv, max(1, lp - 3), k, lp, 1, seed=nq + nv + k)
    _span_equal(q8, qs, f8, fs, lp)


@pytest.mark.parametrize("k", [512, 528])
@pytest.mark.parametrize("nq", [100, 1000])
@pytest.mark.parametrize("lp", [104, 128, 16, 40])
def test_b5_layouts_bit_equal(dev, lp, nq, k):
    """The engine's layout at L = 100 (lp = flat_lp(L) = 104: 256-row
    tiles that cut videos), the JAX package's (128: two videos a tile), 16
    (sixteen) and 40 (cut videos); 21 videos, so the rows end inside a
    tile, L = lp - 4 clips; query counts off the 64-query warpgroups; the
    query tile resident and streamed."""
    L = lp - 4
    q8, qs, f8, fs = _span_sim_case(dev, nq, 21, L, k, lp, 1, seed=lp * nq + k)
    out = _span_equal(q8, qs, f8, fs, lp)
    assert not out[:, :, L:].any() and out[:, :, :L].any()


def test_b5_wrapper_rejects_what_the_kernel_does_not_take(dev):
    q8 = torch.zeros(2, 16, dtype=torch.int8, device=dev)
    qs = torch.ones(2, 1, device=dev)
    f8 = torch.zeros(4 * 8, 16, dtype=torch.int8, device=dev)
    fs = torch.ones(4, 8, device=dev)
    assert vs.span_sim_cat_i8(q8, qs, f8, fs, lp=8).shape == (2, 4, 8)
    with pytest.raises(ValueError, match="multiple of 4"):
        vs.span_sim_cat_i8(q8, qs, f8[:4 * 6], fs[:, :6].contiguous(), lp=6)
    with pytest.raises(ValueError, match="multiple of 16"):
        vs.span_sim_cat_i8(q8[:, :8].contiguous(), qs, f8[:, :8].contiguous(), fs, lp=8)
    with pytest.raises(ValueError, match="contiguous"):
        vs.span_sim_cat_i8(q8, qs, torch.zeros(32, 32, dtype=torch.int8, device=dev)[:, ::2],
                           fs, lp=8)
    with pytest.raises(ValueError, match="one CUDA device"):
        vs.span_sim_cat_i8(q8.cpu(), qs.cpu(), f8, fs, lp=8)
    with pytest.raises(TypeError):
        vs.span_sim_cat_i8(q8.float(), qs, f8, fs, lp=8)


# ------------------------------------------------------------------ B6
def _rows(dev, nq, n, seed, ties):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.rand(nq, n, generator=g, device=dev)
    return torch.round(x * 4) / 4 if ties else x      # ties: 5 values, exact zeros


def _same(x, k):
    n0 = _build.LAUNCHES["topk_transposed"]
    kv, ki = tsort.topk_transposed(x, k)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["topk_transposed"] > n0
    pv, pi = tsort.topk_transposed_plain(x, k)
    assert kv.dtype == torch.float32 and ki.dtype == torch.int32
    assert kv.shape == ki.shape == (x.shape[0], min(k, x.shape[1]))
    assert torch.equal(kv, pv) and torch.equal(ki, pi)
    return kv, ki


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("n,k", [
    (1, 1), (2, 1), (17, 2), (31, 30), (33, 32), (129, 100), (127, 126), (1024, 200),
    (1025, 1024), (1364, 100), (2800, 200), (4095, 7), (4097, 200), (9000, 300),
    (16384, 100), (64, 64), (40, 100)])
def test_b6_topk_equals_plain(dev, n, k, ties):
    _same(_rows(dev, 37, n, n + k, ties), k)


def test_b6_equal_rows_and_rows_short_of_finite_values(dev):
    x = torch.full((5, 300), -math.inf, device=dev)
    x[0, [3, 7, 250]] = torch.tensor([1.0, 1.0, 2.0], device=dev)
    x[1] = 0.25                                       # all equal: index order
    x[2, 299] = -0.0
    x[3, ::7] = 0.0
    _, ki = _same(x, 120)
    assert ki[0, :5].tolist() == [250, 3, 7, 0, 1] and ki[1, :4].tolist() == [0, 1, 2, 3]
    _same(x.to(torch.bfloat16), 50)                   # the wrapper widens to f32
    _same(x[:, ::2], 50)                              # and compacts a strided row


@pytest.mark.parametrize("n,k", [(7, 3), (300, 120), (1364, 100), (2800, 200), (5000, 1000)])
def test_b6_ties_across_the_cut_with_signed_zeros(dev, n, k):
    """The k-th value is 0.0 and more zeros, of both signs, than the cut
    keeps: the first of them in index order are kept, -0.0 tying with 0.0."""
    g = torch.Generator(device=dev).manual_seed(n)
    x = -torch.rand(4, n, generator=g, device=dev) - 0.5
    above = k // 3
    x[:, :above] = torch.rand(4, above, generator=g, device=dev) + 0.5
    zeros = torch.randperm(n - above, generator=g, device=dev)[:k] + above
    x[:, zeros] = 0.0
    x[:, zeros[::2]] = -0.0
    x = x[:, torch.randperm(n, generator=g, device=dev)].contiguous()
    kv, ki = _same(x, k)
    assert int((kv == 0.0).sum(1).min()) >= 1 and int((x == 0.0).sum(1).min()) > k - above
    assert bool(torch.signbit(x).gather(1, ki.long()).eq(torch.signbit(kv)).all())


@pytest.mark.parametrize("value", [0.25, -0.0, -math.inf, 3e38])
@pytest.mark.parametrize("n,k", [(1, 1), (100, 1), (2800, 200), (4096, 4096), (16384, 300)])
def test_b6_rows_of_one_repeated_value(dev, value, n, k):
    _, ki = _same(torch.full((3, n), value, device=dev), k)
    assert torch.equal(ki, torch.arange(k, device=dev, dtype=torch.int32).expand(3, k))


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("n", [1, 2, 33, 256, 257, 1600, 9000])
def test_b6_k_one_and_k_n(dev, n, ties):
    x = _rows(dev, 9, n, 3 * n, ties)
    _same(x, 1)
    _same(x, n)


@pytest.mark.parametrize("n,k", [(1364, 100), (1600, 100), (1250, 200), (1600, 200),
                                 (2800, 200)])
def test_b6_engine_shapes_with_65_value_ties(dev, n, k):
    g = torch.Generator(device=dev).manual_seed(n + k)
    x = torch.round(torch.rand((1000, n), generator=g, device=dev) * 64) / 64
    _same(x, k)


@pytest.mark.parametrize("n,k", [(16385, 100), (40000, 200), (70000, 8192)])
def test_b6_rows_longer_than_one_launch(dev, n, k):
    """Chunks of MAX_ROW, then a second launch over the survivors."""
    x = _rows(dev, 3, n, n, True)
    x[0, n - 5:] = -math.inf
    n0 = _build.LAUNCHES["topk_transposed"]
    _same(x, k)
    assert _build.LAUNCHES["topk_transposed"] >= n0 + 2
    with pytest.raises(ValueError, match=str(tsort.MAX_ROW // 2)):
        tsort.topk_transposed(x, tsort.MAX_ROW // 2 + 1)


def test_b6_psort_span_ops_equal_the_plain_selections(dev):
    from tvretrieval_tpu_torch.ops import span as ts
    x = _rows(dev, 50, 21818, 1, True)
    n0 = _build.LAUNCHES["topk_transposed"]
    kv, ki = ts.topk_stable_blocked_psort(x, 100, block=16)
    assert _build.LAUNCHES["topk_transposed"] == n0 + 2
    pv, pi = ts.topk_stable_blocked(x, 100, block=16)
    assert torch.equal(kv, pv) and torch.equal(ki, pi)
    g = torch.Generator(device=dev).manual_seed(2)
    st, ed = (torch.softmax(torch.round(torch.randn(20, 100, 100, generator=g, device=dev)), -1)
              for _ in range(2))
    vsc = torch.exp(torch.round(torch.rand(20, 100, generator=g, device=dev) * 8) / 4)
    keep = (torch.rand(20, 100, generator=g, device=dev) < 0.7).float()
    for km in (None, keep):
        n0 = _build.LAUNCHES["topk_transposed"]
        a = ts.banded_topk_spans_grouped_shift_psort(st, ed, vsc, 2, 16, 200, keep_mask=km)
        assert _build.LAUNCHES["topk_transposed"] == n0 + 3
        b = ts.banded_topk_spans_grouped_shift(st, ed, vsc, 2, 16, 200, keep_mask=km)
        for u, v in zip(a, b):
            assert torch.equal(u, v)


# ------------------------------------------------------------- B9, B10
def _masked_case(dev, nq, nv, L, d, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    unit = lambda *s: torch.nn.functional.normalize(
        torch.randn(*s, generator=g, device=dev), dim=-1).to(dtype)
    lengths = torch.randint(1, L + 1, (nv,), generator=g, device=dev)
    mask = (torch.arange(L, device=dev)[None] < lengths[:, None]).float()
    mask[nv // 2] = 0.0                                # a fully masked video
    if nv > 2:
        mask[1, 0] = 0.25                              # a fractional mask value
    return unit(nq, d), unit(nq, d), unit(nv, L, d), unit(nv, L, d), mask


MASKED_SHAPES = [  # nq, nv, L, d
    (1, 1, 1, 8), (3, 5, 7, 16), (70, 33, 12, 64), (130, 100, 100, 256), (65, 40, 20, 72)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nq,nv,L,d", MASKED_SHAPES)
def test_b9_masked_scores_close(dev, dtype, nq, nv, L, d):
    qv, qs, fv, fs, mask = _masked_case(dev, nq, nv, L, d, dtype, nq + nv)
    n0 = _build.LAUNCHES["video_scores_masked"]
    out = vs.video_scores_masked(qv, qs, fv, fs, mask)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["video_scores_masked"] == n0 + 1
    ref = vs.video_scores_xla(qv, qs, fv, fs, mask)
    assert out.shape == ref.shape == (nq, nv) and out.dtype == torch.float32
    assert bool((out[:, nv // 2] == -1e10).all())
    live = torch.arange(nv, device=dev) != nv // 2
    # the -1e10 * 0.75 term of video 1's fractional clip rounds at 2^10, so
    # where that clip is video 1's only one its score is held to 1e-6
    # relative; where a whole clip follows, that clip is the max, a plain
    # dot, held to WHOLE_CLIP_ATOL
    if nv > 2:
        live[1] = False
        if bool(mask[1, 1:].any()):
            assert (out[:, 1] - ref[:, 1]).abs().max().item() <= WHOLE_CLIP_ATOL
        else:
            assert torch.allclose(out[:, 1], ref[:, 1], rtol=1e-6, atol=0)
    assert (out[:, live] - ref[:, live]).abs().max().item() <= F32_ATOL if live.any() else True


@pytest.mark.parametrize("alpha", [None, 20.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nq,nv,L,d", MASKED_SHAPES)
def test_b10_fused_scores_close(dev, dtype, alpha, nq, nv, L, d):
    q, _, f, _, mask = _masked_case(dev, nq, nv, L, d, dtype, nq + nv + 1)
    mask = (mask > 0.5).float()
    n0 = _build.LAUNCHES["fused_video_scores_clip_major"]
    out = fsc.fused_video_scores(q, f, mask, alpha)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fused_video_scores_clip_major"] == n0 + 1
    ref = fsc.fused_video_scores_xla(q, f, mask, alpha)
    assert out.shape == ref.shape == (nq, nv)
    if alpha is None:
        assert bool((out[:, nv // 2] == -1e10).all())
        assert (out - ref).abs().max().item() <= F32_ATOL
    else:
        assert bool((out[:, nv // 2] == 0).all())
        # exp(20 s) turns the 1e-5 slack of s into 2e-4 relative
        assert torch.allclose(out, ref, rtol=3e-4, atol=0)


def _masked_mixed(dev, nq, nv, L, d, dtype, seed):
    """Unit rows, prefix masks with fractional values among the valid
    clips, video 0 fully masked and (nv > 2) video 1 fractional at every
    clip. Returns the case and, per video, whether some clip has m = 1."""
    g = torch.Generator(device=dev).manual_seed(seed)
    unit = lambda *s: torch.nn.functional.normalize(
        torch.randn(*s, generator=g, device=dev), dim=-1).to(dtype)
    lengths = torch.randint(1, L + 1, (nv,), generator=g, device=dev)
    mask = (torch.arange(L, device=dev)[None] < lengths[:, None]).float()
    frac = torch.rand((nv, L), generator=g, device=dev)
    mask = torch.where(frac < 0.2, mask * frac * 5, mask)
    mask[0] = 0.0
    if nv > 2:
        mask[1] = 0.5
    return unit(nq, d), unit(nq, d), unit(nv, L, d), unit(nv, L, d), mask, (mask == 1).any(1)


def _check_masked(out, ref, mask, full, tol=F32_ATOL, masked=-1e10):
    """Exactly ``masked`` at fully masked videos; within ``tol`` where a
    clip is whole; the -1e10 * (1 - m) terms of videos with only
    fractional clips round at ~2^10, so those to 1e-6 relative."""
    dead = ~(mask > 0).any(1)
    assert bool((out[:, dead] == masked).all())
    if full.any():
        assert (out[:, full] - ref[:, full]).abs().max().item() <= tol
    part = ~full & ~dead
    if part.any():
        assert torch.allclose(out[:, part], ref[:, part], rtol=1e-6, atol=0)


@pytest.mark.parametrize("d", [72, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", [1, 7, 8, 100, 129])
def test_b9_b10_tensor_cores_clip_counts(dev, L, dtype, d):
    """B9 (video-major caches, two streams) and B10 (clip-major, one
    stream, exp fused and not) on the tensor cores: clip counts on and off
    8, 67 videos (a part of one 128-video tile), 65 queries (off the
    64-query warpgroup), D with a tail past a 128-byte chunk (72) and the
    model's width (256), fractional and all-zero masks; one launch each."""
    nq, nv = 65, 67
    qv, qs, fv, fs, mask, full = _masked_mixed(dev, nq, nv, L, d, dtype, seed=L + d)
    n9 = _build.LAUNCHES["video_scores_masked"]
    out = vs.video_scores_masked(qv, qs, fv, fs, mask)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["video_scores_masked"] == n9 + 1
    assert out.shape == (nq, nv) and out.dtype == torch.float32
    _check_masked(out, vs.video_scores_xla(qv, qs, fv, fs, mask), mask, full)
    fv_t, mask_t = fv.transpose(0, 1).contiguous(), mask.T[:, None, :].contiguous()
    for alpha in (None, 20.0):
        n10 = _build.LAUNCHES["fused_video_scores_clip_major"]
        out = fsc.fused_video_scores_clip_major(qv, fv_t, mask_t, alpha)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["fused_video_scores_clip_major"] == n10 + 1
        ref = fsc.fused_video_scores_xla(qv, fv, mask, alpha)
        if alpha is None:
            _check_masked(out, ref, mask, full)
        else:
            # exp(20 s) turns the 1e-5 slack of s into 2e-4 relative
            assert bool((out[:, ~(mask > 0).any(1)] == 0).all())
            assert torch.allclose(out, ref, rtol=3e-4, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b9_b10_tf32_exact_values_bit_equal(dev, dtype):
    """On values exact in TF32 (and bf16) with a 0/1 mask the masked
    kernels' sums are exact: B9 and B10 equal their plain versions bit for
    bit, both layouts."""
    g = torch.Generator(device=dev).manual_seed(11)
    nq, nv, L, d = 70, 67, 9, 64
    draw = lambda *s: (torch.randint(-8, 9, s, generator=g, device=dev).float() / 16).to(dtype)
    qv, qs, fv, fs = draw(nq, d), draw(nq, d), draw(nv, L, d), draw(nv, L, d)
    mask = (torch.rand((nv, L), generator=g, device=dev) < 0.7).float()
    mask[3] = 0.0
    n9 = _build.LAUNCHES["video_scores_masked"]
    n10 = _build.LAUNCHES["fused_video_scores_clip_major"]
    assert torch.equal(vs.video_scores_masked(qv, qs, fv, fs, mask),
                       vs.video_scores_xla(qv, qs, fv, fs, mask))
    out = fsc.fused_video_scores(qv, fv, mask)
    assert torch.equal(out, fsc.fused_video_scores_xla(qv, fv, mask))
    assert bool((out[:, 3] == -1e10).all())
    assert _build.LAUNCHES["video_scores_masked"] == n9 + 1
    assert _build.LAUNCHES["fused_video_scores_clip_major"] == n10 + 1


WGMMA_MASKED_SHAPES = [  # nq, nv, L, d
    (127, 127, 5, 256), (129, 129, 5, 256), (128, 128, 3, 256),  # the 128 x 128 tile +-1
    (63, 63, 4, 768), (65, 65, 4, 768), (64, 64, 2, 768),       # the 64-query tile, f32 N = 64
    (65, 129, 3, 384), (130, 127, 3, 512), (1, 1, 7, 768),
    (1000, 300, 100, 256)]                                       # the full query batch and L


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nq,nv,L,d", WGMMA_MASKED_SHAPES)
def test_b9_b10_wgmma_tiles_edges(dev, dtype, nq, nv, L, d):
    """B9 and B10 (exp fused and not) on the wgmma kernel's edges: query
    and video counts one off the 128 x 128 tile and the 64-query tile of
    rows past 1,024 bytes, f32 rows past 2,560 bytes on 64-video tiles,
    D = 384 / 512 / 768 in both kinds, and 1,000 queries at L = 100 on a
    slice of the corpus; fractional and all-zero masks."""
    qv, qs, fv, fs, mask, full = _masked_mixed(dev, nq, nv, L, d, dtype, seed=nq + nv + L + d)
    n9 = _build.LAUNCHES["video_scores_masked"]
    out = vs.video_scores_masked(qv, qs, fv, fs, mask)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["video_scores_masked"] == n9 + 1
    assert out.shape == (nq, nv) and out.dtype == torch.float32
    _check_masked(out, vs.video_scores_xla(qv, qs, fv, fs, mask), mask, full)
    fv_t, mask_t = fv.transpose(0, 1).contiguous(), mask.T[:, None, :].contiguous()
    for alpha in (None, 20.0):
        n10 = _build.LAUNCHES["fused_video_scores_clip_major"]
        out = fsc.fused_video_scores_clip_major(qv, fv_t, mask_t, alpha)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["fused_video_scores_clip_major"] == n10 + 1
        ref = fsc.fused_video_scores_xla(qv, fv, mask, alpha)
        if alpha is None:
            _check_masked(out, ref, mask, full)
        else:
            assert bool((out[:, ~(mask > 0).any(1)] == 0).all())
            assert torch.allclose(out, ref, rtol=3e-4, atol=0)


def test_b9_b10_wrappers_reject_what_the_kernel_does_not_take(dev):
    qv, qs, fv, fs, mask = _masked_case(dev, 4, 6, 5, 16, torch.float32, 0)
    with pytest.raises(TypeError):
        vs.video_scores_masked(qv.bfloat16(), qs, fv, fs, mask)
    with pytest.raises(TypeError):
        vs.video_scores_masked(qv.half(), qs.half(), fv.half(), fs.half(), mask)
    with pytest.raises(ValueError, match="mask"):
        vs.video_scores_masked(qv, qs, fv, fs, mask[:, :4])
    with pytest.raises(ValueError, match="one CUDA device"):
        vs.video_scores_masked(qv.cpu(), qs, fv, fs, mask)
    with pytest.raises(ValueError, match="contiguous"):
        vs.video_scores_masked(qv, qs, fv.transpose(0, 1).contiguous().transpose(0, 1), fs, mask)
    q6, s6, f6, g6, m6 = _masked_case(dev, 4, 6, 5, 6, torch.float32, 0)   # 24-byte rows
    with pytest.raises(ValueError, match="multiple of 16"):
        vs.video_scores_masked(q6, s6, f6, g6, m6)
    with pytest.raises(ValueError, match=r"\(L, 1, Nv\)"):
        fsc.fused_video_scores_clip_major(qv, fv.transpose(0, 1).contiguous(), mask.T.contiguous())
    wide = _masked_case(dev, 4, 6, 5, vs.MASKED_MAX_D + 8, torch.float32, 0)
    with pytest.raises(ValueError, match=str(vs.MASKED_MAX_D)):
        vs.video_scores_masked(*wide)


# ------------------------------------------------------------------ B7
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,L,nq,v1,d", [
    (17, 16, 5, 7, 128), (40, 24, 9, 12, 128),     # the shapes of the JAX kernel's test
    (3, 1, 1, 1, 8),                                # one row, one clip, one piece
    (50, 100, 33, 101, 256),                        # the engine's row shape
    (9, 13, 4, 3, 24),                              # L and D the TPU kernel refuses
    (6, 10, 3, 5, 520), (5, 9, 2, 4, 1024)])        # two to eight pieces a lane
def test_b7_gathered_similarity_close(dev, dtype, n, L, nq, v1, d):
    g = torch.Generator(device=dev).manual_seed(n + nq)
    vf2, sf2 = (torch.randn(n, L, d, generator=g, device=dev).to(dtype) for _ in range(2))
    vq, sq = (torch.randn(nq, d, generator=g, device=dev) for _ in range(2))
    idx = torch.randint(0, n, (nq, v1), generator=g, device=dev, dtype=torch.int32)
    idx[0, 0] = n - 1
    n0 = _build.LAUNCHES["gathered_similarity"]
    out = gt.gathered_similarity(vq, sq, vf2, sf2, idx)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["gathered_similarity"] == n0 + 1
    ref = gt.gathered_similarity_plain(vq, sq, vf2, sf2, idx)
    assert out.shape == ref.shape == (nq, v1, L) and out.dtype == torch.float32
    assert ((out - ref).abs().max() / ref.abs().max()).item() <= 1e-5
    assert torch.equal(gt.gathered_similarity(vq, sq, vf2, sf2, idx.long()), out)
    gt.check_indices(dev)


def test_b7_reports_an_index_outside_the_corpus_and_guards(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    vf2, sf2 = (torch.randn(6, 5, 16, generator=g, device=dev) for _ in range(2))
    q = torch.randn(2, 16, generator=g, device=dev)
    gt.check_indices(dev)
    idx = torch.tensor([[0, 6, 2], [-1, 5, 2 ** 33]], device=dev)
    out = gt.gathered_similarity(q, q, vf2, sf2, idx)
    ok = gt.gathered_similarity_plain(q, q, vf2, sf2, idx.clamp(0, 5))
    good = torch.tensor([[True, False, True], [False, True, False]], device=dev)
    assert torch.allclose(out[good], ok[good], atol=1e-5) and not bool(out[~good].any())
    with pytest.raises(IndexError, match="3 indices"):
        gt.check_indices(dev)
    with pytest.raises(ValueError, match="multiple of 16"):
        gt.gathered_similarity(q[:, :6], q[:, :6], vf2[..., :6].contiguous(),
                               sf2[..., :6].contiguous(), idx)
    with pytest.raises(ValueError, match="contiguous"):
        gt.gathered_similarity(q[:, :8], q[:, :8], vf2[..., ::2], sf2[..., ::2], idx)
    with pytest.raises(ValueError, match="one CUDA device"):
        gt.gathered_similarity(q, q, vf2, sf2, idx.cpu())
    with pytest.raises(TypeError):
        gt.gathered_similarity(q, q, vf2, sf2, idx.float())


# ------------------------------------------------------------------ B8
def _span_case(dev, nq, v, L, seed, masked_tail=0, levels=0, peaked=False):
    g = torch.Generator(device=dev).manual_seed(seed)
    st, ed = (torch.rand(nq, v, L, generator=g, device=dev) for _ in range(2))
    if peaked:
        st, ed = torch.softmax(st * 40, -1), torch.softmax(ed * 40, -1)
    if masked_tail:
        st[..., L - masked_tail:] = 0.0
        ed[..., L - masked_tail:] = 0.0
    if levels:
        st, ed = torch.round(st * levels) / levels, torch.round(ed * levels) / levels
    vsc = torch.exp(4.0 * torch.rand(nq, v, generator=g, device=dev))
    return st, ed, torch.sort(vsc, dim=1, descending=True).values


@pytest.mark.parametrize("nq,v,L,min_l,max_l,top_n,kw", [
    (3, 9, 20, 1, 7, 50, {}),
    (2, 5, 33, 2, 16, 200, {}),
    (2, 6, 20, 1, 9, 64, {"masked_tail": 8}),
    (2, 7, 16, 1, 5, 100, {"levels": 2}),
    (1, 3, 10, 2, 6, 120, {}),                      # top_n above the positive span count
    (1, 1, 4, 1, 3, 200, {}),                       # top_n above the band's element count
    (2, 4, 128, 2, 18, 256, {}),                    # L = 128, W = 16, top_n = 256
    (37, 100, 100, 2, 16, 200, {}),                 # the engine's shape, near-uniform
    (37, 100, 100, 2, 16, 200, {"peaked": True}),
    (37, 100, 100, 2, 16, 200, {"levels": 4, "masked_tail": 30}),
    (5, 100, 100, 0, 16, 1, {}),                    # min_l = 0, top_n = 1
])
def test_b8_banded_topk_equals_plain(dev, nq, v, L, min_l, max_l, top_n, kw):
    st, ed, vsc = _span_case(dev, nq, v, L, nq * 100 + v, **kw)
    n0 = _build.LAUNCHES["banded_topk_spans_fused"]
    got = ttopk.banded_topk_spans_fused(st, ed, vsc, min_l, max_l, top_n, return_sorted=True)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["banded_topk_spans_fused"] == n0 + 1
    ref = tspan.banded_topk_spans(st, ed, vsc, min_l, max_l, top_n)
    for name, r, k in zip(("vid", "st", "ed", "scores"), ref, got):
        assert k.shape == (nq, top_n) and k.dtype == r.dtype, name
        assert torch.equal(k, r), name
    assert got[4].shape == (nq,) and bool(((got[4] >= 1) & (got[4] <= v)).all())


def test_b8_unsorted_video_scores_and_limits(dev):
    """Descending video scores matter for speed only; the limits raise."""
    st, ed, vsc = _span_case(dev, 4, 30, 50, 1)
    vsc = vsc.flip(1).contiguous()
    got = ttopk.banded_topk_spans_fused(st, ed, vsc, 2, 16, 200)
    for r, k in zip(tspan.banded_topk_spans(st, ed, vsc, 2, 16, 200), got):
        assert torch.equal(k, r)
    with pytest.raises(ValueError, match="kernel limits"):
        ttopk.banded_topk_spans_fused(st, ed, vsc, 1, 18 + 1, 50)
    with pytest.raises(ValueError, match="kernel limits"):
        ttopk.banded_topk_spans_fused(st, ed, vsc, 2, 16, 257)
    with pytest.raises(ValueError, match="one CUDA device"):
        ttopk.banded_topk_spans_fused(st, ed, vsc.cpu(), 2, 16, 50)


def _b8_case(dev, kind, nq, v, L, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    st, ed = (torch.rand(nq, v, L, generator=g, device=dev) for _ in range(2))
    vsc = torch.exp(4.0 * torch.rand(nq, v, generator=g, device=dev))
    if kind == "all_equal":
        st = torch.zeros_like(st)                       # every joint element 0.0
    elif kind == "negative":
        st = st - 0.5
        vsc = vsc * torch.where(torch.rand(nq, v, generator=g, device=dev) < 0.3, -1.0, 1.0)
    elif kind == "signed_zeros":
        # few positive values: the selection reaches zeros of both signs
        st = torch.round(st * 2) / 2 - 0.5
        ed = torch.where(torch.rand(nq, v, L, generator=g, device=dev) < 0.9, -0.0, ed)
        vsc = vsc * torch.where(torch.rand(nq, v, generator=g, device=dev) < 0.5, -1.0, 1.0)
    return st, ed, vsc          # video scores unsorted


@pytest.mark.parametrize("kind,nq,v,L,min_l,max_l,top_n", [
    ("all_equal", 3, 100, 100, 2, 16, 200),
    ("all_equal", 2, 30, 128, 2, 18, 256),
    ("negative", 3, 40, 60, 1, 9, 150),
    ("signed_zeros", 3, 20, 50, 1, 7, 256),
    ("uniform", 5, 1, 1, 0, 1, 1),                  # V = L = W = 1
    ("uniform", 2, 1, 1, 0, 1, 256),
    ("uniform", 1, 100, 100, 2, 16, 1),             # Nq = 1, top_n = 1
    ("uniform", 131, 100, 100, 2, 16, 256),
    ("uniform", 4000, 50, 100, 2, 16, 200),         # more than a wave of blocks
    ("uniform", 2, 2000, 128, 2, 18, 256),          # 16 chunks of rows
    ("all_equal", 2, 2000, 128, 2, 18, 200),
    ("negative", 2, 300, 100, 2, 16, 100),          # two chunks
])
def test_b8_banded_topk_edges_equal_plain(dev, kind, nq, v, L, min_l, max_l, top_n):
    st, ed, vsc = _b8_case(dev, kind, nq, v, L, nq + v + L)
    n0 = _build.LAUNCHES["banded_topk_spans_fused"]
    got = ttopk.banded_topk_spans_fused(st, ed, vsc, min_l, max_l, top_n, return_sorted=True)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["banded_topk_spans_fused"] == n0 + 1
    for i in range(0, nq, 500):                     # the plain version materializes the joint
        ref = tspan.banded_topk_spans(st[i:i + 500], ed[i:i + 500], vsc[i:i + 500], min_l,
                                      max_l, top_n)
        for name, r, k in zip(("vid", "st", "ed", "scores"), ref, got):
            assert torch.equal(k[i:i + 500], r), name
    assert bool(((got[4] >= 1) & (got[4] <= v)).all())
    if kind == "all_equal":                         # the top_n lowest flat indices
        W = max_l - min_l
        flat = (got[0] * L + got[1]) * W + got[2] - got[1] - min_l
        assert torch.equal(flat, torch.arange(top_n, device=dev, dtype=flat.dtype)
                           .expand(nq, -1))


def _b11_same(x, k, recall):
    n0 = _build.LAUNCHES["approx_max_k"]
    kv, ki = apx.approx_max_k(x, k, recall)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["approx_max_k"] == n0 + 1
    pv, pi = apx.approx_max_k_plain(x, k, recall)
    assert kv.dtype == torch.float32 and ki.dtype == torch.int32 and kv.shape == (x.shape[0], k)
    assert torch.equal(ki, pi) and torch.equal(kv.view(torch.int32), pv.view(torch.int32))
    return kv, ki


def _b11_rows(dev, kind, nq, n, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    if kind == "normal":
        return torch.randn((nq, n), generator=g, device=dev)
    if kind == "int8_grid":
        # q2c on the int8 grid (0.5 / 127^2): ties everywhere, and at the cut
        return torch.randint(0, 2000, (nq, n), generator=g, device=dev).float() * (0.5 / 127 ** 2)
    if kind == "equal":
        return torch.full((nq, n), 0.375, device=dev)
    # "pads": signed zeros and -inf tails
    x = torch.round(torch.randn((nq, n), generator=g, device=dev) * 2)
    x[x == 0] = -0.0
    x[torch.rand((nq, n), generator=g, device=dev) < 0.2] = 0.0
    x[:, n // 2:] = -math.inf
    x[0] = -math.inf
    return x


@pytest.mark.parametrize("kind", ["normal", "int8_grid", "equal", "pads"])
@pytest.mark.parametrize("n,k,recall", [
    (21818, 100, 0.9), (10000, 200, 0.9), (2800, 200, 0.9), (21818, 100, 0.99),
    (10000, 200, 0.99), (21818, 100, 1.0), (200000, 100, 0.999), (129, 1, 0.9),
    (5000, 1, 0.9), (5000, 256, 0.1), (10000, 300, 0.99), (40000, 1024, 0.999)])
def test_b11_approx_topk_equals_plain(dev, kind, n, k, recall):
    nq = 3 if n * k > 2e7 else 37
    _b11_same(_b11_rows(dev, kind, nq, n, n + k), k, recall)


@pytest.mark.parametrize("n,k", [(100, 7), (2800, 200), (21818, 100)])
def test_b11_where_bins_are_elements_equals_b6(dev, n, k):
    recall = 1.0 if n == 21818 else 0.9
    assert apx.bins(n, k, recall) == n
    x = _b11_rows(dev, "int8_grid", 20, n, 3)
    kv, ki = _b11_same(x, k, recall)
    bv, bi = tsort.topk_transposed(x, k)
    assert torch.equal(ki, bi) and torch.equal(kv, bv)


@pytest.mark.parametrize("kind", ["normal", "int8_grid", "equal", "pads"])
@pytest.mark.parametrize("n,k,recall,view", [
    (21817, 100, 0.9, "rows"),          # odd n: one bin a thread, 4-byte loads
    (10001, 200, 0.9, "rows"),
    (21817, 100, 0.9, "from_col_1"),    # x[:, 1:] of an even width, compacted: odd n
    (21818, 100, 0.9, "offset"),        # rows 4 bytes past an 8-byte boundary, even n
    (10000, 200, 0.9, "offset"),
    (2800, 200, 0.9, "offset"),
    (21818, 100, 1.0, "rows"),          # 21,818 bins: carried across two chunks
    (200000, 100, 0.999, "rows"),       # 100,096 bins of two elements: seven chunks
    (200000, 100, 0.999, "offset"),
    (50000, 100, 0.99, "rows"),         # 12,544 bins of 3-4 elements
    (10000, 300, 0.99, "rows"),         # k > 256: the shared-memory sort
    (60000, 1024, 0.999, "rows"),
    (5000, 256, 0.1, "offset"),         # M = k: every bin kept, no select
    (8500000, 1, 0.9, "rows")])         # 128 bins of 66,407 elements: 32-bit steps
def test_b11_paired_scalar_and_chunked_bin_paths_equal_plain(dev, kind, n, k, recall, view):
    nq = 3 if n * k > 2e7 or n > 1e6 else 19
    if view == "from_col_1":
        x = _b11_rows(dev, kind, nq, n + 1, n)[:, 1:]
        assert not x.is_contiguous()
    elif view == "offset":
        x = _b11_rows(dev, kind, 1, nq * n + 1, n).view(-1)[1:].view(nq, n)
        assert x.is_contiguous() and x.data_ptr() % 8 == 4
    else:
        x = _b11_rows(dev, kind, nq, n, n + k)
    _b11_same(x, k, recall)


@pytest.mark.parametrize("kind", ["normal", "int8_grid", "equal", "pads"])
@pytest.mark.parametrize("n,k,recall", [(2799, 200, 0.9), (2800, 200, 0.9), (1364, 100, 1.0),
                                        (10000, 200, 0.99), (10000, 300, 0.99), (128, 128, 0.9)])
def test_b11_where_m_is_n_equals_b6_on_every_kind(dev, kind, n, k, recall):
    assert apx.bins(n, k, recall) == n
    x = _b11_rows(dev, kind, 11, n, n + k)
    kv, ki = _b11_same(x, k, recall)
    bv, bi = tsort.topk_transposed(x, k)
    assert torch.equal(ki, bi) and torch.equal(kv.view(torch.int32), bv.view(torch.int32))


def test_b11_rows_of_one_value_keep_the_first_k_bins_and_inputs_are_widened(dev):
    kv, ki = _b11_same(torch.full((4, 21818), 0.5, device=dev), 100, 0.9)
    assert torch.equal(ki, torch.arange(100, device=dev, dtype=torch.int32).expand(4, 100))
    x = _b11_rows(dev, "normal", 8, 2 * 10000, 1)
    _b11_same(x[:, ::2], 200, 0.9)                    # strided: the wrapper compacts it
    _b11_same(x[:, :10000].to(torch.bfloat16), 200, 0.9)
    with pytest.raises(ValueError, match=str(apx.MAX_K)):
        apx.approx_max_k(x, apx.MAX_K + 1, 0.999)
