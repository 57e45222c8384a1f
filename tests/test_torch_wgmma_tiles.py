"""CPU model of the video scores', the span sweep's and the masked scores'
wgmma tiling (csrc/s8_wgmma.cuh; csrc/video_score.cu::video_score_wgmma_kernel
for B1 / B3-int8 and ::video_score_float_kernel for B2 / B3 in bf16 and
f32; csrc/span_sim.cu::span_sim_wgmma_kernel for B5;
csrc/masked_score.cu::masked_score_kernel for B9 / B10), in numpy.

- ``acc_map``: the wgmma m64nNk* accumulator layout, (thread, register) ->
  (row, column) of the 64 x N tile, as in the PTX ISA's figure for D (the
  same for s32 sums and f32 sums); a bijection for every N the kernels use
  (104, 128, 208, 256).
- B1's per-video fold run through that map on the s32 dots of random int8
  caches: each thread's three-way maxima over its columns of each video,
  the two quad shuffles, stream v's maxima then stream s's, one f32
  rescale; equal to ``video_scores_flat_plain`` at lp = 8, 104 (the
  compile-time fold), 128 and 264 (a video over two segments), with ties
  planted across the two videos of a tile; B3's block maxima folded across
  a block's consecutive tiles equal the plain version's.
- B2's fold, the same map on the f32 dots of bf16 and f32 caches (values
  exact in both, so every order sums them exactly): the tile of each kind
  (bf16 N = 208 / 256, f32 N = 104 / 128), the stream-by-stream walk (the
  first pass writes each max to out, the second reads it back into (mv +
  ms) / 2), the 64-query tile of f32 rows past 1,024 bytes; equal to the
  plain version at lp = 8, 104, 128 and 264 with ties planted, and B3's
  block maxima and -inf pads.
- The persistent tile walk (``tile_range`` and the launch's grid) covers
  every (query, video) and every (query, flat row) exactly once at the
  engine's shapes (1,000 x 21,818), the streaming block (50 x 2,048), a
  4-way shard, and nq in {1, 63, 65}, for the int8 tiles and for both float
  kinds, whose every (query, video) of out is written by one lane in the
  first pass and read back by that lane in the second; B5's row tiles
  cover every (query, row) once.
- B5's epilogue: the staging tile's 128-byte swizzle is a bijection onto
  the four TMA boxes, each word lands where the TMA store reads that
  (query, column), a warp's writes hit 32 different banks, and the row
  scales reach every lane by the shuffle map.
- B9 / B10 with the videos on N: the accumulator map is a bijection onto
  queries x videos (N = 128 and 64) whose video pairs are a mask slot's
  float2 reads; the 3-D tensor map's boxes (128 bytes of D x N videos x
  one clip, the outer axes ordered by stride) hold the cache's rows in
  both layouts, zeros past Nv and past D (D = 72, 256); the persistent walk
  takes every (query tile, video tile) once, a range's query tiles side by
  side (1,000 x 21,818, 65 x 67, 1 x 1); the modelled kernel (boxes,
  per-clip dots, the fold through the map with the mask slot, stream v's
  maxima read back by their writer, exp) equals video_scores_xla and
  fused_video_scores_xla bit for bit on values exact in bf16 and TF32, at
  L in {1, 7, 8, 100, 129} with fractional and all-zero masks and at the
  wide tiles (D = 384, 768).

The kernels themselves run on the card (tests/test_torch_kernels_cuda.py,
chip_smoke.py phase 3); these tests hold the index arithmetic they are
built on. Seconds on one core.
"""
import numpy as np
import pytest
import torch

from tvretrieval_tpu_torch.ops import video_score as vs

N_SM = 132          # the H100's SMs: the launch's grid
QUERIES = 128       # a block's query tile: two consumer warpgroups of 64
SEG = 256           # the widest wgmma N: a segment of a longer video


def acc_map(n: int):
    """(128 threads, n / 2 registers) -> (row, column) of the m64nNk32 s32
    accumulator: thread t (warp w = t / 32, lane l), register i holds row
    16 w + 8 ((i / 2) % 2) + l / 4, column 8 (i / 4) + 2 (l % 4) + i % 2."""
    t = np.arange(128)[:, None]
    i = np.arange(n // 2)[None, :]
    w, lane = t // 32, t % 32
    row = 16 * w + 8 * ((i // 2) % 2) + lane // 4
    col = 8 * (i // 4) + 2 * (lane % 4) + i % 2
    return np.broadcast_to(row, (128, n // 2)), np.broadcast_to(col, (128, n // 2))


def tile_n(lp: int) -> int:
    """The wgmma N of video_score_wgmma_kernel: two videos of 104 rows at
    the model's lp, else 256."""
    return 208 if lp == 104 else SEG


def tile_geometry(lp: int):
    """(videos a tile, segments a video, rows a tile) as the kernel has them."""
    if lp == 104:
        vpt = tile_n(lp) // lp
    else:
        vpt = SEG // lp if lp <= SEG else 1
    return vpt, -(-lp // SEG), vpt * lp


def tile_range(n_tiles: int, groups: int, g: int):
    """s8_wgmma.cuh::tile_range: range g of the contiguous ranges cutting
    n_tiles tiles."""
    base, rem = divmod(n_tiles, groups)
    return g * base + min(g, rem), base + (1 if g < rem else 0)


def grid(nq: int, n_tiles: int, qt: int = QUERIES):
    """The launch: query tiles of qt queries x ranges, one block an SM."""
    n_qtiles = -(-nq // qt)
    return n_qtiles, max(1, min(N_SM // n_qtiles, n_tiles))


# ------------------------------------------------------------ the layout
@pytest.mark.parametrize("n", [104, 128, 208, 256])
def test_accumulator_map_is_a_bijection(n):
    row, col = acc_map(n)
    assert row.min() == 0 and row.max() == 63 and col.min() == 0 and col.max() == n - 1
    assert len(np.unique(row * n + col)) == 128 * (n // 2) == 64 * n
    # a quad's four lanes hold all eight columns of each eight-column group
    # of the same two rows: what lets two shuffles finish a video's max
    quad = np.arange(128) // 4
    for q in range(0, 32, 7):
        r = row[quad == q]
        c = col[quad == q]
        assert len(np.unique(r)) == 2
        for g in range(n // 8):
            assert sorted(c[(c // 8) == g]) == sorted(list(range(8 * g, 8 * g + 8)) * 2)


# ------------------------------------------------------- B1's per-video fold
def fold_tile(blocks, lp, v_local, cols_valid, seg_rows=SEG):
    """One warpgroup's fold of a tile's segments (each a (64, N) block of
    one stream: s32, or f32 for the float kinds) through the accumulator
    map: per thread and register half (row ra or ra + 8), the max of its
    columns of each video, then the max over the quad. Segment seg starts
    at tile column seg_rows * seg. Returns (64 rows, v_local videos)
    maxima."""
    n = blocks[0].shape[1]
    row, col = acc_map(n)
    half = (np.arange(n // 2) // 2) % 2                    # 0: row ra, 1: ra + 8
    low = -np.inf if blocks[0].dtype.kind == "f" else np.iinfo(np.int32).min
    run = np.full((128, 2, v_local), low, dtype=blocks[0].dtype)
    for seg, block in enumerate(blocks):
        held = block[row, col]                             # (128 threads, n / 2)
        for i in range(n // 2):
            c = seg_rows * seg + 8 * (i // 4)              # register i's eight-column group
            if c >= cols_valid:                            # past the tile's videos
                continue
            v = c // lp                                    # the same for every thread
            run[:, half[i], v] = np.maximum(run[:, half[i], v], held[:, i])
    quad = run.reshape(32, 4, 2, v_local).max(axis=1)      # the two shuffles
    out = np.empty((64, v_local), dtype=run.dtype)
    for qd in range(32):
        w, g = divmod(qd, 8)
        out[16 * w + g] = quad[qd, 0]
        out[16 * w + g + 8] = quad[qd, 1]
    return out


def model_b1(qv, qs, fv, fs, n_videos, lp, chunk=None):
    """B1 (chunk None) or B3-int8 through the modelled tiling: (Nq, n_videos)
    scores, or (Nq, Nv_pad) scores with pads at -inf and the (Nq, Nv_pad /
    chunk) block maxima folded over each block's consecutive tiles."""
    nq, nv_pad = qv.shape[0], fv.shape[0] // lp
    n = tile_n(lp)
    vpt, n_seg, span = tile_geometry(lp)
    dots = [q.astype(np.int64) @ f.astype(np.int64).T for q, f in ((qv, fv), (qs, fs))]
    n_vtiles = -(-nv_pad // vpt)
    n_qtiles, groups = grid(nq, n_vtiles)
    scale = np.float32(vs.I8_SCALE)
    scores = np.full((nq, nv_pad), np.nan, dtype=np.float32)
    bmax = None if chunk is None else np.full((nq, nv_pad // chunk), -np.inf, np.float32)
    for x in range(n_qtiles):
        for y in range(groups):
            first, count = tile_range(n_vtiles, groups, y)
            run_chunk = np.full(QUERIES, -1)
            run_max = np.full(QUERIES, -np.inf, dtype=np.float32)
            for t in range(first, first + count):
                v0, maxima = t * vpt, []
                for d in dots:                             # stream v, then stream s
                    q_rows = np.zeros((QUERIES, d.shape[1]), dtype=np.int64)
                    part = d[x * QUERIES:(x + 1) * QUERIES]
                    q_rows[:part.shape[0]] = part          # TMA's zero rows past nq
                    wg = []
                    for half in range(2):                  # the two warpgroups
                        blocks = []
                        for seg in range(n_seg):
                            r0 = t * span + seg * SEG
                            block = np.zeros((64, n), dtype=np.int64)
                            got = q_rows[64 * half:64 * half + 64, r0:r0 + n]
                            block[:, :got.shape[1]] = got  # rows past the cache: zeros
                            blocks.append(block)
                        wg.append(fold_tile(blocks, lp, vpt, span))
                    maxima.append(np.concatenate(wg))
                s = (maxima[0] + maxima[1]).astype(np.float32) * scale
                for vl in range(vpt):
                    v = v0 + vl
                    if v >= nv_pad:
                        continue
                    col = s[:, vl].copy()
                    if chunk is not None and v >= n_videos:
                        col[:] = -np.inf
                    q_hi = min(QUERIES, nq - x * QUERIES)
                    scores[x * QUERIES:x * QUERIES + q_hi, v] = col[:q_hi]
                    if chunk is None:
                        continue
                    c = v // chunk                          # the running block maximum
                    for q in range(q_hi):
                        if c != run_chunk[q]:
                            if run_chunk[q] >= 0:
                                qq = x * QUERIES + q
                                bmax[qq, run_chunk[q]] = max(bmax[qq, run_chunk[q]],
                                                             run_max[q])
                            run_chunk[q], run_max[q] = c, -np.inf
                        run_max[q] = max(run_max[q], col[q])
            if chunk is not None:
                for q in range(min(QUERIES, nq - x * QUERIES)):
                    if run_chunk[q] >= 0:
                        qq = x * QUERIES + q
                        bmax[qq, run_chunk[q]] = max(bmax[qq, run_chunk[q]], run_max[q])
    assert not np.isnan(scores).any()
    if chunk is None:
        return scores[:, :n_videos]
    return scores, bmax


def _caches(nq, nv_pad, lp, d, seed, tie=False):
    rng = np.random.default_rng(seed)
    draw = lambda *s: rng.integers(-127, 128, s, dtype=np.int8)
    qv, qs = draw(nq, d), draw(nq, d)
    fv, fs = draw(nv_pad * lp, d), draw(nv_pad * lp, d)
    if tie:
        # the two videos of every tile hold the same rows in both streams,
        # so each query's maxima tie across them; and video 0's best row
        # repeats at its last row (a tie inside a video)
        for f in (fv, fs):
            f3 = f.reshape(nv_pad, lp, d)
            f3[1::2] = f3[0::2][:f3[1::2].shape[0]]
            f3[:, -1] = f3[:, 0]
    return qv, qs, fv, fs


def _plain(qv, qs, fv, fs, n_videos, lp):
    t = lambda a: torch.from_numpy(a)
    return vs.video_scores_flat_plain(t(qv).T, t(qs).T, t(fv), t(fs), n_videos, lp).numpy()


@pytest.mark.parametrize("lp,nq,nv_pad,n_videos", [
    (8, 70, 70, 67),          # 32 videos a tile, three tiles (the last short)
    (104, 130, 9, 8),         # the compile-time fold: two videos a tile, one short
    (128, 65, 6, 6),          # two videos of 128 rows
    (264, 1, 3, 2)])          # a video over two segments (256 + 8 rows)
def test_b1_fold_through_the_map_equals_the_plain_version(lp, nq, nv_pad, n_videos):
    qv, qs, fv, fs = _caches(nq, nv_pad, lp, 32, seed=lp + nq)
    got = model_b1(qv, qs, fv, fs, n_videos, lp)
    assert np.array_equal(got, _plain(qv, qs, fv, fs, n_videos, lp))


@pytest.mark.parametrize("lp", [8, 104, 128])
def test_b1_fold_with_ties_across_the_videos_of_a_tile(lp):
    nq, nv_pad, n_videos = 66, 10, 10
    qv, qs, fv, fs = _caches(nq, nv_pad, lp, 16, seed=lp, tie=True)
    got = model_b1(qv, qs, fv, fs, n_videos, lp)
    ref = _plain(qv, qs, fv, fs, n_videos, lp)
    assert np.array_equal(got, ref)
    assert np.array_equal(ref[:, 0::2], ref[:, 1::2])     # the planted ties hold


@pytest.mark.parametrize("lp,nv_pad,chunk", [(104, 16, 16), (8, 40, 8), (104, 12, 4), (264, 6, 3)])
def test_b3_block_maxima_folded_across_tiles(lp, nv_pad, chunk):
    nq, n_videos = 70, nv_pad - 3
    qv, qs, fv, fs = _caches(nq, nv_pad, lp, 32, seed=nv_pad)
    scores, bmax = model_b1(qv, qs, fv, fs, n_videos, lp, chunk=chunk)
    t = lambda a: torch.from_numpy(a)
    ps, pb = vs.video_scores_flat_bmax_plain(t(qv).T, t(qs).T, t(fv), t(fs), n_videos, lp,
                                             chunk)
    assert np.array_equal(scores, ps.numpy()) and np.array_equal(bmax, pb.numpy())


# ------------------------------------------------- B2's fold (bf16, f32)
def float_tile(kind: str, lp: int):
    """video_score_float_kernel's tile: (N, videos a tile, segments a video,
    rows a tile). bf16: N = 208 at lp = 104, else 256; f32 (whose ring
    stage also holds the rows' low halves): 104, else 128."""
    n = {"bf16": 208 if lp == 104 else 256, "f32": 104 if lp == 104 else 128}[kind]
    vpt = n // lp if lp <= n else 1
    return n, vpt, -(-lp // n), vpt * lp


def float_queries(kind: str, d: int) -> int:
    """The query tile: 128 queries (two consumer warpgroups), or 64 (one)
    for f32 rows wider than 1,024 bytes."""
    return 64 if kind == "f32" and 4 * d > 1024 else 128


def model_b2(qv, qs, fv, fs, n_videos, lp, kind, chunk=None):
    """B2 (chunk None) or B3 in bf16 / f32 through the modelled tiling and
    walk: each block walks its range twice, the first pass writing stream
    v's max of each (query, video < n_videos) to out, the second reading it
    back into (mv + ms) / 2 in f32 (B3: pads -inf, block maxima over the
    block's consecutive videos in the second pass)."""
    nq, d = qv.shape
    nv_pad = fv.shape[0] // lp
    n, vpt, n_seg, span = float_tile(kind, lp)
    qt = float_queries(kind, d)
    dots = [q.astype(np.float32) @ f.astype(np.float32).T for q, f in ((qv, fv), (qs, fs))]
    n_vtiles = -(-nv_pad // vpt)
    n_qtiles, groups = grid(nq, n_vtiles, qt)
    out = np.full((nq, nv_pad), np.nan, dtype=np.float32)
    bmax = None if chunk is None else np.full((nq, nv_pad // chunk), -np.inf, np.float32)
    for x in range(n_qtiles):
        q_lo, q_hi = x * qt, min(nq, x * qt + qt)
        for y in range(groups):
            first, count = tile_range(n_vtiles, groups, y)
            run_chunk = np.full(qt, -1)
            run_max = np.full(qt, -np.inf, dtype=np.float32)
            for st in range(2):                            # stream v, then stream s
                q_rows = np.zeros((qt, dots[st].shape[1]), dtype=np.float32)
                q_rows[:q_hi - q_lo] = dots[st][q_lo:q_hi]  # TMA's zero rows past nq
                for t in range(first, first + count):
                    wg = []
                    for half in range(qt // 64):           # the consumer warpgroups
                        blocks = []
                        for seg in range(n_seg):
                            r0 = t * span + seg * n
                            block = np.zeros((64, n), dtype=np.float32)
                            got = q_rows[64 * half:64 * half + 64, r0:r0 + n]
                            block[:, :got.shape[1]] = got  # rows past the cache: zeros
                            blocks.append(block)
                        wg.append(fold_tile(blocks, lp, vpt, span, seg_rows=n))
                    maxima = np.concatenate(wg)[:q_hi - q_lo]
                    for vl in range(vpt):
                        v = t * vpt + vl
                        if v >= nv_pad:
                            continue
                        if st == 0:
                            if v < n_videos:
                                out[q_lo:q_hi, v] = maxima[:, vl]
                            continue
                        if v >= n_videos:
                            score = np.full(q_hi - q_lo, -np.inf, dtype=np.float32)
                        else:
                            score = (out[q_lo:q_hi, v] + maxima[:, vl]) / np.float32(2)
                        out[q_lo:q_hi, v] = score
                        if chunk is None:
                            continue
                        c = v // chunk                     # the running block maximum
                        for q in range(q_hi - q_lo):
                            if c != run_chunk[q]:
                                if run_chunk[q] >= 0:
                                    bmax[q_lo + q, run_chunk[q]] = max(
                                        bmax[q_lo + q, run_chunk[q]], run_max[q])
                                run_chunk[q], run_max[q] = c, -np.inf
                            run_max[q] = max(run_max[q], score[q])
            for q in range(q_hi - q_lo):
                if chunk is not None and run_chunk[q] >= 0:
                    bmax[q_lo + q, run_chunk[q]] = max(bmax[q_lo + q, run_chunk[q]], run_max[q])
    if chunk is None:
        assert not np.isnan(out[:, :n_videos]).any()
        return out[:, :n_videos]
    assert not np.isnan(out).any()
    return out, bmax


def _float_caches(nq, nv_pad, lp, d, seed, tie=False):
    """Values k / 16, |k| <= 8: exact in bf16 and TF32, and every sum of D
    of their products a multiple of 2^-8 below 2^10, exact in f32 in any
    order, so the model's dots equal the plain version's bit for bit."""
    rng = np.random.default_rng(seed)
    draw = lambda *s: rng.integers(-8, 9, s).astype(np.float32) / 16
    qv, qs = draw(nq, d), draw(nq, d)
    fv, fs = draw(nv_pad * lp, d), draw(nv_pad * lp, d)
    if tie:
        for f in (fv, fs):
            f3 = f.reshape(nv_pad, lp, d)
            f3[1::2] = f3[0::2][:f3[1::2].shape[0]]
            f3[:, -1] = f3[:, 0]
    return qv, qs, fv, fs


def _float_plain(kind, qv, qs, fv, fs, n_videos, lp, chunk=None):
    dt = torch.bfloat16 if kind == "bf16" else torch.float32
    t = lambda a: torch.from_numpy(a).to(dt)
    if chunk is None:
        return vs.video_scores_flat_plain(t(qv).T, t(qs).T, t(fv), t(fs), n_videos, lp).numpy()
    s, b = vs.video_scores_flat_bmax_plain(t(qv).T, t(qs).T, t(fv), t(fs), n_videos, lp, chunk)
    return s.numpy(), b.numpy()


@pytest.mark.parametrize("kind", ["bf16", "f32"])
@pytest.mark.parametrize("lp,nq,nv_pad,n_videos,d", [
    (8, 70, 70, 67, 32),      # bf16 32 / f32 16 videos a tile, the last tile short
    (104, 130, 9, 8, 32),     # the compile-time fold: bf16 two videos a tile, f32 one
    (128, 65, 6, 6, 32),      # bf16 two videos of 128 rows, f32 one
    (264, 1, 3, 2, 32),       # bf16 a video over two segments, f32 over three
    (24, 70, 7, 7, 320)])     # f32 rows of 1,280 bytes: the 64-query tile
def test_b2_fold_through_the_map_equals_the_plain_version(kind, lp, nq, nv_pad, n_videos, d):
    qv, qs, fv, fs = _float_caches(nq, nv_pad, lp, d, seed=lp + nq + d)
    got = model_b2(qv, qs, fv, fs, n_videos, lp, kind)
    assert np.array_equal(got, _float_plain(kind, qv, qs, fv, fs, n_videos, lp))


@pytest.mark.parametrize("kind", ["bf16", "f32"])
@pytest.mark.parametrize("lp", [8, 104, 128])
def test_b2_fold_with_ties_across_the_videos_of_a_tile(kind, lp):
    nq, nv_pad, n_videos = 66, 10, 10
    qv, qs, fv, fs = _float_caches(nq, nv_pad, lp, 16, seed=lp, tie=True)
    got = model_b2(qv, qs, fv, fs, n_videos, lp, kind)
    ref = _float_plain(kind, qv, qs, fv, fs, n_videos, lp)
    assert np.array_equal(got, ref)
    assert np.array_equal(ref[:, 0::2], ref[:, 1::2])     # the planted ties hold


@pytest.mark.parametrize("kind", ["bf16", "f32"])
@pytest.mark.parametrize("lp,nv_pad,chunk", [(104, 16, 16), (8, 40, 8), (104, 12, 4), (264, 6, 3)])
def test_b3_float_block_maxima_folded_across_tiles(kind, lp, nv_pad, chunk):
    nq, n_videos = 70, nv_pad - 3
    qv, qs, fv, fs = _float_caches(nq, nv_pad, lp, 32, seed=nv_pad)
    scores, bmax = model_b2(qv, qs, fv, fs, n_videos, lp, kind, chunk=chunk)
    ps, pb = _float_plain(kind, qv, qs, fv, fs, n_videos, lp, chunk)
    assert np.array_equal(scores, ps) and np.array_equal(bmax, pb)
    assert (scores[:, n_videos:] == -np.inf).all()


# ---------------------------------------------------------- the tile walk
def _coverage(nq, n_units, n_tiles, units_of_tile, qt=QUERIES):
    """(nq, n_units) counts of the walk: every block (x, y) takes its query
    tile and its range's tiles; units_of_tile(t) -> the units tile t covers."""
    n_qtiles, groups = grid(nq, n_tiles, qt)
    counts = np.zeros((n_qtiles, n_units), dtype=np.int32)
    for y in range(groups):
        first, count = tile_range(n_tiles, groups, y)
        for t in range(first, first + count):
            lo, hi = units_of_tile(t)
            counts[:, lo:min(hi, n_units)] += 1
    assert n_qtiles * qt >= nq > (n_qtiles - 1) * qt
    return counts, groups


@pytest.mark.parametrize("nq,nv_pad,lp", [
    (1000, 21824, 104),       # the engine: 21,818 videos padded to 16
    (50, 2048, 104),          # a streaming block
    (1000, 5456, 104),        # one of 4 shards (21,824 / 4)
    (1, 37, 8), (63, 40, 264), (65, 9, 128)])
def test_b1_walk_covers_every_query_video_and_row_once(nq, nv_pad, lp):
    vpt, n_seg, span = tile_geometry(lp)
    n_vtiles = -(-nv_pad // vpt)
    counts, groups = _coverage(nq, nv_pad, n_vtiles, lambda t: (t * vpt, t * vpt + vpt))
    assert (counts == 1).all()
    # the rows: segment seg of tile t covers flat rows t * span + seg * 256
    # .. + N, of which the columns below span count
    rows = np.zeros(nv_pad * lp, dtype=np.int32)
    n = tile_n(lp)
    for t in range(n_vtiles):
        for seg in range(n_seg):
            lo = t * span + seg * SEG
            hi = min(lo + n, t * span + span, nv_pad * lp)
            rows[lo:hi] += 1
    assert (rows == 1).all()
    if nq == 1000 and nv_pad == 21824:
        assert groups == 16 and -(-nq // QUERIES) * groups == 128   # 128 of the 132 SMs


def float_lanes(kind: str, lp: int, qt: int):
    """Per consumer thread of a block, the (query offset, tile video) of out
    its lane writes in the first pass and reads back in the second, or -1:
    at lp = 104 lane quad < 2 VPT of a quad owns row h = quad / VPT, video
    quad % VPT of the tile; otherwise lanes 0 and 1 own rows ra and ra + 8
    of every video of the tile (one video at a time, at its flush)."""
    _, vpt, _, _ = float_tile(kind, lp)
    thr = np.arange(2 * qt)
    wg, t = thr // 128, thr % 128
    warp, lane = t // 32, t % 32
    quad = lane % 4
    ra = 64 * wg + 16 * warp + lane // 4
    if lp == 104:
        own = quad < 2 * vpt
        q = np.where(own, ra + 8 * (quad // vpt), -1)
        v = np.where(own, quad % vpt, -1)
        return q[:, None], v[:, None]
    own = quad < 2
    q = np.where(own, ra + 8 * quad, -1)
    return np.repeat(q[:, None], vpt, 1), np.where(own[:, None], np.arange(vpt)[None], -1)


@pytest.mark.parametrize("kind", ["bf16", "f32"])
@pytest.mark.parametrize("nq,nv_pad,lp,d", [
    (1000, 21824, 104, 256),          # the engine: 21,818 videos padded to 16
    (50, 2048, 104, 256),             # a streaming block
    (1000, 5456, 104, 256),           # one of 4 shards (21,824 / 4)
    (1, 37, 8, 256), (63, 40, 264, 256), (65, 9, 128, 256),
    (70, 30, 104, 384)])              # f32 D = 384: the 64-query tile
def test_b2_walk_writes_and_reads_back_every_query_video_once(kind, nq, nv_pad, lp, d):
    """One lane owns each (query, video) of out: it writes the first pass's
    max there and reads it back in the second (B3's pads: writes -inf in
    the second); the ranges cover every video tile once per query tile,
    and the segments every flat row once."""
    n, vpt, n_seg, span = float_tile(kind, lp)
    qt = float_queries(kind, d)
    n_vtiles = -(-nv_pad // vpt)
    counts, groups = _coverage(nq, nv_pad, n_vtiles, lambda t: (t * vpt, t * vpt + vpt), qt)
    assert (counts == 1).all()
    q_off, v_off = float_lanes(kind, lp, qt)
    n_qtiles = -(-nq // qt)
    tiles = np.arange(n_vtiles)
    for x in range(n_qtiles):
        q = np.broadcast_to(x * qt + q_off[:, :, None], q_off.shape + (n_vtiles,))
        v = tiles[None, None] * vpt + v_off[:, :, None]
        ok = (q_off[:, :, None] >= 0) & (q < nq) & (v < nv_pad)
        seen = np.bincount((q[ok] - x * qt) * nv_pad + v[ok], minlength=qt * nv_pad)
        seen = seen.reshape(qt, nv_pad)[:min(qt, nq - x * qt)]
        # one lane for each (query, video): the writer of the first pass is
        # the reader of the second, the lane mapping being the same in both
        assert (seen == 1).all()
    # the rows: segment seg of tile t covers flat rows t * span + seg * N ..
    # + N, of which the columns below span count
    rows = np.zeros(nv_pad * lp, dtype=np.int32)
    for t in range(n_vtiles):
        for seg in range(n_seg):
            lo = t * span + seg * n
            rows[lo:min(lo + n, t * span + span, nv_pad * lp)] += 1
    assert (rows == 1).all()
    if nq == 1000 and nv_pad == 21824:
        assert n_qtiles * groups == 128                     # 128 of the 132 SMs


@pytest.mark.parametrize("nq,rows", [(1000, 2793472), (50, 2048 * 128), (1, 148), (63, 888),
                                     (65, 4736), (1000, 698368),
                                     # the engine's layout at L = 100 (flat_lp = 104 rows a
                                     # video): whole, one of four shards, 21 videos
                                     (1000, 21824 * 104), (1000, 5456 * 104), (65, 21 * 104)])
def test_b5_walk_covers_every_query_row_once(nq, rows):
    n_rtiles = -(-rows // SEG)
    counts, _ = _coverage(nq, rows, n_rtiles, lambda t: (t * SEG, t * SEG + SEG))
    assert (counts == 1).all()


# ---------------------------------------------------------- B5's epilogue
def staging_words():
    """Per (thread, j, half): the byte offset of the 4-byte word (two bf16:
    columns 8 j + 2 (l % 4), + 1 of tile row ra + 8 half) in a warpgroup's
    staging tile: four boxes of 64 rows x 128 bytes, 16-byte chunk c of row
    r at chunk c ^ (r % 8)."""
    t = np.arange(128)[:, None, None]
    j = np.arange(32)[None, :, None]
    h = np.arange(2)[None, None, :]
    lane = t % 32
    ra = 16 * (t // 32) + lane // 4
    r = ra + 8 * h
    off = (j >> 3) * (64 * 128) + r * 128 + (((j & 7) ^ (ra & 7)) * 16) + 4 * (lane % 4)
    return np.broadcast_arrays(off, r, 8 * j + 2 * (lane % 4))


def test_b5_staging_swizzle_is_a_bijection_onto_the_tma_boxes():
    off, r, c = staging_words()
    assert len(np.unique(off)) == off.size == 64 * 256 * 2 // 4
    assert off.min() == 0 and off.max() == 4 * 8192 - 4 and (off % 4 == 0).all()
    # where the TMA store (128-byte swizzle, box 64 x 64 bf16) reads each word
    box, within = off // 8192, off % 8192
    row, chunk = within // 128, (within % 128) // 16
    col = 64 * box + 8 * (chunk ^ (row % 8)) + (within % 16) // 2
    assert np.array_equal(row, r) and np.array_equal(col, c)


def test_b5_staging_writes_are_free_of_bank_conflicts():
    off, _, _ = staging_words()
    for w in range(4):
        for j in range(32):
            for h in range(2):
                banks = (off[32 * w:32 * w + 32, j, h] // 4) % 32
                assert len(np.unique(banks)) == 32


def test_b5_row_scales_reach_every_lane():
    """Lane 4 b + c loads the pairs of columns 8 (b + 8 i) + 2 c, i < 4; for
    eight-column group j a lane of quad position c reads register j / 8 of
    lane 4 (j % 8) + c, and gets columns 8 j + 2 c, + 1."""
    lane = np.arange(32)
    held = {(l, i): 8 * ((l >> 2) + 8 * i) + 2 * (l & 3) for l in lane for i in range(4)}
    for j in range(32):
        for l in lane:
            src = 4 * (j & 7) + (l & 3)
            assert held[(src, j >> 3)] == 8 * j + 2 * (l & 3)
    assert sorted(held.values()) == list(range(0, 256, 2))


# ------------------------------------------- B9 / B10: the videos on N
MASKED_N = 128      # csrc/masked_score.cu: videos a tile (64 at f32 rows past 2,560 bytes)
CHUNK = 128         # K bytes of a TMA box and a ring stage


def masked_tiles(kind: str, d: int):
    """masked_score_kernel's (query tile, videos a tile) for D features:
    rows past 1,024 bytes take the 64-query tile, f32 rows past 2,560
    bytes also N = 64."""
    row = d * (2 if kind == "bf16" else 4)
    qt = 64 if row > 1024 else 128
    return qt, 64 if kind == "f32" and row > 2560 else MASKED_N


@pytest.mark.parametrize("n", [128, 64])
def test_masked_accumulator_map_is_a_bijection_onto_queries_x_videos(n):
    """With the queries on M and the videos on N, register i of thread t is
    one (query, video) of the warpgroup's 64 x N tile, each exactly once,
    and the videos a thread holds are the pairs 8 j + 2 (t % 4), + 1 that
    its float2 reads of a mask slot give (register 4 j + 2 h + e)."""
    row, col = acc_map(n)
    assert len(np.unique(row * n + col)) == 64 * n == 128 * (n // 2)
    i = np.arange(n // 2)[None, :]
    quad = (np.arange(128) % 4)[:, None]
    assert np.array_equal(col, 8 * (i // 4) + 2 * quad + i % 2)
    lane = np.arange(128) % 32
    assert np.array_equal(row, 16 * (np.arange(128) // 32)[:, None]
                          + 8 * ((i // 2) % 2) + (lane // 4)[:, None])
    # two consumer warpgroups of 64 queries each: queries x videos of a block
    q = np.concatenate([row, row + 64])
    c = np.concatenate([col, col])
    assert len(np.unique(q * n + c)) == 128 * n


def box_read(buf, inner, dims, strides, elem, c0, c1, c2, box1, box2):
    """A TMA box of the 3-D tensor map encode_3d makes, in numpy: ``buf``
    the flat cache (elements), ``inner`` contiguous elements, outer axes of
    ``dims`` = (outer1, outer2) entries ``strides`` elements apart; the box
    at (c0, c1, c2) is 128 bytes of the inner axis x box1 x box2, zero
    where any coordinate lies past its axis. Returns (box1 * box2, 128 /
    elem) rows in shared-memory order (the inner axis fastest, then axis 1,
    then axis 2)."""
    w = CHUNK // elem
    out = np.zeros((box2, box1, w), dtype=buf.dtype)
    for b in range(box2):
        for a in range(box1):
            i1, i2 = c1 + a, c2 + b
            if i1 >= dims[0] or i2 >= dims[1]:
                continue
            lo, hi = c0, min(c0 + w, inner)
            if lo < hi:
                base = i1 * strides[0] + i2 * strides[1]
                out[b, a, :hi - lo] = buf[base + lo:base + hi]
    return out.reshape(box1 * box2, w)


def masked_map(layout: str, nv: int, n_clips: int, d: int):
    """The launch's choice of axes: the two outer axes of the cache ordered
    by stride, equal strides putting the axis of one entry first. B9's
    (Nv, L, D) cache: strides (video L D, clip D); B10's (L, Nv, D): (video
    D, clip Nv D). Returns (clip_inner, dims, strides) in elements."""
    f_video, f_clip = (n_clips * d, d) if layout == "b9" else (d, nv * d)
    clip_inner = f_clip < f_video or (f_clip == f_video and n_clips == 1)
    if clip_inner:
        return True, (n_clips, nv), (f_clip, f_video)
    return False, (nv, n_clips), (f_video, f_clip)


def read_clip_rows(cache, layout, nv, n_clips, d, elem, v0, l, n):
    """N videos' rows of clip l from the first video v0, as the producer's
    boxes of every 128-byte K chunk bring them: (N, whole chunks) with TMA's
    zeros past Nv and past D."""
    clip_inner, dims, strides = masked_map(layout, nv, n_clips, d)
    w = CHUNK // elem
    buf = cache.reshape(-1)
    chunks = []
    for kc in range(-(-d // w)):
        if clip_inner:
            chunks.append(box_read(buf, d, dims, strides, elem, kc * w, l, v0, 1, n))
        else:
            chunks.append(box_read(buf, d, dims, strides, elem, kc * w, v0, l, n, 1))
    return np.concatenate(chunks, axis=1)


@pytest.mark.parametrize("layout", ["b9", "b10"])
@pytest.mark.parametrize("kind,d", [("bf16", 72), ("bf16", 256), ("f32", 72), ("f32", 256)])
def test_masked_box_reads_equal_the_cache_rows(layout, kind, d):
    """Every box the producer loads (128 bytes of D x N videos x one clip,
    in both layouts) holds the cache's rows of those videos at that clip,
    zeros past Nv (the last tile) and past D (D = 72: a tail of 8 bf16, or
    of 8 f32 in the third chunk)."""
    nv, n_clips = 67, 5
    elem = 2 if kind == "bf16" else 4
    _, n = masked_tiles(kind, d)
    rng = np.random.default_rng(d + elem)
    video_major = rng.normal(size=(nv, n_clips, d)).astype(np.float32)
    cache = video_major if layout == "b9" else np.ascontiguousarray(video_major.transpose(1, 0, 2))
    w = CHUNK // elem
    d_pad = -(-d // w) * w
    for v0 in range(0, nv, n):
        for l in range(n_clips):
            rows = read_clip_rows(cache, layout, nv, n_clips, d, elem, v0, l, n)
            assert rows.shape == (n, d_pad)
            real = min(n, nv - v0)
            assert np.array_equal(rows[:real, :d], video_major[v0:v0 + real, l])
            assert not rows[real:].any() and not rows[:, d:].any()
    # B9 at L = 1 and B10 at Nv = 1: strides tie, the axis of one entry first
    assert masked_map("b9", nv, 1, d)[0] and not masked_map("b10", 1, n_clips, d)[0]


def masked_walk(nq: int, nv: int, qt: int, n: int):
    """The launch's grid and each block's ordered video tiles: (n_qtiles,
    groups, {(x, y): [tiles]})."""
    n_vtiles = -(-nv // n)
    n_qtiles, groups = grid(nq, n_vtiles, qt)
    tiles = {}
    for y in range(groups):
        first, count = tile_range(n_vtiles, groups, y)
        for x in range(n_qtiles):
            tiles[(x, y)] = list(range(first, first + count))
    return n_qtiles, groups, tiles


@pytest.mark.parametrize("qt,n", [(128, 128), (64, 128), (64, 64)])
@pytest.mark.parametrize("nq,nv", [(1000, 21818), (65, 67), (1, 1)])
def test_masked_walk_covers_every_tile_pair_once_with_query_tiles_together(nq, nv, qt, n):
    """Every (query tile, video tile) is walked by exactly one block, and
    the blocks of one range (its query tiles) walk the same video tiles in
    the same order: at each step the query tiles of a video tile run side
    by side and share its rows through L2, so the cache crosses device
    memory about once a stream."""
    n_qtiles, groups, tiles = masked_walk(nq, nv, qt, n)
    n_vtiles = -(-nv // n)
    seen = np.zeros((n_qtiles, n_vtiles), dtype=np.int32)
    for (x, _), ts in tiles.items():
        seen[x, ts] += 1
    assert (seen == 1).all()
    for y in range(groups):
        walks = [tiles[(x, y)] for x in range(n_qtiles)]
        assert all(w == walks[0] for w in walks) and walks[0] == sorted(walks[0])
    assert n_qtiles * groups <= N_SM and n_qtiles * qt >= nq
    if (nq, nv, qt, n) == (1000, 21818, 128, 128):
        assert (n_qtiles, groups, n_vtiles) == (8, 16, 171)       # 128 of the 132 SMs


def masked_model(queries, caches, layout, mask_vl, init, alpha, kind, d):
    """masked_score_kernel in numpy: the walk, the boxes, the per-clip dots
    (values exact in bf16 and TF32, so every order sums them exactly), the
    fold through the accumulator map with the helpers' mask slot (zeros past
    Nv), the first stream's maxima waiting in out and read back by their
    writer, then exp. queries: one or two (Nq, D) f32; caches the same
    count in ``layout``; mask_vl: (Nv, L) f32."""
    nq = queries[0].shape[0]
    nv, n_clips = mask_vl.shape
    elem = 2 if kind == "bf16" else 4
    qt, n = masked_tiles(kind, d)
    n_qtiles, groups, tiles = masked_walk(nq, nv, qt, n)
    row, col = acc_map(n)
    out = np.full((nq, nv), np.nan, dtype=np.float32)
    neg = np.float32(-1e10)
    for (x, y), ts in tiles.items():
        for st, (q, cache) in enumerate(zip(queries, caches)):
            q_tile = np.zeros((qt, d), dtype=np.float32)       # TMA's zero rows past nq
            q_tile[:min(qt, nq - x * qt)] = q[x * qt:(x + 1) * qt]
            for t in ts:
                v0 = t * n
                rows = np.stack([read_clip_rows(cache, layout, nv, n_clips, d, elem, v0, l, n)
                                 [:, :d] for l in range(n_clips)])     # (L, N, D)
                dots = np.einsum("qd,lnd->lqn", q_tile, rows).astype(np.float32)
                slot = np.zeros((n_clips, n), dtype=np.float32)        # the helpers' loads
                real = min(n, nv - v0)
                slot[:, :real] = mask_vl[v0:v0 + real].T
                for wg in range(qt // 64):
                    held = dots[:, 64 * wg + row, col]                 # (L, thread, register)
                    m = slot[:, col]
                    off = (np.float32(1) - m) * neg
                    best = np.full(held.shape[1:], init, dtype=np.float32)
                    for l in range(n_clips):
                        best = np.maximum(best, held[l] * m[l] + off[l])
                    qq, vv = x * qt + 64 * wg + row, v0 + col
                    ok = (qq < nq) & (vv < nv)
                    if st == 0:
                        out[qq[ok], vv[ok]] = best[ok]
                    else:
                        out[qq[ok], vv[ok]] = (out[qq[ok], vv[ok]] + best[ok]) / np.float32(2)
    assert not np.isnan(out).any()
    if alpha is not None:
        out = torch.exp(alpha * torch.from_numpy(out)).numpy()
    return out


def _masked_inputs(nq, nv, n_clips, d, seed, frac=True):
    """Values k / 16 (exact in bf16 and TF32; D * 64 / 256 < 2^10, so every
    dot is exact in f32); prefix masks, some fractional, video 0 fully
    masked and (nv > 2) video 1 at 0.5 on every clip."""
    rng = np.random.default_rng(seed)
    draw = lambda *s: rng.integers(-8, 9, s).astype(np.float32) / 16
    lengths = rng.integers(1, n_clips + 1, nv)
    mask = (np.arange(n_clips)[None] < lengths[:, None]).astype(np.float32)
    if frac:
        f = rng.random((nv, n_clips)).astype(np.float32)
        mask = np.where(f < 0.2, mask * f * 5, mask).astype(np.float32)
        if nv > 2:
            mask[1] = 0.5
    mask[0] = 0.0
    return draw(nq, d), draw(nq, d), draw(nv, n_clips, d), draw(nv, n_clips, d), mask


@pytest.mark.parametrize("kind", ["bf16", "f32"])
@pytest.mark.parametrize("n_clips", [1, 7, 8, 100, 129])
def test_masked_fold_through_the_map_equals_the_plain_versions(kind, n_clips):
    """B9 (two streams, video-major) and B10 (one stream, clip-major, the
    running max from -1e10, exp and not) through the modelled kernel on 65
    queries x 67 videos with fractional and all-zero masks: equal to
    video_scores_xla and fused_video_scores_xla, the fully masked video
    exactly -1e10 (0 after the exp)."""
    from tvretrieval_tpu_torch.ops import fused_score as fsc

    nq, nv, d = 65, 67, 16
    qv, qs, fv, fs, mask = _masked_inputs(nq, nv, n_clips, d, seed=n_clips)
    dt = torch.bfloat16 if kind == "bf16" else torch.float32
    T = lambda a: torch.from_numpy(a).to(dt)
    got = masked_model([qv, qs], [fv, fs], "b9", mask, -np.inf, None, kind, d)
    ref = vs.video_scores_xla(T(qv), T(qs), T(fv), T(fs), torch.from_numpy(mask)).numpy()
    assert np.array_equal(got, ref) and (got[:, 0] == -1e10).all()
    fv_t = np.ascontiguousarray(fv.transpose(1, 0, 2))
    for alpha in (None, 20.0):
        got = masked_model([qv], [fv_t], "b10", mask, -1e10, alpha, kind, d)
        ref = fsc.fused_video_scores_xla(T(qv), T(fv), torch.from_numpy(mask), alpha).numpy()
        assert np.array_equal(got, ref)
        assert (got[:, 0] == (-1e10 if alpha is None else 0.0)).all()


@pytest.mark.parametrize("kind,d", [("bf16", 72), ("bf16", 768), ("f32", 72), ("f32", 384),
                                    ("f32", 768)])
def test_masked_fold_at_the_wide_and_ragged_widths(kind, d):
    """D with a tail past a chunk (72) and the widest rows, on the 64-query
    tile (bf16 768, f32 384) and N = 64 (f32 768): 130 queries cross two
    64-query tiles, 67 videos two 64-video tiles."""
    from tvretrieval_tpu_torch.ops import fused_score as fsc

    nq, nv, n_clips = 130, 67, 3
    qv, qs, fv, fs, mask = _masked_inputs(nq, nv, n_clips, d, seed=d, frac=False)
    # k / 64 values: products are multiples of 2^-12 below 2^-6, so the
    # dots of 768 stay below 2^4 and exact in f32 in any order
    qv, qs, fv, fs = (a / 4 for a in (qv, qs, fv, fs))
    dt = torch.bfloat16 if kind == "bf16" else torch.float32
    T = lambda a: torch.from_numpy(a).to(dt)
    got = masked_model([qv, qs], [fv, fs], "b9", mask, -np.inf, None, kind, d)
    ref = vs.video_scores_xla(T(qv), T(qs), T(fv), T(fs), torch.from_numpy(mask)).numpy()
    assert np.array_equal(got, ref)
    fv_t = np.ascontiguousarray(fv.transpose(1, 0, 2))
    got = masked_model([qv], [fv_t], "b10", mask, -1e10, None, kind, d)
    assert np.array_equal(got, fsc.fused_video_scores_xla(T(qv), T(fv),
                                                          torch.from_numpy(mask)).numpy())
