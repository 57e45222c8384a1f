// Masked video-score kernels for Hopper (sm_90a): the ports of the two
// Pallas design studies of the q2c stage.
//
//   B9  video_scores_pallas            (tvretrieval_tpu/ops/pallas_score.py:48-100)
//       two streams, video-major (Nv, L, D) caches, mask (Nv, L)
//   B10 fused_video_scores_clip_major  (tvretrieval_tpu/ops/pallas_kernels.py:37-96)
//       one stream, clip-major (L, Nv, D) cache, mask (L, 1, Nv), optional
//       exp(alpha * score)
//
// What it computes. For query q and video v, per stream, the max over the
// clips l of  s * m + (1 - m) * -1e10  with s = q . feat[v, l] (f32
// accumulation) and m = mask[v, l]; B9 averages the two streams' maxima,
// B10 returns its one stream's, through exp(alpha * .) when asked. A fully
// masked video scores exactly -1e10 in both (every clip gives 0 + -1e10).
// The two functions differ only in strides and stream count, so they are
// one kernel: the caller hands over the strides of the video and clip axes
// of the cache and of the mask.
//
// What bounds it on this card. The work is a GEMM of Nv * L rows against
// the queries whose (Nq, Nv, L) product must not reach device memory, so
// the bound is arithmetic (at the data sheet's peaks, 1,000 queries x
// 21,818 videos x 100 clips x D = 256: B9 2.26 ms bf16, B10 1.13; f32
// counted as three TF32 products, 13.55 and 6.77). The bytes are small
// beside it: both bf16 caches are 2.23 GB, 0.67 ms at 3.35 TB/s, if each
// crosses device memory once (below).
//
// The design: wgmma fed by TMA (the pieces of s8_wgmma.cuh), a persistent,
// warp-specialised block as in video_score.cu's float kernel.
//  - Orientation. The queries are the A operand (64 rows a consumer
//    warpgroup, from a resident K-major query tile of one stream), the
//    videos the N axis (B, from the ring): a ring stage holds one clip's
//    128-byte K chunk of N = 128 videos. A clip's dot for one (query,
//    video) then ends in one accumulator register (register i of thread t:
//    tile row 16 (t / 32) + 8 ((i / 2) % 2) + (t % 32) / 4, video 8 (i / 4)
//    + 2 (t % 4) + i % 2), so the mask fold stays in registers with no
//    shuffles and no atomics, and any clip count works (L = 100 is no
//    multiple of 8). B2's layout, with clips on N and quad shuffles, fits
//    only B9's video-major cache, since B10's clip-major cache holds no
//    contiguous rows of a video; this one takes both layouts on one path.
//  - Layouts through TMA. The cache is a 3-D tensor map: D contiguous,
//    then the clip and video axes ordered by their strides (B9: clips D e
//    bytes apart, videos L D e; B10: videos D e, clips Nv D e). A box is 128
//    bytes of D x N videos x 1 clip and lands as N swizzled rows of 128
//    bytes, as a 2-D box does. Videos past Nv and features past D arrive as
//    zeros from TMA's out-of-bounds fill (D = 72 has a tail): products are
//    issued on them, never branched around (a branch around wgmma that
//    ptxas cannot prove warpgroup-uniform serializes every product, its
//    warning C7518).
//  - Warp roles. Consumer warpgroups 0 and 1 each own 64 queries (one at
//    rows wider than the query tile allows, below). Warpgroup 2's first
//    thread is the producer: it loads the stream's query tile and keeps
//    TMA loads of the clip chunks in an mbarrier ring. Its warps 1-3 (96
//    threads) are the helpers: they load each clip's N mask values with
//    plain loads (B9's mask column strides L * 4 bytes, which TMA cannot
//    take for every L: 1, 7, 100, 129), zero past Nv, into a slot beside
//    the stage of the clip's last chunk; in f32 they also split each landed
//    chunk into its TF32 halves (below). A stage has three barriers: full
//    (the TMA's bytes), ready (the helpers' 96 arrivals, after they saw
//    full) and empty (every consumer thread).
//  - The per-clip fold. After a clip's K loop every accumulator element
//    takes __fmul_rn by its video's mask, __fadd_rn of __fmul_rn(1 - m,
//    -1e10), and fmaxf into the running max: three FP32 operations against
//    D multiply-adds, about 0.023 cycles an SM against 0.125 on the bf16
//    tensor cores at D = 256 (~19% of the product time; ~3% in f32). The
//    two consumer warpgroups share every stage but hold no common barrier
//    beyond it, so one's fold can run under the other's products. The
//    stage of the clip's last chunk is handed back after the fold, which
//    reads its mask slot. On the H100 the kernel reaches ~57-60% of its
//    bound at the full shapes; variants that issued a clip's fold under
//    the next clip's first products (two accumulator sets), started
//    warpgroup 1 half a clip late, or held bf16's A fragments in registers
//    and gave the query tile's memory to 13 ring stages were no faster
//    (PERF.md), so none of the fold, the A operand's shared-memory reads
//    and the ring's depth bounds it alone.
//  - The two streams (B9). One stream's query tile is resident at a time
//    (a 128-query bf16 tile is 64 KiB at D = 256, f32 128 KiB): the block
//    walks its range of video tiles for stream v, each thread writing its
//    (query, video) maxima to out at the end of each tile, then, with
//    stream s's queries loaded over the tile (the producer waits on a
//    barrier every consumer passes after its last fold of stream v), for
//    stream s, each maximum combined with stream v's read back by the
//    thread that wrote it into (mv + ms) / 2. 87 MB written and read back
//    at the full shapes, ~0.05 ms.
//  - The walk and L2. The grid is (query tiles, ranges): 132 / query tiles
//    contiguous ranges of the Nv / N video tiles, one block an SM (8 x 16 =
//    128 blocks at Nq = 1,000). The blocks of one range hold its query
//    tiles and walk the same video tiles in the same order side by side,
//    so a tile's rows come from device memory about once a stream and from
//    L2 once per query tile.
//  - bf16: wgmma m64n128k16, A and B from shared memory (descriptors).
//  - f32: three tf32 products a k-step of 8 (the 3xTF32 split of
//    s8_mma.cuh), wgmma m64nNk8 with A from registers: each consumer
//    thread loads its A fragments of a chunk's four k-steps from the raw
//    query tile (ldmatrix) and splits them (split_tf32) once the previous
//    chunk's products are done; the rows are B, from the ring, where the
//    helpers round each landed chunk to its TF32 high halves in place and
//    write its low halves beside it (then fence.proxy.async, then ready).
//    Products in the order of B2's f32 kind: lo.hi, hi.lo, hi.hi into the
//    one f32 accumulator.
// Budgets. Registers, a consumer thread: 64 accumulators and 64 running
// maxima at N = 128 (32 and 32 at N = 64), f32 also 48 fragment registers;
// setmaxnreg gives the two consumer warpgroups 232 and the producer's 40
// (ptxas: no spills in any instance).
// Shared memory: the query tile (nkc chunks of QT rows x 128 bytes), the
// ring (stages of N x 128 bytes, twice that in f32, each with an N-float
// mask slot), the barriers, and 1 KiB that the alignment may take, within
// 227 KiB:
//   bf16 D <= 512: QT = 128, N = 128; D = 256: 64 KiB + eight 16.5 KiB stages
//   bf16 D <= 768: QT = 64 (rows past 1,024 bytes), N = 128; seven stages
//   f32  D <= 256: QT = 128, N = 128; D = 256: 128 KiB + three 32.5 KiB stages
//   f32  D <= 640: QT = 64 (rows past 1,024 bytes), N = 128; two to four stages
//   f32  D <= 768: QT = 64, N = 64 (rows past 2,560 bytes): 192 KiB + two
// So every width the wrapper takes (D <= 768 in both kinds) runs on wgmma.
//
// Exactness. The mask arithmetic is written out as two roundings of a
// product and one of a sum (__fmul_rn / __fadd_rn, 1 - m by __fsub_rn), as
// the plain version computes it, so that no FMA contraction changes a
// fractional mask's result. The dots are f32 sums of exact products (bf16),
// or of the split's three products (f32, both operands split with rna, so
// the tensor core reads exact TF32 values), in another order than a library
// GEMM: f32 summation slack, held to 1e-5 of the plain versions (the
// argument of s8_mma.cuh and video_score.cu; a k-step of wgmma m64nNk16 /
// m64nNk8 sums the same products in the same order as mma.sync m16n8k16 /
// m16n8k8, so it held unchanged; tests/test_torch_mma_order.py models the
// walk). On values exact in TF32 with 0/1 masks the sums are exact and
// both kinds equal their plain versions bit for bit. expf is the CUDA
// library's (no fast-math flag).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (tvretrieval_tpu_torch/ops/_build.py). C interface, loaded with
// ctypes; the entry point returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "s8_mma.cuh"
#include "s8_wgmma.cuh"

namespace {

using namespace s8wg;

constexpr float kMasked = -1e10f;       // ops/masking.py::NEG_INF, exact in f32
constexpr int kMaxStages = 8;
constexpr int kBarBytes = (3 * kMaxStages + 2) * 8;  // full, ready, empty a stage; the query tile's two
constexpr int kHelpers = 96;            // warps 1-3 of the producer warpgroup

// The two kinds' products. MaskedBf16: bf16 x bf16 -> f32, both operands
// from shared memory. MaskedTf32x3: three tf32 products a k-step, A (the
// queries) from registers; a ring stage holds the rows' TF32 high halves
// and, beside them, their low halves.
struct MaskedBf16 {
  static constexpr bool kSplit = false;
  static constexpr int kElem = 2;
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static constexpr int kMaxRowBytes = 1536;       // D <= 768
  static constexpr int kNarrowRowBytes = 1536;    // no row takes N = 64
  template <int N>
  using Mma = WgmmaBf16<N>;
};
struct MaskedTf32x3 {
  static constexpr bool kSplit = true;
  static constexpr int kElem = 4;
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  static constexpr int kMaxRowBytes = 3072;       // D <= 768
  static constexpr int kNarrowRowBytes = 2560;    // rows past D = 640: N = 64
  template <int N>
  using Mma = WgmmaTf32<N>;
};
constexpr int kWideRowBytes = 1024;     // rows past it: the 64-query tile, either kind

__host__ __device__ constexpr int stage_bytes(bool split, int n) {
  return (split ? 2 : 1) * n * kChunk;
}
__host__ __device__ constexpr int query_bytes(int nkc, int qt) { return nkc * qt * kChunk; }
// ring stages (each with its mask slot) that fit beside the query tile and
// the barriers, and the 1 KiB the alignment may take
__host__ __device__ constexpr int fit_stages(int nkc, int qt, bool split, int n) {
  return (kMaxSmem - kGroupBytes - kBarBytes - query_bytes(nkc, qt)) /
         (stage_bytes(split, n) + 4 * n);
}
static_assert(fit_stages(4, 128, false, 128) >= kMaxStages, "bf16 D = 256: eight stages");
static_assert(fit_stages(8, 128, false, 128) >= 5, "bf16 D = 512: five stages");
static_assert(fit_stages(12, 64, false, 128) >= 7, "bf16 D = 768: seven stages");
static_assert(fit_stages(8, 128, true, 128) >= 3, "f32 D = 256: three stages");
static_assert(fit_stages(12, 64, true, 128) >= 3, "f32 D = 384: three stages");
static_assert(fit_stages(20, 64, true, 128) >= 2, "f32 D = 640: two stages");
static_assert(fit_stages(24, 64, true, 64) >= 2, "f32 D = 768: two stages");

struct Params {
  const float* mask;
  long long m_video, m_clip;   // mask strides, in floats
  float* out;                  // (nq, nv)
  int nq, nv, n_clips, d;      // d: bytes a row, a multiple of 16
  int n_streams;
  int clip_inner;              // the cache map's axes: (D, clips, videos), else (D, videos, clips)
  float init;                  // the running max starts here (-inf, or -1e10 for B10)
  int use_exp;
  float alpha;
  int n_vtiles, stages;
};

// map_q0 / map_q1: (nq, D) query rows of each stream (boxes of QT queries x
// 128 bytes); map_f0 / map_f1: the caches (boxes of 128 bytes x N videos x
// one clip). Block (x, y): query tile x, the y-th of gridDim.y contiguous
// ranges of the n_vtiles video tiles of N videos. QT: 128 queries, two
// consumer warpgroups, or 64, one.
template <class T, int QT, int N>
__global__ void __launch_bounds__(2 * QT + 128, 1)
masked_score_kernel(const __grid_constant__ CUtensorMap map_q0,
                    const __grid_constant__ CUtensorMap map_q1,
                    const __grid_constant__ CUtensorMap map_f0,
                    const __grid_constant__ CUtensorMap map_f1, const Params p) {
  using Mma = typename T::template Mma<N>;
  constexpr int kStage = stage_bytes(T::kSplit, N);
  constexpr int kConsumers = 2 * QT;              // a warpgroup a 64 queries
  constexpr int kQTile = QT * kChunk;             // a K chunk of the query tile
  constexpr int kStep = kChunk / T::kElem;        // elements of a K chunk
  extern __shared__ unsigned char smem_raw[];
  // every tile on a 1,024-byte boundary: the swizzle's period
  unsigned char* smem = smem_raw + ((kGroupBytes - (smem_u32(smem_raw) & (kGroupBytes - 1)))
                                    & (kGroupBytes - 1));
  const int nkc = (p.d + kChunk - 1) / kChunk;
  const int stages = p.stages;
  unsigned char* ring = smem + query_bytes(nkc, QT);            // [stage][N rows][128 B] (x2)
  float* masks = reinterpret_cast<float*>(ring + stages * kStage);  // [stage][N]
  const uint32_t full0 = smem_u32(masks + stages * N);
  const uint32_t ready0 = full0 + 8 * kMaxStages, empty0 = ready0 + 8 * kMaxStages;
  const uint32_t q_full = empty0 + 8 * kMaxStages, q_empty = q_full + 8;
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * QT;
  int first, count;
  tile_range(p.n_vtiles, gridDim.y, blockIdx.y, first, count);

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(ready0 + 8 * s, kHelpers);
      mbar_init(empty0 + 8 * s, kConsumers);
    }
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumers);
    fence_mbar_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ------------------------------------------------ producer and helpers
    if constexpr (QT == 128) setmaxnreg_dec<40>();
    const int h = tid - kConsumers;
    if (h == 0) {
      prefetch_map(&map_q0);
      prefetch_map(&map_q1);
      prefetch_map(&map_f0);
      prefetch_map(&map_f1);
      int stage = 0;
      uint32_t phase = 0;
      for (int st = 0; st < p.n_streams; ++st) {
        // stream st's query tile, over stream v's once every consumer is done with it
        if (st == 1) mbar_wait(q_empty, 0);
        mbar_expect_tx(q_full, query_bytes(nkc, QT));
        for (int kc = 0; kc < nkc; ++kc)
          tma_load(smem_u32(smem + kc * kQTile), st ? &map_q1 : &map_q0, q_full, kc * kStep, q0);
        const CUtensorMap* map_f = st ? &map_f1 : &map_f0;
        for (int t = 0; t < count; ++t) {
          const int v0 = (first + t) * N;
          for (int l = 0; l < p.n_clips; ++l)
            for (int kc = 0; kc < nkc; ++kc) {
              mbar_wait(empty0 + 8 * stage, phase ^ 1);
              const uint32_t full = full0 + 8 * stage;
              mbar_expect_tx(full, N * kChunk);
              tma_load_3d(smem_u32(ring + stage * kStage), map_f, full, kc * kStep,
                          p.clip_inner ? l : v0, p.clip_inner ? v0 : l);
              if (++stage == stages) {
                stage = 0;
                phase ^= 1;
              }
            }
        }
      }
    } else if (h >= 32) {
      // the helpers: a clip's mask values (videos hh and hh + 96 of the
      // tile), loaded when its first chunk's turn comes and written beside
      // the stage of its last; in f32 each landed stage's rows become their
      // TF32 high halves in place and their low halves beside them (the
      // same swizzled offsets), visible to wgmma before ready
      const int hh = h - 32;
      int stage = 0;
      uint32_t phase = 0;
      float mk[2] = {0.0f, 0.0f};
      for (int st = 0; st < p.n_streams; ++st)
        for (int t = 0; t < count; ++t) {
          const int v0 = (first + t) * N;
          for (int l = 0; l < p.n_clips; ++l)
            for (int kc = 0; kc < nkc; ++kc) {
              if (kc == 0) {
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                  const int v = v0 + hh + j * kHelpers;
                  mk[j] = hh + j * kHelpers < N && v < p.nv
                              ? __ldg(p.mask + v * p.m_video + l * p.m_clip) : 0.0f;
                }
              }
              mbar_wait(full0 + 8 * stage, phase);
              if constexpr (T::kSplit) {
                uint4* hi = reinterpret_cast<uint4*>(ring + stage * kStage);
                uint4* lo = hi + N * kChunk / 16;
                for (int j = hh; j < N * kChunk / 16; j += kHelpers) {
                  const uint4 x = hi[j];
                  uint4 a, b;
                  s8mma::split_tf32(x.x, a.x, b.x);
                  s8mma::split_tf32(x.y, a.y, b.y);
                  s8mma::split_tf32(x.z, a.z, b.z);
                  s8mma::split_tf32(x.w, a.w, b.w);
                  hi[j] = a;
                  lo[j] = b;
                }
                fence_async_smem();
              }
              if (kc == nkc - 1) {
#pragma unroll
                for (int j = 0; j < 2; ++j)
                  if (hh + j * kHelpers < N) masks[stage * N + hh + j * kHelpers] = mk[j];
              }
              mbar_arrive(ready0 + 8 * stage);
              if (++stage == stages) {
                stage = 0;
                phase ^= 1;
              }
            }
        }
    }
  } else {
    // ---------------------------------------------------------- consumers
    if constexpr (QT == 128) setmaxnreg_inc<232>();
    const int wg = tid >> 7, t = tid & 127, warp = t >> 5, lane = t & 31, quad = lane & 3;
    const int qa = q0 + 64 * wg + 16 * warp + (lane >> 2);  // this thread's queries: qa, qa + 8
    const uint32_t a_wg = smem_u32(smem) + wg * 64 * kChunk;
    // tf32: this lane's ldmatrix address of k-step kk of a query chunk
    uint32_t a_off[kChunk / 32];
#pragma unroll
    for (int kk = 0; kk < kChunk / 32; ++kk)
      a_off[kk] = s8mma::swizzle(16 * warp + (lane & 15), 2 * kk + (lane >> 4), kChunk);
    int stage = 0;
    uint32_t phase = 0;
    constexpr int R = Mma::kRegs;
    float acc[R], best[R];
    auto advance = [&]() {
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
    };
    // one clip's products into acc: nkc ring stages, each but the last
    // handed back once the next one's products no longer need it; returns
    // the last one's stage, whose mask slot the fold reads
    auto clip_products = [&]() {
      int prev = 0;
      for (int kc = 0; kc < nkc; ++kc) {
        const uint32_t a = a_wg + kc * kQTile, b = smem_u32(ring + stage * kStage);
        if constexpr (T::kSplit) {
          // A: the chunk's four k-steps of this warp's 16 queries, split
          // into TF32 halves once the previous chunk's products (which read
          // the registers) are done; that stage is handed back then
          uint32_t raw[kChunk / 32][4];
#pragma unroll
          for (int kk = 0; kk < kChunk / 32; ++kk) s8mma::ldmatrix_x4(raw[kk], a + a_off[kk]);
          mbar_wait(ready0 + 8 * stage, phase);
          if (kc > 0) {
            wgmma_wait<0>();
            mbar_arrive(empty0 + 8 * prev);
          }
          uint32_t hi[kChunk / 32][4], lo[kChunk / 32][4];
#pragma unroll
          for (int kk = 0; kk < kChunk / 32; ++kk)
#pragma unroll
            for (int j = 0; j < 4; ++j) s8mma::split_tf32(raw[kk][j], hi[kk][j], lo[kk][j]);
          const uint32_t b_lo = b + N * kChunk;
          wgmma_fence();
          // lo.hi, hi.lo, then hi.hi: the small products first
#pragma unroll
          for (int kk = 0; kk < kChunk / 32; ++kk) {
            Mma::mma(acc, lo[kk], desc_sw128(b + 32 * kk), (kc | kk) != 0);
            Mma::mma(acc, hi[kk], desc_sw128(b_lo + 32 * kk), 1);
            Mma::mma(acc, hi[kk], desc_sw128(b + 32 * kk), 1);
          }
          wgmma_commit();
        } else {
          // the rows from the TMA, the mask slot from the helpers
          mbar_wait(full0 + 8 * stage, phase);
          mbar_wait(ready0 + 8 * stage, phase);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kChunk / 32; ++kk)
            Mma::mma(acc, desc_sw128(a + 32 * kk), desc_sw128(b + 32 * kk), (kc | kk) != 0);
          wgmma_commit();
          // the previous stage, once this one's products are in flight
          if (kc > 0) {
            wgmma_wait<1>();
            mbar_arrive(empty0 + 8 * prev);
          }
        }
        prev = stage;
        advance();
      }
      wgmma_wait<0>();
      fence_acc(acc);
      return prev;
    };

    // the clip's dots in a are whole: s * m + (1 - m) * -1e10, each
    // operation rounded on its own, into the running max (register 4 j + 2 h
    // + e is video 8 j + 2 quad + e); then stage s, whose slot holds the
    // mask, is handed back
    auto fold = [&](const float (&a)[R], int s) {
      const float* mk = masks + s * N + 2 * quad;
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const float2 m = *reinterpret_cast<const float2*>(mk + 8 * j);
        const float off0 = __fmul_rn(__fsub_rn(1.0f, m.x), kMasked);
        const float off1 = __fmul_rn(__fsub_rn(1.0f, m.y), kMasked);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h;
          best[i] = fmaxf(best[i], __fadd_rn(__fmul_rn(a[i], m.x), off0));
          best[i + 1] = fmaxf(best[i + 1], __fadd_rn(__fmul_rn(a[i + 1], m.y), off1));
        }
      }
      mbar_arrive(empty0 + 8 * s);
    };

    for (int st = 0; st < p.n_streams; ++st) {
      mbar_wait(q_full, st);
      const bool last = st == p.n_streams - 1;
      for (int tt = 0; tt < count; ++tt) {
        const int v0 = (first + tt) * N;
#pragma unroll
        for (int i = 0; i < R; ++i) best[i] = p.init;
        for (int l = 0; l < p.n_clips; ++l) {
          const int s_last = clip_products();
          fold(acc, s_last);
        }
        // the tile's maxima: stream v's wait in out; the last stream's are
        // combined with them (read back by the thread that wrote them),
        // through exp if asked, and written
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int q = qa + 8 * ((i >> 1) & 1), v = v0 + 8 * (i >> 2) + 2 * quad + (i & 1);
          if (q >= p.nq || v >= p.nv) continue;
          float* o = p.out + static_cast<size_t>(q) * p.nv + v;
          float score = best[i];
          if (last) {
            if (p.n_streams == 2) score = __fadd_rn(*o, score) / 2.0f;
            if (p.use_exp) score = expf(__fmul_rn(p.alpha, score));
          }
          *o = score;
        }
      }
      // every product of stream v is done: the producer may load stream s's
      // queries over its tile
      if (!last) mbar_arrive(q_empty);
    }
  }
}

struct Launch {
  const void* q[2];
  const void* f[2];
  int d;                       // bytes a row
  long long f_video, f_clip;   // cache strides in bytes
};

template <class T, int QT, int N>
int launch_as(const Launch& a, Params p, cudaStream_t stream) {
  const auto kernel = masked_score_kernel<T, QT, N>;
  const int nkc = (a.d + kChunk - 1) / kChunk;
  const int fit = fit_stages(nkc, QT, T::kSplit, N);
  p.stages = fit < kMaxStages ? fit : kMaxStages;
  if (p.stages < 2) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = kGroupBytes + query_bytes(nkc, QT) +
                    p.stages * (stage_bytes(T::kSplit, N) + 4 * N) + kBarBytes;
  // the cache's two outer axes ordered by stride: (D, clips, videos) when
  // the clips are the nearer (B9), else (D, videos, clips) (B10); equal
  // strides leave an axis of one entry, which goes first
  p.clip_inner = a.f_clip < a.f_video || (a.f_clip == a.f_video && p.n_clips == 1);
  const uint64_t k = a.d / T::kElem;
  CUtensorMap maps[4];
  int err = 0;
  for (int s = 0; s < 2 && !err; ++s) {
    err = encode_rows(&maps[s], T::kType, T::kElem, a.q[s], k, p.nq, QT);
    if (!err)
      err = p.clip_inner
                ? encode_3d(&maps[2 + s], T::kType, T::kElem, a.f[s], k, p.n_clips, a.f_clip,
                            p.nv, a.f_video, 1, N)
                : encode_3d(&maps[2 + s], T::kType, T::kElem, a.f[s], k, p.nv, a.f_video,
                            p.n_clips, a.f_clip, N, 1);
  }
  if (err) return err;
  cudaError_t r = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (r != cudaSuccess) return static_cast<int>(r);
  int device = 0, n_sm = 0;
  if ((r = cudaGetDevice(&device)) != cudaSuccess ||
      (r = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return static_cast<int>(r);
  p.n_vtiles = (p.nv + N - 1) / N;
  const int n_qtiles = (p.nq + QT - 1) / QT;
  // one block an SM: the query tiles of one range side by side
  int groups = n_sm / n_qtiles;
  groups = groups < 1 ? 1 : groups > p.n_vtiles ? p.n_vtiles : groups;
  kernel<<<dim3(n_qtiles, groups), 2 * QT + 128, bytes, stream>>>(maps[0], maps[1], maps[2],
                                                                   maps[3], p);
  return static_cast<int>(cudaGetLastError());
}

// rows past 1,024 bytes take the 64-query tile, f32 rows past 2,560 bytes
// also N = 64: a dispatch by shape between instances of the one kernel
template <class T>
int launch(const Launch& a, const Params& p, cudaStream_t stream) {
  if (a.d > kWideRowBytes) {
    if constexpr (T::kNarrowRowBytes < T::kMaxRowBytes) {
      if (a.d > T::kNarrowRowBytes) return launch_as<T, 64, 64>(a, p, stream);
    }
    return launch_as<T, 64, 128>(a, p, stream);
  }
  return launch_as<T, 128, 128>(a, p, stream);
}

}  // namespace

extern "C" {

// kind: 1 bf16, 2 f32 (the numbering of tvr_video_scores), both on wgmma.
// qs / fs may be null when n_streams is 1. d_words: the feature axis in
// 4-byte words (a multiple of 4; D <= 768). Cache strides in 4-byte words
// (multiples of 4: TMA's 16 bytes), mask strides in floats. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// shape the kernel does not take.
int tvr_masked_scores(int kind, const void* qv, const void* qs, const void* fv,
                      const void* fs, const void* mask, int nq, int nv, int n_clips,
                      int d_words, long long f_video, long long f_clip, long long m_video,
                      long long m_clip, int n_streams, float init, int use_exp, float alpha,
                      void* out, void* stream) {
  const int max_bytes = kind == 1 ? MaskedBf16::kMaxRowBytes : MaskedTf32x3::kMaxRowBytes;
  if (nq <= 0 || nv <= 0 || n_clips <= 0 || d_words <= 0 || d_words % 4 ||
      4 * d_words > max_bytes || f_video <= 0 || f_clip <= 0 || f_video % 4 || f_clip % 4 ||
      4 * f_video >= (1LL << 40) || 4 * f_clip >= (1LL << 40) || n_streams < 1 ||
      n_streams > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  Launch a;
  a.q[0] = qv;
  a.q[1] = n_streams == 2 ? qs : qv;
  a.f[0] = fv;
  a.f[1] = n_streams == 2 ? fs : fv;
  a.d = 4 * d_words;
  a.f_video = 4 * f_video;
  a.f_clip = 4 * f_clip;
  Params p;
  p.mask = static_cast<const float*>(mask);
  p.m_video = m_video; p.m_clip = m_clip;
  p.out = static_cast<float*>(out);
  p.nq = nq; p.nv = nv; p.n_clips = n_clips; p.d = a.d; p.n_streams = n_streams;
  p.clip_inner = 0;
  p.init = init; p.use_exp = use_exp; p.alpha = alpha;
  p.n_vtiles = 0; p.stages = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 1) return launch<MaskedBf16>(a, p, s);
  if (kind == 2) return launch<MaskedTf32x3>(a, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
