// Corpus video-score kernels for Hopper (sm_90a): the port of the Pallas
// video-score family in tvretrieval_tpu/ops/pallas_score.py.
//
//   B1 video_scores_pallas_flat_i8   (pallas_score.py:344-407)  kind 0, no bmax
//   B2 video_scores_pallas_flat      (pallas_score.py:103-179)  kind 1/2, no bmax
//   B3 video_scores_pallas_flat_bmax (pallas_score.py:231-341)  any kind, bmax
//
// What it computes. The feat1 caches are video-major flat arrays
// (Nv_pad * lp, D) whose masked and pad rows repeat a valid clip row
// (build_flat_feat1), so a video's score needs no mask: for each query q
// and video v, the max over v's lp rows of row . q, per stream, and then
//   int8:        (max_v + max_s) as int32 -> f32, times f32(0.5 / 127^2)
//   bf16 / f32:  (max_v + max_s) / 2 in f32.
// B3 also sets pad videos (v >= n_videos) to -inf and emits the max of
// every chunk_v consecutive videos, which the video top-k consumes.
//
// What bounds it on this card, and the design. The work is a GEMM of
// (Nv_pad * lp) x D rows against D x Nq queries (2 * 2.27M x 256 x 1000
// MACs at the full TVR corpus) whose (Nq, Nv_pad * lp) product is reduced
// by a segmented max. The TPU kernel exists to keep that product out of
// device memory, and so do these: only the (Nq, Nv) scores (and B3's block
// maxima) are written, so the bound is arithmetic (at the data sheet's
// peaks: 1.17 ms int8, 2.35 ms bf16, and 14.09 ms f32 counted as the three
// TF32 products of the cheapest f32-accurate route on this card).
//
// The int8 kind (B1, B3-int8) runs on wgmma fed by TMA
// (video_score_wgmma_kernel; shared pieces in s8_wgmma.cuh). A persistent
// block of three warpgroups owns 128 queries, both streams' query tiles
// resident in shared memory (TMA, zero-filled past nq), and walks a
// contiguous range of video tiles. A tile spans whole videos: floor(256 /
// lp) of them, so at lp = 104 two videos, N = 208 flat rows, a legal s8
// wgmma N (other lp: N = 256, the columns past the tile's videos ignored; a
// video longer than 256 rows spans consecutive segments of 256 with its
// max carried in registers). Warpgroup 2 is the producer: one thread keeps
// TMA loads of 128-byte K chunks of the tile's rows, stream v's then
// stream s's, in an mbarrier ring (six stages at D = 256). Warpgroups 0
// and 1 each own 64 queries: wgmma m64nNk32 (s8 x s8 -> s32 from shared
// memory), four k-steps a chunk, a stage handed back once the next chunk's
// products are in flight; both issue them even where their queries lie past
// nq (zero rows), since a branch around wgmma makes ptxas serialize the
// products (its C7518 warning), which cost 36% of the time on the H100. A
// warpgroup then holds every column of its
// videos for its 64 queries (104 s32 registers a thread at N = 208), so
// each thread folds its columns of each video with three-way maxima and two
// quad shuffles finish the max: no shared-memory atomics. At lp = 104 the
// columns of each video are known at compile time and stream v's maxima
// stay in registers until stream s's are folded; then one add and one f32
// multiply, and each lane of a quad stores one (query, video) score. Other
// lp fold with the video found at run time, stream v's maxima parked in
// shared memory (each slot written and read by one thread). B3's block
// maxima fold across the consecutive tiles of the block's range in
// registers and reach device memory by one float atomic max a (query,
// block), or two where a block straddles two ranges. The blocks of one
// range (one per query tile: 8 at Nq = 1,000, 16 ranges on 132 SMs) walk
// it side by side, so each row tile comes from device memory about once
// and from L2 once per query tile; TMA multicast across a cluster would
// read it from L2 once, but the walk keeps both streams' queries resident
// and needs no cluster launch. The cost: 128 of the 132 SMs at Nq = 1,000.
// Shared memory at D = 256: queries 2 x 2 x 16 KiB, the ring 6 x 26 KiB.
//
// The bf16 and f32 kinds (B2, B3-bf16, B3-f32) run on wgmma fed by TMA
// too (video_score_float_kernel): the same persistent walk, producer
// thread, mbarrier ring, zero rows past nq (products issued on them, no
// branch around wgmma) and per-video fold through the accumulator layout,
// which is the same for f32 sums as for s32 ones. Their bound is
// arithmetic as well (2.35 ms bf16, 14.09 ms f32 at the full corpus), so
// what they need is the tensor core fed without pause, and what they lack
// is shared memory: a bf16 query tile of 128 queries is 64 KiB a stream at
// D = 256, an f32 one 128 KiB. So a block keeps ONE stream's query tile
// and walks its range of video tiles twice: stream v's rows against stream
// v's queries, writing each (query, video) max to out, then, with stream
// s's queries loaded over the first (the producer waits on a barrier that
// every consumer passes when its last product of stream v is done), stream
// s's rows, each max combined with stream v's read back from out (loaded
// before the tile's products; the lane that wrote it reads it) into (mv +
// ms) / 2 in f32, in that order. At the full corpus that is 87 MB written
// and read back, ~0.05 ms at the memory's rate. B3's block maxima fold in
// the second pass.
//   bf16: wgmma m64nNk16 (bf16 x bf16 -> f32, A and B from shared memory),
//   N = 208 at lp = 104 (two videos), else 256 (as the int8 kind). Shared
//   memory at D = 256: the query tile 4 x 16 KiB, six ring stages of 208
//   rows x 128 bytes (26 KiB), the barriers; at D = 512 (the widest row,
//   128 KiB of queries) three stages of 256 rows.
//   f32: three tf32 products a k-step of 8 (a 3xTF32 split, below), wgmma
//   m64nNk8 with A from registers: each consumer thread loads its A
//   fragments of a chunk's four k-steps from the raw query tile (ldmatrix)
//   and splits them (split_tf32) once the previous chunk's products are
//   done; the rows are B, from the ring, where warps 1-3 of the producer
//   warpgroup round each landed chunk to its TF32 high halves in place and
//   write its low halves beside it (the same swizzled offsets; then
//   fence.proxy.async and a third barrier a stage, "ready", that the
//   consumers wait on instead of "full"). Products in the 3xTF32 order of
//   s8_mma.cuh: lo.hi, hi.lo, hi.hi into the one f32 accumulator. A stage is
//   twice the rows' bytes, so N = 104 at lp = 104 (one video a tile; a 208-row
//   stage of 52 KiB would leave one stage beside the 128 KiB query tile),
//   else 128. Shared memory at D = 256: the query tile 8 x 16 KiB, three
//   stages of 2 x 13 KiB, the barriers. Rows wider than 1,024 bytes (256 <
//   D <= 640) take a 64-query tile and one consumer warpgroup: at D = 384
//   the query tile is 96 KiB and four stages fit, at D = 640 (160 KiB) two.
// The shapes taken: bf16 rows up to 1,024 bytes, f32 rows up to 2,560,
// any lp % 8 == 0 (lp > N: a video over segments of N rows), any nq.
//
// Exactness. Integer accumulation and max are exact, and the int8 rescale
// is the same single f32 multiply by f32(0.5 / 16129) that JAX does, so B1
// and B3-int8 are bit-equal to their plain versions. The bf16 kind's
// tolerance argument:
//  1. a bf16 x bf16 product is exact in f32 (8 + 8 significant bits), and
//     the plain version upcasts to f32 and multiplies there with TF32 off
//     (tvretrieval_tpu_torch/__init__.py), so both sides sum the same D
//     exact products in f32 and differ only in the order of the sums;
//  2. the engine L2-normalizes queries and caches, so sum |q_i f_i| <=
//     |q| |f| ~ 1, and any order's rounding error is at most (D - 1) 2^-24
//     ~ 1.5e-5 at D = 256 in the worst case and ~ sqrt(D) 2^-24 ~ 1e-6 in
//     practice; a max over rows and the halving combine add nothing to it;
//  3. the TPU kernel itself sums on the MXU in f32
//     (preferred_element_type=jnp.float32), so the tensor cores are closer
//     to the reference's own arithmetic than FMA is;
//  4. nothing sums in reduced precision: no split-K, no bf16 partial sums.
// The f32 kind adds the 3xTF32 split's ~3 2^-22 per unit of sum |q_i f_i|
// (the argument in s8_mma.cuh): both operands are split with
// round-to-nearest (rna) into TF32 halves before the tensor core sees
// them, so it reads exact TF32 values and nothing rests on how it treats
// the low 13 bits of a register; on inputs exact in TF32 the low halves
// are zero and the sums are exact. A k-step of wgmma m64nNk8 sums the same
// 8 products of each of the three terms as a k-step of mma.sync m16n8k8,
// in the same order, so the argument moved with the kernel unchanged. So B2
// / B3 in bf16 and f32 are held to 1e-5 of their plain versions
// (tests/test_torch_mma_order.py models both orders on the CPU).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (tvretrieval_tpu_torch/ops/_build.py). C interface, loaded with
// ctypes; the entry point returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <chrono>

#include "s8_mma.cuh"
#include "s8_wgmma.cuh"

namespace {

// float max through integer atomics: floats with the sign bit clear order
// like signed ints, floats with it set (-0.0 included) order reversed as
// unsigned ints
__device__ void atomic_max_float(float* addr, float value) {
  if (__float_as_int(value) >= 0)
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(value));
  else
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(value));
}

// JAX: (mv + ms).astype(f32) * (0.5 / (127.0 * 127.0)), the constant
// rounded once from double to f32
__device__ __forceinline__ float i8_score(int v, int s) {
  return static_cast<float>(v + s) * static_cast<float>(0.5 / 16129.0);
}

// -------------------------------------------- the int8 kind: wgmma + TMA

using namespace s8wg;

constexpr int kWgThreads = 384;         // consumer warpgroups 0, 1; the producer's 2
constexpr int kWgQueries = 128;         // the query tile: 64 a consumer warpgroup
constexpr int kSegRows = 256;           // the widest wgmma N: a segment of a longer video
constexpr int kQChunk = kWgQueries * kChunk;        // 16 KiB: a K chunk of a query tile
constexpr int kMaxStages = 8;
constexpr int kBarBytes = 3 * kMaxStages * 8;       // full, empty, the query tiles'
constexpr int kSlots = 32;              // videos a tile at most (lp = 8)
constexpr int kSlotBytes = 2 * 64 * kSlots * 4;     // stream v's maxima of the run-time fold
constexpr int kI8MaxRowBytes = 384;     // three K chunks

// the wgmma N: lp = 104 (the model's 100 clips) two videos of 104 rows,
// otherwise 256 rows
template <int LP>
struct TileN {
  static constexpr int N = 256;
};
template <>
struct TileN<104> {
  static constexpr int N = 208;
};

__host__ __device__ constexpr int wg_query_bytes(int nkc) { return 2 * nkc * kQChunk; }
__host__ __device__ constexpr int wg_slot_bytes(bool fixed) { return fixed ? 0 : kSlotBytes; }
// ring stages that fit beside the query tiles, the slots and the barriers
// (and the 1 KiB the alignment may take)
__host__ __device__ constexpr int wg_stages(int nkc, int n, bool fixed) {
  return (kMaxSmem - kGroupBytes - kBarBytes - wg_query_bytes(nkc) - wg_slot_bytes(fixed)) /
         (n * kChunk);
}
static_assert(wg_stages(2, 208, true) >= 6, "D = 256, lp = 104: six stages");
static_assert(wg_stages(3, 256, false) >= 3, "D = 384: three stages");

// q: (nq, d) int8 query rows of each stream (map_qv / map_qs: boxes of 128
// queries x 128 bytes); f: (nv_pad * lp, d) flat rows (map_fv / map_fs:
// boxes of N rows x 128 bytes). out: (nq, out_cols). bmax == nullptr:
// write videos < n_videos (B1). Otherwise (B3) write all nv_pad videos with
// pad videos at -inf, and fold each chunk-video block's max into bmax (nq,
// nv_pad / chunk), which the caller fills with -inf (chunk = gcd(nv_pad,
// chunk_v)). LP: lp fixed at compile time (104), or 0
// (read from lp). Block (x, y): query tile x, the y-th of gridDim.y
// contiguous ranges of the n_vtiles video tiles.
template <int LP>
__global__ void __launch_bounds__(kWgThreads, 1)
video_score_wgmma_kernel(const __grid_constant__ CUtensorMap map_qv,
                         const __grid_constant__ CUtensorMap map_qs,
                         const __grid_constant__ CUtensorMap map_fv,
                         const __grid_constant__ CUtensorMap map_fs, int nq, int nv_pad, int lp,
                         int d, int n_videos, float* __restrict__ out, int out_cols,
                         float* __restrict__ bmax, int chunk, int n_vtiles, int stages) {
  constexpr bool kFixed = LP > 0;
  constexpr int N = TileN<LP>::N;
  constexpr int kStage = N * kChunk;
  extern __shared__ unsigned char smem_raw[];
  // every tile on a 1,024-byte boundary: the swizzle's period
  unsigned char* smem = smem_raw + ((kGroupBytes - (smem_u32(smem_raw) & (kGroupBytes - 1)))
                                    & (kGroupBytes - 1));
  const int nkc = (d + kChunk - 1) / kChunk;
  unsigned char* ring = smem + wg_query_bytes(nkc);             // [stage][N rows][128 B]
  int* slots = reinterpret_cast<int*>(ring + stages * kStage);  // [wg][row][video]
  const uint32_t full0 = smem_u32(ring + stages * kStage + wg_slot_bytes(kFixed));
  const uint32_t empty0 = full0 + 8 * kMaxStages, q_full = empty0 + 8 * kMaxStages;
  // videos a tile, segments a video (1 unless lp > 256), the tile's rows
  const int vpt = kFixed ? N / (kFixed ? LP : 1) : lp <= kSegRows ? kSegRows / lp : 1;
  const int n_seg = (lp + kSegRows - 1) / kSegRows;
  const int span = vpt * lp;
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kWgQueries;
  int first, count;
  tile_range(n_vtiles, gridDim.y, blockIdx.y, first, count);

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2 * 128);         // every consumer thread
    }
    mbar_init(q_full, 1);
    fence_mbar_init();
  }
  __syncthreads();

  if (tid >= 256) {
    // ---------------------------------------------------------- producer
    setmaxnreg_dec<40>();
    if (tid == 256) {
      prefetch_map(&map_qv);
      prefetch_map(&map_qs);
      prefetch_map(&map_fv);
      prefetch_map(&map_fs);
      mbar_expect_tx(q_full, wg_query_bytes(nkc));
      for (int st = 0; st < 2; ++st)
        for (int kc = 0; kc < nkc; ++kc)
          tma_load(smem_u32(smem + (st * nkc + kc) * kQChunk), st ? &map_qs : &map_qv, q_full,
                   kc * kChunk, q0);
      int stage = 0;
      uint32_t phase = 0;
      for (int t = 0; t < count; ++t) {
        const int row0 = (first + t) * span;
        for (int st = 0; st < 2; ++st)
          for (int seg = 0; seg < n_seg; ++seg)
            for (int kc = 0; kc < nkc; ++kc) {
              mbar_wait(empty0 + 8 * stage, phase ^ 1);
              const uint32_t full = full0 + 8 * stage;
              mbar_expect_tx(full, kStage);
              tma_load(smem_u32(ring + stage * kStage), st ? &map_fs : &map_fv, full,
                       kc * kChunk, row0 + seg * kSegRows);
              if (++stage == stages) {
                stage = 0;
                phase ^= 1;
              }
            }
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    setmaxnreg_inc<232>();
    const int wg = tid >> 7, t = tid & 127, lane = t & 31, quad = lane & 3;
    const int ra = 16 * (t >> 5) + (lane >> 2);   // this thread's tile rows: ra, ra + 8
    const int qa = q0 + 64 * wg + ra;             // ... its queries: qa, qa + 8
    const uint32_t a_wg = smem_u32(smem) + wg * 64 * kChunk;
    // B3: lanes 0 and 1 of a quad keep the running block maximum of query
    // qa and qa + 8 over the block's consecutive videos
    const int q_bm = qa + 8 * (quad & 1);
    float* bm_row = bmax != nullptr && quad < 2 && q_bm < nq
                        ? bmax + static_cast<size_t>(q_bm) * (nv_pad / chunk) : nullptr;
    float bm = -INFINITY;
    int bm_chunk = -1;
    auto bm_push = [&](int v, float score) {
      const int c = v / chunk;
      if (c != bm_chunk) {
        if (bm_chunk >= 0) atomic_max_float(bm_row + bm_chunk, bm);
        bm_chunk = c;
        bm = -INFINITY;
      }
      bm = fmaxf(bm, score);
    };
    mbar_wait(q_full, 0);
    int stage = 0;
    uint32_t phase = 0;
    int acc[Wgmma<N>::kRegs];
    // stream st's products of the tile's next segment into acc: nkc ring
    // stages, each handed back once the next one's products are issued
    auto mainloop = [&](int st) {
      const uint32_t a0 = a_wg + st * nkc * kQChunk;
      int prev = 0;
      for (int kc = 0; kc < nkc; ++kc) {
        mbar_wait(full0 + 8 * stage, phase);
        const uint32_t a = a0 + kc * kQChunk, b = smem_u32(ring + stage * kStage);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kChunk / 32; ++kk)
          Wgmma<N>::mma(acc, desc_sw128(a + 32 * kk), desc_sw128(b + 32 * kk), (kc | kk) != 0);
        wgmma_commit();
        if (kc > 0) {
          wgmma_wait<1>();
          mbar_arrive(empty0 + 8 * prev);
        }
        prev = stage;
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      mbar_arrive(empty0 + 8 * prev);
    };
    auto quad_max = [](int v) {
      v = max(v, __shfl_xor_sync(0xffffffffu, v, 1));
      return max(v, __shfl_xor_sync(0xffffffffu, v, 2));
    };

    for (int tt = 0; tt < count; ++tt) {
      const int v0 = (first + tt) * vpt;
      if constexpr (kFixed) {
        // video v of the tile is column groups v G .. v G + G - 1 (8 columns
        // each): stream v's maxima in registers, then stream s's
        constexpr int VPT = N / LP, G = LP / 8;
        static_assert(VPT * LP == N && LP % 8 == 0, "whole videos a tile");
        int mx[2][2][VPT];                        // stream, row ra / ra + 8, video
        for (int st = 0; st < 2; ++st) {
          mainloop(st);
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int v = 0; v < VPT; ++v) {
              int m = INT_MIN;
#pragma unroll
              for (int g = 0; g < G; ++g)
                m = __vimax3_s32(m, acc[4 * (v * G + g) + 2 * h], acc[4 * (v * G + g) + 2 * h + 1]);
              mx[st][h][v] = quad_max(m);
            }
        }
        float sc[2][VPT];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int v = 0; v < VPT; ++v) {
            const int vv = v0 + v, q = qa + 8 * h;
            sc[h][v] = bmax != nullptr && vv >= n_videos ? -INFINITY
                                                          : i8_score(mx[0][h][v], mx[1][h][v]);
            // the quad's lanes share the stores: one (query, video) each
            if (((h * VPT + v) & 3) == quad && q < nq && vv < nv_pad &&
                (bmax != nullptr || vv < n_videos))
              out[static_cast<size_t>(q) * out_cols + vv] = sc[h][v];
          }
        if (bm_row != nullptr)
#pragma unroll
          for (int v = 0; v < VPT; ++v)
            if (v0 + v < nv_pad) bm_push(v0 + v, quad ? sc[1][v] : sc[0][v]);
      } else {
        // the video of each 8-column group found at run time; at a change of
        // video the quad's max goes to its slot (stream v) or is combined
        // with the slot into the score (stream s)
        for (int st = 0; st < 2; ++st) {
          int run[2] = {INT_MIN, INT_MIN};
          int cur = 0;
          auto flush = [&](int vl) {
            const int m0 = quad_max(run[0]), m1 = quad_max(run[1]);
            if (quad >= 2) return;
            int* slot = slots + ((wg * 64 + ra + 8 * quad) * kSlots + vl);
            const int m = quad ? m1 : m0;
            if (st == 0) {
              *slot = m;
              return;
            }
            const int q = qa + 8 * quad, vv = v0 + vl;
            if (q >= nq || vv >= nv_pad) return;
            const float score =
                bmax != nullptr && vv >= n_videos ? -INFINITY : i8_score(*slot, m);
            if (bmax != nullptr || vv < n_videos)
              out[static_cast<size_t>(q) * out_cols + vv] = score;
            if (bm_row != nullptr) bm_push(vv, score);
          };
          for (int seg = 0; seg < n_seg; ++seg) {
            mainloop(st);
#pragma unroll
            for (int j = 0; j < N / 8; ++j) {
              const int col = seg * kSegRows + 8 * j;
              if (col >= span) break;
              const int vl = col / lp;
              if (vl != cur) {
                flush(cur);
                cur = vl;
                run[0] = run[1] = INT_MIN;
              }
              run[0] = __vimax3_s32(run[0], acc[4 * j], acc[4 * j + 1]);
              run[1] = __vimax3_s32(run[1], acc[4 * j + 2], acc[4 * j + 3]);
            }
          }
          flush(cur);
        }
      }
    }
    if (bm_row != nullptr && bm_chunk >= 0) atomic_max_float(bm_row + bm_chunk, bm);
  }
}

// the four tensor maps of a launch: both streams' queries and flat rows
int encode_i8_maps(CUtensorMap (&m)[4], const void* qv, const void* qs, const void* fv,
                   const void* fs, int nq, long long rows, int d, int n) {
  int err;
  if ((err = encode_s8_rows(&m[0], qv, d, nq, kWgQueries)) ||
      (err = encode_s8_rows(&m[1], qs, d, nq, kWgQueries)) ||
      (err = encode_s8_rows(&m[2], fv, d, rows, n)) ||
      (err = encode_s8_rows(&m[3], fs, d, rows, n)))
    return err;
  return 0;
}

template <int LP>
int launch_wgmma_as(const void* qv, const void* qs, const void* fv, const void* fs, int nq,
                    int nv_pad, int lp, int d, int n_videos, void* out, int out_cols, void* bmax,
                    int chunk, cudaStream_t stream) {
  const auto kernel = video_score_wgmma_kernel<LP>;
  constexpr int N = TileN<LP>::N;
  const int nkc = (d + kChunk - 1) / kChunk;
  const int fit = wg_stages(nkc, N, LP > 0);
  const int stages = fit < kMaxStages ? fit : kMaxStages;
  const int bytes = kGroupBytes + wg_query_bytes(nkc) + stages * N * kChunk +
                    wg_slot_bytes(LP > 0) + kBarBytes;
  CUtensorMap maps[4];
  int err = encode_i8_maps(maps, qv, qs, fv, fs, nq, static_cast<long long>(nv_pad) * lp, d, N);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  int device = 0, n_sm = 0;
  if ((e = cudaGetDevice(&device)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return static_cast<int>(e);
  const int vpt = LP > 0 ? N / (LP > 0 ? LP : 1) : lp <= kSegRows ? kSegRows / lp : 1;
  const int n_vtiles = (nv_pad + vpt - 1) / vpt;
  const int n_qtiles = (nq + kWgQueries - 1) / kWgQueries;
  // one block an SM: the query tiles of one range side by side
  int groups = n_sm / n_qtiles;
  groups = groups < 1 ? 1 : groups > n_vtiles ? n_vtiles : groups;
  kernel<<<dim3(n_qtiles, groups), kWgThreads, bytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], nq, nv_pad, lp, d, n_videos, static_cast<float*>(out),
      out_cols, static_cast<float*>(bmax), chunk, n_vtiles, stages);
  return static_cast<int>(cudaGetLastError());
}

// d: a feature row in bytes (a multiple of 16, at most 384)
int launch_wgmma(const void* qv, const void* qs, const void* fv, const void* fs, int nq,
                 int nv_pad, int lp, int d, int n_videos, void* out, int out_cols, void* bmax,
                 int chunk, cudaStream_t stream) {
  if (d <= 0 || d % 16 || d > kI8MaxRowBytes || lp <= 0 || lp % 8 || nq <= 0 || nv_pad <= 0 ||
      chunk <= 0 || static_cast<long long>(nv_pad) * lp + kSegRows > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (lp == 104)
    return launch_wgmma_as<104>(qv, qs, fv, fs, nq, nv_pad, lp, d, n_videos, out, out_cols, bmax,
                                chunk, stream);
  return launch_wgmma_as<0>(qv, qs, fv, fs, nq, nv_pad, lp, d, n_videos, out, out_cols, bmax,
                            chunk, stream);
}

// ------------------------------------- the bf16 and f32 kinds: wgmma + TMA

// The two float kinds' products (the design in the note at the top).
// Bf16Wg: bf16 x bf16 -> f32, both operands from shared memory
// (WgmmaBf16), a tile of N = 208 rows at lp = 104, else 256. Tf32x3Wg:
// three tf32 products a k-step, A (the queries) from registers
// (WgmmaTf32), a tile of N = 104 rows at lp = 104, else 128; a ring stage
// holds the rows' TF32 high halves and, beside them, their low halves.
struct Bf16Wg {
  static constexpr bool kSplit = false;
  static constexpr int kElem = 2;
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static constexpr int kMaxRowBytes = 1024;       // D <= 512
  static constexpr int kWideRowBytes = 1024;      // no row takes the 64-query tile
  __host__ __device__ static constexpr int tile_n(int lp) { return lp == 104 ? 208 : 256; }
  template <int N>
  using Mma = WgmmaBf16<N>;
};

struct Tf32x3Wg {
  static constexpr bool kSplit = true;
  static constexpr int kElem = 4;
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  static constexpr int kMaxRowBytes = 2560;       // D <= 640
  static constexpr int kWideRowBytes = 1024;      // rows past D = 256: the 64-query tile
  __host__ __device__ static constexpr int tile_n(int lp) { return lp == 104 ? 104 : 128; }
  template <int N>
  using Mma = WgmmaTf32<N>;
};

constexpr int kFloatBarBytes = 4 * kMaxStages * 8;  // full, ready, empty; the query tile's two
constexpr int kSplitThreads = 96;                   // warps 1-3 of the producer warpgroup

__host__ __device__ constexpr int fl_stage_bytes(bool split, int n) {
  return (split ? 2 : 1) * n * kChunk;
}
__host__ __device__ constexpr int fl_query_bytes(int nkc, int qt) { return nkc * qt * kChunk; }
// ring stages that fit beside one stream's query tile and the barriers
// (and the 1 KiB the alignment may take)
__host__ __device__ constexpr int fl_stages(int nkc, int qt, int stage) {
  return (kMaxSmem - kGroupBytes - kFloatBarBytes - fl_query_bytes(nkc, qt)) / stage;
}
static_assert(fl_stages(4, 128, fl_stage_bytes(false, 208)) >= 6, "bf16 D = 256, lp = 104");
static_assert(fl_stages(8, 128, fl_stage_bytes(false, 256)) >= 3, "bf16 D = 512: three stages");
static_assert(fl_stages(8, 128, fl_stage_bytes(true, 104)) >= 3, "f32 D = 256, lp = 104");
static_assert(fl_stages(8, 128, fl_stage_bytes(true, 128)) >= 3, "f32 D = 256: three stages");
static_assert(fl_stages(12, 64, fl_stage_bytes(true, 104)) >= 4, "f32 D = 384: four stages");
static_assert(fl_stages(20, 64, fl_stage_bytes(true, 128)) >= 2, "f32 D = 640: two stages");

// q: (nq, d / kElem) query rows of each stream (map_qv / map_qs: boxes of
// QT queries x 128 bytes); f: (nv_pad * lp, d / kElem) flat rows (map_fv /
// map_fs: boxes of N rows x 128 bytes). out, bmax, chunk, n_vtiles, stages
// as video_score_wgmma_kernel. QT: 128 queries, two consumer warpgroups,
// or 64, one (f32 rows wider than 1,024 bytes). The block walks its range
// of video tiles twice, stream v's rows against stream v's queries, then
// stream s's against stream s's: the first pass writes each (query, video)
// max to out, the second reads it back into (mv + ms) / 2.
template <class T, int LP, int QT>
__global__ void __launch_bounds__(2 * QT + 128, 1)
video_score_float_kernel(const __grid_constant__ CUtensorMap map_qv,
                         const __grid_constant__ CUtensorMap map_qs,
                         const __grid_constant__ CUtensorMap map_fv,
                         const __grid_constant__ CUtensorMap map_fs, int nq, int nv_pad, int lp,
                         int d, int n_videos, float* __restrict__ out, int out_cols,
                         float* __restrict__ bmax, int chunk, int n_vtiles, int stages) {
  using Mma = typename T::template Mma<T::tile_n(LP)>;
  constexpr bool kFixed = LP > 0;
  constexpr int N = T::tile_n(LP);
  constexpr int kStage = fl_stage_bytes(T::kSplit, N);
  constexpr int kConsumers = 2 * QT;              // consumer threads: a warpgroup a 64 queries
  constexpr int kQTile = QT * kChunk;             // a K chunk of the query tile
  extern __shared__ unsigned char smem_raw[];
  // every tile on a 1,024-byte boundary: the swizzle's period
  unsigned char* smem = smem_raw + ((kGroupBytes - (smem_u32(smem_raw) & (kGroupBytes - 1)))
                                    & (kGroupBytes - 1));
  const int nkc = (d + kChunk - 1) / kChunk;
  unsigned char* ring = smem + fl_query_bytes(nkc, QT);         // [stage][N rows][128 B] (x2)
  const uint32_t full0 = smem_u32(ring + stages * kStage);
  const uint32_t ready0 = full0 + 8 * kMaxStages, empty0 = ready0 + 8 * kMaxStages;
  const uint32_t q_full = empty0 + 8 * kMaxStages, q_empty = q_full + 8;
  // videos a tile, segments a video (1 unless lp > N), the tile's rows
  const int vpt = kFixed ? N / (kFixed ? LP : 1) : lp <= N ? N / lp : 1;
  const int n_seg = kFixed ? 1 : (lp + N - 1) / N;
  const int span = vpt * lp;
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * QT;
  int first, count;
  tile_range(n_vtiles, gridDim.y, blockIdx.y, first, count);

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      if constexpr (T::kSplit) mbar_init(ready0 + 8 * s, kSplitThreads);
      mbar_init(empty0 + 8 * s, kConsumers);
    }
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumers);
    fence_mbar_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---------------------------------------------------------- producer
    if constexpr (QT == 128) setmaxnreg_dec<40>();
    const int p = tid - kConsumers;
    if (p == 0) {
      prefetch_map(&map_qv);
      prefetch_map(&map_qs);
      prefetch_map(&map_fv);
      prefetch_map(&map_fs);
      int stage = 0;
      uint32_t phase = 0;
      for (int st = 0; st < 2; ++st) {
        // stream st's query tile, over stream v's once every consumer is done with it
        if (st == 1) mbar_wait(q_empty, 0);
        mbar_expect_tx(q_full, fl_query_bytes(nkc, QT));
        for (int kc = 0; kc < nkc; ++kc)
          tma_load(smem_u32(smem + kc * kQTile), st ? &map_qs : &map_qv, q_full,
                   kc * (kChunk / T::kElem), q0);
        for (int t = 0; t < count; ++t) {
          const int row0 = (first + t) * span;
          for (int seg = 0; seg < n_seg; ++seg)
            for (int kc = 0; kc < nkc; ++kc) {
              mbar_wait(empty0 + 8 * stage, phase ^ 1);
              const uint32_t full = full0 + 8 * stage;
              mbar_expect_tx(full, N * kChunk);
              tma_load(smem_u32(ring + stage * kStage), st ? &map_fs : &map_fv, full,
                       kc * (kChunk / T::kElem), row0 + seg * N);
              if (++stage == stages) {
                stage = 0;
                phase ^= 1;
              }
            }
        }
      }
    } else if constexpr (T::kSplit) {
      if (p >= 32) {
        // warps 1-3: each landed stage's rows become their TF32 high halves
        // in place and their low halves beside them (the same swizzled
        // offsets), visible to wgmma before the stage is handed on
        const int n_steps = 2 * count * n_seg * nkc;
        int stage = 0;
        uint32_t phase = 0;
        for (int i = 0; i < n_steps; ++i) {
          mbar_wait(full0 + 8 * stage, phase);
          uint4* hi = reinterpret_cast<uint4*>(ring + stage * kStage);
          uint4* lo = hi + N * kChunk / 16;
          for (int j = p - 32; j < N * kChunk / 16; j += kSplitThreads) {
            const uint4 x = hi[j];
            uint4 h, l;
            s8mma::split_tf32(x.x, h.x, l.x);
            s8mma::split_tf32(x.y, h.y, l.y);
            s8mma::split_tf32(x.z, h.z, l.z);
            s8mma::split_tf32(x.w, h.w, l.w);
            hi[j] = h;
            lo[j] = l;
          }
          fence_async_smem();
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
    const int ra = 16 * warp + (lane >> 2);       // this thread's tile rows: ra, ra + 8
    const int qa = q0 + 64 * wg + ra;             // ... its queries: qa, qa + 8
    const uint32_t a_wg = smem_u32(smem) + wg * 64 * kChunk;
    // the fixed fold: lane quad of a quad stores the (query, video) of row
    // h_own, video v_own of the tile's VPT, if quad < 2 VPT
    constexpr int VPT = kFixed ? N / (kFixed ? LP : 1) : 1;
    static_assert(!kFixed || (VPT * LP == N && LP % 8 == 0 && VPT <= 2), "whole videos a tile");
    const int h_own = quad / VPT, v_own = quad % VPT;
    const bool own = quad < 2 * VPT;
    // B3: one lane a query row keeps its running block maximum over the
    // block's consecutive videos (fixed: the lane of the row's first
    // video; otherwise lanes 0 and 1, rows ra and ra + 8)
    const int h_bm = kFixed ? h_own : quad;
    const int q_bm = qa + 8 * h_bm;
    const bool bm_lane = kFixed ? own && v_own == 0 : quad < 2;
    float* bm_row = bmax != nullptr && bm_lane && q_bm < nq
                        ? bmax + static_cast<size_t>(q_bm) * (nv_pad / chunk) : nullptr;
    float bm = -INFINITY;
    int bm_chunk = -1;
    auto bm_push = [&](int v, float score) {
      const int c = v / chunk;
      if (c != bm_chunk) {
        if (bm_chunk >= 0) atomic_max_float(bm_row + bm_chunk, bm);
        bm_chunk = c;
        bm = -INFINITY;
      }
      bm = fmaxf(bm, score);
    };
    // tf32: this lane's ldmatrix address of k-step kk of a query chunk
    uint32_t a_off[kChunk / 32];
#pragma unroll
    for (int kk = 0; kk < kChunk / 32; ++kk)
      a_off[kk] = s8mma::swizzle(16 * warp + (lane & 15), 2 * kk + (lane >> 4), kChunk);
    int stage = 0;
    uint32_t phase = 0;
    float acc[Mma::kRegs];
    auto advance = [&]() {
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
    };
    // the products of the tile's next segment into acc: nkc ring stages
    auto mainloop = [&]() {
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
          mbar_wait(full0 + 8 * stage, phase);
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
      mbar_arrive(empty0 + 8 * prev);
    };
    auto quad_max = [](float v) {
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
      return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
    };

    for (int st = 0; st < 2; ++st) {
      mbar_wait(q_full, st);
      for (int tt = 0; tt < count; ++tt) {
        const int v0 = (first + tt) * vpt;
        if constexpr (kFixed) {
          // video v of the tile is column groups v G .. v G + G - 1 (8
          // columns each); this lane's (query, video) in out, and in the
          // second pass stream v's max there, loaded before the products
          constexpr int G = LP / 8;
          const int q = qa + 8 * h_own, vv = v0 + v_own;
          const size_t o = static_cast<size_t>(q) * out_cols + vv;
          const bool in_out = own && q < nq && vv < n_videos;
          float mv = 0.0f;
          if (st == 1 && in_out) mv = out[o];
          mainloop();
          float mine = -INFINITY;
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int v = 0; v < VPT; ++v) {
              float m = -INFINITY;
#pragma unroll
              for (int g = 0; g < G; ++g)
                m = fmaxf(m, fmaxf(acc[4 * (v * G + g) + 2 * h], acc[4 * (v * G + g) + 2 * h + 1]));
              m = quad_max(m);
              if (h * VPT + v == quad) mine = m;
            }
          if (st == 0) {
            if (in_out) out[o] = mine;
            continue;
          }
          float sc = (mv + mine) / 2.0f;
          if (bmax != nullptr && vv >= n_videos) sc = -INFINITY;
          if (own && q < nq && vv < nv_pad && (bmax != nullptr || vv < n_videos)) out[o] = sc;
          // the row's scores of the tile's videos reach its block-maximum lane
#pragma unroll
          for (int v = 0; v < VPT; ++v) {
            const float s_v = __shfl_sync(0xffffffffu, sc, (lane & ~3) | ((h_own * VPT + v) & 3));
            if (bm_row != nullptr && v0 + v < nv_pad) bm_push(v0 + v, s_v);
          }
        } else {
          // the video of each 8-column group found at run time; at a change
          // of video the quad's max goes to out (first pass) or is combined
          // with stream v's max there (second)
          float run[2] = {-INFINITY, -INFINITY};
          int cur = 0;
          auto flush = [&](int vl) {
            const float m0 = quad_max(run[0]), m1 = quad_max(run[1]);
            const int q = qa + 8 * quad, vv = v0 + vl;
            if (quad >= 2 || q >= nq || vv >= nv_pad) return;
            const float m = quad ? m1 : m0;
            const size_t o = static_cast<size_t>(q) * out_cols + vv;
            if (st == 0) {
              if (vv < n_videos) out[o] = m;
              return;
            }
            const float score = vv >= n_videos ? -INFINITY : (out[o] + m) / 2.0f;
            if (bmax != nullptr || vv < n_videos) out[o] = score;
            if (bm_row != nullptr) bm_push(vv, score);
          };
          for (int seg = 0; seg < n_seg; ++seg) {
            mainloop();
#pragma unroll
            for (int j = 0; j < N / 8; ++j) {
              const int col = seg * N + 8 * j;
              if (col >= span) break;
              const int vl = col / lp;
              if (vl != cur) {
                flush(cur);
                cur = vl;
                run[0] = run[1] = -INFINITY;
              }
              run[0] = fmaxf(run[0], fmaxf(acc[4 * j], acc[4 * j + 1]));
              run[1] = fmaxf(run[1], fmaxf(acc[4 * j + 2], acc[4 * j + 3]));
            }
          }
          flush(cur);
        }
      }
      // every product of stream v is done: the producer may load stream s's
      // queries over its tile
      if (st == 0) mbar_arrive(q_empty);
    }
    if (bm_row != nullptr && bm_chunk >= 0) atomic_max_float(bm_row + bm_chunk, bm);
  }
}

template <class T, int LP, int QT>
int launch_float_as(const void* qv, const void* qs, const void* fv, const void* fs, int nq,
                    int nv_pad, int lp, int d, int n_videos, void* out, int out_cols, void* bmax,
                    int chunk, cudaStream_t stream) {
  const auto kernel = video_score_float_kernel<T, LP, QT>;
  constexpr int N = T::tile_n(LP);
  constexpr int kStage = fl_stage_bytes(T::kSplit, N);
  const int nkc = (d + kChunk - 1) / kChunk;
  const int fit = fl_stages(nkc, QT, kStage);
  const int stages = fit < kMaxStages ? fit : kMaxStages;
  if (stages < 2) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = kGroupBytes + fl_query_bytes(nkc, QT) + stages * kStage + kFloatBarBytes;
  CUtensorMap maps[4];
  const uint64_t k = d / T::kElem, rows = static_cast<uint64_t>(nv_pad) * lp;
  int err;
  if ((err = encode_rows(&maps[0], T::kType, T::kElem, qv, k, nq, QT)) ||
      (err = encode_rows(&maps[1], T::kType, T::kElem, qs, k, nq, QT)) ||
      (err = encode_rows(&maps[2], T::kType, T::kElem, fv, k, rows, N)) ||
      (err = encode_rows(&maps[3], T::kType, T::kElem, fs, k, rows, N)))
    return err;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  int device = 0, n_sm = 0;
  if ((e = cudaGetDevice(&device)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return static_cast<int>(e);
  const int vpt = LP > 0 ? N / (LP > 0 ? LP : 1) : lp <= N ? N / lp : 1;
  const int n_vtiles = (nv_pad + vpt - 1) / vpt;
  const int n_qtiles = (nq + QT - 1) / QT;
  // one block an SM: the query tiles of one range side by side
  int groups = n_sm / n_qtiles;
  groups = groups < 1 ? 1 : groups > n_vtiles ? n_vtiles : groups;
  kernel<<<dim3(n_qtiles, groups), 2 * QT + 128, bytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], nq, nv_pad, lp, d, n_videos, static_cast<float*>(out),
      out_cols, static_cast<float*>(bmax), chunk, n_vtiles, stages);
  return static_cast<int>(cudaGetLastError());
}

template <class T, int QT>
int launch_float_lp(const void* qv, const void* qs, const void* fv, const void* fs, int nq,
                    int nv_pad, int lp, int d, int n_videos, void* out, int out_cols, void* bmax,
                    int chunk, cudaStream_t stream) {
  if (lp == 104)
    return launch_float_as<T, 104, QT>(qv, qs, fv, fs, nq, nv_pad, lp, d, n_videos, out,
                                       out_cols, bmax, chunk, stream);
  return launch_float_as<T, 0, QT>(qv, qs, fv, fs, nq, nv_pad, lp, d, n_videos, out, out_cols,
                                   bmax, chunk, stream);
}

// d: a feature row in bytes (a multiple of 16, at most T::kMaxRowBytes)
template <class T>
int launch_float(const void* qv, const void* qs, const void* fv, const void* fs, int nq,
                 int nv_pad, int lp, int d, int n_videos, void* out, int out_cols, void* bmax,
                 int chunk, cudaStream_t stream) {
  if (d <= 0 || d % 16 || d > T::kMaxRowBytes || lp <= 0 || lp % 8 || nq <= 0 || nv_pad <= 0 ||
      chunk <= 0 || static_cast<long long>(nv_pad) * lp + kSegRows > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (T::kMaxRowBytes > T::kWideRowBytes) {
    if (d > T::kWideRowBytes)
      return launch_float_lp<T, 64>(qv, qs, fv, fs, nq, nv_pad, lp, d, n_videos, out, out_cols,
                                    bmax, chunk, stream);
  }
  return launch_float_lp<T, 128>(qv, qs, fv, fs, nq, nv_pad, lp, d, n_videos, out, out_cols, bmax,
                                 chunk, stream);
}

}  // namespace

extern "C" {

// kind: 0 int8 (s8 wgmma; d_words <= 96), 1 bf16 (bf16 wgmma; d_words
// <= 256), 2 f32 (three tf32 wgmma products; d_words <= 640).
// d_words: the feature axis in 4-byte words (a multiple of 4). Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a shape
// the kernel does not take.
int tvr_video_scores(int kind, const void* qv, const void* qs, const void* fv,
                     const void* fs, int nq, int nv_pad, int lp, int d_words,
                     int n_videos, void* out, int out_cols, void* bmax, int chunk_v,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0:
      return launch_wgmma(qv, qs, fv, fs, nq, nv_pad, lp, 4 * d_words, n_videos, out, out_cols,
                          bmax, chunk_v, s);
    case 1:
      return launch_float<Bf16Wg>(qv, qs, fv, fs, nq, nv_pad, lp, 4 * d_words, n_videos, out,
                                  out_cols, bmax, chunk_v, s);
    case 2:
      return launch_float<Tf32x3Wg>(qv, qs, fv, fs, nq, nv_pad, lp, 4 * d_words, n_videos, out,
                                    out_cols, bmax, chunk_v, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The host time of one int8 launch's four tensor-map encodes (queries
// (nq, d) and flat rows (rows, d) of both streams), the mean over n in ns,
// into *ns. No kernel runs: chip_smoke.py reads the host cost the maps add
// to a launch.
int tvr_tensor_map_encode_ns(const void* q, const void* f, int nq, long long rows, int d, int n,
                             void* ns) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[4];
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < n; ++i) {
    const int err = encode_i8_maps(maps, q, q, f, f, nq, rows, d, TileN<104>::N);
    if (err) return err;
  }
  const auto t1 = std::chrono::steady_clock::now();
  *static_cast<double*>(ns) = std::chrono::duration<double, std::nano>(t1 - t0).count() / n;
  return 0;
}

}  // extern "C"
