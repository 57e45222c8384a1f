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
// The bf16 and f32 kinds run on the tensor cores through mma.sync: bf16
// m16n8k16 with f32 sums, and f32 as three TF32 m16n8k8 products (a
// 3xTF32 split) with f32 sums (tile code in s8_mma.cuh: a k-step is 32
// bytes and the fragments have the same byte layout in both, so one kernel
// template, video_score_mma_kernel, serves them). A block owns a tile of
// 128 queries x 16 videos and 8 warps, each warp 32 queries (two m16
// fragments) x a column of a ring step's flat rows: four query groups x
// two columns of 32 rows of a 64-row step (four n8 fragments), or in f32
// two columns of 64 rows of a 128-row step (eight). (f32 rows wider than
// 256 features take a 64-query tile: two groups x four columns of 32.)
// The block's 16 x lp flat rows stream through a two-stage cp.async ring,
// stream by stream, into XOR-swizzled tiles read with ldmatrix. Because
// lp % 8 == 0, an n8 fragment is 8 rows of one video, so after a row
// block's K loop each thread folds its fragments' columns into a running
// max per (query, video) in registers (a three-way max); when the warp's
// video changes it takes the max over the quad (shuffles) and folds it
// into a per-(stream, query, video) max in shared memory (atomics: one
// video's fragments are spread over the warp columns). The grid runs the
// query tiles of one video tile side by side, so they share its rows
// through L2 and device memory is read about once. The K axis is padded to
// 32 bytes with zeros in shared memory. In f32 each k-step's fragments are
// split once (A reused across the eight n8 fragments, B across the two m16
// ones: 24 splits serve 48 products) and every fragment pair costs three
// products.
// Shared memory a block, at D = 256 (the model's width):
//   bf16: one stream's query tile resident     128 x 512 B     = 64 KiB
//         (the second loads over it when the first stream's steps are done)
//         ring, 2 stages x 64 rows x 256 B     (a row block takes two
//         steps, one for each half of the 512-byte row)            = 32 KiB
//         maxima                                                 = 16 KiB
//   f32:  one stream's query tile resident     128 x 1,024 B   = 128 KiB
//         ring, 2 stages x 128 rows x 128 B    (a row block of 128
//         rows takes eight steps)                                 = 32 KiB
//         maxima                                                 = 16 KiB
// bf16: 112 KiB, so two blocks share an SM and one's barrier, copies and
// epilogue run under the other's products. f32: 176 KiB, one block an SM;
// its products are three times as many a byte, and its 128-query tile
// reads each row from L2 half as often as a 64-query tile at two blocks an
// SM (104 KiB), which measured slower on the H100. The k loop is unrolled
// at D = 256, the next k-step's fragments loading while this one's
// products run. bf16 rows are at most 1,024 bytes (D = 512, 176 KiB; D =
// 384, the widest in use, 144 KiB: one block an SM), f32 rows at most
// 2,560 (D = 640; D = 384: 136 KiB with the 64-query tile). Int8 rows are
// at most 384 bytes (three K chunks).
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
// (the argument in s8_mma.cuh). So B2 / B3 in bf16 and f32 are held to
// 1e-5 of their plain versions (tests/test_torch_mma_order.py models both
// orders on the CPU).
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

constexpr int kMmaThreads = 256;        // 8 warps
constexpr int kMmaVideos = 16;          // videos per block
constexpr int kMmaStages = 2;           // ring depth
constexpr int kMaxSmem = 227 * 1024;

// JAX: (mv + ms).astype(f32) * (0.5 / (127.0 * 127.0)), the constant
// rounded once from double to f32
__device__ __forceinline__ float i8_score(int v, int s) {
  return static_cast<float>(v + s) * static_cast<float>(0.5 / 16129.0);
}

// The bf16 and f32 products. A k-step is 32 bytes of the feature axis in
// each; a ring step holds the 64 rows' bytes of up to kChunkSteps k-steps.
// One stream's query tile stays in shared memory at a time, the second
// loaded when the first stream's steps are done. Queries: the block's
// query tile. Split: the fragments are f32, split
// into TF32 halves and multiplied three times (mma_tf32x3).
struct FloatMax {                       // f32 sums: max, atomic max, combine
  using Acc = float;
  __device__ static Acc lowest() { return -INFINITY; }
  __device__ static Acc max3(Acc a, Acc b, Acc c) { return fmaxf(a, fmaxf(b, c)); }
  __device__ static Acc max(Acc a, Acc b) { return fmaxf(a, b); }
  __device__ static void atomic_max(Acc* p, Acc v) { atomic_max_float(p, v); }
  __device__ static float score(Acc v, Acc s) { return (v + s) / 2.0f; }
};

struct Bf16Mma : FloatMax {             // B2, B3-bf16: f32 sums of exact products
  static constexpr int kMinBlocks = 2;
  static constexpr bool kSplit = false;
  static constexpr int kQueries = 128;
  static constexpr int kRows = 64;
  static constexpr int kChunkSteps = 8;           // 256 bytes of a 512-byte row
  static constexpr int kMaxRowBytes = 1024;
  __device__ static void mma(Acc (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    s8mma::mma_bf16(c, a, b0, b1);
  }
};

struct Tf32x3Mma : FloatMax {           // B2, B3-f32: three TF32 products, f32 sums
  static constexpr int kMinBlocks = 1;            // 176 KiB at D = 256
  static constexpr bool kSplit = true;
  static constexpr int kQueries = 128;
  static constexpr int kRows = 128;               // 32 x 64 warp tiles: fewer splits a product
  static constexpr int kChunkSteps = 4;           // 128 bytes of a 1,024-byte row
  static constexpr int kMaxRowBytes = 1024;       // D <= 256
};

struct Tf32x3MmaWide : Tf32x3Mma {      // B2, B3-f32 at 256 < D <= 640
  static constexpr int kQueries = 64;             // 32 x 32 warp tiles
  static constexpr int kMaxRowBytes = 2560;
};

// tile rows: whole swizzle periods of 128 bytes
__host__ __device__ constexpr int mma_row_bytes(int nk) { return (2 * nk + 7) / 8 * 128; }
template <class M>
__host__ __device__ constexpr int mma_chunk_steps(int nk) {
  return nk < M::kChunkSteps ? nk : M::kChunkSteps;
}
template <class M>
__host__ __device__ constexpr int mma_smem(int nk) {
  return M::kQueries * mma_row_bytes(nk)
         + kMmaStages * M::kRows * mma_row_bytes(mma_chunk_steps<M>(nk))
         + 2 * M::kQueries * kMmaVideos * 4;
}

// q: (nq, d) rows of int8, bf16 or f32, d bytes a row (a multiple of 16);
// f: (nv_pad * lp, d). out: (nq, out_cols). bmax == nullptr: write videos
// < n_videos (B1, B2). Otherwise (B3) write all nv_pad videos with pad
// videos at -inf, and fold each chunk_v-video block's max into bmax (nq,
// nv_pad / chunk_v), which the caller fills with -inf. KS: the k-steps (32
// bytes) of a ring step, fixed at compile time when every step holds KS of
// them (KS = 0: read from d).
template <class M, int KS>
__global__ void __launch_bounds__(kMmaThreads, M::kMinBlocks)
video_score_mma_kernel(const unsigned char* __restrict__ qv, const unsigned char* __restrict__ qs,
                       const unsigned char* __restrict__ fv, const unsigned char* __restrict__ fs,
                       int nq, int nv_pad, int lp, int d, int n_videos,
                       float* __restrict__ out, int out_cols,
                       float* __restrict__ bmax, int chunk_v) {
  using namespace s8mma;
  using Acc = typename M::Acc;
  constexpr int QT = M::kQueries;                 // queries a block
  constexpr int MF = 2;                           // m16 fragments a warp: 32 queries
  constexpr int WM = QT / (MF * 16);              // warps along the queries: 4, or 2
  constexpr int WN = kMmaThreads / 32 / WM;       // ... along the rows: 2, or 4
  constexpr int kMmaRows = M::kRows;              // flat rows a ring step
  constexpr int FRAGS = kMmaRows / 8;             // n8 fragments a ring step
  constexpr int NF = FRAGS / WN;                  // n8 fragments a warp: 4, or 8 (f32)
  static_assert(WM * WN * 32 == kMmaThreads && NF % 2 == 0, "the warp grid");
  extern __shared__ __align__(128) unsigned char smem[];
  const int nk = (d + 31) / 32;                   // k-steps of the row
  const int ks = KS ? KS : mma_chunk_steps<M>(nk);   // k-steps of a ring step
  const int nkc = (nk + ks - 1) / ks;             // ring steps a row block takes
  const int q_rb = mma_row_bytes(nk);             // query tile rows: the whole row
  const int f_rb = mma_row_bytes(ks);             // ring tile rows: one K chunk
  const int n_valid = d / 16;                     // 16-byte pieces of real features
  unsigned char* q_tile = smem;                                   // [QT][q_rb]
  unsigned char* f_ring = smem + QT * q_rb;                       // [stage][kMmaRows][f_rb]
  // [stream][query][video]: the max of each video's dots
  Acc* best = reinterpret_cast<Acc*>(f_ring + kMmaStages * kMmaRows * f_rb);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;       // query group, row column
  const int q0 = blockIdx.x * QT;
  const int v0 = blockIdx.y * kMmaVideos;
  const int fpv = lp / 8;                         // n8 fragments per video
  const int n_blocks = kMmaVideos * fpv / FRAGS;  // row blocks a stream
  const int n_steps = n_blocks * nkc;             // ring steps a stream
  const int n_total = 2 * n_steps;                // both streams
  const size_t n_rows = static_cast<size_t>(nv_pad) * lp;
  const size_t row0 = static_cast<size_t>(v0) * lp;

  for (int i = tid; i < 2 * QT * kMmaVideos; i += kMmaThreads) best[i] = M::lowest();

  // stream s's query tile; rows past nq and pieces past d are zeros
  auto load_queries = [&](int s) {
    const int n_load = 2 * nk;                    // pieces a row
    const unsigned char* q = s ? qs : qv;
    for (int i = tid; i < QT * n_load; i += kMmaThreads) {
      const int r = i / n_load, c = i - r * n_load;
      const bool ok = q0 + r < nq && c < n_valid;
      cp_async16(smem_addr(q_tile) + swizzle(r, c, q_rb),
                 ok ? q + static_cast<size_t>(q0 + r) * d + c * 16 : q, ok ? 16 : 0);
    }
  };
  load_queries(0);
  // step t: stream t / n_steps; of its steps, row block (t % n_steps) / nkc
  // (the block's rows * 64 .. + 63), K chunk (t % n_steps) % nkc
  auto load_step = [&](int t) {
    const int s = t / n_steps, st = t - s * n_steps;
    const int ch = st / nkc, kc = st - ch * nkc;
    const unsigned char* f = s ? fs : fv;
    const uint32_t dst = smem_addr(f_ring + (t % kMmaStages) * kMmaRows * f_rb);
    const size_t base = row0 + static_cast<size_t>(ch) * kMmaRows;
    const int c0 = kc * 2 * ks;                   // the chunk's first piece
    if constexpr (KS > 0 && kMmaThreads % (2 * KS) == 0) {
      // a thread's piece is the same in every row it copies, and its rows
      // are kMmaThreads / (2 KS) apart: no division in the loop
      constexpr int kLoad = 2 * KS, kRowStep = kMmaThreads / kLoad;
      static_assert(kRowStep % 8 == 0 && kMmaRows % kRowStep == 0, "rows a thread copies");
      const int r0 = tid / kLoad, c = tid % kLoad;
      const uint32_t d0 = dst + swizzle(r0, c, f_rb);         // the same swizzle every row
      const unsigned char* src = f + (base + r0) * d + (c0 + c) * 16;
#pragma unroll
      for (int j = 0; j < kMmaRows / kRowStep; ++j) {
        const bool ok = base + r0 + j * kRowStep < n_rows && c0 + c < n_valid;
        cp_async16(d0 + j * kRowStep * f_rb,
                   ok ? src + static_cast<size_t>(j) * kRowStep * d : f, ok ? 16 : 0);
      }
    } else {
      const int n_load = 2 * min(ks, nk - kc * ks);
      for (int i = tid; i < kMmaRows * n_load; i += kMmaThreads) {
        const int r = i / n_load, c = i - r * n_load;
        const bool ok = base + r < n_rows && c0 + c < n_valid;
        cp_async16(dst + swizzle(r, c, f_rb), ok ? f + (base + r) * d + (c0 + c) * 16 : f,
                   ok ? 16 : 0);
      }
    }
  };
#pragma unroll
  for (int t = 0; t < kMmaStages - 1; ++t) {     // the first group carries the queries
    if (t < n_total) load_step(t);
    cp_async_commit();
  }

  const int g = lane >> 2, t4 = lane & 3;
  Acc run[MF][2];                                 // running max: m16 fragment, row g / g + 8
  int cur = -1;                                   // the video `run` belongs to
  // the max over the quad, folded into best[stream][query][video]
  auto flush = [&](int s, int vl) {
#pragma unroll
    for (int mi = 0; mi < MF; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        Acc v = run[mi][h];
        v = M::max(v, __shfl_xor_sync(0xffffffffu, v, 1));
        v = M::max(v, __shfl_xor_sync(0xffffffffu, v, 2));
        run[mi][h] = v;
      }
#pragma unroll
    for (int e = 0; e < 2 * MF; ++e)
      if ((e & 3) == t4) {                        // the quad's lanes share the writes
        const int q = wm * (MF * 16) + (e >> 1) * 16 + g + 8 * (e & 1);
        M::atomic_max(&best[(s * QT + q) * kMmaVideos + vl], run[e >> 1][e & 1]);
      }
  };

  Acc acc[MF][NF][4];
  for (int t = 0; t < n_total; ++t) {
    cp_async_wait<kMmaStages - 2>();              // step t has landed, for this thread
    __syncthreads();                              // ... for all; step t - 1 is done
    if (t + kMmaStages - 1 < n_total) load_step(t + kMmaStages - 1);
    cp_async_commit();
    const int s = t / n_steps, st = t - s * n_steps;
    const int ch = st / nkc, kc = st - ch * nkc;
    // with KS a multiple of 4, chunk kc starts at byte kc * KS * 32 of every
    // query row whatever the row's swizzle (which permutes 16-byte pieces
    // inside 128 bytes): fold it into the tile's base
    constexpr bool kFold = KS > 0 && KS % 4 == 0;
    const uint32_t qa = smem_addr(q_tile) + (kFold ? kc * KS * 32 : 0);
    const int kq = kFold ? 0 : kc * ks;           // the query tile's k-step of kk = 0
    const uint32_t fb = smem_addr(f_ring + (t % kMmaStages) * kMmaRows * f_rb);
    if (kc == 0) {
#pragma unroll
      for (int mi = 0; mi < MF; ++mi)
#pragma unroll
        for (int ni = 0; ni < NF; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = Acc(0);
    }
    // k-step kk of this chunk: the query tile's k-step kq + kk
    warp_tile_step<M, KS, 2>(acc, qa, wm * (MF * 16), kq, q_rb, fb, wn * (NF * 8), f_rb, lane,
                             KS ? KS : min(ks, nk - kc * ks));
    if (kc == nkc - 1) {
      // fragment ni is 8 rows of video (f0 + ni) / fpv, the same for the
      // whole warp (one division a step while videos are NF fragments or more)
      const int f0 = ch * FRAGS + wn * NF, v_first = f0 / fpv, r0 = f0 - v_first * fpv;
#pragma unroll
      for (int ni = 0; ni < NF; ++ni) {
        const int vl = r0 + ni < fpv ? v_first : (f0 + ni) / fpv;
        if (vl != cur) {
          if (cur >= 0) flush(s, cur);
          cur = vl;
#pragma unroll
          for (int mi = 0; mi < MF; ++mi) run[mi][0] = run[mi][1] = M::lowest();
        }
#pragma unroll
        for (int mi = 0; mi < MF; ++mi) {
          run[mi][0] = M::max3(run[mi][0], acc[mi][ni][0], acc[mi][ni][1]);
          run[mi][1] = M::max3(run[mi][1], acc[mi][ni][2], acc[mi][ni][3]);
        }
      }
    }
    if (st == n_steps - 1) {                      // the stream's last step
      flush(s, cur);
      cur = -1;
      if (s == 0) {
        // every warp is done with the first stream's queries: load the
        // second's over them; step t + 1 waits for this group too
        __syncthreads();
        load_queries(1);
        cp_async_commit();
      }
    }
  }
  __syncthreads();

  // scores: B1 / B2 write videos < n_videos; B3 all of nv_pad, pads at -inf
  for (int p = tid; p < QT * kMmaVideos; p += kMmaThreads) {
    const int q = p / kMmaVideos, vl = p % kMmaVideos, qq = q0 + q, v = v0 + vl;
    float score = M::score(best[q * kMmaVideos + vl], best[(QT + q) * kMmaVideos + vl]);
    if (bmax == nullptr) {
      if (qq < nq && v < n_videos) out[static_cast<size_t>(qq) * out_cols + v] = score;
    } else {
      if (v >= n_videos) score = -INFINITY;
      if (qq < nq && v < nv_pad) out[static_cast<size_t>(qq) * out_cols + v] = score;
    }
  }
  if (bmax == nullptr || tid >= QT || q0 + tid >= nq) return;
  // B3: a thread per query folds the block's videos into their chunk_v blocks
  const int qq = q0 + tid, nb = nv_pad / chunk_v;
  float* brow = bmax + static_cast<size_t>(qq) * nb;
  int seg = v0 / chunk_v;
  float m = -INFINITY;
  for (int vl = 0; vl < kMmaVideos && v0 + vl < nv_pad; ++vl) {
    const int v = v0 + vl;
    if (v / chunk_v != seg) {
      atomic_max_float(brow + seg, m);
      seg = v / chunk_v;
      m = -INFINITY;
    }
    const float score = v >= n_videos ? -INFINITY
        : M::score(best[tid * kMmaVideos + vl], best[(QT + tid) * kMmaVideos + vl]);
    m = fmaxf(m, score);
  }
  atomic_max_float(brow + seg, m);
}

template <class M, int KS>
int launch_mma_as(const void* qv, const void* qs, const void* fv, const void* fs, int nq,
                  int nv_pad, int lp, int d, int n_videos, void* out, int out_cols,
                  void* bmax, int chunk_v, cudaStream_t stream) {
  const auto kernel = video_score_mma_kernel<M, KS>;
  const int bytes = mma_smem<M>((d + 31) / 32);
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // queries fastest: the 8 (f32: 16) query tiles of one video tile (Nq =
  // 1,000) run side by side and share its feature rows through L2
  const dim3 grid((nq + M::kQueries - 1) / M::kQueries, (nv_pad + kMmaVideos - 1) / kMmaVideos);
  kernel<<<grid, kMmaThreads, bytes, stream>>>(
      static_cast<const unsigned char*>(qv), static_cast<const unsigned char*>(qs),
      static_cast<const unsigned char*>(fv), static_cast<const unsigned char*>(fs), nq, nv_pad,
      lp, d, n_videos, static_cast<float*>(out), out_cols, static_cast<float*>(bmax), chunk_v);
  return static_cast<int>(cudaGetLastError());
}

// d: a feature row in bytes (a multiple of 16)
template <class M>
int launch_mma(const void* qv, const void* qs, const void* fv, const void* fs, int nq,
               int nv_pad, int lp, int d, int n_videos, void* out, int out_cols, void* bmax,
               int chunk_v, cudaStream_t stream) {
  if (d <= 0 || d % 16 || d > M::kMaxRowBytes || lp % 8 ||
      (nv_pad + kMmaVideos - 1) / kMmaVideos > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  static_assert(mma_smem<M>(M::kMaxRowBytes / 32) <= kMaxSmem, "the widest row does not fit");
  // rows of whole ring steps (the model's width, D = 256: 512 bf16 bytes,
  // two steps a row block; 1,024 f32 bytes, eight) run with the k loop
  // unrolled and the next k-step's fragments loading under this one's
  // products; other widths read it at run time.
  constexpr int kSteps = M::kChunkSteps;
  const int nk = (d + 31) / 32;
  if (nk % kSteps == 0)
    return launch_mma_as<M, kSteps>(qv, qs, fv, fs, nq, nv_pad, lp, d, n_videos, out, out_cols, bmax,
                               chunk_v, stream);
  return launch_mma_as<M, 0>(qv, qs, fv, fs, nq, nv_pad, lp, d, n_videos, out, out_cols, bmax,
                             chunk_v, stream);
}

// D = 256: bf16 two blocks an SM (112 KiB each, with the 1 KiB each
// reserves), f32 one (176 KiB)
static_assert(2 * (mma_smem<Bf16Mma>(16) + 1024) <= 228 * 1024, "bf16 D = 256: two blocks an SM");
static_assert(mma_smem<Tf32x3Mma>(32) == 176 * 1024, "f32 D = 256: 176 KiB");
// D = 384 (the widest feature axis in use) fits one block an SM: bf16
// 96 + 32 + 16 KiB, f32 (64-query tile) 96 + 32 + 8 KiB
static_assert(mma_smem<Bf16Mma>(24) <= kMaxSmem, "bf16 D = 384 does not fit");
static_assert(mma_smem<Tf32x3MmaWide>(48) <= kMaxSmem, "f32 D = 384 does not fit");
// the second stream's query tile rides on the ring's copy groups: with two
// stages each step waits for every group, that one included
static_assert(kMmaStages == 2, "the query reload needs a two-stage ring");

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
// boxes of N rows x 128 bytes). out, bmax, chunk as video_score_mma_kernel
// (chunk = gcd(nv_pad, chunk_v)). LP: lp fixed at compile time (104), or 0
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

}  // namespace

extern "C" {

// kind: 0 int8 (s8 wgmma; d_words <= 96), 1 bf16 (bf16 mma.sync; d_words
// <= 256), 2 f32 (3xTF32 mma.sync; d_words <= 640).
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
      return launch_mma<Bf16Mma>(qv, qs, fv, fs, nq, nv_pad, lp, 4 * d_words, n_videos, out,
                                 out_cols, bmax, chunk_v, s);
    case 2:
      if (4 * d_words <= Tf32x3Mma::kMaxRowBytes)
        return launch_mma<Tf32x3Mma>(qv, qs, fv, fs, nq, nv_pad, lp, 4 * d_words, n_videos, out,
                                     out_cols, bmax, chunk_v, s);
      return launch_mma<Tf32x3MmaWide>(qv, qs, fv, fs, nq, nv_pad, lp, 4 * d_words, n_videos,
                                       out, out_cols, bmax, chunk_v, s);
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
