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
// All three kinds run on the tensor cores through mma.sync: s8 m16n8k32
// with s32 sums, bf16 m16n8k16 with f32 sums, and f32 as three TF32
// m16n8k8 products (a 3xTF32 split) with f32 sums (tile code in
// s8_mma.cuh: a k-step is 32 bytes and the fragments have the same byte
// layout in all three, so one kernel template, video_score_mma_kernel,
// serves them). A block owns a tile of 128 queries x 16 videos and 8
// warps, each warp 32 queries (two m16 fragments) x a column of a ring
// step's flat rows: four query groups x two columns of 32 rows of a 64-row
// step (four n8 fragments), or in f32 two columns of 64 rows of a 128-row
// step (eight). (f32 rows wider than 256 features take a 64-query tile:
// two groups x four columns of 32.)
// The block's 16 x lp flat rows stream through a two-stage cp.async ring,
// stream by stream, into XOR-swizzled tiles read with ldmatrix. Because lp % 8 == 0, an n8 fragment is 8 rows of one video, so
// after a row block's K loop each thread folds its fragments' columns into
// a running max per (query, video) in registers (a three-way max); when
// the warp's video changes it takes the max over the quad (shuffles) and
// folds it into a per-(stream, query, video) max in shared memory
// (atomics: one video's fragments are spread over the warp columns). The
// grid runs the query tiles of one video tile side by side, so they share
// its rows through L2 and device memory is read about once. The K axis is
// padded to 32 bytes with zeros in shared memory. In f32 each k-step's
// fragments are split once (A reused across the eight n8 fragments, B
// across the two m16 ones: 24 splits serve 48 products) and every fragment
// pair costs three products.
// Shared memory a block, at D = 256 (the model's width):
//   int8: both streams' query tiles resident   2 x 128 x 256 B = 64 KiB
//         ring, 2 stages x 64 rows x the row   2 x 64 x 256 B  = 32 KiB
//         per-(stream, query, video) maxima    2 x 128 x 16 x 4 B = 16 KiB
//   bf16: one stream's query tile resident     128 x 512 B     = 64 KiB
//         (the second loads over it when the first stream's steps are done)
//         ring, 2 stages x 64 rows x 256 B     (a row block takes two
//         steps, one for each half of the 512-byte row)            = 32 KiB
//         maxima                                                 = 16 KiB
//   f32:  one stream's query tile resident     128 x 1,024 B   = 128 KiB
//         ring, 2 stages x 128 rows x 128 B    (a row block of 128
//         rows takes eight steps)                                 = 32 KiB
//         maxima                                                 = 16 KiB
// int8 and bf16: 112 KiB, so two blocks share an SM and one's barrier,
// copies and epilogue run under the other's products. f32: 176 KiB, one
// block an SM; its products are three times as many a byte, and its
// 128-query tile reads each row from L2 half as often as a 64-query tile
// at two blocks an SM (104 KiB), which measured slower on the H100. The k
// loop is unrolled at D = 256, the next k-step's fragments loading while
// this one's products run. Int8 rows are at most 384 bytes (160 KiB), bf16
// rows at most 1,024 (D = 512, 176 KiB; D = 384, the widest in use, 144
// KiB: one block an SM), f32 rows at most 2,560 (D = 640; D = 384: 136 KiB
// with the 64-query tile).
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

#include "s8_mma.cuh"

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

// The three products. A k-step is 32 bytes of the feature axis in each; a
// ring step holds the 64 rows' bytes of up to kChunkSteps k-steps.
// BothResident: both streams' query tiles stay in shared memory; otherwise
// one at a time, the second loaded when the first stream's steps are done.
// Queries: the block's query tile. Split: the fragments are f32, split
// into TF32 halves and multiplied three times (mma_tf32x3).
struct S8Mma {                          // B1, B3-int8: s32 dots, integer max
  using Acc = int;
  static constexpr int kMinBlocks = 2;            // blocks an SM (__launch_bounds__)
  static constexpr bool kBothResident = true;
  static constexpr bool kSplit = false;
  static constexpr int kQueries = 128;
  static constexpr int kRows = 64;                // flat rows a ring step: 8 n8 fragments
  static constexpr int kChunkSteps = 12;          // 384 bytes: the whole row
  static constexpr int kMaxRowBytes = 384;
  __device__ static Acc lowest() { return INT_MIN; }
  __device__ static void mma(Acc (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    s8mma::mma(c, a, b0, b1);
  }
  __device__ static Acc max3(Acc a, Acc b, Acc c) { return __vimax3_s32(a, b, c); }
  __device__ static Acc max(Acc a, Acc b) { return ::max(a, b); }
  __device__ static void atomic_max(Acc* p, Acc v) { atomicMax(p, v); }
  __device__ static float score(Acc v, Acc s) { return i8_score(v, s); }
};

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
  static constexpr bool kBothResident = false;
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
  static constexpr bool kBothResident = false;
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
  return (M::kBothResident ? 2 : 1) * M::kQueries * mma_row_bytes(nk)
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
  constexpr int kQTiles = M::kBothResident ? 2 : 1;
  extern __shared__ __align__(128) unsigned char smem[];
  // the int8 rows fit one ring step whole: no K chunks to count
  constexpr bool kOneChunk = M::kChunkSteps * 32 >= M::kMaxRowBytes;
  const int nk = (d + 31) / 32;                   // k-steps of the row
  const int ks = KS ? KS : mma_chunk_steps<M>(nk);   // k-steps of a ring step
  const int nkc = kOneChunk ? 1 : (nk + ks - 1) / ks;   // ring steps a row block takes
  const int q_rb = mma_row_bytes(nk);             // query tile rows: the whole row
  const int f_rb = mma_row_bytes(ks);             // ring tile rows: one K chunk
  const int n_valid = d / 16;                     // 16-byte pieces of real features
  unsigned char* q_tile = smem;                                   // [tile][QT][q_rb]
  unsigned char* f_ring = smem + kQTiles * QT * q_rb;             // [stage][kMmaRows][f_rb]
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

  // query tiles; rows past nq and pieces past d are zeros
  auto load_queries = [&](int s0, int n_s) {
    const int n_load = 2 * nk;                    // pieces a row
    for (int i = tid; i < n_s * QT * n_load; i += kMmaThreads) {
      const int s = i / (QT * n_load), rem = i - s * QT * n_load;
      const int r = rem / n_load, c = rem - r * n_load;
      const unsigned char* q = (s0 + s) ? qs : qv;
      const bool ok = q0 + r < nq && c < n_valid;
      cp_async16(smem_addr(q_tile + s * QT * q_rb) + swizzle(r, c, q_rb),
                 ok ? q + static_cast<size_t>(q0 + r) * d + c * 16 : q, ok ? 16 : 0);
    }
  };
  load_queries(0, kQTiles);
  // step t: stream t / n_steps; of its steps, row block (t % n_steps) / nkc
  // (the block's rows * 64 .. + 63), K chunk (t % n_steps) % nkc
  auto load_step = [&](int t) {
    const int s = t / n_steps, st = t - s * n_steps;
    const int ch = kOneChunk ? st : st / nkc, kc = st - ch * nkc;
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
    const int ch = kOneChunk ? st : st / nkc, kc = st - ch * nkc;
    // with KS a multiple of 4, chunk kc starts at byte kc * KS * 32 of every
    // query row whatever the row's swizzle (which permutes 16-byte pieces
    // inside 128 bytes): fold it into the tile's base
    constexpr bool kFold = KS > 0 && KS % 4 == 0;
    const uint32_t qa = smem_addr(q_tile + (M::kBothResident ? s : 0) * QT * q_rb)
                        + (kFold ? kc * KS * 32 : 0);
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
      if (!M::kBothResident && s == 0) {
        // every warp is done with the first stream's queries: load the
        // second's over them; step t + 1 waits for this group too
        __syncthreads();
        load_queries(1, 1);
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
  // rows of whole 256-byte ring steps (the model's width, D = 256: 256
  // int8 bytes, one step a row block; 512 bf16 bytes, two; 1,024 f32
  // bytes, four) run with the k loop unrolled and the next k-step's
  // fragments loading under this one's products; other widths read it at
  // run time. The int8 row is one ring step whatever its width.
  constexpr bool kOneChunk = M::kChunkSteps * 32 >= M::kMaxRowBytes;
  constexpr int kSteps = kOneChunk ? 8 : M::kChunkSteps;
  const int nk = (d + 31) / 32;
  if (kOneChunk ? nk == kSteps : nk % kSteps == 0)
    return launch_mma_as<M, kSteps>(qv, qs, fv, fs, nq, nv_pad, lp, d, n_videos, out, out_cols, bmax,
                               chunk_v, stream);
  return launch_mma_as<M, 0>(qv, qs, fv, fs, nq, nv_pad, lp, d, n_videos, out, out_cols, bmax,
                             chunk_v, stream);
}

// D = 256: int8 and bf16 two blocks an SM (112 KiB each, with the 1 KiB
// each reserves), f32 one (176 KiB)
static_assert(2 * (mma_smem<S8Mma>(8) + 1024) <= 228 * 1024, "int8 D = 256: two blocks an SM");
static_assert(2 * (mma_smem<Bf16Mma>(16) + 1024) <= 228 * 1024, "bf16 D = 256: two blocks an SM");
static_assert(mma_smem<Tf32x3Mma>(32) == 176 * 1024, "f32 D = 256: 176 KiB");
// D = 384 (the widest feature axis in use) fits one block an SM: bf16
// 96 + 32 + 16 KiB, f32 (64-query tile) 96 + 32 + 8 KiB
static_assert(mma_smem<Bf16Mma>(24) <= kMaxSmem, "bf16 D = 384 does not fit");
static_assert(mma_smem<Tf32x3MmaWide>(48) <= kMaxSmem, "f32 D = 384 does not fit");
// the second stream's query tile rides on the ring's copy groups: with two
// stages each step waits for every group, that one included
static_assert(kMmaStages == 2, "the query reload needs a two-stage ring");

}  // namespace

extern "C" {

// kind: 0 int8 (s8 tensor cores; d_words <= 96), 1 bf16 (bf16 tensor cores;
// d_words <= 256), 2 f32 (3xTF32 on the tensor cores; d_words <= 640).
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
      return launch_mma<S8Mma>(qv, qs, fv, fs, nq, nv_pad, lp, 4 * d_words, n_videos, out,
                               out_cols, bmax, chunk_v, s);
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

}  // extern "C"
