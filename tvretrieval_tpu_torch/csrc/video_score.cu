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
// maxima) are written, so the bound is arithmetic.
//
// int8 (B1, B3-int8): the s8 tensor cores, mma.sync m16n8k32 (tile code in
// s8_mma.cuh). A block owns 128 queries x 16 videos and 8 warps: four
// query groups of 32 (two m16 fragments) x two columns of 32 flat rows
// (four n8 fragments). Both streams' query tiles stay resident in shared
// memory; the block's 16 x lp flat rows stream through a two-stage
// cp.async ring, 64 rows a step, stream by stream, into XOR-swizzled tiles
// read with ldmatrix. At D = 256 that is 112 KiB, so two blocks share an
// SM and one's barrier, copies and epilogue run under the other's
// products; the k loop is unrolled there, the next k-step's fragments
// loading while this one's products run. Because lp % 8 == 0, an n8
// fragment is 8 rows of one video, so after a step's K loop each thread
// folds its fragments' columns into a running max per (query, video) in
// registers (a three-way max); when the warp's video changes it takes the
// max over the quad (shuffles) and folds it into a per-(stream, query,
// video) max in shared memory (atomicMax: one video's fragments are spread
// over the warp columns). The grid runs the query tiles of one video tile
// side by side, so they share its rows through L2 and device memory is
// read about once. The K axis is padded to 32 bytes with zeros in shared
// memory; D is at most 384 bytes (160 KiB at that width).
//
// bf16 / f32 (B2, B3): plain FMA over shared-memory tiles: a block owns 32
// videos x 64 queries, every thread one video (its lane) x 8 queries,
// walking the video's rows 8 at a time with the dots in registers. A
// tensor-core version changes their summation order and waits for a
// tolerance argument.
//
// Exactness. Integer accumulation and max are exact, and the int8 rescale
// is the same single f32 multiply by f32(0.5 / 16129) that JAX does, so B1
// and B3-int8 are bit-equal to their plain versions. The bf16 / f32 kinds
// sum in another order than a library GEMM (f32 rounding slack).
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

constexpr int kThreads = 256;
constexpr int kVideos = 32;             // videos per block: one per lane
constexpr int kQueries = 64;            // queries per block
constexpr int kQPerThread = kQueries / (kThreads / 32);   // 8: one warp per query group
constexpr int kRows = 8;                // rows per video per step (lp % 8 == 0)
constexpr int kWords = 32;              // 4-byte words of the feature axis per stage
constexpr int kVideoStride = kRows * kWords + 1;  // odd: the 32 lanes hit 32 banks

// Element traits of the FMA kernel. A shared-memory word packs 2 bf16 or
// 1 f32 of the feature axis; `step` folds one word of every (row, query)
// pair into the accumulators.
struct Float32 {
  using Acc = float;
  __device__ static Acc zero() { return 0.0f; }
  __device__ static Acc lowest() { return -INFINITY; }
  __device__ static Acc max(Acc a, Acc b) { return fmaxf(a, b); }
  __device__ static void step(const uint32_t (&f)[kRows], const uint32_t (&q)[kQPerThread],
                              Acc (&acc)[kRows][kQPerThread]) {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int j = 0; j < kQPerThread; ++j)
        acc[r][j] = fmaf(__uint_as_float(f[r]), __uint_as_float(q[j]), acc[r][j]);
  }
  __device__ static float combine(Acc v, Acc s) { return (v + s) / 2.0f; }
};

struct BFloat16 : Float32 {
  // a word holds feature k in its low half and k + 1 in its high half; a
  // bf16 widens to f32 by a 16-bit shift, and bf16 x bf16 is exact in f32
  __device__ static void step(const uint32_t (&f)[kRows], const uint32_t (&q)[kQPerThread],
                              Acc (&acc)[kRows][kQPerThread]) {
    float flo[kRows], fhi[kRows], qlo[kQPerThread], qhi[kQPerThread];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      flo[r] = __uint_as_float(f[r] << 16);
      fhi[r] = __uint_as_float(f[r] & 0xffff0000u);
    }
#pragma unroll
    for (int j = 0; j < kQPerThread; ++j) {
      qlo[j] = __uint_as_float(q[j] << 16);
      qhi[j] = __uint_as_float(q[j] & 0xffff0000u);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int j = 0; j < kQPerThread; ++j)
        acc[r][j] = fmaf(fhi[r], qhi[j], fmaf(flo[r], qlo[j], acc[r][j]));
  }
};

// float max through integer atomics: non-negative floats order like
// signed ints, negative floats order reversed as unsigned ints
__device__ void atomic_max_float(float* addr, float value) {
  if (value >= 0.0f)
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(value));
  else
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(value));
}

// q: (nq, dw) words, row-major; f: (nv_pad * lp, dw) words. out: (nq,
// out_cols). bmax == nullptr: write videos < n_videos (B1, B2). Otherwise
// (B3) write all nv_pad videos with pad videos at -inf, and fold each
// chunk_v-video block's max into bmax (nq, nv_pad / chunk_v), which the
// caller fills with -inf.
template <class T>
__global__ void __launch_bounds__(kThreads, 2)
video_score_kernel(const uint32_t* __restrict__ qv, const uint32_t* __restrict__ qs,
                   const uint32_t* __restrict__ fv, const uint32_t* __restrict__ fs,
                   int nq, int nv_pad, int lp, int dw, int n_videos,
                   float* __restrict__ out, int out_cols,
                   float* __restrict__ bmax, int chunk_v) {
  __shared__ uint32_t f_tile[kVideos * kVideoStride];
  __shared__ __align__(16) uint32_t q_tile[kQueries * kWords];

  const int lane = threadIdx.x & 31;      // this thread's video in the block
  const int group = threadIdx.x >> 5;     // queries group + 8 * j, j < 8
  const int q0 = blockIdx.x * kQueries;
  const int v0 = blockIdx.y * kVideos;

  typename T::Acc best[2][kQPerThread];
#pragma unroll
  for (int stream = 0; stream < 2; ++stream) {
    const uint32_t* q = stream ? qs : qv;
    const uint32_t* f = stream ? fs : fv;
#pragma unroll
    for (int j = 0; j < kQPerThread; ++j) best[stream][j] = T::lowest();

    for (int r0 = 0; r0 < lp; r0 += kRows) {
      typename T::Acc acc[kRows][kQPerThread];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int j = 0; j < kQPerThread; ++j) acc[r][j] = T::zero();

      for (int k0 = 0; k0 < dw; k0 += kWords) {
        // stage 32 videos x 8 rows x 32 words of f, 16 bytes per load;
        // words past dw (a feature-axis tail) and videos past nv_pad are
        // zeros, which add nothing to a dot
        for (int i = threadIdx.x; i < kVideos * kRows * (kWords / 4); i += kThreads) {
          const int piece = i % (kWords / 4);
          const int row = i / (kWords / 4);
          const int vs = row / kRows, r = row % kRows;
          const int v = v0 + vs, kw = k0 + piece * 4;
          uint4 val = make_uint4(0u, 0u, 0u, 0u);
          if (v < nv_pad && kw < dw)
            val = *reinterpret_cast<const uint4*>(
                f + (static_cast<size_t>(v) * lp + r0 + r) * dw + kw);
          uint32_t* dst = f_tile + vs * kVideoStride + r * kWords + piece * 4;
          dst[0] = val.x; dst[1] = val.y; dst[2] = val.z; dst[3] = val.w;
        }
        // stage 64 queries x 32 words (zeros past nq or dw)
        for (int i = threadIdx.x; i < kQueries * (kWords / 4); i += kThreads) {
          const int piece = i % (kWords / 4);
          const int qi = i / (kWords / 4);
          const int qq = q0 + qi, kw = k0 + piece * 4;
          uint4 val = make_uint4(0u, 0u, 0u, 0u);
          if (qq < nq && kw < dw)
            val = *reinterpret_cast<const uint4*>(q + static_cast<size_t>(qq) * dw + kw);
          *reinterpret_cast<uint4*>(q_tile + qi * kWords + piece * 4) = val;
        }
        __syncthreads();
#pragma unroll 4
        for (int kw = 0; kw < kWords; ++kw) {
          uint32_t fw[kRows], qw[kQPerThread];
#pragma unroll
          for (int r = 0; r < kRows; ++r) fw[r] = f_tile[lane * kVideoStride + r * kWords + kw];
#pragma unroll
          for (int j = 0; j < kQPerThread; ++j) qw[j] = q_tile[(group + 8 * j) * kWords + kw];
          T::step(fw, qw, acc);
        }
        __syncthreads();
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int j = 0; j < kQPerThread; ++j)
          best[stream][j] = T::max(best[stream][j], acc[r][j]);
    }
  }

  const int v = v0 + lane;
#pragma unroll
  for (int j = 0; j < kQPerThread; ++j) {
    const int qq = q0 + group + 8 * j;    // the same for the whole warp
    float score = T::combine(best[0][j], best[1][j]);
    if (bmax == nullptr) {
      if (qq < nq && v < n_videos) out[static_cast<size_t>(qq) * out_cols + v] = score;
      continue;
    }
    if (v >= n_videos) score = -INFINITY;
    if (qq < nq && v < nv_pad) out[static_cast<size_t>(qq) * out_cols + v] = score;
    // segmented suffix max over the lanes of one chunk_v block (the lanes
    // hold consecutive videos); the first lane of each block segment in
    // this warp folds it into bmax
    float m = v < nv_pad ? score : -INFINITY;
    const int seg = v / chunk_v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float other = __shfl_down_sync(0xffffffffu, m, off);
      if (lane + off < 32 && (v + off) / chunk_v == seg) m = fmaxf(m, other);
    }
    const bool head = lane == 0 || (v - 1) / chunk_v != seg;
    if (qq < nq && v < nv_pad && head)
      atomic_max_float(bmax + static_cast<size_t>(qq) * (nv_pad / chunk_v) + seg, m);
  }
}

template <class T>
void launch(const void* qv, const void* qs, const void* fv, const void* fs, int nq,
            int nv_pad, int lp, int d_words, int n_videos, void* out, int out_cols,
            void* bmax, int chunk_v, cudaStream_t stream) {
  // queries fastest: the 16 query tiles of one video tile run side by side
  // and share its feature rows through L2
  const dim3 grid((nq + kQueries - 1) / kQueries, (nv_pad + kVideos - 1) / kVideos);
  video_score_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(qv), static_cast<const uint32_t*>(qs),
      static_cast<const uint32_t*>(fv), static_cast<const uint32_t*>(fs),
      nq, nv_pad, lp, d_words, n_videos, static_cast<float*>(out), out_cols,
      static_cast<float*>(bmax), chunk_v);
}

// ------------------------------------------------ int8: s8 tensor cores
constexpr int kI8Threads = 256;         // 8 warps: 4 query groups x 2 row columns
constexpr int kI8Queries = 128;         // queries per block: the A tile
constexpr int kI8Videos = 16;           // videos per block
constexpr int kI8Rows = 64;             // flat rows a ring step: 8 n8 fragments
constexpr int kI8Stages = 2;            // ring depth
constexpr int kI8MaxRowBytes = 384;     // the longest feature row (D) the tiles hold
constexpr int kI8BestBytes = 2 * kI8Queries * kI8Videos * 4;
constexpr int kI8MaxSmem = 227 * 1024;

// JAX: (mv + ms).astype(f32) * (0.5 / (127.0 * 127.0)), the constant
// rounded once from double to f32
__device__ __forceinline__ float i8_score(int v, int s) {
  return static_cast<float>(v + s) * static_cast<float>(0.5 / 16129.0);
}

__host__ __device__ constexpr int i8_row_bytes(int nk) { return (2 * nk + 7) / 8 * 128; }
__host__ __device__ constexpr int i8_smem(int nk) {
  return (2 * kI8Queries + kI8Stages * kI8Rows) * i8_row_bytes(nk) + kI8BestBytes;
}

// q: (nq, d) int8 rows; f: (nv_pad * lp, d) int8 rows; d a multiple of 16.
// out, bmax, chunk_v as for video_score_kernel. NK: k-steps of 32 bytes,
// ceil(d / 32), fixed at compile time (NK = 0: read from d).
template <int NK>
__global__ void __launch_bounds__(kI8Threads, 2)
video_score_i8_kernel(const int8_t* __restrict__ qv, const int8_t* __restrict__ qs,
                      const int8_t* __restrict__ fv, const int8_t* __restrict__ fs,
                      int nq, int nv_pad, int lp, int d, int n_videos,
                      float* __restrict__ out, int out_cols,
                      float* __restrict__ bmax, int chunk_v) {
  using namespace s8mma;
  constexpr int MF = 2;                           // m16 fragments a warp: 32 queries
  constexpr int FRAGS = kI8Rows / 8;              // n8 fragments a ring step
  extern __shared__ __align__(128) unsigned char smem[];
  const int nk = NK ? NK : (d + 31) / 32;
  const int row_bytes = i8_row_bytes(nk);         // tile rows: whole swizzle periods
  const int n_load = 2 * nk;                      // 16-byte chunks copied per row
  const int n_valid = d / 16;                     // chunks of real features; zeros after
  unsigned char* q_tile = smem;                                // [stream][128][row_bytes]
  unsigned char* f_ring = smem + 2 * kI8Queries * row_bytes;   // [stage][64][row_bytes]
  // [stream][query][video]: the integer max of each video's dots
  int* best = reinterpret_cast<int*>(f_ring + kI8Stages * kI8Rows * row_bytes);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;        // query group, row column
  const int q0 = blockIdx.x * kI8Queries;
  const int v0 = blockIdx.y * kI8Videos;
  const int fpv = lp / 8;                         // n8 fragments per video
  const int n_steps = 16 * fpv / FRAGS;           // 16 * fpv fragments
  const int n_total = 2 * n_steps;                // both streams
  const size_t n_rows = static_cast<size_t>(nv_pad) * lp;
  const size_t row0 = static_cast<size_t>(v0) * lp;

  for (int i = tid; i < 2 * kI8Queries * kI8Videos; i += kI8Threads) best[i] = INT_MIN;

  // both streams' query tiles; rows past nq and the K tail are zeros
  for (int i = tid; i < 2 * kI8Queries * n_load; i += kI8Threads) {
    const int s = i / (kI8Queries * n_load), rem = i - s * kI8Queries * n_load;
    const int r = rem / n_load, c = rem - r * n_load;
    const int8_t* q = s ? qs : qv;
    const bool ok = q0 + r < nq && c < n_valid;
    cp_async16(smem_addr(q_tile + s * kI8Queries * row_bytes) + swizzle(r, c, row_bytes),
               ok ? q + static_cast<size_t>(q0 + r) * d + c * 16 : q, ok ? 16 : 0);
  }
  // step t: stream t / n_steps, the block's rows (t % n_steps) * 64 .. + 63
  auto load_step = [&](int t) {
    const int s = t / n_steps, ch = t - s * n_steps;
    const int8_t* f = s ? fs : fv;
    const uint32_t dst = smem_addr(f_ring + (t % kI8Stages) * kI8Rows * row_bytes);
    const size_t base = row0 + static_cast<size_t>(ch) * kI8Rows;
    if constexpr (NK > 0 && kI8Threads % (2 * NK) == 0) {
      // a thread's chunk is the same in every row it copies, and its rows
      // are kI8Threads / n_load apart: no division in the loop
      constexpr int kLoad = 2 * NK, kRowStep = kI8Threads / kLoad;
      static_assert(kRowStep % 8 == 0 && kI8Rows % kRowStep == 0, "rows a thread copies");
      const int r0 = tid / kLoad, c = tid % kLoad;
      const uint32_t d0 = dst + swizzle(r0, c, row_bytes);    // the same swizzle every row
      const int8_t* src = f + (base + r0) * d + c * 16;
#pragma unroll
      for (int j = 0; j < kI8Rows / kRowStep; ++j) {
        const bool ok = base + r0 + j * kRowStep < n_rows && c < n_valid;
        cp_async16(d0 + j * kRowStep * row_bytes,
                   ok ? src + static_cast<size_t>(j) * kRowStep * d : f, ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < kI8Rows * n_load; i += kI8Threads) {
        const int r = i / n_load, c = i - r * n_load;
        const bool ok = base + r < n_rows && c < n_valid;
        cp_async16(dst + swizzle(r, c, row_bytes), ok ? f + (base + r) * d + c * 16 : f,
                   ok ? 16 : 0);
      }
    }
  };
#pragma unroll
  for (int t = 0; t < kI8Stages - 1; ++t) {      // the first group carries the queries
    if (t < n_total) load_step(t);
    cp_async_commit();
  }

  const int g = lane >> 2, t4 = lane & 3;
  int run[MF][2];                                 // running max: m16 fragment, row g / g + 8
  int cur = -1;                                   // the video `run` belongs to
  // the max over the quad, folded into best[stream][query][video]
  auto flush = [&](int s, int vl) {
#pragma unroll
    for (int mi = 0; mi < MF; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int v = run[mi][h];
        v = max(v, __shfl_xor_sync(0xffffffffu, v, 1));
        v = max(v, __shfl_xor_sync(0xffffffffu, v, 2));
        run[mi][h] = v;
      }
#pragma unroll
    for (int e = 0; e < 2 * MF; ++e)
      if ((e & 3) == t4) {                        // the quad's lanes share the writes
        const int q = wm * (MF * 16) + (e >> 1) * 16 + g + 8 * (e & 1);
        atomicMax(&best[(s * kI8Queries + q) * kI8Videos + vl], run[e >> 1][e & 1]);
      }
  };

  uint32_t a[2][MF][4], b[2][4][2];
  int acc[MF][4][4];
  for (int t = 0; t < n_total; ++t) {
    cp_async_wait<kI8Stages - 2>();               // step t has landed, for this thread
    __syncthreads();                              // ... for all; step t - 1 is done
    if (t + kI8Stages - 1 < n_total) load_step(t + kI8Stages - 1);
    cp_async_commit();
    const int s = t / n_steps, ch = t - s * n_steps;
    const uint32_t qa = smem_addr(q_tile + s * kI8Queries * row_bytes);
    const uint32_t fb = smem_addr(f_ring + (t % kI8Stages) * kI8Rows * row_bytes);
#pragma unroll
    for (int mi = 0; mi < MF; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;
    auto load_frags = [&](int kk, int buf) {
#pragma unroll
      for (int mi = 0; mi < MF; ++mi)
        ldmatrix_x4(a[buf][mi], a_frag_addr(qa, wm * (MF * 16) + mi * 16, kk, lane, row_bytes));
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4(r, b_frag_pair_addr(fb, wn * 32 + np * 16, kk, lane, row_bytes));
        b[buf][2 * np][0] = r[0];
        b[buf][2 * np][1] = r[1];
        b[buf][2 * np + 1][0] = r[2];
        b[buf][2 * np + 1][1] = r[3];
      }
    };
    auto mma_all = [&](int buf) {
#pragma unroll
      for (int mi = 0; mi < MF; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma(acc[mi][ni], a[buf][mi], b[buf][ni][0], b[buf][ni][1]);
    };
    if constexpr (NK > 0) {
      // fragments of k-step kk + 1 load while k-step kk multiplies
      load_frags(0, 0);
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        if (kk + 1 < NK) load_frags(kk + 1, (kk + 1) & 1);
        mma_all(kk & 1);
      }
    } else {
#pragma unroll 1
      for (int kk = 0; kk < nk; ++kk) {
        load_frags(kk, 0);
        mma_all(0);
      }
    }
    // fragment ni is 8 rows of video (f0 + ni) / fpv, the same for the
    // whole warp (one division a step while videos are 4 fragments or more)
    const int f0 = ch * FRAGS + wn * 4, v_first = f0 / fpv, r0 = f0 - v_first * fpv;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int vl = r0 + ni < fpv ? v_first : (f0 + ni) / fpv;
      if (vl != cur) {
        if (cur >= 0) flush(s, cur);
        cur = vl;
#pragma unroll
        for (int mi = 0; mi < MF; ++mi) run[mi][0] = run[mi][1] = INT_MIN;
      }
#pragma unroll
      for (int mi = 0; mi < MF; ++mi) {
        run[mi][0] = __vimax3_s32(run[mi][0], acc[mi][ni][0], acc[mi][ni][1]);
        run[mi][1] = __vimax3_s32(run[mi][1], acc[mi][ni][2], acc[mi][ni][3]);
      }
    }
    if (ch == n_steps - 1) {                      // the stream's last step
      flush(s, cur);
      cur = -1;
    }
  }
  __syncthreads();

  // scores: B1 writes videos < n_videos; B3 all of nv_pad, pads at -inf
  for (int p = tid; p < kI8Queries * kI8Videos; p += kI8Threads) {
    const int q = p / kI8Videos, vl = p % kI8Videos, qq = q0 + q, v = v0 + vl;
    float score = i8_score(best[q * kI8Videos + vl], best[(kI8Queries + q) * kI8Videos + vl]);
    if (bmax == nullptr) {
      if (qq < nq && v < n_videos) out[static_cast<size_t>(qq) * out_cols + v] = score;
    } else {
      if (v >= n_videos) score = -INFINITY;
      if (qq < nq && v < nv_pad) out[static_cast<size_t>(qq) * out_cols + v] = score;
    }
  }
  if (bmax == nullptr || tid >= kI8Queries || q0 + tid >= nq) return;
  // B3: a thread per query folds the block's videos into their chunk_v blocks
  const int qq = q0 + tid, nb = nv_pad / chunk_v;
  float* brow = bmax + static_cast<size_t>(qq) * nb;
  int seg = v0 / chunk_v;
  float m = -INFINITY;
  for (int vl = 0; vl < kI8Videos && v0 + vl < nv_pad; ++vl) {
    const int v = v0 + vl;
    if (v / chunk_v != seg) {
      atomic_max_float(brow + seg, m);
      seg = v / chunk_v;
      m = -INFINITY;
    }
    const float score = v >= n_videos ? -INFINITY
        : i8_score(best[tid * kI8Videos + vl], best[(kI8Queries + tid) * kI8Videos + vl]);
    m = fmaxf(m, score);
  }
  atomic_max_float(brow + seg, m);
}

template <int NK>
int launch_i8_as(const void* qv, const void* qs, const void* fv, const void* fs, int nq,
                 int nv_pad, int lp, int d, int n_videos, void* out, int out_cols,
                 void* bmax, int chunk_v, cudaStream_t stream) {
  const auto kernel = video_score_i8_kernel<NK>;
  const int bytes = i8_smem((d + 31) / 32);
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // queries fastest: the 8 query tiles of one video tile (Nq = 1,000) run
  // side by side and share its feature rows through L2
  const dim3 grid((nq + kI8Queries - 1) / kI8Queries, (nv_pad + kI8Videos - 1) / kI8Videos);
  kernel<<<grid, kI8Threads, bytes, stream>>>(
      static_cast<const int8_t*>(qv), static_cast<const int8_t*>(qs),
      static_cast<const int8_t*>(fv), static_cast<const int8_t*>(fs), nq, nv_pad, lp, d,
      n_videos, static_cast<float*>(out), out_cols, static_cast<float*>(bmax), chunk_v);
  return static_cast<int>(cudaGetLastError());
}

int launch_i8(const void* qv, const void* qs, const void* fv, const void* fs, int nq,
              int nv_pad, int lp, int d, int n_videos, void* out, int out_cols, void* bmax,
              int chunk_v, cudaStream_t stream) {
  if (d <= 0 || d % 16 || d > kI8MaxRowBytes || lp % 8 ||
      (nv_pad + kI8Videos - 1) / kI8Videos > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  static_assert(2 * (i8_smem(8) + 1024) <= 228 * 1024, "D = 256: two blocks an SM");
  static_assert(i8_smem(kI8MaxRowBytes / 32) <= kI8MaxSmem, "D = 384 does not fit");
  // D = 256 (the model's width) with the k loop unrolled and the next
  // k-step's fragments loading under this one's products; other widths read
  // it at run time
  if (d > 224 && d <= 256)
    return launch_i8_as<8>(qv, qs, fv, fs, nq, nv_pad, lp, d, n_videos, out, out_cols, bmax,
                           chunk_v, stream);
  return launch_i8_as<0>(qv, qs, fv, fs, nq, nv_pad, lp, d, n_videos, out, out_cols, bmax,
                         chunk_v, stream);
}

}  // namespace

extern "C" {

// kind: 0 int8 (tensor cores; d_words <= 96), 1 bf16, 2 f32 (FMA).
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
      return launch_i8(qv, qs, fv, fs, nq, nv_pad, lp, 4 * d_words, n_videos, out, out_cols,
                       bmax, chunk_v, s);
    case 1:
      launch<BFloat16>(qv, qs, fv, fs, nq, nv_pad, lp, d_words, n_videos, out, out_cols,
                       bmax, chunk_v, s);
      break;
    case 2:
      launch<Float32>(qv, qs, fv, fs, nq, nv_pad, lp, d_words, n_videos, out, out_cols,
                      bmax, chunk_v, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
