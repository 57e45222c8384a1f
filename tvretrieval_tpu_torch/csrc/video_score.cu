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
// device memory, and so does this one: a block owns 32 videos x 64 queries,
// every thread owns one video (its lane) x 8 queries, walks the video's
// rows 8 at a time with the dots in registers, and folds them into a
// running per-query max. Only the (Nq, Nv) scores (and B3's block maxima)
// are written. Inputs are read once per 64-query tile, so the bound is
// arithmetic: this first version uses __dp4a (int8, s32 accumulation) and
// plain FMA (bf16 / f32, f32 accumulation) over shared-memory tiles, not
// the tensor cores; wgmma / mma.sync tiles are the next step.
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

namespace {

constexpr int kThreads = 256;
constexpr int kVideos = 32;             // videos per block: one per lane
constexpr int kQueries = 64;            // queries per block
constexpr int kQPerThread = kQueries / (kThreads / 32);   // 8: one warp per query group
constexpr int kRows = 8;                // rows per video per step (lp % 8 == 0)
constexpr int kWords = 32;              // 4-byte words of the feature axis per stage
constexpr int kVideoStride = kRows * kWords + 1;  // odd: the 32 lanes hit 32 banks

// Element traits. A shared-memory word packs 4 int8, 2 bf16 or 1 f32 of
// the feature axis; `step` folds one word of every (row, query) pair into
// the accumulators.
struct Int8 {
  using Acc = int;
  __device__ static Acc zero() { return 0; }
  __device__ static Acc lowest() { return INT_MIN; }
  __device__ static Acc max(Acc a, Acc b) { return a > b ? a : b; }
  __device__ static void step(const uint32_t (&f)[kRows], const uint32_t (&q)[kQPerThread],
                              Acc (&acc)[kRows][kQPerThread]) {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int j = 0; j < kQPerThread; ++j)
        acc[r][j] = __dp4a(static_cast<int>(f[r]), static_cast<int>(q[j]), acc[r][j]);
  }
  // JAX: (mv + ms).astype(f32) * (0.5 / (127.0 * 127.0)), the constant
  // rounded once from double to f32
  __device__ static float combine(Acc v, Acc s) {
    const float c = static_cast<float>(0.5 / 16129.0);
    return static_cast<float>(v + s) * c;
  }
};

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

}  // namespace

extern "C" {

// kind: 0 int8, 1 bf16, 2 f32. d_words: the feature axis in 4-byte words
// (a multiple of 4). Returns cudaGetLastError() after the launch.
int tvr_video_scores(int kind, const void* qv, const void* qs, const void* fv,
                     const void* fs, int nq, int nv_pad, int lp, int d_words,
                     int n_videos, void* out, int out_cols, void* bmax, int chunk_v,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0:
      launch<Int8>(qv, qs, fv, fs, nq, nv_pad, lp, d_words, n_videos, out, out_cols,
                   bmax, chunk_v, s);
      break;
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
