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
// What bounds it on this card, and the design. As for the flat kernels of
// video_score.cu the work is a GEMM of Nv * L rows against the queries whose
// (Nq, Nv, L) product must not reach device memory, so the bound is
// arithmetic, and the tiling is theirs: a block owns 32 videos x 64 queries,
// a thread one video (its lane) x 8 queries; it walks the video's clips 8
// at a time with the dots in registers (plain FMA on shared-memory tiles;
// the tensor cores are a later step), masks each dot and folds it into a
// running per-query max. Clips past L in the last step of 8 are left out of
// the max. Only the (Nq, Nv) scores are written.
//
// Exactness. The mask arithmetic is written out as two roundings of a
// product and one of a sum (__fmul_rn / __fadd_rn), as the plain version
// computes it, so that no FMA contraction changes a fractional mask's
// result. The dots sum in another order than a library GEMM (f32 rounding
// slack). expf is the CUDA library's (no fast-math flag).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (tvretrieval_tpu_torch/ops/_build.py). C interface, loaded with
// ctypes; the entry point returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVideos = 32;             // videos per block: one per lane
constexpr int kQueries = 64;            // queries per block
constexpr int kQPerThread = kQueries / (kThreads / 32);   // 8: one warp per query group
constexpr int kRows = 8;                // clips per video per step
constexpr int kWords = 32;              // 4-byte words of the feature axis per stage
constexpr int kVideoStride = kRows * kWords + 1;  // odd: the 32 lanes hit 32 banks
constexpr float kMasked = -1e10f;       // ops/masking.py::NEG_INF, exact in f32

// `step` folds one 4-byte word of every (clip, query) pair into the
// accumulators: one f32, or two bf16 widened by a 16-bit shift (bf16 x bf16
// is exact in f32).
struct Float32 {
  __device__ static void step(const uint32_t (&f)[kRows], const uint32_t (&q)[kQPerThread],
                              float (&acc)[kRows][kQPerThread]) {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int j = 0; j < kQPerThread; ++j)
        acc[r][j] = fmaf(__uint_as_float(f[r]), __uint_as_float(q[j]), acc[r][j]);
  }
};

struct BFloat16 {
  __device__ static void step(const uint32_t (&f)[kRows], const uint32_t (&q)[kQPerThread],
                              float (&acc)[kRows][kQPerThread]) {
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

struct Params {
  const uint32_t* q[2];        // (nq, dw) words per stream
  const uint32_t* f[2];        // feature caches per stream
  const float* mask;
  int nq, nv, n_clips, dw, n_streams;
  long long f_video, f_clip;   // cache strides of the video and clip axes, in words
  long long m_video, m_clip;   // mask strides, in floats
  float init;                  // the running max starts here (-inf, or -1e10 for B10)
  int use_exp;
  float alpha;
  float* out;                  // (nq, nv)
};

template <class T>
__global__ void __launch_bounds__(kThreads, 2) masked_score_kernel(const Params p) {
  __shared__ uint32_t f_tile[kVideos * kVideoStride];
  __shared__ __align__(16) uint32_t q_tile[kQueries * kWords];

  const int lane = threadIdx.x & 31;      // this thread's video in the block
  const int group = threadIdx.x >> 5;     // queries group + 8 * j, j < 8
  const int q0 = blockIdx.x * kQueries;
  const int v0 = blockIdx.y * kVideos;
  const int v = v0 + lane;

  float total[kQPerThread];
#pragma unroll
  for (int j = 0; j < kQPerThread; ++j) total[j] = 0.0f;

  for (int stream = 0; stream < p.n_streams; ++stream) {
    const uint32_t* q = p.q[stream];
    const uint32_t* f = p.f[stream];
    float best[kQPerThread];
#pragma unroll
    for (int j = 0; j < kQPerThread; ++j) best[j] = p.init;

    for (int r0 = 0; r0 < p.n_clips; r0 += kRows) {
      float acc[kRows][kQPerThread];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int j = 0; j < kQPerThread; ++j) acc[r][j] = 0.0f;

      for (int k0 = 0; k0 < p.dw; k0 += kWords) {
        // stage 32 videos x 8 clips x 32 words of the cache, 16 bytes per
        // load; words past dw, clips past L and videos past nv are zeros
        for (int i = threadIdx.x; i < kVideos * kRows * (kWords / 4); i += kThreads) {
          const int piece = i % (kWords / 4);
          const int row = i / (kWords / 4);
          const int vs = row / kRows, r = row % kRows;
          const int vv = v0 + vs, kw = k0 + piece * 4;
          uint4 val = make_uint4(0u, 0u, 0u, 0u);
          if (vv < p.nv && r0 + r < p.n_clips && kw < p.dw)
            val = *reinterpret_cast<const uint4*>(
                f + static_cast<long long>(vv) * p.f_video +
                static_cast<long long>(r0 + r) * p.f_clip + kw);
          uint32_t* dst = f_tile + vs * kVideoStride + r * kWords + piece * 4;
          dst[0] = val.x; dst[1] = val.y; dst[2] = val.z; dst[3] = val.w;
        }
        // stage 64 queries x 32 words (zeros past nq or dw)
        for (int i = threadIdx.x; i < kQueries * (kWords / 4); i += kThreads) {
          const int piece = i % (kWords / 4);
          const int qi = i / (kWords / 4);
          const int qq = q0 + qi, kw = k0 + piece * 4;
          uint4 val = make_uint4(0u, 0u, 0u, 0u);
          if (qq < p.nq && kw < p.dw)
            val = *reinterpret_cast<const uint4*>(q + static_cast<size_t>(qq) * p.dw + kw);
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
      // s * m + (1 - m) * -1e10, each operation rounded on its own
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r0 + r >= p.n_clips || v >= p.nv) continue;
        const float m = p.mask[static_cast<long long>(v) * p.m_video +
                               static_cast<long long>(r0 + r) * p.m_clip];
        const float off = __fmul_rn(1.0f - m, kMasked);
#pragma unroll
        for (int j = 0; j < kQPerThread; ++j)
          best[j] = fmaxf(best[j], __fadd_rn(__fmul_rn(acc[r][j], m), off));
      }
    }
#pragma unroll
    for (int j = 0; j < kQPerThread; ++j)
      total[j] = stream == 0 ? best[j] : __fadd_rn(total[j], best[j]);
  }

#pragma unroll
  for (int j = 0; j < kQPerThread; ++j) {
    const int qq = q0 + group + 8 * j;    // the same for the whole warp
    float score = p.n_streams == 2 ? total[j] / 2.0f : total[j];
    if (p.use_exp) score = expf(__fmul_rn(p.alpha, score));
    if (qq < p.nq && v < p.nv) p.out[static_cast<size_t>(qq) * p.nv + v] = score;
  }
}

}  // namespace

extern "C" {

// kind: 1 bf16, 2 f32 (the numbering of tvr_video_scores). qs / fs may be
// null when n_streams is 1. d_words: the feature axis in 4-byte words (a
// multiple of 4). Strides in 4-byte words (cache) and floats (mask).
// Returns cudaGetLastError() after the launch.
int tvr_masked_scores(int kind, const void* qv, const void* qs, const void* fv,
                      const void* fs, const void* mask, int nq, int nv, int n_clips,
                      int d_words, long long f_video, long long f_clip, long long m_video,
                      long long m_clip, int n_streams, float init, int use_exp, float alpha,
                      void* out, void* stream) {
  if (nq <= 0 || nv <= 0 || n_clips <= 0 || d_words <= 0 || d_words % 4 ||
      n_streams < 1 || n_streams > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q[0] = static_cast<const uint32_t*>(qv);
  p.q[1] = static_cast<const uint32_t*>(qs);
  p.f[0] = static_cast<const uint32_t*>(fv);
  p.f[1] = static_cast<const uint32_t*>(fs);
  p.mask = static_cast<const float*>(mask);
  p.nq = nq; p.nv = nv; p.n_clips = n_clips; p.dw = d_words; p.n_streams = n_streams;
  p.f_video = f_video; p.f_clip = f_clip; p.m_video = m_video; p.m_clip = m_clip;
  p.init = init; p.use_exp = use_exp; p.alpha = alpha;
  p.out = static_cast<float*>(out);
  // queries fastest: the query tiles of one video tile run side by side and
  // share its feature rows through L2
  const dim3 grid((nq + kQueries - 1) / kQueries, (nv + kVideos - 1) / kVideos);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 1)
    masked_score_kernel<BFloat16><<<grid, kThreads, 0, s>>>(p);
  else if (kind == 2)
    masked_score_kernel<Float32><<<grid, kThreads, 0, s>>>(p);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
