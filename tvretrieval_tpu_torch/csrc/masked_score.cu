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
// arithmetic (at the data sheet's peaks, 1,000 queries x 21,818 videos x
// 100 clips x D = 256: B9 2.26 ms bf16, B10 1.13; f32 counted as three
// TF32 products, 13.55 and 6.77). Both kinds run on the tensor cores
// through mma.sync, with the tile code of s8_mma.cuh: bf16 m16n8k16, and
// f32 as three TF32 m16n8k8 products (the 3xTF32 split, whose argument
// s8_mma.cuh gives), f32 sums in both.
// The n axis of the products is videos, not clips: a ring step holds one
// clip's row of each of the block's videos (each row read through the
// video and clip strides, so both layouts take the same path), and the K
// loop of a clip runs over its ring steps. A clip's rows are then columns
// of independent videos, so after the clip's K loop every thread masks its
// own accumulator elements (one query and one video each) and folds them
// into a running max in registers: no shuffles, no atomics, no shared
// maxima, and the clip axis needs no padding (L = 100 is not a multiple of
// 8, which the flat kernels' clips-as-columns layout needs). The B9 layout
// reads a video's clip rows L * D apart; each row is contiguous, which is
// all a 16-byte copy needs. The mask values of a thread's columns are
// loaded when the clip's first ring step starts and used after its last.
// A block has 8 warps, each 32 queries (two m16 fragments) x 32 videos
// (four n8 fragments): in bf16 128 queries x 64 videos (four query groups
// x two video columns) with 256-byte K chunks; in f32 64 queries x 128
// videos (two x four) with 128-byte chunks, so that each split fragment
// serves four products (A across the n8 fragments, B across the m16 ones)
// and the split costs fewer instructions a product. Rows move through a
// two-stage cp.async ring into XOR-swizzled tiles read with ldmatrix; one
// stream's query tile stays resident, the second loaded over it when the
// first stream's steps are done, and the first stream's maxima wait in the
// output, each thread reading back what it wrote.
// Shared memory a block, at D = 256:
//   bf16: query tile 128 x 512 B = 64 KiB, ring 2 x 64 x 256 B  = 32 KiB
//   f32:  query tile 64 x 1,024 B = 64 KiB, ring 2 x 128 x 128 B = 32 KiB
// = 96 KiB, so two blocks share an SM and one's barrier, copies and mask
// epilogue run under the other's products. D is at most 768 in either kind
// (224 KiB, one block an SM). Queries past Nq and videos past Nv load as
// zeros and are not written.
//
// Exactness. The mask arithmetic is written out as two roundings of a
// product and one of a sum (__fmul_rn / __fadd_rn), as the plain version
// computes it, so that no FMA contraction changes a fractional mask's
// result. The dots are f32 sums of exact products (bf16), or of the split's
// three products (f32), in another order than a library GEMM: f32 summation
// slack, held to 1e-5 of the plain versions. expf is the CUDA library's (no
// fast-math flag).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (tvretrieval_tpu_torch/ops/_build.py). C interface, loaded with
// ctypes; the entry point returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "s8_mma.cuh"

namespace {

constexpr int kThreads = 256;           // 8 warps
constexpr int kStages = 2;              // ring depth
constexpr int kMaxD = 768;              // features a row, either kind
constexpr int kMaxSmem = 227 * 1024;
constexpr float kMasked = -1e10f;       // ops/masking.py::NEG_INF, exact in f32

// The two products. Queries x Videos: the block's tile; a ring step holds
// one clip's row of each video, ChunkSteps k-steps (32 bytes) of it.
// Split: the fragments are f32, split into TF32 halves and multiplied
// three times.
struct MaskedBf16 {
  static constexpr int kQueries = 128;
  static constexpr int kVideos = 64;
  static constexpr int kChunkSteps = 8;           // 256 bytes of a 512-byte row
  static constexpr bool kSplit = false;
  static constexpr int kMaxRowBytes = 2 * kMaxD;
  __device__ static void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    s8mma::mma_bf16(c, a, b0, b1);
  }
};
struct MaskedTf32x3 {
  static constexpr int kQueries = 64;             // two blocks an SM at D = 256
  static constexpr int kVideos = 128;             // 32 x 32 warp tiles: fewer splits a product
  static constexpr int kChunkSteps = 4;           // 128 bytes of a 1,024-byte row
  static constexpr bool kSplit = true;
  static constexpr int kMaxRowBytes = 4 * kMaxD;
};

// tile rows: whole swizzle periods of 128 bytes
__host__ __device__ constexpr int row_bytes(int nk) { return (2 * nk + 7) / 8 * 128; }
template <class M>
__host__ __device__ constexpr int chunk_steps(int nk) {
  return nk < M::kChunkSteps ? nk : M::kChunkSteps;
}
template <class M>
__host__ __device__ constexpr int smem_bytes(int nk) {
  return M::kQueries * row_bytes(nk) + kStages * M::kVideos * row_bytes(chunk_steps<M>(nk));
}
static_assert(2 * (smem_bytes<MaskedBf16>(16) + 1024) <= 228 * 1024, "bf16 D = 256: two blocks");
static_assert(2 * (smem_bytes<MaskedTf32x3>(32) + 1024) <= 228 * 1024, "f32 D = 256: two blocks");
// the second stream's query tile rides on the ring's copy groups: with two
// stages each step waits for every group, that one included
static_assert(kStages == 2, "the query reload needs a two-stage ring");
static_assert(smem_bytes<MaskedBf16>(MaskedBf16::kMaxRowBytes / 32) <= kMaxSmem, "D = 768 bf16");
static_assert(smem_bytes<MaskedTf32x3>(MaskedTf32x3::kMaxRowBytes / 32) <= kMaxSmem,
              "D = 768 f32");

struct Params {
  const unsigned char* q[2];   // (nq, d) rows per stream
  const unsigned char* f[2];   // feature caches per stream
  const float* mask;
  int nq, nv, n_clips, d, n_streams;   // d: bytes a row, a multiple of 16
  long long f_video, f_clip;   // cache strides of the video and clip axes, in bytes
  long long m_video, m_clip;   // mask strides, in floats
  float init;                  // the running max starts here (-inf, or -1e10 for B10)
  int use_exp;
  float alpha;
  float* out;                  // (nq, nv)
};

// KS: the k-steps of a ring step, fixed at compile time when every step
// holds KS of them (KS = 0: read from d).
template <class M, int KS>
__global__ void __launch_bounds__(kThreads, 2) masked_score_kernel(const Params p) {
  using namespace s8mma;
  constexpr int QT = M::kQueries, kVideos = M::kVideos;
  constexpr int MF = 2;                           // m16 fragments a warp: 32 queries
  constexpr int WM = QT / (MF * 16);              // warps along the queries: 4, or 2
  constexpr int WN = kThreads / 32 / WM;          // ... along the videos: 2, or 4
  constexpr int NF = kVideos / 8 / WN;            // n8 fragments a warp: 32 videos
  static_assert(WM * WN * 32 == kThreads && NF % 2 == 0, "the warp grid");
  extern __shared__ __align__(128) unsigned char smem[];
  const int nk = (p.d + 31) / 32;                 // k-steps of the row
  const int ks = KS ? KS : chunk_steps<M>(nk);    // k-steps of a ring step
  const int nkc = (nk + ks - 1) / ks;             // ring steps a clip takes
  const int q_rb = row_bytes(nk), f_rb = row_bytes(ks);
  const int n_valid = p.d / 16;                   // 16-byte pieces of real features
  unsigned char* q_tile = smem;                   // [QT][q_rb]
  unsigned char* f_ring = smem + QT * q_rb;       // [stage][kVideos][f_rb]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;       // query group, video column
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * QT;
  const int v0 = blockIdx.y * kVideos;
  const int n_steps = p.n_clips * nkc;            // ring steps a stream
  const int n_total = p.n_streams * n_steps;

  // rows past nq and pieces past d are zeros
  auto load_queries = [&](int s) {
    const int n_load = 2 * nk;                    // pieces a row
    for (int i = tid; i < QT * n_load; i += kThreads) {
      const int r = i / n_load, c = i - r * n_load;
      const unsigned char* q = s ? p.q[1] : p.q[0];
      const bool ok = q0 + r < p.nq && c < n_valid;
      cp_async16(smem_addr(q_tile) + swizzle(r, c, q_rb),
                 ok ? q + static_cast<size_t>(q0 + r) * p.d + c * 16 : q, ok ? 16 : 0);
    }
  };
  load_queries(0);
  // step t: stream t / n_steps; clip (t % n_steps) / nkc, K chunk (t % n_steps) % nkc;
  // tile row r is video v0 + r (zeros past nv)
  auto load_step = [&](int t) {
    const int s = t / n_steps, st = t - s * n_steps;
    const int l = st / nkc, kc = st - l * nkc;
    const unsigned char* f = s ? p.f[1] : p.f[0];
    const unsigned char* clip = f + l * p.f_clip;
    const uint32_t dst = smem_addr(f_ring + (t % kStages) * kVideos * f_rb);
    const int c0 = kc * 2 * ks;                   // the chunk's first piece
    if constexpr (KS > 0) {
      // a thread's piece is the same in every row it copies, and its rows
      // are kThreads / (2 KS) apart: no division in the loop
      constexpr int kLoad = 2 * KS, kRowStep = kThreads / kLoad;
      static_assert(kThreads % kLoad == 0 && kVideos % kRowStep == 0, "rows a thread copies");
      const int r0 = tid / kLoad, c = tid % kLoad;
      const uint32_t d0 = dst + swizzle(r0, c, f_rb);         // the same swizzle every row
#pragma unroll
      for (int j = 0; j < kVideos / kRowStep; ++j) {
        const int v = v0 + r0 + j * kRowStep;
        const bool ok = v < p.nv;
        cp_async16(d0 + j * kRowStep * f_rb, ok ? clip + v * p.f_video + (c0 + c) * 16 : f,
                   ok ? 16 : 0);
      }
    } else {
      const int n_load = 2 * min(ks, nk - kc * ks);
      for (int i = tid; i < kVideos * n_load; i += kThreads) {
        const int r = i / n_load, c = i - r * n_load;
        const bool ok = v0 + r < p.nv && c0 + c < n_valid;
        cp_async16(dst + swizzle(r, c, f_rb),
                   ok ? clip + (v0 + r) * p.f_video + (c0 + c) * 16 : f, ok ? 16 : 0);
      }
    }
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {         // the first group carries the queries
    if (t < n_total) load_step(t);
    cp_async_commit();
  }

  // this thread's accumulator elements: e = 2 h + j of fragment (mi, ni) is
  // query q0 + wm * 32 + mi * 16 + g + 8 h, video v0 + vcol(ni, j)
  auto vcol = [&](int ni, int j) { return wn * (NF * 8) + ni * 8 + 2 * t4 + j; };
  auto qrow = [&](int mi, int h) { return wm * (MF * 16) + mi * 16 + g + 8 * h; };
  float best[MF][NF][4];                          // running max over the clips
  float mk[NF][2];                                // this clip's mask of the thread's videos
#pragma unroll
  for (int mi = 0; mi < MF; ++mi)
#pragma unroll
    for (int ni = 0; ni < NF; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) best[mi][ni][e] = p.init;

  // the maxima of a stream: stream 0 of two waits in the output; the last
  // one is combined with it, through exp if asked, and written
  auto store = [&](bool last) {
#pragma unroll
    for (int mi = 0; mi < MF; ++mi)
#pragma unroll
      for (int ni = 0; ni < NF; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qq = q0 + qrow(mi, e >> 1), v = v0 + vcol(ni, e & 1);
          if (qq >= p.nq || v >= p.nv) continue;
          float* o = p.out + static_cast<size_t>(qq) * p.nv + v;
          float score = best[mi][ni][e];
          if (last) {
            if (p.n_streams == 2) score = __fadd_rn(*o, score) / 2.0f;
            if (p.use_exp) score = expf(__fmul_rn(p.alpha, score));
          }
          *o = score;
          best[mi][ni][e] = p.init;
        }
  };

  float acc[MF][NF][4];
  for (int t = 0; t < n_total; ++t) {
    cp_async_wait<kStages - 2>();                 // step t has landed, for this thread
    __syncthreads();                              // ... for all; step t - 1 is done
    if (t + kStages - 1 < n_total) load_step(t + kStages - 1);
    cp_async_commit();
    const int s = t / n_steps, st = t - s * n_steps;
    const int l = st / nkc, kc = st - l * nkc;
    // with KS a multiple of 4, chunk kc starts at byte kc * KS * 32 of every
    // query row whatever the row's swizzle: fold it into the tile's base
    constexpr bool kFold = KS > 0 && KS % 4 == 0;
    const uint32_t qa = smem_addr(q_tile) + (kFold ? kc * KS * 32 : 0);
    const int kq = kFold ? 0 : kc * ks;           // the query tile's k-step of kk = 0
    const uint32_t fb = smem_addr(f_ring + (t % kStages) * kVideos * f_rb);
    if (kc == 0) {
#pragma unroll
      for (int mi = 0; mi < MF; ++mi)
#pragma unroll
        for (int ni = 0; ni < NF; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;
#pragma unroll
      for (int ni = 0; ni < NF; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int v = v0 + vcol(ni, j);
          mk[ni][j] = v < p.nv ? __ldg(p.mask + v * p.m_video + l * p.m_clip) : 0.0f;
        }
    }
    // the next k-step's fragments load under this one's products, except in
    // f32, whose split halves would not fit the registers beside them
    warp_tile_step<M, KS, M::kSplit ? 1 : 2>(acc, qa, wm * (MF * 16), kq, q_rb, fb, wn * (NF * 8),
                                             f_rb, lane, KS ? KS : min(ks, nk - kc * ks));
    if (kc == nkc - 1) {
      // the clip's dots are whole: s * m + (1 - m) * -1e10, each operation
      // rounded on its own, into the running max
#pragma unroll
      for (int ni = 0; ni < NF; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float m = mk[ni][j], off = __fmul_rn(1.0f - m, kMasked);
#pragma unroll
          for (int mi = 0; mi < MF; ++mi)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              best[mi][ni][2 * h + j] =
                  fmaxf(best[mi][ni][2 * h + j], __fadd_rn(__fmul_rn(acc[mi][ni][2 * h + j], m), off));
        }
    }
    if (st == n_steps - 1) {                      // the stream's last step
      store(s == p.n_streams - 1);
      if (s + 1 < p.n_streams) {
        // every warp is done with the first stream's queries: load the
        // second's over them; step t + 1 waits for this group too
        __syncthreads();
        load_queries(s + 1);
        cp_async_commit();
      }
    }
  }
}

template <class M, int KS>
int launch_as(const Params& p, cudaStream_t stream) {
  const auto kernel = masked_score_kernel<M, KS>;
  const int bytes = smem_bytes<M>((p.d + 31) / 32);
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // queries fastest: the query tiles of one video tile run side by side and
  // share its feature rows through L2
  const dim3 grid((p.nq + M::kQueries - 1) / M::kQueries,
                  (p.nv + M::kVideos - 1) / M::kVideos);
  kernel<<<grid, kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// rows of whole ring steps (D = 256: bf16 two of 256 bytes, f32 eight of
// 128) run with the k loop unrolled, the next k-step's fragments loading
// under this one's products; other widths read it at run time
template <class M>
int launch(const Params& p, cudaStream_t stream) {
  return p.d % 32 == 0 && (p.d / 32) % M::kChunkSteps == 0
             ? launch_as<M, M::kChunkSteps>(p, stream)
             : launch_as<M, 0>(p, stream);
}

}  // namespace

extern "C" {

// kind: 1 bf16, 2 f32 (the numbering of tvr_video_scores), both on the
// tensor cores. qs / fs may be null when n_streams is 1. d_words: the
// feature axis in 4-byte words (a multiple of 4; D <= 768). Strides in
// 4-byte words (cache) and floats (mask). Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for a shape the kernel does not take.
int tvr_masked_scores(int kind, const void* qv, const void* qs, const void* fv,
                      const void* fs, const void* mask, int nq, int nv, int n_clips,
                      int d_words, long long f_video, long long f_clip, long long m_video,
                      long long m_clip, int n_streams, float init, int use_exp, float alpha,
                      void* out, void* stream) {
  const int max_bytes = kind == 1 ? MaskedBf16::kMaxRowBytes : MaskedTf32x3::kMaxRowBytes;
  const int tile_videos = kind == 1 ? MaskedBf16::kVideos : MaskedTf32x3::kVideos;
  if (nq <= 0 || nv <= 0 || n_clips <= 0 || d_words <= 0 || d_words % 4 ||
      4 * d_words > max_bytes || f_video % 4 || f_clip % 4 || n_streams < 1 ||
      n_streams > 2 || (nv + tile_videos - 1) / tile_videos > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q[0] = static_cast<const unsigned char*>(qv);
  p.q[1] = static_cast<const unsigned char*>(n_streams == 2 ? qs : qv);
  p.f[0] = static_cast<const unsigned char*>(fv);
  p.f[1] = static_cast<const unsigned char*>(n_streams == 2 ? fs : fv);
  p.mask = static_cast<const float*>(mask);
  p.nq = nq; p.nv = nv; p.n_clips = n_clips; p.d = 4 * d_words; p.n_streams = n_streams;
  p.f_video = 4 * f_video; p.f_clip = 4 * f_clip; p.m_video = m_video; p.m_clip = m_clip;
  p.init = init; p.use_exp = use_exp; p.alpha = alpha;
  p.out = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 1) return launch<MaskedBf16>(p, s);
  if (kind == 2) return launch<MaskedTf32x3>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
