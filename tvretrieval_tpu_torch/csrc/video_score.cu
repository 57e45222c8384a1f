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
// maxima) are written, so the bound is arithmetic (1.17 ms int8, 2.35 ms
// bf16, 34.7 ms f32 at the data sheet's peaks).
//
// int8 and bf16 (B1, B2, B3): the tensor cores through mma.sync, s8
// m16n8k32 with s32 sums or bf16 m16n8k16 with f32 sums (tile code in
// s8_mma.cuh: a k-step is 32 bytes and the fragments have the same byte
// layout in both, so one kernel template, video_score_mma_kernel, serves
// them). A block owns 128 queries x 16 videos and 8 warps: four query
// groups of 32 (two m16 fragments) x two columns of 32 flat rows (four n8
// fragments). The block's 16 x lp flat rows stream through a two-stage
// cp.async ring, 64 rows a step, stream by stream, into XOR-swizzled tiles
// read with ldmatrix. Because lp % 8 == 0, an n8 fragment is 8 rows of one
// video, so after a row block's K loop each thread folds its fragments'
// columns into a running max per (query, video) in registers (a three-way
// max); when the warp's video changes it takes the max over the quad
// (shuffles) and folds it into a per-(stream, query, video) max in shared
// memory (atomics: one video's fragments are spread over the warp
// columns). The grid runs the query tiles of one video tile side by side,
// so they share its rows through L2 and device memory is read about once.
// The K axis is padded to 32 bytes with zeros in shared memory.
// Shared memory a block, at D = 256 (the model's width):
//   int8: both streams' query tiles resident   2 x 128 x 256 B = 64 KiB
//         ring, 2 stages x 64 rows x the row   2 x 64 x 256 B  = 32 KiB
//   bf16: one stream's query tile resident     128 x 512 B     = 64 KiB
//         (the second loads over it when the first stream's steps are done)
//         ring, 2 stages x 64 rows x 256 B     (a row block takes two
//         steps, one for each half of the 512-byte row)            = 32 KiB
//   both: per-(stream, query, video) maxima    2 x 128 x 16 x 4 B = 16 KiB
// = 112 KiB, so two blocks share an SM and one's barrier, copies and
// epilogue run under the other's products; the k loop is unrolled at that
// width, the next k-step's fragments loading while this one's products run.
// Int8 rows are at most 384 bytes (160 KiB), bf16 rows at most 1,024
// (D = 512, 176 KiB; D = 384, the widest in use, 144 KiB: one block an SM).
//
// f32 (B2, B3): plain FMA over shared-memory tiles: a block owns 32 videos
// x 64 queries, every thread one video (its lane) x 8 queries, walking the
// video's rows 8 at a time with the dots in registers. The tensor cores
// take no f32 input at this precision (TF32 keeps 10 mantissa bits).
//
// Exactness. Integer accumulation and max are exact, and the int8 rescale
// is the same single f32 multiply by f32(0.5 / 16129) that JAX does, so B1
// and B3-int8 are bit-equal to their plain versions. The bf16 kind's
// tolerance argument:
//  1. a bf16 x bf16 product is exact in f32 (8 + 8 significant bits), and
//     the plain version upcasts to f32 and multiplies there with TF32 off
//     (tvretrieval_tpu_torch/__init__.py), so both sides sum the same D
//     exact products in f32 and differ only in the order of the sums, as
//     the f32 FMA kernel and its plain version do;
//  2. the engine L2-normalizes queries and caches, so sum |q_i f_i| <=
//     |q| |f| ~ 1, and any order's rounding error is at most (D - 1) 2^-24
//     ~ 1.5e-5 at D = 256 in the worst case and ~ sqrt(D) 2^-24 ~ 1e-6 in
//     practice; a max over rows and the halving combine add nothing to it;
//  3. the TPU kernel itself sums on the MXU in f32
//     (preferred_element_type=jnp.float32), so the tensor cores are closer
//     to the reference's own arithmetic than FMA is;
//  4. nothing sums in reduced precision: no split-K, no bf16 partial sums.
// So B2 / B3-bf16 are held to 1e-5 of their plain versions, the bound the
// FMA kernel was held to (tests/test_torch_mma_order.py models the
// tensor-core order on the CPU).
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

// Element traits of the FMA kernel (f32 only: bf16 runs on the tensor
// cores). A shared-memory word holds one f32 of the feature axis; `step`
// folds one word of every (row, query) pair into the accumulators.
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

// float max through integer atomics: floats with the sign bit clear order
// like signed ints, floats with it set (-0.0 included) order reversed as
// unsigned ints
__device__ void atomic_max_float(float* addr, float value) {
  if (__float_as_int(value) >= 0)
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

// ------------------------------------- int8 and bf16: the tensor cores
constexpr int kMmaThreads = 256;        // 8 warps: 4 query groups x 2 row columns
constexpr int kMmaQueries = 128;        // queries per block: the A tile
constexpr int kMmaVideos = 16;          // videos per block
constexpr int kMmaRows = 64;            // flat rows a ring step: 8 n8 fragments
constexpr int kMmaStages = 2;           // ring depth
constexpr int kMaxSmem = 227 * 1024;

// JAX: (mv + ms).astype(f32) * (0.5 / (127.0 * 127.0)), the constant
// rounded once from double to f32
__device__ __forceinline__ float i8_score(int v, int s) {
  return static_cast<float>(v + s) * static_cast<float>(0.5 / 16129.0);
}

// The two products. A k-step is 32 bytes of the feature axis in both; a
// ring step holds the 64 rows' bytes of up to kChunkSteps k-steps.
// BothResident: both streams' query tiles stay in shared memory; otherwise
// one at a time, the second loaded when the first stream's steps are done.
struct S8Mma {                          // B1, B3-int8: s32 dots, integer max
  using Acc = int;
  static constexpr bool kBothResident = true;
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

struct Bf16Mma {                        // B2, B3-bf16: f32 sums of exact products
  using Acc = float;
  static constexpr bool kBothResident = false;
  static constexpr int kChunkSteps = 8;           // 256 bytes of a 512-byte row
  static constexpr int kMaxRowBytes = 1024;
  __device__ static Acc lowest() { return -INFINITY; }
  __device__ static void mma(Acc (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    s8mma::mma_bf16(c, a, b0, b1);
  }
  __device__ static Acc max3(Acc a, Acc b, Acc c) { return fmaxf(a, fmaxf(b, c)); }
  __device__ static Acc max(Acc a, Acc b) { return fmaxf(a, b); }
  __device__ static void atomic_max(Acc* p, Acc v) { atomic_max_float(p, v); }
  __device__ static float score(Acc v, Acc s) { return (v + s) / 2.0f; }
};

// tile rows: whole swizzle periods of 128 bytes
__host__ __device__ constexpr int mma_row_bytes(int nk) { return (2 * nk + 7) / 8 * 128; }
template <class M>
__host__ __device__ constexpr int mma_chunk_steps(int nk) {
  return nk < M::kChunkSteps ? nk : M::kChunkSteps;
}
template <class M>
__host__ __device__ constexpr int mma_smem(int nk) {
  return (M::kBothResident ? 2 : 1) * kMmaQueries * mma_row_bytes(nk)
         + kMmaStages * kMmaRows * mma_row_bytes(mma_chunk_steps<M>(nk))
         + 2 * kMmaQueries * kMmaVideos * 4;
}

// q: (nq, d) rows of int8 or bf16, d bytes a row (a multiple of 16); f:
// (nv_pad * lp, d). out, bmax, chunk_v as for video_score_kernel. KS: the
// k-steps (32 bytes) of a ring step, fixed at compile time when every
// step holds KS of them (KS = 0: read from d).
template <class M, int KS>
__global__ void __launch_bounds__(kMmaThreads, 2)
video_score_mma_kernel(const unsigned char* __restrict__ qv, const unsigned char* __restrict__ qs,
                       const unsigned char* __restrict__ fv, const unsigned char* __restrict__ fs,
                       int nq, int nv_pad, int lp, int d, int n_videos,
                       float* __restrict__ out, int out_cols,
                       float* __restrict__ bmax, int chunk_v) {
  using namespace s8mma;
  using Acc = typename M::Acc;
  constexpr int MF = 2;                           // m16 fragments a warp: 32 queries
  constexpr int FRAGS = kMmaRows / 8;             // n8 fragments a ring step
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
  unsigned char* q_tile = smem;                                   // [tile][128][q_rb]
  unsigned char* f_ring = smem + kQTiles * kMmaQueries * q_rb;    // [stage][64][f_rb]
  // [stream][query][video]: the max of each video's dots
  Acc* best = reinterpret_cast<Acc*>(f_ring + kMmaStages * kMmaRows * f_rb);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;        // query group, row column
  const int q0 = blockIdx.x * kMmaQueries;
  const int v0 = blockIdx.y * kMmaVideos;
  const int fpv = lp / 8;                         // n8 fragments per video
  const int n_blocks = 16 * fpv / FRAGS;          // row blocks of 64 a stream
  const int n_steps = n_blocks * nkc;             // ring steps a stream
  const int n_total = 2 * n_steps;                // both streams
  const size_t n_rows = static_cast<size_t>(nv_pad) * lp;
  const size_t row0 = static_cast<size_t>(v0) * lp;

  for (int i = tid; i < 2 * kMmaQueries * kMmaVideos; i += kMmaThreads) best[i] = M::lowest();

  // query tiles; rows past nq and pieces past d are zeros
  auto load_queries = [&](int s0, int n_s) {
    const int n_load = 2 * nk;                    // pieces a row
    for (int i = tid; i < n_s * kMmaQueries * n_load; i += kMmaThreads) {
      const int s = i / (kMmaQueries * n_load), rem = i - s * kMmaQueries * n_load;
      const int r = rem / n_load, c = rem - r * n_load;
      const unsigned char* q = (s0 + s) ? qs : qv;
      const bool ok = q0 + r < nq && c < n_valid;
      cp_async16(smem_addr(q_tile + s * kMmaQueries * q_rb) + swizzle(r, c, q_rb),
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
        M::atomic_max(&best[(s * kMmaQueries + q) * kMmaVideos + vl], run[e >> 1][e & 1]);
      }
  };

  uint32_t a[2][MF][4], b[2][4][2];
  Acc acc[MF][4][4];
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
    const uint32_t qa = smem_addr(q_tile + (M::kBothResident ? s : 0) * kMmaQueries * q_rb)
                        + (kFold ? kc * KS * 32 : 0);
    const int kq = kFold ? 0 : kc * ks;           // the query tile's k-step of kk = 0
    const uint32_t fb = smem_addr(f_ring + (t % kMmaStages) * kMmaRows * f_rb);
    if (kc == 0) {
#pragma unroll
      for (int mi = 0; mi < MF; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = Acc(0);
    }
    // k-step kk of this chunk: the query tile's k-step kc * ks + kk
    auto load_frags = [&](int kk, int buf) {
#pragma unroll
      for (int mi = 0; mi < MF; ++mi)
        ldmatrix_x4(a[buf][mi], a_frag_addr(qa, wm * (MF * 16) + mi * 16, kq + kk, lane, q_rb));
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4(r, b_frag_pair_addr(fb, wn * 32 + np * 16, kk, lane, f_rb));
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
        for (int ni = 0; ni < 4; ++ni)
          M::mma(acc[mi][ni], a[buf][mi], b[buf][ni][0], b[buf][ni][1]);
    };
    if constexpr (KS > 0) {
      // fragments of k-step kk + 1 load while k-step kk multiplies
      load_frags(0, 0);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        if (kk + 1 < KS) load_frags(kk + 1, (kk + 1) & 1);
        mma_all(kk & 1);
      }
    } else {
      const int n_kk = min(ks, nk - kc * ks);
#pragma unroll 1
      for (int kk = 0; kk < n_kk; ++kk) {
        load_frags(kk, 0);
        mma_all(0);
      }
    }
    if (kc == nkc - 1) {
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
  for (int p = tid; p < kMmaQueries * kMmaVideos; p += kMmaThreads) {
    const int q = p / kMmaVideos, vl = p % kMmaVideos, qq = q0 + q, v = v0 + vl;
    float score = M::score(best[q * kMmaVideos + vl], best[(kMmaQueries + q) * kMmaVideos + vl]);
    if (bmax == nullptr) {
      if (qq < nq && v < n_videos) out[static_cast<size_t>(qq) * out_cols + v] = score;
    } else {
      if (v >= n_videos) score = -INFINITY;
      if (qq < nq && v < nv_pad) out[static_cast<size_t>(qq) * out_cols + v] = score;
    }
  }
  if (bmax == nullptr || tid >= kMmaQueries || q0 + tid >= nq) return;
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
        : M::score(best[tid * kMmaVideos + vl], best[(kMmaQueries + tid) * kMmaVideos + vl]);
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
  // queries fastest: the 8 query tiles of one video tile (Nq = 1,000) run
  // side by side and share its feature rows through L2
  const dim3 grid((nq + kMmaQueries - 1) / kMmaQueries, (nv_pad + kMmaVideos - 1) / kMmaVideos);
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
  // the model's width, D = 256 (256 int8 bytes, one ring step a row block;
  // 512 bf16 bytes, two), with the k loop unrolled and the next k-step's
  // fragments loading under this one's products; other widths read it at
  // run time
  constexpr int kModelSteps = 256 / 32 * (M::kBothResident ? 1 : 2);
  if ((d + 31) / 32 == kModelSteps)
    return launch_mma_as<M, 8>(qv, qs, fv, fs, nq, nv_pad, lp, d, n_videos, out, out_cols, bmax,
                               chunk_v, stream);
  return launch_mma_as<M, 0>(qv, qs, fv, fs, nq, nv_pad, lp, d, n_videos, out, out_cols, bmax,
                             chunk_v, stream);
}

// D = 256: two blocks an SM (112 KiB each, with the 1 KiB each reserves)
static_assert(2 * (mma_smem<S8Mma>(8) + 1024) <= 228 * 1024, "int8 D = 256: two blocks an SM");
static_assert(2 * (mma_smem<Bf16Mma>(16) + 1024) <= 228 * 1024, "bf16 D = 256: two blocks an SM");
// D = 384 bf16 (768-byte rows; the widest feature axis in use) fits one
// block an SM: 96 + 32 + 16 KiB
static_assert(mma_smem<Bf16Mma>(24) <= kMaxSmem, "bf16 D = 384 does not fit");

}  // namespace

extern "C" {

// kind: 0 int8 (s8 tensor cores; d_words <= 96), 1 bf16 (bf16 tensor cores;
// d_words <= 256), 2 f32 (FMA). d_words: the feature axis in 4-byte words
// (a multiple of 4). Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a shape the kernel does not take.
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
      launch<Float32>(qv, qs, fv, fs, nq, nv_pad, lp, d_words, n_videos, out, out_cols,
                      bmax, chunk_v, s);
      return static_cast<int>(cudaGetLastError());
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
