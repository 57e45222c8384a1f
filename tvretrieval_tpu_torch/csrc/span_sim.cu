// Int8 span-similarity sweep for Hopper (sm_90a): the port of
// tvretrieval_tpu/ops/pallas_score.py::span_sim_pallas_cat_i8
// (_span_sim_kernel_i8, :417-514), kernel B5.
//
// What it computes. q8 (nq, K) int8 are the halved, concatenated, quantized
// query vectors with one f32 scale per query; f8 (rows, K) int8 is the
// video-major flat feat2 cache (rows = Nv_pad * lp, build_flat_feat2_i8)
// with one f32 scale per row. For every query q and row r
//   out[q, r] = bf16( (f32(q8[q] . f8[r]) * q_scale[q]) * f_scale[r] )
// with the dot accumulated in s32. out is (nq, rows) row-major, which the
// caller views as (nq, Nv_pad, lp): the engine's top-V row gather then
// reads contiguous lp-runs.
//
// What bounds it on this card, and the design. At the full corpus (1,000
// queries x 2.79M rows x K = 512) the work is 2.86e12 integer operations
// and 7 GB of traffic, 5.6 GB of it the bf16 output, so a tensor-core
// version would be bound by bytes; this first version runs the dots on
// __dp4a and is bound by them. The TPU kernel exists so that the s32
// similarity never reaches device memory, and so does this one: a block
// owns 64 queries x 256 rows, a thread 8 queries x 8 rows with its 64 s32
// sums in registers, and only the rescaled bf16 values are written. The
// K axis is staged through shared memory 64 bytes at a time, stored
// word-major ([word][row]) so that a thread fetches its rows' words with
// 16-byte loads that the lanes of a warp spread over all banks, and its
// queries' words with 16-byte broadcasts. A thread's rows are two runs of
// four (lane * 4 and 128 + lane * 4), so a warp stores 256 contiguous
// bytes per query and run, 8 bytes per lane. Query tiles vary fastest
// over the grid, so the 16 blocks that share a row tile run side by side
// and the cache is read from device memory once.
//
// Exactness. The s32 dot is exact; the epilogue converts it to f32 (exact
// below 2^24; K * 127^2 stays below that for K <= 1040), multiplies by the
// query scale and then by the row scale with two separately rounded f32
// multiplications in that association, and rounds once to bf16 (nearest
// even): bit-equal to span_sim_int8_xla, the plain version.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (tvretrieval_tpu_torch/ops/_build.py). C interface, loaded with
// ctypes; the entry point returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQueries = 64;    // queries per block: 8 per warp
constexpr int kRows = 256;      // rows per block: 2 runs of 4 per lane
constexpr int kWords = 16;      // 4-byte words of the K axis per stage

// q8: (nq, kw) words; f8: (rows, kw) words; q_scale: (nq); f_scale: (rows);
// out: (nq, rows) bf16. rows % 4 == 0 and kw % 4 == 0 (the wrapper checks).
__global__ void __launch_bounds__(kThreads, 2)
span_sim_kernel(const uint32_t* __restrict__ q8, const float* __restrict__ q_scale,
                const uint32_t* __restrict__ f8, const float* __restrict__ f_scale,
                int nq, long long rows, int kw, int n_qtiles,
                __nv_bfloat16* __restrict__ out) {
  __shared__ __align__(16) uint32_t f_tile[kWords][kRows];
  __shared__ __align__(16) uint32_t q_tile[kWords][kQueries];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q0 = static_cast<int>(blockIdx.x % n_qtiles) * kQueries;
  const long long r0 = static_cast<long long>(blockIdx.x / n_qtiles) * kRows;

  int acc[8][8];                // [query of the warp's 8][row: run * 4 + i]
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = 0;

  for (int k0 = 0; k0 < kw; k0 += kWords) {
    // stage 256 rows x 16 words: one row per thread, 16 bytes per load,
    // scattered word-major (lanes hold consecutive rows: no bank conflict);
    // rows past the end and words past kw are zeros, which add nothing
    {
      const long long r = r0 + threadIdx.x;
#pragma unroll
      for (int piece = 0; piece < kWords / 4; ++piece) {
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (r < rows && k0 + piece * 4 < kw)
          val = *reinterpret_cast<const uint4*>(f8 + r * kw + k0 + piece * 4);
        f_tile[piece * 4 + 0][threadIdx.x] = val.x;
        f_tile[piece * 4 + 1][threadIdx.x] = val.y;
        f_tile[piece * 4 + 2][threadIdx.x] = val.z;
        f_tile[piece * 4 + 3][threadIdx.x] = val.w;
      }
    }
    // stage 64 queries x 16 words: thread -> (query, piece of 4 words)
    {
      const int qi = threadIdx.x & (kQueries - 1);
      const int piece = threadIdx.x / kQueries;          // 0..3
      const int q = q0 + qi;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (q < nq && k0 + piece * 4 < kw)
        val = *reinterpret_cast<const uint4*>(
            q8 + static_cast<long long>(q) * kw + k0 + piece * 4);
      q_tile[piece * 4 + 0][qi] = val.x;
      q_tile[piece * 4 + 1][qi] = val.y;
      q_tile[piece * 4 + 2][qi] = val.z;
      q_tile[piece * 4 + 3][qi] = val.w;
    }
    __syncthreads();
#pragma unroll 4
    for (int w = 0; w < kWords; ++w) {
      const uint4 fa = *reinterpret_cast<const uint4*>(&f_tile[w][lane * 4]);
      const uint4 fb = *reinterpret_cast<const uint4*>(&f_tile[w][128 + lane * 4]);
      const uint4 qa = *reinterpret_cast<const uint4*>(&q_tile[w][warp * 8]);
      const uint4 qb = *reinterpret_cast<const uint4*>(&q_tile[w][warp * 8 + 4]);
      const uint32_t f[8] = {fa.x, fa.y, fa.z, fa.w, fb.x, fb.y, fb.z, fb.w};
      const uint32_t q[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b)
          acc[a][b] = __dp4a(static_cast<int>(q[a]), static_cast<int>(f[b]), acc[a][b]);
    }
    __syncthreads();
  }

  // epilogue: (f32(s) * q_scale) * f_scale, one rounding to bf16, 8-byte stores
#pragma unroll
  for (int run = 0; run < 2; ++run) {
    const long long r = r0 + run * 128 + lane * 4;
    if (r >= rows) continue;              // rows % 4 == 0: a run of 4 is whole
    const float4 fs = *reinterpret_cast<const float4*>(f_scale + r);
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int q = q0 + warp * 8 + a;
      if (q >= nq) continue;
      const float qs = q_scale[q];
      const float s0 = __fmul_rn(__fmul_rn(static_cast<float>(acc[a][run * 4 + 0]), qs), fs.x);
      const float s1 = __fmul_rn(__fmul_rn(static_cast<float>(acc[a][run * 4 + 1]), qs), fs.y);
      const float s2 = __fmul_rn(__fmul_rn(static_cast<float>(acc[a][run * 4 + 2]), qs), fs.z);
      const float s3 = __fmul_rn(__fmul_rn(static_cast<float>(acc[a][run * 4 + 3]), qs), fs.w);
      uint2 packed;
      packed.x = static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(s0)))
                 | (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(s1))) << 16);
      packed.y = static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(s2)))
                 | (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(s3))) << 16);
      *reinterpret_cast<uint2*>(out + static_cast<long long>(q) * rows + r) = packed;
    }
  }
}

}  // namespace

extern "C" {

// k_words: the K axis in 4-byte words (a multiple of 4); rows a multiple of
// 4; every pointer 16-byte aligned. Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a shape the kernel does not take.
int tvr_span_sim_i8(const void* q8, const void* q_scale, const void* f8,
                    const void* f_scale, int nq, long long rows, int k_words,
                    void* out, void* stream) {
  if (nq <= 0 || rows <= 0 || k_words <= 0 || k_words % 4 || rows % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_qtiles = (nq + kQueries - 1) / kQueries;
  const long long n_rtiles = (rows + kRows - 1) / kRows;
  if (n_qtiles * n_rtiles > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  span_sim_kernel<<<static_cast<unsigned>(n_qtiles * n_rtiles), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(q8), static_cast<const float*>(q_scale),
      static_cast<const uint32_t*>(f8), static_cast<const float*>(f_scale), nq, rows,
      k_words, static_cast<int>(n_qtiles), static_cast<__nv_bfloat16*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
