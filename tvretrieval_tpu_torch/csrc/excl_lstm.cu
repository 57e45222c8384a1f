// ExCL's second bidirectional LSTM over [ctx1; query] for Hopper (sm_90a),
// both streams and both directions in one launch.
//
// Which TPU kernel it replaces: none. The JAX package runs every RNN as a
// lax.scan (tvretrieval_tpu/models/rnn.py), which XLA compiles; there is no
// Pallas LSTM. The port ran this stage through cuDNN (two nn.LSTM calls a
// stream over the concatenated input and its reversed copy). It was added
// because that stage held ~69% of a served MEE + ExCL call, and because
// most of cuDNN's work there is not needed: the input [ctx1; q] repeats the
// query's hidden vector q on every clip, so by linearity
//   W_ih . [ctx1; q] = W_c . ctx1 + W_q . q,
// and W_q . q + b_ih + b_hh (the wrapper's g_q, one f32 product a pair,
// ops/lstm.py) is the same at every step. cuDNN cannot take a per-sequence
// bias, so the split needs its own recurrence.
//
// What it computes, exactly RNNEncoder.forward (models/rnn.py) of each
// stream's encoder2 in eval mode at f32, outputs only: for sequence (pair
// p, stream s, direction d) with length n = len_s[p] (0 <= n <= L), steps
// t = 0 .. n - 1 read clip x(t) = t (forward) or n - 1 - t (backward,
// flax's flip_sequences order over the valid prefix), and
//   gates = ctx1[p, x(t)] . W_c^T + h . W_hh^T + g_q[p]   (i, f, g, o)
//   c = sigmoid(f) c + sigmoid(i) tanh(g),  h = sigmoid(o) tanh(c)
// with h = c = 0 before step 0; h goes to out_s[p, x(t), d*128 : d*128 +
// 128], and every position >= n of out_s[p] is zero (the steps past n in
// flax's order only touch those positions, which the mask zeroes).
//
// What bounds it on this card. A call of the benchmark cell (5,050 pairs x
// 2 streams x 2 directions = 20,200 sequences of 100 steps, K = 256 + 128,
// 512 gates) is 0.794 TFLOP of f32 products: 4.8 ms at 3xTF32's rate on the
// tensor cores (a third of 494.7 TFLOP/s, the card's fastest f32-accurate
// rate); its bytes (ctx1 read by each direction, ctx2 written: 3.1 GB) take
// 0.93 ms. So it is bound by products, and by their latency: a step needs
// the previous step's h.
//
// Design.
//  - A block of 16 warps takes 64 sequences of one (stream, direction), or
//    32 in the blocks after the last whole wave of 64-row blocks (the
//    entry point sizes them from the SM count, so the last wave holds
//    blocks of half the work instead of a partly empty wave of whole
//    ones). A step is one product of the block's [x_t | h_{t-1}] (rows x
//    384) with W^T (384 x 512) on mma.sync m16n8k8 TF32, 3xTF32
//    (csrc/s8_mma.cuh: both operands split hi + lo with rna, three products
//    lo.hi, hi.lo, hi.hi into the f32 accumulator, which keeps f32
//    accuracy), accumulated onto g_q.
//  - Warp w owns hidden units 8w .. 8w + 7: its four n-tiles are the i, f,
//    g and o columns of those units, so every lane holds all four gates of
//    its (row, unit) pairs in its accumulator; c lives in shared memory
//    (in registers it spilled at the 128 a thread that 512 threads allow).
//  - x_t and h_{t-1} sit in shared memory as TF32 halves (hi, lo), read by
//    ldmatrix with no conversion: x_{t+1} lands by cp.async while step t
//    multiplies h, and is split once in the gate phase, which also writes
//    h_t split. (Each of the 16 warps splitting the same fragments took 5%
//    more time for x and 6% more for h.) The backward direction's
//    reversed walk is only an index.
//  - W is 384 x 512 f32 (768 KiB), too large for shared memory, and each
//    warp needs only its own 64 columns: the wrapper stores W once per
//    model in the B-fragment order of mma.sync (w, k-step, lane, n-tile,
//    register), so a lane loads its fragments of a k-step as two coalesced
//    16-byte loads from L2, one k-step ahead, and splits them in
//    registers. Each block reads W once a step for all its sequences. (W
//    stored split, twice the bytes, took 12% more time.)
//  - The gates' input products never reach device memory; no concatenated
//    input, reversed copy or mask pass exists.
// Measured at the cell's call on an H100 (700 W): 13.3 ms, 36% of the
// bound; the products hold ~90% of it (the gate math the rest; W's loads
// from L2 cost nothing measurable), at ~60% of mma.sync's probed ceiling.
// Rows past the pairs and steps past a row's length run on in-bounds clips
// and are never written.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (tvretrieval_tpu_torch/ops/_build.py). C interface, loaded with
// ctypes; the entry point returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "s8_mma.cuh"

namespace {

constexpr int kH = 128;                 // hidden units a direction
constexpr int kG = 4 * kH;              // gates a direction: i, f, g, o
constexpr int kX = 2 * kH;              // ctx1 width (the first LSTM's two directions)
constexpr int kXSteps = kX / 8;         // k-steps over ctx1
constexpr int kHSteps = kH / 8;         // k-steps over h
constexpr int kKSteps = kXSteps + kHSteps;
constexpr int kRows = 64;               // sequences a whole block
constexpr int kMT = kRows / 16;         // its m-tiles
constexpr int kWarps = kH / 8;          // one warp per 8 hidden units
constexpr int kThreads = 32 * kWarps;
constexpr int kHStride = kH + 4;        // floats an h row: ldmatrix's 8 rows in 8 bank groups
constexpr int kXBuf = kRows * kX;       // an x buffer, rows of 16-byte chunks swizzled
constexpr int kHBuf = kRows * kHStride;
// x hi, x lo (where x lands), h hi, h lo, c, the rows' lengths: 231,680 bytes
constexpr size_t kSmem = static_cast<size_t>(2 * kXBuf + 2 * kHBuf + kRows * kH + kRows) * 4;

// float offset of column `col` of row `r` in an x buffer: 16-byte chunk c
// of a row at chunk c ^ (r % 8), so an ldmatrix's 8 rows fall in distinct
// bank groups
__device__ __forceinline__ int x_at(int r, int col) {
  return r * kX + (((col >> 2) ^ (r & 7)) << 2) + (col & 3);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// this lane's B fragments of one k-step (b0 / b1: n-tiles 0-1 / 2-3) as
// TF32 halves
__device__ __forceinline__ void split_b(const float4& b0, const float4& b1, uint32_t (&bh)[4][2],
                                        uint32_t (&bl)[4][2]) {
  s8mma::split_tf32(__float_as_uint(b0.x), bh[0][0], bl[0][0]);
  s8mma::split_tf32(__float_as_uint(b0.y), bh[0][1], bl[0][1]);
  s8mma::split_tf32(__float_as_uint(b0.z), bh[1][0], bl[1][0]);
  s8mma::split_tf32(__float_as_uint(b0.w), bh[1][1], bl[1][1]);
  s8mma::split_tf32(__float_as_uint(b1.x), bh[2][0], bl[2][0]);
  s8mma::split_tf32(__float_as_uint(b1.y), bh[2][1], bl[2][1]);
  s8mma::split_tf32(__float_as_uint(b1.z), bh[3][0], bl[3][0]);
  s8mma::split_tf32(__float_as_uint(b1.w), bh[3][1], bl[3][1]);
}

// acc[j] += lo.hi + hi.lo + hi.hi of one k-step for the four n-tiles
__device__ __forceinline__ void three_products(float (&acc)[4][4], const uint32_t (&ah)[4],
                                               const uint32_t (&al)[4], const uint32_t (&bh)[4][2],
                                               const uint32_t (&bl)[4][2]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    s8mma::mma_tf32(acc[j], al, bh[j][0], bh[j][1]);
    s8mma::mma_tf32(acc[j], ah, bl[j][0], bl[j][1]);
    s8mma::mma_tf32(acc[j], ah, bh[j][0], bh[j][1]);
  }
}

// acc[mt] += A . B over the k-steps of x (kIsH: of h) for the block's
// first n_mt m-tiles. A: its TF32 halves in shared memory at addresses a
// (hi) and a_lo (lo), x's rows swizzled, h's padded; B: this lane's
// fragments from `wp`, two float4 a lane a k-step, 64 float4 a k-step,
// split here. n0 / n1 hold the
// fragments of the first k-step on entry and of `after` (the next call's
// first) on exit, so the loads run a k-step ahead across calls.
template <bool kIsH>
__device__ __forceinline__ void products(float (&acc)[kMT][4][4], uint32_t a, uint32_t a_lo,
                                         const float4* __restrict__ wp,
                                         const float4* __restrict__ after, float4& n0,
                                         float4& n1, int n_mt, int lane) {
  constexpr int kSteps = kIsH ? kHSteps : kXSteps, kStride = kIsH ? kHStride : kX;
  // ldmatrix.x4: lanes 8m .. 8m + 7 address rows (m % 2) * 8 + i of the
  // m-tile at its k-step's 16-byte chunk m / 2, which gives a0 .. a3
  const int i = lane & 7, m = lane >> 3, row = (m & 1) * 8 + i;
#pragma unroll 2
  for (int s = 0; s < kSteps; ++s) {
    const float4 b0 = n0, b1 = n1;
    const float4* next = s + 1 < kSteps ? wp + (s + 1) * 64 : after;
    n0 = __ldg(next);
    n1 = __ldg(next + 1);
    uint32_t bh[4][2], bl[4][2];
    split_b(b0, b1, bh, bl);
    const uint32_t off = kIsH ? (row * kHStride + s * 8 + (m >> 1) * 4) * 4
                              : (row * kX + (((2 * s + (m >> 1)) ^ i) << 2)) * 4;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      if (mt >= n_mt) break;
      uint32_t ah[4], al[4];
      s8mma::ldmatrix_x4(ah, a + mt * 16 * kStride * 4 + off);
      s8mma::ldmatrix_x4(al, a_lo + mt * 16 * kStride * 4 + off);
      three_products(acc[mt], ah, al, bh, bl);
    }
  }
}

// ctx1_s: (P, L, 256); len_s: (P,) int32; w: (n_sd, kWarps, kKSteps, 32,
// 8) f32 in B-fragment order (ops/lstm.py::pack_weights); gq: (P,
// gq_stride) f32, (stream, direction) sd's 512 gates at sd * 512; out_s:
// (P, L, 256), written whole. Blocks: first n_sd * n_big of 64 rows (n_big
// a (stream, direction)), then n_sd * n_small of 32 rows over the rows
// past n_big * 64.
__global__ void __launch_bounds__(kThreads, 1)
excl_lstm_kernel(const float* __restrict__ ctx1_0, const float* __restrict__ ctx1_1,
                 const int* __restrict__ len_0, const int* __restrict__ len_1,
                 const float* __restrict__ w, const float* __restrict__ gq, int gq_stride,
                 float* __restrict__ out_0, float* __restrict__ out_1, int P, int L,
                 int n_sd, int n_big, int n_small) {
  extern __shared__ __align__(16) float smem[];
  float* xhi = smem;                                         // [kRows][kX] swizzled
  float* xlo = xhi + kXBuf;                                  // the same; x lands here
  float* hhi = xlo + kXBuf;                                  // [kRows][kHStride]
  float* hlo = hhi + kHBuf;                                  // the same
  float* cs = hlo + kHBuf;                                   // [kRows][kH]
  int* lens = reinterpret_cast<int*>(cs + kRows * kH);       // [kRows]
  __shared__ int s_steps;

  int b = blockIdx.x, sd, row0, rows;
  if (b < n_sd * n_big) {
    sd = b / n_big;
    row0 = (b % n_big) * kRows;
    rows = kRows;
  } else {
    b -= n_sd * n_big;
    sd = b / n_small;
    row0 = n_big * kRows + (b % n_small) * (kRows / 2);
    rows = kRows / 2;
  }
  const int n_mt = rows / 16, dir = sd & 1;
  const float* __restrict__ ctx1 = (sd >> 1) ? ctx1_1 : ctx1_0;
  const int* __restrict__ len = (sd >> 1) ? len_1 : len_0;
  float* __restrict__ out = (sd >> 1) ? out_1 : out_0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  if (tid == 0) s_steps = 0;
  for (int i = tid; i < 2 * kHBuf; i += kThreads) hhi[i] = 0.0f;   // h before step 0
  for (int i = tid; i < kRows * kH; i += kThreads) cs[i] = 0.0f;
  __syncthreads();
  if (tid < kRows) {
    const int p = row0 + tid;
    const int n = p < P && tid < rows ? min(max(len[p], 0), L) : 0;
    lens[tid] = n;
    atomicMax(&s_steps, n);
  }
  __syncthreads();
  const int steps = s_steps;

  // this lane's B fragments of k-step 0 over ctx1; those over h follow
  const float4* wx = reinterpret_cast<const float4*>(w) +
                     (static_cast<size_t>(sd * kWarps + warp) * kKSteps * 32 + lane) * 2;
  const float4* wh = wx + kXSteps * 64;

  // x_t of the block's rows into xlo (up to 8 16-byte copies a thread)
  auto load_x = [&](int t) {
#pragma unroll
    for (int k = 0; k < kRows * (kX / 4) / kThreads; ++k) {
      const int i = tid + k * kThreads, r = i / (kX / 4), c = i % (kX / 4);
      if (r < rows) {
        const int p = min(row0 + r, P - 1), n = lens[r];
        const int clip = dir == 0 ? t : (L - 1 - t + n) % L;
        cp_async16(xlo + x_at(r, c * 4),
                   ctx1 + (static_cast<size_t>(p) * L + clip) * kX + c * 4);
      }
    }
    cp_async_commit();
  };
  // the landed x in xlo as TF32 halves: hi to xhi, lo in place
  auto split_x = [&]() {
    for (int i = tid; i < rows * (kX / 4); i += kThreads) {
      const int off = x_at(i / (kX / 4), (i % (kX / 4)) * 4);
      const float4 v = *reinterpret_cast<const float4*>(xlo + off);
      uint4 hi, lo;
      s8mma::split_tf32(__float_as_uint(v.x), hi.x, lo.x);
      s8mma::split_tf32(__float_as_uint(v.y), hi.y, lo.y);
      s8mma::split_tf32(__float_as_uint(v.z), hi.z, lo.z);
      s8mma::split_tf32(__float_as_uint(v.w), hi.w, lo.w);
      *reinterpret_cast<uint4*>(xhi + off) = hi;
      *reinterpret_cast<uint4*>(xlo + off) = lo;
    }
  };

  float acc[kMT][4][4];
  // the accumulators start a step at g_q of their (row, gate)
  auto load_gq = [&]() {
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      if (mt >= n_mt) break;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = min(row0 + mt * 16 + g + 8 * half, P - 1);
        const float* src = gq + static_cast<size_t>(p) * gq_stride + sd * kG + warp * 8 + 2 * t4;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 v = __ldg(reinterpret_cast<const float2*>(src + j * kH));
          acc[mt][j][2 * half] = v.x;
          acc[mt][j][2 * half + 1] = v.y;
        }
      }
    }
  };

  load_gq();
  float4 n0 = __ldg(wx), n1 = __ldg(wx + 1);
  const uint32_t s_xhi = static_cast<uint32_t>(__cvta_generic_to_shared(xhi));
  const uint32_t s_xlo = static_cast<uint32_t>(__cvta_generic_to_shared(xlo));
  const uint32_t s_hhi = static_cast<uint32_t>(__cvta_generic_to_shared(hhi));
  const uint32_t s_hlo = static_cast<uint32_t>(__cvta_generic_to_shared(hlo));
  if (steps > 0) {
    load_x(0);
    cp_async_wait_all();
    __syncthreads();
    split_x();
  }
  for (int t = 0; t < steps; ++t) {
    __syncthreads();             // x_t's and h_{t-1}'s halves written
    products<false>(acc, s_xhi, s_xlo, wx, wh, n0, n1, n_mt, lane);
    __syncthreads();             // x_t read by every warp: x_{t+1} may land
    if (t + 1 < steps) load_x(t + 1);
    products<true>(acc, s_hhi, s_hlo, wh, wx, n0, n1, n_mt, lane);
    cp_async_wait_all();
    __syncthreads();             // x_{t+1} landed; h_{t-1} read by every warp
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      if (mt >= n_mt) break;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        // accumulator q = 2 half + e: row r, unit + e (C fragment c0 .. c3)
        const int r = mt * 16 + g + 8 * half, unit = warp * 8 + 2 * t4;
        float2 c2 = *reinterpret_cast<const float2*>(cs + r * kH + unit);
        float hv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int q = 2 * half + e;
          float& cc = e ? c2.y : c2.x;
          cc = sigmoid(acc[mt][1][q]) * cc + sigmoid(acc[mt][0][q]) * tanhf(acc[mt][2][q]);
          hv[e] = sigmoid(acc[mt][3][q]) * tanhf(cc);
        }
        *reinterpret_cast<float2*>(cs + r * kH + unit) = c2;
        uint2 hi, lo;
        s8mma::split_tf32(__float_as_uint(hv[0]), hi.x, lo.x);
        s8mma::split_tf32(__float_as_uint(hv[1]), hi.y, lo.y);
        *reinterpret_cast<uint2*>(hhi + r * kHStride + unit) = hi;
        *reinterpret_cast<uint2*>(hlo + r * kHStride + unit) = lo;
        const int p = row0 + r, n = lens[r];
        if (p < P && t < n) {
          const int pos = dir == 0 ? t : n - 1 - t;
          *reinterpret_cast<float2*>(out + (static_cast<size_t>(p) * L + pos) * kX + dir * kH +
                                     unit) = make_float2(hv[0], hv[1]);
        }
      }
    }
    if (t + 1 < steps) split_x();
    load_gq();
  }

  // positions n .. L - 1 of each row: zero
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int i = tid; i < rows * L * (kH / 4); i += kThreads) {
    const int r = i / (L * (kH / 4)), rem = i % (L * (kH / 4));
    const int pos = rem / (kH / 4), q = rem % (kH / 4);
    const int p = row0 + r;
    if (p < P && pos >= lens[r])
      *reinterpret_cast<float4*>(out + (static_cast<size_t>(p) * L + pos) * kX + dir * kH +
                                 q * 4) = zero;
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// a shape it does not take (n_pairs, n_clips >= 1, n_streams 1 or 2,
// gq_stride >= n_streams * 1024 and even).
int tvr_excl_lstm(const void* ctx1_0, const void* ctx1_1, const void* len_0, const void* len_1,
                  const void* w, const void* gq, int gq_stride, void* out_0, void* out_1,
                  int n_pairs, int n_clips, int n_streams, void* stream) {
  if (n_pairs <= 0 || n_clips <= 0 || (n_streams != 1 && n_streams != 2) ||
      gq_stride < n_streams * 2 * kG || (gq_stride & 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      excl_lstm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmem));
  int device = 0, sms = 0;
  if (err != cudaSuccess || (err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return static_cast<int>(err);
  // one block an SM: whole waves of 64-row blocks, then 32-row blocks
  const int n_sd = 2 * n_streams, per_wave = sms / n_sd;
  const int n_big = per_wave > 0 ? n_pairs / (kRows * per_wave) * per_wave : 0;
  const int n_small = (n_pairs - n_big * kRows + kRows / 2 - 1) / (kRows / 2);
  excl_lstm_kernel<<<n_sd * (n_big + n_small), kThreads, kSmem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ctx1_0), static_cast<const float*>(n_streams > 1 ? ctx1_1 : ctx1_0),
      static_cast<const int*>(len_0), static_cast<const int*>(n_streams > 1 ? len_1 : len_0),
      static_cast<const float*>(w), static_cast<const float*>(gq), gq_stride,
      static_cast<float*>(out_0), static_cast<float*>(n_streams > 1 ? out_1 : out_0), n_pairs,
      n_clips, n_sd, n_big, n_small);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
