// ExCL's start / end span heads for Hopper (sm_90a): both streams and both
// heads of every (query, video) pair in one launch, with the mask and the
// streams' mean.
//
// Which TPU kernel it replaces: none. The JAX package's heads are nn.Dense
// layers under XLA (tvretrieval_tpu/models/excl.py); there is no Pallas
// kernel. The port ran them as PyTorch operators (models/excl.py before:
// the [ctx2; ctx1; q] concatenation, Dense_0 768 -> 256 on cuBLAS's f32
// SIMT GEMM, tanh, Dense_1 256 -> 1, mask_logits twice, a stream at a time).
// It was added because that stage held half of a served MEE + ExCL call,
// and because most of its work there is not needed: the query's hidden
// vector q repeats on every clip of a pair, so by linearity
//   W0 . [ctx2; ctx1; q] + b0 = W0_c . [ctx2; ctx1] + (W0_q . q + b0),
// and u = W0_q . q + b0 (the wrapper's, one f32 product a pair,
// ops/excl_head.py) is the same on every clip.
//
// What it computes, exactly ExCL.fused_span_logits' heads (models/excl.py)
// in eval mode at f32: for flat row r = p L + c (pair p, clip c) of each
// stream s with length n = len_s[p], and head h (0 start, 1 end),
//   H = [ctx2_s[r] | ctx1_s[r]] . W0c_{s,h}^T + u[p, s, h]   (512 -> 256)
//   x = tanh(H) . w1_{s,h} + b1_{s,h}
//   m = x if c < n else -1e10   (mask_logits: x * 1 + 0 * -1e10 = x; x * 0
//                                + 1 * -1e10 = -1e10 for finite x)
// and out_h[r] = (m_{0,h} + m_{1,h}) / 2 with two streams, m_{0,h} with
// one. Nothing but the outputs reaches device memory: no concatenation, no
// H, no tanh output.
//
// What bounds it on this card. A call of the benchmark cell (5,050 pairs x
// 100 clips = 505,000 rows a stream, 2 streams, K = 512, N = 512: st and ed
// side by side) is 5.30e11 f32 operations: 3.21 ms at 3xTF32's rate on the
// tensor cores (a third of 494.7 TFLOP/s, the card's fastest f32-accurate
// rate); its bytes (ctx2 and ctx1 of both streams, 2.07 GB) take 0.62 ms.
// So it is bound by products.
//
// Design.
//  - A persistent block a SM walks a contiguous range of 128-row tiles of
//    the flat rows. A tile takes passes (stream, head) in turn: 2 streams x
//    2 heads; a pass is one product of the tile's 128 rows x K = 512 with
//    that head's W0c^T (512 x 256), over 16 K chunks of 32 (8 from ctx2,
//    then 8 from ctx1, read from their own tensors: no concatenation).
//  - Three warpgroups: 0 and 1 consume, each 64 rows of the tile with an
//    m64n256 accumulator (128 registers a thread) on wgmma m64n256k8 tf32;
//    warpgroup 2 produces: its thread 0 keeps TMA loads of W0c's 256 x 32
//    chunks in a three-stage mbarrier ring, and its warps 1-3 round each
//    landed chunk to its TF32 high halves in place and write its low
//    halves beside it (as B2's f32 kind does with its rows).
//  - The f32 W0c is 1 MB a stream, too large to stay in shared memory, so
//    it streams from L2: 2 MB a tile over 128 rows (both streams), about
//    7.9 GB a call, under the products' time. A chunk's two halves are
//    64 KB a stage; three stages fit.
//  - A comes from device memory straight into registers, one chunk ahead
//    of its products: each thread loads 8 contiguous floats of each of its
//    two rows a chunk (two 16-byte loads a row), and the wrapper permutes
//    W0c's columns within each chunk of 32 so that those 8 floats are the
//    thread's A fragments of the chunk's four k-steps (below). So A needs
//    no shared memory, TMA or ldmatrix.
//  - 3xTF32 (s8_mma.cuh): A split in registers, W0c in the ring, three
//    products a k-step in the order lo.hi, hi.lo, hi.hi into the one f32
//    accumulator, which keeps f32 accuracy.
//  - Epilogue in registers at the end of each pass: + u, tanh, times w1,
//    each thread's 64 columns of a row summed and a quad's four lanes
//    combined by two shuffles, + b1, the mask from the pair's length; the
//    two streams' values summed per head. After the last pass each lane of
//    a quad writes one of (row, row + 8) x (st, ed).
//  - Rows past the last one load the last row and are never written.
//    Rows at or past a pair's length run the products too (no branch
//    around wgmma: ptxas would serialize every product) and write -1e10.
//  - Registers: the consumers take 232 a thread (setmaxnreg; the
//    accumulator, the A halves of a chunk in flight and the next chunk's
//    raw A), which the producer warpgroup's 40 leave exactly free.
// Measured at the cell's call on an H100 (700 W): 4.6-4.9 ms, ~66% of the
// bound (A staged through shared memory by cp.async instead of registers
// ran 3% slower).
//
// The A fragment map. wgmma m64nNk8 with A from registers takes, in lane l
// (g = l / 4, t = l % 4) of warp w, a0 = A[16w + g][t], a1 = A[16w + g +
// 8][t], a2 = A[16w + g][t + 4], a3 = A[16w + g + 8][t + 4] of the k-step's
// 8 columns (s8_wgmma.cuh). Logical column 8 kk + t + 4 e of a chunk (k-step
// kk, e 0 for a0 / a1, 1 for a2 / a3) is read from physical column 8 t + 2
// kk + e of the chunk, so lane t's columns of a chunk are 8 t .. 8 t + 7:
// float4 x0 = row cols 8t..8t+3 gives k-steps 0 and 1, x1 = 8t+4..8t+7
// k-steps 2 and 3. The wrapper stores W0c[n, 32 c + l] = W0[n, 32 c +
// perm(l)] with perm(8 kk + t + 4 e) = 8 t + 2 kk + e
// (ops/excl_head.py::CHUNK_PERM), so each product pairs the same physical
// columns of A and W0.
//
// Accuracy. The products follow the 3xTF32 argument of s8_mma.cuh: each
// term within ~3 2^-22 of its f32 product, nothing summed in reduced
// precision. The sums run in another order than cuBLAS's (K = 512 here,
// then u's 256 terms and b0 added; 768 terms and the bias there; Dense_1's
// 256 terms in another order), and tanhf is CUDA's, as torch.tanh's is.
// The tensor cores round each k-step's sum into the accumulator toward
// zero, 3 x 64 times a hidden unit, where cuBLAS's FMA rounds to nearest:
// on an H100 the logits lie within ~1.2e-6 of the same heads in f64, and
// cuBLAS's within ~1.8e-7; with inputs exact in TF32 (low halves zero) the
// kernel's lean toward zero stays (tests/test_torch_excl_head.py holds it
// within 5e-6 of f64 and 1e-5 of the plain version).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (tvretrieval_tpu_torch/ops/_build.py). C interface, loaded with
// ctypes; the entry point returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "s8_mma.cuh"
#include "s8_wgmma.cuh"

namespace {

using namespace s8wg;

constexpr int kHidden = 256;            // ctx1, ctx2 and q widths; a head's units
constexpr int kK = 2 * kHidden;         // [ctx2 | ctx1]
constexpr int kKc = kChunk / 4;         // f32 columns a chunk: 32
constexpr int kChunks = kK / kKc;       // 16: 8 of ctx2, then 8 of ctx1
constexpr int kTileRows = 128;          // a tile: 64 rows a consumer warpgroup
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 128;
constexpr int kSplitThreads = 96;       // warps 1-3 of the producer warpgroup
constexpr int kHalf = kHidden * kChunk;  // 32 KiB: 256 rows of W0c x 128 bytes
constexpr int kStage = 2 * kHalf;       // TF32 high halves, then low halves
constexpr int kStages = 3;
constexpr int kBarBytes = 3 * kStages * 8;  // full, ready, empty
constexpr int kSmem = kGroupBytes + kStages * kStage + kBarBytes;
static_assert(kSmem <= kMaxSmem, "three stages fit");
constexpr float kMasked = -1e10f;       // mask_logits' fill

using Mma = WgmmaTf32<kHidden>;

// w: (n_streams * 512, 512) f32, row (s, h, unit) = s * 512 + h * 256 +
// unit, columns permuted within each chunk (map_w: boxes of 256 rows x 32
// columns); ctx2_s, ctx1_s: (n_rows, 256) f32, n_rows = P L; len_s: (P,)
// int32; u: (P, u_stride) f32, (s, h) at s * 512 + h * 256; w1: (n_streams
// * 2, 256), b1: (n_streams * 2); out_st, out_ed: (n_rows,) f32.
__global__ void __launch_bounds__(kThreads, 1)
excl_head_kernel(const __grid_constant__ CUtensorMap map_w, const float* __restrict__ ctx2_0,
                 const float* __restrict__ ctx1_0, const float* __restrict__ ctx2_1,
                 const float* __restrict__ ctx1_1, const int* __restrict__ len_0,
                 const int* __restrict__ len_1, const float* __restrict__ u, int u_stride,
                 const float* __restrict__ w1, const float* __restrict__ b1,
                 float* __restrict__ out_st, float* __restrict__ out_ed, int n_rows, int L,
                 int n_streams, int n_tiles) {
  extern __shared__ unsigned char smem_raw[];
  // every stage on a 1,024-byte boundary: the swizzle's period
  unsigned char* ring = smem_raw + ((kGroupBytes - (smem_u32(smem_raw) & (kGroupBytes - 1)))
                                    & (kGroupBytes - 1));
  const uint32_t full0 = smem_u32(ring + kStages * kStage);
  const uint32_t ready0 = full0 + 8 * kStages, empty0 = ready0 + 8 * kStages;
  const int tid = threadIdx.x;
  const int passes = 2 * n_streams;
  int first, count;
  tile_range(n_tiles, gridDim.x, blockIdx.x, first, count);
  const int n_steps = count * passes * kChunks;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(ready0 + 8 * s, kSplitThreads);
      mbar_init(empty0 + 8 * s, kConsumers);
    }
    fence_mbar_init();
  }
  __syncthreads();

  int stage = 0;
  uint32_t phase = 0;
  auto advance = [&]() {
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  };

  if (tid >= kConsumers) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<40>();
    const int p = tid - kConsumers;
    if (p == 0) {
      prefetch_map(&map_w);
      // step i: pass (i / kChunks) % passes, chunk i % kChunks; W0c's rows
      // of pass (s, h) start at (2 s + h) * 256
      for (int i = 0; i < n_steps; ++i) {
        mbar_wait(empty0 + 8 * stage, phase ^ 1);
        const uint32_t full = full0 + 8 * stage;
        mbar_expect_tx(full, kHalf);
        tma_load(smem_u32(ring + stage * kStage), &map_w, full, (i % kChunks) * kKc,
                 ((i / kChunks) % passes) * kHidden);
        advance();
      }
    } else if (p >= 32) {
      // warps 1-3: each landed chunk becomes its TF32 high halves in place
      // and its low halves beside them (the same swizzled offsets), visible
      // to wgmma before the stage is handed on
      for (int i = 0; i < n_steps; ++i) {
        mbar_wait(full0 + 8 * stage, phase);
        uint4* hi = reinterpret_cast<uint4*>(ring + stage * kStage);
        uint4* lo = hi + kHalf / 16;
        for (int j = p - 32; j < kHalf / 16; j += kSplitThreads) {
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
        advance();
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  setmaxnreg_inc<232>();
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row_in_tile = 64 * wg + 16 * warp + g;     // this thread's rows: it and + 8

  // this thread's 8 columns of rows (r, r + 8) of step i's chunk: x[0], x[1]
  // of row r, x[2], x[3] of row r + 8 (the last row past the end)
  float4 x[4];
  auto load_a = [&](int i) {
    const int kc = i % kChunks, s = (i / kChunks) % passes >> 1;
    const int r = (first + i / (kChunks * passes)) * kTileRows + row_in_tile;
    const float* src = kc < kChunks / 2 ? (s ? ctx2_1 : ctx2_0) : (s ? ctx1_1 : ctx1_0);
    const int col = (kc % (kChunks / 2)) * kKc + 8 * t;
    const float4* pa = reinterpret_cast<const float4*>(
        src + static_cast<size_t>(min(r, n_rows - 1)) * kHidden + col);
    const float4* pb = reinterpret_cast<const float4*>(
        src + static_cast<size_t>(min(r + 8, n_rows - 1)) * kHidden + col);
    x[0] = __ldg(pa);
    x[1] = __ldg(pa + 1);
    x[2] = __ldg(pb);
    x[3] = __ldg(pb + 1);
  };

  float acc[Mma::kRegs];
  float st[2] = {0.0f, 0.0f}, ed[2] = {0.0f, 0.0f};      // rows r, r + 8: the streams' sum
  int prev = 0;
  if (n_steps > 0) load_a(0);
  for (int i = 0; i < n_steps; ++i) {
    const int kc = i % kChunks;
    const uint32_t b = smem_u32(ring + stage * kStage), b_lo = b + kHalf;
    mbar_wait(ready0 + 8 * stage, phase);
    // the previous chunk's products read the A registers: done before they
    // are written again; that stage is handed back then
    if (kc > 0) {
      wgmma_wait<0>();
      mbar_arrive(empty0 + 8 * prev);
    }
    // A fragments of k-step kk: (row r, r + 8) at logical columns t, t + 4
    const float a_raw[4][4] = {{x[0].x, x[2].x, x[0].y, x[2].y},
                               {x[0].z, x[2].z, x[0].w, x[2].w},
                               {x[1].x, x[3].x, x[1].y, x[3].y},
                               {x[1].z, x[3].z, x[1].w, x[3].w}};
    uint32_t hi[4][4], lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) s8mma::split_tf32(__float_as_uint(a_raw[kk][j]), hi[kk][j], lo[kk][j]);
    wgmma_fence();
    // lo.hi, hi.lo, then hi.hi: the small products first
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      Mma::mma(acc, lo[kk], desc_sw128(b + 32 * kk), (kc | kk) != 0);
      Mma::mma(acc, hi[kk], desc_sw128(b_lo + 32 * kk), 1);
      Mma::mma(acc, hi[kk], desc_sw128(b + 32 * kk), 1);
    }
    wgmma_commit();
    if (i + 1 < n_steps) load_a(i + 1);
    prev = stage;
    advance();
    if (kc != kChunks - 1) continue;

    // ------------------------------------------------ the pass's epilogue
    wgmma_wait<0>();
    fence_acc(acc);
    mbar_arrive(empty0 + 8 * prev);
    const int pass = (i / kChunks) % passes, s = pass >> 1, h = pass & 1;
    const int r = (first + i / (kChunks * passes)) * kTileRows + row_in_tile;
    const int* __restrict__ len = s ? len_1 : len_0;
    const float* __restrict__ w1p = w1 + pass * kHidden + 2 * t;
    float sum[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      // accumulator 4 j + 2 half + e: row r + 8 half, column 8 j + 2 t + e
      const int pair = min(r + 8 * half, n_rows - 1) / L;
      const float* __restrict__ up = u + static_cast<size_t>(pair) * u_stride +
                                     pass * kHidden + 2 * t;
      float v = 0.0f;
#pragma unroll
      for (int j = 0; j < kHidden / 8; ++j) {
        const float2 w = __ldg(reinterpret_cast<const float2*>(w1p + 8 * j));
        const float2 uu = __ldg(reinterpret_cast<const float2*>(up + 8 * j));
        v = fmaf(w.x, tanhf(acc[4 * j + 2 * half] + uu.x), v);
        v = fmaf(w.y, tanhf(acc[4 * j + 2 * half + 1] + uu.y), v);
      }
      sum[half] = v;
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float v = sum[half];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      const int row = r + 8 * half;
      const int pair = min(row, n_rows - 1) / L;
      const bool valid = row < n_rows && row - pair * L < __ldg(len + pair);
      const float m = valid ? v + __ldg(b1 + pass) : kMasked;
      if (h == 0)
        st[half] += m;
      else
        ed[half] += m;
    }
    if (pass != passes - 1) continue;
    // lane t of the quad writes (row r + 8 (t / 2), st if t is even else ed)
    const int row = r + 8 * (t >> 1);
    const float mine = t == 0 ? st[0] : t == 1 ? ed[0] : t == 2 ? st[1] : ed[1];
    if (row < n_rows) ((t & 1) ? out_ed : out_st)[row] = mine / static_cast<float>(n_streams);
    st[0] = st[1] = ed[0] = ed[1] = 0.0f;
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// a shape it does not take (n_pairs, n_clips >= 1, n_pairs * n_clips below
// 2^30, n_streams 1 or 2, u_stride >= n_streams * 512 and even).
int tvr_excl_heads(const void* ctx2_0, const void* ctx1_0, const void* len_0, const void* ctx2_1,
                   const void* ctx1_1, const void* len_1, const void* w, const void* u,
                   int u_stride, const void* w1, const void* b1, void* out_st, void* out_ed,
                   int n_pairs, int n_clips, int n_streams, void* stream) {
  if (n_pairs <= 0 || n_clips <= 0 || (n_streams != 1 && n_streams != 2) ||
      static_cast<long long>(n_pairs) * n_clips >= (1LL << 30) ||
      u_stride < n_streams * kK || (u_stride & 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_rows = n_pairs * n_clips;
  CUtensorMap map_w;
  int err = encode_rows(&map_w, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, w, kK,
                        static_cast<uint64_t>(n_streams) * kK, kHidden);
  if (err) return err;
  cudaError_t e =
      cudaFuncSetAttribute(excl_head_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  int device = 0, sms = 0;
  if (e != cudaSuccess || (e = cudaGetDevice(&device)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return static_cast<int>(e);
  const int n_tiles = (n_rows + kTileRows - 1) / kTileRows;
  const int blocks = n_tiles < sms ? n_tiles : sms;
  const bool two = n_streams > 1;
  excl_head_kernel<<<blocks, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      map_w, static_cast<const float*>(ctx2_0), static_cast<const float*>(ctx1_0),
      static_cast<const float*>(two ? ctx2_1 : ctx2_0), static_cast<const float*>(two ? ctx1_1 : ctx1_0),
      static_cast<const int*>(len_0), static_cast<const int*>(two ? len_1 : len_0),
      static_cast<const float*>(u), u_stride, static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<float*>(out_st), static_cast<float*>(out_ed),
      n_rows, n_clips, n_streams, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
