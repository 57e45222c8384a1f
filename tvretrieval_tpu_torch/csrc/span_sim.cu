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
// What bounds it on this card. At the full corpus (1,000 queries x 2.79M
// rows x K = 512) the work is 2.86e12 int8 operations (1.45 ms at the
// 1,979 TOPS peak) and 7.03 GB of traffic, 5.59 GB of it the bf16 output
// (2.10 ms at 3.35 TB/s): bound by bytes. The TPU kernel exists so that the
// s32 similarity never reaches device memory, and so does this one.
//
// The design: s8 tensor cores through mma.sync.m16n8k32 (tile code in
// s8_mma.cuh). A block owns a tile of 128 queries (A) and walks row tiles
// of 128 flat rows (B; one video at lp = 128) with 8 warps, 2 query groups
// of 64 (four m16 fragments) x 4 row columns of 32 (four n8 fragments).
// The K axis moves in chunks of 128 bytes (four k-steps), each chunk of a
// 128-row tile a 16 KiB XOR-swizzled shared-memory tile read with ldmatrix.
// Shared memory at K <= 512, per block:
//   queries resident   128 x 512 B                = 64 KiB
//   row ring           3 stages x 128 x 128 B     = 48 KiB
//   query scales       128 x 4 B                  = 0.5 KiB
//   total 112.5 KiB, so two blocks share an SM (2 x 113.5 <= 228 KiB with
//   the 1 KiB each reserves) and one's barriers, copies and epilogue run
//   under the other's products.
// For K > 512 the query tile does not fit twice; the query chunks then
// stream through the ring beside the row chunks (3 x 32 KiB).
// The ring is cp.async with two chunks in flight and runs on across row
// tiles: a block takes row tiles y, y + G, y + 2G, ... (G = gridDim.y,
// sized so that every block is resident at once), so the next tile's
// chunks load while this tile's products and epilogue run. The grid's
// query tiles vary fastest and the blocks of one y walk the same row tiles
// side by side, so the 1.43 GB cache is read from device memory about once
// and from L2 once per query tile.
// The epilogue is a store problem: a lane's C fragment holds two adjacent
// rows of a query per n8 fragment (4 bytes once in bf16), which stored as
// they are would be half-sector writes. A four-lane transpose (shuffles)
// gives each lane eight adjacent rows of one query instead: one 16-byte
// store a lane, 64 contiguous bytes a quad.
//
// Exactness. The s32 dot is exact in any order (|s| <= K * 127^2); the
// epilogue converts it to f32 (round to nearest), multiplies by the query
// scale and then by the row scale with two separately rounded f32
// multiplications in that association, and rounds once to bf16 (nearest
// even): bit-equal to span_sim_int8_xla, the plain version. Rows past the
// end of the cache and K past its end load as zeros (cp.async with no
// source bytes) and add nothing; queries and rows off the tile are not
// stored.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (tvretrieval_tpu_torch/ops/_build.py). C interface, loaded with
// ctypes; the entry point returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "s8_mma.cuh"

namespace {

constexpr int kThreads = 256;           // 8 warps: 2 query groups x 4 row columns
constexpr int kQueries = 128;           // the query tile (A)
constexpr int kRows = 128;              // a row tile (B)
constexpr int kChunk = 128;             // bytes of K a chunk tile holds: four k-steps
constexpr int kStages = 3;              // ring depth; two chunks in flight
constexpr int kTileBytes = kRows * kChunk;           // 16 KiB
constexpr int kMaxResidentK = 512;      // the query tile stays resident up to this K
static_assert(kQueries == kRows, "a chunk tile holds 128 query rows or 128 flat rows");

__host__ __device__ constexpr int smem_bytes(bool resident, int nkc) {
  return (resident ? nkc * kTileBytes + kStages * kTileBytes : kStages * 2 * kTileBytes)
         + kQueries * 4;
}
static_assert(2 * (smem_bytes(true, kMaxResidentK / kChunk) + 1024) <= 228 * 1024,
              "K = 512: two blocks an SM");

// K chunk `kc` of rows [base, base + 128) of `src` (n_src rows of k bytes)
// into the swizzled chunk tile at `dst`; rows past n_src and 16-byte pieces
// past the K axis (n_valid pieces) are zeros. A thread copies one piece of
// four rows 32 apart: the same swizzle in each.
__device__ __forceinline__ void load_chunk(uint32_t dst, const int8_t* __restrict__ src,
                                           long long base, long long n_src, int k, int kc,
                                           int n_valid, int tid) {
  using namespace s8mma;
  const int c = tid & 7, r0 = tid >> 3;
  const int piece = kc * (kChunk / 16) + c;
  const uint32_t d0 = dst + swizzle(r0, c, kChunk);
#pragma unroll
  for (int j = 0; j < kRows / 32; ++j) {
    const long long r = base + r0 + 32 * j;
    const bool ok = r < n_src && piece < n_valid;
    cp_async16(d0 + j * 32 * kChunk, ok ? src + r * k + piece * 16 : src, ok ? 16 : 0);
  }
}

// lane t of a quad holds w[n] = its two rows of n8 fragment n (rows 8n + 2t,
// 8n + 2t + 1); afterwards it holds w[s] = lane s's two rows of fragment t,
// i.e. rows 8t .. 8t + 7 in order. Two butterfly stages of a 4 x 4 transpose.
__device__ __forceinline__ void quad_transpose(uint32_t (&w)[4], int t) {
  const bool hi = t & 2, lo = t & 1;
#pragma unroll
  for (int k = 0; k < 2; ++k) {           // 2 x 2 blocks, with lane t ^ 2
    const uint32_t y = __shfl_xor_sync(0xffffffffu, hi ? w[k] : w[2 + k], 2);
    if (hi) w[k] = y; else w[2 + k] = y;
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {           // inside the blocks, with lane t ^ 1
    const uint32_t y = __shfl_xor_sync(0xffffffffu, lo ? w[2 * k] : w[2 * k + 1], 1);
    if (lo) w[2 * k] = y; else w[2 * k + 1] = y;
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo)))
         | (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

// q8: (nq, k) int8; f8: (rows, k) int8; q_scale: (nq); f_scale: (rows);
// out: (nq, rows) bf16. k % 16 == 0 and rows % 4 == 0 (the wrapper checks).
// Resident: the query tile stays in shared memory (k <= kMaxResidentK).
template <bool Resident>
__global__ void __launch_bounds__(kThreads, 2)
span_sim_kernel(const int8_t* __restrict__ q8, const float* __restrict__ q_scale,
                const int8_t* __restrict__ f8, const float* __restrict__ f_scale,
                int nq, long long rows, int k, int n_rtiles, __nv_bfloat16* __restrict__ out) {
  using namespace s8mma;
  constexpr int MF = 4, NF = 4;           // a warp: 64 queries x 32 rows
  extern __shared__ __align__(128) unsigned char smem[];
  const int nkc = (k + kChunk - 1) / kChunk;
  const int n_valid = k / 16;
  // Resident: [chunk][128 queries][128 B] then [stage][128 rows][128 B];
  // streamed: [stage][queries, rows][128][128 B]. Then the query scales.
  unsigned char* q_tile = smem;
  unsigned char* ring = smem + (Resident ? nkc * kTileBytes : 0);
  float* qsc = reinterpret_cast<float*>(ring + kStages * (Resident ? 1 : 2) * kTileBytes);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * kQueries;
  const int n_mine = (n_rtiles - static_cast<int>(blockIdx.y) + gridDim.y - 1) / gridDim.y;
  const int n_steps = n_mine * nkc;       // step t: row tile t / nkc, K chunk t % nkc

  if (tid < kQueries) qsc[tid] = q0 + tid < nq ? q_scale[q0 + tid] : 0.0f;
  if (Resident)
    for (int kc = 0; kc < nkc; ++kc)
      load_chunk(smem_addr(q_tile + kc * kTileBytes), q8, q0, nq, k, kc, n_valid, tid);
  auto row_base = [&](int t) {
    return (static_cast<long long>(blockIdx.y) + static_cast<long long>(t / nkc) * gridDim.y)
           * kRows;
  };
  auto load_step = [&](int t) {
    const int kc = t % nkc;
    const uint32_t stage = smem_addr(ring + (t % kStages) * (Resident ? 1 : 2) * kTileBytes);
    if (!Resident) load_chunk(stage, q8, q0, nq, k, kc, n_valid, tid);
    load_chunk(stage + (Resident ? 0 : kTileBytes), f8, row_base(t), rows, k, kc, n_valid, tid);
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) { // the first group carries the queries
    if (t < n_steps) load_step(t);
    cp_async_commit();
  }

  const bool vec16 = (rows & 7) == 0;     // query rows of out start 16-byte aligned
  int acc[MF][NF][4];
  for (int t = 0; t < n_steps; ++t) {
    cp_async_wait<kStages - 2>();         // step t has landed, for this thread
    __syncthreads();                      // ... for all; step t - 1 is done
    if (t + kStages - 1 < n_steps) load_step(t + kStages - 1);
    cp_async_commit();
    const int kc = t % nkc;
    const uint32_t stage = smem_addr(ring + (t % kStages) * (Resident ? 1 : 2) * kTileBytes);
    const uint32_t qa = Resident ? smem_addr(q_tile + kc * kTileBytes) : stage;
    const uint32_t fb = Resident ? stage : stage + kTileBytes;
    if (kc == 0) {
#pragma unroll
      for (int mi = 0; mi < MF; ++mi)
#pragma unroll
        for (int ni = 0; ni < NF; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;
    }
#pragma unroll
    for (int kk = 0; kk < kChunk / 32; ++kk) {
      uint32_t b[NF][2];
#pragma unroll
      for (int np = 0; np < NF / 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4(r, b_frag_pair_addr(fb, wn * 32 + np * 16, kk, lane, kChunk));
        b[2 * np][0] = r[0];
        b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2];
        b[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < MF; ++mi) {
        uint32_t a[4];
        ldmatrix_x4(a, a_frag_addr(qa, wm * 64 + mi * 16, kk, lane, kChunk));
#pragma unroll
        for (int ni = 0; ni < NF; ++ni) mma(acc[mi][ni], a, b[ni][0], b[ni][1]);
      }
    }
    if (kc != nkc - 1) continue;

    // epilogue of the row tile: (f32(s) * q_scale) * f_scale, one rounding
    // to bf16, a quad transpose, 16-byte stores
    const long long rw = row_base(t) + wn * 32;           // the warp's 32 rows
    float2 fs[NF];
#pragma unroll
    for (int ni = 0; ni < NF; ++ni) {
      const long long r = rw + 8 * ni + 2 * t4;           // rows % 4 == 0: r, r + 1 both in
      fs[ni] = r < rows ? *reinterpret_cast<const float2*>(f_scale + r) : make_float2(0.f, 0.f);
    }
    const long long r = rw + 8 * t4;                      // this lane's 8 rows after the transpose
#pragma unroll
    for (int mi = 0; mi < MF; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = wm * 64 + mi * 16 + g + 8 * h;
        const float qs = qsc[q];
        uint32_t w[NF];
#pragma unroll
        for (int ni = 0; ni < NF; ++ni)
          w[ni] = pack_bf16(
              __fmul_rn(__fmul_rn(static_cast<float>(acc[mi][ni][2 * h]), qs), fs[ni].x),
              __fmul_rn(__fmul_rn(static_cast<float>(acc[mi][ni][2 * h + 1]), qs), fs[ni].y));
        quad_transpose(w, t4);
        if (q0 + q >= nq || r >= rows) continue;          // r < rows: r + 4 <= rows
        __nv_bfloat16* dst = out + static_cast<long long>(q0 + q) * rows + r;
        if (vec16 && r + 8 <= rows) {
          *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
        } else {
          *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
          if (r + 8 <= rows) *reinterpret_cast<uint2*>(dst + 4) = make_uint2(w[2], w[3]);
        }
      }
  }
}

template <bool Resident>
int launch(const void* q8, const void* q_scale, const void* f8, const void* f_scale, int nq,
           long long rows, int k, void* out, cudaStream_t stream) {
  const auto kernel = span_sim_kernel<Resident>;
  const int nkc = (k + kChunk - 1) / kChunk;
  const int bytes = smem_bytes(Resident, nkc);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, n_sm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device)) !=
          cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, bytes)) !=
          cudaSuccess)
    return static_cast<int>(err);
  const long long n_qtiles = (nq + kQueries - 1) / kQueries;
  const long long n_rtiles = (rows + kRows - 1) / kRows;
  // row-tile groups: enough blocks to fill every SM once, each walking
  // n_rtiles / G row tiles
  long long groups = (static_cast<long long>(n_sm) * (per_sm > 0 ? per_sm : 1) + n_qtiles - 1)
                     / n_qtiles;
  groups = groups < 1 ? 1 : groups > n_rtiles ? n_rtiles : groups;
  if (groups > 65535) groups = 65535;
  const dim3 grid(static_cast<unsigned>(n_qtiles), static_cast<unsigned>(groups));
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const int8_t*>(q8), static_cast<const float*>(q_scale),
      static_cast<const int8_t*>(f8), static_cast<const float*>(f_scale), nq, rows, k,
      static_cast<int>(n_rtiles), static_cast<__nv_bfloat16*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// k_words: the K axis in 4-byte words (a multiple of 4); rows a multiple of
// 4; every pointer 16-byte aligned. Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a shape the kernel does not take.
int tvr_span_sim_i8(const void* q8, const void* q_scale, const void* f8,
                    const void* f_scale, int nq, long long rows, int k_words,
                    void* out, void* stream) {
  if (nq <= 0 || rows <= 0 || k_words <= 0 || k_words % 4 || rows % 4 ||
      (rows + kRows - 1) / kRows > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int k = 4 * k_words;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return k <= kMaxResidentK ? launch<true>(q8, q_scale, f8, f_scale, nq, rows, k, out, s)
                            : launch<false>(q8, q_scale, f8, f_scale, nq, rows, k, out, s);
}

}  // extern "C"
