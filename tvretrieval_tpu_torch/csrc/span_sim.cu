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
// (2.10 ms at 3.35 TB/s): bound by bytes. The engines build the cache at
// flat_lp(L) rows a video (104 at L = 100, 2.27M rows: 5.71 GB, 4.54 GB
// of it output, 1.70 ms), so that 3.9% of the rows are pad, not 21.9%:
// every row, pad or not, is loaded, multiplied, rescaled and stored. The
// TPU kernel exists so that the s32 similarity never reaches device
// memory, and so does this one. So the design keeps device memory writing
// without a break, and the products and the epilogue out of its way.
//
// The design (shared pieces in s8_wgmma.cuh). A persistent block of three
// warpgroups owns 128 queries and walks a contiguous range of row tiles of
// 256 flat rows (two videos at lp = 128; at lp = 104 a tile cuts videos,
// which costs nothing, every row having its own scale: tiles of two whole
// videos, N = 208, measured the same, 2.386 ms against 2.380 at the full
// corpus). Warpgroup 2 is the producer: one thread keeps TMA loads of
// 128-byte K chunks of the row tiles in an mbarrier ring (the query tile,
// K <= 512, loads once and stays resident; past that its chunks ride in
// the ring beside the rows'). Warpgroups 0 and 1 each own 64 queries and
// multiply with wgmma m64n256k32 (s8 x s8 -> s32, both operands from
// shared memory): four k-steps a chunk, a stage handed back as soon as the
// products of the next chunk are in flight. Both
// issue their products even where their 64 queries lie past nq (TMA's zero
// rows): a branch around wgmma makes ptxas serialize every product (its
// C7518 warning), which cost 10-24% of the kernel's time on the H100.
// The tile's 256 row scales load into registers under its products, eight
// a lane (lane 4 b + c the pairs of columns 8 j + 2 c, j = b mod 8), and
// reach the lanes that need them by shuffles: loaded in the epilogue, 32
// loads a thread took 2.3 times as long. The epilogue converts the
// 128 s32 sums a thread holds, rescales them, rounds
// to bf16 and writes them into a 128-byte-swizzled staging tile (64
// queries x 256 rows, four boxes of 64 columns; a warp's writes fall in
// eight different bank groups); one thread then issues four TMA stores of
// the tile and goes on to the next row tile, whose loads the producer has
// already issued. Before the staging tile is rewritten a tile later, that
// thread waits for the stores to have read it (cp.async.bulk.wait_group
// .read), so each tile's store overlaps the next tile's loads and
// products. The blocks that share a range (one per query tile) run side
// by side, so the cache is read from device memory about once and from L2
// once per query tile. Shared memory at K <= 512: queries 64 KiB, the ring
// 3 x 32 KiB, staging 64 KiB (one block an SM). Output rows whose stride is
// not a multiple of 16 bytes (rows % 8 != 0), which a TMA store cannot
// address, leave the staging tile by 8-byte stores instead.
//
// Where its time goes (H100 80GB HBM3, 700 W, 2.89 ms at the full corpus
// at lp = 128, 2.38-2.45 ms at lp = 104): the products alone (no
// epilogue, no store) take 1.56 ms, the loads, epilogue and stores without
// the products 2.80 ms (at lp = 104, with N = 208 tiles: 1.32 and 2.31),
// so the epilogue and store path bounds it at 1.9-2.0 TB/s of output.
// Two variants measured no faster: consumers taking 128-query x 128-row
// tiles in turn, one's epilogue under the other's products (ping-pong,
// 2.83-2.95 ms), and a strided walk, the groups' tiles adjacent at any
// moment (2.95-2.98 ms).
//
// Exactness. The s32 dot is exact in any order (|s| <= K * 127^2); the
// epilogue converts it to f32 (round to nearest), multiplies by the query
// scale and then by the row scale with two separately rounded f32
// multiplications in that association, and rounds once to bf16 (nearest
// even): bit-equal to span_sim_int8_xla, the plain version. Rows past the
// end of the cache, queries past nq and K past its end load as zeros
// (TMA's out-of-bounds fill) and add nothing; queries and rows off the
// tensor are not stored.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (tvretrieval_tpu_torch/ops/_build.py). C interface, loaded with
// ctypes; the entry point returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "s8_wgmma.cuh"

namespace {

using namespace s8wg;

constexpr int kThreads = 384;           // consumer warpgroups 0, 1; the producer's 2
constexpr int kQueries = 128;           // the query tile (A): 64 a consumer warpgroup
constexpr int kRows = 256;              // a row tile (B): the wgmma N
constexpr int kQChunk = kQueries * kChunk;          // 16 KiB: a K chunk of the query tile
constexpr int kRChunk = kRows * kChunk;             // 32 KiB: a K chunk of a row tile
constexpr int kBoxCols = kChunk / 2;                // bf16 columns of an output box
constexpr int kStaged = 64 * kRows * 2;             // 32 KiB: a warpgroup's staged output
constexpr int kMaxStages = 8;
constexpr int kBarBytes = 3 * kMaxStages * 8;       // full, empty, the query tile's
constexpr int kMaxResidentK = 512;      // the query tile stays resident up to this K

__host__ __device__ constexpr int stage_bytes(bool resident) {
  return kRChunk + (resident ? 0 : kQChunk);
}
__host__ __device__ constexpr int query_bytes(bool resident, int nkc) {
  return resident ? nkc * kQChunk : 0;
}
// ring stages that fit beside the queries, the staging tiles and the
// barriers (and the 1 KiB the alignment may take)
__host__ __device__ constexpr int n_stages(bool resident, int nkc) {
  return (kMaxSmem - kGroupBytes - kBarBytes - query_bytes(resident, nkc) - 2 * kStaged) /
         stage_bytes(resident);
}
__host__ __device__ constexpr int smem_bytes(bool resident, int nkc, int stages) {
  return kGroupBytes + query_bytes(resident, nkc) + stages * stage_bytes(resident) +
         2 * kStaged + kBarBytes;
}
static_assert(n_stages(true, kMaxResidentK / kChunk) >= 3, "K = 512: three stages");
static_assert(n_stages(false, 1) >= 3, "streamed queries: three stages");

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo)))
         | (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

__device__ __forceinline__ float rescale(int s, float qs, float fs) {
  return __fmul_rn(__fmul_rn(static_cast<float>(s), qs), fs);
}

// q8: (nq, k) int8 (map_q: boxes of 128 queries x 128 bytes); f8: (rows, k)
// (map_f: 256 rows x 128 bytes); out: (nq, rows) bf16 (map_o: boxes of 64
// queries x 64 columns, used when rows % 8 == 0). k % 16 == 0, rows % 4 ==
// 0 (the wrapper checks). Block (x, y): query tile x, the y-th of gridDim.y
// contiguous ranges of row tiles.
template <bool Resident>
__global__ void __launch_bounds__(kThreads, 1)
span_sim_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_f,
                      const __grid_constant__ CUtensorMap map_o,
                      const float* __restrict__ q_scale, const float* __restrict__ f_scale,
                      __nv_bfloat16* __restrict__ out, int nq, long long rows, int k,
                      int n_rtiles, int stages) {
  extern __shared__ unsigned char smem_raw[];
  // every tile on a 1,024-byte boundary: the swizzle's period
  unsigned char* smem = smem_raw + ((kGroupBytes - (smem_u32(smem_raw) & (kGroupBytes - 1)))
                                    & (kGroupBytes - 1));
  const int nkc = (k + kChunk - 1) / kChunk;
  constexpr int kStage = stage_bytes(Resident);
  unsigned char* ring = smem + query_bytes(Resident, nkc);
  unsigned char* staged = ring + stages * kStage;
  const uint32_t full0 = smem_u32(staged + 2 * kStaged);
  const uint32_t empty0 = full0 + 8 * kMaxStages, q_full = empty0 + 8 * kMaxStages;
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kQueries;
  int first, count;
  tile_range(n_rtiles, gridDim.y, blockIdx.y, first, count);

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2 * 128);         // every consumer thread
    }
    mbar_init(q_full, 1);
    fence_mbar_init();
  }
  __syncthreads();

  if (tid >= 256) {
    // ---------------------------------------------------------- producer
    setmaxnreg_dec<40>();
    if (tid == 256) {
      prefetch_map(&map_q);
      prefetch_map(&map_f);
      if (Resident) {
        mbar_expect_tx(q_full, nkc * kQChunk);
        for (int kc = 0; kc < nkc; ++kc)
          tma_load(smem_u32(smem + kc * kQChunk), &map_q, q_full, kc * kChunk, q0);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int t = 0; t < count; ++t) {
        const int r0 = (first + t) * kRows;
        for (int kc = 0; kc < nkc; ++kc) {
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          const uint32_t full = full0 + 8 * stage;
          const uint32_t st = smem_u32(ring + stage * kStage);
          mbar_expect_tx(full, kStage);
          tma_load(st, &map_f, full, kc * kChunk, r0);
          if (!Resident) tma_load(st + kRChunk, &map_q, full, kc * kChunk, q0);
          if (++stage == stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    setmaxnreg_inc<232>();
    const int wg = tid >> 7, t = tid & 127, lane = t & 31;
    const int ra = 16 * (t >> 5) + (lane >> 2);   // this thread's tile rows: ra, ra + 8
    const int qa = q0 + 64 * wg + ra, qb = qa + 8;
    const float qs_a = qa < nq ? q_scale[qa] : 0.0f, qs_b = qb < nq ? q_scale[qb] : 0.0f;
    const bool tma_out = (rows & 7) == 0;
    unsigned char* mine = staged + wg * kStaged;
    const uint32_t a_off = wg * 64 * kChunk;        // the warpgroup's 64 query rows
    if (Resident) mbar_wait(q_full, 0);
    int stage = 0;
    uint32_t phase = 0;
    int acc[Wgmma<kRows>::kRegs];
    for (int tt = 0; tt < count; ++tt) {
      const long long r0 = static_cast<long long>(first + tt) * kRows;
      // the tile's 256 row scales, loaded under its products: lane 4 b + c
      // holds the pair of columns 8 j + 2 c for j = b, b + 8, b + 16, b + 24
      // (rows % 4 == 0: both or neither past the end)
      float2 fs_held[kRows / 64];
#pragma unroll
      for (int i = 0; i < kRows / 64; ++i) {
        const long long c = r0 + 8 * ((lane >> 2) + 8 * i) + 2 * (lane & 3);
        fs_held[i] = c < rows ? *reinterpret_cast<const float2*>(f_scale + c)
                              : make_float2(0.0f, 0.0f);
      }
      int prev = 0;
      for (int kc = 0; kc < nkc; ++kc) {
        mbar_wait(full0 + 8 * stage, phase);
        unsigned char* st = ring + stage * kStage;
        const uint32_t a = smem_u32(Resident ? smem + kc * kQChunk : st + kRChunk) + a_off;
        const uint32_t b = smem_u32(st);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kChunk / 32; ++kk)
          Wgmma<kRows>::mma(acc, desc_sw128(a + 32 * kk), desc_sw128(b + 32 * kk),
                            (kc | kk) != 0);
        wgmma_commit();
        if (kc > 0) {
          wgmma_wait<1>();                           // the previous chunk's products are done
          mbar_arrive(empty0 + 8 * prev);
        }
        prev = stage;
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      mbar_arrive(empty0 + 8 * prev);

      // epilogue: (f32(s) * q_scale) * f_scale, one rounding to bf16, into
      // the swizzled staging tile; four TMA stores
      if (t == 0 && tma_out) tma_store_wait_read();  // the last tile's stores have read it
      bar_sync(1 + wg, 128);
#pragma unroll
      for (int j = 0; j < kRows / 8; ++j) {
        const int held = 4 * (j & 7) + (lane & 3);          // the lane holding j's pair
        const float2 fs = make_float2(__shfl_sync(0xffffffffu, fs_held[j >> 3].x, held),
                                      __shfl_sync(0xffffffffu, fs_held[j >> 3].y, held));
        // box j / 8, 16-byte chunk j % 8 of tile rows ra and ra + 8 (one swizzle)
        unsigned char* box = mine + (j >> 3) * (64 * kChunk);
        const int sw = ((j & 7) ^ (ra & 7)) * 16 + 4 * (lane & 3);
        *reinterpret_cast<uint32_t*>(box + ra * kChunk + sw) =
            pack_bf16(rescale(acc[4 * j], qs_a, fs.x), rescale(acc[4 * j + 1], qs_a, fs.y));
        *reinterpret_cast<uint32_t*>(box + (ra + 8) * kChunk + sw) =
            pack_bf16(rescale(acc[4 * j + 2], qs_b, fs.x), rescale(acc[4 * j + 3], qs_b, fs.y));
      }
      if (tma_out) fence_async_smem();
      bar_sync(1 + wg, 128);
      if (tma_out) {
        if (t == 0) {
          for (int bx = 0; bx < kRows / kBoxCols; ++bx)
            tma_store(&map_o, smem_u32(mine + bx * 64 * kChunk),
                      static_cast<int>(r0) + bx * kBoxCols, q0 + 64 * wg);
          tma_store_commit();
        }
      } else {
        // 64 queries x 64 pieces of four bf16 (8 bytes: rows % 4 == 0)
        for (int i = t; i < 64 * (kRows / 4); i += 128) {
          const int r = i / (kRows / 4), p = i % (kRows / 4), j = p >> 1;
          const long long c = r0 + 4 * p;
          const int q = q0 + 64 * wg + r;
          if (q >= nq || c >= rows) continue;
          const unsigned char* src = mine + (j >> 3) * (64 * kChunk) + r * kChunk
                                     + ((j & 7) ^ (r & 7)) * 16 + (p & 1) * 8;
          *reinterpret_cast<uint2*>(out + static_cast<long long>(q) * rows + c) =
              *reinterpret_cast<const uint2*>(src);
        }
      }
    }
    if (t == 0 && tma_out) tma_store_wait_all();
  }
}

template <bool Resident>
int launch(const void* q8, const void* q_scale, const void* f8, const void* f_scale, int nq,
           long long rows, int k, void* out, cudaStream_t stream) {
  const auto kernel = span_sim_wgmma_kernel<Resident>;
  const int nkc = (k + kChunk - 1) / kChunk;
  const int stages = n_stages(Resident, nkc) < kMaxStages ? n_stages(Resident, nkc) : kMaxStages;
  const int bytes = smem_bytes(Resident, nkc, stages);
  CUtensorMap map_q, map_f, map_o;
  memset(&map_o, 0, sizeof(map_o));
  int err;
  if ((err = encode_s8_rows(&map_q, q8, k, nq, kQueries)) ||
      (err = encode_s8_rows(&map_f, f8, k, rows, kRows)) ||
      ((rows & 7) == 0 && (err = encode_2d(&map_o, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, out,
                                            rows, nq, kBoxCols, 64))))
    return err;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  int device = 0, n_sm = 0;
  if ((e = cudaGetDevice(&device)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return static_cast<int>(e);
  const int n_qtiles = (nq + kQueries - 1) / kQueries;
  const int n_rtiles = static_cast<int>((rows + kRows - 1) / kRows);
  // one block an SM: the query tiles of one range side by side
  int groups = n_sm / n_qtiles;
  groups = groups < 1 ? 1 : groups > n_rtiles ? n_rtiles : groups;
  const dim3 grid(static_cast<unsigned>(n_qtiles), static_cast<unsigned>(groups));
  kernel<<<grid, kThreads, bytes, stream>>>(
      map_q, map_f, map_o, static_cast<const float*>(q_scale), static_cast<const float*>(f_scale),
      static_cast<__nv_bfloat16*>(out), nq, rows, k, n_rtiles, stages);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// k_words: the K axis in 4-byte words (a multiple of 4); rows a multiple of
// 4 and below 2^31 (TMA coordinates are 32-bit); every pointer 16-byte
// aligned. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a shape the kernel does not take.
int tvr_span_sim_i8(const void* q8, const void* q_scale, const void* f8,
                    const void* f_scale, int nq, long long rows, int k_words,
                    void* out, void* stream) {
  if (nq <= 0 || rows <= 0 || k_words <= 0 || k_words % 4 || rows % 4 ||
      rows + kRows > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int k = 4 * k_words;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return k <= kMaxResidentK ? launch<true>(q8, q_scale, f8, f_scale, nq, rows, k, out, s)
                            : launch<false>(q8, q_scale, f8, f_scale, nq, rows, k, out, s);
}

}  // extern "C"
