// Tensor-core ceiling probe for Hopper (sm_90a): back-to-back mma.sync
// products from registers on every SM, s8 m16n8k32 (s32 sums), bf16
// m16n8k16 or tf32 m16n8k8 (f32 sums), and back-to-back s8 wgmma
// m64n256k32 from shared memory, with no memory traffic. It ports no TPU
// kernel and no engine path runs it: chip_smoke.py (phase 2) times it, so
// that the tensor-core kernels (B1 / B3-int8 and B5 on wgmma; B2 / B3,
// B9 / B10 on mma.sync) can be stated as a share of what their instruction
// reaches on this card as well as of the data sheet's peak.
//
// mma.sync: each warp keeps kChains independent accumulators, so a
// product's latency hides behind the next chains' issue; operands are
// seeded from the thread index, and the sums are written out, so nothing
// folds away. wgmma: each of a block's two warpgroups issues four k-steps
// a group on one 64 x 256 accumulator, one group in flight behind the
// next, from a 48 KiB tile of seeded bytes.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (tvretrieval_tpu_torch/ops/_build.py). C interface, loaded with
// ctypes; the entry point returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "s8_mma.cuh"
#include "s8_wgmma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChains = 8;

// Kind 0: s8, 1: bf16, 2: tf32.
template <int Kind>
__global__ void __launch_bounds__(kThreads) mma_probe_kernel(int iters, float* __restrict__ out) {
  using Acc = typename std::conditional<Kind != 0, float, int>::type;
  const uint32_t seed = (blockIdx.x * kThreads + threadIdx.x) * 2654435761u;
  uint32_t a[4];
  // bf16 pairs of magnitude ~2^-8 (exponent 119), tf32 of magnitude ~2^-8
  // (exponent 119, the low 13 bits clear), or bytes of any value
  const uint32_t mask = Kind == 1 ? 0x807f807fu : Kind == 2 ? 0x807fe000u : 0xffffffffu;
  const uint32_t base = Kind == 1 ? 0x3b803b80u : Kind == 2 ? 0x3b800000u : 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = ((seed >> i) & mask) | base;
  const uint32_t b0 = ((seed >> 5) & mask) | base, b1 = ((seed >> 7) & mask) | base;
  Acc c[kChains][4];
#pragma unroll
  for (int j = 0; j < kChains; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = Acc(0);
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int j = 0; j < kChains; ++j) {
      if constexpr (Kind == 2)
        s8mma::mma_tf32(c[j], a, b0, b1);
      else if constexpr (Kind == 1)
        s8mma::mma_bf16(c[j], a, b0, b1);
      else
        s8mma::mma(c[j], a, b0, b1);
    }
  float sum = 0.0f;
#pragma unroll
  for (int j = 0; j < kChains; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sum += static_cast<float>(c[j][e]);
  out[blockIdx.x * kThreads + threadIdx.x] = sum;
}

constexpr int kWgThreads = 256;         // two warpgroups
constexpr int kWgTile = 48 * 1024;      // A: 2 x 64 rows, B: 256 rows, of 128 bytes
constexpr int kWgSmem = kWgTile + s8wg::kGroupBytes;

__global__ void __launch_bounds__(kWgThreads, 1) wgmma_probe_kernel(int iters,
                                                                   float* __restrict__ out) {
  using namespace s8wg;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((kGroupBytes - (smem_u32(smem_raw) & (kGroupBytes - 1)))
                                    & (kGroupBytes - 1));
  for (int i = threadIdx.x; i < kWgTile / 4; i += kWgThreads)
    reinterpret_cast<uint32_t*>(smem)[i] = (i * 2654435761u) ^ blockIdx.x;
  fence_async_smem();                   // the stores, visible to wgmma
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  const uint32_t a = smem_u32(smem) + wg * 64 * kChunk, b = smem_u32(smem) + 2 * 64 * kChunk;
  int acc[Wgmma<256>::kRegs];
  for (int it = 0; it < iters; ++it) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kChunk / 32; ++kk)
      Wgmma<256>::mma(acc, desc_sw128(a + 32 * kk), desc_sw128(b + 32 * kk), it | kk);
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  fence_acc(acc);
  int sum = 0;
#pragma unroll
  for (int i = 0; i < Wgmma<256>::kRegs; ++i) sum += acc[i];
  out[blockIdx.x * kWgThreads + threadIdx.x] = static_cast<float>(sum);
}

}  // namespace

extern "C" {

// kind 0: s8 m16n8k32, 1: bf16 m16n8k16, 2: tf32 m16n8k8: `blocks` blocks
// of 256 threads, each warp issuing iters x 8 products; kind 3: s8 wgmma
// m64n256k32, `blocks` blocks of two warpgroups, each issuing iters x 4
// products. out: blocks x 256 floats. Returns cudaGetLastError() after the
// launch.
int tvr_mma_probe(int kind, int blocks, int iters, void* out, void* stream) {
  if (blocks <= 0 || iters <= 0 || kind < 0 || kind > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (kind == 3) {
    const cudaError_t e = cudaFuncSetAttribute(
        wgmma_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    wgmma_probe_kernel<<<blocks, kWgThreads, kWgSmem, s>>>(iters, o);
  } else if (kind == 0)
    mma_probe_kernel<0><<<blocks, kThreads, 0, s>>>(iters, o);
  else if (kind == 1)
    mma_probe_kernel<1><<<blocks, kThreads, 0, s>>>(iters, o);
  else
    mma_probe_kernel<2><<<blocks, kThreads, 0, s>>>(iters, o);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
