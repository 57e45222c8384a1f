// Tensor-core ceiling probe for Hopper (sm_90a): back-to-back mma.sync
// products from registers on every SM, s8 m16n8k32 (s32 sums), bf16
// m16n8k16 or tf32 m16n8k8 (f32 sums), and back-to-back wgmma products:
// s8 m64n256k32 and bf16 m64n208k16 from shared memory, tf32 m64n104k8
// with A from registers (B2's instructions at lp = 104), with no memory
// traffic. It
// ports no TPU kernel and no engine path runs it: chip_smoke.py (phase 2)
// times it, so that the tensor-core kernels (B1 / B3-int8, B2 / B3, B5 and
// B9 / B10, all on wgmma) can be stated as a share of what wgmma and
// mma.sync reach on this card as well as of the data sheet's peak.
//
// mma.sync: each warp keeps kChains independent accumulators, so a
// product's latency hides behind the next chains' issue; operands are
// seeded from the thread index, and the sums are written out, so nothing
// folds away. wgmma: each of a block's two warpgroups issues four k-steps
// a group on one 64 x N accumulator, one group in flight behind the next,
// from a 48 KiB tile of seeded words (finite values of magnitude ~2^-8 in
// bf16 and tf32; the tf32 A fragments seeded the same way in registers).
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

// the seeded word of kind Kind (0 s8, 1 bf16, 2 tf32): bf16 pairs or tf32
// of magnitude ~2^-8 (exponent 119, tf32's low 13 bits clear), or bytes of
// any value
template <int Kind>
__device__ __forceinline__ uint32_t seeded(uint32_t h) {
  if constexpr (Kind == 1) return (h & 0x807f807fu) | 0x3b803b80u;
  if constexpr (Kind == 2) return (h & 0x807fe000u) | 0x3b800000u;
  return h;
}

// Op: the wgmma (s8wg::Wgmma, WgmmaBf16 or WgmmaTf32), Kind as seeded
template <class Op, int Kind>
__global__ void __launch_bounds__(kWgThreads, 1) wgmma_probe_kernel(int iters,
                                                                   float* __restrict__ out) {
  using namespace s8wg;
  using Acc = typename std::conditional<Kind != 0, float, int>::type;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((kGroupBytes - (smem_u32(smem_raw) & (kGroupBytes - 1)))
                                    & (kGroupBytes - 1));
  for (int i = threadIdx.x; i < kWgTile / 4; i += kWgThreads)
    reinterpret_cast<uint32_t*>(smem)[i] = seeded<Kind>((i * 2654435761u) ^ blockIdx.x);
  fence_async_smem();                   // the stores, visible to wgmma
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  const uint32_t a = smem_u32(smem) + wg * 64 * kChunk, b = smem_u32(smem) + 2 * 64 * kChunk;
  uint32_t ar[4];                       // tf32: A from registers
#pragma unroll
  for (int i = 0; i < 4; ++i) ar[i] = seeded<Kind>((threadIdx.x * 4 + i) * 2654435761u);
  Acc acc[Op::kRegs];
  for (int it = 0; it < iters; ++it) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kChunk / 32; ++kk) {
      if constexpr (Kind == 2)
        Op::mma(acc, ar, desc_sw128(b + 32 * kk), it | kk);
      else
        Op::mma(acc, desc_sw128(a + 32 * kk), desc_sw128(b + 32 * kk), it | kk);
    }
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  fence_acc(acc);
  Acc sum = 0;
#pragma unroll
  for (int i = 0; i < Op::kRegs; ++i) sum += acc[i];
  out[blockIdx.x * kWgThreads + threadIdx.x] = static_cast<float>(sum);
}

template <class Op, int Kind>
int launch_wgmma_probe(int blocks, int iters, float* out, cudaStream_t stream) {
  const auto kernel = wgmma_probe_kernel<Op, Kind>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<blocks, kWgThreads, kWgSmem, stream>>>(iters, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// kind 0: s8 m16n8k32, 1: bf16 m16n8k16, 2: tf32 m16n8k8: `blocks` blocks
// of 256 threads, each warp issuing iters x 8 products; kinds 3-5: wgmma
// s8 m64n256k32, bf16 m64n208k16, tf32 m64n104k8, `blocks` blocks of two
// warpgroups, each issuing iters x 4 products. out: blocks x 256 floats.
// Returns cudaGetLastError() after the launch.
int tvr_mma_probe(int kind, int blocks, int iters, void* out, void* stream) {
  if (blocks <= 0 || iters <= 0 || kind < 0 || kind > 5)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  switch (kind) {
    case 0:
      mma_probe_kernel<0><<<blocks, kThreads, 0, s>>>(iters, o);
      break;
    case 1:
      mma_probe_kernel<1><<<blocks, kThreads, 0, s>>>(iters, o);
      break;
    case 2:
      mma_probe_kernel<2><<<blocks, kThreads, 0, s>>>(iters, o);
      break;
    case 3:
      return launch_wgmma_probe<s8wg::Wgmma<256>, 0>(blocks, iters, o, s);
    case 4:
      return launch_wgmma_probe<s8wg::WgmmaBf16<208>, 1>(blocks, iters, o, s);
    default:
      return launch_wgmma_probe<s8wg::WgmmaTf32<104>, 2>(blocks, iters, o, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
