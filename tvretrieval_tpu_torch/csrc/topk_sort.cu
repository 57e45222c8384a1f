// Exact stable top-k of every row for Hopper (sm_90a): the port of
// tvretrieval_tpu/ops/pallas_sort.py::topk_transposed (_make_kernel,
// _stage, _compound_gt, :56-216), kernel B6.
//
// What it computes. x is (nq, n) f32. For every row the k best elements
// under the compound order of _compound_gt, value descending and then
// index ascending: (v, i) comes before (pv, pi) iff v > pv, or v == pv and
// i < pi. That is a stable descending sort's order (0.0 and -0.0 tie).
// Values come back as f32 (the row's own bits), indices as int32 clamped
// to n - 1.
//
// What bounds it on this card, and the design. The rows are short (the
// engine's are 1,250 to 2,800 long, k = 100 or 200), so the bytes are few
// (11 MB for 1,000 rows of 2,800: 3.3 us at 3.35 TB/s) and the time goes to
// on-chip passes. Sorting the whole row, as the TPU kernel's network does,
// spends 66-78 shared-memory passes on elements that are thrown away. So
// one block of 256 threads selects first and sorts only what it keeps:
//   1. load the row once (16-byte loads where the row allows) into shared
//      memory as u32 order keys (select.cuh::order_key);
//   2. radix-select the k-th largest key from the top
//      (select.cuh::radix_select: 8-bit passes, per-warp histograms with
//      __match_any_sync, early stop);
//   3. compact exactly k survivors, ties at the cut in index order
//      (select.cuh::compact: one block prefix sum);
//   4. sort the survivors as 64-bit (key, ~index) composites, descending:
//      for k <= 256 with one composite a thread (select.cuh::sort_desc),
//      for larger k a bitonic network in shared memory over next_pow2(k)
//      (select.cuh::sort_desc_smem).
// Steps 2-4 are shared with the banded top-N B8 through select.cuh.
// Rows of up to 16,384 elements fit (64 KiB of keys, plus up to 128 KiB of
// survivors; above 48 KiB the entry point opts in to the large carve-out);
// the wrapper splits longer rows into chunks and launches twice.
//
// Exactness. Keys, counts and moves only: equal to a stable descending
// sort in values and indices. NaNs are unordered and land anywhere.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (tvretrieval_tpu_torch/ops/_build.py). C interface, loaded with
// ctypes; the entry point returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "select.cuh"

namespace {

using namespace tvr_select;

constexpr int kMaxRow = 16384;
constexpr int kRegSort = kThreads;      // k up to this: one survivor a thread
// survivors of the largest k, the warps' histograms, the keys of the longest row
constexpr int kMaxSmem = kMaxRow * 8 + kWarps * kBins * 4 + kMaxRow * 4;

// x: (nq, n); out_v / out_i: (nq, k); s_sort: the survivor buffer's length
// (kRegSort for k <= kRegSort, else next_pow2(k)).
__global__ void __launch_bounds__(kThreads)
topk_select_kernel(const float* __restrict__ x, int n, int k, int s_sort,
                   float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* surv = reinterpret_cast<uint64_t*>(smem);
  uint32_t* hist = reinterpret_cast<uint32_t*>(surv + s_sort);
  uint32_t* keys = hist + kWarps * kBins;
  __shared__ uint32_t warp_tot[kWarps];
  __shared__ uint32_t sel[3];

  const int tid = threadIdx.x;
  const float* row = x + static_cast<size_t>(blockIdx.x) * n;

  // 1. keys
  if ((n & 3) == 0 && (reinterpret_cast<uintptr_t>(row) & 15) == 0) {
    const float4* r4 = reinterpret_cast<const float4*>(row);
    for (int i = tid; i < (n >> 2); i += kThreads) {
      const float4 v = r4[i];
      reinterpret_cast<uint4*>(keys)[i] =
          make_uint4(order_key(v.x), order_key(v.y), order_key(v.z), order_key(v.w));
    }
  } else {
    for (int i = tid; i < n; i += kThreads) keys[i] = order_key(row[i]);
  }

  // 2. radix select; 3. compaction of exactly k survivors
  uint32_t prefix, mask, need;
  radix_select<false>(keys, n, static_cast<uint32_t>(k), 0u, hist, warp_tot, sel, prefix,
                      mask, need);
  compact(keys, n, k, 0u, prefix, mask, need, surv, s_sort, warp_tot);

  float* ov = out_v + static_cast<size_t>(blockIdx.x) * k;
  int* oi = out_i + static_cast<size_t>(blockIdx.x) * k;

  // 4. sort the survivors, descending
  if (k <= kRegSort) {
    int span = 1;                         // next_pow2(k)
    while (span < k) span <<= 1;
    const uint64_t c = sort_desc(surv[tid], span, surv);
    if (tid < k) {
      const int i = position(c);
      ov[tid] = row[i];
      oi[tid] = min(i, n - 1);
    }
    return;
  }
  sort_desc_smem(surv, s_sort);
  for (int p = tid; p < k; p += kThreads) {
    const int i = position(surv[p]);
    ov[p] = row[i];
    oi[p] = min(i, n - 1);
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for a shape the kernel does not take (0 < k <= n <= 16,384, which
// ops/sort.py::MAX_ROW repeats).
int tvr_topk_sort(const void* x, int nq, int n, int k, void* out_v, void* out_i,
                  void* stream) {
  if (nq <= 0 || n <= 0 || k <= 0 || k > n || n > kMaxRow)
    return static_cast<int>(cudaErrorInvalidValue);
  int s_sort = kRegSort;
  while (s_sort < k) s_sort <<= 1;
  const size_t bytes = static_cast<size_t>(s_sort) * 8 + kWarps * kBins * 4 +
                       static_cast<size_t>((n + 3) & ~3) * 4;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        topk_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  topk_select_kernel<<<nq, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n, k, s_sort, static_cast<float*>(out_v),
      static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
