// Approximate top-k of every row by bins for Hopper (sm_90a): kernel B11,
// the port's counterpart of the TPU's hardware approximate top-k, which no
// Pallas kernel of the JAX package holds: jax.lax.approx_max_k reaches it
// at tvretrieval_tpu/retrieval/engine.py:597 (video top-V on the pre-exp
// scores) and tvretrieval_tpu/ops/span.py:581, 609 (the group and final
// selects of banded_topk_spans_grouped_shift_approx). On a TPU it is a
// partial reduce (arXiv:2206.14286): M bin maxima, then an exact top-k of
// them.
//
// What it computes (ops/approx_topk.py, whose plain version it equals in
// values and indices). x is (nq, n) f32; M bins come from the recall
// target (ops/approx_topk.py::reduction_output_size). Bin b holds the
// elements j with j % M == b. Each bin keeps its largest element, ties to
// the lowest index; the k best bins are kept, ties at the cut to the lower
// bin index; the output is their elements by value descending, then
// element index ascending, as (f32 values, the row's own bits; int32
// element indices). -0.0 ties with 0.0.
//
// What bounds it on this card, and the design. Every element is read once
// (87 MB at the engine's video site, 1,000 rows of 21,818: 26 us at
// 3.35 TB/s), and the selection works on the M << n bin maxima only. One
// block of 256 threads a row:
//   1. bin maxima: consecutive threads take consecutive bins, so each step
//      down a bin (element b + i * M) is a coalesced read of a warp; a bin's
//      best is kept as a u32 order key (select.cuh::order_key) beside its
//      element index in shared memory, a strictly greater key replacing it,
//      so ties keep the lowest index;
//   2. the k best keys: select.cuh's radix select and compaction, which
//      keep ties at the cut in key-array position, here bin order;
//   3. the survivors as (key, ~element) composites, sorted descending
//      (select.cuh::sort_desc for k <= 256, sort_desc_smem above), so the
//      order carries the element index, not the bin's.
// Bins go in chunks of at most 16,384 (the recall 1.0 video site has
// 21,818): the k best of a chunk are carried into the next one's key array
// ahead of its bins. Compaction keeps equal keys in position order, so the
// carried keys keep bin order among ties and precede every later bin.
//
// Exactness. Keys, counts and moves only: equal to the plain version.
//
// Limits: k <= M <= n < 2^30, k <= 1,024 (ops/approx_topk.py::MAX_K).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (tvretrieval_tpu_torch/ops/_build.py). C interface, loaded with
// ctypes; the entry point returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "select.cuh"

namespace {

using namespace tvr_select;

constexpr int kMaxChunk = 16384;          // bins of one pass
constexpr int kMaxK = 1024;
constexpr int kCarry = kMaxK / kThreads;  // carried survivors a thread moves

// x: (nq, n); out_v / out_i: (nq, k). chunk: bins a pass; s_sort: the
// survivor buffer's length (kThreads for k <= kThreads, else next_pow2(k)).
__global__ void __launch_bounds__(kThreads)
approx_topk_kernel(const float* __restrict__ x, int n, int m, int k, int chunk, int s_sort,
                   float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* surv = reinterpret_cast<uint64_t*>(smem);            // s_sort
  uint32_t* hist = reinterpret_cast<uint32_t*>(surv + s_sort);   // kWarps * kBins
  uint32_t* keys = hist + kWarps * kBins;                        // carried + one chunk
  int* elem = reinterpret_cast<int*>(keys + k + chunk);          // their element indices
  __shared__ uint32_t warp_tot[kWarps];
  __shared__ uint32_t sel[3];

  const int tid = threadIdx.x;
  const float* row = x + static_cast<size_t>(blockIdx.x) * n;

  int n_sel = 0;                          // carried survivors in keys / elem[0, n_sel)
  for (int c0 = 0; c0 < m; c0 += chunk) {
    const int n_chunk = min(chunk, m - c0), n_all = n_sel + n_chunk;
    // 1. bin maxima
    for (int b = c0 + tid; b < c0 + n_chunk; b += kThreads) {
      uint32_t best = order_key(__ldg(row + b));
      int at = b;
#pragma unroll 4
      for (int j = b + m; j < n; j += m) {
        const uint32_t key = order_key(__ldg(row + j));
        if (key > best) {
          best = key;
          at = j;
        }
      }
      keys[n_sel + b - c0] = best;
      elem[n_sel + b - c0] = at;
    }
    __syncthreads();
    if (n_all <= k) {                     // every bin so far is kept
      n_sel = n_all;
      continue;
    }
    // 2. the k best keys, then carried into keys / elem[0, k)
    uint32_t prefix, mask, need;
    radix_select<false>(keys, n_all, static_cast<uint32_t>(k), 0u, hist, warp_tot, sel,
                        prefix, mask, need);
    compact(keys, n_all, k, 0u, prefix, mask, need, surv, s_sort, warp_tot);
    uint32_t ck[kCarry];
    int ce[kCarry];
#pragma unroll
    for (int r = 0; r < kCarry; ++r) {
      const int i = tid + r * kThreads;
      if (i < k) {
        const uint64_t c = surv[i];
        ck[r] = static_cast<uint32_t>(c >> 32);
        ce[r] = elem[position(c)];
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kCarry; ++r) {
      const int i = tid + r * kThreads;
      if (i < k) {
        keys[i] = ck[r];
        elem[i] = ce[r];
      }
    }
    __syncthreads();
    n_sel = k;
  }

  // 3. (key, ~element) composites, sorted descending
  for (int i = tid; i < s_sort; i += kThreads)
    surv[i] = i < n_sel ? composite(keys[i], elem[i]) : 0ull;
  __syncthreads();
  float* ov = out_v + static_cast<size_t>(blockIdx.x) * k;
  int* oi = out_i + static_cast<size_t>(blockIdx.x) * k;
  if (s_sort == kThreads) {
    int span = 1;                         // next_pow2(k)
    while (span < k) span <<= 1;
    const uint64_t c = sort_desc(surv[tid], span, surv);
    if (tid < k) {
      const int i = position(c);
      ov[tid] = row[i];
      oi[tid] = i;
    }
    return;
  }
  sort_desc_smem(surv, s_sort);
  for (int p = tid; p < k; p += kThreads) {
    const int i = position(surv[p]);
    ov[p] = row[i];
    oi[p] = i;
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for a shape the kernel does not take (0 < k <= m <= n < 2^30, k <= 1,024).
int tvr_approx_topk(const void* x, int nq, int n, int m, int k, void* out_v, void* out_i,
                    void* stream) {
  if (nq <= 0 || n <= 0 || n >= (1 << 30) || m <= 0 || m > n || k <= 0 || k > m ||
      k > kMaxK)
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunk = m < kMaxChunk ? m : kMaxChunk;
  int s_sort = kThreads;
  while (s_sort < k) s_sort <<= 1;
  const size_t bytes = static_cast<size_t>(s_sort) * 8 + kWarps * kBins * 4 +
                       static_cast<size_t>(k + chunk) * 8;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        approx_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  approx_topk_kernel<<<nq, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n, m, k, chunk, s_sort, static_cast<float*>(out_v),
      static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
