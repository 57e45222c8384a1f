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
// block of 256 threads a row, four blocks an SM (at most 64 registers a
// thread): 528 rows at once, so that the selects of the first rows run
// while later rows stream in. With all 1,000 rows resident at once (32
// registers, 8 blocks an SM) every block reads and then selects at the same
// time, and the card idles its memory through the selects: slower.
//   1. bin maxima: a thread takes two adjacent bins and reads both with
//      one 8-byte load a step down the bins (element b + s * M), where the
//      row allows (n and M even, the row 8-byte aligned: every engine row),
//      else one bin with 4-byte loads; consecutive threads take consecutive
//      bins, so a step is a coalesced read of a warp, and a bin's steps are
//      issued kGroup at a time before their compares. A bin keeps its best
//      as a u32 order key (select.cuh::order_key) and the step it came from
//      (u16 where a bin holds at most 65,536 elements), a strictly greater
//      key replacing it, so ties keep the lowest index. Where M = n every
//      bin is one element: the row is read as keys, 16 bytes a load where
//      it allows. Each key's top 8 bits are counted into the warp's
//      histogram as it is written (select.cuh::count_digit, lane by lane:
//      on this card the shared-memory atomics beat __match_any_sync), which
//      is radix_select's first pass;
//   2. the k best keys: select.cuh's radix select from its second digit
//      (keys read 16 bytes at a time), and its compaction, which keeps ties
//      at the cut in key-array position, here bin order;
//   3. the survivors as (key, ~element) composites, sorted descending: for
//      k <= 256 by select.cuh::sort_desc_span, unrolled for its span and run
//      by the warps that hold it; above, sort_desc_smem. The order carries
//      the element index, not the bin's.
// Bins go in chunks of at most 16,384 (the recall 1.0 video site has
// 21,818): the k best of a chunk, with their elements, are carried into
// the next one's key array ahead of its bins, their digits counted again.
// Compaction keeps equal keys in position order, so the carried keys keep
// bin order among ties and precede every later bin. Shared memory: the
// histograms (8 KB, which the survivors reuse once the select is done),
// the keys and steps of a chunk, and the carried elements (16.6 KB at the
// video site, 23.6 KB at the group select, 19.4 KB at the final one).
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
constexpr int kMinBlocks = 4;             // blocks an SM: at most 64 registers a thread
constexpr int kGroup = 4;                 // steps of a bin loaded before their compares
// the survivors reuse the histograms: s_sort <= kMaxK composites of 8 bytes
static_assert(kMaxK * 8 <= kWarps * kBins * 4, "survivors must fit over the histograms");

template <int kE> struct Lanes;           // kE adjacent bins, one load
template <> struct Lanes<1> {
  using T = float;
  static __device__ __forceinline__ float at(float v, int) { return v; }
};
template <> struct Lanes<2> {
  using T = float2;
  static __device__ __forceinline__ float at(float2 v, int e) { return e ? v.y : v.x; }
};
template <> struct Lanes<4> {
  using T = float4;
  static __device__ __forceinline__ float at(float4 v, int e) {
    return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
  }
};

// Step 1 where every bin is one element (M = n): the keys of seg[0, nc)
// into keys[0, nc), kV a load (16- or 8-byte loads where the row allows),
// each key's top digit counted into the warp's histogram of `hist`.
template <int kV>
__device__ __forceinline__ void element_keys(const float* __restrict__ seg, int nc,
                                             uint32_t* keys, uint32_t* hist) {
  using V = typename Lanes<kV>::T;
  const V* sv = reinterpret_cast<const V*>(seg);
  uint32_t* wh = hist + (threadIdx.x >> 5) * kBins;
#pragma unroll 2
  for (int i = threadIdx.x; i < nc / kV; i += kThreads) {
    const V v = __ldg(sv + i);
#pragma unroll
    for (int e = 0; e < kV; ++e) {
      const uint32_t key = order_key(Lanes<kV>::at(v, e));
      keys[i * kV + e] = key;
      count_digit<false>(wh, key >> 24);
    }
  }
}

// Step 1 over bins [c0, c0 + nc) of more than one element, kE adjacent
// bins a thread: the best key of bin c0 + i into keys[i], its step into
// step[i], its top digit counted into the warp's histogram of `hist`.
// kE = 2 needs n, m, c0 and nc even and the row 8-byte aligned.
template <int kE, typename Step>
__device__ __forceinline__ void bin_maxima(const float* __restrict__ row, int n, int m,
                                           int c0, int nc, uint32_t* keys, Step* step,
                                           uint32_t* hist) {
  using V = typename Lanes<kE>::T;
  const V* rv = reinterpret_cast<const V*>(row);
  uint32_t* wh = hist + (threadIdx.x >> 5) * kBins;
  const int groups = nc / kE;
  for (int base = 0; base < groups; base += kThreads) {
    const int g = base + threadIdx.x;
    uint32_t best[kE], at[kE];
#pragma unroll
    for (int e = 0; e < kE; ++e) {        // every real key is above 0
      best[e] = 0u;
      at[e] = 0u;
    }
    if (g < groups) {
      const int b = c0 + g * kE;
      const int steps = (n - 1 - b) / m + 1;   // the same for all kE bins
      for (int s = 0; s < steps; s += kGroup) {
        V v[kGroup];
#pragma unroll
        for (int u = 0; u < kGroup; ++u)   // unsigned: past the row it wraps, unread
          if (s + u < steps)
            v[u] = __ldg(rv + (static_cast<unsigned>(b) +
                               static_cast<unsigned>(s + u) * static_cast<unsigned>(m)) / kE);
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          if (s + u < steps) {
#pragma unroll
            for (int e = 0; e < kE; ++e) {
              const uint32_t key = order_key(Lanes<kE>::at(v[u], e));
              if (key > best[e]) {
                best[e] = key;
                at[e] = s + u;
              }
            }
          }
        }
      }
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        keys[b - c0 + e] = best[e];
        step[b - c0 + e] = static_cast<Step>(at[e]);
      }
    }
#pragma unroll
    for (int e = 0; e < kE; ++e) count_digit<false>(wh, g < groups ? best[e] >> 24 : kBins);
  }
}

// x: (nq, n); out_v / out_i: (nq, k). chunk: bins a pass; s_sort: the
// survivor buffer's length (kThreads for k <= kThreads, else next_pow2(k)).
// Step: the type of a bin's winning step.
template <typename Step>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
approx_topk_kernel(const float* __restrict__ x, int n, int m, int k, int chunk, int s_sort,
                   float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int carry = m > chunk ? k : 0;
  uint32_t* hist = reinterpret_cast<uint32_t*>(smem);            // kWarps * kBins
  uint64_t* surv = reinterpret_cast<uint64_t*>(smem);            // s_sort, once hist is done
  uint32_t* keys = hist + kWarps * kBins;                        // carried + one chunk
  int* celem = reinterpret_cast<int*>(keys + carry + chunk);     // the carried keys' elements
  Step* step = m < n ? reinterpret_cast<Step*>(celem + carry) : nullptr;   // one chunk
  __shared__ uint32_t warp_tot[kWarps];
  __shared__ uint32_t sel[3];

  const int tid = threadIdx.x;
  const float* row = x + static_cast<size_t>(blockIdx.x) * n;
  const bool paired = ((n | m) & 1) == 0 && (reinterpret_cast<uintptr_t>(row) & 7) == 0;

  for (int i = tid; i < kWarps * kBins; i += kThreads) hist[i] = 0u;
  __syncthreads();
  int n_sel = 0, c0 = 0;                  // carried keys in keys / celem[0, n_sel)
  // the element that key-array position p of the chunk at c0 stands for
  auto elem = [&](int p) {
    if (p < n_sel) return celem[p];
    const int b = c0 + p - n_sel;
    return step ? b + static_cast<int>(step[p - n_sel]) * m : b;
  };
  bool selected = false;                  // surv holds (key, position) survivors
  for (;; c0 += chunk) {
    const int nc = min(chunk, m - c0), n_all = n_sel + nc;
    const bool last = c0 + nc >= m;
    // 1. bin maxima, their top digits counted
    if (!step) {                          // one element a bin: the row's keys
      const uintptr_t addr = reinterpret_cast<uintptr_t>(row + c0);
      if ((addr & 15) == 0 && (nc & 3) == 0)
        element_keys<4>(row + c0, nc, keys + n_sel, hist);
      else if ((addr & 7) == 0 && (nc & 1) == 0)
        element_keys<2>(row + c0, nc, keys + n_sel, hist);
      else
        element_keys<1>(row + c0, nc, keys + n_sel, hist);
    } else if (paired) {
      bin_maxima<2>(row, n, m, c0, nc, keys + n_sel, step, hist);
    } else {
      bin_maxima<1>(row, n, m, c0, nc, keys + n_sel, step, hist);
    }
    __syncthreads();
    if (n_all <= k) {                     // every bin so far is kept
      if (last) break;
      for (int p = n_sel + tid; p < n_all; p += kThreads) celem[p] = elem(p);
      __syncthreads();
      n_sel = n_all;
      continue;
    }
    // 2. the k best keys
    uint32_t prefix, mask, need;
    radix_select<false, true, false>(keys, n_all, static_cast<uint32_t>(k), 0u, hist, warp_tot,
                                     sel, prefix, mask, need);
    compact(keys, n_all, k, 0u, prefix, mask, need, surv, s_sort, warp_tot);
    if (last) {
      selected = true;
      break;
    }
    // carried into keys / celem[0, k), their digits counted afresh
    uint64_t c[kCarry];
#pragma unroll
    for (int r = 0; r < kCarry; ++r) {
      const int i = tid + r * kThreads;
      c[r] = i < k ? composite(static_cast<uint32_t>(surv[i] >> 32), elem(position(surv[i])))
                   : 0ull;
    }
    __syncthreads();
    for (int i = tid; i < kWarps * kBins; i += kThreads) hist[i] = 0u;
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kCarry; ++r) {
      const int i = tid + r * kThreads;
      const uint32_t key = static_cast<uint32_t>(c[r] >> 32);
      if (i < k) {
        keys[i] = key;
        celem[i] = position(c[r]);
      }
      count_digit<false>(hist + (tid >> 5) * kBins, i < k ? key >> 24 : kBins);
    }
    __syncthreads();
    n_sel = k;
  }

  // 3. (key, ~element) composites of the k kept keys, sorted descending;
  // without a select they are keys[0, k)
  auto survivor = [&](int i) {
    if (!selected) return composite(keys[i], elem(i));
    const uint64_t c = surv[i];
    return composite(static_cast<uint32_t>(c >> 32), elem(position(c)));
  };
  float* ov = out_v + static_cast<size_t>(blockIdx.x) * k;
  int* oi = out_i + static_cast<size_t>(blockIdx.x) * k;
  if (s_sort == kThreads) {
    int span = 32;                        // max(32, next_pow2(k)): zeros sort last
    while (span < k) span <<= 1;
    if (tid >= span) return;              // warps past the survivors take no part
    const uint64_t sv = tid < k ? survivor(tid) : 0ull;
    const uint64_t c = span == 32    ? sort_desc_span<32>(sv, surv)
                       : span == 64  ? sort_desc_span<64>(sv, surv)
                       : span == 128 ? sort_desc_span<128>(sv, surv)
                                     : sort_desc_span<256>(sv, surv);
    if (tid < k) {
      const int i = position(c);
      ov[tid] = row[i];
      oi[tid] = i;
    }
    return;
  }
  uint64_t c[kCarry];                     // in place: every read before any write
#pragma unroll
  for (int r = 0; r < kCarry; ++r) {
    const int i = tid + r * kThreads;
    c[r] = i < k ? survivor(i) : 0ull;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kCarry; ++r) {
    const int i = tid + r * kThreads;
    if (i < s_sort) surv[i] = c[r];
  }
  __syncthreads();
  sort_desc_smem(surv, s_sort);
  for (int p = tid; p < k; p += kThreads) {
    const int i = position(surv[p]);
    ov[p] = row[i];
    oi[p] = i;
  }
}

template <typename Step>
int launch(const float* x, int nq, int n, int m, int k, float* out_v, int* out_i,
           cudaStream_t stream) {
  const int chunk = m < kMaxChunk ? m : kMaxChunk;
  const int carry = m > chunk ? k : 0;
  int s_sort = kThreads;
  while (s_sort < k) s_sort <<= 1;
  const size_t bytes = kWarps * kBins * 4 + static_cast<size_t>(2 * carry + chunk) * 4 +
                       (m < n ? static_cast<size_t>(chunk) * sizeof(Step) : 0);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        approx_topk_kernel<Step>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  approx_topk_kernel<Step><<<nq, kThreads, bytes, stream>>>(x, n, m, k, chunk, s_sort, out_v,
                                                           out_i);
  return static_cast<int>(cudaGetLastError());
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
  const float* xv = static_cast<const float*>(x);
  float* ov = static_cast<float*>(out_v);
  int* oi = static_cast<int*>(out_i);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // a bin's steps fit 16 bits unless it holds more than 65,536 elements
  return (n - 1) / m < 65536 ? launch<uint16_t>(xv, nq, n, m, k, ov, oi, st)
                             : launch<uint32_t>(xv, nq, n, m, k, ov, oi, st);
}

}  // extern "C"
