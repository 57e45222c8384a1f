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
//      memory as u32 keys that order like the values: -0.0 becomes +0.0,
//      then non-negatives get the sign bit set and negatives are inverted
//      (real -inf is the lowest non-NaN key);
//   2. radix-select the k-th largest key T from the top: up to four 8-bit
//      passes, each a 256-bin histogram of the keys that still match the
//      chosen prefix. Each warp counts into its own sub-histogram, and
//      lanes holding the same digit add once (__match_any_sync), so rows
//      full of ties do not serialise on one bin. A pass whose chosen bin
//      holds exactly the keys still needed ends the search early;
//   3. compact exactly k survivors: every key above T (under the prefix
//      mask reached) and the first k - count(> T) keys equal to T in index
//      order, by one block prefix sum over per-thread counts of contiguous
//      stretches of the row;
//   4. sort the survivors as 64-bit (key, ~index) composites, descending:
//      for k <= 256 a bitonic network with one composite a thread,
//      __shfl_xor_sync below stride 32 and shared memory above; for larger
//      k a bitonic network in shared memory over next_pow2(k).
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

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;
constexpr int kMaxRow = 16384;
constexpr int kRegSort = kThreads;      // k up to this: one survivor a thread
// survivors of the largest k, the warps' histograms, the keys of the longest row
constexpr int kMaxSmem = kMaxRow * 8 + kWarps * kBins * 4 + kMaxRow * 4;

__device__ __forceinline__ uint32_t order_key(float v) {
  uint32_t u = __float_as_uint(v);
  if (u == 0x80000000u) u = 0u;           // -0.0 ties with +0.0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// (key, index) -> one u64 that orders as (key descending, index ascending)
// under a descending sort; 0 (a NaN key at index 2^32 - 1) pads the network
__device__ __forceinline__ uint64_t composite(uint32_t key, int i) {
  return (static_cast<uint64_t>(key) << 32) | static_cast<uint32_t>(~i);
}

// inclusive prefix sum over the block's threads in thread order; `total`
// gets the block's sum. Ends with a barrier, so `warp_tot` can be reused.
__device__ uint32_t block_scan(uint32_t v, uint32_t* warp_tot, uint32_t& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t o = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += o;
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  if (warp == 0) {
    uint32_t w = lane < kWarps ? warp_tot[lane] : 0u;
#pragma unroll
    for (int off = 1; off < kWarps; off <<= 1) {
      const uint32_t o = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += o;
    }
    if (lane < kWarps) warp_tot[lane] = w;
  }
  __syncthreads();
  const uint32_t base = warp ? warp_tot[warp - 1] : 0u;
  total = warp_tot[kWarps - 1];
  __syncthreads();
  return v + base;
}

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
  __shared__ uint32_t s_digit, s_need, s_done;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
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

  // 2. radix select: after the loop, the kept keys are those with
  // (key & mask) > prefix, and the first `need` with (key & mask) == prefix
  uint32_t prefix = 0u, mask = 0u, need = static_cast<uint32_t>(k);
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = tid; i < kWarps * kBins; i += kThreads) hist[i] = 0u;
    __syncthreads();
    uint32_t* wh = hist + warp * kBins;
    for (int base = 0; base < n; base += kThreads) {
      const int i = base + tid;
      uint32_t d = kBins;                 // no bin: out of the row or off the prefix
      if (i < n) {
        const uint32_t key = keys[i];
        if ((key & mask) == prefix) d = (key >> shift) & 255u;
      }
      const uint32_t peers = __match_any_sync(0xffffffffu, d);
      if (d < kBins && lane == __ffs(peers) - 1) atomicAdd(&wh[d], __popc(peers));
    }
    __syncthreads();
    const uint32_t b = kBins - 1 - tid;   // thread 0 holds the top bin
    uint32_t c = 0u;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) c += hist[w * kBins + b];
    uint32_t total;
    const uint32_t at_least = block_scan(c, warp_tot, total);   // keys with digit >= b
    const uint32_t above = at_least - c;
    if (above < need && need <= at_least) {
      s_digit = b;
      s_need = need - above;
      s_done = c == need - above;
    }
    __syncthreads();
    prefix |= s_digit << shift;
    mask |= 255u << shift;
    need = s_need;
    if (s_done) break;                    // the whole bin is kept
  }

  // 3. compaction: each thread counts a contiguous stretch of the row
  const int per = (n + kThreads - 1) / kThreads;
  const int lo = min(n, tid * per), hi = min(n, lo + per);
  uint32_t gt = 0u, eq = 0u;
  for (int i = lo; i < hi; ++i) {
    const uint32_t m = keys[i] & mask;
    gt += m > prefix;
    eq += m == prefix;
  }
  const uint32_t packed = (gt << 16) | eq;   // each below 2^15: no carry
  uint32_t total;
  const uint32_t before = block_scan(packed, warp_tot, total) - packed;
  const uint32_t n_gt = total >> 16;          // k - need
  uint32_t g = before >> 16, e = before & 0xffffu;
  for (int i = k + tid; i < s_sort; i += kThreads) surv[i] = 0ull;
  for (int i = lo; i < hi; ++i) {
    const uint32_t key = keys[i], m = key & mask;
    if (m > prefix) {
      surv[g++] = composite(key, i);
    } else if (m == prefix) {
      if (e < need) surv[n_gt + e] = composite(key, i);
      ++e;
    }
  }
  __syncthreads();

  float* ov = out_v + static_cast<size_t>(blockIdx.x) * k;
  int* oi = out_i + static_cast<size_t>(blockIdx.x) * k;

  // 4. sort the survivors, descending
  if (k <= kRegSort) {
    int span = 1;                         // next_pow2(k)
    while (span < k) span <<= 1;
    uint64_t c = surv[tid];
    for (int size = 2; size <= span; size <<= 1) {
      for (int j = size >> 1; j > 0; j >>= 1) {
        uint64_t o;
        if (j >= 32) {
          __syncthreads();
          surv[tid] = c;
          __syncthreads();
          o = surv[tid ^ j];
        } else {
          o = __shfl_xor_sync(0xffffffffu, c, j);
        }
        const bool keep_max = ((tid & size) == 0) == ((tid & j) == 0);
        c = keep_max ? (c > o ? c : o) : (c < o ? c : o);
      }
    }
    if (tid < k) {
      const int i = static_cast<int>(~static_cast<uint32_t>(c));
      ov[tid] = row[i];
      oi[tid] = min(i, n - 1);
    }
    return;
  }
  const int half = s_sort >> 1;
  for (int size = 2; size <= s_sort; size <<= 1) {
    for (int j = size >> 1; j > 0; j >>= 1) {
      for (int t = tid; t < half; t += kThreads) {
        const int l = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const int h = l | j;
        const uint64_t a = surv[l], b = surv[h];
        if ((l & size) == 0 ? a < b : a > b) {
          surv[l] = b;
          surv[h] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int p = tid; p < k; p += kThreads) {
    const int i = static_cast<int>(~static_cast<uint32_t>(surv[p]));
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
