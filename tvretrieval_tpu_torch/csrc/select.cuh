// Select-then-sort steps for Hopper (sm_90a), shared by the sorting top-k
// B6 (topk_sort.cu), the banded top-N B8 (banded_topk.cu) and the
// approximate top-k B11 (approx_topk.cu). One block of
// kThreads = 256 threads (one histogram bin a thread) works on u32 order
// keys in shared memory:
//   order_key      -0.0 becomes +0.0, then non-negatives get the sign bit
//                  set and negatives are inverted, so that unsigned order is
//                  value order (real -inf is the lowest non-NaN key);
//   radix_select   the k-th largest key as (prefix, mask, need): up to four
//                  8-bit passes from the top, each a 256-bin histogram of
//                  the keys that still match the chosen prefix. Each warp
//                  counts into its own sub-histogram, and lanes holding the
//                  same digit add once (count_digit: __match_any_sync), so
//                  that rows full of ties do not serialise on one bin (B11
//                  adds lane by lane: on the H100 that is the faster of the
//                  two there). A pass whose chosen bin holds exactly the
//                  keys still needed ends the search. A caller that counted
//                  the top digits while it wrote the keys (B11) skips the
//                  first count;
//   compact        exactly k survivors: every key above the prefix and the
//                  first `need` keys equal to it in position order, by one
//                  block prefix sum over per-thread counts of contiguous
//                  stretches;
//   sort_desc      a bitonic network over one 64-bit (key, ~position)
//                  composite a thread: __shfl_xor_sync below stride 32,
//                  shared memory above; sort_desc_span the same network
//                  unrolled for a span fixed at compile time, on the warps
//                  that hold it; sort_desc_smem over more composites than
//                  threads, in shared memory.
// A floor key `least` leaves every key below it out of the selection: a
// caller that knows at least k keys reach it passes it (B8), the others 0.
// Keys, counts and moves only: exact, ties in position order.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tvr_select {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;
static_assert(kThreads == kBins, "radix_select gives one histogram bin to each thread");

__device__ __forceinline__ uint32_t order_key(float v) {
  uint32_t u = __float_as_uint(v);
  if (u == 0x80000000u) u = 0u;           // -0.0 ties with +0.0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// (key, position) -> one u64 that orders as (key descending, position
// ascending) under a descending sort; 0 (a NaN key at 2^32 - 1) pads
__device__ __forceinline__ uint64_t composite(uint32_t key, int i) {
  return (static_cast<uint64_t>(key) << 32) | static_cast<uint32_t>(~i);
}

__device__ __forceinline__ int position(uint64_t c) {
  return static_cast<int>(~static_cast<uint32_t>(c));
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

// One digit a lane into its warp's sub-histogram `wh` (kBins words); d =
// kBins counts nothing. kAggregate: lanes holding the same digit add once
// (__match_any_sync; every lane of the warp calls it), else each lane adds
// its own (the shared-memory atomics serialise equal digits of a warp).
template <bool kAggregate = true>
__device__ __forceinline__ void count_digit(uint32_t* wh, uint32_t d) {
  if (!kAggregate) {
    if (d < kBins) atomicAdd(&wh[d], 1u);
    return;
  }
  const uint32_t peers = __match_any_sync(0xffffffffu, d);
  if (d < kBins && (threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(&wh[d], __popc(peers));
}

// The k-th largest of keys[0, n) at or above `least` (at least k of them
// reach it), as (prefix, mask, need): the k best are the keys with (key &
// mask) > prefix, and the first `need` with (key & mask) == prefix and key
// >= least. `hist`: kWarps * kBins words; `sel`: 3 words. kSkipIdle: a warp
// whose lanes hold no counted key skips the histogram update (worth it when
// the floor leaves most keys out). kFirstCounted: `hist` already holds the
// top digits (key >> 24) of keys[0, n), counted with count_digit into the
// warps' sub-histograms, and a barrier has passed since. kAggregate: as in
// count_digit; without it the keys are read 16 bytes at a time (`keys`
// 16-byte aligned) and kSkipIdle does not apply.
template <bool kSkipIdle, bool kFirstCounted = false, bool kAggregate = true>
__device__ __forceinline__ void radix_select(const uint32_t* keys, int n, uint32_t k,
                                             uint32_t least, uint32_t* hist,
                                             uint32_t* warp_tot, uint32_t* sel,
                                             uint32_t& prefix, uint32_t& mask,
                                             uint32_t& need) {
  const int tid = threadIdx.x, warp = tid >> 5;
  prefix = 0u;
  mask = 0u;
  need = k;
  for (int shift = 24; shift >= 0; shift -= 8) {
    if (!kFirstCounted || shift != 24) {
      for (int i = tid; i < kWarps * kBins; i += kThreads) hist[i] = 0u;
      __syncthreads();
      uint32_t* wh = hist + warp * kBins;
      if (kAggregate) {
        for (int base = 0; base < n; base += kThreads) {
          const int i = base + tid;
          uint32_t d = kBins;             // no bin: out of the row, off the prefix, below the floor
          if (i < n) {
            const uint32_t key = keys[i];
            if ((key & mask) == prefix && key >= least) d = (key >> shift) & 255u;
          }
          if (kSkipIdle && !__any_sync(0xffffffffu, d < kBins)) continue;
          count_digit(wh, d);
        }
      } else {                            // four keys a 16-byte read, each lane adding its own
        auto count = [&](uint32_t key) {
          if ((key & mask) == prefix && key >= least) atomicAdd(&wh[(key >> shift) & 255u], 1u);
        };
        for (int q = tid; q < (n >> 2); q += kThreads) {
          const uint4 v = reinterpret_cast<const uint4*>(keys)[q];
          count(v.x);
          count(v.y);
          count(v.z);
          count(v.w);
        }
        for (int i = (n & ~3) + tid; i < n; i += kThreads) count(keys[i]);
      }
      __syncthreads();
    }
    const uint32_t b = kBins - 1 - tid;   // thread 0 holds the top bin
    uint32_t c = 0u;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) c += hist[w * kBins + b];
    uint32_t total;
    const uint32_t at_least = block_scan(c, warp_tot, total);   // keys with digit >= b
    const uint32_t above = at_least - c;
    if (above < need && need <= at_least) {
      sel[0] = b;
      sel[1] = need - above;
      sel[2] = c == need - above;
    }
    __syncthreads();
    prefix |= sel[0] << shift;
    mask |= 255u << shift;
    need = sel[1];
    if (sel[2]) break;                    // the whole bin is kept
  }
}

// Survivors of radix_select: k composites (key, ~position) into surv[0, k),
// those above the prefix first, each group in position order, zeros in
// surv[k, s_sort). Each thread counts a contiguous stretch of the keys.
// Ends with a barrier.
__device__ __forceinline__ void compact(const uint32_t* keys, int n, int k, uint32_t least,
                                        uint32_t prefix, uint32_t mask, uint32_t need,
                                        uint64_t* surv, int s_sort, uint32_t* warp_tot) {
  const int tid = threadIdx.x;
  const int per = (n + kThreads - 1) / kThreads;
  const int lo = min(n, tid * per), hi = min(n, lo + per);
  uint32_t gt = 0u, eq = 0u;
  for (int i = lo; i < hi; ++i) {
    const uint32_t key = keys[i], m = key & mask;
    gt += m > prefix;
    eq += m == prefix && key >= least;
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
    } else if (m == prefix && key >= least) {
      if (e < need) surv[n_gt + e] = composite(key, i);
      ++e;
    }
  }
  __syncthreads();
}

// Bitonic sort of one composite a thread, descending over the first `span`
// threads (a power of two <= kThreads); `buf`: kThreads words of shared
// memory for the strides of 32 and above. A caller that reuses `buf`
// afterwards puts a barrier first.
__device__ __forceinline__ uint64_t sort_desc(uint64_t c, int span, uint64_t* buf) {
  const int tid = threadIdx.x;
  for (int size = 2; size <= span; size <<= 1) {
    for (int j = size >> 1; j > 0; j >>= 1) {
      uint64_t o;
      if (j >= 32) {
        __syncthreads();
        buf[tid] = c;
        __syncthreads();
        o = buf[tid ^ j];
      } else {
        o = __shfl_xor_sync(0xffffffffu, c, j);
      }
      const bool keep_max = ((tid & size) == 0) == ((tid & j) == 0);
      c = keep_max ? (c > o ? c : o) : (c < o ? c : o);
    }
  }
  return c;
}

// sort_desc over a span known at compile time (32 to kThreads), the network
// unrolled, called by the first kSpan threads only: the strides of 32 and
// above meet at named barrier 1 of kSpan threads, and the other warps take
// no part.
template <int kSpan>
__device__ __forceinline__ uint64_t sort_desc_span(uint64_t c, uint64_t* buf) {
  static_assert(kSpan >= 32 && kSpan <= kThreads && (kSpan & (kSpan - 1)) == 0, "span");
  const int tid = threadIdx.x;
#pragma unroll
  for (int size = 2; size <= kSpan; size <<= 1) {
#pragma unroll
    for (int j = size >> 1; j > 0; j >>= 1) {
      uint64_t o;
      if (j >= 32) {
        asm volatile("bar.sync 1, %0;" ::"r"(kSpan) : "memory");
        buf[tid] = c;
        asm volatile("bar.sync 1, %0;" ::"r"(kSpan) : "memory");
        o = buf[tid ^ j];
      } else {
        o = __shfl_xor_sync(0xffffffffu, c, j);
      }
      const bool keep_max = ((tid & size) == 0) == ((tid & j) == 0);
      c = keep_max ? (c > o ? c : o) : (c < o ? c : o);
    }
  }
  return c;
}

// Bitonic sort, descending, of the `s` composites of v (a power of two),
// each thread taking pairs; ends with a barrier. The caller puts a barrier
// between the writes of v and this call.
__device__ __forceinline__ void sort_desc_smem(uint64_t* v, int s) {
  const int half = s >> 1;
  for (int size = 2; size <= s; size <<= 1) {
    for (int j = size >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < half; t += kThreads) {
        const int l = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const int h = l | j;
        const uint64_t a = v[l], b = v[h];
        if ((l & size) == 0 ? a < b : a > b) {
          v[l] = b;
          v[h] = a;
        }
      }
      __syncthreads();
    }
  }
}

}  // namespace tvr_select
