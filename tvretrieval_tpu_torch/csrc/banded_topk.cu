// Fused banded joint + exact top-N span selection for Hopper (sm_90a): the
// port of tvretrieval_tpu/ops/pallas_topk.py::banded_topk_spans_pallas
// (_make_kernel, _bitonic_*, :59-274), kernel B8.
//
// What it computes. Per query, over V candidate videos with start / end
// probabilities st, ed (V, L) and a video score vs (V,): the joint
//   joint[v, s, w] = (st[v, s] * ed[v, s + min_l + w]) * vs[v]   (two f32
//   multiplications, in this order), 0 <= w < W = max_l - min_l,
// with 0.0 where the end s + min_l + w lies beyond the clip axis, and its
// top_n elements under (value descending, flat index v * L * W + s * W + w
// ascending): the order of a stable top-k over the flat joint, which
// ops/span.py::banded_topk_spans materializes and sorts. The joint never
// reaches device memory. Outputs: video, start and end indices (int32) and
// scores (f32), each (Nq, top_n), and per query the number of videos that
// hold a selected row (see below). An out-of-band zero keeps its real flat
// index and can be returned; when the joint has fewer than top_n elements
// the rest decode to score 0, indices (0, 0, min_l), like the padding of
// the plain version.
//
// What bounds it on this card. The bytes are few (84 MB at 1,000 queries x
// 100 videos x 100 clips: 25 us at 3.35 TB/s) and the work per byte is
// small; the time goes to passes over on-chip keys and the barriers between
// them. So the kernel looks at each of the V * L * W joint elements once,
// and selects with a few passes over one key a row, not over the joint:
//   1. row bests. A row (v, s) holds the W elements of one start. f32
//      multiplication by a fixed factor is monotone (non-decreasing for a
//      factor >= 0, non-increasing below), so over the row the joint peaks
//      at the largest or the smallest end probability of the band (0.0
//      standing for the out-of-band ends): the row's best value is the
//      larger of the joint at those two, exact for any finite input. One
//      pass over the rows, each thread on its own rows, one u32 order key
//      a row in shared memory (select.cuh::order_key: 0.0 and -0.0 equal).
//      It carries the value only: ends giving one product need no order;
//   2. the top_n rows under (best descending, row ascending), which hold
//      the answer: if a row outside them held a selected element e, each of
//      those top_n rows would hold its best element, at least e's value
//      and, at an equal value, a lower flat index; e would then be beaten
//      top_n times. A floor first: the top_n-th largest of the threads'
//      row maxima (one register sort of 256 keys) is reached by at least
//      top_n rows, so rows below it are left out of the select. Then
//      select.cuh's radix select, compaction with ties in row order, and a
//      register sort of the <= 256 rows back into row order;
//   3. the top_n elements of those rows' <= 256 * W: the joint recomputed
//      there, keys below the least selected row best left out (each
//      selected row reaches it, so top_n elements do), the same radix
//      select and compaction, and one register sort of the survivors as
//      (key, ~position) composites, positions in flat order.
// No step is per video; a query costs about six barriers a radix pass.
// Rows are read straight from device memory, four consecutive rows a
// thread, whose windows share W + 3 loads (one row a thread, with W loads
// a row, was 1.25x slower on an H100: the row pass is the largest step).
// Staging each query's rows into shared memory by cp.async on a persistent
// grid, one block an SM, was 1.8x slower: four blocks an SM on their own
// queries hide more latency than one. A query's rows go in chunks of at
// most 16,384 (64 KiB of keys), the top_n rows of one chunk carried into
// the next, so shared memory does not grow with V.
//
// Exactness. The joint is computed by two __fmul_rn in the plain version's
// order; every comparison is on order keys and positions, moves only: all
// four outputs equal to the plain version's, ties included.
//
// Limits: L <= 128, W <= 16, top_n <= 256, V * L * W < 2^30.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (tvretrieval_tpu_torch/ops/_build.py). C interface, loaded with
// ctypes; the entry point returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "select.cuh"

namespace {

using namespace tvr_select;

constexpr int kMaxL = 128;
constexpr int kMaxW = 16;
constexpr int kMaxTop = kThreads;         // top_n <= 256: one output a thread
constexpr int kMaxChunk = 16384;          // rows of one chunk
constexpr int kRun = 4;                   // consecutive rows a thread takes at a time
constexpr int kLimit = 1 << 30;           // V * L * W: flat indices in int

__device__ __forceinline__ float joint(float st, float ed, float vs) {
  return __fmul_rn(__fmul_rn(st, ed), vs);
}

// the order key of the row's best joint value: the joint at the largest and
// at the smallest of its n_in in-band end probabilities e[0, n_in), 0.0
// standing for the W - n_in out-of-band ends
__device__ __forceinline__ uint32_t row_best_key(const float* e, int n_in, int W, float st,
                                                 float vs) {
  float hi = n_in < W ? 0.0f : -INFINITY, lo = n_in < W ? 0.0f : INFINITY;
#pragma unroll
  for (int w = 0; w < kMaxW; ++w) {
    if (w < n_in) {
      hi = fmaxf(hi, e[w]);
      lo = fminf(lo, e[w]);
    }
  }
  return max(order_key(joint(st, hi, vs)), order_key(joint(st, lo, vs)));
}

// st, ed: (nq, V, L); vs: (nq, V). out_*: (nq, top_n). videos: (nq,), the
// videos of each query that hold one of its top_n rows. chunk: rows a
// chunk.
__global__ void __launch_bounds__(kThreads)
banded_topk_kernel(const float* __restrict__ st, const float* __restrict__ ed,
                   const float* __restrict__ vs, int V, int L, int W, int min_l, int top_n,
                   int chunk, int* __restrict__ out_vid, int* __restrict__ out_st,
                   int* __restrict__ out_ed, float* __restrict__ out_score,
                   int* __restrict__ videos)
{
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* surv = reinterpret_cast<uint64_t*>(smem);           // kThreads
  uint32_t* hist = reinterpret_cast<uint32_t*>(surv + kThreads);  // kWarps * kBins
  int* rows = reinterpret_cast<int*>(hist + kWarps * kBins);      // kMaxTop selected rows
  uint32_t* keys = reinterpret_cast<uint32_t*>(rows + kMaxTop);   // carried + chunk, or elements
  __shared__ uint32_t warp_tot[kWarps];
  __shared__ uint32_t sel[3];
  __shared__ uint32_t s_floor;

  const int tid = threadIdx.x;
  const long long q = blockIdx.x;
  const float* st_q = st + q * V * L;
  const float* ed_q = ed + q * V * L;
  const float* vs_q = vs + q * V;
  const int n_rows = V * L;
  // a thread's stride from one run of rows to its next, in videos and starts
  const int dv = kThreads * kRun / L, ds = kThreads * kRun - dv * L;

  // 1-2. row bests, chunk by chunk; the top_n rows so far stay in
  // rows[0, n_sel) in row order, their keys in keys[0, n_sel)
  int n_sel = 0;
  for (int c0 = 0; c0 < n_rows; c0 += chunk) {
    const int n_chunk = min(chunk, n_rows - c0), n = n_sel + n_chunk;
    uint32_t* ck = keys + n_sel;
    uint32_t t_max = 0u;                  // below every non-NaN key
    // runs of kRun consecutive rows a thread: their windows share the run's
    // W + kRun - 1 end probabilities, ed_q[r0 + min_l ...] (a run may cross
    // into the next video: ed is (V, L) contiguous)
    int v = (c0 + tid * kRun) / L, s = c0 + tid * kRun - v * L;
    for (int i0 = tid * kRun; i0 < n_chunk; i0 += kThreads * kRun) {
      const int r0 = c0 + i0;
      float e[kRun + kMaxW - 1];
#pragma unroll
      for (int i = 0; i < kRun + kMaxW - 1; ++i) {
        const int r = r0 + min_l + i;
        e[i] = i < kRun + W - 1 && r < n_rows ? __ldg(ed_q + r) : 0.0f;
      }
      int vj = v, sj = s;                 // row r0 + j = vj * L + sj
#pragma unroll
      for (int j = 0; j < kRun; ++j) {
        if (i0 + j < n_chunk) {
          const uint32_t key = row_best_key(e + j, min(W, max(0, L - sj - min_l)), W,
                                            __ldg(st_q + r0 + j), __ldg(vs_q + vj));
          ck[i0 + j] = key;
          t_max = max(t_max, key);
        }
        if (++sj == L) { sj = 0; ++vj; }
      }
      s += ds;
      v += dv;
      if (s >= L) { s -= L; ++v; }
    }
    if (n <= top_n) {                     // every row so far is kept
      for (int i = tid; i < n_chunk; i += kThreads) rows[n_sel + i] = c0 + i;
      n_sel = n;
      __syncthreads();
      continue;
    }
    // the floor: top_n of the threads' maxima are keys of distinct rows
    uint32_t least = 0u;
    if (n_chunk >= top_n) {
      const uint64_t c = sort_desc(composite(t_max, tid), kThreads, surv);
      if (tid == top_n - 1) s_floor = static_cast<uint32_t>(c >> 32);
    }
    __syncthreads();
    if (n_chunk >= top_n) least = s_floor;
    uint32_t prefix, mask, need;
    radix_select<true>(keys, n, top_n, least, hist, warp_tot, sel, prefix, mask, need);
    compact(keys, n, top_n, least, prefix, mask, need, surv, kThreads, warp_tot);
    // back into row order: (~position, key) composites sorted descending
    uint64_t c = 0ull;
    if (tid < top_n) {
      const uint64_t sv = surv[tid];
      c = (static_cast<uint64_t>(~static_cast<uint32_t>(position(sv))) << 32) |
          static_cast<uint32_t>(sv >> 32);
    }
    c = sort_desc(c, kThreads, surv);
    int row = 0;
    if (tid < top_n) {
      const int p = static_cast<int>(~static_cast<uint32_t>(c >> 32));
      row = p < n_sel ? rows[p] : c0 + p - n_sel;
    }
    __syncthreads();                      // every read of rows / keys is done
    if (tid < top_n) {
      rows[tid] = row;
      keys[tid] = static_cast<uint32_t>(c);
    }
    n_sel = top_n;
    __syncthreads();
  }

  // videos holding a selected row (rows in order: count where the video changes)
  const int my_row = tid < n_sel ? rows[tid] : 0;
  const int my_vid = my_row / L;
  const int n_videos = __syncthreads_count(
      tid < n_sel && (tid == 0 || rows[tid - 1] / L != my_vid));
  // the element floor: the least selected row best, reached by top_n elements
  if (tid == 0) s_floor = n_sel == top_n ? 0xffffffffu : 0u;
  __syncthreads();
  if (n_sel == top_n && tid < n_sel) atomicMin(&s_floor, keys[tid]);
  __syncthreads();
  const uint32_t least = s_floor;

  // 3. the selected rows' elements, positions j * W + w in flat order
  const int my_s = my_row - my_vid * L;
  if (tid < n_sel) {
    const float st_v = __ldg(st_q + my_row), vs_v = __ldg(vs_q + my_vid);
    for (int w = 0; w < W; ++w) {
      const float val = my_s + min_l + w < L
          ? joint(st_v, __ldg(ed_q + my_row + min_l + w), vs_v) : 0.0f;
      keys[tid * W + w] = order_key(val);
    }
  }
  __syncthreads();
  const int n_el = n_sel * W;
  const int k = min(top_n, n_el);
  if (n_el > k) {
    uint32_t prefix, mask, need;
    radix_select<true>(keys, n_el, k, least, hist, warp_tot, sel, prefix, mask, need);
    compact(keys, n_el, k, least, prefix, mask, need, surv, kThreads, warp_tot);
  } else {
    surv[tid] = tid < n_el ? composite(keys[tid], tid) : 0ull;
    __syncthreads();
  }
  int span = 1;                           // next_pow2(k)
  while (span < k) span <<= 1;
  const uint64_t c = sort_desc(surv[tid], span, surv);

  // decode
  if (tid < top_n) {
    int vid = 0, s = 0, end = min_l;
    float val = 0.0f;
    if (tid < k) {
      const int p = position(c), j = p / W, w = p - j * W;
      const int row = rows[j];
      vid = row / L;
      s = row - vid * L;
      end = s + min_l + w;
      if (end < L) val = joint(__ldg(st_q + row), __ldg(ed_q + row + min_l + w),
                               __ldg(vs_q + vid));
    }
    const long long o = q * top_n + tid;
    out_vid[o] = vid;
    out_st[o] = s;
    out_ed[o] = end;
    out_score[o] = val;
  }
  if (tid == 0) videos[q] = n_videos;
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for a shape outside the kernel's limits (ops/topk.py repeats them).
int tvr_banded_topk(const void* st, const void* ed, const void* vs, int nq, int V, int L,
                    int min_l, int max_l, int top_n, void* out_vid, void* out_st,
                    void* out_ed, void* out_score, void* videos, void* stream)
{
  const int W = max_l - min_l;
  if (nq <= 0 || V <= 0 || L <= 0 || L > kMaxL || min_l < 0 || W <= 0 || W > kMaxW ||
      top_n <= 0 || top_n > kMaxTop ||
      static_cast<long long>(V) * L * W >= static_cast<long long>(kLimit))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_rows = V * L;
  const int chunk = n_rows < kMaxChunk ? n_rows : kMaxChunk;
  // keys: the carried rows and one chunk, or the selected rows' elements
  const int n_sel = n_rows < top_n ? n_rows : top_n;
  const int keys_len = kMaxTop + chunk > n_sel * W ? kMaxTop + chunk : n_sel * W;
  const size_t bytes = static_cast<size_t>(kThreads) * 8 + kWarps * kBins * 4 +
                       kMaxTop * 4 + static_cast<size_t>(keys_len) * 4;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        banded_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  banded_topk_kernel<<<nq, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(st), static_cast<const float*>(ed),
      static_cast<const float*>(vs), V, L, W, min_l, top_n, chunk,
      static_cast<int*>(out_vid), static_cast<int*>(out_st), static_cast<int*>(out_ed),
      static_cast<float*>(out_score), static_cast<int*>(videos));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
