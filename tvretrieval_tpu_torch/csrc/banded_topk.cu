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
// scores (f32), each (Nq, top_n). An out-of-band zero keeps its real flat
// index and can be returned; when the joint has fewer than top_n elements
// the rest decode to score 0, indices (0, 0, min_l), like the padding of
// the plain version.
//
// What bounds it on this card, and the design. The inputs are small (80 MB
// at 1,000 queries x 100 videos x 100 clips); the time goes to selection.
// The TPU kernel sorts every video's 2,048-slot tile that can displace the
// worst of a 256-entry buffer and merges its top 256 in. Here a block owns
// a query and keeps the running top 256 sorted in shared memory. Per video
// every thread builds its share of the tile and keeps only the elements
// that beat the buffer's top_n-th entry (no later element with a larger
// index can do more than tie it): they are compacted into shared memory
// with one warp-aggregated counter. A video with no such element costs one
// barrier. Otherwise only the candidates are sorted (a bitonic network over
// the next power of two, usually a few dozen), and their best 256, stored
// ascending behind the descending buffer, make a bitonic sequence that one
// 512-wide merge turns into the new buffer. All comparisons are on (float
// value, index) pairs, so 0.0 and -0.0 tie and fall to the index.
//
// Exactness. Comparisons and moves of values computed by two __fmul_rn:
// equal to the plain version in all four outputs, ties included.
//
// Limits: L <= 128, W <= 16 (a tile of at most 2,048), top_n <= 256,
// V * L * W < 2^30 (the initial buffer entries carry indices from 2^30).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (tvretrieval_tpu_torch/ops/_build.py). C interface, loaded with
// ctypes; the entry point returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxL = 128;
constexpr int kMaxW = 16;
constexpr int kTile = kMaxL * kMaxW;     // 2,048 candidates at most per video
constexpr int kBuf = 256;                // running top-K buffer; top_n <= kBuf
constexpr int kSentinel = 1 << 30;

__device__ __forceinline__ bool before(float v, int i, float pv, int pi) {
  return v > pv || (v == pv && i < pi);
}

// one compare-exchange: the better pair goes to `lo` when `forward`
__device__ __forceinline__ void exchange(float* vals, int* idx, int lo, int hi, bool forward) {
  const float vl = vals[lo], vh = vals[hi];
  const int il = idx[lo], ih = idx[hi];
  const bool swap = forward ? before(vh, ih, vl, il) : before(vl, il, vh, ih);
  if (swap) {
    vals[lo] = vh; vals[hi] = vl;
    idx[lo] = ih; idx[hi] = il;
  }
}

// st, ed: (nq, V, L); vs: (nq, V). out_*: (nq, top_n). sorted: (nq,), the
// number of videos of each query whose candidates were sorted and merged.
__global__ void __launch_bounds__(kThreads)
banded_topk_kernel(const float* __restrict__ st, const float* __restrict__ ed,
                   const float* __restrict__ vs, int V, int L, int W, int min_l, int top_n,
                   int* __restrict__ out_vid, int* __restrict__ out_st,
                   int* __restrict__ out_ed, float* __restrict__ out_score,
                   int* __restrict__ sorted)
{
  __shared__ float rows[2][2][kMaxL];     // [parity][st / ed][clip]
  __shared__ float cand_v[kTile];
  __shared__ int cand_i[kTile];
  __shared__ float buf_v[2 * kBuf];       // [0, kBuf): the buffer, best first;
  __shared__ int buf_i[2 * kBuf];         // [kBuf, 2 kBuf): the merge's other half
  __shared__ int count[3];                // candidates of video v in count[v % 3]

  const int tid = threadIdx.x, lane = tid & 31;
  const long long q = blockIdx.x;
  const float* st_q = st + q * V * L;
  const float* ed_q = ed + q * V * L;
  const float* vs_q = vs + q * V;
  const int tile = L * W;

  // the buffer starts with -inf entries whose indices lose every tie
  for (int p = tid; p < kBuf; p += kThreads) {
    buf_v[p] = -INFINITY;
    buf_i[p] = kSentinel + p;
  }
  if (tid < L) rows[0][0][tid] = st_q[tid];
  else if (tid >= kMaxL && tid - kMaxL < L) rows[0][1][tid - kMaxL] = ed_q[tid - kMaxL];
  if (tid < 3) count[tid] = 0;
  __syncthreads();

  int n_sorted = 0;
  for (int v = 0; v < V; ++v) {
    const int cur = v & 1;
    int* n_cand = count + v % 3;
    if (tid == 0) count[(v + 1) % 3] = 0;
    // the next video's rows travel while this one is worked on
    float next = 0.0f;
    const bool has_next = v + 1 < V;
    if (has_next) {
      if (tid < L) next = st_q[(v + 1) * L + tid];
      else if (tid >= kMaxL && tid - kMaxL < L) next = ed_q[(v + 1) * L + tid - kMaxL];
    }
    const float score = vs_q[v];
    const float worst_v = buf_v[top_n - 1];
    const int worst_i = buf_i[top_n - 1];
    const float* st_row = rows[cur][0];
    const float* ed_row = rows[cur][1];

    // build the tile; keep what beats the buffer's top_n-th entry
    for (int e0 = 0; e0 < tile; e0 += kThreads) {
      const int e = e0 + tid;
      bool take = false;
      float val = 0.0f;
      int flat = 0;
      if (e < tile) {
        const int s = e / W, w = e - s * W;
        const int end = s + min_l + w;
        if (end < L) val = __fmul_rn(__fmul_rn(st_row[s], ed_row[end]), score);
        flat = v * tile + e;
        take = before(val, flat, worst_v, worst_i);
      }
      const unsigned votes = __ballot_sync(0xffffffffu, take);
      if (votes) {
        int base = 0;
        if (lane == 0) base = atomicAdd(n_cand, __popc(votes));
        base = __shfl_sync(0xffffffffu, base, 0);
        if (take) {
          const int pos = base + __popc(votes & ((1u << lane) - 1u));
          cand_v[pos] = val;
          cand_i[pos] = flat;
        }
      }
    }
    if (has_next) {
      if (tid < L) rows[cur ^ 1][0][tid] = next;
      else if (tid >= kMaxL && tid - kMaxL < L) rows[cur ^ 1][1][tid - kMaxL] = next;
    }
    __syncthreads();

    const int n = *n_cand;                  // the same in every thread
    if (n == 0) continue;
    ++n_sorted;
    int padded = 2;
    while (padded < n) padded <<= 1;
    for (int p = n + tid; p < padded; p += kThreads) {
      cand_v[p] = -INFINITY;
      cand_i[p] = INT_MAX;
    }
    __syncthreads();
    // bitonic sort of the candidates, best first
    const int half = padded >> 1;
    for (int size = 2; size <= padded; size <<= 1) {
      for (int j = size >> 1; j > 0; j >>= 1) {
        for (int t = tid; t < half; t += kThreads) {
          const int lo = ((t & ~(j - 1)) << 1) | (t & (j - 1));
          exchange(cand_v, cand_i, lo, lo | j, (lo & size) == 0);
        }
        __syncthreads();
      }
    }
    // their best kBuf, worst first, behind the buffer: [best first ; worst
    // first] is bitonic, and a forward merge sorts it best first
    const int kept = padded < kBuf ? padded : kBuf;
    for (int p = tid; p < kBuf; p += kThreads) {
      const int src = kBuf - 1 - p;
      buf_v[kBuf + p] = src < kept ? cand_v[src] : -INFINITY;
      buf_i[kBuf + p] = src < kept ? cand_i[src] : INT_MAX;
    }
    __syncthreads();
    for (int j = kBuf; j > 0; j >>= 1) {
      for (int t = tid; t < kBuf; t += kThreads) {
        const int lo = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        exchange(buf_v, buf_i, lo, lo | j, true);
      }
      __syncthreads();
    }
  }

  // decode; entries the joint could not fill (still -inf) become zeros
  for (int p = tid; p < top_n; p += kThreads) {
    float val = buf_v[p];
    int flat = buf_i[p];
    if (!(val > -INFINITY)) { val = 0.0f; flat = 0; }
    const int vid = flat / tile, rem = flat - vid * tile;
    const int s = rem / W;
    const long long o = q * top_n + p;
    out_vid[o] = vid;
    out_st[o] = s;
    out_ed[o] = s + min_l + (rem - s * W);
    out_score[o] = val;
  }
  if (tid == 0) sorted[q] = n_sorted;
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for a shape outside the kernel's limits (ops/topk.py repeats them).
int tvr_banded_topk(const void* st, const void* ed, const void* vs, int nq, int V, int L,
                    int min_l, int max_l, int top_n, void* out_vid, void* out_st,
                    void* out_ed, void* out_score, void* sorted, void* stream)
{
  const int W = max_l - min_l;
  if (nq <= 0 || V <= 0 || L <= 0 || L > kMaxL || min_l < 0 || W <= 0 || W > kMaxW ||
      top_n <= 0 || top_n > kBuf ||
      static_cast<long long>(V) * L * W >= static_cast<long long>(kSentinel))
    return static_cast<int>(cudaErrorInvalidValue);
  banded_topk_kernel<<<nq, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(st), static_cast<const float*>(ed),
      static_cast<const float*>(vs), V, L, W, min_l, top_n, static_cast<int*>(out_vid),
      static_cast<int*>(out_st), static_cast<int*>(out_ed),
      static_cast<float*>(out_score), static_cast<int*>(sorted));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
