// Exact stable top-k of every row for Hopper (sm_90a): the port of
// tvretrieval_tpu/ops/pallas_sort.py::topk_transposed (_make_kernel,
// _stage, _compound_gt, :56-216), kernel B6.
//
// What it computes. x is (nq, n) f32. For every row the k best elements
// under the compound order of _compound_gt, value descending and then
// index ascending: (v, i) comes before (pv, pi) iff v > pv, or v == pv and
// i < pi. That is lax.top_k's stable order. Values come back as f32,
// indices as int32 clamped to n - 1.
//
// What bounds it on this card, and the design. The rows are short (the
// engine's are 1,250 to 2,800 long), so the bytes are few and the time goes
// to the exchange network. The TPU kernel sorts 128 queries in lockstep
// down the sublane axis, because a lane-crossing exchange is the expensive
// direction there; on this card a block's shared memory holds a whole row,
// so one block sorts one row: it loads the row as (value, index) pairs
// padded to a power of two with (-inf, position), runs the full bitonic
// network in shared memory, one compare-exchange per thread and step, and
// writes the first k pairs. The pads carry positions >= n, so the
// compound order puts them after every real element, real -inf included.
// The truncating merge-and-discard schedule of the TPU kernel saves
// compile size and VMEM there; here the full sort of a padded row is
// 78 steps at 4,096 elements. Rows of up to 16,384 elements fit (128 KiB of
// pairs; above 48 KiB the entry point opts in to the large carve-out);
// the wrapper splits longer rows into chunks and launches twice.
//
// Exactness. Only comparisons and moves: equal to a stable descending
// sort in values and indices. NaNs are unordered and land anywhere.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (tvretrieval_tpu_torch/ops/_build.py). C interface, loaded with
// ctypes; the entry point returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxPadded = 16384;       // 128 KiB of (value, index) pairs

__device__ __forceinline__ bool before(float v, int i, float pv, int pi) {
  return v > pv || (v == pv && i < pi);
}

// x: (nq, n); out_v / out_i: (nq, k); n_pad: n rounded up to a power of
// two (>= 2).
__global__ void topk_sort_kernel(const float* __restrict__ x, int n, int n_pad, int k,
                                 float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* vals = reinterpret_cast<float*>(smem);
  int* idx = reinterpret_cast<int*>(smem + sizeof(float) * n_pad);

  const float* row = x + static_cast<size_t>(blockIdx.x) * n;
  for (int p = threadIdx.x; p < n_pad; p += blockDim.x) {
    vals[p] = p < n ? row[p] : -INFINITY;
    idx[p] = p;
  }
  __syncthreads();

  const int half = n_pad >> 1;
  for (int size = 2; size <= n_pad; size <<= 1) {
    for (int j = size >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < half; t += blockDim.x) {
        const int lo = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const int hi = lo | j;
        const float vl = vals[lo], vh = vals[hi];
        const int il = idx[lo], ih = idx[hi];
        // forward blocks ((lo & size) == 0) keep the better element low
        const bool forward = (lo & size) == 0;
        const bool swap = forward ? before(vh, ih, vl, il) : before(vl, il, vh, ih);
        if (swap) {
          vals[lo] = vh; vals[hi] = vl;
          idx[lo] = ih; idx[hi] = il;
        }
      }
      __syncthreads();
    }
  }

  float* ov = out_v + static_cast<size_t>(blockIdx.x) * k;
  int* oi = out_i + static_cast<size_t>(blockIdx.x) * k;
  for (int p = threadIdx.x; p < k; p += blockDim.x) {
    ov[p] = vals[p];
    oi[p] = min(idx[p], n - 1);
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for a shape the kernel does not take (0 < k <= n <= 16,384, which
// ops/sort.py::MAX_ROW repeats).
int tvr_topk_sort(const void* x, int nq, int n, int k, void* out_v, void* out_i,
                  void* stream) {
  if (nq <= 0 || n <= 0 || k <= 0 || k > n || n > kMaxPadded)
    return static_cast<int>(cudaErrorInvalidValue);
  int n_pad = 2;
  while (n_pad < n) n_pad <<= 1;
  const size_t bytes = static_cast<size_t>(n_pad) * (sizeof(float) + sizeof(int));
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        topk_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kMaxPadded * (sizeof(float) + sizeof(int))));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int threads = n_pad / 2;
  if (threads > kMaxThreads) threads = kMaxThreads;
  if (threads < 32) threads = 32;
  topk_sort_kernel<<<nq, threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n, n_pad, k, static_cast<float*>(out_v),
      static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
