// Byte-row gather for the GPU-resident training corpus, for Hopper (sm_90a).
//
// Replaces tvretrieval_tpu/ops/pallas_gather.py::gather_byte_rows
// (_make_byte_gather_kernel): out[b] = table[idx[b]] for rows of raw bytes,
// the indices read on the device, duplicates allowed, no copy of the table.
//
// What bounds it on this card is bytes: every gathered row is read once and
// written once (2 x B x row_bytes), and nothing is computed. The TPU kernel
// issues 8 row DMAs per grid step and waits for them; here the grid is
// (row, 16 KiB segment of the row), so a batch of 128 rows of 308,224 bytes
// is 2,432 independent blocks, each thread holding 4 x 16-byte loads in
// flight before it stores. Rows are 1,024-byte multiples and the wrapper
// checks 16-byte alignment, so every access is an aligned uint4. The loads
// are streaming (a table row is touched once); the stores are plain, since
// the caller reads the batch back at once.
//
// An index outside [0, n_rows) reads nothing: its output row is zeros and
// the counter `bad` goes up by one, for the wrapper's caller to check.
//
// Plain C interface; built by ops/_build.py with nvcc, loaded with ctypes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecsPerThread = 4;
constexpr int kSegVecs = kThreads * kVecsPerThread;   // 16 KiB per block

__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const uint4* __restrict__ table, const int* __restrict__ idx,
                   uint4* __restrict__ out, long long n_rows, long long row_vecs,
                   int* __restrict__ bad)
{
    const int b = blockIdx.x;
    const long long row = idx[b];
    const bool ok = row >= 0 && row < n_rows;
    if (!ok && blockIdx.y == 0 && threadIdx.x == 0) atomicAdd(bad, 1);

    const uint4* src = table + (ok ? row : 0) * row_vecs;
    uint4* dst = out + (long long)b * row_vecs;
    const long long v0 = (long long)blockIdx.y * kSegVecs + threadIdx.x;

    uint4 r[kVecsPerThread];
#pragma unroll
    for (int i = 0; i < kVecsPerThread; ++i) {
        const long long v = v0 + (long long)i * kThreads;
        r[i] = make_uint4(0u, 0u, 0u, 0u);
        if (ok && v < row_vecs) r[i] = __ldcs(src + v);
    }
#pragma unroll
    for (int i = 0; i < kVecsPerThread; ++i) {
        const long long v = v0 + (long long)i * kThreads;
        if (v < row_vecs) dst[v] = r[i];
    }
}

}  // namespace

// table: (n_rows, row_bytes) bytes; idx: (n_idx,) int32 on the device;
// out: (n_idx, row_bytes) bytes; bad: one int32 on the device.
extern "C" int tvr_gather_byte_rows(const void* table, const void* idx, void* out,
                                    long long n_rows, int n_idx, long long row_bytes,
                                    void* bad, void* stream)
{
    if (n_idx <= 0) return (int)cudaSuccess;
    if (n_rows <= 0 || row_bytes <= 0 || row_bytes % 16) return (int)cudaErrorInvalidValue;
    const long long row_vecs = row_bytes / 16;
    const long long segs = (row_vecs + kSegVecs - 1) / kSegVecs;
    if (segs > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)n_idx, (unsigned)segs);
    gather_rows_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint4*)table, (const int*)idx, (uint4*)out, n_rows, row_vecs, (int*)bad);
    return (int)cudaGetLastError();
}
