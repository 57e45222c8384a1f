// Fused row gather + span similarity for Hopper (sm_90a): the port of
// tvretrieval_tpu/ops/pallas_gather.py::gathered_similarity (_make_kernel,
// :49-157), kernel B7.
//
// What it computes. For every query q and every selected row r = idx[q, v]:
//   sim[q, v, l] = (vq[q] . vf2[r, l] + sq[q] . sf2[r, l]) / 2
// over corpora (N, L, D) in bf16 or f32, the queries already cast to the
// corpus type, each dot accumulated in f32, the two dots rounded apart and
// then averaged. The gathered (Nq, V, L, D) rows never reach device memory;
// the only output is the (Nq, V, L) f32 similarity.
//
// What bounds it on this card, and the design. Bytes: every selected row of
// both corpora is read once (101,000 rows x 2 x 51,200 bytes = 10.3 GB at
// 1,000 queries x 101 rows x 100 clips x 256 bf16) against two
// multiply-adds per 2 or 4 bytes read. The TPU kernel is a ring of row DMAs
// into VMEM feeding an MXU dot per 8 rows; here a block owns one (query,
// row) pair and its 8 warps take the clips in turn. A warp reads a clip's D
// features as 16-byte vectors, one or more per lane (kPieces), against the
// query's same slice held in registers as f32, accumulates in f32 and
// reduces the two dots with shuffles; lane 0 stores the average. The loads
// are streaming (__ldcs): a row is not read again by this block, and there
// are tens of thousands of blocks to keep the memory system busy.
//
// An index outside [0, N) reads nothing: its output row is zeros and the
// counter `bad` goes up by one, for the wrapper's caller to check
// (the choice of csrc/gather.cu).
//
// Exactness. f32 sums in another order than a library product (rounding
// slack); bf16 x bf16 products are exact in f32.
//
// Plain C interface; built by ops/_build.py with nvcc, loaded with ctypes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// a 16-byte piece as f32 values: 8 bf16 (widened by a 16-bit shift) or 4 f32
struct BFloat16 {
  static constexpr int kElems = 8;
  __device__ static void widen(const uint4& w, float (&x)[kElems]) {
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(u[i] << 16);
      x[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
};

struct Float32 {
  static constexpr int kElems = 4;
  __device__ static void widen(const uint4& w, float (&x)[kElems]) {
    x[0] = __uint_as_float(w.x); x[1] = __uint_as_float(w.y);
    x[2] = __uint_as_float(w.z); x[3] = __uint_as_float(w.w);
  }
};

// Sizes in 16-byte vectors: a clip's features are clip_vecs of them, a
// corpus row n_clips * clip_vecs, a query clip_vecs. kPieces * 32 >=
// clip_vecs. idx: (nq * v1,) int32; out: (nq * v1, n_clips) f32.
template <class T, int kPieces>
__global__ void __launch_bounds__(kThreads)
gathered_sim_kernel(const uint4* __restrict__ qv, const uint4* __restrict__ qs,
                    const uint4* __restrict__ vf2, const uint4* __restrict__ sf2,
                    const int* __restrict__ idx, long long n_rows, int v1, int n_clips,
                    int clip_vecs, float* __restrict__ out, int* __restrict__ bad)
{
    const long long pair = blockIdx.x;              // q * v1 + v
    const long long q = pair / v1;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

    const long long row = idx[pair];
    float* dst = out + pair * n_clips;
    if (row < 0 || row >= n_rows) {
        if (threadIdx.x == 0) atomicAdd(bad, 1);
        for (int l = threadIdx.x; l < n_clips; l += kThreads) dst[l] = 0.0f;
        return;
    }

    // this lane's slice of the two query vectors, as f32 in registers
    float qa[kPieces][T::kElems], qb[kPieces][T::kElems];
#pragma unroll
    for (int p = 0; p < kPieces; ++p) {
        const int piece = lane + 32 * p;
        uint4 a = make_uint4(0u, 0u, 0u, 0u), b = a;
        if (piece < clip_vecs) {
            a = qv[q * clip_vecs + piece];
            b = qs[q * clip_vecs + piece];
        }
        T::widen(a, qa[p]);
        T::widen(b, qb[p]);
    }

    const long long row_vecs = static_cast<long long>(n_clips) * clip_vecs;
    const uint4* vrow = vf2 + row * row_vecs;
    const uint4* srow = sf2 + row * row_vecs;
#pragma unroll 2
    for (int l = warp; l < n_clips; l += kWarps) {
        const uint4* vc = vrow + static_cast<long long>(l) * clip_vecs;
        const uint4* sc = srow + static_cast<long long>(l) * clip_vecs;
        uint4 fa[kPieces], fb[kPieces];
#pragma unroll
        for (int p = 0; p < kPieces; ++p) {
            const int piece = lane + 32 * p;
            fa[p] = make_uint4(0u, 0u, 0u, 0u);
            fb[p] = fa[p];
            if (piece < clip_vecs) {
                fa[p] = __ldcs(vc + piece);
                fb[p] = __ldcs(sc + piece);
            }
        }
        float sv = 0.0f, ss = 0.0f;
#pragma unroll
        for (int p = 0; p < kPieces; ++p) {
            float xa[T::kElems], xb[T::kElems];
            T::widen(fa[p], xa);
            T::widen(fb[p], xb);
#pragma unroll
            for (int e = 0; e < T::kElems; ++e) {
                sv = fmaf(qa[p][e], xa[e], sv);
                ss = fmaf(qb[p][e], xb[e], ss);
            }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            sv += __shfl_xor_sync(0xffffffffu, sv, off);
            ss += __shfl_xor_sync(0xffffffffu, ss, off);
        }
        if (lane == 0) dst[l] = __fadd_rn(sv, ss) / 2.0f;
    }
}

template <class T>
cudaError_t launch(const void* qv, const void* qs, const void* vf2, const void* sf2,
                   const void* idx, long long n_rows, long long n_pairs, int v1, int n_clips,
                   int clip_vecs, void* out, void* bad, cudaStream_t stream)
{
    const unsigned grid = static_cast<unsigned>(n_pairs);
#define TVR_GATHERED_SIM(P)                                                              \
    gathered_sim_kernel<T, P><<<grid, kThreads, 0, stream>>>(                            \
        static_cast<const uint4*>(qv), static_cast<const uint4*>(qs),                    \
        static_cast<const uint4*>(vf2), static_cast<const uint4*>(sf2),                  \
        static_cast<const int*>(idx), n_rows, v1, n_clips, clip_vecs,                    \
        static_cast<float*>(out), static_cast<int*>(bad))
    if (clip_vecs <= 32) TVR_GATHERED_SIM(1);
    else if (clip_vecs <= 64) TVR_GATHERED_SIM(2);
    else if (clip_vecs <= 128) TVR_GATHERED_SIM(4);
    else if (clip_vecs <= 256) TVR_GATHERED_SIM(8);
    else return cudaErrorInvalidValue;
#undef TVR_GATHERED_SIM
    return cudaGetLastError();
}

}  // namespace

// kind: 1 bf16, 2 f32 (the numbering of tvr_video_scores). qv / qs: (nq, D);
// vf2 / sf2: (n_rows, n_clips, D); idx: (nq, v1) int32; out: (nq, v1,
// n_clips) f32; bad: one int32 on the device. clip_bytes = D * itemsize, a
// multiple of 16 and at most 4,096 (ops/gather.py::MAX_CLIP_BYTES).
extern "C" int tvr_gathered_similarity(int kind, const void* qv, const void* qs,
                                       const void* vf2, const void* sf2, const void* idx,
                                       long long n_rows, int nq, int v1, int n_clips,
                                       int clip_bytes, void* out, void* bad, void* stream)
{
    if (nq <= 0 || v1 <= 0) return (int)cudaSuccess;
    const long long n_pairs = (long long)nq * v1;
    if (n_rows <= 0 || n_clips <= 0 || clip_bytes <= 0 || clip_bytes % 16 ||
        n_pairs > 2147483647LL)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (kind == 1)
        return (int)launch<BFloat16>(qv, qs, vf2, sf2, idx, n_rows, n_pairs, v1, n_clips,
                                     clip_bytes / 16, out, bad, s);
    if (kind == 2)
        return (int)launch<Float32>(qv, qs, vf2, sf2, idx, n_rows, n_pairs, v1, n_clips,
                                    clip_bytes / 16, out, bad, s);
    return (int)cudaErrorInvalidValue;
}
