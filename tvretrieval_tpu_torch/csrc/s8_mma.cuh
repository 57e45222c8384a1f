// Tensor-core tiles for Hopper (sm_90a) through mma.sync: asynchronous
// 16-byte copies into XOR-swizzled shared-memory tiles, ldmatrix fragment
// loads, and the s8 x s8 -> s32 m16n8k32, bf16 x bf16 -> f32 m16n8k16 and
// tf32 x tf32 -> f32 m16n8k8 products, the last as a 3xTF32 split that
// keeps f32 accuracy. Shared by the bf16 and f32 video-score kernels
// (csrc/video_score.cu, B2 / B3), the masked video scores
// (csrc/masked_score.cu, B9 / B10 in bf16 and f32) and the ceiling probe
// (csrc/mma_probe.cu, which alone still issues the s8 product: the int8
// kernels B1 / B3-int8 and B5 run on wgmma, s8_wgmma.cuh).
//
// Tile layout. A tile holds rows of int8 with K contiguous, `row_bytes` a
// multiple of 128 (8 chunks of 16 bytes). Chunk c of row r sits at chunk
// position c ^ (r & 7) of the row: the eight rows that one ldmatrix 8x8
// matrix reads at one logical chunk then fall in eight different 16-byte
// bank groups, where a plain 256-byte row stride would put all eight in one.
//
// Fragments of mma.m16n8k32.row.col.s32.s8.s8.s32, g = lane / 4, t = lane % 4:
//   A (16 x 32, row-major):  a0 = A[g][4t..4t+3],   a1 = A[g+8][4t..4t+3],
//                            a2 = A[g][16+4t..],    a3 = A[g+8][16+4t..]
//   B (32 x 8, col-major, i.e. 8 rows of 32 K bytes):
//                            b0 = row g, bytes 4t..4t+3; b1 = row g, bytes 16+4t..
//   C (16 x 8 s32):          c0, c1 = C[g][2t], C[g][2t+1]; c2, c3 = C[g+8][2t], C[g+8][2t+1]
// An ldmatrix 8x8 (b16) matrix gives lane l the 4 bytes at row l / 4,
// bytes 4 (l % 4) of a 16-byte chunk, which is exactly one of those
// registers: ldmatrix.x4 fills a whole A fragment, or two B fragments.
//
// mma.m16n8k16.row.col.f32.bf16.bf16.f32 has the same fragments in bytes:
// a k-step is 16 bf16 = 32 bytes, a0 = A[g][2t..2t+1] = bytes 4t..4t+3 of
// row g, a2 = bytes 16+4t.., b0 / b1 = row g, bytes 4t.. / 16+4t.., and C
// holds f32 at the same (row, column) places.
//
// mma.m16n8k8.row.col.f32.tf32.tf32.f32 too: a k-step is 8 f32 = 32 bytes,
// a0 = A[g][t] = bytes 4t..4t+3 of row g, a1 = A[g+8][t], a2 = A[g][t+4] =
// bytes 16+4t.., a3 = A[g+8][t+4]; b0 = B[t][g] = row g, bytes 4t..,
// b1 = B[t+4][g] = row g, bytes 16+4t..; C as above. So a k-step is 32
// bytes and the fragments have the same byte layout in all three products:
// the tiles, the swizzle and the fragment addresses below serve them
// unchanged (tests/test_torch_kernels_cuda.py holds an f32 case whose
// values are exact in TF32 bit-equal to the plain version, which a wrong
// pairing of A and B elements would not be).
//
// 3xTF32. The tensor cores take f32 only as TF32 (10 stored mantissa bits;
// they ignore the low 13 bits of the register), which alone would move a
// 256-term unit-vector dot by ~1e-4. mma_tf32x3 restores f32 accuracy:
// each operand x splits as hi = rna_tf32(x), lo = rna_tf32(x - hi) (the
// subtraction is exact in f32), and three products hi.hi + hi.lo + lo.hi go
// into the one f32 accumulator, the small ones first. The argument:
//  1. hi carries 11 significant bits, so |x - hi| <= 2^-11 |x|, and lo
//     rounds x - hi to 11 bits again, |x - hi - lo| <= 2^-22 |x|; the
//     dropped lo.lo term and those roundings leave a.b - (hi_a hi_b +
//     hi_a lo_b + lo_a hi_b) within about 3 2^-22 |a| |b|;
//  2. a TF32 x TF32 product (11 x 11 significant bits) is exact in f32;
//  3. for the engine's L2-normalized rows sum |a_i b_i| <= 1, so the split
//     adds at most ~7e-7 to the f32 summation-order slack every f32 kernel
//     has (<= (D - 1) 2^-24 at worst, ~ sqrt(D) 2^-24 in practice);
//  4. nothing is summed in reduced precision: no split-K, no TF32 partial
//     sums; each product lands in the f32 accumulator.
// So the f32 kernels stay held to 1e-5 of their f32 plain versions
// (tests/test_torch_mma_order.py models the split and the order on the
// CPU, and shows that one TF32 product alone exceeds that bound).
#pragma once

#include <stdint.h>

namespace s8mma {

// byte offset of logical 16-byte chunk `chunk` of tile row `row`
__device__ __forceinline__ uint32_t swizzle(int row, int chunk, int row_bytes) {
  return static_cast<uint32_t>(row * row_bytes + ((chunk ^ (row & 7)) << 4));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; src_bytes = 0 writes zeros
// (rows past the end, the K tail) and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// lane `lane`'s address for the A fragment of k-step `kk` (32 bytes) of
// the 16 tile rows from `row0`: matrices (rows 0-7, 8-15) x (bytes 0-15,
// 16-31), in a0..a3 order
__device__ __forceinline__ uint32_t a_frag_addr(uint32_t tile, int row0, int kk, int lane,
                                                int row_bytes) {
  return tile + swizzle(row0 + (lane & 15), 2 * kk + (lane >> 4), row_bytes);
}

// lane `lane`'s address for the B fragments of k-step `kk` of two n8
// fragments, tile rows row0..row0+7 and row0+8..row0+15: the x4 load gives
// (b0, b1) of the first in r[0], r[1] and of the second in r[2], r[3]
__device__ __forceinline__ uint32_t b_frag_pair_addr(uint32_t tile, int row0, int kk,
                                                     int lane, int row_bytes) {
  return tile + swizzle(row0 + ((lane >> 4) << 3) + (lane & 7), 2 * kk + ((lane >> 3) & 1),
                        row_bytes);
}

// c += a . b over one k-step of 32 bytes
__device__ __forceinline__ void mma(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b over one k-step of 16 bf16, f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to TF32 (nearest, ties away from zero), the low 13 bits zero:
// cvt.rna.tf32.f32 for finite x, in the integer form the compiler emits for
// it (half a TF32 ulp added to the magnitude bits, then truncated) without
// its test for inf and NaN, which the normalized features never hold
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// the f32 in x as hi + lo, both TF32
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(__uint_as_float(x));
  lo = to_tf32(__fsub_rn(__uint_as_float(x), __uint_as_float(hi)));
}

// c += a . b over one k-step of 8 TF32, f32 accumulation
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b over one k-step of 8 f32 with f32 accuracy, from the split
// fragments (split_tf32 of each register): lo.hi, hi.lo, then hi.hi
__device__ __forceinline__ void mma_tf32x3(float (&c)[4], const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4], const uint32_t (&b_hi)[2],
                                           const uint32_t (&b_lo)[2]) {
  mma_tf32(c, a_lo, b_hi[0], b_hi[1]);
  mma_tf32(c, a_hi, b_lo[0], b_lo[1]);
  mma_tf32(c, a_hi, b_hi[0], b_hi[1]);
}

// The warp-tile step of the kernels that use these tiles: one warp's MF m16
// fragments (query-tile rows a_row0 .. a_row0 + 16 MF - 1) by NF n8
// fragments (ring-tile rows b_row0 .. b_row0 + 8 NF - 1) over the k-steps
// of one ring step, the query tile's k-step ka0 + kk against the ring's kk.
// P is the product: P::kSplit (f32 fragments, each register split once a
// k-step, B's across the m16 fragments and A's across the n8 ones, then
// mma_tf32x3), else P::mma, one instruction a fragment pair.

// the fragments of k-step kk
template <int MF, int NF>
__device__ __forceinline__ void load_warp_frags(uint32_t (&a)[MF][4], uint32_t (&b)[NF][2],
                                                uint32_t qa, int a_row0, int ka, int a_rb,
                                                uint32_t fb, int b_row0, int kk, int b_rb,
                                                int lane) {
#pragma unroll
  for (int mi = 0; mi < MF; ++mi)
    ldmatrix_x4(a[mi], a_frag_addr(qa, a_row0 + mi * 16, ka, lane, a_rb));
#pragma unroll
  for (int np = 0; np < NF / 2; ++np) {
    uint32_t r[4];
    ldmatrix_x4(r, b_frag_pair_addr(fb, b_row0 + np * 16, kk, lane, b_rb));
    b[2 * np][0] = r[0];
    b[2 * np][1] = r[1];
    b[2 * np + 1][0] = r[2];
    b[2 * np + 1][1] = r[3];
  }
}

// acc += a . b over one k-step, every fragment pair
template <class P, int MF, int NF, class Acc>
__device__ __forceinline__ void mma_warp_frags(Acc (&acc)[MF][NF][4], const uint32_t (&a)[MF][4],
                                               const uint32_t (&b)[NF][2]) {
  if constexpr (P::kSplit) {
    uint32_t b_hi[NF][2], b_lo[NF][2];
#pragma unroll
    for (int ni = 0; ni < NF; ++ni)
#pragma unroll
      for (int j = 0; j < 2; ++j) split_tf32(b[ni][j], b_hi[ni][j], b_lo[ni][j]);
#pragma unroll
    for (int mi = 0; mi < MF; ++mi) {
      uint32_t a_hi[4], a_lo[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) split_tf32(a[mi][j], a_hi[j], a_lo[j]);
#pragma unroll
      for (int ni = 0; ni < NF; ++ni) mma_tf32x3(acc[mi][ni], a_hi, a_lo, b_hi[ni], b_lo[ni]);
    }
  } else {
#pragma unroll
    for (int mi = 0; mi < MF; ++mi)
#pragma unroll
      for (int ni = 0; ni < NF; ++ni) P::mma(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
  }
}

// the whole ring step. KS > 0: KS k-steps, unrolled; with Bufs = 2 the
// fragments of k-step kk + 1 load under k-step kk's products (Bufs = 1
// where the split halves leave no registers for a second set). KS = 0:
// n_kk k-steps counted at run time, one set of fragments.
template <class P, int KS, int Bufs, int MF, int NF, class Acc>
__device__ __forceinline__ void warp_tile_step(Acc (&acc)[MF][NF][4], uint32_t qa, int a_row0,
                                               int ka0, int a_rb, uint32_t fb, int b_row0,
                                               int b_rb, int lane, int n_kk) {
  static_assert(Bufs == 1 || Bufs == 2, "one or two sets of fragments");
  uint32_t a[Bufs][MF][4], b[Bufs][NF][2];
  if constexpr (KS > 0 && Bufs == 2) {
    load_warp_frags(a[0], b[0], qa, a_row0, ka0, a_rb, fb, b_row0, 0, b_rb, lane);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if (kk + 1 < KS)
        load_warp_frags(a[(kk + 1) & 1], b[(kk + 1) & 1], qa, a_row0, ka0 + kk + 1, a_rb, fb,
                        b_row0, kk + 1, b_rb, lane);
      mma_warp_frags<P>(acc, a[kk & 1], b[kk & 1]);
    }
  } else if constexpr (KS > 0) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      load_warp_frags(a[0], b[0], qa, a_row0, ka0 + kk, a_rb, fb, b_row0, kk, b_rb, lane);
      mma_warp_frags<P>(acc, a[0], b[0]);
    }
  } else {
#pragma unroll 1
    for (int kk = 0; kk < n_kk; ++kk) {
      load_warp_frags(a[0], b[0], qa, a_row0, ka0 + kk, a_rb, fb, b_row0, kk, b_rb, lane);
      mma_warp_frags<P>(acc, a[0], b[0]);
    }
  }
}

}  // namespace s8mma
