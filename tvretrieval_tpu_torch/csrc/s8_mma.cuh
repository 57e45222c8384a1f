// Tensor-core pieces for Hopper (sm_90a) from the mma.sync generation: the
// s8 x s8 -> s32 m16n8k32, bf16 x bf16 -> f32 m16n8k16 and tf32 x tf32 ->
// f32 m16n8k8 products, which only the ceiling probe (csrc/mma_probe.cu)
// still issues, and what the wgmma kernels take from this file: the
// XOR swizzle of a tile row's 16-byte chunks, ldmatrix fragment loads and
// the 3xTF32 split that keeps f32 accuracy on the tensor cores (the f32
// kinds of the video scores, csrc/video_score.cu B2 / B3, and of the
// masked scores, csrc/masked_score.cu B9 / B10, both on wgmma with
// s8_wgmma.cuh).
//
// Tile layout. A tile holds rows with K contiguous, `row_bytes` a multiple
// of 128 (8 chunks of 16 bytes). Chunk c of row r sits at chunk position c
// ^ (r & 7) of the row, the pattern TMA's 128-byte swizzle writes: the
// eight rows that one ldmatrix 8x8 matrix reads at one logical chunk then
// fall in eight different 16-byte bank groups.
//
// Fragments of mma.m16n8k32.row.col.s32.s8.s8.s32, g = lane / 4, t = lane % 4:
//   A (16 x 32, row-major):  a0 = A[g][4t..4t+3],   a1 = A[g+8][4t..4t+3],
//                            a2 = A[g][16+4t..],    a3 = A[g+8][16+4t..]
//   B (32 x 8, col-major, i.e. 8 rows of 32 K bytes):
//                            b0 = row g, bytes 4t..4t+3; b1 = row g, bytes 16+4t..
//   C (16 x 8 s32):          c0, c1 = C[g][2t], C[g][2t+1]; c2, c3 = C[g+8][2t], C[g+8][2t+1]
// An ldmatrix 8x8 (b16) matrix gives lane l the 4 bytes at row l / 4,
// bytes 4 (l % 4) of a 16-byte chunk, which is exactly one of those
// registers: ldmatrix.x4 fills a whole A fragment.
//
// mma.m16n8k16.row.col.f32.bf16.bf16.f32 has the same fragments in bytes:
// a k-step is 16 bf16 = 32 bytes, a0 = A[g][2t..2t+1] = bytes 4t..4t+3 of
// row g, a2 = bytes 16+4t.., b0 / b1 = row g, bytes 4t.. / 16+4t.., and C
// holds f32 at the same (row, column) places.
//
// mma.m16n8k8.row.col.f32.tf32.tf32.f32 too: a k-step is 8 f32 = 32 bytes,
// a0 = A[g][t] = bytes 4t..4t+3 of row g, a1 = A[g+8][t], a2 = A[g][t+4] =
// bytes 16+4t.., a3 = A[g+8][t+4]; b0 = B[t][g] = row g, bytes 4t..,
// b1 = B[t+4][g] = row g, bytes 16+4t..; C as above. wgmma m64nNk8 with A
// from registers takes the A fragment in this form (s8_wgmma.cuh), which
// one ldmatrix.x4 of a swizzled tile gives (tests/test_torch_kernels_cuda.py
// holds f32 cases whose values are exact in TF32 bit-equal to the plain
// versions, which a wrong pairing of A and B elements would not be).
//
// 3xTF32. The tensor cores take f32 only as TF32 (10 stored mantissa bits;
// they ignore the low 13 bits of the register), which alone would move a
// 256-term unit-vector dot by ~1e-4. The split restores f32 accuracy: each
// operand x splits as hi = rna_tf32(x), lo = rna_tf32(x - hi) (the
// subtraction is exact in f32), and three products hi.hi + hi.lo + lo.hi go
// into the one f32 accumulator, the small ones first (lo.hi, hi.lo, hi.hi).
// The argument:
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
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

}  // namespace s8mma
