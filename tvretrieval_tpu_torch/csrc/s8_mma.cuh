// Tensor-core tiles for Hopper (sm_90a) through mma.sync: asynchronous
// 16-byte copies into XOR-swizzled shared-memory tiles, ldmatrix fragment
// loads, and the s8 x s8 -> s32 m16n8k32 and bf16 x bf16 -> f32 m16n8k16
// products. Shared by the video-score kernels (csrc/video_score.cu, B1 /
// B2 / B3 in int8 and bf16) and the int8 span sweep (csrc/span_sim.cu, B5).
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
// holds f32 at the same (row, column) places. So the tiles, the swizzle
// and the fragment addresses below serve both products unchanged.
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

}  // namespace s8mma
