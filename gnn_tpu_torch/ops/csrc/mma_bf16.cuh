// bf16 tensor-core tiles for the bf16-adjacency kernels (loop2_bf16.cu:
// K10_bf16's aggregation adjT^T @ bf(U_a); bn2_bf16.cu: K15_bf16's
// contraction adjT @ bf(dagg)), as tile2.cuh serves the f32 kernels:
// warp-level
// mma.sync.m16n8k16 with bf16 operands and f32 accumulators, fed by ldmatrix
// from shared memory (.trans for an operand staged transposed).
//
// Fragments (PTX ISA, "Matrix Fragments for mma.m16n8k16"), lane l, g = l / 4,
// q = l % 4:
//   A 16x16 (row): a[0] = (g, 2q..2q+1), a[1] = (g+8, 2q..), a[2] = (g, 8+2q..),
//                  a[3] = (g+8, 8+2q..), two bf16 a register, the lower
//                  column in the low half;
//   B 16x8 (col):  b[0] = (k 2q..2q+1, n g), b[1] = (k 8+2q.., n g);
//   C 16x8 (f32):  c[0], c[1] = (g, 2q), (g, 2q+1); c[2], c[3] = (g+8, ...).
// The order in which a tensor core adds a tile's products and the
// accumulator is its own: a sum that is not exact in f32 comes out in
// other bits than the plain versions' term-by-term adds (tools/bf16_order.py
// shows where that matters).
//
// Shared-memory tiles of bf16 rows have a row stride of (a multiple of 16
// bytes) + 16 bytes: the eight 16-byte rows an ldmatrix phase reads then lie
// in eight different bank groups.

#pragma once

#include "common.cuh"

namespace gnn {

// f32 accumulators of a 16x8 tile, += A (16x16 bf16) * B (16x8 bf16).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) rounded to bf16 to nearest even, packed lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// x rounded to bf16 to nearest even, its 16 bits.
__device__ __forceinline__ uint16_t bf16_bits(float x) {
  return static_cast<uint16_t>(pack_bf16(x, 0.0f) & 0xffffu);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// A fragment of rows m0.., columns k0.. of a row-major bf16 tile x [M][ld].
__device__ __forceinline__ void lda_rows(uint32_t (&a)[4], const uint16_t* x, int ld, int m0,
                                         int k0) {
  const int l = threadIdx.x & 31;
  ldsm_x4(a, x + (size_t)(m0 + (l & 7) + ((l >> 3) & 1) * 8) * ld + k0 + (l >> 4) * 8);
}

// A fragment of A = x^T, x a row-major bf16 tile [K][ld] (the adjacency
// staged [src][dst] read as [dst][src]): rows m0.. of A are x's columns.
__device__ __forceinline__ void lda_cols(uint32_t (&a)[4], const uint16_t* x, int ld, int m0,
                                         int k0) {
  const int l = threadIdx.x & 31;
  ldsm_x4_t(a, x + (size_t)(k0 + (l & 7) + (l >> 4) * 8) * ld + m0 + ((l >> 3) & 1) * 8);
}

// B fragments of two n-tiles (n0.., n0+8..) from a row-major bf16 tile
// x [K][ld] (B = x): b[0], b[1] the first tile's, b[2], b[3] the second's.
__device__ __forceinline__ void ldb_rows(uint32_t (&b)[4], const uint16_t* x, int ld, int k0,
                                         int n0) {
  const int l = threadIdx.x & 31;
  ldsm_x4_t(b, x + (size_t)(k0 + (l & 7) + ((l >> 3) & 1) * 8) * ld + n0 + (l >> 4) * 8);
}

// A C tile's entry e: its row (of 16) and column (of 8) within the tile.
__device__ __forceinline__ int c_row(int e) { return ((threadIdx.x & 31) >> 2) + (e >> 1) * 8; }
__device__ __forceinline__ int c_col(int e) { return 2 * (threadIdx.x & 3) + (e & 1); }

// Copy the bf16 [W][W] matrix src into shared rows of W + 8 (16-byte copies).
__device__ inline void stage_padded(uint16_t* dst, const uint16_t* __restrict__ src, int W) {
  const int4* s = reinterpret_cast<const int4*>(src);
  int4* d = reinterpret_cast<int4*>(dst);
  const int rq = W / 8, aq = (W + 8) / 8;
  for (int i = threadIdx.x; i < W * rq; i += blockDim.x) d[(i / rq) * aq + i % rq] = s[i];
}

// Round x up to a multiple of 16 (the tiles' k and padded widths).
__host__ __device__ __forceinline__ int pad16(int x) { return (x + 15) / 16 * 16; }

}  // namespace gnn
