// mma_bf16.cuh — bf16 mma.sync (m16n8k16, float32 accumulation) and the
// operand loads of the recurrence bodies for Hopper (lstm_bwd_sm90.cu,
// attention_gru_bwd_sm90.cu).
//
// Fragments of mma.m16n8k16.row.col (g = lane / 4, t = lane % 4):
//   A [16 x 16]: a0 (row g, k 2t..2t+1), a1 (row g + 8, k 2t..), a2 (row g,
//                k 2t + 8..), a3 (row g + 8, k 2t + 8..), two bf16 a register
//                (the lower k in the lower half);
//   B [16 x 8]:  b0 (k 2t..2t+1, column g), b1 (k 2t + 8.., column g);
//   C [16 x 8]:  c0, c1 (row g, columns 2t, 2t + 1), c2, c3 (row g + 8).
//
// Permuted k. A product's sum over k does not care which k a fragment
// position stands for, as long as A and B agree. Over a chunk of 32
// consecutive k, lane (g, t) takes the 16 contiguous bytes k = 8t .. 8t + 7
// of its rows of A and of its column of B, and feeds them to two mmas:
// bytes 0-3 and 4-7 as the first mma's (2t, 2t + 1) and (2t + 8, 2t + 9),
// bytes 8-11 and 12-15 as the second's. So an operand row is read as whole
// 16-byte vectors (four lanes cover 64 contiguous bytes of a row), with no
// shuffle and no ldmatrix: chunk32 below.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace mmabf16 {

// d += a . b on the tensor cores, bf16 operands, float32 sums.
__device__ __forceinline__ void mma(float (&d)[4], unsigned a0, unsigned a1, unsigned a2,
                                    unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One 32-k chunk of the permuted product: ra, rb the 16 bytes of rows g and
// g + 8 of A, w the 16 bytes of column g of B, all at k = 8t .. 8t + 7 of
// the chunk (two mmas).
__device__ __forceinline__ void chunk32(float (&d)[4], const uint4& ra, const uint4& rb,
                                        const uint4& w) {
  mma(d, ra.x, rb.x, ra.y, rb.y, w.x, w.y);
  mma(d, ra.z, rb.z, ra.w, rb.w, w.z, w.w);
}

// Four 8 x 8 bf16 matrices from shared memory, transposed: lane l gives the
// address of row l % 8 of matrix l / 8; register q receives, of matrix q,
// the elements (rows 2t, 2t + 1; column g) of the stored rows: the A or B
// fragment of a product whose k runs down the stored rows.
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ uint4 zero4() { return make_uint4(0u, 0u, 0u, 0u); }

// 16 bytes through L2 (rows other blocks of the launch wrote).
__device__ __forceinline__ uint4 ldcg16(const void* p) {
  return __ldcg(reinterpret_cast<const uint4*>(p));
}

}  // namespace mmabf16
