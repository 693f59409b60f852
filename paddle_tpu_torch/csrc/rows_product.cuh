// rows_product.cuh — the weight gradient of a recurrence body for Hopper,
// summed off its sequential loop: C [M][N] = A^T . (Bhi + Blo) over all
// rows n, with A [rows][M] (the steps' h_prev, bf16) and Bhi, Blo [rows][N]
// a float32 gradient as two bf16 pieces (hi = bf16(g), lo = bf16(g - hi)),
// so that the products keep ~16 bits of g as the float32 sums of the Pallas
// kernels need. lstm_bwd_sm90.cu (dW) and attention_gru_bwd_sm90.cu (dWa)
// launch it after their loops.
//
// A block takes a tile of 128 rows m of C x 64 columns (blockIdx.y,
// blockIdx.x), its eight warps 32 x 32 each, on mma.sync m16n8k16 bf16 with
// both operands read by ldmatrix.trans from a 3-stage cp.async ring of 64
// rows n a stage (rows padded so that ldmatrix reads without conflicts).
// The tensor core's float32 accumulation truncates: over thousands of
// rows in one accumulator that drift reached 31 bf16 spacings of the LSTM's
// dW at T B = 16,384 rows (H100), so each 128 rows' products are summed in
// registers of their own and added to the tile's sums with one rounded add.
// Every sum runs in a fixed order: two launches give the same bits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "mma_bf16.cuh"

namespace rowsprod {

constexpr int kThreads = 256;
constexpr int kBM = 128, kBN = 64, kBK = 64, kStages = 3;
constexpr int kFlush = 2;                            // stages a partial sums apart
constexpr int kLdA = kBM + 8, kLdB = kBN + 8;        // padded rows of the staged tiles
constexpr int kStage = kBK * kLdA + 2 * kBK * kLdB;  // bf16 values of a stage
constexpr size_t kSmem = 2ull * kStages * kStage;    // the dynamic shared memory a block needs

__device__ __forceinline__ void store2(float* c, float x, float y) {
  *reinterpret_cast<float2*>(c) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* c, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(c) = __floats2bfloat162_rn(x, y);
}

// The block's tile of C (Out float or bf16, row stride ldc, written once).
// lda, ldb, ldc and N multiples of 8 and 64 (N), the bases 16-byte aligned;
// rows past `rows` and columns m past M read as 0. Needs kSmem bytes of
// dynamic shared memory (`smem`) and kThreads threads.
template <typename Out>
__device__ __forceinline__ void tile(const __nv_bfloat16* __restrict__ A, long long lda, int M,
                                     const __nv_bfloat16* __restrict__ Bhi,
                                     const __nv_bfloat16* __restrict__ Blo, long long ldb,
                                     int rows, Out* __restrict__ C, long long ldc,
                                     __nv_bfloat16* smem) {
  using bf16 = __nv_bfloat16;
  const int j0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp % 4, wn = warp / 4;              // the warp's 32 x 32 of the tile
  const int g = lane >> 2, tq = lane & 3;
  const int nk = (rows + kBK - 1) / kBK;
  // stage c's rows of A (the tile's m) and of Bhi, Blo (its columns) into
  // slot `slot`
  auto load = [&](int c, int slot) {
    bf16* sa = smem + slot * kStage;
    bf16* sh = sa + kBK * kLdA;
    bf16* sl = sh + kBK * kLdB;
    const int n0 = c * kBK;
    for (int i = tid; i < kBK * (kBM / 8); i += kThreads) {
      const int r = i / (kBM / 8), e = i % (kBM / 8);
      const bool ok = n0 + r < rows && m0 + 8 * e < M;
      const bf16* src = ok ? A + static_cast<long long>(n0 + r) * lda + m0 + 8 * e : A;
      cp_async16_cg(reinterpret_cast<float*>(sa + r * kLdA + 8 * e),
                    reinterpret_cast<const float*>(src), ok);
    }
    for (int i = tid; i < kBK * (kBN / 8); i += kThreads) {
      const int r = i / (kBN / 8), e = i % (kBN / 8);
      const bool ok = n0 + r < rows;
      const long long off = ok ? static_cast<long long>(n0 + r) * ldb + j0 + 8 * e : 0;
      cp_async16_cg(reinterpret_cast<float*>(sh + r * kLdB + 8 * e),
                    reinterpret_cast<const float*>(Bhi + off), ok);
      cp_async16_cg(reinterpret_cast<float*>(sl + r * kLdB + 8 * e),
                    reinterpret_cast<const float*>(Blo + off), ok);
    }
  };
  float acc[2][4][4], part[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = part[mi][ni][e] = 0.0f;
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < nk) load(c, c);
    cp_async_commit();
  }
  const int lr = lane % 8, lq = lane / 8;              // ldmatrix: row lr of matrix lq
  for (int c = 0; c < nk; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                                   // stage c landed; slot c - 1 is free
    if (c + kStages - 1 < nk) load(c + kStages - 1, (c + kStages - 1) % kStages);
    cp_async_commit();
    const bf16* sa = smem + (c % kStages) * kStage;
    const bf16* sh = sa + kBK * kLdA;
    const bf16* sl = sh + kBK * kLdB;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      unsigned a[2][4], bh[2][4], bl[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)      // A^T [m][n] from the stored [n][m]
        mmabf16::ldmatrix_x4_trans(
            a[mi], sa + (kk + lr + 8 * (lq >> 1)) * kLdA + wm * 32 + 16 * mi + 8 * (lq & 1));
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {    // B [n][column] as stored, two n8 tiles each
        const int off = (kk + lr + 8 * (lq & 1)) * kLdB + wn * 32 + 16 * nj + 8 * (lq >> 1);
        mmabf16::ldmatrix_x4_trans(bh[nj], sh + off);
        mmabf16::ldmatrix_x4_trans(bl[nj], sl + off);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int nj = ni / 2, h = 2 * (ni % 2);
          mmabf16::mma(part[mi][ni], a[mi][0], a[mi][1], a[mi][2], a[mi][3], bh[nj][h],
                       bh[nj][h + 1]);
          mmabf16::mma(part[mi][ni], a[mi][0], a[mi][1], a[mi][2], a[mi][3], bl[nj][h],
                       bl[nj][h + 1]);
        }
    }
    if ((c + 1) % kFlush == 0 || c + 1 == nk) {         // uniform over the block
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[mi][ni][e] += part[mi][ni][e];
            part[mi][ni][e] = 0.0f;
          }
    }
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int m = m0 + wm * 32 + 16 * mi + g;
      const int j = j0 + wn * 32 + 8 * ni + 2 * tq;
      if (m < M) store2(C + static_cast<long long>(m) * ldc + j, acc[mi][ni][0], acc[mi][ni][1]);
      if (m + 8 < M)
        store2(C + static_cast<long long>(m + 8) * ldc + j, acc[mi][ni][2], acc[mi][ni][3]);
    }
}

// The grid of tiles over C [M][N].
inline dim3 grid(int M, int N) { return dim3(N / kBN, (M + kBM - 1) / kBM); }

}  // namespace rowsprod
