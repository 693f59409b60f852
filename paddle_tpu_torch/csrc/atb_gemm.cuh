// atb — C = A^T . B over N rows, the weight-gradient contraction of the
// backward kernels (dW of the LSTM, dba / dv of the attention GRU).
//
//   C[k, j] = sum_n A(n, k) * B[n, j]              k < K, j < J
//   A(n, k) = a1[n, k] * a2[n, k]   (a2 may be null: A = a1; a1 null: A = 1)
//
// With a1 null and K = 1 it is a column sum. Rows are read with their
// leading dimension, so a column slice of a wider row (the candidate third
// of dx3, the reset gate inside acts) needs no copy.
//
// What bounds it: at the LSTM's shapes (N = T*B = 16384, K = 512,
// J = 2048) 34 GFLOP against 0.2 GB read, so the float32 rate (67 TFLOP/s).
// The design is the plain shared-memory tiled product: a 64 x 64 tile of C
// per block, 256 threads holding 4 x 4 sums each, the N axis walked in
// slices of 16 rows staged in shared memory. Every C element is summed by
// one thread in a fixed order, so the result is deterministic — no atomics.
#pragma once

#include <cuda_runtime.h>

namespace atb_detail {

constexpr int kTile = 64;
constexpr int kDepth = 16;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
atb_kernel(const float* __restrict__ a1, long long lda1,
           const float* __restrict__ a2, long long lda2,
           const float* __restrict__ bm, long long ldb,
           float* __restrict__ c, long long ldc, int N, int K, int J) {
  __shared__ float as[kDepth][kTile];
  __shared__ float bs[kDepth][kTile];
  const int k0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % 16;      // columns j0 + tx + 16 * jj
  const int ty = threadIdx.x / 16;      // rows    k0 + ty + 16 * i
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0.0f;

  for (int n0 = 0; n0 < N; n0 += kDepth) {
    for (int e = threadIdx.x; e < kDepth * kTile; e += kThreads) {
      const int nn = e / kTile, col = e % kTile;
      const long long n = n0 + nn;
      float av = 0.0f, bv = 0.0f;
      if (n < N) {
        if (k0 + col < K) {
          av = a1 ? a1[n * lda1 + k0 + col] : 1.0f;
          if (a2) av *= a2[n * lda2 + k0 + col];
        }
        if (j0 + col < J) bv = bm[n * ldb + j0 + col];
      }
      as[nn][col] = av;
      bs[nn][col] = bv;
    }
    __syncthreads();
#pragma unroll
    for (int nn = 0; nn < kDepth; ++nn) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[nn][ty + 16 * i];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) b[jj] = bs[nn][tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[i][jj] = fmaf(a[i], b[jj], acc[i][jj]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty + 16 * i;
    if (k >= K) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = j0 + tx + 16 * jj;
      if (j < J) c[k * ldc + j] = acc[i][jj];
    }
  }
}

}  // namespace atb_detail

// Launch C = A^T . B on `stream` (see above); returns cudaGetLastError().
inline cudaError_t atb(const float* a1, long long lda1, const float* a2, long long lda2,
                       const float* bm, long long ldb, float* c, long long ldc,
                       int N, int K, int J, cudaStream_t stream) {
  using namespace atb_detail;
  if (K > 0 && J > 0) {
    const dim3 grid((J + kTile - 1) / kTile, (K + kTile - 1) / kTile);
    atb_kernel<<<grid, kThreads, 0, stream>>>(a1, lda1, a2, lda2, bm, ldb, c, ldc, N, K, J);
  }
  return cudaGetLastError();
}
