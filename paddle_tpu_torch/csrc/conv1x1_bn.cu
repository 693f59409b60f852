// conv1x1_stats — kernel 9: a 1x1 stride-1 convolution over NHWC pixel rows
// with the per-channel batch-norm statistics of its output.
//
// Replaces paddle_tpu/ops/pallas_conv1x1_bn.py::_kernel (pallas_call in _run):
//
//   y[m, n] = sum_k x[m, k] * w[n, k] + b[n]        (accumulated in float32)
//   s[n]    = sum_m y[m, n]
//   q[n]    = sum_m y[m, n]^2                        (of the stored y)
//
//   x [M, K]  row-major: the [B*H*W, C] view of a contiguous NHWC activation
//   w [N, K]  row-major: the conv parameter as stored (OIHW flattened), so
//             the product is x . w^T and no transposed copy is made
//   b [N]     or null (ResNet's convs have no bias)
//
// What bounds it: at ResNet-50's shapes (M = 4,096 .. 207,936 rows, K and N
// 64 .. 2048) 2.0-6.8 GFLOP against 35-266 MB a launch, so mostly the float32
// rate (67 TFLOP/s, ~0.1 ms); the widest stage-2 shapes sit near the ridge,
// where the bytes count as much (3.35 TB/s, ~0.08 ms).
//
// Design. The TPU kernel walks a sequential grid and keeps sum and sumsq in
// one resident output block; on Hopper the blocks run in parallel, so:
//  1. conv1x1_stats_tile: a register-tiled SGEMM on the CUDA cores. One block
//     of 256 threads owns a 128 x 64 tile of y and walks K in slices of 16,
//     both operand slices staged in shared memory (transposed, so a thread
//     reads its 8 rows and 4 columns as float4s), the next slice prefetched
//     into registers while the current one is multiplied. Each thread holds
//     8 x 4 outputs. The epilogue adds b, stores the tile, and reduces the
//     tile's column sums and sums of squares over its 128 rows through
//     shared memory in a fixed order into one partial row per tile:
//     part[tile, 0, n] and part[tile, 1, n].
//  2. conv1x1_stats_reduce: sums the partials over the tiles, 32 columns a
//     block, each of 32 warps a fixed subset of tiles, then the 32 warp sums
//     in order. No atomics anywhere, so two launches give the same bits.
// Ragged edges (M, N and K not multiples of the tile) are masked; rows past M
// add nothing to the statistics. Tensor cores, wgmma and TMA are later work.
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128;                 // rows of y per block
constexpr int kBN = 64;                  // columns of y per block
constexpr int kBK = 16;                  // depth of one staged slice
constexpr int kTM = 8;                   // rows per thread
constexpr int kTN = 4;                   // columns per thread
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);   // 256
constexpr int kPad = 4;                  // keeps float4 alignment, spreads banks
constexpr int kReduceWarps = 32;

static_assert(kBM * kBK == 2 * 4 * kThreads, "two float4 of x per thread");
static_assert(kBN * kBK == 4 * kThreads, "one float4 of w per thread");

__device__ __forceinline__ float4 load4(const float* __restrict__ p, long long row,
                                        long long rows, int k, int K, bool vec) {
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (row >= rows) return v;
  const float* r = p + row * K;
  if (vec) {                             // K % 4 == 0 and 16-byte aligned rows
    if (k < K) v = *reinterpret_cast<const float4*>(r + k);
  } else {
    if (k + 0 < K) v.x = r[k + 0];
    if (k + 1 < K) v.y = r[k + 1];
    if (k + 2 < K) v.z = r[k + 2];
    if (k + 3 < K) v.w = r[k + 3];
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
conv1x1_stats_tile(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ b, float* __restrict__ y,
                   float* __restrict__ part, int M, int K, int N, int vec) {
  __shared__ __align__(16) float xs[kBK][kBM + kPad];
  __shared__ __align__(16) float ws[kBK][kBN + kPad];
  __shared__ float red[2][kBM / kTM][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN);      // columns n0 + 4 tx .. + 3
  const int ty = tid / (kBN / kTN);      // rows    m0 + 8 ty .. + 7
  const long long m0 = static_cast<long long>(blockIdx.y) * kBM;
  const int n0 = blockIdx.x * kBN;
  const bool v = vec != 0;

  // this thread's share of each slice: x rows lr, lr + 64 and w row lr,
  // all at depth offset lc (four threads cover a row's 16 values)
  const int lr = tid / (kBK / 4);
  const int lc = (tid % (kBK / 4)) * 4;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

  float4 xa, xb, wa;
  auto fetch = [&](int k0) {
    xa = load4(x, m0 + lr, M, k0 + lc, K, v);
    xb = load4(x, m0 + lr + kBM / 2, M, k0 + lc, K, v);
    wa = load4(w, n0 + lr, N, k0 + lc, K, v);
  };
  auto stage = [&]() {
    xs[lc + 0][lr] = xa.x; xs[lc + 1][lr] = xa.y; xs[lc + 2][lr] = xa.z; xs[lc + 3][lr] = xa.w;
    xs[lc + 0][lr + kBM / 2] = xb.x; xs[lc + 1][lr + kBM / 2] = xb.y;
    xs[lc + 2][lr + kBM / 2] = xb.z; xs[lc + 3][lr + kBM / 2] = xb.w;
    ws[lc + 0][lr] = wa.x; ws[lc + 1][lr] = wa.y; ws[lc + 2][lr] = wa.z; ws[lc + 3][lr] = wa.w;
  };

  fetch(0);
  stage();
  __syncthreads();
  for (int k0 = 0; k0 < K; k0 += kBK) {
    const bool more = k0 + kBK < K;
    if (more) fetch(k0 + kBK);           // in flight while this slice multiplies
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&xs[kk][ty * kTM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&xs[kk][ty * kTM + 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&ws[kk][tx * kTN]);
      const float a[kTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bb[kTN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    __syncthreads();
    if (more) {
      stage();
      __syncthreads();
    }
  }

  // epilogue: bias, store, and this thread's column sums over its rows
  const int nc = n0 + tx * kTN;
  float bias[kTN], cs[kTN], cq[kTN];
#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    bias[j] = (b != nullptr && nc + j < N) ? b[nc + j] : 0.0f;
    cs[j] = 0.0f;
    cq[j] = 0.0f;
  }
  const bool vec_store = (N % 4 == 0) && (nc + kTN <= N);
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const long long row = m0 + ty * kTM + i;
    if (row >= M) break;
    float o[kTN];
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      o[j] = acc[i][j] + bias[j];
      cs[j] += o[j];
      cq[j] = fmaf(o[j], o[j], cq[j]);
    }
    float* dst = y + row * N + nc;
    if (vec_store) {
      *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int j = 0; j < kTN; ++j)
        if (nc + j < N) dst[j] = o[j];
    }
  }
#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    red[0][ty][tx * kTN + j] = cs[j];
    red[1][ty][tx * kTN + j] = cq[j];
  }
  __syncthreads();
  if (tid < 2 * kBN) {
    const int stat = tid / kBN, col = tid % kBN;
    if (n0 + col < N) {
      float total = 0.0f;
#pragma unroll
      for (int r = 0; r < kBM / kTM; ++r) total += red[stat][r][col];
      part[(static_cast<long long>(blockIdx.y) * 2 + stat) * N + n0 + col] = total;
    }
  }
}

// s and q from part [tiles, 2, N]: column c of the 2N (s then q) is summed
// over the tiles by lane c % 32 of each warp, warp w taking tiles w, w + 32,
// ..., then the warps' sums in order.
__global__ void __launch_bounds__(32 * kReduceWarps)
conv1x1_stats_reduce(const float* __restrict__ part, float* __restrict__ s,
                     float* __restrict__ q, int tiles, int N) {
  __shared__ float red[kReduceWarps][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  const int two_n = 2 * N;
  float acc = 0.0f;
  if (c < two_n) {
#pragma unroll 4
    for (int t = threadIdx.y; t < tiles; t += kReduceWarps)
      acc += part[static_cast<long long>(t) * two_n + c];
  }
  red[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && c < two_n) {
    float total = 0.0f;
#pragma unroll
    for (int i = 0; i < kReduceWarps; ++i) total += red[i][threadIdx.x];
    if (c < N) s[c] = total;
    else q[c - N] = total;
  }
}

}  // namespace

// Launch both kernels on `stream`. part is scratch of ceil(M / 128) * 2 * N
// floats; vec != 0 promises K % 4 == 0 and 16-byte aligned x and w. Returns
// cudaGetLastError().
extern "C" int conv1x1_stats(const void* x, const void* w, const void* b, void* y,
                             void* s, void* q, void* part, int M, int K, int N,
                             int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (M + kBM - 1) / kBM;
  if (M > 0 && N > 0) {
    const dim3 grid((N + kBN - 1) / kBN, tiles);   // n fastest: a row tile's
    conv1x1_stats_tile<<<grid, kThreads, 0, st>>>(  // blocks run together, x from L2
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(b), static_cast<float*>(y), static_cast<float*>(part),
        M, K, N, vec);
  }
  if (N > 0) {
    const dim3 grid((2 * N + 31) / 32);
    conv1x1_stats_reduce<<<grid, dim3(32, kReduceWarps), 0, st>>>(
        static_cast<const float*>(part), static_cast<float*>(s), static_cast<float*>(q),
        tiles, N);
  }
  return static_cast<int>(cudaGetLastError());
}
