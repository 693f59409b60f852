// persistent_grid.cuh — the pieces shared by the persistent, weight-
// stationary recurrence kernels (the attention-GRU forward of
// attention_gru_fwd.cuh, attention_gru_bwd.cu, gru_fwd.cu, gru_bwd.cu,
// lstm_fwd.cu, lstm_bwd.cu): a cooperative launch, a grid
// barrier, and the block products of all B rows with a weight slice held
// in shared memory.
//
// Layout every kernel here keeps: 256 threads (8 warps) a block, one block
// on each SM it uses. A block product walks the rows in tiles of 64, eight
// rows to a warp; the lanes of a warp split the contraction axis k (lane,
// lane + 32, ...), so each row of X is read from L2 as whole 128-byte
// lines and the weight slice W [K][N] is read from shared memory, N
// floats of one k a lane. The 32 lanes' partial sums of the warp's 8 x N
// outputs are summed by a butterfly that halves the values each lane holds
// at every shuffle (8N - 8N/32 shuffles, not 5 * 8N), in a fixed order:
// two launches on the same inputs give the same bits. No atomics.
#pragma once

#include <cuda_runtime.h>

#include "common.cuh"

namespace pgrid {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 8;
constexpr int kRowTile = kWarps * kRowsPerWarp;   // rows of one pass of a block product
constexpr int kUnits = 4;                         // hidden units in a unit group
constexpr int kERows = 8;                         // rows of wctx in an e-group (backward)
// the shared memory a block may opt into on sm_90 (227 KB)
constexpr size_t kSmemLimit = 232448;

// The card's nanosecond clock (for phase timings).
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned ld_acquire_gpu(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// A barrier across every block of a cooperative launch, or across the
// `blocks` blocks that share `counter` when it is set (a part of the grid
// that waits on no other part). `counter` is zeroed before the launch and
// only ever grows: the n-th barrier of a block waits until it reads
// n * blocks. Every write a block made before sync() is visible to every
// block after it, if the reader reads through L2 (__ldcg): the L1 of an SM
// is not coherent with the other SMs' writes.
struct GridBarrier {
  unsigned* counter;
  unsigned passed;
  unsigned blocks = 0;   // 0: every block of the grid

  __device__ __forceinline__ void sync() {
    __syncthreads();
    ++passed;
    if (threadIdx.x == 0) {
      __threadfence();
      atomicAdd(counter, 1u);
      const unsigned target = passed * (blocks != 0 ? blocks : gridDim.x);
      while (ld_acquire_gpu(counter) < target) {
      }
      __threadfence();
    }
    __syncthreads();
  }
};

// One butterfly step after another: with V values a lane, the lanes whose
// bit O is set keep the upper half, the others the lower half, each adding
// the half its partner sends. After the steps for O = 16 .. 1 lane L holds
// the full sums of the flattened indices (V / 32) * L + j, j < V / 32.
template <int V, int O>
struct Halve {
  static __device__ __forceinline__ void run(float* v, int lane) {
    constexpr int H = V / 2;
    const bool upper = (lane & O) != 0;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float send = upper ? v[i] : v[i + H];
      const float keep = upper ? v[i + H] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    Halve<H, O / 2>::run(v, lane);
  }
};

template <int V>
struct Halve<V, 0> {
  static __device__ __forceinline__ void run(float*, int) {}
};

// acc[r][c] += sum over this lane's k of X[row0 + r, k] * W[k][c]; rows at
// or past nrows read as 0. X was written by other blocks of this launch,
// so it is read through L2. X is float or bf16 (widened on load); with
// kRound a float X is rounded to bf16 first (a bf16 product operand kept
// unrounded for another use).
template <int N, bool kRound = false, typename TX>
__device__ __forceinline__ void accumulate(float (&acc)[kRowsPerWarp][N], const TX* X,
                                           long long ldx, int row0, int nrows, int K,
                                           const float* W) {
  static_assert(N % 4 == 0, "W rows are read as float4");
  const int lane = threadIdx.x & 31;
  const TX* xr[kRowsPerWarp];
  bool ok[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    ok[r] = row0 + r < nrows;
    xr[r] = X + static_cast<long long>(ok[r] ? row0 + r : 0) * ldx;
  }
#pragma unroll 8
  for (int k = lane; k < K; k += 32) {
    float x[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float v = ok[r] ? ldcg_f32(xr[r] + k) : 0.0f;
      x[r] = kRound ? round_bf16(v) : v;
    }
    const float4* w4 = reinterpret_cast<const float4*>(W + static_cast<long long>(k) * N);
    float w[N];
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 f = w4[q];
      w[4 * q] = f.x;
      w[4 * q + 1] = f.y;
      w[4 * q + 2] = f.z;
      w[4 * q + 3] = f.w;
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int c = 0; c < N; ++c) acc[r][c] = fmaf(x[r], w[c], acc[r][c]);
  }
}

// out[b * ldo + c] = sum_k X[b, k] W[k][c] (+ sum_k X2[b, k] W2[k][c] when
// X2 is given) for every b < nrows and c < N, out in shared memory. W and
// W2 are [K][N] and [K2][N] slices in shared memory. X and X2 are float or
// bf16; kRound2 rounds a float X2 to bf16 as it is read. The caller
// synchronises the block before reading out.
template <int N, bool kRound2 = false, typename TX = float, typename TX2 = float>
__device__ __forceinline__ void block_product(float* out, int ldo, int nrows,
                                              const TX* X, long long ldx, int K,
                                              const float* W,
                                              const TX2* X2 = nullptr, long long ldx2 = 0,
                                              int K2 = 0, const float* W2 = nullptr) {
  constexpr int kPer = kRowsPerWarp * N / 32;
  static_assert(kRowsPerWarp * N % 32 == 0, "the butterfly leaves whole values a lane");
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int b0 = 0; b0 < nrows; b0 += kRowTile) {
    const int row0 = b0 + warp * kRowsPerWarp;
    if (row0 >= nrows) continue;                   // uniform over the warp
    float acc[kRowsPerWarp][N];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int c = 0; c < N; ++c) acc[r][c] = 0.0f;
    accumulate<N>(acc, X, ldx, row0, nrows, K, W);
    if (X2 != nullptr) accumulate<N, kRound2>(acc, X2, ldx2, row0, nrows, K2, W2);
    Halve<kRowsPerWarp * N, 16>::run(&acc[0][0], lane);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int f = kPer * lane + j;
      const int r = f / N, c = f % N;
      if (row0 + r < nrows) out[(row0 + r) * ldo + c] = (&acc[0][0])[j];
    }
  }
}

// For a slice of 4 output columns (a unit group), two contractions of the
// same rows X [nrows, K] at once:
//   out(b, c) = sum_k X[b, k] W[k][c]     handed to epi(b, c, value), once
//                                         for every b < nrows, c < 4;
//   DW[k][c] += sum_b S[b][c] X[b, k]      for every k < K.
// X was written by other blocks of this launch, so it is read through L2;
// W and DW ([K][4]) lie in shared memory or in device memory that only
// this block touches, S ([nrows][4]) in shared memory. Thread tid takes
// kCols columns k = kb + tid + 256 u of each batch of 256 kCols (a warp
// reads 32 neighbouring floats of a row), holds their W and DW rows in
// registers over all the rows, and adds the rows kRows at a time, in
// order; every element of DW has one owner. All kCols x kRows loads of a
// chunk are issued before any is used, and nothing is stored to device
// memory inside the loop, so they stay in flight together: a chunk costs
// one L2 round trip and its FMAs, so more rows a chunk mean fewer round
// trips a phase (as many as the registers hold). The product's partial
// sums are summed over the lanes by the butterfly and over the column
// batches and the warps through `red` ([kWarps][kRowTile][4] floats), in
// a fixed order: two launches give the same bits. With kRoundX the
// product takes X rounded to bf16 and DW's sums take it unrounded (the
// bf16 GRU backward: its products read dg and dcand in bf16, its dW sums
// them in float32). Returns with the block synchronised.
template <int kCols, int kRows, bool kRoundX = false, typename Epi>
__device__ __forceinline__ void product_colsum4(const float* X, long long ldx, int nrows, int K,
                                                const float* W, const float* S, float* DW,
                                                float* red, Epi epi) {
  static_assert(kRowTile % kRows == 0 && kRows * 4 % 32 == 0, "whole chunks, whole lanes");
  constexpr int kPer = kRows * 4 / 32;            // sums a lane holds after the butterfly
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float4* W4 = reinterpret_cast<const float4*>(W);
  const float4* S4 = reinterpret_cast<const float4*>(S);
  float4* DW4 = reinterpret_cast<float4*>(DW);
  for (int tile0 = 0; tile0 < nrows; tile0 += kRowTile) {
    const int rows = min(kRowTile, nrows - tile0);
    for (int kb = 0; kb < K; kb += kThreads * kCols) {
      bool kok[kCols];
      float w[kCols][4], d[kCols][4];
#pragma unroll
      for (int u = 0; u < kCols; ++u) {
        const int k = kb + tid + kThreads * u;
        kok[u] = k < K;
        const float4 wv = kok[u] ? W4[k] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        const float4 dv = kok[u] ? DW4[k] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        w[u][0] = wv.x; w[u][1] = wv.y; w[u][2] = wv.z; w[u][3] = wv.w;
        d[u][0] = dv.x; d[u][1] = dv.y; d[u][2] = dv.z; d[u][3] = dv.w;
      }
      const float* xk = X + kb + tid;
      for (int r0 = 0; r0 < rows; r0 += kRows) {
        const int b0 = tile0 + r0;
        float x[kCols][kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const bool ok = b0 + r < nrows;
          const float* xr = xk + static_cast<long long>(ok ? b0 + r : 0) * ldx;
#pragma unroll
          for (int u = 0; u < kCols; ++u)
            x[u][r] = ok && kok[u] ? __ldcg(xr + kThreads * u) : 0.0f;
        }
        float acc[kRows][4];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float4 sv = b0 + r < nrows ? S4[b0 + r] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          const float sr[4] = {sv.x, sv.y, sv.z, sv.w};
          float xa[kCols];
#pragma unroll
          for (int u = 0; u < kCols; ++u) xa[u] = kRoundX ? round_bf16(x[u][r]) : x[u][r];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float a = 0.0f;
#pragma unroll
            for (int u = 0; u < kCols; ++u) {
              a = fmaf(xa[u], w[u][c], a);
              d[u][c] = fmaf(sr[c], x[u][r], d[u][c]);
            }
            acc[r][c] = a;
          }
        }
        Halve<kRows * 4, 16>::run(&acc[0][0], lane);
        // lane L now holds the warp's sums of rows r0 + f / 4, columns f % 4,
        // for f = kPer L + j
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          float* rp = red + (warp * kRowTile + r0) * 4 + kPer * lane + j;
          *rp = kb == 0 ? (&acc[0][0])[j] : *rp + (&acc[0][0])[j];
        }
      }
#pragma unroll
      for (int u = 0; u < kCols; ++u) {
        const int k = kb + tid + kThreads * u;
        if (kok[u]) DW4[k] = make_float4(d[u][0], d[u][1], d[u][2], d[u][3]);
      }
    }
    __syncthreads();
    for (int i = tid; i < rows * 4; i += kThreads) {
      float v = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += red[w * kRowTile * 4 + i];
      epi(tile0 + i / 4, i % 4, v);
    }
    __syncthreads();
  }
}

// product_colsum4 over N output columns (the units of one or more unit
// groups, N a multiple of 4), with X staged through shared memory:
//   out(b, c) = sum_k X[b, k] W[k][c] to epi(b, c, value), c < N;
//   DW[k][c] += sum_b S[b][c] X[b, k],
// W and DW [K][N], S [nrows][N]. X is read once for all N columns: the
// rows of a chunk (kRows rows, the 256 kCols columns of a column batch)
// are copied by cp.async into a ring of kStages slots ([kRows][256 kCols]
// floats each, `ring`), kStages - 1 chunks ahead of the one the threads
// multiply, so the L2 round trips of the next chunks overlap the FMAs and
// the butterfly of this one (product_colsum4 issues a chunk's loads and
// then waits on them, with nothing to do meanwhile). The sums run in the
// same fixed order. X, ldx and K must allow 16-byte copies: X 16-byte
// aligned, ldx and K multiples of 4. The cross-warp sums take
// [kWarps][kRowTile][N] floats of `red`. With kRoundX the product takes X
// rounded to bf16 and DW's sums take it unrounded (the bf16 LSTM backward:
// its product with w transposed reads the gate gradients in bf16, its dW
// sums them in float32). Returns with the block synchronised; with
// nrows = 0 it does nothing.
template <int N, int kCols, int kRows, int kStages, bool kRoundX = false, typename Epi>
__device__ __forceinline__ void product_colsum_staged(const float* X, long long ldx, int nrows,
                                                      int K, const float* W, const float* S,
                                                      float* DW, float* red, float* ring,
                                                      Epi epi) {
  static_assert(N % 4 == 0, "rows of W, S and DW are read as float4");
  static_assert(kRowTile % kRows == 0 && kRows * N % 32 == 0, "whole chunks, whole lanes");
  static_assert(kStages >= 2, "a chunk in flight while one is multiplied");
  constexpr int kPer = kRows * N / 32;            // sums a lane holds after the butterfly
  constexpr int kQ = N / 4;                       // float4s of a row of W, S or DW
  constexpr int kWidth = kThreads * kCols;        // columns of a batch
  constexpr int kSlot = kRows * kWidth;           // floats of a ring slot
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float4* W4 = reinterpret_cast<const float4*>(W);
  const float4* S4 = reinterpret_cast<const float4*>(S);
  float4* DW4 = reinterpret_cast<float4*>(DW);
  for (int tile0 = 0; tile0 < nrows; tile0 += kRowTile) {
    const int rows = min(kRowTile, nrows - tile0);
    const int chunks = (rows + kRows - 1) / kRows;
    for (int kb = 0; kb < K; kb += kWidth) {
      // chunk c's rows of this column batch into slot c % kStages, 16 bytes
      // a copy; rows past nrows and columns past K read as 0
      auto issue = [&](int c) {
        const int b0 = tile0 + c * kRows;
        float* dst = ring + (c % kStages) * kSlot;
        for (int i = tid; i < kSlot / 4; i += kThreads) {
          const int r = i / (kWidth / 4), col = 4 * (i % (kWidth / 4));
          const bool ok = b0 + r < nrows && kb + col < K;
          cp_async16_cg(dst + r * kWidth + col,
                        ok ? X + static_cast<long long>(b0 + r) * ldx + kb + col : X, ok);
        }
      };
      bool kok[kCols];
      float w[kCols][N], d[kCols][N];
#pragma unroll
      for (int u = 0; u < kCols; ++u) {
        const int k = kb + tid + kThreads * u;
        kok[u] = k < K;
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          const float4 wv = kok[u] ? W4[k * kQ + q] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          const float4 dv = kok[u] ? DW4[k * kQ + q] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          w[u][4 * q] = wv.x; w[u][4 * q + 1] = wv.y; w[u][4 * q + 2] = wv.z; w[u][4 * q + 3] = wv.w;
          d[u][4 * q] = dv.x; d[u][4 * q + 1] = dv.y; d[u][4 * q + 2] = dv.z; d[u][4 * q + 3] = dv.w;
        }
      }
      for (int c = 0; c < kStages - 1; ++c) {
        if (c < chunks) issue(c);
        cp_async_commit();
      }
      for (int c = 0; c < chunks; ++c) {
        // chunk c has landed (kStages - 2 later ones may still be in
        // flight), every thread sees it, and every thread is done with
        // chunk c - 1, whose slot chunk c + kStages - 1 takes
        cp_async_wait<kStages - 2>();
        __syncthreads();
        if (c + kStages - 1 < chunks) issue(c + kStages - 1);
        cp_async_commit();
        const float* xs = ring + (c % kStages) * kSlot + tid;
        const int r0 = c * kRows;
        const int b0 = tile0 + r0;
        float x[kCols][kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int u = 0; u < kCols; ++u) x[u][r] = xs[r * kWidth + kThreads * u];
        float acc[kRows][N];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          float sr[N];
#pragma unroll
          for (int q = 0; q < kQ; ++q) {
            const float4 sv = b0 + r < nrows ? S4[(b0 + r) * kQ + q]
                                             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            sr[4 * q] = sv.x; sr[4 * q + 1] = sv.y; sr[4 * q + 2] = sv.z; sr[4 * q + 3] = sv.w;
          }
          float xa[kCols];
#pragma unroll
          for (int u = 0; u < kCols; ++u) xa[u] = kRoundX ? round_bf16(x[u][r]) : x[u][r];
#pragma unroll
          for (int c2 = 0; c2 < N; ++c2) {
            float a = 0.0f;
#pragma unroll
            for (int u = 0; u < kCols; ++u) {
              a = fmaf(xa[u], w[u][c2], a);
              d[u][c2] = fmaf(sr[c2], x[u][r], d[u][c2]);
            }
            acc[r][c2] = a;
          }
        }
        Halve<kRows * N, 16>::run(&acc[0][0], lane);
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          float* rp = red + (warp * kRowTile + r0) * N + kPer * lane + j;
          *rp = kb == 0 ? (&acc[0][0])[j] : *rp + (&acc[0][0])[j];
        }
      }
      __syncthreads();                            // the ring is free for the next batch
#pragma unroll
      for (int u = 0; u < kCols; ++u) {
        const int k = kb + tid + kThreads * u;
        if (kok[u]) {
#pragma unroll
          for (int q = 0; q < kQ; ++q)
            DW4[k * kQ + q] = make_float4(d[u][4 * q], d[u][4 * q + 1], d[u][4 * q + 2],
                                          d[u][4 * q + 3]);
        }
      }
    }
    for (int i = tid; i < rows * N; i += kThreads) {
      float v = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += red[w * kRowTile * N + i];
      epi(tile0 + i / N, i % N, v);
    }
    __syncthreads();
  }
}

// out[te] = sum over x < X of f(src[te * st + x], x) for every te < T: the
// warps take te = warp, warp + 8, ... four at a time, the lanes x = lane,
// lane + 32, ..., with 4 U loads a lane in flight (these rows come from L2
// or device memory, and their latency, not their bytes, sets the time of a
// row's attention when f is cheap). The sums run in a fixed order.
template <int U, typename TS, typename F>
__device__ __forceinline__ void warp_dots(float* out, const TS* src, long long st, int T,
                                          int X, F f) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int te0 = warp; te0 < T; te0 += 4 * kWarps) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const TS* p[4];
    bool ok[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      ok[k] = te0 + k * kWarps < T;
      p[k] = src + (ok[k] ? te0 + k * kWarps : 0) * st;
    }
    for (int x0 = lane; x0 < X; x0 += U * 32) {
      float val[4][U];
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int x = x0 + 32 * u;
          val[k][u] = ok[k] && x < X ? to_f32(p[k][x]) : 0.0f;
        }
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int x = x0 + 32 * u;
          if (x < X) acc[k] += f(val[k][u], x);
        }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float sum = warp_sum(acc[k]);
      if (lane == 0 && ok[k]) out[te0 + k * kWarps] = sum;
    }
  }
}

// Launch `kernel` cooperatively: every block of the grid is resident at
// once, which the grid barrier needs. A grid the card cannot hold at once
// is refused (cudaErrorCooperativeLaunchTooLarge), never run in waves.
template <typename... KArgs, typename... Args>
inline cudaError_t launch_cooperative(void (*kernel)(KArgs...), int blocks, size_t smem,
                                      cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                                  smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// How the persistent kernels cut the work (mirrored by
// paddle_tpu_torch/ops/fused_attention_gru.py grid_plan): unit groups of
// 4 hidden units, one block per SM up to one block per group, and each
// block owning groups blockIdx.x, blockIdx.x + blocks, ...
struct Plan {
  int blocks;      // blocks launched
  int gpb;         // unit groups a block owns, at most
  int epb;         // e-groups (8 rows of wctx) a block owns, at most (backward)
  int parts;       // blocks that share one batch row in the attention phase
  int plen;        // columns of a part: of E (forward ctx) or D (backward d_enc_proj)
  int ipb;         // (row, part) items a block owns, at most
};

inline Plan make_plan(int B, int D, int E, int num_sms, bool backward) {
  Plan p;
  const int groups = (D + kUnits - 1) / kUnits;
  p.blocks = groups < num_sms ? groups : num_sms;
  p.gpb = (groups + p.blocks - 1) / p.blocks;
  const int egroups = (E + kERows - 1) / kERows;
  p.epb = (egroups + p.blocks - 1) / p.blocks;
  p.parts = p.blocks / B > 1 ? p.blocks / B : 1;
  const int width = backward ? D : E;
  p.plen = (width + p.parts - 1) / p.parts;
  p.ipb = (B * p.parts + p.blocks - 1) / p.blocks;
  return p;
}

}  // namespace pgrid
