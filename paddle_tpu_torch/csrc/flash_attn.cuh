// The tile machinery shared by the flash-attention kernels (flash_attn_fwd.cu,
// flash_attn_bwd.cu).
//
// Every kernel owns a tile of R rows (queries, or keys in dK/dV) and streams
// tiles of C = 64 rows of the other side past it. A block has 4 warps; a warp
// owns 4 * RM of the R = 16 * RM own rows, and its lanes split as 4 row groups
// (rg = lane / 8) of RM rows each by 8 column lanes (cg = lane % 8). A lane
// holds, for each of its RM rows, the 8 streamed columns c = cg + 8 j of a
// score tile in registers, and the DMAX / 8 feature columns d = cg + 8 jd of
// an accumulator. Row reductions over a score tile are 3 shuffles within the
// 8 lanes of a row group; every lane ends with the same bits.
//
// Both operands of every product sit in shared memory, row-major with an odd
// leading dimension LD = DMAX + 1: in a score product the 8 column lanes read
// 8 different rows at one feature (distinct banks, since LD is odd) and the
// row groups broadcast; in an accumulator product they read one row's
// consecutive features. Features d in [D, DMAX) are stored as zeros, so the
// score products run over DMAX and add exact zeros.
#pragma once

#include <cuda_runtime.h>

#include <cmath>

#include "common.cuh"

namespace flash {

constexpr int kThreads = 128;          // 4 warps
constexpr int kC = 64;                 // streamed rows per tile
constexpr int kNJ = kC / 8;            // score columns per lane
constexpr float kNeg = -1e30f;         // the JAX package's _NEG
constexpr unsigned kFull = 0xffffffffu;

template <int DMAX>
struct Dims {
  static constexpr int LD = DMAX + 1;  // odd: conflict-free in both products
  static constexpr int NJD = DMAX / 8; // accumulator columns per lane
};

// Strided [B, T, H, D] operand with a contiguous last dimension.
struct Operand {
  const float* ptr;
  long long sb, st, sh;
  __device__ __forceinline__ const float* head(int b, int h) const {
    return ptr + b * sb + h * sh;
  }
};

struct Output {
  float* ptr;
  long long sb, st, sh;
  __device__ __forceinline__ float* head(int b, int h) const { return ptr + b * sb + h * sh; }
};

// rows [t0, t0 + rows) of one (batch, head) into dst [rows][LD], times
// `scale`; rows at or past T and features at or past D are zeros.
template <int DMAX>
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long st, int t0,
                                          int rows, int T, int D, float scale) {
  constexpr int LD = Dims<DMAX>::LD;
  for (int e = threadIdx.x; e < rows * DMAX; e += kThreads) {
    const int r = e / DMAX;
    const int d = e % DMAX;
    const int t = t0 + r;
    float v = 0.0f;
    if (t < T && d < D) v = src[t * st + d] * scale;
    dst[r * LD + d] = v;
  }
}

// s[i][j] = sum_d own[r0 + i][d] * str[cg + 8 j][d], summed in feature order.
template <int RM, int DMAX>
__device__ __forceinline__ void score_tile(float (&s)[RM][kNJ], const float* own,
                                           const float* str, int r0, int cg) {
  constexpr int LD = Dims<DMAX>::LD;
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < kNJ; ++j) s[i][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < DMAX; ++d) {
    float a[RM], b[kNJ];
#pragma unroll
    for (int i = 0; i < RM; ++i) a[i] = own[(r0 + i) * LD + d];
#pragma unroll
    for (int j = 0; j < kNJ; ++j) b[j] = str[(cg + 8 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < kNJ; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
}

// acc[i][jd] += sum_c p[i][c] * str[c][cg + 8 jd], summed in stream order;
// p[i][c] lives in lane (row group, c % 8), register c / 8.
template <int RM, int DMAX>
__device__ __forceinline__ void accumulate_tile(float (&acc)[RM][Dims<DMAX>::NJD],
                                                const float (&p)[RM][kNJ], const float* str,
                                                int lane, int cg) {
  constexpr int LD = Dims<DMAX>::LD;
  constexpr int NJD = Dims<DMAX>::NJD;
  const int group = lane & ~7;
#pragma unroll
  for (int j = 0; j < kNJ; ++j) {
#pragma unroll
    for (int c8 = 0; c8 < 8; ++c8) {
      const float* row = str + (8 * j + c8) * LD + cg;
      float pv[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) pv[i] = __shfl_sync(kFull, p[i][j], group | c8);
#pragma unroll
      for (int jd = 0; jd < NJD; ++jd) {
        const float v = row[8 * jd];
#pragma unroll
        for (int i = 0; i < RM; ++i) acc[i][jd] = fmaf(pv[i], v, acc[i][jd]);
      }
    }
  }
}

__device__ __forceinline__ float row_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 1));
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 2));
  return fmaxf(v, __shfl_xor_sync(kFull, v, 4));
}

__device__ __forceinline__ float row_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  v += __shfl_xor_sync(kFull, v, 2);
  return v + __shfl_xor_sync(kFull, v, 4);
}

// The JAX package's mask (_mask): key kp is visible to query qp when it lies
// before the length and, with `causal`, not after the query.
__device__ __forceinline__ bool visible(int qp, int kp, int len, int causal) {
  return kp < len && (!causal || kp <= qp);
}

// acc[i][jd] -> dst rows r0 + i (row t = t0 + r0 + i < T), features d < D.
template <int RM, int DMAX>
__device__ __forceinline__ void store_rows(float* dst, long long st,
                                           const float (&acc)[RM][Dims<DMAX>::NJD], int t0,
                                           int r0, int cg, int T, int D) {
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int t = t0 + r0 + i;
    if (t >= T) continue;
#pragma unroll
    for (int jd = 0; jd < Dims<DMAX>::NJD; ++jd) {
      const int d = cg + 8 * jd;
      if (d < D) dst[t * st + d] = acc[i][jd];
    }
  }
}

__device__ __forceinline__ int clamp_length(const int* lengths, int b, int T) {
  const int len = lengths[b];
  return len < 0 ? 0 : (len > T ? T : len);
}

// The JAX package's scale, 1 / sqrt(D) rounded once to float.
inline float softmax_scale(int D) {
  return static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
}

}  // namespace flash
