// Tensor-core helpers of the flash-attention kernels (flash_attn_fwd.cu,
// flash_attn_bwd.cu): float32-accurate products on mma.sync TF32 by the
// 3-pass split, the cp.async tile loads that feed them, and the geometry
// and output stores the kernels share. conv1x1_bn.cu takes the split.
//
// bf16 operands (the kernels' bf16 instances): a tile of bf16 values is
// widened into the same float32 shared-memory tile, and a widened bf16
// value is exact in TF32 (8 significant bits of its 11): its small half is
// 0, so a product drops the pass that multiplies it (mma_passes). A
// product of two exact factors takes one pass, of one exact factor two,
// and keeps float32 accuracy either way.
//
// The product. mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 takes
// A [16 x 8] and B [8 x 8] as TF32 (10-bit mantissa; the tensor core
// ignores the low 13 bits of a 32-bit operand) and accumulates in float32.
// Each float32 operand x is split as big = x rounded to TF32 and
// small = x - big (exact in float32, |small| <= 2^-11 |x|, read by the
// tensor core with its low bits dropped), and a . b is summed as
// small_a . big_b + big_a . small_b + big_a . big_b: what is lost is
// ~2^-21 of each product, so the sum keeps float32 accuracy at three times
// the TF32 issue count (the technique of CUTLASS's OpMultiplyAddFastF32).
// The split happens in registers as a fragment is loaded, so shared memory
// holds only float32 tiles. It is two integer operations and a float
// subtraction, not cvt.rna.tf32.f32, which runs on the slower conversion
// pipe: with it the split cost more than the products on an H100.
//
// Fragments (lane = 4 g + t, g = lane / 4, t = lane % 4; PTX ISA, "Matrix
// Fragments for mma.m16n8k8", .tf32):
//   A [16 x 8]  a0 (g, t)  a1 (g + 8, t)  a2 (g, t + 4)  a3 (g + 8, t + 4)
//   B [8 x 8]   b0 (k = t, n = g)         b1 (k = t + 4, n = g)
//   C [16 x 8]  c0 (g, 2t) c1 (g, 2t + 1) c2 (g + 8, 2t) c3 (g + 8, 2t + 1)
// A C fragment is not an A fragment: a lane holds columns 2t and 2t + 1 of
// its rows, where A wants t and t + 4. A product's k order does not change
// its sum, so the second product of a kernel (P . V-like, k = the streamed
// rows) takes its k index permuted: logical k = t means streamed row 2t and
// k = t + 4 means 2t + 1. Then a0..a3 = c0, c2, c1, c3 of the score tile,
// with no shuffle and no trip through shared memory, and B's lane (g, t)
// reads streamed rows 2t and 2t + 1 (load_b_rows).
//
// Banks. Tiles are row-major with a leading dimension LD = DMAX + 4, so
// LD = 4 (mod 32) for DMAX = 32, 64, 128, 256 (and 20 for 16, which also
// works): an A or a score-B load reads word LD g + t (+ const), banks 4 g + t,
// and a permuted-B load reads word LD 2t + g, banks 8 t + g: every warp-wide
// 32-bit load touches 32 distinct banks. Rows stay 16-byte aligned for the
// 16-byte cp.async.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace flash_mma {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

// x = big + small: big is x rounded to nearest TF32 (ties away from zero;
// the kernels' operands are finite and far from overflow), small the rest.
__device__ __forceinline__ void split(float x, unsigned& big, unsigned& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

struct FragA {
  unsigned big[4], small[4];
  __device__ __forceinline__ void set(float a0, float a1, float a2, float a3) {
    split(a0, big[0], small[0]);
    split(a1, big[1], small[1]);
    split(a2, big[2], small[2]);
    split(a3, big[3], small[3]);
  }
};

struct FragB {
  unsigned big[2], small[2];
  __device__ __forceinline__ void set(float b0, float b1) {
    split(b0, big[0], small[0]);
    split(b1, big[1], small[1]);
  }
};

__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a . b to float32 accuracy: the small cross terms first, then the
// big product. A factor marked exact is exact in TF32 (its small half 0,
// as a widened bf16 value's), and the pass that multiplies its small half
// is dropped: with neither exact the three passes of the split.
template <bool kExactA, bool kExactB>
__device__ __forceinline__ void mma_passes(float (&d)[4], const FragA& a, const FragB& b) {
  if constexpr (!kExactA) mma_tf32(d, a.small, b.big);
  if constexpr (!kExactB) mma_tf32(d, a.big, b.small);
  mma_tf32(d, a.big, b.big);
}

// As mma_passes, the passes summed apart and added to d in float32.
template <bool kExactA, bool kExactB>
__device__ __forceinline__ void mma_passes_apart(float (&d)[4], const FragA& a,
                                                 const FragB& b) {
  float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma_passes<kExactA, kExactB>(p, a, b);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += p[e];
}

// A [16 x 8] from a row-major tile: rows r0 + g (+ 8), columns c0 + t (+ 4).
template <int LD>
__device__ __forceinline__ void load_a(FragA& a, const float* s, int r0, int c0, int g, int t) {
  const float* p = s + (r0 + g) * LD + c0 + t;
  a.set(p[0], p[8 * LD], p[4], p[8 * LD + 4]);
}

// A [16 x 8] from a tile already split into its big and small halves
// (bits, row-major, leading dimension LD), as load_a.
template <int LD>
__device__ __forceinline__ void load_a_split(FragA& a, const unsigned* big,
                                             const unsigned* small, int r0, int c0, int g,
                                             int t) {
  const int o = (r0 + g) * LD + c0 + t;
  a.big[0] = big[o];
  a.big[1] = big[o + 8 * LD];
  a.big[2] = big[o + 4];
  a.big[3] = big[o + 8 * LD + 4];
  a.small[0] = small[o];
  a.small[1] = small[o + 8 * LD];
  a.small[2] = small[o + 4];
  a.small[3] = small[o + 8 * LD + 4];
}

// B [8 x 8] with element (k, n) = s[n0 + n][c0 + k]: the transposed
// streamed tile of a score product (k runs over features).
template <int LD>
__device__ __forceinline__ void load_b_cols(FragB& b, const float* s, int n0, int c0, int g,
                                            int t) {
  const float* p = s + (n0 + g) * LD + c0 + t;
  b.set(p[0], p[4]);
}

// B [8 x 8] with element (k, n) = s[k0 + perm(k)][c0 + n], perm(t) = 2t,
// perm(t + 4) = 2t + 1: the streamed tile of an accumulate product, its k
// (streamed rows) permuted to match a_from_c.
template <int LD>
__device__ __forceinline__ void load_b_rows(FragB& b, const float* s, int k0, int c0, int g,
                                            int t) {
  const float* p = s + (k0 + 2 * t) * LD + c0 + g;
  b.set(p[0], p[LD]);
}

// The A fragment of an accumulate product from a score tile's C fragment
// (rows g, g + 8; streamed columns 2t, 2t + 1), k permuted as load_b_rows.
__device__ __forceinline__ void a_from_c(FragA& a, const float (&c)[4]) {
  a.set(c[0], c[2], c[1], c[3]);
}

// cp.async with zero fill: copies `bytes` when `valid`, else writes zeros
// (src-size 0 reads nothing; `src` must still be a mapped address).
__device__ __forceinline__ void cp_async16z(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4z(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// Issue the copies of rows [t0, t0 + ROWS) of one (batch, head), features
// [0, DMAX), into dst [ROWS][DMAX + 4]: rows at or past T and features at
// or past D are zeros. `vec`: every row start is 16-byte aligned and
// D % 4 == 0, so 16-byte copies, a thread keeping one column of chunks and
// stepping its source pointer down the rows; else 4-byte ones. The caller
// commits the group.
template <int DMAX, int ROWS>
__device__ __forceinline__ void load_tile_async(float* dst, const float* src, long long st,
                                                int t0, int T, int D, bool vec) {
  constexpr int LD = DMAX + 4;
  if (vec) {
    constexpr int kChunks = DMAX / 4;                 // 16-byte chunks in a row
    constexpr int kRowsPerPass = kThreads / kChunks;
    static_assert(kThreads % kChunks == 0 && ROWS % kRowsPerPass == 0, "tile geometry");
    const int c = 4 * (threadIdx.x % kChunks);
    const int r = threadIdx.x / kChunks;
    const bool in_d = c < D;
    const float* p = src + static_cast<long long>(t0 + r) * st + c;
#pragma unroll
    for (int i = 0; i < ROWS / kRowsPerPass; ++i) {
      const int row = r + i * kRowsPerPass;
      const bool ok = in_d && t0 + row < T;
      cp_async16z(dst + row * LD + c, ok ? p : src, ok);
      p += kRowsPerPass * st;
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * DMAX; e += kThreads) {
      const int r = e / DMAX;
      const int c = e % DMAX;
      const int t = t0 + r;
      const bool ok = t < T && c < D;
      cp_async4z(dst + r * LD + c, ok ? src + t * st + c : src, ok);
    }
  }
}

// The same tile from a bf16 operand, widened into the float32 tile: plain
// loads (cp.async cannot widen), stored before the caller's barrier, so
// they complete before it like the copies' wait. `vec`: rows start 16-byte
// aligned and D % 8 == 0, so one 16-byte load of 8 values a thread, stored
// as two float4; else one value at a time.
template <int DMAX, int ROWS>
__device__ __forceinline__ void load_tile_async(float* dst, const __nv_bfloat16* src,
                                                long long st, int t0, int T, int D, bool vec) {
  constexpr int LD = DMAX + 4;
  if (vec) {
    constexpr int kChunks = DMAX / 8;                 // 16-byte chunks in a row
    constexpr int kRowsPerPass = kThreads / kChunks;
    static_assert(kThreads % kChunks == 0 && ROWS % kRowsPerPass == 0, "tile geometry");
    const int c = 8 * (threadIdx.x % kChunks);
    const int r = threadIdx.x / kChunks;
    const bool in_d = c < D;
    const __nv_bfloat16* p = src + static_cast<long long>(t0 + r) * st + c;
#pragma unroll
    for (int i = 0; i < ROWS / kRowsPerPass; ++i) {
      const int row = r + i * kRowsPerPass;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (in_d && t0 + row < T) raw = *reinterpret_cast<const uint4*>(p);
      // a bf16 is the high half of its float32: widen by shifting
      const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
      float4* out = reinterpret_cast<float4*>(dst + row * LD + c);
      out[0] = make_float4(__uint_as_float(w[0] << 16), __uint_as_float(w[0] & 0xffff0000u),
                           __uint_as_float(w[1] << 16), __uint_as_float(w[1] & 0xffff0000u));
      out[1] = make_float4(__uint_as_float(w[2] << 16), __uint_as_float(w[2] & 0xffff0000u),
                           __uint_as_float(w[3] << 16), __uint_as_float(w[3] & 0xffff0000u));
      p += kRowsPerPass * st;
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * DMAX; e += kThreads) {
      const int r = e / DMAX;
      const int c = e % DMAX;
      const int t = t0 + r;
      dst[r * LD + c] = t < T && c < D ? __bfloat162float(src[t * st + c]) : 0.0f;
    }
  }
}

// [t0, t0 + rows) of a [T] row statistic (lse, delta) into dst; zeros past T.
__device__ __forceinline__ void load_stat_async(float* dst, const float* src, int t0, int rows,
                                                int T) {
  for (int c = threadIdx.x; c < rows; c += kThreads) {
    const bool ok = t0 + c < T;
    cp_async4z(dst + c, ok ? src + t0 + c : src, ok);
  }
}

// Whether 16-byte copies can read every row of a strided [B, T, H, D]
// operand of `elem`-byte values: its base and all three strides 16-byte
// multiples, and D a multiple of a 16-byte chunk.
inline bool rows_16b_aligned(const void* p, long long sb, long long st, long long sh, int D,
                             int elem = 4) {
  const int per = 16 / elem;
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % per == 0 && st % per == 0 &&
         sh % per == 0 && D % per == 0;
}

// The geometry of one instantiation: DMAX features (a multiple of 16), WF
// warps per row strip (splitting the accumulator features), BC streamed
// rows.
template <int DMAX_, int WF_, int BC_>
struct Cfg {
  static constexpr int DMAX = DMAX_;
  static constexpr int WF = WF_;
  static constexpr int BC = BC_;
  static constexpr int LD = DMAX + 4;         // see "Banks" above
  static constexpr int BR = 16 * (kWarps / WF);
  static constexpr int DACC = DMAX / WF;      // accumulator features per warp
  static constexpr int NA = DACC / 8;         // accumulator n-tiles per warp
  static constexpr int NS = BC / 8;           // score n-tiles per warp
  static constexpr int KS = DMAX / 8;         // score k-steps
};

template <class C>
__device__ __forceinline__ void zero(float (&acc)[C::NA][4]) {
#pragma unroll
  for (int n = 0; n < C::NA; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
}

// acc (C layout: rows r0 + g (+ 8), features f0 + 8n + 2t (+ 1)) into the
// rows t < T and features d < D of one (batch, head) of dst, rounded once
// to dst's type S (float or __nv_bfloat16).
template <class C, typename S>
__device__ __forceinline__ void store_acc(S* dst, long long st, const float (&acc)[C::NA][4],
                                          int r0, int f0, int T, int D, int g, int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + g + 8 * half;
    if (row >= T) continue;
    S* out = dst + row * st;
#pragma unroll
    for (int n = 0; n < C::NA; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = f0 + 8 * n + 2 * t + e;
        if (d < D) out[d] = from_f32<S>(acc[n][2 * half + e]);
      }
  }
}

}  // namespace flash_mma
