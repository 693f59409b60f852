// flash_attn_dq / flash_attn_dkv — the backward of flash_attn_fwd, scores
// recomputed from the saved log-sum-exp, FlashAttention-2's split in two
// kernels as the JAX package's.
//
// Replaces: paddle_tpu/ops/pallas_attention.py _dq_kernel (flash_attn_dq)
// and _dkv_kernel (flash_attn_dkv), both launched by pl.pallas_call in
// _run_bwd, the custom-VJP backward of the JAX package's flash attention.
// With scale = 1 / sqrt(D), the mask of flash_attn_fwd, lse from it and
// delta[q] = sum_d dout[q, d] out[q, d] (computed by the caller, as the JAX
// package computes it outside its kernels):
//   s  = (q . k) scale             p  = exp(s - lse[q]) where visible else 0
//   dp = dout . v                  ds = p (dp - delta[q]) scale
//   dq = sum_k ds k                dk = sum_q ds q        dv = sum_q p dout
// The mask is applied to p explicitly: at a query that sees no key
// s = lse = -1e30 and exp(s - lse) would be 1.
//
// What bounds them on an H100: at B = 8, H = 8, T = 2048, D = 64, causal,
// dq does 3 B H T^2 D = 51.5 GFLOP on ~169 MB and dkv 4 B H T^2 D = 68.7
// GFLOP on ~202 MB: operations bound both, 0.770 and 1.026 ms at the 67
// TFLOP/s float32 rate of the CUDA cores. The first design ran every
// product there (2.4 and 3.3 ms), with both operands in shared memory (12
// shared loads or shuffles per 32 FMAs) and each streamed tile loaded
// element by element between two barriers, so no load overlapped a product.
//
// What this design does about it:
// - The products run on the tensor cores, mma.sync m16n8k8 TF32 with the
//   3-pass split of flash_mma.cuh, which keeps float32 accuracy (plain TF32
//   rounds each operand to 2^-11, ~4.9e-4 relative, above the 1e-4 checks).
//   Three TF32 passes per product bound
//   the kernels at 3 ops / 495 TFLOP/s: ~0.31 ms (dq) and ~0.42 ms (dkv).
// - A block of 4 warps owns a tile of BR rows (queries in dq, keys in dkv);
//   a warp owns a strip of 16 of them (and, at WF > 1, a WF-th of the
//   features of the accumulators; such warps recompute the strip's scores).
//   The block streams tiles of BC rows of the other side past it. Per
//   streamed tile a warp computes two score tiles [16 x BC] in registers
//   (s and dp in dq; their transposes in dkv), turns them into p and ds in
//   place, and feeds them as the A operands of the accumulate products
//   straight from the accumulator registers (k permuted, see flash_mma.cuh).
//   The own tiles stay in shared memory, float32, and are re-read as A
//   fragments: in registers they would take 2 x 16 x D / 32 x 2 (split) =
//   128 registers at D = 64.
// - Streamed tiles (and, in dkv, their lse and delta) go through a ring of
//   two stages filled by cp.async, 16-byte copies where the operand allows:
//   tile i + 1 loads while tile i is multiplied.
// - Accumulators: dq holds 16 x D / WF, dkv twice that, per warp. WF = 1
//   up to D = 64 (dq up to 128); dq at D = 256 and dkv at 128 take WF = 2,
//   dkv at 256 WF = 4, so no thread holds more than 64 accumulator floats
//   beyond D = 64 and none spills.
// - The feature loops run over DMAX (16, 32, 64, 128 or 256, the smallest
//   that holds D), fixed at compile time: shared features in [D, DMAX) are
//   zeros and add exact zeros. A bound at D rounded up to 8 would save the
//   zero k-steps at odd D, but a runtime bound inside the unrolled loops
//   cut them into basic blocks (a branch and a convergence barrier per
//   k-step and n-tile), and the compiler then no longer overlapped the
//   loads, splits and products of one step with the next.
// - The tensor core's float32 accumulation truncates, so over many passes
//   the errors add up one way: 96 passes of a D = 256 score, 768 of a
//   2048-row sum. The accumulate products sum each streamed tile apart
//   (BC rows) and add it to their sums with rounded float32 adds; the score
//   products beyond D = 64 do so for each 8 features; a score over D <= 64
//   (24 passes) sums in place.
//
// dq walks the key tiles up to its last query and the length; dkv the query
// tiles from the one holding its first key (causal) to the end. A key tile
// wholly at or past the length gets dk = dv = 0 and reads nothing. Each
// block writes only its own rows, summing over the streamed tiles in order:
// no atomics, two launches give equal bits.
//
// The bf16 instances (flash_attn_dq_bf16, flash_attn_dkv_bf16) keep the
// Pallas kernels' bf16 contract: q, k, v and dout bf16, widened to float32;
// lse, delta, p, ds and every sum float32; dq, dk and dv rounded once to
// bf16. The same bodies on the storage type S: tiles are widened into the
// float32 tiles by plain 16-byte loads, and the products drop the passes of
// an exact factor (flash_mma.cuh): the score products (q . k^T, dout . v^T)
// multiply two bf16 values, one TF32 pass each; the accumulate products
// (ds . k, p^T . dout, ds^T . q) split their float32 factor, two passes.

#include "flash_attn.cuh"
#include "flash_mma.cuh"

namespace {

using flash::Operand;
using flash::Output;
using flash_mma::Cfg;
using bf16 = __nv_bfloat16;
using flash_mma::FragA;
using flash_mma::FragB;
using flash_mma::kThreads;
using flash_mma::kWarps;

constexpr float kLog2e = 1.4426950408889634f;

// s[j] = own[r0 .. r0 + 16) . x[8j .. 8j + 8)^T over the DMAX features
// (zeros past D): the warp's score tile. kExact: both factors exact in TF32
// (bf16 operands; mma_passes).
template <class C, bool kExact>
__device__ __forceinline__ void score_tile(float (&s)[C::NS][4], const float* own,
                                           const float* x, int r0, int g, int t) {
#pragma unroll
  for (int j = 0; j < C::NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < C::KS; ++ks) {
    FragA a;
    flash_mma::load_a<C::LD>(a, own, r0, 8 * ks, g, t);
#pragma unroll
    for (int j = 0; j < C::NS; ++j) {
      FragB b;
      flash_mma::load_b_cols<C::LD>(b, x, 8 * j, 8 * ks, g, t);
      if constexpr (C::KS > 8) {
        flash_mma::mma_passes_apart<kExact, kExact>(s[j], a, b);
      } else {
        flash_mma::mma_passes<kExact, kExact>(s[j], a, b);
      }
    }
  }
}

// acc[n] += a . x over the BC streamed rows, x's features [f0, f0 + DACC);
// `a` is a score tile in C layout (a_from_c). Each n-tile sums the streamed
// tile apart and adds it to acc with rounded float32 adds. kExactX: x exact
// in TF32.
template <class C, bool kExactX>
__device__ __forceinline__ void accumulate(float (&acc)[C::NA][4], const float (&a)[C::NS][4],
                                           const float* x, int f0, int g, int t) {
  FragA fa[C::NS];
#pragma unroll
  for (int j = 0; j < C::NS; ++j) flash_mma::a_from_c(fa[j], a[j]);
#pragma unroll
  for (int n = 0; n < C::NA; ++n) {
    float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < C::NS; ++j) {
      FragB b;
      flash_mma::load_b_rows<C::LD>(b, x, 8 * j, f0 + 8 * n, g, t);
      flash_mma::mma_passes<false, kExactX>(part, fa[j], b);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += part[e];
  }
}

// S: the storage type of q, k, v, dout and dq.
template <class C, typename S>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(Operand<S> q, Operand<S> k, Operand<S> v, Operand<S> dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const int* __restrict__ lengths, Output<S> dq, int T, int H, int D, int causal,
                float scale, int vec) {
  constexpr bool kExact = !IsF32<S>::value;          // bf16 operands are exact in TF32
  constexpr int LD = C::LD, BR = C::BR, BC = C::BC;
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;                       // [BR][LD]
  float* sdo = sq + BR * LD;              // [BR][LD]
  float* sk = sdo + BR * LD;              // [2][BC][LD]
  float* sv = sk + 2 * BC * LD;           // [2][BC][LD]

  const int iq = gridDim.x - 1 - blockIdx.x;   // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = iq * BR;
  const int len = flash::clamp_length(lengths, b, T);
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) / 4;
  const int t = threadIdx.x % 4;
  const int r0 = (warp / C::WF) * 16;     // the warp's strip in the tile
  const int f0 = (warp % C::WF) * C::DACC;
  const long long stat = (static_cast<long long>(b) * H + h) * T;
  const S* kh = k.head(b, h);
  const S* vh = v.head(b, h);

  const int kend = causal ? min(len, q0 + BR) : len;
  const int tiles = kend > 0 ? (kend + BC - 1) / BC : 0;
  if (tiles > 0) {                        // else the row sees no key: dq = 0
    flash_mma::load_tile_async<C::DMAX, BR>(sq, q.head(b, h), q.st, q0, T, D, vec);
    flash_mma::load_tile_async<C::DMAX, BR>(sdo, dout.head(b, h), dout.st, q0, T, D, vec);
    flash_mma::load_tile_async<C::DMAX, BC>(sk, kh, k.st, 0, T, D, vec);
    flash_mma::load_tile_async<C::DMAX, BC>(sv, vh, v.st, 0, T, D, vec);
    cp_async_commit();
  }

  float row_lse2[2], row_delta[2];        // lse in base 2
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qp = q0 + r0 + g + 8 * half;
    row_lse2[half] = qp < T ? lse[stat + qp] * kLog2e : 0.0f;
    row_delta[half] = qp < T ? delta[stat + qp] : 0.0f;
  }
  const float scale2 = scale * kLog2e;
  float acc[C::NA][4];
  flash_mma::zero<C>(acc);

  for (int it = 0; it < tiles; ++it) {
    const int k0 = it * BC;
    const int stage = it & 1;
    if (it + 1 < tiles) {
      const int nxt = (stage ^ 1) * BC * LD;
      flash_mma::load_tile_async<C::DMAX, BC>(sk + nxt, kh, k.st, k0 + BC, T, D, vec);
      flash_mma::load_tile_async<C::DMAX, BC>(sv + nxt, vh, v.st, k0 + BC, T, D, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* ks = sk + stage * BC * LD;
    const float* vs = sv + stage * BC * LD;

    float s[C::NS][4], dp[C::NS][4];
    score_tile<C, kExact>(s, sq, ks, r0, g, t);               // q . k^T
    score_tile<C, kExact>(dp, sdo, vs, r0, g, t);             // dout . v^T
    // every key of the tile visible to every query of the strip
    const bool all = k0 + BC <= len && (!causal || k0 + BC - 1 <= q0 + r0);
#pragma unroll
    for (int j = 0; j < C::NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e / 2;
        const int qp = q0 + r0 + g + 8 * half;
        const int kp = k0 + 8 * j + 2 * t + (e & 1);
        const float e2 = exp2f(s[j][e] * scale2 - row_lse2[half]);
        const float p = all || flash::visible(qp, kp, len, causal) ? e2 : 0.0f;
        s[j][e] = p * (dp[j][e] - row_delta[half]) * scale;   // ds
      }
    accumulate<C, kExact>(acc, s, ks, f0, g, t);          // dq += ds k
    __syncthreads();                      // the stage is refilled next iteration
  }
  flash_mma::store_acc<C>(dq.head(b, h), dq.st, acc, q0 + r0, f0, T, D, g, t);
}

// S: the storage type of q, k, v, dout, dk and dv.
template <class C, typename S>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(Operand<S> q, Operand<S> k, Operand<S> v, Operand<S> dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 const int* __restrict__ lengths, Output<S> dk, Output<S> dv, int T, int H,
                 int D, int causal, float scale, int vec) {
  constexpr bool kExact = !IsF32<S>::value;          // bf16 operands are exact in TF32
  constexpr int LD = C::LD, BR = C::BR, BC = C::BC;
  extern __shared__ __align__(16) float smem[];
  float* sk = smem;                       // [BR][LD]
  float* sv = sk + BR * LD;               // [BR][LD]
  float* sq = sv + BR * LD;               // [2][BC][LD]
  float* sdo = sq + 2 * BC * LD;          // [2][BC][LD]
  float* slse = sdo + 2 * BC * LD;        // [2][BC]
  float* sdelta = slse + 2 * BC;          // [2][BC]

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = blockIdx.x * BR;         // the first key tiles see the most queries
  const int len = flash::clamp_length(lengths, b, T);
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) / 4;
  const int t = threadIdx.x % 4;
  const int r0 = (warp / C::WF) * 16;
  const int f0 = (warp % C::WF) * C::DACC;
  const long long stat = (static_cast<long long>(b) * H + h) * T;
  const S* qh = q.head(b, h);
  const S* doh = dout.head(b, h);
  const float scale2 = scale * kLog2e;

  float acc_k[C::NA][4], acc_v[C::NA][4];
  flash_mma::zero<C>(acc_k);
  flash_mma::zero<C>(acc_v);
  if (k0 < len) {                         // else every key of the tile is masked
    const int first = causal ? k0 / BC : 0;
    const int tiles = (T + BC - 1) / BC;
    flash_mma::load_tile_async<C::DMAX, BR>(sk, k.head(b, h), k.st, k0, T, D, vec);
    flash_mma::load_tile_async<C::DMAX, BR>(sv, v.head(b, h), v.st, k0, T, D, vec);
    const int t0 = first * BC;
    const int s0 = (first & 1);
    flash_mma::load_tile_async<C::DMAX, BC>(sq + s0 * BC * LD, qh, q.st, t0, T, D, vec);
    flash_mma::load_tile_async<C::DMAX, BC>(sdo + s0 * BC * LD, doh, dout.st, t0, T, D, vec);
    flash_mma::load_stat_async(slse + s0 * BC, lse + stat, t0, BC, T);
    flash_mma::load_stat_async(sdelta + s0 * BC, delta + stat, t0, BC, T);
    cp_async_commit();

    for (int it = first; it < tiles; ++it) {
      const int q0 = it * BC;
      const int stage = it & 1;
      if (it + 1 < tiles) {
        const int nx = stage ^ 1;
        const int n0 = q0 + BC;
        flash_mma::load_tile_async<C::DMAX, BC>(sq + nx * BC * LD, qh, q.st, n0, T, D, vec);
        flash_mma::load_tile_async<C::DMAX, BC>(sdo + nx * BC * LD, doh, dout.st, n0, T, D, vec);
        flash_mma::load_stat_async(slse + nx * BC, lse + stat, n0, BC, T);
        flash_mma::load_stat_async(sdelta + nx * BC, delta + stat, n0, BC, T);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* qs = sq + stage * BC * LD;
      const float* dos = sdo + stage * BC * LD;
      const float* ls = slse + stage * BC;
      const float* ds_ = sdelta + stage * BC;

      float s[C::NS][4], dp[C::NS][4];
      score_tile<C, kExact>(s, sk, qs, r0, g, t);             // (q . k)^T
      score_tile<C, kExact>(dp, sv, dos, r0, g, t);           // (dout . v)^T
      const int kr = k0 + r0;
      // every query of the tile (all before T) sees every key of the strip
      const bool all = q0 + BC <= T && kr + 16 <= len && (!causal || q0 >= kr + 15);
#pragma unroll
      for (int j = 0; j < C::NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * t + (e & 1);
          const int qp = q0 + c;
          const int kp = kr + g + 8 * (e / 2);
          const float e2 = exp2f(s[j][e] * scale2 - ls[c] * kLog2e);
          const float p = all || (qp < T && flash::visible(qp, kp, len, causal)) ? e2 : 0.0f;
          s[j][e] = p;                                          // p^T
          dp[j][e] = p * (dp[j][e] - ds_[c]) * scale;           // ds^T
        }
      accumulate<C, kExact>(acc_v, s, dos, f0, g, t);     // dv += p^T dout
      accumulate<C, kExact>(acc_k, dp, qs, f0, g, t);     // dk += ds^T q
      __syncthreads();
    }
  }
  flash_mma::store_acc<C>(dk.head(b, h), dk.st, acc_k, k0 + r0, f0, T, D, g, t);
  flash_mma::store_acc<C>(dv.head(b, h), dv.st, acc_v, k0 + r0, f0, T, D, g, t);
}

template <class C, typename S>
int launch_dq(Operand<S> q, Operand<S> k, Operand<S> v, Operand<S> dout, const float* lse,
              const float* delta, const int* lengths, Output<S> dq, int B, int T, int H, int D,
              int causal, int vec, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(2 * C::BR + 4 * C::BC) * C::LD * sizeof(float);
  cudaError_t err = allow_smem(flash_dq_kernel<C, S>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + C::BR - 1) / C::BR, H, B);
  flash_dq_kernel<C, S><<<grid, kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, lengths, dq, T, H, D, causal, flash::softmax_scale(D), vec);
  return static_cast<int>(cudaGetLastError());
}

template <class C, typename S>
int launch_dkv(Operand<S> q, Operand<S> k, Operand<S> v, Operand<S> dout, const float* lse,
               const float* delta, const int* lengths, Output<S> dk, Output<S> dv, int B, int T,
               int H, int D, int causal, int vec, cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(2 * C::BR + 4 * C::BC) * C::LD + 4 * C::BC) * sizeof(float);
  cudaError_t err = allow_smem(flash_dkv_kernel<C, S>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + C::BR - 1) / C::BR, H, B);
  flash_dkv_kernel<C, S><<<grid, kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, lengths, dk, dv, T, H, D, causal, flash::softmax_scale(D),
      vec);
  return static_cast<int>(cudaGetLastError());
}

// 16-byte loads when every operand allows them.
template <typename S>
int rows_16b(const Operand<S>& q, const Operand<S>& k, const Operand<S>& v,
             const Operand<S>& g, int D) {
  constexpr int kElem = sizeof(S);
  return flash_mma::rows_16b_aligned(q.ptr, q.sb, q.st, q.sh, D, kElem) &&
         flash_mma::rows_16b_aligned(k.ptr, k.sb, k.st, k.sh, D, kElem) &&
         flash_mma::rows_16b_aligned(v.ptr, v.sb, v.st, v.sh, D, kElem) &&
         flash_mma::rows_16b_aligned(g.ptr, g.sb, g.st, g.sh, D, kElem);
}

// The strided operands of both kernels, in either storage type.
template <typename S>
struct Args {
  Operand<S> q, k, v, dout;
  Args(const void* q_, long long q_sb, long long q_st, long long q_sh, const void* k_,
       long long k_sb, long long k_st, long long k_sh, const void* v_, long long v_sb,
       long long v_st, long long v_sh, const void* g_, long long g_sb, long long g_st,
       long long g_sh)
      : q{static_cast<const S*>(q_), q_sb, q_st, q_sh},
        k{static_cast<const S*>(k_), k_sb, k_st, k_sh},
        v{static_cast<const S*>(v_), v_sb, v_st, v_sh},
        dout{static_cast<const S*>(g_), g_sb, g_st, g_sh} {}
};

template <typename S>
int run_dq(const Args<S>& a, const void* lse, const void* delta, const void* lengths, void* dq,
           long long d_sb, long long d_st, long long d_sh, int B, int T, int H, int D,
           int causal, void* stream) {
  const Output<S> od{static_cast<S*>(dq), d_sb, d_st, d_sh};
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = rows_16b(a.q, a.k, a.v, a.dout, D);
#define FLASH_DQ(DMAX, WF, BC) \
  launch_dq<Cfg<DMAX, WF, BC>, S>(a.q, a.k, a.v, a.dout, l, dl, len, od, B, T, H, D, causal, \
                                  vec, s)
  if (D <= 16) return FLASH_DQ(16, 1, 64);
  if (D <= 32) return FLASH_DQ(32, 1, 64);
  if (D <= 64) return FLASH_DQ(64, 1, 32);
  if (D <= 128) return FLASH_DQ(128, 1, 32);
  if (D <= 256) return FLASH_DQ(256, 2, 32);
#undef FLASH_DQ
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename S>
int run_dkv(const Args<S>& a, const void* lse, const void* delta, const void* lengths,
            void* dk, long long dk_sb, long long dk_st, long long dk_sh, void* dv,
            long long dv_sb, long long dv_st, long long dv_sh, int B, int T, int H, int D,
            int causal, void* stream) {
  const Output<S> odk{static_cast<S*>(dk), dk_sb, dk_st, dk_sh};
  const Output<S> odv{static_cast<S*>(dv), dv_sb, dv_st, dv_sh};
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = rows_16b(a.q, a.k, a.v, a.dout, D);
#define FLASH_DKV(DMAX, WF, BC) \
  launch_dkv<Cfg<DMAX, WF, BC>, S>(a.q, a.k, a.v, a.dout, l, dl, len, odk, odv, B, T, H, D, \
                                   causal, vec, s)
  if (D <= 16) return FLASH_DKV(16, 1, 64);
  if (D <= 32) return FLASH_DKV(32, 1, 64);
  if (D <= 64) return FLASH_DKV(64, 1, 32);
  if (D <= 128) return FLASH_DKV(128, 2, 32);
  if (D <= 256) return FLASH_DKV(256, 4, 32);
#undef FLASH_DKV
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, k, v, dout, dq, dk and dv [B, T, H, D] through their batch, time and
// head strides (in elements; the last dimension contiguous); lse and delta
// [B, H, T] contiguous; lengths [B] int32. 1 <= D <= 256, T >= 1, H and
// B <= 65535. Launch on `stream`, return cudaGetLastError() (or the launch's
// own error). The _bf16 instances take the same arguments with q, k, v,
// dout, dq, dk and dv __nv_bfloat16 (lse and delta float32).
#define FLASH_BWD_QKVG                                                                    \
  const void *q, long long q_sb, long long q_st, long long q_sh, const void *k,          \
      long long k_sb, long long k_st, long long k_sh, const void *v, long long v_sb,     \
      long long v_st, long long v_sh, const void *dout, long long g_sb, long long g_st,  \
      long long g_sh
#define FLASH_BWD_ARGS \
  q, q_sb, q_st, q_sh, k, k_sb, k_st, k_sh, v, v_sb, v_st, v_sh, dout, g_sb, g_st, g_sh

extern "C" int flash_attn_dq(FLASH_BWD_QKVG, const void* lse, const void* delta,
                             const void* lengths, void* dq, long long d_sb, long long d_st,
                             long long d_sh, int B, int T, int H, int D, int causal,
                             void* stream) {
  return run_dq(Args<float>(FLASH_BWD_ARGS), lse, delta, lengths, dq, d_sb, d_st, d_sh, B, T,
                H, D, causal, stream);
}

extern "C" int flash_attn_dq_bf16(FLASH_BWD_QKVG, const void* lse, const void* delta,
                                  const void* lengths, void* dq, long long d_sb,
                                  long long d_st, long long d_sh, int B, int T, int H, int D,
                                  int causal, void* stream) {
  return run_dq(Args<bf16>(FLASH_BWD_ARGS), lse, delta, lengths, dq, d_sb, d_st, d_sh, B, T,
                H, D, causal, stream);
}

extern "C" int flash_attn_dkv(FLASH_BWD_QKVG, const void* lse, const void* delta,
                              const void* lengths, void* dk, long long dk_sb, long long dk_st,
                              long long dk_sh, void* dv, long long dv_sb, long long dv_st,
                              long long dv_sh, int B, int T, int H, int D, int causal,
                              void* stream) {
  return run_dkv(Args<float>(FLASH_BWD_ARGS), lse, delta, lengths, dk, dk_sb, dk_st, dk_sh,
                 dv, dv_sb, dv_st, dv_sh, B, T, H, D, causal, stream);
}

extern "C" int flash_attn_dkv_bf16(FLASH_BWD_QKVG, const void* lse, const void* delta,
                                   const void* lengths, void* dk, long long dk_sb,
                                   long long dk_st, long long dk_sh, void* dv, long long dv_sb,
                                   long long dv_st, long long dv_sh, int B, int T, int H, int D,
                                   int causal, void* stream) {
  return run_dkv(Args<bf16>(FLASH_BWD_ARGS), lse, delta, lengths, dk, dk_sb, dk_st, dk_sh,
                 dv, dv_sb, dv_st, dv_sh, B, T, H, D, causal, stream);
}
