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
// flash_attn_dq_bf16 and flash_attn_dkv_bf16 take the bf16 shapes the Hopper
// bodies below do not (D other than 64 and 128, an unaligned base, strides
// TMA cannot read).
//
// The bf16 dK/dV body for Hopper (flash_attn_dkv_bf16_sm90) takes D = 64
// and 128 with q, k, v and dout as TMA reads them (flash_attention.py's
// sm90_takes). What bounds it: at the LM's shape (B = 8, H = 8, T = 2048,
// D = 64, causal) 68.8 GFLOP, 0.070 ms at the 989 TFLOP/s bf16 rate; with
// p^T and ds^T in two bf16 pieces (the forward's note) 1.5 passes a
// product, a design bound of 0.104 ms. What the design does about it:
// - A block owns 128 keys, two warpgroups of 64; k and v stay in shared
//   memory for the launch. One thread streams q and dout tiles of BQ
//   queries (64 at D = 64, 32 at D = 128; TMA from the strided views, the
//   128-byte swizzle) with their lse and delta rows (TMA through 1-d maps
//   over all (b, h, t)) through a ring of 5 stages on mbarriers; causal
//   blocks begin at the query tile that holds their first key, and a key
//   tile wholly past the length reads nothing and writes dk = dv = 0.
// - Per query tile: s^T = k . q^T and dp^T = v . dout^T as wgmma
//   m64nBQk16, all operands K-major from shared memory, their steps
//   interleaved (independent chains); p^T = 2^(s^T scale log2(e) - lse
//   log2(e)), masked explicitly (at a query that sees no key s = lse =
//   -1e30), and ds^T = p^T (dp^T - delta) scale in float32; then dv +=
//   p^T . dout and dk += ds^T . q as wgmma m64n64k16 with the factors' two
//   bf16 pieces as A from registers and dout and q read MN-major from their
//   tiles, the four chains interleaved.
// - dv and dk sum in the wgmma accumulators over every query tile, without
//   the float32 body's rounded adds (a tile's partial sums would take 64
//   more registers a thread at D = 64 and 128 at D = 128, past the 255 a
//   thread may hold), so their truncation adds up: where dk cancels over a
//   long sum (non-causal, T = 1000-2048) it lies several bf16 spacings, at
//   2^-11 of its scale, from the plain version's; dv within one
//   (chip_smoke.py's SM90_ULPS).
// - dk and dv are rounded once to bf16; each block writes only its own
//   rows: no atomics, two launches give equal bits.
//
// The bf16 dQ body for Hopper (flash_attn_dq_bf16_sm90) takes the same
// shapes. What bounds it: at the LM's shape 3 products x 2 B H T^2 D / 2
// (causal) = 51.5 GFLOP, 0.0521 ms at the bf16 rate; with ds in two bf16
// pieces the products average 4/3 passes, a design bound of 0.0695 ms.
// flash_attn_dq_bf16 (the float32 body's instance: tiles widened into float32
// shared tiles, mma.sync TF32) ran 0.94-1.01 ms there, 1.4-1.8x the whole
// bf16 SDPA backward. What the design does about it, mirroring dK/dV:
// - A block owns 128 queries, two warpgroups of 64; q and dout stay in
//   shared memory for the launch (TMA from the strided views, the 128-byte
//   swizzle), each thread's two rows' lse and delta in registers (read once
//   with plain loads: no ring, no alignment asked of them). One thread
//   streams k and v tiles of BK keys (64 at D = 64, 32 at D = 128) through
//   a ring of 6 stages on mbarriers; the key range ends at the block's last
//   query (causal) and at the length, and a warpgroup skips a tile wholly
//   after its last query.
// - Per key tile: s = q . k^T and dp = dout . v^T as wgmma m64nBKk16, their
//   chains interleaved; p = 2^(s scale log2(e) - lse log2(e)), masked
//   explicitly, and ds = p (dp - delta) scale in float32, a copy of dK/dV's
//   step in its own layout (one function for both moved ptxas's allocation
//   of the dK/dV body, 194 and 220 registers against 192 and 218, and
//   changed its SASS); then dq's tile partial ds . K as wgmma m64n64k16
//   with ds's two bf16 pieces as A from registers and K read MN-major from
//   its tile.
// - dq's accumulation: each key tile's partial is summed apart in two
//   independent chains (at D = 64 one a piece, at D = 128 one a half of the
//   features) and added to dq with rounded float32 adds, as the float32
//   body does: 148 registers at D = 64, 166 at 128, no spill. dq lies
//   within one bf16 spacing of the plain version's, or two where ds
//   cancels and the tensor core's truncating sums of the scores show
//   (tests/test_torch_flash_attention.py emulates both).
// - dq is rounded once to bf16; each block writes only its own rows: no
//   atomics, two launches give equal bits.
// Measured (tools/flash_sm90_phases.py, chip_smoke.py; PERF.md): ~3,100-
// 3,500 cycles a tile, ~1,290-1,350 of them p, ds and the pieces, ~460-500
// the scores, ~500-570 the dq product; 0.35-0.37 ms at the LM's shape.

#include "flash_attn.cuh"
#include "flash_mma.cuh"
#include "hopper.cuh"

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

// ---- the bf16 dK/dV body for Hopper (flash_attn_dkv_bf16_sm90) ----

namespace sm90 {

using bf16 = __nv_bfloat16;
using flash::Output;
using namespace hopper;

// Two warpgroups of 64 keys, and no warp of its own for the loads (as the
// forward: a producer warp or warpgroup capped every thread at 168
// registers, which serialized the wgmmas); one thread (kLoader) issues the
// loads.
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * kConsumers;
constexpr int kLoader = 128;                     // thread 0 of warpgroup 1

// D = 64 or 128; tiles are swizzled [rows][64] images, D / 64 of them.
template <int D>
struct DkvGeo {
  static constexpr int BK = 64 * kConsumers;     // keys of a block
  static constexpr int BQ = D == 64 ? 64 : 32;   // queries of a stage
  static constexpr int HALVES = D / 64;
  static constexpr int STAGES = 5;
  static constexpr int K_BYTES = BK * D * 2;     // the block's K, and its V
  static constexpr int T_BYTES = BQ * D * 2;     // a Q or a dO tile: 8 KB at both widths
  static constexpr int STAT_ROW = BQ + 4;        // a stat row from its 16-byte boundary
  static constexpr int DELTA_OFF = 512;          // bytes: delta's row after lse's
  static constexpr int STAT_BYTES = 1024;        // the tile's lse and delta rows
  static constexpr int STAGE_BYTES = 2 * T_BYTES + STAT_BYTES;
  static constexpr int SMEM = 1024 + 2 * K_BYTES + STAGES * STAGE_BYTES + 8 * (1 + 2 * STAGES);
  static constexpr int NS = BQ / 2;              // score accumulators a thread
  static_assert(T_BYTES % 1024 == 0 && STAT_ROW * 4 <= DELTA_OFF &&
                DELTA_OFF + STAT_ROW * 4 <= STAT_BYTES, "stage layout");
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_dkv_sm90(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
               const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap g_map,
               const __grid_constant__ CUtensorMap lse_map,
               const __grid_constant__ CUtensorMap delta_map, const int* __restrict__ lengths,
               Output<bf16> dk, Output<bf16> dv, int T, int H, int causal, float scale,
               float scale_log2) {
  using G = DkvGeo<D>;
  constexpr int BK = G::BK, BQ = G::BQ, HV = G::HALVES, ST = G::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* skk = base;                                             // [HV][BK][64]
  uint8_t* svv = base + G::K_BYTES;
  auto sq = [&](int s) { return base + 2 * G::K_BYTES + s * G::STAGE_BYTES; };   // [HV][BQ][64]
  auto sdo = [&](int s) { return sq(s) + G::T_BYTES; };
  auto slse = [&](int s) { return reinterpret_cast<float*>(sdo(s) + G::T_BYTES); };
  auto sdelta = [&](int s) { return reinterpret_cast<float*>(sdo(s) + G::T_BYTES + G::DELTA_OFF); };
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(base + 2 * G::K_BYTES + ST * G::STAGE_BYTES);
  uint64_t* full = kvbar + 1;
  uint64_t* empty = full + ST;

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = blockIdx.x * BK;                // the first key tiles see the most queries
  const int len = flash::clamp_length(lengths, b, T);
  const int first = causal ? k0 / BQ : 0;        // the query tile holding the first key
  const int n = k0 < len ? (T + BQ - 1) / BQ - first : 0;   // else every key is masked
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    bar_init(kvbar, 1);
    for (int s = 0; s < ST; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // kLoader loads k and v once, then q and dout tiles with their lse and
  // delta rows STAGES ahead: tile i + STAGES into tile i's stage once both
  // warpgroups have released it (refill, called where warpgroup 1 releases
  // tile i + 1, by when warpgroup 0 has long released tile i). The rows
  // come from 1-d maps over all (b, h, t), each box from the 16-byte
  // boundary at or below the tile's first query (TMA's rule; with T % 4 !=
  // 0 a row starts between boundaries) and 4 values longer: past T they
  // read the next row's values or zeros, where p is masked.
  const long long stat = (static_cast<long long>(b) * H + h) * T;
  auto stat_at = [&](int i) { return stat + static_cast<long long>(first + i) * BQ; };
  auto load = [&](int i) {
    const int s = i % ST;
    const int q0 = (first + i) * BQ;
    bar_expect(&full[s], 2 * G::T_BYTES + 2 * G::STAT_ROW * 4);
    for (int hv = 0; hv < HV; ++hv) {
      tma_load_4d(sq(s) + hv * BQ * 128, &q_map, 64 * hv, h, q0, b, &full[s]);
      tma_load_4d(sdo(s) + hv * BQ * 128, &g_map, 64 * hv, h, q0, b, &full[s]);
    }
    const int c0 = static_cast<int>(stat_at(i) & ~3ll);
    tma_load_1d(slse(s), &lse_map, c0, &full[s]);
    tma_load_1d(sdelta(s), &delta_map, c0, &full[s]);
  };
  auto refill = [&](int i) {
    if (threadIdx.x == kLoader && i + ST < n) {
      bar_wait(&empty[i % ST], (i / ST) & 1);
      load(i + ST);
    }
  };
  if (threadIdx.x == kLoader && n > 0) {
    bar_expect(kvbar, 2 * G::K_BYTES);
    for (int hv = 0; hv < HV; ++hv) {
      tma_load_4d(skk + hv * BK * 128, &k_map, 64 * hv, h, k0, b, kvbar);
      tma_load_4d(svv + hv * BK * 128, &v_map, 64 * hv, h, k0, b, kvbar);
    }
    for (int i = 0; i < ST && i < n; ++i) load(i);
  }

  // keys [64 wg, 64 wg + 64) of the block; broadcast from lane 0, so that
  // ptxas sees the branches around the wgmmas as warp-uniform (a divergent
  // one makes it serialize them)
  const int wg = __shfl_sync(flash::kFull, warp / 4, 0);
  const int g = lane / 4, t = lane % 4;
  const int kw0 = k0 + 64 * wg;                  // the warpgroup's first key
  const int kr = kw0 + 16 * (warp % 4) + g;      // this thread's keys kr, kr + 8

  float acc_k[HV][32], acc_v[HV][32];
#pragma unroll
  for (int hv = 0; hv < HV; ++hv)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      acc_k[hv][i] = 0.0f;
      acc_v[hv][i] = 0.0f;
    }

  float sc[G::NS], dp[G::NS];
  unsigned ahi[BQ / 16][4], alo[BQ / 16][4], dhi[BQ / 16][4], dlo[BQ / 16][4];

  // The two stages of tile i's products, each straight-line code from the
  // fence to the wait (a stage split across branches makes ptxas serialize
  // the wgmmas), with independent chains of accumulation interleaved, so
  // that one chain's latency does not stall the tensor cores (an m64n64k16
  // step is 32 cycles of work): the scores (q . k)^T and (dout . v)^T, then
  // dv += p^T . dout and dk += ds^T . q.
  auto scores = [&](int i) {
    const int s = i % ST;
#pragma unroll
    for (int e = 0; e < G::NS; ++e) {
      fence_operand(sc[e]);
      fence_operand(dp[e]);
    }
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      wgmma_bf16_ss<BQ>(sc, desc_k_major<BK>(skk, 64 * wg, ks), desc_k_major<BQ>(sq(s), 0, ks),
                        ks > 0);
      wgmma_bf16_ss<BQ>(dp, desc_k_major<BK>(svv, 64 * wg, ks), desc_k_major<BQ>(sdo(s), 0, ks),
                        ks > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int e = 0; e < G::NS; ++e) {
      fence_operand(sc[e]);
      fence_operand(dp[e]);
    }
  };
  auto fence_acc = [&]() {
#pragma unroll
    for (int hv = 0; hv < HV; ++hv)
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        fence_operand(acc_k[hv][e]);
        fence_operand(acc_v[hv][e]);
      }
  };
  auto accumulate = [&](int i) {
    const int s = i % ST;
    fence_acc();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        fence_operand(ahi[kk][e]);
        fence_operand(alo[kk][e]);
        fence_operand(dhi[kk][e]);
        fence_operand(dlo[kk][e]);
      }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
      for (int hv = 0; hv < HV; ++hv) {          // dout and q MN-major as stored
        const uint64_t dg = desc_sw128_mn(sdo(s) + hv * BQ * 128 + kk * 2048);
        const uint64_t dq_ = desc_sw128_mn(sq(s) + hv * BQ * 128 + kk * 2048);
        wgmma_bf16_rs_tb_n64(acc_v[hv], alo[kk], dg, 1);
        wgmma_bf16_rs_tb_n64(acc_k[hv], dlo[kk], dq_, 1);
        wgmma_bf16_rs_tb_n64(acc_v[hv], ahi[kk], dg, 1);
        wgmma_bf16_rs_tb_n64(acc_k[hv], dhi[kk], dq_, 1);
      }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc();
  };
  // tile i's p^T and ds^T from its scores, each in two bf16 pieces
  auto grads = [&](int i) {
    const int q0 = (first + i) * BQ;
    const int off = static_cast<int>(stat_at(i) & 3);
    const float* ls = slse(i % ST) + off;
    const float* dl = sdelta(i % ST) + off;
    // every query of the tile (all before T) sees every key of the warpgroup
    const bool all = q0 + BQ <= T && kw0 + 64 <= len && (!causal || q0 >= kw0 + 63);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1);
        const int qp = q0 + c;
        const int kp = kr + 8 * (e / 2);
        const float e2 = flash::exp2_ftz(fmaf(sc[4 * j + e], scale_log2, -ls[c] * kLog2e));
        const bool vis = qp < T && flash::visible(qp, kp, len, causal);
        const float p = all || vis ? e2 : 0.0f;
        sc[4 * j + e] = p;                                       // p^T
        dp[4 * j + e] = p * (dp[4 * j + e] - dl[c]) * scale;     // ds^T
      }
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      a_from_acc(sc, kk, ahi[kk], alo[kk]);
      a_from_acc(dp, kk, dhi[kk], dlo[kk]);
    }
  };
  auto release = [&](int i) {
    bar_arrive(&empty[i % ST]);
    if (i > 0) refill(i - 1);
  };
  // The warpgroup's tiles: from the first whose last query reaches its first
  // key (causal), none where every key is masked. Before them it only waits
  // for the tiles and releases them.
  int i0 = n;
  if (kw0 < len) i0 = causal ? min(n, kw0 / BQ - first) : 0;
  for (int i = 0; i < i0; ++i) {
    bar_wait(&full[i % ST], (i / ST) & 1);
    release(i);
  }
  if (i0 < n) bar_wait(kvbar, 0);
  const bool probed = b == 0 && h == 0 && blockIdx.x == 0;   // FLASH_SM90_PHASE's block
  (void)probed;
  for (int i = i0; i < n; ++i) {
    FLASH_SM90_PHASE(probed, wg, i, 0);
    bar_wait(&full[i % ST], (i / ST) & 1);
    FLASH_SM90_PHASE(probed, wg, i, 1);
    scores(i);
    FLASH_SM90_PHASE(probed, wg, i, 2);
    grads(i);
    FLASH_SM90_PHASE(probed, wg, i, 3);
    accumulate(i);
    FLASH_SM90_PHASE(probed, wg, i, 4);
    release(i);
    FLASH_SM90_PHASE(probed, wg, i, 5);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int kp = kr + 8 * half;
    if (kp >= T) continue;
    bf16* rk = dk.head(b, h) + kp * dk.st;
    bf16* rv = dv.head(b, h) + kp * dv.st;
#pragma unroll
    for (int hv = 0; hv < HV; ++hv)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = 64 * hv + 8 * j + 2 * t;
        const int e = 4 * j + 2 * half;
        *reinterpret_cast<__nv_bfloat162*>(rk + d) =
            __floats2bfloat162_rn(acc_k[hv][e], acc_k[hv][e + 1]);
        *reinterpret_cast<__nv_bfloat162*>(rv + d) =
            __floats2bfloat162_rn(acc_v[hv][e], acc_v[hv][e + 1]);
      }
  }
}

template <int D>
int launch_dkv(const Args<bf16>& a, const float* lse, const float* delta, const int* lengths,
               Output<bf16> dk, Output<bf16> dv, int B, int T, int H, int causal,
               cudaStream_t stream) {
  using G = DkvGeo<D>;
  CUtensorMap qm, km, vm, gm;
  // lse and delta [B, H, T] as one row of B H T floats (TMA's coordinates
  // are 32-bit)
  CUtensorMap lm, dm;
  const cuuint64_t rows[1] = {static_cast<cuuint64_t>(B) * H * T};
  const cuuint64_t unused[1] = {16};
  const cuuint32_t box[1] = {G::STAT_ROW};
  if (rows[0] >= (1ull << 31)) return static_cast<int>(cudaErrorNotSupported);
  if (!tensor_map(&lm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, lse, 1, rows, unused, box,
                  CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !tensor_map(&dm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, delta, 1, rows, unused, box,
                  CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !flash::operand_map(&qm, a.q.ptr, a.q.sb, a.q.st, a.q.sh, B, T, H, D, G::BQ) ||
      !flash::operand_map(&km, a.k.ptr, a.k.sb, a.k.st, a.k.sh, B, T, H, D, G::BK) ||
      !flash::operand_map(&vm, a.v.ptr, a.v.sb, a.v.st, a.v.sh, B, T, H, D, G::BK) ||
      !flash::operand_map(&gm, a.dout.ptr, a.dout.sb, a.dout.st, a.dout.sh, B, T, H, D, G::BQ))
    return static_cast<int>(cudaErrorNotSupported);
  cudaError_t err = allow_smem(flash_dkv_sm90<D>, G::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = flash::softmax_scale(D);
  const dim3 grid((T + G::BK - 1) / G::BK, H, B);
  flash_dkv_sm90<D><<<grid, kThreads, G::SMEM, stream>>>(
      qm, km, vm, gm, lm, dm, lengths, dk, dv, T, H, causal, scale, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

// ---- the bf16 dQ body for Hopper (flash_attn_dq_bf16_sm90) ----

// D = 64 or 128; a block owns 128 queries, two warpgroups of 64, and
// streams key tiles of BK keys (K and V: 8 KB each at both widths).
template <int D>
struct DqGeo {
  static constexpr int BQ = 64 * kConsumers;     // queries of a block
  static constexpr int BK = D == 64 ? 64 : 32;   // keys of a stage
  static constexpr int HALVES = D / 64;
  static constexpr int STAGES = 6;
  static constexpr int Q_BYTES = BQ * D * 2;     // the block's Q, and its dO
  static constexpr int T_BYTES = BK * D * 2;     // a K or a V tile
  static constexpr int STAGE_BYTES = 2 * T_BYTES;
  static constexpr int SMEM = 1024 + 2 * Q_BYTES + STAGES * STAGE_BYTES + 8 * (1 + 2 * STAGES);
  static constexpr int NS = BK / 2;              // score accumulators a thread
  static constexpr int KK = BK / 16;             // k steps of ds . K
  static_assert(Q_BYTES % 1024 == 0 && T_BYTES % 1024 == 0, "swizzle atoms");
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_dq_sm90(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
              const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap g_map,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const int* __restrict__ lengths, Output<bf16> dq, int T, int H, int causal,
              float scale, float scale_log2) {
  using G = DqGeo<D>;
  constexpr int BQ = G::BQ, BK = G::BK, HV = G::HALVES, ST = G::STAGES, KK = G::KK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* sq = base;                                              // [HV][BQ][64]
  uint8_t* sdo = base + G::Q_BYTES;
  auto sk = [&](int s) { return base + 2 * G::Q_BYTES + s * G::STAGE_BYTES; };   // [HV][BK][64]
  auto sv = [&](int s) { return sk(s) + G::T_BYTES; };
  uint64_t* qbar = reinterpret_cast<uint64_t*>(base + 2 * G::Q_BYTES + ST * G::STAGE_BYTES);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + ST;

  const int iq = gridDim.x - 1 - blockIdx.x;                       // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = iq * BQ;
  const int len = flash::clamp_length(lengths, b, T);
  const int kend = causal ? min(len, q0 + BQ) : len;               // keys [0, kend) can be visible
  const int tiles = kend > 0 ? (kend + BK - 1) / BK : 0;           // else dq = 0
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    bar_init(qbar, 1);
    for (int s = 0; s < ST; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // kLoader loads q and dout once and k and v tiles STAGES ahead, as the
  // forward's loader: tile it + STAGES into tile it's stage once both
  // warpgroups have released it (refill, called where warpgroup 1 releases
  // tile it + 1). Key tiles past the block's keys are not read.
  auto load = [&](int it) {
    const int s = it % ST;
    bar_expect(&full[s], G::STAGE_BYTES);
    for (int hv = 0; hv < HV; ++hv) {
      tma_load_4d(sk(s) + hv * BK * 128, &k_map, 64 * hv, h, it * BK, b, &full[s]);
      tma_load_4d(sv(s) + hv * BK * 128, &v_map, 64 * hv, h, it * BK, b, &full[s]);
    }
  };
  auto refill = [&](int it) {
    if (threadIdx.x == kLoader && it + ST < tiles) {
      bar_wait(&empty[it % ST], (it / ST) & 1);
      load(it + ST);
    }
  };
  if (threadIdx.x == kLoader && tiles > 0) {
    bar_expect(qbar, 2 * G::Q_BYTES);
    for (int hv = 0; hv < HV; ++hv) {
      tma_load_4d(sq + hv * BQ * 128, &q_map, 64 * hv, h, q0, b, qbar);
      tma_load_4d(sdo + hv * BQ * 128, &g_map, 64 * hv, h, q0, b, qbar);
    }
    for (int it = 0; it < ST && it < tiles; ++it) load(it);
  }

  // query rows [64 wg, 64 wg + 64) of the block; broadcast from lane 0, so
  // that ptxas sees the branches around the wgmmas as warp-uniform
  const int wg = __shfl_sync(flash::kFull, warp / 4, 0);
  const int g = lane / 4, t = lane % 4;
  const int r0 = q0 + 64 * wg;                   // the warpgroup's first query
  const int rq = r0 + 16 * (warp % 4) + g;       // this thread's queries rq, rq + 8
  // the warpgroup's tiles: (causal) none wholly after its last query, where
  // p = 0 and ds = 0
  const int mine = causal ? min(tiles, (r0 + 63) / BK + 1) : tiles;
  // the rows' lse (base 2, negated) and delta, read once
  const long long stat = (static_cast<long long>(b) * H + h) * T;
  float neg_lse2[2], row_delta[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qp = rq + 8 * half;
    neg_lse2[half] = qp < T ? -lse[stat + qp] * kLog2e : 0.0f;
    row_delta[half] = qp < T ? delta[stat + qp] : 0.0f;
  }

  float acc[HV][32];
#pragma unroll
  for (int hv = 0; hv < HV; ++hv)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[hv][i] = 0.0f;

  // Per key tile two stages of products, each straight-line code from the
  // fence to the wait: s = q . k^T and dp = dout . v^T (two independent
  // chains, interleaved); p and ds on them and ds in two bf16 pieces; then
  // a tile's dq partial ds . K with K read MN-major from its tile. The
  // partial is summed apart (scale_d 0 at its first step) in two
  // independent chains, at D = 64 one a piece, at D = 128 one a half of
  // dq's features, and added to acc with rounded float32 adds, as the
  // float32 body sums a streamed tile apart.
  const bool probed = b == 0 && h == 0 && iq == gridDim.x - 1;   // FLASH_SM90_PHASE's block
  (void)probed;
  if (tiles > 0) bar_wait(qbar, 0);
  for (int r = 0; r < mine; ++r) {
    FLASH_SM90_PHASE(probed, wg, r, 0);
    const int s = r % ST;
    bar_wait(&full[s], (r / ST) & 1);
    FLASH_SM90_PHASE(probed, wg, r, 1);
    float sc[G::NS], dp[G::NS];
#pragma unroll
    for (int i = 0; i < G::NS; ++i) {
      fence_operand(sc[i]);
      fence_operand(dp[i]);
    }
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      wgmma_bf16_ss<BK>(sc, desc_k_major<BQ>(sq, 64 * wg, ks), desc_k_major<BK>(sk(s), 0, ks),
                        ks > 0);
      wgmma_bf16_ss<BK>(dp, desc_k_major<BQ>(sdo, 64 * wg, ks), desc_k_major<BK>(sv(s), 0, ks),
                        ks > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < G::NS; ++i) {
      fence_operand(sc[i]);
      fence_operand(dp[i]);
    }

    FLASH_SM90_PHASE(probed, wg, r, 2);
    const int k0 = r * BK;
    // every key of the tile visible to every query of the warpgroup
    const bool all = k0 + BK <= len && (!causal || k0 + BK - 1 <= r0);
    // p and ds as the dK/dV body's grads (transposed there); a copy, not a
    // function both call: taking that step out of grads moved ptxas's
    // allocation of the dK/dV body (194 and 220 registers against 192 and
    // 218, its SASS changed)
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e / 2;
        const int kp = k0 + 8 * j + 2 * t + (e & 1);
        const float e2 = flash::exp2_ftz(fmaf(sc[4 * j + e], scale_log2, neg_lse2[half]));
        const float p = all || flash::visible(rq + 8 * half, kp, len, causal) ? e2 : 0.0f;
        dp[4 * j + e] = p * (dp[4 * j + e] - row_delta[half]) * scale;   // ds
      }
    unsigned dhi[KK][4], dlo[KK][4];
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      a_from_acc(dp, kk, dhi[kk], dlo[kk]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        fence_operand(dhi[kk][e]);
        fence_operand(dlo[kk][e]);
      }
    }
    FLASH_SM90_PHASE(probed, wg, r, 3);
    float part[2][32];
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) fence_operand(part[c][i]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
#pragma unroll
      for (int hv = 0; hv < HV; ++hv) {          // K MN-major as stored
        const uint64_t dk = desc_sw128_mn(sk(s) + hv * BK * 128 + kk * 2048);
        if constexpr (HV == 1) {
          wgmma_bf16_rs_tb_n64(part[0], dlo[kk], dk, kk > 0);
          wgmma_bf16_rs_tb_n64(part[1], dhi[kk], dk, kk > 0);
        } else {
          wgmma_bf16_rs_tb_n64(part[hv], dlo[kk], dk, kk > 0);
          wgmma_bf16_rs_tb_n64(part[hv], dhi[kk], dk, 1);
        }
      }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) fence_operand(part[c][i]);
#pragma unroll
    for (int hv = 0; hv < HV; ++hv)
#pragma unroll
      for (int i = 0; i < 32; ++i)
        acc[hv][i] += HV == 1 ? part[0][i] + part[1][i] : part[hv][i];
    FLASH_SM90_PHASE(probed, wg, r, 4);
    bar_arrive(&empty[s]);
    if (r > 0) refill(r - 1);
    FLASH_SM90_PHASE(probed, wg, r, 5);
  }
  for (int r = mine; r < tiles; ++r) {
    bar_wait(&full[r % ST], (r / ST) & 1);
    bar_arrive(&empty[r % ST]);
    if (r > 0) refill(r - 1);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qp = rq + 8 * half;
    if (qp >= T) continue;
    bf16* row = dq.head(b, h) + qp * dq.st;
#pragma unroll
    for (int hv = 0; hv < HV; ++hv)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(row + 64 * hv + 8 * j + 2 * t) =
            __floats2bfloat162_rn(acc[hv][4 * j + 2 * half], acc[hv][4 * j + 2 * half + 1]);
  }
}

template <int D>
int launch_dq(const Args<bf16>& a, const float* lse, const float* delta, const int* lengths,
              Output<bf16> dq, int B, int T, int H, int causal, cudaStream_t stream) {
  using G = DqGeo<D>;
  CUtensorMap qm, km, vm, gm;
  if (!flash::operand_map(&qm, a.q.ptr, a.q.sb, a.q.st, a.q.sh, B, T, H, D, G::BQ) ||
      !flash::operand_map(&km, a.k.ptr, a.k.sb, a.k.st, a.k.sh, B, T, H, D, G::BK) ||
      !flash::operand_map(&vm, a.v.ptr, a.v.sb, a.v.st, a.v.sh, B, T, H, D, G::BK) ||
      !flash::operand_map(&gm, a.dout.ptr, a.dout.sb, a.dout.st, a.dout.sh, B, T, H, D, G::BQ))
    return static_cast<int>(cudaErrorNotSupported);
  cudaError_t err = allow_smem(flash_dq_sm90<D>, G::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = flash::softmax_scale(D);
  const dim3 grid((T + G::BQ - 1) / G::BQ, H, B);
  flash_dq_sm90<D><<<grid, kThreads, G::SMEM, stream>>>(
      qm, km, vm, gm, lse, delta, lengths, dq, T, H, causal, scale, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90

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

// The bf16 dK/dV body for Hopper: the arguments of flash_attn_dkv_bf16, D =
// 64 or 128, and q, k, v and dout as TMA reads them (flash_attention.py's
// sm90_takes): base 16-byte aligned, batch, time and head strides multiples
// of 8 values. Returns cudaErrorInvalidValue for any other shape, and
// cudaErrorNotSupported where a tensor map cannot be made.
extern "C" int flash_attn_dkv_bf16_sm90(FLASH_BWD_QKVG, const void* lse, const void* delta,
                                        const void* lengths, void* dk, long long dk_sb,
                                        long long dk_st, long long dk_sh, void* dv,
                                        long long dv_sb, long long dv_st, long long dv_sh, int B,
                                        int T, int H, int D, int causal, void* stream) {
  const Args<bf16> a(FLASH_BWD_ARGS);
  if ((D != 64 && D != 128) || !rows_16b(a.q, a.k, a.v, a.dout, D))
    return static_cast<int>(cudaErrorInvalidValue);
  const Output<bf16> odk{static_cast<bf16*>(dk), dk_sb, dk_st, dk_sh};
  const Output<bf16> odv{static_cast<bf16*>(dv), dv_sb, dv_st, dv_sh};
  return (D == 64 ? sm90::launch_dkv<64> : sm90::launch_dkv<128>)(
      a, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(lengths), odk, odv, B, T, H, causal,
      static_cast<cudaStream_t>(stream));
}

// The bf16 dQ body for Hopper: the arguments of flash_attn_dq_bf16, D = 64
// or 128, and q, k, v and dout as TMA reads them (flash_attention.py's
// sm90_takes); lse and delta are read with plain loads (no alignment asked).
// Returns cudaErrorInvalidValue for any other shape, and
// cudaErrorNotSupported where a tensor map cannot be made.
extern "C" int flash_attn_dq_bf16_sm90(FLASH_BWD_QKVG, const void* lse, const void* delta,
                                       const void* lengths, void* dq, long long d_sb,
                                       long long d_st, long long d_sh, int B, int T, int H, int D,
                                       int causal, void* stream) {
  const Args<bf16> a(FLASH_BWD_ARGS);
  if ((D != 64 && D != 128) || !rows_16b(a.q, a.k, a.v, a.dout, D))
    return static_cast<int>(cudaErrorInvalidValue);
  const Output<bf16> od{static_cast<bf16*>(dq), d_sb, d_st, d_sh};
  return (D == 64 ? sm90::launch_dq<64> : sm90::launch_dq<128>)(
      a, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(lengths), od, B, T, H, causal, static_cast<cudaStream_t>(stream));
}
