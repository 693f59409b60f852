// flash_attn_fwd — length-masked, optionally causal attention by online
// softmax, one launch for all (batch, head, query tile).
//
// Replaces: paddle_tpu/ops/pallas_attention.py _fwd_kernel (launched by
// pl.pallas_call in _run_fwd), the forward of the JAX package's flash
// attention. Per (b, h) with scale = 1 / sqrt(D) and len = lengths[b]:
//   s[q, k]  = (q[q] * scale) . k[k]          masked to -1e30 unless
//              k < len and (not causal or k <= q)
//   m, l     = running row max and sum; per key tile
//              m' = max(m, max_k s), alpha = exp(m - m'),
//              p = exp(s - m') where visible else 0 (never by underflow),
//              l = l alpha + sum_k p,  o = o alpha + p . v
//   out[q]   = o / max(l, 1e-20);   lse[q] = m + log(max(l, 1e-20)) if l > 0
//              else -1e30 (a query that sees no key gets out = 0).
// q, k, v and out are [B, T, H, D] with any batch, time and head strides (the
// multi-head layer passes strided views of its fused qkv projection); lse is
// [B, H, T] and optional (the test pass does not ask for it).
//
// What bounds it on an H100: at B = 8, H = 8, T = 2048, D = 64, causal, the
// function moves 134.7 MB (0.040 ms at 3.35 TB/s) and does 2 B H T^2 D =
// 34.4 GFLOP (0.513 ms at the 67 TFLOP/s float32 rate of the CUDA cores).
// The first design ran both products there, with both operands in shared
// memory and each key tile loaded between two barriers: 1.72-1.82 ms, 1.4x
// PyTorch's scaled_dot_product_attention.
//
// What this design does about it (FlashAttention-2's split, as the JAX
// package's, on flash_mma.cuh's tensor-core machinery):
// - Both products run on the tensor cores, mma.sync m16n8k8 TF32 with the
//   3-pass split, which keeps float32 accuracy: 3 x 34.4 GFLOP at 495
//   TFLOP/s bounds it at 0.208 ms.
// - A block of 4 warps owns BR query rows; a warp owns a strip of 16 (and,
//   at D = 128 and 256, WF = 2: half the output features; two warps
//   recompute the strip's scores). The query tile is pre-scaled and split once per block:
//   up to DMAX = 64 each warp keeps its strip's big and small A fragments in
//   registers (64 at D = 64); beyond, the block keeps both halves in shared
//   memory.
// - Per key tile of BC rows a warp computes the score tile [16 x BC] in
//   C fragments, takes the online softmax on them in registers (a row is
//   the 4 lanes of a quad: 2 shuffles per reduction), and feeds p as the A
//   operand of p . v straight from the accumulators (k permuted,
//   flash_mma.cuh). The tensor core truncates as it accumulates, so each
//   tile's p . v is summed apart and added to o with rounded float32 adds.
// - Key and value tiles go through a 2-stage cp.async ring (16-byte copies
//   where the operands allow): tile i + 1 loads while tile i is used.
// - Key tiles wholly at or past the length, or (causal) past the tile's
//   last query, are skipped, and a warp skips a tile past its strip's last
//   query: their p is 0 and alpha 1, so skipping them changes no bit.
//   Blocks are launched heaviest first (the last query tiles see the most
//   keys under a causal mask). No atomics: two launches give equal bits.
//
// The bf16 instance (flash_attn_fwd_bf16) keeps the Pallas kernel's bf16
// contract: q, k and v bf16, widened to float32 (q scaled there), the online
// softmax and o in float32, out rounded once to bf16, lse float32. The same
// body on the storage type S: key and value tiles are widened into the
// float32 tiles by plain 16-byte loads (cp.async cannot widen), and the
// products drop the passes of an exact factor (flash_mma.cuh): k and v are
// bf16, so P . V takes two passes, and Q . K^T two, or one where 1 / sqrt(D)
// is a power of two (D = 16, 64, 256: q * scale is then bf16-exact too).
// It takes the bf16 shapes the Hopper body below does not: D other than 64
// and 128, an unaligned base, strides TMA cannot read.
//
// The bf16 body for Hopper (flash_attn_fwd_bf16_sm90) takes D = 64 and 128
// with every operand as TMA reads it (flash_attention.py's sm90_takes).
// What bounds it: at the LM's shape (B = 8, H = 8, T = 2048, D = 64, causal)
// 34.4 GFLOP, 0.035 ms at the 989 TFLOP/s bf16 rate. The contract keeps p in
// float32 and bf16 tensor cores take bf16 operands, so p enters P . V as two
// bf16 pieces, hi = bf16(p) and lo = bf16(p - hi) (~16 bits of p; one piece
// alone does not hold the outputs within a bf16 ulp of the contract's,
// tests/test_torch_flash_attention.py): 1.5 passes a product, a design bound
// of 0.052 ms. Then the softmax: 2^x on
// the MUFU unit (16 a cycle an SM) and ~8 other instructions per score.
// What the design does about it:
// - TMA reads bf16 q, k and v tiles straight from the strided [B, T, H, D]
//   views (a 4-d tensor map, dims (D, H, T, B), the 128-byte swizzle, zeros
//   past T); one thread keeps a ring of 4 k/v stages in flight on mbarriers.
// - A block is two warpgroups of 64 query rows. Each runs s = q . k^T as
//   wgmma m64nBCk16 (BC = 128 keys at D = 64, 64 at D = 128), both operands
//   K-major from shared memory; the online softmax in float32 on the
//   accumulators in base 2 (the max of the raw scores, p by one FFMA and
//   ex2.approx.ftz, a masked p 0 by a select, a row on the 4 lanes of a
//   quad; branch-free where the whole tile is visible); then o += p . v as
//   wgmma m64n64k16 with p's pieces as A from registers (an accumulator's
//   lanes hold an A fragment's: no shuffle) and v as B read MN-major from
//   its tile (transposed by the instruction).
// - p . v runs as two independent chains of steps (one chain of 16
//   m64n64k16 steps, 32 cycles of work each, waits on every step's
//   latency): at D = 64 one a piece, each summed apart and added to o,
//   scaled by alpha first, with rounded float32 adds; at D = 128 one a half
//   of o's features.
// - scale log2(e) multiplies s in float32: at D = 64 1 / sqrt(D) is a power
//   of two and s scale equals the contract's (q scale) . k exactly; at
//   D = 128 that product takes one more float32 rounding.
// - out is rounded once to bf16, lse is float32, the light launch gives the
//   training launch's bits; key tiles past the length or (causal) the
//   block's last query are not loaded, and a warpgroup skips a tile wholly
//   after its last query. No atomics: two launches give equal bits.

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

// The query strip's split A fragments: in registers up to DMAX = 64, else
// read from the block's split tile in shared memory.
template <class C>
struct QStrip {
  static constexpr bool kInRegisters = C::DMAX <= 64;
  FragA reg[kInRegisters ? C::KS : 1];
  const unsigned* big;
  const unsigned* small;
  int r0, g, t;

  __device__ __forceinline__ void get(FragA& a, int ks) const {
    if constexpr (kInRegisters) {
      a = reg[ks];
    } else {
      flash_mma::load_a_split<C::LD>(a, big, small, r0, 8 * ks, g, t);
    }
  }
};

// s[j] = q strip . k[8j .. 8j + 8)^T over the DMAX features (zeros past D);
// kExactQ, kExactK: the factors exact in TF32 (mma_passes).
template <class C, bool kExactQ, bool kExactK>
__device__ __forceinline__ void score_tile(float (&s)[C::NS][4], const QStrip<C>& q,
                                           const float* kt, int g, int t) {
#pragma unroll
  for (int j = 0; j < C::NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < C::KS; ++ks) {
    FragA a;
    q.get(a, ks);
#pragma unroll
    for (int j = 0; j < C::NS; ++j) {
      FragB b;
      flash_mma::load_b_cols<C::LD>(b, kt, 8 * j, 8 * ks, g, t);
      if constexpr (C::KS > 8) {
        flash_mma::mma_passes_apart<kExactQ, kExactK>(s[j], a, b);
      } else {
        flash_mma::mma_passes<kExactQ, kExactK>(s[j], a, b);
      }
    }
  }
}

// o += p . v over the tile's BC keys, v's features [f0, f0 + DACC); p in
// C layout (a_from_c), one A fragment at a time. The tile is summed apart
// and added to o with rounded float32 adds, 8 n-tiles at a time: at
// DACC = 128 a 32-float partial sum beside the 64-float o, which fits the
// registers (a 64-float one spilled). kExactV: v exact in TF32.
template <class C, bool kExactV>
__device__ __forceinline__ void accumulate(float (&o)[C::NA][4], const float (&p)[C::NS][4],
                                           const float* vt, int f0, int g, int t) {
  constexpr int NB = C::NA < 8 ? C::NA : 8;
#pragma unroll
  for (int n0 = 0; n0 < C::NA; n0 += NB) {
    float part[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[n][e] = 0.0f;
#pragma unroll
    for (int j = 0; j < C::NS; ++j) {
      FragA a;
      flash_mma::a_from_c(a, p[j]);
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        FragB b;
        flash_mma::load_b_rows<C::LD>(b, vt, 8 * j, f0 + 8 * (n0 + n), g, t);
        flash_mma::mma_passes<false, kExactV>(part[n], a, b);
      }
    }
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n0 + n][e] += part[n][e];
  }
}

// A row's reduction over the 4 lanes of its quad (the lanes that share g).
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(flash::kFull, v, 1));
  return fmaxf(v, __shfl_xor_sync(flash::kFull, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(flash::kFull, v, 1);
  return v + __shfl_xor_sync(flash::kFull, v, 2);
}

// S: the storage type of q, k, v and out; kQExact: q * scale exact in TF32.
template <class C, typename S, bool kQExact>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(Operand<S> q, Operand<S> k, Operand<S> v, const int* __restrict__ lengths,
                 Output<S> out, float* __restrict__ lse, int T, int H, int D, int causal,
                 float scale, int vec) {
  constexpr bool kExactKV = !IsF32<S>::value;        // bf16 k and v are exact in TF32
  constexpr int LD = C::LD, BR = C::BR, BC = C::BC;
  constexpr bool kQReg = QStrip<C>::kInRegisters;
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;                                    // [BR][LD]: q, then its big half
  unsigned* sq_small = reinterpret_cast<unsigned*>(sq + BR * LD);   // [BR][LD] unless kQReg
  float* sk = sq + (kQReg ? 1 : 2) * BR * LD;          // [2][BC][LD]
  float* sv = sk + 2 * BC * LD;                        // [2][BC][LD]

  const int iq = gridDim.x - 1 - blockIdx.x;           // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = iq * BR;
  const int len = flash::clamp_length(lengths, b, T);
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) / 4;
  const int t = threadIdx.x % 4;
  const int r0 = (warp / C::WF) * 16;                  // the warp's strip in the tile
  const int f0 = (warp % C::WF) * C::DACC;
  const S* kh = k.head(b, h);
  const S* vh = v.head(b, h);

  QStrip<C> qs;
  qs.big = reinterpret_cast<const unsigned*>(sq);
  qs.small = sq_small;
  qs.r0 = r0;
  qs.g = g;
  qs.t = t;
  const int kend = causal ? min(len, q0 + BR) : len;   // keys [0, kend) can be visible
  const int tiles = kend > 0 ? (kend + BC - 1) / BC : 0;
  if (tiles > 0) {                                     // else out = 0, lse = -1e30
    flash_mma::load_tile_async<C::DMAX, BR>(sq, q.head(b, h), q.st, q0, T, D, vec);
    cp_async_commit();
    flash_mma::load_tile_async<C::DMAX, BC>(sk, kh, k.st, 0, T, D, vec);
    flash_mma::load_tile_async<C::DMAX, BC>(sv, vh, v.st, 0, T, D, vec);
    cp_async_commit();
    cp_async_wait<1>();                                // q has landed
    __syncthreads();
    if constexpr (kQReg) {
#pragma unroll
      for (int ks = 0; ks < C::KS; ++ks) {
        const float* p = sq + (r0 + g) * LD + 8 * ks + t;
        qs.reg[ks].set(p[0] * scale, p[8 * LD] * scale, p[4] * scale, p[8 * LD + 4] * scale);
      }
    } else {
      unsigned* big = reinterpret_cast<unsigned*>(sq);
      for (int e = threadIdx.x; e < BR * C::DMAX; e += kThreads) {
        const int i = (e / C::DMAX) * LD + e % C::DMAX;
        flash_mma::split(sq[i] * scale, big[i], sq_small[i]);
      }
    }
  }

  float o[C::NA][4], m[2], l[2];
  flash_mma::zero<C>(o);
  m[0] = m[1] = flash::kNeg;
  l[0] = l[1] = 0.0f;

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
    __syncthreads();                                   // the stage (and the split q) is in
    // the strip sees no key of this tile: p = 0 and alpha = 1
    if (!causal || k0 <= q0 + r0 + 15) {
      const float* kt = sk + stage * BC * LD;
      const float* vt = sv + stage * BC * LD;
      float s[C::NS][4];
      score_tile<C, kQExact, kExactKV>(s, qs, kt, g, t);
      // every key of the tile visible to every query of the strip
      const bool all = k0 + BC <= len && (!causal || k0 + BC - 1 <= q0 + r0);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int qp = q0 + r0 + g + 8 * half;
        float mx = flash::kNeg;
#pragma unroll
        for (int j = 0; j < C::NS; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[j][2 * half + e];
            if (!all && !flash::visible(qp, k0 + 8 * j + 2 * t + e, len, causal))
              x = flash::kNeg;
            mx = fmaxf(mx, x);
          }
        const float m_new = fmaxf(m[half], quad_max(mx));
        const float alpha = expf(m[half] - m_new);
        float ps = 0.0f;
#pragma unroll
        for (int j = 0; j < C::NS; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[j][2 * half + e];
            x = all || flash::visible(qp, k0 + 8 * j + 2 * t + e, len, causal)
                    ? expf(x - m_new) : 0.0f;
            ps += x;
          }
        l[half] = l[half] * alpha + quad_sum(ps);
        m[half] = m_new;
#pragma unroll
        for (int n = 0; n < C::NA; ++n) {
          o[n][2 * half] *= alpha;
          o[n][2 * half + 1] *= alpha;
        }
      }
      accumulate<C, kExactKV>(o, s, vt, f0, g, t);
    }
    __syncthreads();                                   // the stage is refilled next
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float l_safe = fmaxf(l[half], 1e-20f);
#pragma unroll
    for (int n = 0; n < C::NA; ++n) {
      o[n][2 * half] = o[n][2 * half] / l_safe;
      o[n][2 * half + 1] = o[n][2 * half + 1] / l_safe;
    }
    const int qp = q0 + r0 + g + 8 * half;
    if (lse != nullptr && t == 0 && warp % C::WF == 0 && qp < T)
      lse[(static_cast<long long>(b) * H + h) * T + qp] =
          l[half] > 0.0f ? m[half] + logf(l_safe) : flash::kNeg;
  }
  flash_mma::store_acc<C>(out.head(b, h), out.st, o, q0 + r0, f0, T, D, g, t);
}

template <class C, typename S, bool kQExact>
int launch(Operand<S> q, Operand<S> k, Operand<S> v, const int* lengths, Output<S> out,
           float* lse, int B, int T, int H, int D, int causal, int vec, cudaStream_t stream) {
  const int q_tiles = QStrip<C>::kInRegisters ? 1 : 2;
  const size_t smem = static_cast<size_t>(q_tiles * C::BR + 4 * C::BC) * C::LD * sizeof(float);
  cudaError_t err = allow_smem(flash_fwd_kernel<C, S, kQExact>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + C::BR - 1) / C::BR, H, B);
  flash_fwd_kernel<C, S, kQExact><<<grid, kThreads, smem, stream>>>(
      q, k, v, lengths, out, lse, T, H, D, causal, flash::softmax_scale(D), vec);
  return static_cast<int>(cudaGetLastError());
}

// Both instances' entry: the configuration by D (DMAX, warps per strip, key
// tile rows), 16-byte loads where every operand allows them.
template <typename S, bool kQExact>
int run(const void* q, long long q_sb, long long q_st, long long q_sh, const void* k,
        long long k_sb, long long k_st, long long k_sh, const void* v, long long v_sb,
        long long v_st, long long v_sh, const void* lengths, void* out, long long o_sb,
        long long o_st, long long o_sh, void* lse, int B, int T, int H, int D, int causal,
        void* stream) {
  const Operand<S> oq{static_cast<const S*>(q), q_sb, q_st, q_sh};
  const Operand<S> okk{static_cast<const S*>(k), k_sb, k_st, k_sh};
  const Operand<S> ov{static_cast<const S*>(v), v_sb, v_st, v_sh};
  const Output<S> oo{static_cast<S*>(out), o_sb, o_st, o_sh};
  const int* len = static_cast<const int*>(lengths);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kElem = sizeof(S);
  const int vec = flash_mma::rows_16b_aligned(q, q_sb, q_st, q_sh, D, kElem) &&
                  flash_mma::rows_16b_aligned(k, k_sb, k_st, k_sh, D, kElem) &&
                  flash_mma::rows_16b_aligned(v, v_sb, v_st, v_sh, D, kElem);
#define FLASH_FWD(DMAX, WF, BC) \
  launch<Cfg<DMAX, WF, BC>, S, kQExact>(oq, okk, ov, len, oo, l, B, T, H, D, causal, vec, s)
  if (D <= 16) return FLASH_FWD(16, 1, 64);
  if (D <= 32) return FLASH_FWD(32, 1, 64);
  if (D <= 64) return FLASH_FWD(64, 1, 64);
  if (D <= 128) return FLASH_FWD(128, 2, 32);
  if (D <= 256) return FLASH_FWD(256, 2, 32);
#undef FLASH_FWD
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// ---- the bf16 body for Hopper (flash_attn_fwd_bf16_sm90) ----

namespace sm90 {

using bf16 = __nv_bfloat16;
using flash::Output;
using namespace hopper;

// Two warpgroups of 64 query rows, and no warp of its own for the loads:
// ptxas allots a wgmma kernel's registers per warpgroup, so a producer warp
// or warpgroup (setmaxnreg included) capped every thread at 168 registers,
// which spilled and serialized the wgmmas; one thread (kLoader) issues the
// loads.
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * kConsumers;
constexpr int kLoader = 128;                     // thread 0 of warpgroup 1
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// D = 64 or 128. An operand row is D / 64 rows of 128 bytes: a tile of R
// rows is HALVES swizzled [R][64] images, each R x 128 bytes.
template <int D>
struct Geo {
  static constexpr int BR = 64 * kConsumers;     // query rows of a block
  static constexpr int BC = D == 64 ? 128 : 64;  // keys of a stage
  static constexpr int HALVES = D / 64;
  static constexpr int STAGES = 4;
  static constexpr int Q_BYTES = BR * D * 2;
  static constexpr int KV_BYTES = BC * D * 2;    // a K or a V tile: 16 KB at both widths
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * STAGE_BYTES + 8 * (1 + 2 * STAGES);
  static constexpr int NS = BC / 2;              // score accumulators a thread
  static constexpr int KK = BC / 16;             // k steps of p . v
  static_assert(Q_BYTES % 1024 == 0 && KV_BYTES % 1024 == 0, "swizzle atoms");
};

// The online softmax of a score tile for the thread's rows rq and rq + 8:
// sc (raw q . k) becomes p, m and l move on, alpha[half] is the factor o
// must take before p . v is added. Every key of the tile visible to every
// query of the warpgroup (`all`): no mask. The row max is taken of the raw
// scores (scale_log2 > 0 keeps the order), p = 2^(s scale_log2 - m) by one
// FFMA and a MUFU op; a masked key's p is 0 by a select, never by underflow.
template <int BC>
__device__ __forceinline__ void softmax_tile(float (&sc)[BC / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], bool all, int rq, int kc, int len,
                                             int causal, float scale_log2) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qp = rq + 8 * half;
    float mx = flash::kNeg;
    if (all) {
#pragma unroll
      for (int j = 0; j < BC / 8; ++j)
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * half], sc[4 * j + 2 * half + 1]));
    } else {
#pragma unroll
      for (int j = 0; j < BC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * j + 2 * half + e];
          x = flash::visible(qp, kc + 8 * j + e, len, causal) ? x : flash::kNeg;
          mx = fmaxf(mx, x);
        }
    }
    const float m_new = fmaxf(m[half], quad_max(mx) * scale_log2);
    alpha[half] = flash::exp2_ftz(m[half] - m_new);
    float ps = 0.0f;
#pragma unroll
    for (int j = 0; j < BC / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = sc[4 * j + 2 * half + e];
        const float p = flash::exp2_ftz(fmaf(x, scale_log2, -m_new));
        x = all || flash::visible(qp, kc + 8 * j + e, len, causal) ? p : 0.0f;
        ps += x;
      }
    l[half] = l[half] * alpha[half] + quad_sum(ps);
    m[half] = m_new;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
               const __grid_constant__ CUtensorMap v_map, const int* __restrict__ lengths,
               Output<bf16> out, float* __restrict__ lse, int T, int H, int causal,
               float scale_log2) {
  using G = Geo<D>;
  constexpr int BR = G::BR, BC = G::BC, HV = G::HALVES, ST = G::STAGES, KK = G::KK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* sq = base;                                              // [HV][BR][64]
  auto sk = [&](int s) { return base + G::Q_BYTES + s * G::STAGE_BYTES; };   // [HV][BC][64]
  auto sv = [&](int s) { return sk(s) + G::KV_BYTES; };
  uint64_t* qbar = reinterpret_cast<uint64_t*>(base + G::Q_BYTES + ST * G::STAGE_BYTES);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + ST;

  const int iq = gridDim.x - 1 - blockIdx.x;                       // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = iq * BR;
  const int len = flash::clamp_length(lengths, b, T);
  const int kend = causal ? min(len, q0 + BR) : len;               // keys [0, kend) can be visible
  const int tiles = kend > 0 ? (kend + BC - 1) / BC : 0;           // else out = 0, lse = -1e30
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

  // kLoader loads q once and k and v tiles STAGES ahead: tile it + STAGES
  // into tile it's stage once both warpgroups have released it (refill,
  // called where warpgroup 1 releases tile it + 1, by when warpgroup 0 has
  // long released tile it: the loader does not wait on it).
  auto load = [&](int it) {
    const int s = it % ST;
    bar_expect(&full[s], G::STAGE_BYTES);
    for (int hv = 0; hv < HV; ++hv) {
      tma_load_4d(sk(s) + hv * BC * 128, &k_map, 64 * hv, h, it * BC, b, &full[s]);
      tma_load_4d(sv(s) + hv * BC * 128, &v_map, 64 * hv, h, it * BC, b, &full[s]);
    }
  };
  auto refill = [&](int it) {
    if (threadIdx.x == kLoader && it + ST < tiles) {
      bar_wait(&empty[it % ST], (it / ST) & 1);
      load(it + ST);
    }
  };
  if (threadIdx.x == kLoader && tiles > 0) {
    bar_expect(qbar, G::Q_BYTES);
    for (int hv = 0; hv < HV; ++hv)
      tma_load_4d(sq + hv * BR * 128, &q_map, 64 * hv, h, q0, b, qbar);
    for (int it = 0; it < ST && it < tiles; ++it) load(it);
  }

  // query rows [64 wg, 64 wg + 64) of the tile; broadcast from lane 0, so that
  // ptxas sees the branches around the wgmmas as warp-uniform (a divergent
  // one makes it serialize them)
  const int wg = __shfl_sync(flash::kFull, warp / 4, 0);
  const int g = lane / 4, t = lane % 4;
  const int r0 = q0 + 64 * wg;                   // the warpgroup's first query
  const int rq = r0 + 16 * (warp % 4) + g;       // this thread's queries rq, rq + 8
  // the warpgroup's tiles: (causal) none wholly after its last query, where
  // p = 0 and alpha = 1
  const int mine = causal ? min(tiles, (r0 + 63) / BC + 1) : tiles;

  float o[HV][32];
#pragma unroll
  for (int hv = 0; hv < HV; ++hv)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[hv][i] = 0.0f;
  float m[2] = {flash::kNeg, flash::kNeg}, l[2] = {0.0f, 0.0f};   // m: scaled by scale_log2

  // Per tile two stages of products, each straight-line code from the
  // fence to the wait (a stage split across branches makes ptxas serialize
  // the wgmmas): s = q . k^T, the online softmax on it and p in two bf16
  // pieces; then p . v. An m64n64k16 step is 32 cycles of work, less than a
  // chain of accumulation's latency, so p . v runs as two independent
  // chains of steps: at D = 64 one a piece, each summed apart (scale_d 0 at
  // its first step) and added to o, scaled by alpha first, with rounded
  // float32 adds; at D = 128 one a half of o's features, into o itself (the
  // partial sums of two halves would cost 128 more registers and spill).
  constexpr bool kApart = HV == 1;
  const bool probed = b == 0 && h == 0 && iq == gridDim.x - 1;   // FLASH_SM90_PHASE's block
  (void)probed;
  if (tiles > 0) bar_wait(qbar, 0);
  for (int r = 0; r < mine; ++r) {
    FLASH_SM90_PHASE(probed, wg, r, 0);
    const int s = r % ST;
    bar_wait(&full[s], (r / ST) & 1);
    FLASH_SM90_PHASE(probed, wg, r, 1);
    float sc[G::NS];
#pragma unroll
    for (int i = 0; i < G::NS; ++i) fence_operand(sc[i]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_bf16_ss<BC>(sc, desc_k_major<BR>(sq, 64 * wg, ks), desc_k_major<BC>(sk(s), 0, ks),
                        ks > 0);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < G::NS; ++i) fence_operand(sc[i]);

    FLASH_SM90_PHASE(probed, wg, r, 2);
    const int k0 = r * BC;
    const bool all = k0 + BC <= len && (!causal || k0 + BC - 1 <= r0);
    float alpha[2];
    softmax_tile<BC>(sc, m, l, alpha, all, rq, k0 + 2 * t, len, causal, scale_log2);
    unsigned phi[KK][4], plo[KK][4];
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      a_from_acc(sc, kk, phi[kk], plo[kk]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        fence_operand(phi[kk][e]);
        fence_operand(plo[kk][e]);
      }
    }
    FLASH_SM90_PHASE(probed, wg, r, 3);
    float ph[HV][32], pl[HV][32];
#pragma unroll
    for (int hv = 0; hv < HV; ++hv)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if constexpr (kApart) {
          fence_operand(ph[hv][i]);
          fence_operand(pl[hv][i]);
        } else {
          o[hv][i] *= alpha[(i % 4) / 2];
          fence_operand(o[hv][i]);
        }
      }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
#pragma unroll
      for (int hv = 0; hv < HV; ++hv) {          // v MN-major as stored
        const uint64_t dv = desc_sw128_mn(sv(s) + hv * BC * 128 + kk * 2048);
        if constexpr (kApart) {
          wgmma_bf16_rs_tb_n64(pl[hv], plo[kk], dv, kk > 0);
          wgmma_bf16_rs_tb_n64(ph[hv], phi[kk], dv, kk > 0);
        } else {
          wgmma_bf16_rs_tb_n64(o[hv], plo[kk], dv, 1);
          wgmma_bf16_rs_tb_n64(o[hv], phi[kk], dv, 1);
        }
      }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int hv = 0; hv < HV; ++hv)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if constexpr (kApart) {
          fence_operand(ph[hv][i]);
          fence_operand(pl[hv][i]);
          o[hv][i] = fmaf(o[hv][i], alpha[(i % 4) / 2], pl[hv][i] + ph[hv][i]);
        } else {
          fence_operand(o[hv][i]);
        }
      }
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
    // one reciprocal a row (an IEEE division per value compiles to a call,
    // and ptxas serializes every wgmma of a function that calls)
    const float l_safe = fmaxf(l[half], 1e-20f);
    const float inv = __fdividef(1.0f, l_safe);
    bf16* row = out.head(b, h) + qp * out.st;
#pragma unroll
    for (int hv = 0; hv < HV; ++hv)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(row + 64 * hv + 8 * j + 2 * t) = __floats2bfloat162_rn(
            o[hv][4 * j + 2 * half] * inv, o[hv][4 * j + 2 * half + 1] * inv);
    if (lse != nullptr && t == 0)
      lse[(static_cast<long long>(b) * H + h) * T + qp] =
          l[half] > 0.0f ? m[half] * kLn2 + logf(l_safe) : flash::kNeg;
  }
}

template <int D>
int launch(const void* q, long long q_sb, long long q_st, long long q_sh, const void* k,
           long long k_sb, long long k_st, long long k_sh, const void* v, long long v_sb,
           long long v_st, long long v_sh, const int* lengths, Output<bf16> out, float* lse,
           int B, int T, int H, int causal, cudaStream_t stream) {
  using G = Geo<D>;
  CUtensorMap qm, km, vm;
  if (!flash::operand_map(&qm, q, q_sb, q_st, q_sh, B, T, H, D, G::BR) ||
      !flash::operand_map(&km, k, k_sb, k_st, k_sh, B, T, H, D, G::BC) ||
      !flash::operand_map(&vm, v, v_sb, v_st, v_sh, B, T, H, D, G::BC))
    return static_cast<int>(cudaErrorNotSupported);
  cudaError_t err = allow_smem(flash_fwd_sm90<D>, G::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + G::BR - 1) / G::BR, H, B);
  flash_fwd_sm90<D><<<grid, kThreads, G::SMEM, stream>>>(
      qm, km, vm, lengths, out, lse, T, H, causal, flash::softmax_scale(D) * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90

// q, k, v and out [B, T, H, D] through their batch, time and head strides (in
// elements; the last dimension contiguous), lengths [B] int32, lse [B, H, T]
// contiguous or null. 1 <= D <= 256, T >= 1, H and B <= 65535. Launches on
// `stream`, returns cudaGetLastError() (or the launch's own error).
extern "C" int flash_attn_fwd(const void* q, long long q_sb, long long q_st, long long q_sh,
                              const void* k, long long k_sb, long long k_st, long long k_sh,
                              const void* v, long long v_sb, long long v_st, long long v_sh,
                              const void* lengths, void* out, long long o_sb, long long o_st,
                              long long o_sh, void* lse, int B, int T, int H, int D, int causal,
                              void* stream) {
  return run<float, false>(q, q_sb, q_st, q_sh, k, k_sb, k_st, k_sh, v, v_sb, v_st, v_sh,
                           lengths, out, o_sb, o_st, o_sh, lse, B, T, H, D, causal, stream);
}

// The bf16 instance: q, k, v and out __nv_bfloat16, lse float32; the same
// arguments and shapes as flash_attn_fwd.
extern "C" int flash_attn_fwd_bf16(const void* q, long long q_sb, long long q_st,
                                   long long q_sh, const void* k, long long k_sb,
                                   long long k_st, long long k_sh, const void* v,
                                   long long v_sb, long long v_st, long long v_sh,
                                   const void* lengths, void* out, long long o_sb,
                                   long long o_st, long long o_sh, void* lse, int B, int T,
                                   int H, int D, int causal, void* stream) {
  return (flash::scale_is_pow2(D) ? run<bf16, true> : run<bf16, false>)(
      q, q_sb, q_st, q_sh, k, k_sb, k_st, k_sh, v, v_sb, v_st, v_sh, lengths, out, o_sb, o_st,
      o_sh, lse, B, T, H, D, causal, stream);
}

// The bf16 body for Hopper: the arguments of flash_attn_fwd_bf16, D = 64 or
// 128, and every operand as TMA reads it (flash_attention.py's sm90_takes):
// base 16-byte aligned, batch, time and head strides multiples of 8
// values. Returns cudaErrorInvalidValue for any other shape, and
// cudaErrorNotSupported where a tensor map cannot be made.
extern "C" int flash_attn_fwd_bf16_sm90(const void* q, long long q_sb, long long q_st,
                                        long long q_sh, const void* k, long long k_sb,
                                        long long k_st, long long k_sh, const void* v,
                                        long long v_sb, long long v_st, long long v_sh,
                                        const void* lengths, void* out, long long o_sb,
                                        long long o_st, long long o_sh, void* lse, int B, int T,
                                        int H, int D, int causal, void* stream) {
  if ((D != 64 && D != 128) || !flash_mma::rows_16b_aligned(q, q_sb, q_st, q_sh, D, 2) ||
      !flash_mma::rows_16b_aligned(k, k_sb, k_st, k_sh, D, 2) ||
      !flash_mma::rows_16b_aligned(v, v_sb, v_st, v_sh, D, 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const flash::Output<bf16> oo{static_cast<bf16*>(out), o_sb, o_st, o_sh};
  const int* len = static_cast<const int*>(lengths);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (D == 64 ? sm90::launch<64> : sm90::launch<128>)(
      q, q_sb, q_st, q_sh, k, k_sb, k_st, k_sh, v, v_sb, v_st, v_sh, len, oo, l, B, T, H,
      causal, s);
}
