// attention_gru_bwd_sm90 — kernel 6's bf16 body for Hopper: the backward of
// the fused attention-GRU decoder loop in bf16 operands
// (attention_gru_bwd_bf16's function), its per-step products on the bf16
// tensor cores.
//
// Replaces: paddle_tpu/ops/pallas_attention_gru.py _bwd_kernel in bf16
// (launched by pl.pallas_call in _run_bwd), as attention_gru_bwd.cu's bf16
// instance does; this body takes the shapes
// fused_attention_gru.sm90_takes gives it (D a multiple of 256, the plan
// within shared memory), attention_gru_bwd_bf16 the others. The step's
// arithmetic, outputs and rounding are that instance's
// (attention_gru_bwd.cu's header): d_din stored bf16 in dxw, and its three
// products (drh, d_ctx, the dg part of DH) read it rounded; the attention's
// backward reads d_ctx unrounded (a float32 row buffer); d_m's product with
// wa^T takes it rounded, and dWa sums it to ~16 bits, as two bf16 pieces
// (hi = bf16(d_m), lo = bf16(d_m - hi)), where the float32 sums of the
// Pallas kernel hold it whole; d_enc_proj, dWa, dba and dv are float32, dh0
// bf16.
//
// What bounds it on an H100: at Td = Te = 32, B = 64, D = 512, E = 1024 it
// moves ~42 MB (0.0126 ms at 3.35 TB/s) and does 12 GFLOP (0.012 ms of
// bf16 products); each step needs all B x D of the step after, and inside
// a step four exchanges between blocks.
//
// What the design does about that. Two launches on the stream:
//  1. attention_gru_bwd_sm90_loop: a persistent cooperative grid in P row
//     groups of G blocks (make_plan, mirrored by fused_attention_gru
//     .sm90_plan). Batch rows are independent in this recurrence, so group
//     p owns rows [p R, p R + R) and its blocks wait only on each other; a
//     block owns U hidden units (rows of wg and wa) and ER rows of wctx, in
//     bf16 in shared memory, chunk-major ([K/32][N][32]: a 32-k chunk of a
//     row is 64 contiguous bytes). With row groups a block reads only its
//     group's R rows of the exchanged d_din and d_m, not all B. Every
//     product runs on mma.sync m16n8k16 bf16 with float32 sums, its A rows
//     read as 16-byte vectors through L2 straight into the fragments
//     (mma_bf16.cuh's permuted k), the eight warps splitting the
//     contraction and their partial tiles summed through shared memory in
//     warp order. Five phases a step; the first four end in a barrier of
//     the group, each for the exchange the next phase reads:
//       1  dh', and the update-gate and candidate parts of d_din (dxw), for
//          the owned units            -> drh needs every unit's dcand;
//       2  drh = dcand . wg[:, 2D:]^T, the reset-gate part
//                                     -> d_ctx needs every unit's d_din;
//       3  d_ctx = d_din . wctx^T for the owned rows of wctx, to the bf16
//          stream and the float32 row buffer
//                                     -> the attention needs whole d_ctx rows;
//       4  per (row, part of D) item: dalpha (ev read as 16-byte vectors),
//          the softmax and tanh backward, the item's d_enc_proj in shared
//          memory, d_m as its two pieces [Td][B][D], the dv and dba
//          partials                   -> DH needs every unit's d_m;
//       5  DH = dh' u + drh r + [dg | d_m] . [wg[:, :2D] | wa]^T + (1 - m) DH
//          for the owned units, which phase 1 of the next step reads on the
//          same block: no barrier between them.
//  2. attention_gru_bwd_sm90_tail: dWa = h_prev^T . (hi + lo) over all
//     Td B rows on the tensor cores (rows_product.cuh), and dba and dv as
//     the column sums of the items' partials over B in row order.
// Every sum runs in a fixed order and nothing is summed by atomics: two
// launches give the same bits.

#include "common.cuh"
#include "mma_bf16.cuh"
#include "persistent_grid.cuh"
#include "rows_product.cuh"

namespace {

using namespace pgrid;
using bf16 = __nv_bfloat16;

constexpr int kMT = 16;      // rows of a product tile (one m16)
constexpr int kLoad = 6;     // 32-k chunks a warp loads before it multiplies
constexpr int kItems = 4;    // phase 1's items a thread loads at once

// How the loop's grid is cut (mirrored by fused_attention_gru.sm90_plan).
struct Plan6 {
  int P, G, U, ER, R, parts, plen, ipb;
};

// Shared memory of a loop block, in bytes: the weights' rows in bf16 (wg's
// candidate columns [D/32][U][32], wg's gate columns with wa's
// [3D/32][U][32], wctx's [3D/32][ER][32]), then in float32 the warps'
// partial tiles [kWarps][kMT][max(U, ER)], DH, dh', drh and the DH
// product [R][U] each, the d_ctx product [R][ER], v [D], one d_ctx row
// [E], the score gradients [Te rounded up to 4], the dv and dba partials
// [2][ipb][plen] and the d_enc_proj accumulators [ipb][Te][plen].
inline size_t loop_smem_bytes(const Plan6& p, int Te, int D, int E) {
  const long long nmax = p.U > p.ER ? p.U : p.ER;
  const long long items = static_cast<long long>(p.ipb) * p.plen;
  return 2ull * (4LL * p.U * D + 3LL * p.ER * D)
         + 4ull * (kWarps * kMT * nmax + 4LL * p.R * p.U + 1LL * p.R * p.ER + D + E
                   + (Te + 3) / 4 * 4 + 2 * items + items * Te);
}

inline Plan6 make_plan(int B, int Te, int D, int E, int num_sms) {
  const int cand[3][2] = {{4, 16}, {2, 8}, {1, 8}};    // (P, U), the first that fits
  if (B >= 1 && Te >= 1 && D > 0 && D % 256 == 0 && E > 0) {
    for (const auto& c : cand) {
      Plan6 p{};
      p.P = c[0];
      p.U = c[1];
      p.G = D / p.U;
      if (p.P > B || p.P * p.G > num_sms || E % p.G != 0) continue;
      p.ER = E / p.G;
      if (p.ER != 8 && p.ER != 16 && p.ER != 32) continue;   // the compiled widths
      p.R = (B + p.P - 1) / p.P;
      p.parts = p.G / p.R > 1 ? p.G / p.R : 1;
      p.plen = (D + p.parts - 1) / p.parts;
      p.ipb = (p.R * p.parts + p.G - 1) / p.G;
      if (loop_smem_bytes(p, Te, D, E) <= kSmemLimit) return p;
    }
  }
  return Plan6{};
}

// out[r * ldo + n] = sum_k A[r, k] W[n][k] for r < rows and n < 8 NT, out in
// shared memory. A's rows are two bf16 segments read through L2 (A1 [rows]
// [K1] at row stride lda1, then A2 [rows][K2] at lda2; K1 a multiple of 32),
// W [(K1 + K2)/32][8 NT][32] bf16 in shared memory; K1 + K2 a multiple of
// 32 kWarps. The warps take K/(32 kWarps) chunks each, 16 rows a tile.
// Returns with the block synchronised.
template <int NT>
__device__ __forceinline__ void product(float* out, int ldo, int rows, const bf16* A1,
                                        long long lda1, int K1, const bf16* A2, long long lda2,
                                        int K2, const bf16* W, float* red) {
  constexpr int N = 8 * NT;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int nch = (K1 + K2) / 32 / kWarps;
  const int c0 = warp * nch;
  for (int rt0 = 0; rt0 < rows; rt0 += kMT) {
    float acc[NT][4];
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[ni][e] = 0.0f;
    for (int cb = 0; cb < nch; cb += kLoad) {
      uint4 ra[kLoad][2];                              // [chunk][row g, g + 8]
#pragma unroll
      for (int q = 0; q < kLoad; ++q) {
        const int k = 32 * (c0 + cb + q) + 8 * tq;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = rt0 + g + 8 * h;
          const bf16* src = k < K1 ? A1 + static_cast<long long>(r) * lda1 + k
                                   : A2 + static_cast<long long>(r) * lda2 + (k - K1);
          ra[q][h] = cb + q < nch && r < rows ? mmabf16::ldcg16(src) : mmabf16::zero4();
        }
      }
#pragma unroll
      for (int q = 0; q < kLoad; ++q) {
        if (cb + q < nch) {                            // uniform over the block
          const bf16* wc = W + static_cast<size_t>(c0 + cb + q) * N * 32 + g * 32 + 8 * tq;
#pragma unroll
          for (int ni = 0; ni < NT; ++ni)
            mmabf16::chunk32(acc[ni], ra[q][0], ra[q][1],
                             *reinterpret_cast<const uint4*>(wc + ni * 8 * 32));
        }
      }
    }
    float* rw = red + warp * kMT * N;
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
      const int c = 8 * ni + 2 * tq;
      *reinterpret_cast<float2*>(rw + g * N + c) = make_float2(acc[ni][0], acc[ni][1]);
      *reinterpret_cast<float2*>(rw + (g + 8) * N + c) = make_float2(acc[ni][2], acc[ni][3]);
    }
    __syncthreads();
    const int nr = min(kMT, rows - rt0);
    for (int i = tid; i < nr * N; i += kThreads) {
      float v = 0.0f;
#pragma unroll
      for (int x = 0; x < kWarps; ++x) v += red[x * kMT * N + i];
      out[(rt0 + i / N) * ldo + i % N] = v;
    }
    __syncthreads();
  }
}

// A weight row segment into a chunk-major slice: dst[c][n][j] = src[32 c + j]
// for 32-k chunks c < K / 32 of row n of N (16 bytes a copy).
__device__ __forceinline__ void stage_rows(bf16* dst, int N, int n, const bf16* src, int K,
                                           int chunk0) {
  for (int e8 = threadIdx.x; e8 < K / 8; e8 += kThreads)
    *reinterpret_cast<uint4*>(dst + (static_cast<size_t>(chunk0 + e8 / 4) * N + n) * 32 +
                              8 * (e8 % 4)) = *reinterpret_cast<const uint4*>(src + 8 * e8);
}

template <int U, int ER>
__global__ void __launch_bounds__(kThreads, 1)
attention_gru_bwd_sm90_loop(const bf16* __restrict__ dy, long long dy_st, long long dy_sb,
                            const bf16* __restrict__ ep, long long ep_st, long long ep_sb,
                            const bf16* __restrict__ ev, long long ev_st, long long ev_sb,
                            const bf16* __restrict__ dmask, const bf16* __restrict__ hprev,
                            const bf16* __restrict__ acts, const bf16* __restrict__ alpha,
                            const float* __restrict__ m_all, const bf16* __restrict__ wa,
                            const bf16* __restrict__ v, const bf16* __restrict__ wctx,
                            const bf16* __restrict__ wg, bf16* dxw, bf16* dctx, bf16* dh0,
                            float* dep, long long dep_st, long long dep_sb, bf16* dm_hi,
                            bf16* dm_lo, float* dv_part, unsigned* counters, float* dctx32,
                            unsigned long long* phase_ns, int Td, int B, int Te, int D, int E,
                            int G, int R, int parts, int plen, int ipb) {
  constexpr int NMAX = U > ER ? U : ER;
  static_assert(kThreads % U == 0, "a thread's unit is fixed in phases 1, 2 and 5");
  extern __shared__ float4 smem4[];
  const long long D3 = 3LL * D;
  bf16* Wc = reinterpret_cast<bf16*>(smem4);             // [D/32][U][32]
  bf16* W5 = Wc + static_cast<size_t>(U) * D;            // [3D/32][U][32]
  bf16* W3 = W5 + 3 * static_cast<size_t>(U) * D;        // [3D/32][ER][32]
  float* red = reinterpret_cast<float*>(W3 + 3 * static_cast<size_t>(ER) * D);
  float* DH = red + kWarps * kMT * NMAX;                 // [R][U]
  float* DHN = DH + R * U;
  float* DRH = DHN + R * U;
  float* OUT = DRH + R * U;
  float* O3 = OUT + R * U;                               // [R][ER]
  float* v_s = O3 + R * ER;                              // [D]
  float* dc_s = v_s + D;                                 // [E]
  float* ds_s = dc_s + E;                                // [Te]
  float* dv_s = ds_s + (Te + 3) / 4 * 4;                 // [ipb][plen]
  float* dba_s = dv_s + static_cast<long long>(ipb) * plen;
  float* dep_s = dba_s + static_cast<long long>(ipb) * plen;   // [ipb][Te][plen]
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int p = blockIdx.x / G, q = blockIdx.x % G;     // row group, block in it
  const int k0 = q * U, e0 = q * ER;                     // the owned units and rows of wctx
  const int row0 = p * R;
  const int rows = max(0, min(B, row0 + R) - row0);
  const int c_own = tid % U;
  GridBarrier bar{counters + p, 0, static_cast<unsigned>(G)};
  const bool clocked = phase_ns != nullptr && blockIdx.x == 0 && tid == 0;

  for (int n = 0; n < U; ++n) {
    const bf16* row = wg + (k0 + n) * D3;
    stage_rows(Wc, U, n, row + 2 * D, D, 0);
    stage_rows(W5, U, n, row, 2 * D, 0);
    stage_rows(W5, U, n, wa + static_cast<long long>(k0 + n) * D, D, 2 * D / 32);
  }
  for (int n = 0; n < ER; ++n) stage_rows(W3, ER, n, wctx + (e0 + n) * D3, 3 * D, 0);
  for (int i = tid; i < R * U; i += kThreads) DH[i] = 0.0f;
  for (int d = tid; d < D; d += kThreads) v_s[d] = to_f32(v[d]);
  for (long long i = tid; i < static_cast<long long>(ipb) * plen * (Te + 2); i += kThreads)
    dv_s[i] = 0.0f;                                      // dv, dba and d_enc_proj's sums
  __syncthreads();

  for (int s = 0; s < Td; ++s) {
    const int t = Td - 1 - s;
    const long long tB = static_cast<long long>(t) * B;
    const bf16* dxw_g = dxw + (tB + row0) * D3;          // the group's rows of d_din
    unsigned long long* clk = clocked ? phase_ns + 5 * s : nullptr;

    // 1: dh', the update-gate and candidate gradients of the owned units
    for (int i0 = tid; i0 < rows * U; i0 += kThreads * kItems) {
      bool ok[kItems];
      float dm[kItems], h[kItems], u[kItems], c[kItems], dyv[kItems];
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const int i = i0 + j * kThreads;
        ok[j] = i < rows * U;
        const int b = row0 + (ok[j] ? i / U : 0);
        const long long row = tB + b;
        const int k = k0 + c_own;
        dm[j] = ok[j] ? to_f32(dmask[row]) : 0.0f;
        h[j] = ok[j] ? to_f32(hprev[row * D + k]) : 0.0f;
        u[j] = ok[j] ? to_f32(acts[row * D3 + k]) : 0.0f;
        c[j] = ok[j] ? to_f32(acts[row * D3 + 2 * D + k]) : 0.0f;
        dyv[j] = ok[j] ? to_f32(dy[t * dy_st + b * dy_sb + k]) : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        if (!ok[j]) continue;
        const int i = i0 + j * kThreads;
        const long long row = tB + row0 + i / U;
        const int k = k0 + c_own;
        const float d = dyv[j] + dm[j] * DH[i];
        DHN[i] = d;
        stcg_as(dxw + row * D3 + k, d * (h[j] - c[j]) * u[j] * (1.0f - u[j]));
        stcg_as(dxw + row * D3 + 2 * D + k, d * (1.0f - u[j]) * (1.0f - c[j] * c[j]));
      }
    }
    bar.sync();
    if (clk) clk[0] = global_ns();

    // 2: drh = dcand . wg[:, 2D:]^T and the reset-gate gradient
    product<U / 8>(DRH, U, rows, dxw_g + 2 * D, D3, D, nullptr, 0, 0, Wc, red);
    for (int i = tid; i < rows * U; i += kThreads) {
      const long long row = tB + row0 + i / U;
      const int k = k0 + c_own;
      const float r = to_f32(acts[row * D3 + D + k]);
      stcg_as(dxw + row * D3 + D + k, DRH[i] * to_f32(hprev[row * D + k]) * r * (1.0f - r));
    }
    bar.sync();
    if (clk) clk[1] = global_ns();

    // 3: d_ctx = d_din . wctx^T for the owned rows of wctx
    product<ER / 8>(O3, ER, rows, dxw_g, D3, 3 * D, nullptr, 0, 0, W3, red);
    for (int i = tid; i < rows * ER; i += kThreads) {
      const int b = row0 + i / ER, e = e0 + i % ER;
      __stcg(dctx32 + static_cast<long long>(b) * E + e, O3[i]);
      stcg_as(dctx + (tB + b) * E + e, O3[i]);
    }
    bar.sync();
    if (clk) clk[2] = global_ns();

    // 4: per (row, part of D): dalpha, the softmax and tanh backward
    for (int il = 0; il < ipb; ++il) {
      const int item = q + il * G;
      if (item >= rows * parts) break;
      const int b = row0 + item / parts, d0 = (item % parts) * plen;
      const int d1 = min(D, d0 + plen);
      const long long row = tB + b;
      for (int e = tid; e < E; e += kThreads)
        dc_s[e] = __ldcg(dctx32 + static_cast<long long>(b) * E + e);
      __syncthreads();
      // dalpha[te] = ev[te, b, :] . d_ctx: four rows a warp, 16 bytes a lane
      for (int te0 = warp; te0 < Te; te0 += 4 * kWarps) {
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int x = 8 * lane; x < E; x += 256) {
          uint4 raw[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int te = te0 + j * kWarps;
            raw[j] = te < Te ? *reinterpret_cast<const uint4*>(ev + te * ev_st + b * ev_sb + x)
                             : mmabf16::zero4();
          }
          const float4 c0 = *reinterpret_cast<const float4*>(dc_s + x);
          const float4 c1 = *reinterpret_cast<const float4*>(dc_s + x + 4);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const __nv_bfloat162* pr = reinterpret_cast<const __nv_bfloat162*>(&raw[j]);
            const float2 a0 = __bfloat1622float2(pr[0]), a1 = __bfloat1622float2(pr[1]);
            const float2 a2 = __bfloat1622float2(pr[2]), a3 = __bfloat1622float2(pr[3]);
            acc[j] += a0.x * c0.x + a0.y * c0.y + a1.x * c0.z + a1.y * c0.w + a2.x * c1.x +
                      a2.y * c1.y + a3.x * c1.z + a3.y * c1.w;
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float sum = warp_sum(acc[j]);
          const int te = te0 + j * kWarps;
          if (lane == 0 && te < Te) ds_s[te] = sum;
        }
      }
      __syncthreads();
      // masked softmax backward; padded positions have alpha = 0
      if (warp == 0) {
        const bf16* al = alpha + row * Te;
        float dot = 0.0f;
        for (int te = lane; te < Te; te += 32) dot += to_f32(al[te]) * ds_s[te];
        dot = warp_sum(dot);
        for (int te = lane; te < Te; te += 32) ds_s[te] = to_f32(al[te]) * (ds_s[te] - dot);
      }
      __syncthreads();
      for (int d = d0 + tid; d < d1; d += kThreads) {
        const float md = m_all[row * D + d], vd = v_s[d];
        const bf16* epb = ep + b * ep_sb + d;
        float* acc = dep_s + static_cast<long long>(il) * Te * plen + d - d0;
        float dsum = 0.0f, dvs = 0.0f;
        for (int te0 = 0; te0 < Te; te0 += 16) {        // sixteen loads in flight
          float x[16];
#pragma unroll
          for (int j = 0; j < 16; ++j)
            x[j] = te0 + j < Te ? to_f32(epb[(te0 + j) * ep_st]) : 0.0f;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int te = te0 + j;
            if (te >= Te) break;
            const float cmb = tanhf(x[j] + md);
            const float dt = (1.0f - cmb * cmb) * ds_s[te] * vd;
            acc[te * plen] += dt;
            dsum += dt;
            dvs = fmaf(cmb, ds_s[te], dvs);
          }
        }
        bf16 hi, lo;
        split_bf16(dsum, hi, lo);
        __stcg(reinterpret_cast<unsigned short*>(dm_hi + row * D + d), __bfloat16_as_ushort(hi));
        dm_lo[row * D + d] = lo;
        dv_s[il * plen + d - d0] += dvs;
        dba_s[il * plen + d - d0] += dsum;
      }
      __syncthreads();
    }
    bar.sync();
    if (clk) clk[3] = global_ns();

    // 5: DH = dh' u + drh r + [dg | d_m] . [wg[k, :2D] | wa[k, :]] + (1 - dm) DH
    product<U / 8>(OUT, U, rows, dxw_g, D3, 2 * D, dm_hi + (tB + row0) * D, D, D, W5, red);
    for (int i = tid; i < rows * U; i += kThreads) {
      const long long row = tB + row0 + i / U;
      const int k = k0 + c_own;
      const float dm = to_f32(dmask[row]);
      DH[i] = DHN[i] * to_f32(acts[row * D3 + k]) + DRH[i] * to_f32(acts[row * D3 + D + k]) +
              OUT[i] + (1.0f - dm) * DH[i];
    }
    __syncthreads();
    if (clk) clk[4] = global_ns();
  }

  for (int i = tid; i < rows * U; i += kThreads)
    dh0[static_cast<long long>(row0 + i / U) * D + k0 + c_own] = __float2bfloat16_rn(DH[i]);
  for (int il = 0; il < ipb; ++il) {
    const int item = q + il * G;
    if (item >= rows * parts) break;
    const int b = row0 + item / parts, d0 = (item % parts) * plen;
    const int d1 = min(D, d0 + plen);
    for (int d = d0 + tid; d < d1; d += kThreads) {
      dv_part[static_cast<long long>(b) * D + d] = dv_s[il * plen + d - d0];
      dv_part[(static_cast<long long>(B) + b) * D + d] = dba_s[il * plen + d - d0];
      for (int te = 0; te < Te; ++te)
        dep[te * dep_st + b * dep_sb + d] =
            dep_s[(static_cast<long long>(il) * Te + te) * plen + d - d0];
    }
  }
}

// dWa [D][D] = h_prev^T . (d_m's hi + lo) over the N = Td B rows
// (rows_product.cuh); the first blocks also sum dba and dv over the B rows
// of the items' partials, in row order.
__global__ void __launch_bounds__(kThreads)
attention_gru_bwd_sm90_tail(const bf16* __restrict__ hprev, const bf16* __restrict__ dm_hi,
                            const bf16* __restrict__ dm_lo, const float* __restrict__ dv_part,
                            float* __restrict__ dwa, float* __restrict__ dba,
                            float* __restrict__ dv, int N, int B, int D) {
  extern __shared__ float4 smem4[];
  const int block = blockIdx.y * gridDim.x + blockIdx.x;
  for (int d = block * kThreads + threadIdx.x; d < D; d += gridDim.x * gridDim.y * kThreads) {
    float sv = 0.0f, sb = 0.0f;
    for (int b = 0; b < B; ++b) {
      sv += dv_part[static_cast<long long>(b) * D + d];
      sb += dv_part[(static_cast<long long>(B) + b) * D + d];
    }
    dv[d] = sv;
    dba[d] = sb;
  }
  rowsprod::tile(hprev, D, D, dm_hi, dm_lo, D, N, dwa, D, reinterpret_cast<bf16*>(smem4));
}

template <int U, int ER>
cudaError_t launch_loop(const Plan6& pl, size_t smem, cudaStream_t st, const bf16* dy,
                        long long dy_st, long long dy_sb, const bf16* ep, long long ep_st,
                        long long ep_sb, const bf16* ev, long long ev_st, long long ev_sb,
                        const bf16* dmask, const bf16* hprev, const bf16* acts,
                        const bf16* alpha, const float* m_all, const bf16* wa, const bf16* v,
                        const bf16* wctx, const bf16* wg, bf16* dxw, bf16* dctx, bf16* dh0,
                        float* dep, long long dep_st, long long dep_sb, bf16* dm_hi,
                        bf16* dm_lo, float* dv_part, unsigned* counters, float* dctx32,
                        unsigned long long* phase_ns, int Td, int B, int Te, int D, int E) {
  return launch_cooperative(attention_gru_bwd_sm90_loop<U, ER>, pl.P * pl.G, smem, st, dy, dy_st,
                            dy_sb, ep, ep_st, ep_sb, ev, ev_st, ev_sb, dmask, hprev, acts, alpha,
                            m_all, wa, v, wctx, wg, dxw, dctx, dh0, dep, dep_st, dep_sb, dm_hi,
                            dm_lo, dv_part, counters, dctx32, phase_ns, Td, B, Te, D, E, pl.G,
                            pl.R, pl.parts, pl.plen, pl.ipb);
}

}  // namespace

// attention_gru_bwd_bf16's function on the body above, with its arguments
// where they are the same (attention_gru_bwd.cu): dy [Td, B, D], ep
// [Te, B, D], ev [Te, B, E] and dep [Te, B, D] through their time and batch
// strides (ev's multiples of 8, its base 16-byte aligned), the rest
// contiguous (wa, wctx, wg and dxw 16-byte aligned); bf16 operands and
// dxw, dctx, dh0, float32 m_all, dep, dwa, dba and dv. Scratch: d_m's
// pieces dm_hi and dm_lo [Td, B, D] bf16, dv_part [2, B, D] and dctx32 [B, E]
// float32, counters (P unsigned, the plan's row groups:
// fused_attention_gru.sm90_plan). phase_ns, when not null ([Td][5]
// unsigned 64-bit integers), receives block 0's clock in ns at the end of
// each phase of each step, in the loop's order. Launches the loop
// (cooperatively) and then the dWa, dba and dv sums on `stream`; returns the
// first error, or cudaErrorInvalidValue for a shape the plan does not take.
extern "C" int attention_gru_bwd_bf16_sm90(
    const void* dy, long long dy_st, long long dy_sb, const void* ep, long long ep_st,
    long long ep_sb, const void* ev, long long ev_st, long long ev_sb, const void* dmask,
    const void* hprev, const void* acts, const void* alpha, const void* m_all, const void* wa,
    const void* v, const void* wctx, const void* wg, void* dxw, void* dctx, void* dh0, void* dep,
    long long dep_st, long long dep_sb, void* dwa, void* dba, void* dv, void* dm_hi,
    void* dv_part, void* counters, void* dctx32, void* dm_lo, void* phase_ns, int Td, int B,
    int Te, int D, int E, int num_sms, void* stream) {
  const Plan6 pl = make_plan(B, Te, D, E, num_sms);
  if (Td < 0 || pl.P == 0 || static_cast<long long>(Td) * B >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = loop_smem_bytes(pl, Te, D, E);
  cudaError_t err = cudaMemsetAsync(counters, 0, pl.P * sizeof(unsigned), st);
  if (err != cudaSuccess) return static_cast<int>(err);
#define AGRU_SM90_ARGS pl, smem, st, static_cast<const bf16*>(dy), dy_st, dy_sb,            \
    static_cast<const bf16*>(ep), ep_st, ep_sb, static_cast<const bf16*>(ev), ev_st, ev_sb,  \
    static_cast<const bf16*>(dmask), static_cast<const bf16*>(hprev),                       \
    static_cast<const bf16*>(acts), static_cast<const bf16*>(alpha),                        \
    static_cast<const float*>(m_all), static_cast<const bf16*>(wa),                         \
    static_cast<const bf16*>(v), static_cast<const bf16*>(wctx),                            \
    static_cast<const bf16*>(wg), static_cast<bf16*>(dxw), static_cast<bf16*>(dctx),        \
    static_cast<bf16*>(dh0), static_cast<float*>(dep), dep_st, dep_sb,                      \
    static_cast<bf16*>(dm_hi), static_cast<bf16*>(dm_lo), static_cast<float*>(dv_part),     \
    static_cast<unsigned*>(counters), static_cast<float*>(dctx32),                          \
    static_cast<unsigned long long*>(phase_ns), Td, B, Te, D, E
  if (pl.U == 16) {
    err = pl.ER == 32   ? launch_loop<16, 32>(AGRU_SM90_ARGS)
          : pl.ER == 16 ? launch_loop<16, 16>(AGRU_SM90_ARGS)
                        : launch_loop<16, 8>(AGRU_SM90_ARGS);
  } else {
    err = pl.ER == 32   ? launch_loop<8, 32>(AGRU_SM90_ARGS)
          : pl.ER == 16 ? launch_loop<8, 16>(AGRU_SM90_ARGS)
                        : launch_loop<8, 8>(AGRU_SM90_ARGS);
  }
#undef AGRU_SM90_ARGS
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_smem(attention_gru_bwd_sm90_tail, rowsprod::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_gru_bwd_sm90_tail<<<rowsprod::grid(D, D), kThreads, rowsprod::kSmem, st>>>(
      static_cast<const bf16*>(hprev), static_cast<const bf16*>(dm_hi),
      static_cast<const bf16*>(dm_lo), static_cast<const float*>(dv_part),
      static_cast<float*>(dwa), static_cast<float*>(dba), static_cast<float*>(dv), Td * B, B, D);
  return static_cast<int>(cudaGetLastError());
}
