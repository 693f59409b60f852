// attention_gru_bwd — the backward of the fused attention-GRU decoder loop.
//
// Replaces: paddle_tpu/ops/pallas_attention_gru.py _bwd_kernel (launched by
// pl.pallas_call in _run_bwd, the custom-VJP backward of
// fused_attention_gru). Its outputs are this source's: d_din (= dxw), the
// d_ctx stream, dh0, d_enc_proj, dWa, dba and dv. dW_ctx, dW_gru and
// d_enc_vec are large time-parallel products of the streams, left to the
// caller as in the JAX package.
//
// Per decoder step, walked t = Td-1 .. 0 for all batch rows at once, with
// DH [B, D] the gradient carried into the step's carry, dm = dmask[t] and
// the residuals (h_prev, u, r, c, alpha) of attention_gru_fwd_train:
//   dh'    = dy[t] + dm * DH                (the output stream is the raw h')
//   d_din  = [du u(1-u) | drh h_prev r(1-r) | dcand]      (GRU backward, as gru_bwd)
//            drh = dcand . Wg[:, 2D:]^T
//   d_ctx  = d_din . Wctx^T                                [B, E]
//   comb   = tanh(ep + m)        (m = h_prev . Wa + ba, saved by the forward)
//   dalpha = ev . d_ctx;         ds = alpha (dalpha - sum alpha dalpha)
//   dtanh  = (1 - comb^2) * ds * v          d_enc_proj += dtanh
//   d_m    = sum_Te dtanh;       dv += sum_Te comb * ds
//   DH     = dh' u + drh r + d_din[:, :2D] . Wg[:, :2D]^T + d_m . Wa^T + (1 - dm) DH
// and over every (t, b): dWa = h_prev^T . d_m, dba = sum d_m, dv = sum of
// the rows' partials.
//
// What bounds it on an H100: its float32 operations (Td B (10 D^2 + 6 D E
// + 2 Te E + 8 Te D): 12 GFLOP at Td = Te = 32, B = 64, D = 512, E = 1024,
// 0.18 ms at 67 TFLOP/s) over its bytes (about 70 MB); the reversed time
// loop is sequential, and every step needs all B rows of the one after.
//
// What the design does about that: one persistent block on each SM (a
// cooperative launch). The per-step products take the weights transposed,
// so a block owns ROWS: unit group g (hidden units k = 4g .. 4g+3) is rows
// k of wg and wa, e-group e (8 rows of wctx) its rows 8e .. 8e+7; 80 KB at
// D = 512, E = 1024 in shared memory for the whole launch. Products cover
// all B rows at once in float32 FMA (persistent_grid.cuh). m = h_prev . wa
// + ba, which the first design recomputed on the sequential loop, is the
// forward's own m, saved for every step: Td x B x D floats of memory in
// place of Td more products in this launch and a column slice of wa in
// every block. Five phases a step, the first four ending in a grid
// barrier; d_din, d_ctx and d_m pass between blocks through L2 in their
// output buffers (dxw, dctx, dm_rows):
//   1  dh' and the update-gate and candidate parts of d_din, owned units;
//   2  drh = dcand . Wg[:, 2D:]^T and the reset-gate part, owned units;
//   3  d_ctx = d_din . Wctx^T for the owned rows e;
//   4  per (batch row, part of D) item: dalpha, the softmax and tanh
//      backward, that item's d_enc_proj [Te, part] (accumulated in shared
//      memory when it fits, else in place in dep: each element has one
//      owner, so there are no atomics), d_m and the dv partial;
//   5  DH for the owned units, which phase 1 of the next step reads on the
//      same block: no barrier between them.
// dWa, dba and dv sum over every row and step. dWa = h_prev^T . d_m over
// all Td * B rows is a last phase of the launch, in tiles of 32 x 64 over
// the blocks, right after the loop (the d_m rows of every step are complete
// then): the first design's separate contraction (atb_gemm.cuh) took it
// on 64 blocks, a block summing 2048 rows one 16-row slice after another.
// dba and dv collect per-row partials in the attention phase's items, and
// atb sums those over the B rows after the launch. Every sum runs in a
// fixed order; two launches give the same bits.
//
// bf16 instance (attention_gru_bwd_bf16; the storage type S is a template
// parameter), the Pallas kernel's bf16 contract (pallas_attention_gru.py
// _bwd_kernel): dy, ep, ev, dmask, the residuals and the weights are bf16,
// widened on load; DH and every gradient are float32 until stored. d_din is
// stored bf16 in dxw, and that rounded value is what its three products
// read (drh, d_ctx, the dg part of DH), as Pallas rounds d_din for them.
// d_ctx is stored bf16 in dctx, but the attention's backward reads it
// unrounded from a float32 row buffer [B, E] (written in phase 3, read in
// phase 4, one barrier between: a single buffer serves every step). d_m's
// product with wa^T takes it rounded (block_product's kRound2); dWa sums it
// unrounded. d_enc_proj, dWa, dba and dv stay float32 outputs, which the
// caller rounds (as the JAX package rounds them after its kernel), and dh0
// is stored bf16. m stays the forward's float32 m.

#include "atb_gemm.cuh"
#include "common.cuh"
#include "persistent_grid.cuh"

namespace {

using namespace pgrid;

// The shared memory of a block, in floats: per unit group W2 [D][4]
// (wg[k, 2D:] transposed), W5 [3D][4] (wg[k, :2D] then wa[k, :],
// transposed) and the state DH, dhn, drh and the product's output, each
// [B][4]; per e-group W3 [3D][8] (wctx rows, transposed); then the d_ctx
// product's output [B][8], v [D], one row of d_ctx [E], the score
// gradients [Te rounded up to 4], the dv and dba partials [2][ipb][plen]
// and, when dep_smem, the d_enc_proj accumulators [ipb][Te][plen]. After
// the loop the dWa tiles reuse it from the start (kDwaStage floats at
// least).
constexpr int kTk = 32, kTd = 64, kTn = 32;     // a dWa tile: 32 rows k x 64 columns d
constexpr long long kDwaStage = static_cast<long long>(kTn) * (kTk + kTd);

inline size_t bwd_smem_floats(int B, int Te, int D, int E, const Plan& p, bool dep_smem) {
  const long long te4 = (Te + 3) / 4 * 4;
  const long long items = static_cast<long long>(p.ipb) * p.plen;
  const long long n = p.gpb * (16LL * D + 16LL * B) + p.epb * 24LL * D + 8LL * B + D + E + te4
                      + 2 * items + (dep_smem ? items * Te : 0);
  return static_cast<size_t>(n > kDwaStage ? n : kDwaStage);
}

template <typename S>
__global__ void __launch_bounds__(kThreads, 1)
attention_gru_bwd_kernel(const S* __restrict__ dy, long long dy_st, long long dy_sb,
                         const S* __restrict__ ep, long long ep_st, long long ep_sb,
                         const S* __restrict__ ev, long long ev_st, long long ev_sb,
                         const S* __restrict__ dmask,
                         const S* __restrict__ hprev, const S* __restrict__ acts,
                         const S* __restrict__ alpha, const float* __restrict__ m_all,
                         const S* __restrict__ wa,
                         const S* __restrict__ v, const S* __restrict__ wctx,
                         const S* __restrict__ wg,
                         S* dxw, S* dctx, S* dh0,
                         float* dep, long long dep_st, long long dep_sb,
                         float* dwa, float* dm_rows, float* dv_part, unsigned* counter,
                         float* dctx32, unsigned long long* phase_ns,
                         int Td, int B, int Te, int D, int E, int gpb, int epb, int parts,
                         int plen, int ipb, int dep_smem) {
  constexpr bool kF32 = IsF32<S>::value;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nblk = gridDim.x;
  const int groups = (D + kUnits - 1) / kUnits;
  const int egroups = (E + kERows - 1) / kERows;
  const long long D3 = 3LL * D;
  const size_t per_group = 16LL * D + 16LL * B;
  float* W3base = smem + gpb * per_group;
  float* out3 = W3base + epb * 24LL * D;          // [B][8]
  float* v_s = out3 + 8LL * B;
  float* dc_s = v_s + D;                         // [E]
  float* ds_s = dc_s + E;                        // [Te]
  float* dv_s = ds_s + (Te + 3) / 4 * 4;         // [ipb][plen]
  float* dba_s = dv_s + static_cast<long long>(ipb) * plen;   // [ipb][plen]
  float* dep_s = dba_s + static_cast<long long>(ipb) * plen;  // [ipb][Te][plen]
  GridBarrier bar{counter, 0};
  // block 0's clock at the end of each phase of each step, when asked
  const bool clocked = phase_ns != nullptr && blockIdx.x == 0 && tid == 0;
  // unit group gl's regions
  auto W2 = [&](int gl) { return smem + gl * per_group; };
  auto W5 = [&](int gl) { return W2(gl) + 4LL * D; };
  auto DH = [&](int gl) { return W2(gl) + 16LL * D; };
  auto DHN = [&](int gl) { return DH(gl) + 4LL * B; };
  auto DRH = [&](int gl) { return DH(gl) + 8LL * B; };
  auto OUT = [&](int gl) { return DH(gl) + 12LL * B; };

  // the weight slices, zeroed accumulators
  for (int gl = 0; gl < gpb; ++gl) {
    const int g = blockIdx.x + gl * nblk;
    if (g >= groups) break;
    const int k0 = kUnits * g;
    float* w2 = W2(gl);
    float* w5 = W5(gl);
    for (int i = tid; i < 4 * D; i += kThreads) {
      const int j = i / 4, k = k0 + i % 4;
      w2[i] = k < D ? to_f32(wg[k * D3 + 2 * D + j]) : 0.0f;
    }
    for (int i = tid; i < 12 * D; i += kThreads) {
      const int j = i / 4, k = k0 + i % 4;
      w5[i] = k >= D ? 0.0f
              : j < 2 * D ? to_f32(wg[k * D3 + j])
                          : to_f32(wa[static_cast<long long>(k) * D + j - 2 * D]);
    }
    for (int i = tid; i < 4 * B; i += kThreads) DH(gl)[i] = 0.0f;
  }
  for (int el = 0; el < epb; ++el) {
    const int eg = blockIdx.x + el * nblk;
    if (eg >= egroups) break;
    float* w3 = W3base + el * 24LL * D;
    for (int i = tid; i < 24 * D; i += kThreads) {
      const int j = i / 8, e = kERows * eg + i % 8;
      w3[i] = e < E ? to_f32(wctx[static_cast<long long>(e) * D3 + j]) : 0.0f;
    }
  }
  for (int d = tid; d < D; d += kThreads) v_s[d] = to_f32(v[d]);
  for (int il = 0; il < ipb; ++il) {
    const int item = blockIdx.x + il * nblk;
    if (item >= B * parts) break;
    const int b = item / parts, d0 = (item % parts) * plen;
    const int d1 = min(D, d0 + plen);
    for (int d = d0 + tid; d < d1; d += kThreads) {
      dv_s[il * plen + d - d0] = 0.0f;
      dba_s[il * plen + d - d0] = 0.0f;
      for (int te = 0; te < Te; ++te) {
        if (dep_smem) {
          dep_s[(static_cast<long long>(il) * Te + te) * plen + d - d0] = 0.0f;
        } else {
          dep[te * dep_st + b * dep_sb + d] = 0.0f;
        }
      }
    }
  }
  __syncthreads();

  for (int t = Td - 1; t >= 0; --t) {
    const long long tB = static_cast<long long>(t) * B;
    S* dxw_t = dxw + tB * D3;
    unsigned long long* clk = clocked ? phase_ns + 5LL * (Td - 1 - t) : nullptr;
    // the d_ctx rows the attention phase reads: the stream itself, or in
    // bf16 the float32 row buffer
    float* dcx;
    if constexpr (kF32) {
      dcx = dctx + tB * E;
    } else {
      dcx = dctx32;
    }

    // 1: dh', the update-gate and candidate gradients of the owned units
    for (int gl = 0; gl < gpb; ++gl) {
      const int g = blockIdx.x + gl * nblk;
      if (g >= groups) break;
      const float* dh = DH(gl);
      float* dhn = DHN(gl);
      for (int i = tid; i < 4 * B; i += kThreads) {
        const int b = i / 4, k = kUnits * g + i % 4;
        if (k >= D) continue;
        const long long row = tB + b;
        const float dm = to_f32(dmask[row]);
        const float h = to_f32(hprev[row * D + k]);
        const float u = to_f32(acts[row * D3 + k]), c = to_f32(acts[row * D3 + 2 * D + k]);
        const float d = to_f32(dy[t * dy_st + b * dy_sb + k]) + dm * dh[i];
        dhn[i] = d;
        stcg_as(dxw + row * D3 + k, d * (h - c) * u * (1.0f - u));
        stcg_as(dxw + row * D3 + 2 * D + k, d * (1.0f - u) * (1.0f - c * c));
      }
    }
    bar.sync();
    if (clk) clk[0] = global_ns();

    // 2: drh = dcand . wg[:, 2D:]^T and the reset-gate gradient
    for (int gl = 0; gl < gpb; ++gl) {
      const int g = blockIdx.x + gl * nblk;
      if (g >= groups) break;
      block_product<4>(DRH(gl), 4, B, dxw_t + 2 * D, D3, D, W2(gl));
    }
    __syncthreads();
    for (int gl = 0; gl < gpb; ++gl) {
      const int g = blockIdx.x + gl * nblk;
      if (g >= groups) break;
      const float* drh = DRH(gl);
      for (int i = tid; i < 4 * B; i += kThreads) {
        const int b = i / 4, k = kUnits * g + i % 4;
        if (k >= D) continue;
        const long long row = tB + b;
        const float r = to_f32(acts[row * D3 + D + k]);
        stcg_as(dxw + row * D3 + D + k, drh[i] * to_f32(hprev[row * D + k]) * r * (1.0f - r));
      }
    }
    bar.sync();
    if (clk) clk[1] = global_ns();

    // 3: d_ctx = d_din . wctx^T for the owned rows of wctx
    for (int el = 0; el < epb; ++el) {
      const int eg = blockIdx.x + el * nblk;
      if (eg >= egroups) break;
      block_product<8>(out3, 8, B, dxw_t, D3, 3 * D, W3base + el * 24LL * D);
      __syncthreads();
      for (int i = tid; i < 8 * B; i += kThreads) {
        const int b = i / 8, e = kERows * eg + i % 8;
        if (e < E) {
          if constexpr (!kF32) __stcg(dcx + static_cast<long long>(b) * E + e, out3[i]);
          stcg_as(dctx + (tB + b) * E + e, out3[i]);
        }
      }
      __syncthreads();
    }
    bar.sync();
    if (clk) clk[2] = global_ns();

    // 4: per (row, part of D): dalpha, the softmax and tanh backward
    for (int il = 0; il < ipb; ++il) {
      const int item = blockIdx.x + il * nblk;
      if (item >= B * parts) break;
      const int b = item / parts, d0 = (item % parts) * plen;
      const int d1 = min(D, d0 + plen);
      const long long row = tB + b;
      for (int e = tid; e < E; e += kThreads)
        dc_s[e] = __ldcg(dcx + static_cast<long long>(b) * E + e);
      __syncthreads();
      warp_dots<8>(ds_s, ev + b * ev_sb, ev_st, Te, E,
                [&](float x, int e) { return x * dc_s[e]; });
      __syncthreads();
      // masked softmax backward; padded positions have alpha = 0
      if (warp == 0) {
        const S* al = alpha + row * Te;
        float dot = 0.0f;
        for (int te = lane; te < Te; te += 32) dot += to_f32(al[te]) * ds_s[te];
        dot = warp_sum(dot);
        for (int te = lane; te < Te; te += 32) ds_s[te] = to_f32(al[te]) * (ds_s[te] - dot);
      }
      __syncthreads();
      for (int d = d0 + tid; d < d1; d += kThreads) {
        const float md = m_all[row * D + d], vd = v_s[d];
        const S* epb = ep + b * ep_sb + d;
        float* acc = dep_smem ? dep_s + static_cast<long long>(il) * Te * plen + d - d0
                              : dep + b * dep_sb + d;
        const long long acc_st = dep_smem ? plen : dep_st;
        float dsum = 0.0f, dvs = 0.0f;
        for (int te0 = 0; te0 < Te; te0 += 16) {   // sixteen loads in flight
          float x[16];
#pragma unroll
          for (int u = 0; u < 16; ++u) x[u] = te0 + u < Te ? to_f32(epb[(te0 + u) * ep_st]) : 0.0f;
#pragma unroll
          for (int u = 0; u < 16; ++u) {
            const int te = te0 + u;
            if (te >= Te) break;
            const float cmb = tanhf(x[u] + md);
            const float dt = (1.0f - cmb * cmb) * ds_s[te] * vd;
            acc[te * acc_st] += dt;
            dsum += dt;
            dvs = fmaf(cmb, ds_s[te], dvs);
          }
        }
        __stcg(dm_rows + row * D + d, dsum);
        dv_s[il * plen + d - d0] += dvs;
        dba_s[il * plen + d - d0] += dsum;
      }
      __syncthreads();
    }
    bar.sync();
    if (clk) clk[3] = global_ns();

    // 5: DH = dh' u + drh r + d_din[:, :2D] . wg[k, :2D] + d_m . wa[k, :] + (1 - dm) DH
    for (int gl = 0; gl < gpb; ++gl) {
      const int g = blockIdx.x + gl * nblk;
      if (g >= groups) break;
      block_product<4, !kF32>(OUT(gl), 4, B, dxw_t, D3, 2 * D, W5(gl),
                              dm_rows + tB * D, D, D, W5(gl) + 8LL * D);
    }
    __syncthreads();
    for (int gl = 0; gl < gpb; ++gl) {
      const int g = blockIdx.x + gl * nblk;
      if (g >= groups) break;
      float* dh = DH(gl);
      const float* dhn = DHN(gl);
      const float* drh = DRH(gl);
      const float* out = OUT(gl);
      for (int i = tid; i < 4 * B; i += kThreads) {
        const int b = i / 4, k = kUnits * g + i % 4;
        if (k >= D) continue;
        const long long row = tB + b;
        const float dm = to_f32(dmask[row]);
        dh[i] = dhn[i] * to_f32(acts[row * D3 + k]) + drh[i] * to_f32(acts[row * D3 + D + k])
                + out[i] + (1.0f - dm) * dh[i];
      }
    }
    __syncthreads();
    if (clk) clk[4] = global_ns();
  }

  for (int gl = 0; gl < gpb; ++gl) {
    const int g = blockIdx.x + gl * nblk;
    if (g >= groups) break;
    const float* dh = DH(gl);
    for (int i = tid; i < 4 * B; i += kThreads) {
      const int b = i / 4, k = kUnits * g + i % 4;
      if (k < D) dh0[static_cast<long long>(b) * D + k] = from_f32<S>(dh[i]);
    }
  }
  for (int il = 0; il < ipb; ++il) {
    const int item = blockIdx.x + il * nblk;
    if (item >= B * parts) break;
    const int b = item / parts, d0 = (item % parts) * plen;
    const int d1 = min(D, d0 + plen);
    for (int d = d0 + tid; d < d1; d += kThreads) {
      dv_part[static_cast<long long>(b) * D + d] = dv_s[il * plen + d - d0];
      dv_part[(static_cast<long long>(B) + b) * D + d] = dba_s[il * plen + d - d0];
      if (dep_smem) {
        for (int te = 0; te < Te; ++te)
          dep[te * dep_st + b * dep_sb + d] =
              dep_s[(static_cast<long long>(il) * Te + te) * plen + d - d0];
      }
    }
  }

  // dWa = h_prev^T . d_m over the N = Td * B rows: tiles of 32 rows k x 64
  // columns d over the blocks, each thread 2 x 4 sums; 32 rows n at a time
  // staged in shared memory (now free), the next 32 loaded meanwhile
  const int N = Td * B;
  const int tiles_d = (D + kTd - 1) / kTd;
  const int tiles = (D + kTk - 1) / kTk * tiles_d;
  float* hs = smem;                 // [kTn][kTk]
  float* ms = smem + kTn * kTk;     // [kTn][kTd]
  const int kk = (tid / 16) * 2, dd = (tid % 16) * 4;
  for (int tile = blockIdx.x; tile < tiles; tile += nblk) {
    const int k0 = (tile / tiles_d) * kTk, c0 = (tile % tiles_d) * kTd;
    float acc[2][4] = {};
    float ph[4], pm[8];
    auto fetch = [&](int n0) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = tid + q * kThreads, n = n0 + i / kTk, k = k0 + i % kTk;
        ph[q] = n < N && k < D ? to_f32(hprev[static_cast<long long>(n) * D + k]) : 0.0f;
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int i = tid + q * kThreads, n = n0 + i / kTd, d = c0 + i % kTd;
        pm[q] = n < N && d < D ? __ldcg(dm_rows + static_cast<long long>(n) * D + d) : 0.0f;
      }
    };
    fetch(0);
    for (int n0 = 0; n0 < N; n0 += kTn) {
      __syncthreads();
#pragma unroll
      for (int q = 0; q < 4; ++q) hs[tid + q * kThreads] = ph[q];
#pragma unroll
      for (int q = 0; q < 8; ++q) ms[tid + q * kThreads] = pm[q];
      __syncthreads();
      if (n0 + kTn < N) fetch(n0 + kTn);
#pragma unroll 8
      for (int n = 0; n < kTn; ++n) {
        const float h0v = hs[n * kTk + kk], h1v = hs[n * kTk + kk + 1];
        const float4 mv = *reinterpret_cast<const float4*>(ms + n * kTd + dd);
        const float m4[4] = {mv.x, mv.y, mv.z, mv.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[0][c] = fmaf(h0v, m4[c], acc[0][c]);
          acc[1][c] = fmaf(h1v, m4[c], acc[1][c]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int k = k0 + kk + r, d = c0 + dd + c;
        if (k < D && d < D) dwa[static_cast<long long>(k) * D + d] = acc[r][c];
      }
  }
}

// The entries' shared launch (see attention_gru_bwd below).
template <typename S>
int launch_bwd(const void* dy, long long dy_st, long long dy_sb, const void* ep, long long ep_st,
               long long ep_sb, const void* ev, long long ev_st, long long ev_sb,
               const void* dmask, const void* hprev, const void* acts, const void* alpha,
               const void* m_all, const void* wa, const void* v, const void* wctx,
               const void* wg, void* dxw, void* dctx, void* dh0, void* dep, long long dep_st,
               long long dep_sb, void* dwa, void* dba, void* dv, void* dm_rows, void* dv_part,
               void* counter, void* dctx32, void* phase_ns, int Td, int B, int Te, int D, int E,
               int num_sms, void* stream) {
  if (Td <= 0 || B <= 0 || Te <= 0 || D <= 0 || E <= 0) return static_cast<int>(cudaSuccess);
  if (!IsF32<S>::value && dctx32 == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Plan p = make_plan(B, D, E, num_sms, true);
  const bool dep_smem = bwd_smem_floats(B, Te, D, E, p, true) * sizeof(float) <= kSmemLimit;
  const size_t smem = bwd_smem_floats(B, Te, D, E, p, dep_smem) * sizeof(float);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(counter, 0, sizeof(unsigned), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_cooperative(
      attention_gru_bwd_kernel<S>, p.blocks, smem, st,
      static_cast<const S*>(dy), dy_st, dy_sb,
      static_cast<const S*>(ep), ep_st, ep_sb,
      static_cast<const S*>(ev), ev_st, ev_sb,
      static_cast<const S*>(dmask), static_cast<const S*>(hprev),
      static_cast<const S*>(acts), static_cast<const S*>(alpha),
      static_cast<const float*>(m_all), static_cast<const S*>(wa),
      static_cast<const S*>(v), static_cast<const S*>(wctx),
      static_cast<const S*>(wg),
      static_cast<S*>(dxw), static_cast<S*>(dctx), static_cast<S*>(dh0),
      static_cast<float*>(dep), dep_st, dep_sb,
      static_cast<float*>(dwa), static_cast<float*>(dm_rows), static_cast<float*>(dv_part),
      static_cast<unsigned*>(counter), static_cast<float*>(dctx32),
      static_cast<unsigned long long*>(phase_ns),
      Td, B, Te, D, E, p.gpb, p.epb, p.parts, p.plen, p.ipb, dep_smem ? 1 : 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // dba = column sums of the dba partials, dv = column sums of the dv partials
  const float* parts = static_cast<const float*>(dv_part);
  err = atb(nullptr, 0, nullptr, 0, parts + static_cast<long long>(B) * D, D,
            static_cast<float*>(dba), D, B, 1, D, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(atb(nullptr, 0, nullptr, 0, parts, D, static_cast<float*>(dv), D, B,
                              1, D, st));
}

}  // namespace

// dy [Td, B, D], ep [Te, B, D], ev [Te, B, E] and the output dep [Te, B, D]
// are addressed through their time and batch strides (in elements; the last
// dimension is contiguous). dmask [Td, B], the residuals hprev [Td, B, D],
// acts [Td, B, 3D], alpha [Td, B, Te] and m_all [Td, B, D], the weights
// wa [D, D], v [D], wctx [E, 3D], wg [D, 3D], the outputs dxw [Td, B, 3D],
// dctx [Td, B, E], dh0 [B, D], dwa [D, D], dba [D], dv [D] and the scratch
// dm_rows [Td, B, D] and dv_part [2, B, D] are contiguous;
// counter is one unsigned of scratch; num_sms is the card's SM count.
// phase_ns, when not null ([Td][5] unsigned 64-bit integers), receives block
// 0's clock in ns at the end of each phase of each step (the first four with
// their barrier), in the loop's order.
// Launches the reversed-time recurrence with dWa (cooperatively) and then
// the dba / dv sums over the rows on `stream`; returns the first error, as
// attention_gru_fwd_train does.
extern "C" int attention_gru_bwd(const void* dy, long long dy_st, long long dy_sb,
                                 const void* ep, long long ep_st, long long ep_sb,
                                 const void* ev, long long ev_st, long long ev_sb,
                                 const void* dmask, const void* hprev, const void* acts,
                                 const void* alpha, const void* m_all,
                                 const void* wa, const void* v,
                                 const void* wctx, const void* wg,
                                 void* dxw, void* dctx, void* dh0,
                                 void* dep, long long dep_st, long long dep_sb,
                                 void* dwa, void* dba, void* dv,
                                 void* dm_rows, void* dv_part, void* counter, void* phase_ns,
                                 int Td, int B, int Te, int D, int E, int num_sms,
                                 void* stream) {
  return launch_bwd<float>(dy, dy_st, dy_sb, ep, ep_st, ep_sb, ev, ev_st, ev_sb, dmask, hprev,
                           acts, alpha, m_all, wa, v, wctx, wg, dxw, dctx, dh0, dep, dep_st,
                           dep_sb, dwa, dba, dv, dm_rows, dv_part, counter, nullptr, phase_ns,
                           Td, B, Te, D, E, num_sms, stream);
}

// attention_gru_bwd's bf16 instance: dy, ep, ev, dmask, hprev, acts, alpha,
// the weights, dxw, dctx and dh0 are bf16 (__nv_bfloat16); m_all, dep, dwa,
// dba, dv and the scratch float32; dctx32 is float32 scratch [B, E].
extern "C" int attention_gru_bwd_bf16(const void* dy, long long dy_st, long long dy_sb,
                                      const void* ep, long long ep_st, long long ep_sb,
                                      const void* ev, long long ev_st, long long ev_sb,
                                      const void* dmask, const void* hprev, const void* acts,
                                      const void* alpha, const void* m_all,
                                      const void* wa, const void* v,
                                      const void* wctx, const void* wg,
                                      void* dxw, void* dctx, void* dh0,
                                      void* dep, long long dep_st, long long dep_sb,
                                      void* dwa, void* dba, void* dv,
                                      void* dm_rows, void* dv_part, void* counter, void* dctx32,
                                      void* phase_ns, int Td, int B, int Te, int D, int E,
                                      int num_sms, void* stream) {
  return launch_bwd<__nv_bfloat16>(dy, dy_st, dy_sb, ep, ep_st, ep_sb, ev, ev_st, ev_sb, dmask,
                                   hprev, acts, alpha, m_all, wa, v, wctx, wg, dxw, dctx, dh0,
                                   dep, dep_st, dep_sb, dwa, dba, dv, dm_rows, dv_part, counter,
                                   dctx32, phase_ns, Td, B, Te, D, E, num_sms, stream);
}
