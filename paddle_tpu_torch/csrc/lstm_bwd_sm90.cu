// lstm_bwd_sm90 — kernel 8's bf16 body for Hopper: the backward of the
// masked peephole LSTM scan in bf16 operands (lstm_bwd_bf16's function), its
// products on the bf16 tensor cores.
//
// Replaces: paddle_tpu/ops/pallas_lstm.py _bwd_kernel in bf16 (launched by
// pl.pallas_call in _run_bwd), as lstm_bwd.cu's bf16 instance does; this
// body takes the shapes fused_lstm.sm90_takes gives it (H a multiple of 64,
// a block's state within shared memory), lstm_bwd_bf16 the others. The
// step's arithmetic and its rounding are the Pallas kernel's:
//   dx4[t] = [dga | dgi | dgf | dgo], stored bf16 (the output);
//   DH     = bf16(dx4[t]) . w^T + (1 - m) DH, bf16 operands, float32 sums;
//   dW     = sum over the rows n = (t, b) of bf16 hprev^T . dgates with the
//            gate gradients unrounded, dpeep in float32, each rounded once.
// (lstm_bwd.cu's header has the step's equations.)
//
// What bounds it on an H100: at T = 64, B = 256, H = 512 it moves ~0.2 GB
// (0.06 ms at 3.35 TB/s) and does 69.1 GFLOP, 0.070 ms at the 989 TFLOP/s
// bf16 rate; the reversed loop is sequential, and each step needs all 4H
// gate-gradient columns of its rows from the step after.
//
// What the design does about that. Two launches on the stream:
//  1. lstm_bwd_sm90_loop, the recurrence: a persistent cooperative grid in
//     P row groups of G blocks (sm90 plan, mirrored by
//     fused_lstm.sm90_plan). A block owns U = 32 hidden units (16 at wide
//     H), their rows of w in shared memory as bf16 ([4H/32][U][32]: a
//     32-k chunk of a unit is 64 contiguous bytes), and the state DH, DC of
//     its group's R rows. With 2-byte rows a block holds twice the units of
//     lstm_bwd_bf16's float32 carve, so a group has half the blocks and a
//     step reads half the rows of dx4 through L2 per unit (B x 4H x 2 bytes
//     per block of a group: 16 MB a step at the classifier's shape against
//     lstm_bwd_bf16's 128 MB of float32). One barrier a step, in the group:
//       1  for the owned units and rows: c', dh, the gate gradients; dx4[t]
//          in bf16 (hi) and what its rounding left in bf16 (lo, scratch
//          [T][B][4H]); DC in shared memory; the peephole sums in registers
//          (a thread's unit is fixed). Its operands (the residuals, dy, the
//          mask) do not depend on DH: a thread loads its first batch of
//          them for step s + 1 right after step s's barrier, and the
//          product's time covers their trip from device memory;
//       2  DH[rows, U] = dx4[t][rows, :] . w[U, :]^T on mma.sync m16n8k16
//          bf16, the A rows read as 16-byte vectors through L2 straight into
//          the fragments (mma_bf16.cuh's permuted k), 32 rows a tile; the
//          eight warps split the 4H contraction, and their partial tiles are
//          summed through shared memory in warp order.
//  2. lstm_dw_sm90, dW off the loop: one product over all T B rows,
//     dW = hprev^T . hi + hprev^T . lo on the tensor cores
//     (rows_product.cuh); hi + lo keeps ~16 bits of each unrounded gate
//     gradient, as the float32 sums of the Pallas kernel need (one piece
//     would hold each product term to 2^-9). Its first block also sums the
//     groups' dpeep partials.
// Every sum runs in a fixed order and nothing is summed by atomics: two
// launches give the same bits.

#include "common.cuh"
#include "mma_bf16.cuh"
#include "persistent_grid.cuh"
#include "rows_product.cuh"

namespace {

using namespace pgrid;
using bf16 = __nv_bfloat16;

constexpr int kRT = 32;      // rows of a product tile: two m16 tiles
constexpr int kLoad = 4;     // 32-k chunks a warp loads before it multiplies
constexpr int kItems = 4;    // phase 1's items a thread loads at once

// How the recurrence's grid is cut (mirrored by fused_lstm.sm90_plan).
struct Sm90Plan {
  int U, G, P, R;   // units a block, blocks a row group, row groups, rows a group
};

// Shared memory of a loop block: w's rows in bf16, the warps' partial
// product tiles [kWarps][kRT][U], DH and DC [R][U], the block's peepholes.
inline size_t loop_smem_bytes(int U, int H, int R) {
  return 2ull * U * 4 * H + 4ull * kWarps * kRT * U + 8ull * R * U + 12ull * U;
}

inline Sm90Plan make_plan(int B, int H, int num_sms) {
  const int widths[2] = {32, 16};
  if (B >= 1 && H > 0 && H % 64 == 0) {
    for (int U : widths) {
      const int G = H / U;
      if (G > num_sms) continue;
      const int P = max(1, min(B, num_sms / G));
      const int R = (B + P - 1) / P;
      if (loop_smem_bytes(U, H, R) <= kSmemLimit) return Sm90Plan{U, G, P, R};
    }
  }
  return Sm90Plan{0, 0, 0, 0};
}

// Phase 1's operands of a thread's batch of items.
struct Cells {
  float m[kItems], a[kItems], ig[kItems], fg[kItems], og[kItems], cp[kItems], dy[kItems];
};

__device__ __forceinline__ void stcg_bf16(bf16* p, bf16 v) {
  __stcg(reinterpret_cast<unsigned short*>(p), __bfloat16_as_ushort(v));
}

template <int U>
__global__ void __launch_bounds__(kThreads, 1)
lstm_bwd_sm90_loop(const bf16* __restrict__ dy, long long dy_st, long long dy_sb,
                   const bf16* __restrict__ acts, const float* __restrict__ cprev,
                   const float* __restrict__ mask, long long m_st, long long m_sb,
                   const bf16* __restrict__ w, const bf16* __restrict__ peep, bf16* dx4,
                   bf16* __restrict__ lo, float* __restrict__ ppart, unsigned* counters,
                   unsigned long long* phase_ns, int T, int B, int H, int reverse, int act_in,
                   int act_gate, int act_state, int G, int R) {
  constexpr int NT = U / 8;                  // the block's units as n8 tiles
  static_assert(kThreads % U == 0, "a thread's unit is fixed in phase 1");
  extern __shared__ float4 smem4[];
  const int K = 4 * H;
  bf16* ws = reinterpret_cast<bf16*>(smem4);                          // [K / 32][U][32]
  float* red = reinterpret_cast<float*>(ws + static_cast<size_t>(U) * K);   // [kWarps][kRT][U]
  float* dhs = red + kWarps * kRT * U;                                // [R][U]
  float* dcs = dhs + static_cast<size_t>(R) * U;                      // [R][U]
  float* pps = dcs + static_cast<size_t>(R) * U;                      // [3][U]
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int p = blockIdx.x / G;                         // row group
  const int u0 = (blockIdx.x % G) * U;                  // the block's first unit
  const int row0 = p * R;
  const int rows = max(0, min(B, row0 + R) - row0);
  GridBarrier bar{counters + p, 0, static_cast<unsigned>(G)};
  const bool clocked = phase_ns != nullptr && blockIdx.x == 0 && tid == 0;

  // w's rows of the block's units, 16 bytes a copy, read along the rows
  for (int i = tid; i < U * (K / 8); i += kThreads) {
    const int n = i / (K / 8), e8 = i % (K / 8);
    const uint4 v =
        *reinterpret_cast<const uint4*>(w + static_cast<long long>(u0 + n) * K + 8 * e8);
    *reinterpret_cast<uint4*>(ws + (static_cast<size_t>(e8 / 4) * U + n) * 32 + 8 * (e8 % 4)) =
        v;
  }
  for (int i = tid; i < R * U; i += kThreads) {
    dhs[i] = 0.0f;
    dcs[i] = 0.0f;
  }
  for (int i = tid; i < 3 * U; i += kThreads) pps[i] = to_f32(peep[(i / U) * H + u0 + i % U]);
  __syncthreads();

  const int c_own = tid % U;                 // the unit of every item of this thread
  float ps_i = 0.0f, ps_f = 0.0f, ps_o = 0.0f;
  const int kw0 = warp * (K / kWarps);       // the warp's share of the contraction
  const int nch = K / kWarps / 32;           // as 32-k chunks (H / 64)
  // phase 1's operands of the items i0 + q kThreads at step t (0 past the
  // group's rows): the residuals, dy and the mask
  auto load_cells = [&](Cells& c, int t, int i0) {
    const long long tB = static_cast<long long>(t) * B;
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      const int i = i0 + q * kThreads;
      const bool ok = i < rows * U;
      const int b = row0 + (ok ? i / U : 0);
      const long long row = tB + b;
      const int k = u0 + c_own;
      const bf16* ar = acts + row * K + k;             // [a | i | f | o]
      c.m[q] = ok ? mask[t * m_st + b * m_sb] : 0.0f;
      c.a[q] = ok ? to_f32(ar[0]) : 0.0f;
      c.ig[q] = ok ? to_f32(ar[H]) : 0.0f;
      c.fg[q] = ok ? to_f32(ar[2 * H]) : 0.0f;
      c.og[q] = ok ? to_f32(ar[3 * H]) : 0.0f;
      c.cp[q] = ok ? cprev[row * H + k] : 0.0f;
      c.dy[q] = ok ? to_f32(dy[t * dy_st + b * dy_sb + k]) : 0.0f;
    }
  };
  Cells next;
  if (T > 0) load_cells(next, reverse ? 0 : T - 1, tid);

  for (int s = 0; s < T; ++s) {
    if (clocked) phase_ns[3 * s] = global_ns();
    const int t = reverse ? s : T - 1 - s;
    const long long tB = static_cast<long long>(t) * B;
    bf16* dxt = dx4 + tB * K;

    // 1: the gate gradients of the owned units and rows, every operand of a
    //    batch of kItems items loaded before any is used (the first batch's
    //    during the previous step's product)
    for (int i0 = tid; i0 < rows * U; i0 += kThreads * kItems) {
      Cells cur;
      if (i0 == tid) {
        cur = next;
      } else {
        load_cells(cur, t, i0);
      }
#pragma unroll
      for (int q = 0; q < kItems; ++q) {
        const int i = i0 + q * kThreads;
        if (i >= rows * U) continue;
        const int k = u0 + c_own;
        const long long row = tB + row0 + i / U;
        const float m = cur.m[q], a = cur.a[q], ig = cur.ig[q], fg = cur.fg[q], og = cur.og[q],
                    cp = cur.cp[q];
        const float cn = fg * cp + ig * a;
        const float sc = act_f32(act_state, cn);
        const float dcv = dcs[i];
        const float dh = m * (dhs[i] + cur.dy[q]);
        const float dgo = dh * sc * dact_f32(act_gate, og);
        const float dc = dh * og * dact_f32(act_state, sc) + m * dcv + dgo * pps[2 * U + c_own];
        const float dgi = dc * a * dact_f32(act_gate, ig);
        const float dgf = dc * cp * dact_f32(act_gate, fg);
        const float dga = dc * ig * dact_f32(act_in, a);
        const float dg[4] = {dga, dgi, dgf, dgo};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          bf16 hi, rest;
          split_bf16(dg[j], hi, rest);
          stcg_bf16(dx4 + row * K + j * H + k, hi);
          lo[row * K + j * H + k] = rest;
        }
        dcs[i] = dc * fg + dgi * pps[c_own] + dgf * pps[U + c_own] + (1.0f - m) * dcv;
        ps_i += dgi * cp;
        ps_f += dgf * cp;
        ps_o += dgo * cn;
      }
    }
    bar.sync();                                        // the group's dx4[t] is written
    if (clocked) phase_ns[3 * s + 1] = global_ns();
    if (s + 1 < T) load_cells(next, reverse ? s + 1 : T - 2 - s, tid);

    // 2: DH = dx4[t] . w^T + (1 - m) DH, 32 rows a tile
    for (int rt0 = 0; rt0 < rows; rt0 += kRT) {
      float acc[2][NT][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < NT; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;
      for (int cb = 0; cb < nch; cb += kLoad) {
        uint4 ra[kLoad][2][2];                         // [chunk][m16 tile][row g, g + 8]
#pragma unroll
        for (int q = 0; q < kLoad; ++q)
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = rt0 + 16 * mi + 8 * h + g;
              ra[q][mi][h] =
                  cb + q < nch && r < rows
                      ? mmabf16::ldcg16(dxt + static_cast<long long>(row0 + r) * K + kw0 +
                                        32 * (cb + q) + 8 * tq)
                      : mmabf16::zero4();
            }
#pragma unroll
        for (int q = 0; q < kLoad; ++q) {
          if (cb + q < nch) {                          // uniform over the block
            const bf16* wc =
                ws + static_cast<size_t>(kw0 / 32 + cb + q) * U * 32 + g * 32 + 8 * tq;
#pragma unroll
            for (int ni = 0; ni < NT; ++ni) {
              const uint4 wv = *reinterpret_cast<const uint4*>(wc + ni * 8 * 32);
#pragma unroll
              for (int mi = 0; mi < 2; ++mi)
                mmabf16::chunk32(acc[mi][ni], ra[q][mi][0], ra[q][mi][1], wv);
            }
          }
        }
      }
      float* rw = red + warp * kRT * U;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) {
          const int r = 16 * mi + g, c = 8 * ni + 2 * tq;
          *reinterpret_cast<float2*>(rw + r * U + c) = make_float2(acc[mi][ni][0], acc[mi][ni][1]);
          *reinterpret_cast<float2*>(rw + (r + 8) * U + c) =
              make_float2(acc[mi][ni][2], acc[mi][ni][3]);
        }
      __syncthreads();
      const int nr = min(kRT, rows - rt0);
      for (int i = tid; i < nr * U; i += kThreads) {
        float v = 0.0f;
#pragma unroll
        for (int x = 0; x < kWarps; ++x) v += red[x * kRT * U + i];
        const int bl = rt0 + i / U;
        const float m = mask[t * m_st + (row0 + bl) * m_sb];
        float* dh = dhs + bl * U + i % U;
        *dh = v + (1.0f - m) * *dh;
      }
      __syncthreads();
    }
    if (clocked) phase_ns[3 * s + 2] = global_ns();
  }

  // the peephole partials of the block's units over its group's rows: one
  // per unit over the threads that held it, in thread order
  __syncthreads();
  red[tid] = ps_i;
  red[kThreads + tid] = ps_f;
  red[2 * kThreads + tid] = ps_o;
  __syncthreads();
  for (int e = tid; e < 3 * U; e += kThreads) {
    const int gq = e / U, c = e % U;
    float sum = 0.0f;
    for (int x = c; x < kThreads; x += U) sum += red[gq * kThreads + x];
    ppart[(static_cast<long long>(p) * 3 + gq) * H + u0 + c] = sum;
  }
}

// dW [H][4H] = hprev^T . (hi + lo) over the N = T B rows (rows_product.cuh);
// the first block also writes dpeep, the groups' partials summed in group
// order.
__global__ void __launch_bounds__(kThreads)
lstm_dw_sm90(const bf16* __restrict__ hprev, const bf16* __restrict__ hi,
             const bf16* __restrict__ lo, const float* __restrict__ ppart,
             bf16* __restrict__ dw, bf16* __restrict__ dpeep, int N, int H, int P) {
  extern __shared__ float4 smem4[];
  if (blockIdx.x == 0 && blockIdx.y == 0) {
    for (int e = threadIdx.x; e < 3 * H; e += kThreads) {
      float sum = 0.0f;
      for (int q = 0; q < P; ++q) sum += ppart[static_cast<long long>(q) * 3 * H + e];
      dpeep[e] = __float2bfloat16_rn(sum);
    }
  }
  rowsprod::tile(hprev, H, H, hi, lo, 4LL * H, N, dw, 4LL * H, reinterpret_cast<bf16*>(smem4));
}

template <int U>
cudaError_t launch_loop(const Sm90Plan& pl, cudaStream_t st, const bf16* dy, long long dy_st,
                        long long dy_sb, const bf16* acts, const float* cprev, const float* mask,
                        long long m_st, long long m_sb, const bf16* w, const bf16* peep,
                        bf16* dx4, bf16* lo, float* ppart, unsigned* counters,
                        unsigned long long* phase_ns, int T, int B, int H, int reverse,
                        int act_in, int act_gate, int act_state) {
  return launch_cooperative(lstm_bwd_sm90_loop<U>, pl.P * pl.G, loop_smem_bytes(U, H, pl.R), st,
                            dy, dy_st, dy_sb, acts, cprev, mask, m_st, m_sb, w, peep, dx4, lo,
                            ppart, counters, phase_ns, T, B, H, reverse, act_in, act_gate,
                            act_state, pl.G, pl.R);
}

}  // namespace

// lstm_bwd_bf16's function on the body above (lstm_bwd_bf16's arguments
// where they are the same). dy [T, B, H] and mask [T, B] through their time
// and batch strides (in elements); acts [T, B, 4H], hprev [T, B, H] (bf16),
// cprev [T, B, H] (float32), w [H, 4H] and peep [3, H] (bf16) and the
// outputs dx4 [T, B, 4H], dw [H, 4H], dpeep [3, H] (bf16) contiguous, hprev,
// w and the outputs 16-byte aligned. Scratch: lo [T, B, 4H] bf16, ppart
// (3 P H floats), counters (P unsigned), with P the plan's row groups
// (fused_lstm.sm90_plan). phase_ns as lstm_bwd's ([T][3], or null).
// Launches the recurrence (cooperatively) and then the dW product on
// `stream`; returns the first error, or cudaErrorInvalidValue for a shape
// the plan does not take (H not a multiple of 64, a block's state past its
// shared memory).
extern "C" int lstm_bwd_bf16_sm90(const void* dy, long long dy_st, long long dy_sb,
                                  const void* acts, const void* hprev, const void* cprev,
                                  const void* mask, long long m_st, long long m_sb,
                                  const void* w, const void* peep, void* dx4, void* dw,
                                  void* dpeep, void* lo, void* ppart, void* counters,
                                  void* phase_ns, int T, int B, int H, int reverse, int act_in,
                                  int act_gate, int act_state, int num_sms, void* stream) {
  const Sm90Plan pl = make_plan(B, H, num_sms);
  if (T < 0 || pl.U == 0 || static_cast<long long>(T) * B >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(counters, 0, pl.P * sizeof(unsigned), st);
  if (err != cudaSuccess) return static_cast<int>(err);
#define LSTM_SM90_ARGS pl, st, static_cast<const bf16*>(dy), dy_st, dy_sb,                  \
    static_cast<const bf16*>(acts), static_cast<const float*>(cprev),                       \
    static_cast<const float*>(mask), m_st, m_sb, static_cast<const bf16*>(w),               \
    static_cast<const bf16*>(peep), static_cast<bf16*>(dx4), static_cast<bf16*>(lo),        \
    static_cast<float*>(ppart), static_cast<unsigned*>(counters),                           \
    static_cast<unsigned long long*>(phase_ns), T, B, H, reverse, act_in, act_gate, act_state
  err = pl.U == 32 ? launch_loop<32>(LSTM_SM90_ARGS) : launch_loop<16>(LSTM_SM90_ARGS);
#undef LSTM_SM90_ARGS
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_smem(lstm_dw_sm90, rowsprod::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  lstm_dw_sm90<<<rowsprod::grid(H, 4 * H), kThreads, rowsprod::kSmem, st>>>(
      static_cast<const bf16*>(hprev), static_cast<const bf16*>(dx4),
      static_cast<const bf16*>(lo), static_cast<const float*>(ppart), static_cast<bf16*>(dw),
      static_cast<bf16*>(dpeep), T * B, H, pl.P);
  return static_cast<int>(cudaGetLastError());
}
