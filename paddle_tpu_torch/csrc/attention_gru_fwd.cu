// attention_gru_fwd — the fused attention-GRU decoder loop in one launch.
//
// Replaces: paddle_tpu/ops/pallas_attention_gru.py _fwd_kernel_light (the
// inference variant launched by pl.pallas_call in _run_fwd, entry
// fused_attention_gru; attention_gru_step is its one-step form). Serving
// launches it with Td = 1 once per decode micro-step.
//
// Per decoder step t, for batch row b, from h = h0[b]:
//   m     = h . wa + ba                                   [D]
//   s_te  = sum_d tanh(ep[te, b, d] + m[d]) * v[d]        [Te], -1e30 where em = 0
//   alpha = softmax over Te of s, then 0 where em = 0     (an all-masked row gives 0)
//   ctx   = sum_te alpha_te * ev[te, b, :]                [E]
//   din   = ctx . wctx + xw[t, b]                         [3D]
//   h'    = GRU(h, din) with wg = [update | reset | candidate]
//   ys[t, b] = h' (raw);   carry h = dm * h' + (1 - dm) * h   (dm = dmask[t, b])
//
// What bounds it on an H100: at Td = 1 the function must read about 24 MB
// (the encoder projection and values of every row, wctx, wg and wa) for
// 0.34 GFLOP, so device memory bounds it at some 7 us; but each block reads
// all three weight matrices (10.5 MB at D = 512, E = 1024) from L2 for its
// one row, so the SM's L2 read rate is what limits this kernel.
//
// What the design does about that: one thread block per batch row runs
// every phase of the step with its intermediates (h, m, the scores, ctx,
// din, u and r*h, about 18 KB at full width) in shared memory, so no
// intermediate goes to device memory and the whole step is one launch;
// the encoder rows are read through their strides, so the slot state's
// batch-major [B, Te, *] buffers need no transpose. Weight reads are
// coalesced (threads own output columns); sharing them across rows is left
// to a later change.

#include "common.cuh"

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
attention_gru_fwd_kernel(const float* __restrict__ ep, long long ep_st, long long ep_sb,
                         const float* __restrict__ ev, long long ev_st, long long ev_sb,
                         const float* __restrict__ em, long long em_st, long long em_sb,
                         const float* __restrict__ xw, const float* __restrict__ dmask,
                         const float* __restrict__ h0,
                         const float* __restrict__ wa, const float* __restrict__ ba,
                         const float* __restrict__ v, const float* __restrict__ wctx,
                         const float* __restrict__ wg, float* __restrict__ ys,
                         int Td, int B, int Te, int D, int E) {
  extern __shared__ float smem[];
  float* h = smem;              // [D]  carry
  float* m = h + D;             // [D]  attention transform
  float* u = m + D;             // [D]  update gate
  float* rh = u + D;            // [D]  reset gate * carry
  float* din = rh + D;          // [3D] GRU input
  float* ctx = din + 3 * D;     // [E]  context
  float* s = ctx + E;           // [Te] scores, then alpha
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const long long D3 = 3LL * D;

  for (int j = threadIdx.x; j < D; j += blockDim.x) h[j] = h0[static_cast<long long>(b) * D + j];
  __syncthreads();

  for (int t = 0; t < Td; ++t) {
    const long long row = static_cast<long long>(t) * B + b;

    // attention transform m = h . wa + ba
    for (int j = threadIdx.x; j < D; j += blockDim.x) {
      float acc = 0.0f;
#pragma unroll 8
      for (int k = 0; k < D; ++k) acc = fmaf(h[k], wa[static_cast<long long>(k) * D + j], acc);
      m[j] = acc + ba[j];
    }
    __syncthreads();

    // scores: one warp per encoder position, lanes across D
    for (int te = warp; te < Te; te += nwarps) {
      const float* ept = ep + te * ep_st + b * ep_sb;
      float part = 0.0f;
      for (int d = lane; d < D; d += 32) part += tanhf(ept[d] + m[d]) * v[d];
      part = warp_sum(part);
      if (lane == 0) s[te] = em[te * em_st + b * em_sb] > 0.0f ? part : -1e30f;
    }
    __syncthreads();

    // masked softmax over Te (warp 0). With every position masked the
    // scores are all -1e30, exp gives 1/Te each, and the mask zeroes them.
    if (warp == 0) {
      float mx = -3.0e38f;
      for (int te = lane; te < Te; te += 32) mx = fmaxf(mx, s[te]);
      mx = warp_max(mx);
      float sum = 0.0f;
      for (int te = lane; te < Te; te += 32) {
        const float e = expf(s[te] - mx);
        s[te] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      for (int te = lane; te < Te; te += 32) {
        s[te] = em[te * em_st + b * em_sb] > 0.0f ? s[te] / sum : 0.0f;
      }
    }
    __syncthreads();

    // context: sum over Te of alpha * ev
    for (int e = threadIdx.x; e < E; e += blockDim.x) {
      float acc = 0.0f;
      for (int te = 0; te < Te; ++te) acc = fmaf(s[te], ev[te * ev_st + b * ev_sb + e], acc);
      ctx[e] = acc;
    }
    __syncthreads();

    // GRU input din = ctx . wctx + xw[t, b]
    for (int j = threadIdx.x; j < 3 * D; j += blockDim.x) {
      float acc = 0.0f;
#pragma unroll 8
      for (int k = 0; k < E; ++k) acc = fmaf(ctx[k], wctx[k * D3 + j], acc);
      din[j] = acc + xw[row * D3 + j];
    }
    __syncthreads();

    // update and reset gates: columns [0, 2D) of wg
    for (int j = threadIdx.x; j < 2 * D; j += blockDim.x) {
      float acc = 0.0f;
#pragma unroll 8
      for (int k = 0; k < D; ++k) acc = fmaf(h[k], wg[k * D3 + j], acc);
      const float g = sigmoid_f32(din[j] + acc);
      if (j < D) {
        u[j] = g;
      } else {
        rh[j - D] = g * h[j - D];
      }
    }
    __syncthreads();

    // candidate, blend, raw output and masked carry: columns [2D, 3D).
    // Thread j reads only rh[] and its own h[j], so h[j] is updated in place.
    const float dm = dmask[row];
    for (int j = threadIdx.x; j < D; j += blockDim.x) {
      float acc = 0.0f;
#pragma unroll 8
      for (int k = 0; k < D; ++k) acc = fmaf(rh[k], wg[k * D3 + 2 * D + j], acc);
      const float c = tanhf(din[2 * D + j] + acc);
      const float hp = h[j];
      const float hn = u[j] * hp + (1.0f - u[j]) * c;
      ys[row * D + j] = hn;
      h[j] = dm * hn + (1.0f - dm) * hp;
    }
    __syncthreads();
  }
}

}  // namespace

// ep [Te, B, D], ev [Te, B, E] and em [Te, B] are addressed through their
// time and batch strides (in elements; the last dimension is contiguous).
// xw [Td, B, 3D], dmask [Td, B], h0 [B, D], wa [D, D], ba [D], v [D],
// wctx [E, 3D], wg [D, 3D] and ys [Td, B, D] are contiguous.
// Launches on `stream`, returns cudaGetLastError().
extern "C" int attention_gru_fwd(const void* ep, long long ep_st, long long ep_sb,
                                 const void* ev, long long ev_st, long long ev_sb,
                                 const void* em, long long em_st, long long em_sb,
                                 const void* xw, const void* dmask, const void* h0,
                                 const void* wa, const void* ba, const void* v,
                                 const void* wctx, const void* wg, void* ys,
                                 int Td, int B, int Te, int D, int E, void* stream) {
  const size_t smem = (7 * static_cast<size_t>(D) + E + Te) * sizeof(float);
  cudaError_t err = allow_smem(attention_gru_fwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (Td > 0 && B > 0 && D > 0) {
    attention_gru_fwd_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(ep), ep_st, ep_sb,
        static_cast<const float*>(ev), ev_st, ev_sb,
        static_cast<const float*>(em), em_st, em_sb,
        static_cast<const float*>(xw), static_cast<const float*>(dmask),
        static_cast<const float*>(h0),
        static_cast<const float*>(wa), static_cast<const float*>(ba),
        static_cast<const float*>(v), static_cast<const float*>(wctx),
        static_cast<const float*>(wg), static_cast<float*>(ys),
        Td, B, Te, D, E);
  }
  return static_cast<int>(cudaGetLastError());
}
