// attention_gru_bwd — the backward of the fused attention-GRU decoder loop.
//
// Replaces: paddle_tpu/ops/pallas_attention_gru.py _bwd_kernel (launched by
// pl.pallas_call in _run_bwd, the custom-VJP backward of
// fused_attention_gru). Its outputs are this source's: d_din (= dxw), the
// d_ctx stream, dh0, d_enc_proj, dWa, dba and dv. dW_ctx, dW_gru and
// d_enc_vec are large time-parallel products of the streams, left to the
// caller as in the JAX package.
//
// Per decoder step, walked t = Td-1 .. 0 for batch row b, with DH the
// gradient carried into the step's carry, dm = dmask[t, b] and the
// residuals (h_prev, u, r, c, alpha) of attention_gru_fwd_train:
//   dh'    = dy[t] + dm * DH                (the output stream is the raw h')
//   d_din  = [du u(1-u) | drh h_prev r(1-r) | dcand]      (GRU backward, as gru_bwd)
//   d_ctx  = d_din . Wctx^T                                [E]
//   m      = h_prev . Wa + ba;   comb = tanh(ep + m)       (recomputed) [Te, D]
//   dalpha = ev . d_ctx;         ds = alpha (dalpha - sum alpha dalpha)
//   dtanh  = (1 - comb^2) * ds * v          d_enc_proj += dtanh
//   d_m    = sum_Te dtanh;       dv += sum_Te comb * ds
//   DH     = dh' u + drh r + dg . Wg^T + d_m . Wa^T + (1 - dm) * DH
// and over every (t, b): dWa = h_prev^T . d_m, dba = sum d_m, dv = sum of
// the rows' partials.
//
// What bounds it on an H100: per step and row the block reads Wctx, Wg and
// Wa (10.5 MB at D = 512, E = 1024) from L2, so as the forward the L2 read
// rate limits it; the function's own bytes (about 70 MB at Td = Te = 32,
// B = 64) and its 33 GFLOP (pallas_attention_gru._flops(bwd=True), some
// 0.5 ms at the 67 TFLOP/s float32 rate) are far below that.
//
// What the design does about that: one thread block per batch row keeps the
// carried gradient, every per-step intermediate and the row's whole
// d_enc_proj accumulator [Te, D] (64 KB at Te = 32, D = 512) in shared
// memory, and writes the accumulator once at the end. Products with a
// transposed weight give each warp one weight row at a time (coalesced,
// summed with shuffles); products with a weight give each thread a column.
// dWa, dba and dv sum over every row and step: the block streams its d_m
// [Td, B, D] to device memory and writes its dv partial once, and the tiled
// contraction of atb_gemm.cuh reduces them afterwards — deterministic, no
// atomics, and no weight-gradient work on the sequential loop.

#include "atb_gemm.cuh"
#include "common.cuh"

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
attention_gru_bwd_kernel(const float* __restrict__ dy, long long dy_st, long long dy_sb,
                         const float* __restrict__ ep, long long ep_st, long long ep_sb,
                         const float* __restrict__ ev, long long ev_st, long long ev_sb,
                         const float* __restrict__ dmask,
                         const float* __restrict__ hprev, const float* __restrict__ acts,
                         const float* __restrict__ alpha,
                         const float* __restrict__ wa, const float* __restrict__ ba,
                         const float* __restrict__ v, const float* __restrict__ wctx,
                         const float* __restrict__ wg,
                         float* __restrict__ dxw, float* __restrict__ dctx,
                         float* __restrict__ dh0,
                         float* __restrict__ dep, long long dep_st, long long dep_sb,
                         float* __restrict__ dm_rows, float* __restrict__ dv_part,
                         int Td, int B, int Te, int D, int E) {
  extern __shared__ float smem[];
  float* dep_acc = smem;          // [Te * D] this row's d_enc_proj
  float* DH = dep_acc + Te * D;   // [D]  gradient carried into the step's carry
  float* dhn = DH + D;            // [D]  gradient of the step's h'
  float* ddin = dhn + D;          // [3D] d_din = [dgu | dgr | dcand]
  float* drh = ddin + 3 * D;      // [D]  gradient of r * h_prev
  float* hp = drh + D;            // [D]  h_prev
  float* m = hp + D;              // [D]  attention transform
  float* dmv = m + D;             // [D]  d_m
  float* dvacc = dmv + D;         // [D]  this row's dv partial
  float* dc = dvacc + D;          // [E]  d_ctx
  float* ds = dc + E;             // [Te] dalpha, then the score gradient
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const long long D3 = 3LL * D;

  for (int i = threadIdx.x; i < Te * D; i += blockDim.x) dep_acc[i] = 0.0f;
  for (int j = threadIdx.x; j < D; j += blockDim.x) {
    DH[j] = 0.0f;
    dvacc[j] = 0.0f;
  }
  __syncthreads();

  for (int t = Td - 1; t >= 0; --t) {
    const long long row = static_cast<long long>(t) * B + b;
    const float dm = dmask[row];
    const float* a = acts + row * D3;            // [u | r | c]
    const float* al = alpha + row * Te;
    const float* dyt = dy + t * dy_st + b * dy_sb;

    // GRU cell: dh', the update-gate and candidate gradients
    for (int j = threadIdx.x; j < D; j += blockDim.x) {
      const float h = hprev[row * D + j];
      const float d = dyt[j] + dm * DH[j];
      const float u = a[j], c = a[2 * D + j];
      hp[j] = h;
      dhn[j] = d;
      ddin[j] = d * (h - c) * u * (1.0f - u);
      ddin[2 * D + j] = d * (1.0f - u) * (1.0f - c * c);
    }
    __syncthreads();

    // drh[k] = sum_j dcand[j] * wg[k, 2D + j]: one warp per row k of wg
    for (int k = warp; k < D; k += nwarps) {
      const float* wk = wg + k * D3 + 2 * D;
      float part = 0.0f;
      for (int j = lane; j < D; j += 32) part = fmaf(ddin[2 * D + j], wk[j], part);
      part = warp_sum(part);
      if (lane == 0) drh[k] = part;
    }
    // attention transform m = h_prev . wa + ba (thread per column)
    for (int j = threadIdx.x; j < D; j += blockDim.x) {
      float acc = 0.0f;
#pragma unroll 8
      for (int k = 0; k < D; ++k) acc = fmaf(hp[k], wa[static_cast<long long>(k) * D + j], acc);
      m[j] = acc + ba[j];
    }
    __syncthreads();

    // reset-gate gradient; d_din is complete
    for (int j = threadIdx.x; j < D; j += blockDim.x) {
      const float r = a[D + j];
      ddin[D + j] = drh[j] * hp[j] * r * (1.0f - r);
    }
    __syncthreads();
    for (int j = threadIdx.x; j < 3 * D; j += blockDim.x) dxw[row * D3 + j] = ddin[j];

    // d_ctx[e] = sum_j d_din[j] * wctx[e, j]: one warp per row e of wctx
    for (int e = warp; e < E; e += nwarps) {
      const float* we = wctx + e * D3;
      float part = 0.0f;
      for (int j = lane; j < 3 * D; j += 32) part = fmaf(ddin[j], we[j], part);
      part = warp_sum(part);
      if (lane == 0) {
        dc[e] = part;
        dctx[row * E + e] = part;
      }
    }
    __syncthreads();

    // dalpha[te] = ev[te, b, :] . d_ctx: one warp per encoder position
    for (int te = warp; te < Te; te += nwarps) {
      const float* evt = ev + te * ev_st + b * ev_sb;
      float part = 0.0f;
      for (int e = lane; e < E; e += 32) part = fmaf(evt[e], dc[e], part);
      part = warp_sum(part);
      if (lane == 0) ds[te] = part;
    }
    __syncthreads();

    // masked softmax backward (warp 0); padded positions have alpha = 0
    if (warp == 0) {
      float dot = 0.0f;
      for (int te = lane; te < Te; te += 32) dot += al[te] * ds[te];
      dot = warp_sum(dot);
      for (int te = lane; te < Te; te += 32) ds[te] = al[te] * (ds[te] - dot);
    }
    __syncthreads();

    // tanh backward per column d, recomputing comb from ep and m
    for (int d = threadIdx.x; d < D; d += blockDim.x) {
      const float md = m[d], vd = v[d];
      float dsum = 0.0f, dvs = 0.0f;
      for (int te = 0; te < Te; ++te) {
        const float cmb = tanhf(ep[te * ep_st + b * ep_sb + d] + md);
        const float dt = (1.0f - cmb * cmb) * ds[te] * vd;
        dep_acc[te * D + d] += dt;
        dsum += dt;
        dvs = fmaf(cmb, ds[te], dvs);
      }
      dmv[d] = dsum;
      dvacc[d] += dvs;
      dm_rows[row * D + d] = dsum;
    }
    __syncthreads();

    // DH[k] = dh'[k] u[k] + drh[k] r[k] + dg . wg[k, :2D] + d_m . wa[k, :] + (1 - dm) DH[k]
    for (int k = warp; k < D; k += nwarps) {
      const float* wgk = wg + k * D3;
      const float* wak = wa + static_cast<long long>(k) * D;
      float part = 0.0f;
      for (int j = lane; j < 2 * D; j += 32) part = fmaf(ddin[j], wgk[j], part);
      for (int j = lane; j < D; j += 32) part = fmaf(dmv[j], wak[j], part);
      part = warp_sum(part);
      if (lane == 0) {
        DH[k] = dhn[k] * a[k] + drh[k] * a[D + k] + part + (1.0f - dm) * DH[k];
      }
    }
    __syncthreads();
  }

  for (int j = threadIdx.x; j < D; j += blockDim.x) {
    dh0[static_cast<long long>(b) * D + j] = DH[j];
    dv_part[static_cast<long long>(b) * D + j] = dvacc[j];
  }
  for (int i = threadIdx.x; i < Te * D; i += blockDim.x) {
    const int te = i / D, d = i % D;
    dep[te * dep_st + b * dep_sb + d] = dep_acc[i];
  }
}

}  // namespace

// dy [Td, B, D], ep [Te, B, D], ev [Te, B, E] and the output dep [Te, B, D]
// are addressed through their time and batch strides (in elements; the last
// dimension is contiguous). dmask [Td, B], the residuals hprev [Td, B, D],
// acts [Td, B, 3D] and alpha [Td, B, Te], the weights wa [D, D], ba [D],
// v [D], wctx [E, 3D], wg [D, 3D], the outputs dxw [Td, B, 3D],
// dctx [Td, B, E], dh0 [B, D], dwa [D, D], dba [D], dv [D] and the scratch
// dm_rows [Td, B, D] and dv_part [B, D] are contiguous. Launches the
// reversed-time recurrence and then the dWa / dba / dv reductions on
// `stream`; returns cudaGetLastError().
extern "C" int attention_gru_bwd(const void* dy, long long dy_st, long long dy_sb,
                                 const void* ep, long long ep_st, long long ep_sb,
                                 const void* ev, long long ev_st, long long ev_sb,
                                 const void* dmask, const void* hprev, const void* acts,
                                 const void* alpha,
                                 const void* wa, const void* ba, const void* v,
                                 const void* wctx, const void* wg,
                                 void* dxw, void* dctx, void* dh0,
                                 void* dep, long long dep_st, long long dep_sb,
                                 void* dwa, void* dba, void* dv,
                                 void* dm_rows, void* dv_part,
                                 int Td, int B, int Te, int D, int E, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (static_cast<size_t>(Te) * D + 10 * static_cast<size_t>(D) + E + Te)
                      * sizeof(float);
  cudaError_t err = allow_smem(attention_gru_bwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B > 0 && D > 0) {
    attention_gru_bwd_kernel<<<B, kThreads, smem, st>>>(
        static_cast<const float*>(dy), dy_st, dy_sb,
        static_cast<const float*>(ep), ep_st, ep_sb,
        static_cast<const float*>(ev), ev_st, ev_sb,
        static_cast<const float*>(dmask), static_cast<const float*>(hprev),
        static_cast<const float*>(acts), static_cast<const float*>(alpha),
        static_cast<const float*>(wa), static_cast<const float*>(ba),
        static_cast<const float*>(v), static_cast<const float*>(wctx),
        static_cast<const float*>(wg),
        static_cast<float*>(dxw), static_cast<float*>(dctx), static_cast<float*>(dh0),
        static_cast<float*>(dep), dep_st, dep_sb,
        static_cast<float*>(dm_rows), static_cast<float*>(dv_part),
        Td, B, Te, D, E);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const float* hp = static_cast<const float*>(hprev);
  const float* dmr = static_cast<const float*>(dm_rows);
  const int N = Td * B;
  // dWa = h_prev^T . d_m; dba = column sums of d_m; dv = column sums of the partials
  err = atb(hp, D, nullptr, 0, dmr, D, static_cast<float*>(dwa), D, N, D, D, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = atb(nullptr, 0, nullptr, 0, dmr, D, static_cast<float*>(dba), D, N, 1, D, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(atb(nullptr, 0, nullptr, 0, static_cast<const float*>(dv_part), D,
                              static_cast<float*>(dv), D, B, 1, D, st));
}
