// attention_gru_fwd_train — the fused attention-GRU decoder loop over a
// whole target sequence in one launch, saving the residuals its backward
// reads.
//
// Replaces: paddle_tpu/ops/pallas_attention_gru.py _fwd_kernel with
// residuals (the custom-VJP forward of fused_attention_gru, launched by
// pl.pallas_call in _run_fwd, one launch per training step).
//
// Per decoder step t, for every batch row b, from h = h0:
//   m     = h . wa + ba                                   [B, D]
//   s_te  = sum_d tanh(ep[te, b, d] + m[b, d]) * v[d]     [Te], -1e30 where em = 0
//   alpha = softmax over Te of s, then 0 where em = 0     (an all-masked row gives 0)
//   ctx   = sum_te alpha_te * ev[te, b, :]                [B, E]
//   din   = ctx . wctx + xw[t]                            [B, 3D]
//   h'    = GRU(h, din) with wg = [update | reset | candidate]
//   ys[t] = h' (raw);   carry h = dm * h' + (1 - dm) * h   (dm = dmask[t, b])
// Residuals per step: hprev = h [Td, B, D], acts = [u | r | c] [Td, B, 3D],
// alpha [Td, B, Te], ctx [Td, B, E], and m [Td, B, D] for the backward.
//
// What bounds it on an H100: its float32 operations (Td (8 B D^2 + 6 B D E
// + 4 B Te D + 2 B Te E): 11 GFLOP at Td = Te = 32, B = 64, D = 512,
// E = 1024, 0.16 ms at 67 TFLOP/s) over its bytes (about 30 MB). The time
// loop is sequential, and every step needs all B rows of the previous one.
//
// What the design does about that: one persistent block on each SM (a
// cooperative launch), each owning a slice of the output columns: unit
// group g (hidden units 4g .. 4g+3) is the columns of those units in wa,
// in the update, reset and candidate blocks of wg and in the three blocks
// of wctx, 80 KB at D = 512, E = 1024, held in shared memory for the whole
// launch, so the weights are read from device memory once a launch (the
// first design read all 10.5 MB from L2 for every row at every step). Each
// step's products cover all B rows at once ([B, K] x [K, 12 or 4]; the TPU
// kernel's own form, there with bb = 64 rows), in float32 FMA. Four phases
// a step, separated by grid barriers; the vectors every block needs (h, m,
// ctx, r*h) pass through L2, in their residual buffers but r*h:
//   A  m = h . wa + ba and h . wg[:, :2D] for the block's units;
//   B  the attention of each row, (row, part of E) items over the blocks
//      (the scores of a row are computed by each of its parts);
//   C  din = ctx . wctx + xw, then u, r and r*h for the block's units;
//   D  the candidate, the blend, ys and the masked carry.
// Every sum runs in a fixed order; two launches give the same bits.

#include "common.cuh"
#include "persistent_grid.cuh"

namespace {

using namespace pgrid;

// The shared memory of a block, in floats: per unit group the weight
// slices WA [D][12] (wa | wg update | wg reset columns), WC [E][12] (the
// three wctx columns) and WD [D][4] (wg candidate columns), and the state
// sA [B][12] (m | h.wg_u | h.wg_r), sC [B][12] (din, then u and din_c),
// sD [B][4] and the owned carry hown [B][4]; then v [D], one row of m [D]
// and the scores [Te].
inline size_t fwd_smem_floats(int B, int Te, int D, int E, int gpb) {
  return static_cast<size_t>(gpb) * (16LL * D + 12LL * E + 32LL * B) + 2LL * D + Te;
}

__global__ void __launch_bounds__(kThreads, 1)
attention_gru_fwd_train_kernel(const float* __restrict__ ep, long long ep_st, long long ep_sb,
                               const float* __restrict__ ev, long long ev_st, long long ev_sb,
                               const float* __restrict__ em, long long em_st, long long em_sb,
                               const float* __restrict__ xw, const float* __restrict__ dmask,
                               const float* __restrict__ h0,
                               const float* __restrict__ wa, const float* __restrict__ ba,
                               const float* __restrict__ v, const float* __restrict__ wctx,
                               const float* __restrict__ wg, float* ys,
                               float* hprev, float* acts, float* alpha, float* ctxs,
                               float* m_all, float* rhbuf, unsigned* counter,
                               int Td, int B, int Te, int D, int E, int gpb, int parts,
                               int plen) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nblk = gridDim.x;
  const int groups = (D + kUnits - 1) / kUnits;
  const long long D3 = 3LL * D;
  const size_t per_group = 16LL * D + 12LL * E + 32LL * B;
  float* v_s = smem + gpb * per_group;
  float* m_s = v_s + D;
  float* s_s = m_s + D;
  GridBarrier bar{counter, 0};

  // the block's weight slices, loaded once; columns past D are 0
  for (int gl = 0; gl < gpb; ++gl) {
    const int g = blockIdx.x + gl * nblk;
    if (g >= groups) break;
    float* WA = smem + gl * per_group;
    float* WC = WA + 12LL * D;
    float* WD = WC + 12LL * E;
    float* hown = WD + 4LL * D + 28LL * B;
    const int j0 = kUnits * g;
    for (int i = tid; i < 12 * D; i += kThreads) {
      const int k = i / 12, c = i % 12, q = c / 4, j = j0 + c % 4;
      WA[i] = j >= D ? 0.0f
              : q == 0 ? wa[static_cast<long long>(k) * D + j]
                       : wg[k * D3 + (q - 1) * D + j];
    }
    for (int i = tid; i < 12 * E; i += kThreads) {
      const int k = i / 12, c = i % 12, j = j0 + c % 4;
      WC[i] = j < D ? wctx[k * D3 + (c / 4) * D + j] : 0.0f;
    }
    for (int i = tid; i < 4 * D; i += kThreads) {
      const int k = i / 4, j = j0 + i % 4;
      WD[i] = j < D ? wg[k * D3 + 2 * D + j] : 0.0f;
    }
    for (int i = tid; i < 4 * B; i += kThreads) {
      const int b = i / 4, j = j0 + i % 4;
      if (j >= D) continue;
      const float h = h0[static_cast<long long>(b) * D + j];
      hown[i] = h;
      __stcg(hprev + static_cast<long long>(b) * D + j, h);
    }
  }
  for (int d = tid; d < D; d += kThreads) v_s[d] = v[d];
  __syncthreads();

  for (int t = 0; t < Td; ++t) {
    const long long tB = static_cast<long long>(t) * B;
    // the carry every block reads: h0 at t = 0 (an input), else hprev[t]
    const float* hcur = t == 0 ? h0 : hprev + tB * D;

    // A: m = h . wa + ba and the gate products h . wg[:, :2D]
    for (int gl = 0; gl < gpb; ++gl) {
      const int g = blockIdx.x + gl * nblk;
      if (g >= groups) break;
      float* WA = smem + gl * per_group;
      float* sA = WA + 16LL * D + 12LL * E;
      block_product<12>(sA, 12, B, hcur, D, D, WA);
    }
    __syncthreads();
    for (int gl = 0; gl < gpb; ++gl) {
      const int g = blockIdx.x + gl * nblk;
      if (g >= groups) break;
      const float* sA = smem + gl * per_group + 16LL * D + 12LL * E;
      for (int i = tid; i < 4 * B; i += kThreads) {
        const int b = i / 4, j = kUnits * g + i % 4;
        if (j < D) __stcg(m_all + (tB + b) * D + j, sA[b * 12 + i % 4] + ba[j]);
      }
    }
    bar.sync();

    // B: scores, masked softmax and ctx, one (row, part of E) item at a time
    for (int item = blockIdx.x; item < B * parts; item += nblk) {
      const int b = item / parts, p = item % parts;
      const long long row = tB + b;
      for (int d = tid; d < D; d += kThreads) m_s[d] = __ldcg(m_all + row * D + d);
      __syncthreads();
      warp_dots<4>(s_s, ep + b * ep_sb, ep_st, Te, D,
                [&](float x, int d) { return tanhf(x + m_s[d]) * v_s[d]; });
      __syncthreads();
      for (int te = tid; te < Te; te += kThreads) {
        if (!(em[te * em_st + b * em_sb] > 0.0f)) s_s[te] = -1e30f;
      }
      __syncthreads();
      // with every position masked the scores are all -1e30, exp gives
      // 1/Te each, and the mask zeroes them: alpha = 0, ctx = 0
      if (warp == 0) {
        float mx = -3.0e38f;
        for (int te = lane; te < Te; te += 32) mx = fmaxf(mx, s_s[te]);
        mx = warp_max(mx);
        float sum = 0.0f;
        for (int te = lane; te < Te; te += 32) {
          const float e = expf(s_s[te] - mx);
          s_s[te] = e;
          sum += e;
        }
        sum = warp_sum(sum);
        for (int te = lane; te < Te; te += 32) {
          s_s[te] = em[te * em_st + b * em_sb] > 0.0f ? s_s[te] / sum : 0.0f;
          if (p == 0) alpha[row * Te + te] = s_s[te];
        }
      }
      __syncthreads();
      const int e1 = min(E, (p + 1) * plen);
      for (int e = p * plen + tid; e < e1; e += kThreads) {
        const float* evb = ev + b * ev_sb + e;
        float acc = 0.0f;
        int te = 0;
        for (; te + 8 <= Te; te += 8) {          // eight loads in flight
          float x[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) x[u] = evb[(te + u) * ev_st];
#pragma unroll
          for (int u = 0; u < 8; ++u) acc = fmaf(s_s[te + u], x[u], acc);
        }
        for (; te < Te; ++te) acc = fmaf(s_s[te], evb[te * ev_st], acc);
        __stcg(ctxs + row * E + e, acc);
      }
      __syncthreads();
    }
    bar.sync();

    // C: din = ctx . wctx + xw, then u, r and r * h
    for (int gl = 0; gl < gpb; ++gl) {
      const int g = blockIdx.x + gl * nblk;
      if (g >= groups) break;
      float* WC = smem + gl * per_group + 12LL * D;
      float* sC = WC + 4LL * D + 12LL * E + 12LL * B;
      block_product<12>(sC, 12, B, ctxs + tB * E, E, E, WC);
    }
    __syncthreads();
    for (int gl = 0; gl < gpb; ++gl) {
      const int g = blockIdx.x + gl * nblk;
      if (g >= groups) break;
      const float* sA = smem + gl * per_group + 16LL * D + 12LL * E;
      float* sC = const_cast<float*>(sA) + 12LL * B;
      const float* hown = sC + 16LL * B;
      for (int i = tid; i < 4 * B; i += kThreads) {
        const int b = i / 4, jl = i % 4, j = kUnits * g + jl;
        if (j >= D) continue;
        const long long row = tB + b;
        const float* xr = xw + row * D3;
        const float u = sigmoid_f32(sC[b * 12 + jl] + xr[j] + sA[b * 12 + 4 + jl]);
        const float r = sigmoid_f32(sC[b * 12 + 4 + jl] + xr[D + j] + sA[b * 12 + 8 + jl]);
        acts[row * D3 + j] = u;
        acts[row * D3 + D + j] = r;
        __stcg(rhbuf + static_cast<long long>(b) * D + j, r * hown[i]);
        sC[b * 12 + jl] = u;
        sC[b * 12 + 8 + jl] += xr[2 * D + j];
      }
    }
    bar.sync();

    // D: the candidate, the blend, the raw output and the masked carry
    for (int gl = 0; gl < gpb; ++gl) {
      const int g = blockIdx.x + gl * nblk;
      if (g >= groups) break;
      float* WD = smem + gl * per_group + 12LL * D + 12LL * E;
      float* sD = WD + 4LL * D + 24LL * B;
      block_product<4>(sD, 4, B, rhbuf, D, D, WD);
    }
    __syncthreads();
    for (int gl = 0; gl < gpb; ++gl) {
      const int g = blockIdx.x + gl * nblk;
      if (g >= groups) break;
      const float* sC = smem + gl * per_group + 16LL * D + 12LL * E + 12LL * B;
      const float* sD = sC + 12LL * B;
      float* hown = const_cast<float*>(sD) + 4LL * B;
      for (int i = tid; i < 4 * B; i += kThreads) {
        const int b = i / 4, jl = i % 4, j = kUnits * g + jl;
        if (j >= D) continue;
        const long long row = tB + b;
        const float dm = dmask[row];
        const float c = tanhf(sC[b * 12 + 8 + jl] + sD[i]);
        const float u = sC[b * 12 + jl];
        const float hp = hown[i];
        const float hn = u * hp + (1.0f - u) * c;
        acts[row * D3 + 2 * D + j] = c;
        ys[row * D + j] = hn;
        const float h = dm * hn + (1.0f - dm) * hp;
        hown[i] = h;
        if (t + 1 < Td) __stcg(hprev + (row + B) * D + j, h);
      }
    }
    if (t + 1 < Td) bar.sync();
  }
}

// Measures the grid barrier alone: `iters` barriers over `blocks` blocks
// holding `smem` bytes each (so that they sit one to an SM, as the
// attention-GRU kernels do).
__global__ void __launch_bounds__(kThreads, 1) grid_barrier_bench_kernel(unsigned* counter,
                                                                        int iters) {
  GridBarrier bar{counter, 0};
  for (int i = 0; i < iters; ++i) bar.sync();
}

}  // namespace

// ep [Te, B, D], ev [Te, B, E] and em [Te, B] are addressed through their
// time and batch strides (in elements; the last dimension is contiguous).
// xw [Td, B, 3D], dmask [Td, B], h0 [B, D], wa [D, D], ba [D], v [D],
// wctx [E, 3D], wg [D, 3D], the outputs ys [Td, B, D], hprev [Td, B, D],
// acts [Td, B, 3D], alpha [Td, B, Te], ctxs [Td, B, E], m_all [Td, B, D]
// and the scratch rhbuf [B, D] are contiguous; counter is one unsigned of
// scratch.
// num_sms is the card's SM count. Launches on `stream` (cooperatively);
// returns the launch's error, cudaErrorCooperativeLaunchTooLarge or the
// shared-memory opt-in's error for a shape the grid cannot hold.
extern "C" int attention_gru_fwd_train(const void* ep, long long ep_st, long long ep_sb,
                                       const void* ev, long long ev_st, long long ev_sb,
                                       const void* em, long long em_st, long long em_sb,
                                       const void* xw, const void* dmask, const void* h0,
                                       const void* wa, const void* ba, const void* v,
                                       const void* wctx, const void* wg, void* ys,
                                       void* hprev, void* acts, void* alpha, void* ctxs,
                                       void* m_all, void* rhbuf, void* counter,
                                       int Td, int B, int Te, int D, int E, int num_sms,
                                       void* stream) {
  if (Td <= 0 || B <= 0 || Te <= 0 || D <= 0 || E <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Plan p = make_plan(B, D, E, num_sms, false);
  const size_t smem = fwd_smem_floats(B, Te, D, E, p.gpb) * sizeof(float);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(counter, 0, sizeof(unsigned), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_cooperative(
      attention_gru_fwd_train_kernel, p.blocks, smem, st,
      static_cast<const float*>(ep), ep_st, ep_sb,
      static_cast<const float*>(ev), ev_st, ev_sb,
      static_cast<const float*>(em), em_st, em_sb,
      static_cast<const float*>(xw), static_cast<const float*>(dmask),
      static_cast<const float*>(h0),
      static_cast<const float*>(wa), static_cast<const float*>(ba),
      static_cast<const float*>(v), static_cast<const float*>(wctx),
      static_cast<const float*>(wg), static_cast<float*>(ys),
      static_cast<float*>(hprev), static_cast<float*>(acts),
      static_cast<float*>(alpha), static_cast<float*>(ctxs),
      static_cast<float*>(m_all), static_cast<float*>(rhbuf), static_cast<unsigned*>(counter),
      Td, B, Te, D, E, p.gpb, p.parts, p.plen);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// `iters` grid barriers of `blocks` blocks with `smem` bytes of shared
// memory each, cooperatively on `stream` (counter: one unsigned of scratch).
extern "C" int grid_barrier_bench(void* counter, int iters, int blocks, int smem,
                                  void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(counter, 0, sizeof(unsigned), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_cooperative(grid_barrier_bench_kernel, blocks, static_cast<size_t>(smem), st,
                           static_cast<unsigned*>(counter), iters);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
