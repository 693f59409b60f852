// attention_gru_fwd.cuh — the fused attention-GRU decoder loop as one
// persistent, weight-stationary launch: the body of kernel 4
// (attention_gru_fwd.cu, the inference form: serving's decode step at
// Td = 1, and the decoder route without gradients) and of kernel 5
// (attention_gru_fwd_train.cu, which also saves the residuals its backward
// reads). One template, kResiduals, is the only difference.
//
// Per decoder step t, for every batch row b, from h = h0:
//   m     = h . wa + ba                                   [B, D]
//   s_te  = sum_d tanh(ep[te, b, d] + m[b, d]) * v[d]     [Te], -1e30 where em = 0
//   alpha = softmax over Te of s, then 0 where em = 0     (an all-masked row gives 0)
//   ctx   = sum_te alpha_te * ev[te, b, :]                [B, E]
//   din   = ctx . wctx + xw[t]                            [B, 3D]
//   h'    = GRU(h, din) with wg = [update | reset | candidate]
//   ys[t] = h' (raw);   carry h = dm * h' + (1 - dm) * h   (dm = dmask[t, b])
// Residuals per step (kResiduals): hprev = h [Td, B, D], acts = [u | r | c]
// [Td, B, 3D], alpha [Td, B, Te], ctx [Td, B, E], and m [Td, B, D].
//
// What bounds it on an H100: its float32 operations (Td (8 B D^2 + 6 B D E
// + 4 B Te D + 2 B Te E): 11 GFLOP at Td = Te = 32, B = 64, D = 512,
// E = 1024, 0.16 ms at 67 TFLOP/s) over its bytes (about 30 MB). At
// Td = 1 (serving) the bytes bound it: about 24 MB (the encoder rows and
// the weights), some 7 us. The time loop is sequential, and every step
// needs all B rows of the previous one.
//
// What the design does about that: one persistent block on each SM (a
// cooperative launch), each owning a slice of the output columns: unit
// group g (hidden units 4g .. 4g+3) is the columns of those units in wa,
// in the update, reset and candidate blocks of wg and in the three blocks
// of wctx, 80 KB at D = 512, E = 1024, held in shared memory for the whole
// launch, so the weights are read from device memory once a launch (the
// first design of both kernels read all 10.5 MB from L2 for every row at
// every step). Each step's products cover all B rows at once ([B, K] x
// [K, 12 or 4]; the TPU kernel's own form, there with bb = 64 rows), in
// float32 FMA. Four phases a step, separated by grid barriers; the vectors
// every block needs (h, m, ctx, r*h) pass through L2:
//   A  m = h . wa + ba and h . wg[:, :2D] for the block's units;
//   B  the attention of each row, (row, part of E) items over the blocks
//      (the scores of a row are computed by each of its parts);
//   C  din = ctx . wctx + xw, then u, r and r*h for the block's units;
//   D  the candidate, the blend, ys and the masked carry.
// With residuals h, m and ctx pass in their residual buffers, one row of
// steps each. Without, in [B, *] scratch the wrapper allocates, one
// buffer each: every buffer's readers in a step are done a barrier
// before its writer of the next step (h: read in A, written in D; m:
// written in A, read in B; ctx: B, C; r*h: C, D), so no buffer needs a
// second copy. The first step reads h0 itself. Every sum runs in a fixed
// order; two launches give the same bits.
//
// bf16 instance of kernel 5 (attention_gru_fwd_train_bf16; the storage type
// S is a template parameter), the Pallas kernel's bf16 contract
// (pallas_attention_gru.py _fwd_kernel): ep, ev, xw, the masks, h0 and the
// weights are bf16, widened on load (the weights into the same float32
// slices); the scores, the softmax, ctx's sums and the carry are float32;
// the vectors that pass between blocks are the products' operands rounded
// to bf16 (h in hprev, ctx in ctxs, r * h in rhbuf), exactly the residuals
// Pallas stores; ys, hprev, acts, alpha and ctxs are stored bf16, m stays
// float32. Kernel 4 has no bf16 instance (serving computes in float32).
#pragma once

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

// With kResiduals, hprev, acts, alpha, ctxs and m_all are the residuals
// ([Td, B, *]). Without, acts and alpha are unused and hprev (the carry),
// ctxs and m_all are [B, *] scratch. rhbuf [B, D] is scratch either way.
template <bool kResiduals, typename S>
__global__ void __launch_bounds__(kThreads, 1)
attention_gru_fwd_kernel(const S* __restrict__ ep, long long ep_st, long long ep_sb,
                         const S* __restrict__ ev, long long ev_st, long long ev_sb,
                         const S* __restrict__ em, long long em_st, long long em_sb,
                         const S* __restrict__ xw, const S* __restrict__ dmask,
                         const S* __restrict__ h0,
                         const S* __restrict__ wa, const S* __restrict__ ba,
                         const S* __restrict__ v, const S* __restrict__ wctx,
                         const S* __restrict__ wg, S* ys,
                         S* hprev, S* acts, S* alpha, S* ctxs,
                         float* m_all, S* rhbuf, unsigned* counter,
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

  // the block's weight slices, loaded once by asynchronous copies (all of
  // a thread's in flight at once: at Td = 1 this load is a large share of
  // the launch); columns past D are 0
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
      if (j >= D) {
        WA[i] = 0.0f;
      } else {
        stage_f32(WA + i, q == 0 ? wa + static_cast<long long>(k) * D + j
                                 : wg + k * D3 + (q - 1) * D + j);
      }
    }
    for (int i = tid; i < 12 * E; i += kThreads) {
      const int k = i / 12, c = i % 12, j = j0 + c % 4;
      if (j >= D) {
        WC[i] = 0.0f;
      } else {
        stage_f32(WC + i, wctx + k * D3 + (c / 4) * D + j);
      }
    }
    for (int i = tid; i < 4 * D; i += kThreads) {
      const int k = i / 4, j = j0 + i % 4;
      if (j >= D) {
        WD[i] = 0.0f;
      } else {
        stage_f32(WD + i, wg + k * D3 + 2 * D + j);
      }
    }
    for (int i = tid; i < 4 * B; i += kThreads) {
      const int b = i / 4, j = j0 + i % 4;
      if (j >= D) continue;
      const float h = to_f32(h0[static_cast<long long>(b) * D + j]);
      hown[i] = h;
      if constexpr (kResiduals) stcg_as(hprev + static_cast<long long>(b) * D + j, h);
    }
  }
  for (int d = tid; d < D; d += kThreads) v_s[d] = to_f32(v[d]);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  for (int t = 0; t < Td; ++t) {
    const long long tB = static_cast<long long>(t) * B;
    // the first row of this step in the buffers that pass h, m and ctx
    const long long tS = kResiduals ? tB : 0;
    // the carry every block reads: h0 at t = 0 (an input), else hprev
    const S* hcur = t == 0 ? h0 : hprev + tS * D;

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
        if (j < D) __stcg(m_all + (tS + b) * D + j, sA[b * 12 + i % 4] + to_f32(ba[j]));
      }
    }
    bar.sync();

    // B: scores, masked softmax and ctx, one (row, part of E) item at a time
    for (int item = blockIdx.x; item < B * parts; item += nblk) {
      const int b = item / parts, p = item % parts;
      const long long row = tB + b;
      const long long srow = tS + b;
      for (int d = tid; d < D; d += kThreads) m_s[d] = __ldcg(m_all + srow * D + d);
      __syncthreads();
      warp_dots<4>(s_s, ep + b * ep_sb, ep_st, Te, D,
                [&](float x, int d) { return tanhf(x + m_s[d]) * v_s[d]; });
      __syncthreads();
      for (int te = tid; te < Te; te += kThreads) {
        if (!(to_f32(em[te * em_st + b * em_sb]) > 0.0f)) s_s[te] = -1e30f;
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
          s_s[te] = to_f32(em[te * em_st + b * em_sb]) > 0.0f ? s_s[te] / sum : 0.0f;
          if constexpr (kResiduals) {
            if (p == 0) alpha[row * Te + te] = from_f32<S>(s_s[te]);
          }
        }
      }
      __syncthreads();
      const int e1 = min(E, (p + 1) * plen);
      for (int e = p * plen + tid; e < e1; e += kThreads) {
        const S* evb = ev + b * ev_sb + e;
        float acc = 0.0f;
        int te = 0;
        for (; te + 8 <= Te; te += 8) {          // eight loads in flight
          float x[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) x[u] = to_f32(evb[(te + u) * ev_st]);
#pragma unroll
          for (int u = 0; u < 8; ++u) acc = fmaf(s_s[te + u], x[u], acc);
        }
        for (; te < Te; ++te) acc = fmaf(s_s[te], to_f32(evb[te * ev_st]), acc);
        stcg_as(ctxs + srow * E + e, acc);
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
      block_product<12>(sC, 12, B, ctxs + tS * E, E, E, WC);
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
        const S* xr = xw + row * D3;
        const float u = sigmoid_f32(sC[b * 12 + jl] + to_f32(xr[j]) + sA[b * 12 + 4 + jl]);
        const float r =
            sigmoid_f32(sC[b * 12 + 4 + jl] + to_f32(xr[D + j]) + sA[b * 12 + 8 + jl]);
        if constexpr (kResiduals) {
          acts[row * D3 + j] = from_f32<S>(u);
          acts[row * D3 + D + j] = from_f32<S>(r);
        }
        stcg_as(rhbuf + static_cast<long long>(b) * D + j, r * hown[i]);
        sC[b * 12 + jl] = u;
        sC[b * 12 + 8 + jl] += to_f32(xr[2 * D + j]);
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
    // the carry of the next step: its residual row, or the one carry buffer
    S* hnext = hprev + (kResiduals ? tB + B : 0) * D;
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
        const float dm = to_f32(dmask[row]);
        const float c = tanhf(sC[b * 12 + 8 + jl] + sD[i]);
        const float u = sC[b * 12 + jl];
        const float hp = hown[i];
        const float hn = u * hp + (1.0f - u) * c;
        if constexpr (kResiduals) acts[row * D3 + 2 * D + j] = from_f32<S>(c);
        ys[row * D + j] = from_f32<S>(hn);
        const float h = dm * hn + (1.0f - dm) * hp;
        hown[i] = h;
        if (t + 1 < Td) stcg_as(hnext + static_cast<long long>(b) * D + j, h);
      }
    }
    if (t + 1 < Td) bar.sync();
  }
}

// Launch the kernel on the grid of make_plan (cooperatively), after
// zeroing the barrier's counter. Returns the first error: a shape whose
// shared memory passes kSmemLimit, the opt-in's, or the launch's
// (cudaErrorCooperativeLaunchTooLarge when the card cannot hold the grid).
// Td = 0 launches the grid all the same: it loads the weight slices and
// ends (the slice load timed alone).
template <bool kResiduals, typename S = float>
inline int launch_fwd(const void* ep, long long ep_st, long long ep_sb,
                      const void* ev, long long ev_st, long long ev_sb,
                      const void* em, long long em_st, long long em_sb,
                      const void* xw, const void* dmask, const void* h0,
                      const void* wa, const void* ba, const void* v,
                      const void* wctx, const void* wg, void* ys,
                      void* hprev, void* acts, void* alpha, void* ctxs,
                      void* m_all, void* rhbuf, void* counter,
                      int Td, int B, int Te, int D, int E, int num_sms, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Plan p = make_plan(B, D, E, num_sms, false);
  const size_t smem = fwd_smem_floats(B, Te, D, E, p.gpb) * sizeof(float);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(counter, 0, sizeof(unsigned), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_cooperative(
      attention_gru_fwd_kernel<kResiduals, S>, p.blocks, smem, st,
      static_cast<const S*>(ep), ep_st, ep_sb,
      static_cast<const S*>(ev), ev_st, ev_sb,
      static_cast<const S*>(em), em_st, em_sb,
      static_cast<const S*>(xw), static_cast<const S*>(dmask),
      static_cast<const S*>(h0),
      static_cast<const S*>(wa), static_cast<const S*>(ba),
      static_cast<const S*>(v), static_cast<const S*>(wctx),
      static_cast<const S*>(wg), static_cast<S*>(ys),
      static_cast<S*>(hprev), static_cast<S*>(acts),
      static_cast<S*>(alpha), static_cast<S*>(ctxs),
      static_cast<float*>(m_all), static_cast<S*>(rhbuf), static_cast<unsigned*>(counter),
      Td, B, Te, D, E, p.gpb, p.parts, p.plen);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
