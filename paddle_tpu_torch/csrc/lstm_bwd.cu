// lstm_bwd — the backward of the masked peephole LSTM scan: dx4, dW and
// dpeep from the residuals of lstm_fwd_train, in one launch.
//
// Replaces: paddle_tpu/ops/pallas_lstm.py _bwd_kernel (launched by
// pl.pallas_call in _run_bwd, the custom-VJP backward of fused_lstm), which
// walks time backwards carrying dh and dc in VMEM and accumulates dW and
// dpeep there.
//
// Per step, walked in the opposite order of the forward (t = T-1 .. 0, or
// 0 .. T-1 for a reversed sequence), with DH and DC the gradients carried
// into the step's carries, m = mask[t, b], (a, i, f, o) = acts[t] and
// c = cprev[t] the residuals:
//   c'   = f c + i a   (recomputed)          s = act_state(c')
//   dh   = m (DH + dy[t])                    (a padded step passes DH, DC on)
//   dgo  = dh s act_gate'(o)
//   dc'  = dh o act_state'(s) + m DC + dgo po
//   dgi  = dc' a act_gate'(i)    dgf = dc' c act_gate'(f)    dga = dc' i act_in'(a)
//   dx4[t] = [dga | dgi | dgf | dgo]
//   DH   = dx4[t] . w^T + (1 - m) DH
//   DC   = dc' f + dgi pi + dgf pf + (1 - m) DC
// with every derivative taken from the saved post-activation value, and
// over every row n = (t, b):
//   dW = hprev^T . dx4        dpeep = [sum dgi c | sum dgf c | sum dgo c']
//
// What bounds it on an H100: at T = 64, B = 256, H = 512 the function moves
// about 0.5 GB (dy, the residuals, w, dx4, dW), some 0.15 ms at 3.35 TB/s,
// and does 69.1 GFLOP (kernel_flops.lstm_bwd_flops: the recurrent product
// with w^T and the dW product), 1.03 ms at the 67 TFLOP/s float32 rate.
// The reversed time loop is sequential, and every step needs all 4H
// gradient columns of its rows from the step after.
//
// What the design does about that: a persistent, cooperative grid
// (persistent_grid.cuh), in P row groups of G blocks, one block on each SM
// (fused_lstm.grid_plan chooses P and mirrors the plan). Batch rows are
// independent in this recurrence, so row group p owns rows
// [p R, (p + 1) R) and waits only on its own blocks (a barrier counter of
// its own); within a group, block q owns gpb unit groups of 4 hidden units,
// contiguous, processed in bundles of N = 4 or 8 units. DH = dx4[t] . w^T
// takes w transposed, so a block keeps w's ROWS k of its units, all 4H
// columns ([4H][N] a bundle, 64 KB at N = 8, H = 512), in shared memory
// for the whole launch: no transposed copy of w is made. One barrier a
// step:
//   1  for the owned units and rows: c', dh, the four gate gradients into
//      dx4[t]'s owned columns (through L2), DC in shared memory, and the
//      peephole sums (one accumulator a thread, in shared memory);
//   2  DH[:, k] = dx4[t] . w[k, :]^T + (1 - m) DH for the owned units,
//      reading the group's rows of dx4[t] once for all N units, staged
//      through shared memory by cp.async a chunk ahead (a 64 KB ring),
//      and in the same pass dW[k, :] += hprev[t, :, k]^T . dx4[t]
//      (product_colsum_staged):
//      dW costs no second pass over dx4 and no separate launch, as the TPU
//      kernel accumulates dW in VMEM.
// DH stays in the owner's shared memory, where the next step's phase 1
// reads it on the same block: no barrier between them; the next step
// writes dx4 at another time index, so no buffer is reused while a block
// may still read it. With P row groups a block reads R = B / P rows of
// dx4[t] a step (1 MB at P = 2 on the classifier's shape, against 2 MB
// at P = 1) and its dW rows are partial sums over its group's rows: after
// one barrier over the whole grid the owner in group 0 adds the other
// groups' partials in group order and writes dW and dpeep once. Where a
// block's rows of w or dW do not fit in shared memory beside the state of
// its rows (wide H, many rows), they are kept in device memory that the
// block alone reads and writes, in the same layout. Every sum runs in a
// fixed order and nothing is summed by atomics: two launches give the
// same bits. Two activation triples are template parameters: the kernel
// wrapper's default (tanh, sigmoid, sigmoid) and the config DSL's
// lstmemory default (tanh, sigmoid, tanh), which the LSTM classifier runs;
// the other triples read their codes at run time, some 4% slower on an
// H100 at the classifier's shape (three instances per bundle width
// instead of 64).
//
// The bf16 instance (lstm_bwd_bf16; the storage type S is a template
// parameter) keeps the Pallas kernel's bf16 contract (pallas_lstm.py
// _bwd_kernel): dy, acts, hprev, w and peep are bf16, widened on load (w
// into the same float32 rows in shared memory, so the plan and the shared
// memory are the float32 instance's), cprev is float32, and every sum runs
// in float32. Phase 2 needs the gate gradients twice: rounded to bf16 for
// DH = dgates . w^T, unrounded for dW += hprev^T . dgates. So phase 1
// stores dx4[t] in bf16 (the output) and the unrounded values into a
// float32 exchange buffer xch [2][B][4H], by step parity (a block may still
// read step s's rows in its phase 2 while a faster one writes step s + 1's;
// step s + 2 writes after the barrier every block passes only once its
// phase 2 of step s is done), and phase 2 reads xch, rounding the rows for
// the product alone (product_colsum_staged's kRoundX). dW and dpeep are
// summed in float32 in the same fixed order and rounded once to bf16 as
// they are written.

#include "common.cuh"
#include "persistent_grid.cuh"

namespace {

using namespace pgrid;

// Floats of state per batch row and unit: DH, DC and h_prev (the S of the
// dW sums).
constexpr int kState = 3;
// phase 1's items a thread loads at once
constexpr int kBatch = 4;
// product_colsum_staged's columns a thread holds, rows a chunk and ring
// slots, by bundle width: a ring of 64 KB either way. Eight columns a
// thread at N = 8 take one column batch at H = 512 and halve the
// butterfly's share of a step against four (PERF.md, kernel 8's findings).
template <int N>
struct Tile;
template <>
struct Tile<4> {
  static constexpr int kCols = 4, kRows = 8, kStages = 2;
};
template <>
struct Tile<8> {
  static constexpr int kCols = 8, kRows = 4, kStages = 2;
};
template <int N>
constexpr int ring_floats() {
  return Tile<N>::kStages * Tile<N>::kRows * kThreads * Tile<N>::kCols;
}
constexpr int kRingFloats = 16384;                  // the ring's 64 KB
static_assert(ring_floats<4>() <= kRingFloats && ring_floats<8>() <= kRingFloats,
              "a tile's ring fits its 64 KB");

// How the grid is cut (mirrored by paddle_tpu_torch/ops/fused_lstm.py
// grid_plan): P row groups of R = ceil(B / P) rows; in each, G blocks of
// gpb unit groups (4 hidden units each, contiguous), in bundles of N units.
struct BwdPlan {
  int P, G, gpb, N, bundles, R;
};

inline BwdPlan make_bwd_plan(int B, int H, int num_sms, int P) {
  BwdPlan p;
  const int groups = (H + kUnits - 1) / kUnits;
  p.P = P;
  int G = num_sms / P < groups ? num_sms / P : groups;
  if (G < 1) G = 1;
  p.gpb = (groups + G - 1) / G;
  p.G = (groups + p.gpb - 1) / p.gpb;
  p.N = p.gpb >= 2 ? 8 : 4;
  p.bundles = (kUnits * p.gpb + p.N - 1) / p.N;
  p.R = (B + P - 1) / P;
  return p;
}

// The shared memory of a block, in floats: per bundle its rows of w
// ([4H][N], when w_smem), its rows of dW ([4H][N], when dw_smem) and the
// state [3][R][N]; then the cross-warp sums [kWarps][kRowTile][N], the
// peephole accumulators [bundles][3][kThreads] and the ring of dx4 rows.
inline size_t bwd_smem_floats(const BwdPlan& p, int H, bool w_smem, bool dw_smem) {
  const long long slice = 4LL * H * p.N;
  return static_cast<size_t>(p.bundles) * ((w_smem ? slice : 0) + (dw_smem ? slice : 0)
                                           + static_cast<long long>(kState) * p.R * p.N)
         + static_cast<size_t>(kWarps) * kRowTile * p.N + 3LL * kThreads * p.bundles
         + kRingFloats;
}

// kActIn, kActGate, kActState: act_f32 codes, or -1 to read the run-time
// codes act_in, act_gate and act_state. xch: the bf16 instance's exchange
// buffer (null for float).
template <int N, int kActIn, int kActGate, int kActState, typename S>
__global__ void __launch_bounds__(kThreads, 1)
lstm_bwd_kernel(const S* __restrict__ dy, long long dy_st, long long dy_sb,
                const S* __restrict__ acts, const S* __restrict__ hprev,
                const float* __restrict__ cprev,
                const float* __restrict__ mask, long long m_st, long long m_sb,
                const S* __restrict__ w, const S* __restrict__ peep,
                S* dx4, S* __restrict__ dw, S* __restrict__ dpeep,
                float* wslices, float* dwacc, float* dwpart, float* ppart,
                unsigned* counters, unsigned long long* phase_ns, float* xch,
                int T, int B, int H, int reverse, int act_in_rt, int act_gate_rt,
                int act_state_rt, int G, int gpb, int R, int w_smem, int dw_smem) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int act_in = kActIn < 0 ? act_in_rt : kActIn;
  const int act_gate = kActGate < 0 ? act_gate_rt : kActGate;
  const int act_state = kActState < 0 ? act_state_rt : kActState;
  const int tid = threadIdx.x;
  const int P = gridDim.x / G;
  const int p = blockIdx.x / G;                       // row group
  const int row0 = p * R;                             // its first row
  const int rows = max(0, min(B, row0 + R) - row0);   // and how many (0 when B < P R)
  const int u0 = (blockIdx.x % G) * kUnits * gpb;     // the block's first unit
  const int u1 = min(H, u0 + kUnits * gpb);           // and its end
  const int bundles = (kUnits * gpb + N - 1) / N;
  const long long K = 4LL * H;
  const long long slice = K * N;
  const long long state = static_cast<long long>(kState) * R * N;
  const long long per_bundle = (w_smem ? slice : 0) + (dw_smem ? slice : 0) + state;
  float* red = smem + bundles * per_bundle;
  float* ps = red + kWarps * kRowTile * N;            // [bundles][3][kThreads]
  float* ring = ps + 3 * kThreads * bundles;          // the staged rows of dx4[t]
  GridBarrier bar{counters + p, 0, static_cast<unsigned>(G)};
  // block 0's clock at each step's start and phases' ends, when asked
  const bool clocked = phase_ns != nullptr && blockIdx.x == 0 && tid == 0;
  // bundle nb's rows of w and dW ([4H][N]: W[j][c] = w[u0 + N nb + c, j])
  // and its state DH, DC and h_prev, each [R][N]
  auto W = [&](int nb) {
    return w_smem ? smem + nb * per_bundle
                  : wslices + (static_cast<long long>(blockIdx.x) * bundles + nb) * slice;
  };
  auto DW = [&](int nb) {
    return dw_smem ? smem + nb * per_bundle + (w_smem ? slice : 0)
                   : dwacc + (static_cast<long long>(blockIdx.x) * bundles + nb) * slice;
  };
  auto DH = [&](int nb) { return smem + nb * per_bundle + (per_bundle - state); };
  auto DC = [&](int nb) { return DH(nb) + static_cast<long long>(R) * N; };
  auto HP = [&](int nb) { return DH(nb) + 2LL * R * N; };

  // the block's rows of w, zeroed dW rows, state and peephole sums; units
  // past the block's own are 0
  for (int nb = 0; nb < bundles; ++nb) {
    float* wg = W(nb);
    float* dwg = DW(nb);
    for (long long i = tid; i < slice; i += kThreads) {
      const int c = static_cast<int>(i / K), k = u0 + N * nb + c;
      const long long j = i % K;
      if (k >= u1) {
        wg[j * N + c] = 0.0f;
      } else if (w_smem) {
        stage_f32(wg + j * N + c, w + k * K + j);   // all of a thread's in flight at once
      } else {
        wg[j * N + c] = to_f32(w[k * K + j]);
      }
      dwg[j * N + c] = 0.0f;
    }
    float* st = DH(nb);
    for (long long i = tid; i < state; i += kThreads) st[i] = 0.0f;
  }
  for (int i = tid; i < 3 * kThreads * bundles; i += kThreads) ps[i] = 0.0f;
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    if (clocked) phase_ns[3 * s] = global_ns();
    const int t = reverse ? s : T - 1 - s;
    const long long tB = static_cast<long long>(t) * B;
    // the step's gate gradients as phase 2 reads them: dx4[t] itself in
    // float32, the exchange buffer of the step's parity in bf16
    float* dxt;
    if constexpr (IsF32<S>::value) {
      dxt = dx4 + tB * K;
    } else {
      dxt = xch + static_cast<long long>(s & 1) * B * K;
    }

    // 1: the gate gradients of the owned units and rows. Thread tid takes
    //    items tid, tid + 256, ...: always unit c = tid % N (256 % N = 0),
    //    so its peephole sums are one accumulator each. Every operand of a
    //    batch of kBatch items is loaded before any is used, so that their
    //    round trips to device memory overlap.
    for (int nb = 0; nb < bundles; ++nb) {
      float* dhs = DH(nb);
      float* dcs = DC(nb);
      float* hps = HP(nb);
      float* psb = ps + nb * 3 * kThreads;
      for (int i0 = tid; i0 < rows * N; i0 += kThreads * kBatch) {
        bool ok[kBatch];
        float m[kBatch], a[kBatch], ig[kBatch], fg[kBatch], og[kBatch], cp[kBatch],
            hp[kBatch], dyv[kBatch];
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          const int i = i0 + q * kThreads;
          const int k = u0 + N * nb + i % N;
          ok[q] = i < rows * N && k < u1;
          const int b = row0 + (ok[q] ? i / N : 0);
          const long long row = tB + b;
          const int kk = ok[q] ? k : u0;
          const S* ar = acts + row * K + kk;        // [a | i | f | o]
          m[q] = ok[q] ? mask[t * m_st + b * m_sb] : 0.0f;
          a[q] = ok[q] ? to_f32(ar[0]) : 0.0f;
          ig[q] = ok[q] ? to_f32(ar[H]) : 0.0f;
          fg[q] = ok[q] ? to_f32(ar[2 * H]) : 0.0f;
          og[q] = ok[q] ? to_f32(ar[3 * H]) : 0.0f;
          cp[q] = ok[q] ? cprev[row * H + kk] : 0.0f;
          hp[q] = ok[q] ? to_f32(hprev[row * H + kk]) : 0.0f;
          dyv[q] = ok[q] ? to_f32(dy[t * dy_st + b * dy_sb + kk]) : 0.0f;
        }
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          if (!ok[q]) continue;
          const int i = i0 + q * kThreads;
          const int k = u0 + N * nb + i % N;
          const int b = row0 + i / N;
          const float cn = fg[q] * cp[q] + ig[q] * a[q];
          const float sc = act_f32(act_state, cn);
          const float dcv = dcs[i];
          const float dh = m[q] * (dhs[i] + dyv[q]);
          const float dgo = dh * sc * dact_f32(act_gate, og[q]);
          const float dc = dh * og[q] * dact_f32(act_state, sc) + m[q] * dcv
                           + dgo * to_f32(peep[2 * H + k]);
          const float dgi = dc * a[q] * dact_f32(act_gate, ig[q]);
          const float dgf = dc * cp[q] * dact_f32(act_gate, fg[q]);
          const float dga = dc * ig[q] * dact_f32(act_in, a[q]);
          float* dxr = dxt + static_cast<long long>(b) * K + k;
          __stcg(dxr, dga);
          __stcg(dxr + H, dgi);
          __stcg(dxr + 2 * H, dgf);
          __stcg(dxr + 3 * H, dgo);
          if constexpr (!IsF32<S>::value) {        // the output, rounded
            S* out = dx4 + (tB + b) * K + k;
            out[0] = from_f32<S>(dga);
            out[H] = from_f32<S>(dgi);
            out[2 * H] = from_f32<S>(dgf);
            out[3 * H] = from_f32<S>(dgo);
          }
          dcs[i] = dc * fg[q] + dgi * to_f32(peep[k]) + dgf * to_f32(peep[H + k])
                   + (1.0f - m[q]) * dcv;
          hps[i] = hp[q];
          psb[tid] += dgi * cp[q];
          psb[kThreads + tid] += dgf * cp[q];
          psb[2 * kThreads + tid] += dgo * cn;
        }
      }
    }
    bar.sync();                                       // the group's dx4[t] is written
    if (clocked) phase_ns[3 * s + 1] = global_ns();

    // 2: DH = dx4[t] . w[k, :]^T + (1 - m) DH;  dW[k, :] += h_prev^T . dx4[t]
    for (int nb = 0; nb < bundles; ++nb) {
      float* dhs = DH(nb);
      product_colsum_staged<N, Tile<N>::kCols, Tile<N>::kRows, Tile<N>::kStages,
                            !IsF32<S>::value>(
          dxt + static_cast<long long>(row0) * K, K, rows, static_cast<int>(K), W(nb), HP(nb),
          DW(nb), red, ring, [&](int bl, int c, float v) {
            const int i = bl * N + c;
            const float m = mask[t * m_st + (row0 + bl) * m_sb];
            dhs[i] = v + (1.0f - m) * dhs[i];
          });
    }
    if (clocked) phase_ns[3 * s + 2] = global_ns();
  }

  // dpeep: this block's sums for its units, one per unit over the threads
  // that held it, in thread order; with one row group they are the result
  __syncthreads();
  for (int e = tid; e < 3 * bundles * N; e += kThreads) {
    const int g = e / (bundles * N), nb = (e / N) % bundles, c = e % N;
    const int k = u0 + N * nb + c;
    if (k >= u1) continue;
    const float* src = ps + (nb * 3 + g) * kThreads;
    float sum = 0.0f;
    for (int x = c; x < kThreads; x += N) sum += src[x];
    if (P == 1) {
      dpeep[g * H + k] = from_f32<S>(sum);
    } else {
      __stcg(ppart + (static_cast<long long>(p) * 3 + g) * H + k, sum);
    }
  }
  if (P > 1) {
    // the other groups' dW partials, then one barrier over the whole grid
    if (p > 0) {
      for (int nb = 0; nb < bundles; ++nb) {
        const float* dwg = DW(nb);
        float* part = dwpart + (p - 1) * static_cast<long long>(H) * K;
        for (long long i = tid; i < slice; i += kThreads) {
          const int c = static_cast<int>(i / K), k = u0 + N * nb + c;
          const long long j = i % K;
          if (k < u1) __stcg(part + k * K + j, dwg[j * N + c]);
        }
      }
    }
    GridBarrier all{counters + P, 0, static_cast<unsigned>(gridDim.x)};
    all.sync();
    if (p > 0) return;
    for (int e = tid; e < 3 * (u1 - u0); e += kThreads) {
      const int g = e / (u1 - u0), k = u0 + e % (u1 - u0);
      float sum = 0.0f;
      for (int q = 0; q < P; ++q) sum += __ldcg(ppart + (q * 3LL + g) * H + k);
      dpeep[g * H + k] = from_f32<S>(sum);
    }
  }
  // dW: group 0's rows, plus the other groups' in group order, written once
  for (int nb = 0; nb < bundles; ++nb) {
    const float* dwg = DW(nb);
    for (long long i = tid; i < slice; i += kThreads) {
      const int c = static_cast<int>(i / K), k = u0 + N * nb + c;
      const long long j = i % K;
      if (k >= u1) continue;
      float v = dwg[j * N + c];
      for (int q = 1; q < P; ++q)
        v += __ldcg(dwpart + (q - 1) * static_cast<long long>(H) * K + k * K + j);
      dw[k * K + j] = from_f32<S>(v);
    }
  }
}

template <int N, int kActIn, int kActGate, int kActState, typename S>
cudaError_t launch(const BwdPlan& plan, size_t smem, const S* dy, long long dy_st,
                   long long dy_sb, const S* acts, const S* hprev, const float* cprev,
                   const float* mask, long long m_st, long long m_sb, const S* w,
                   const S* peep, S* dx4, S* dw, S* dpeep, float* wslices,
                   float* dwacc, float* dwpart, float* ppart, unsigned* counters,
                   unsigned long long* phase_ns, float* xch, int T, int B, int H, int reverse,
                   int act_in, int act_gate, int act_state, int w_smem, int dw_smem,
                   cudaStream_t st) {
  return launch_cooperative(lstm_bwd_kernel<N, kActIn, kActGate, kActState, S>,
                            plan.P * plan.G, smem, st, dy, dy_st, dy_sb, acts, hprev, cprev,
                            mask, m_st, m_sb, w, peep, dx4, dw, dpeep, wslices, dwacc, dwpart,
                            ppart, counters, phase_ns, xch, T, B, H, reverse, act_in, act_gate,
                            act_state, plan.G, plan.gpb, plan.R, w_smem, dw_smem);
}

// The launch both entries share: check the plan and the scratch, zero the
// barriers' counters, then the instance of the bundle width and the
// activation triple.
template <typename S>
int run(const void* dy, long long dy_st, long long dy_sb, const void* acts, const void* hprev,
        const void* cprev, const void* mask, long long m_st, long long m_sb, const void* w,
        const void* peep, void* dx4, void* dw, void* dpeep, void* wslices, void* dwacc,
        void* dwpart, void* ppart, void* counters, void* phase_ns, void* xch, int T, int B,
        int H, int reverse, int act_in, int act_gate, int act_state, int num_sms,
        int row_groups, int w_smem, int dw_smem, int runtime_acts, void* stream) {
  if (T < 0 || B < 0 || H <= 0 || row_groups < 1 || row_groups > num_sms)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const BwdPlan plan = make_bwd_plan(B, H, num_sms, row_groups);
  const size_t smem = bwd_smem_floats(plan, H, w_smem, dw_smem) * sizeof(float);
  if (smem > kSmemLimit || (!w_smem && wslices == nullptr) || (!dw_smem && dwacc == nullptr)
      || (plan.P > 1 && (dwpart == nullptr || ppart == nullptr))
      || (!IsF32<S>::value && xch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(counters, 0, (plan.P + 1) * sizeof(unsigned), st);
  if (err != cudaSuccess) return static_cast<int>(err);
#define LSTM_BWD_ARGS plan, smem, static_cast<const S*>(dy), dy_st, dy_sb, \
    static_cast<const S*>(acts), static_cast<const S*>(hprev),              \
    static_cast<const float*>(cprev), static_cast<const float*>(mask), m_st, m_sb, \
    static_cast<const S*>(w), static_cast<const S*>(peep), static_cast<S*>(dx4), \
    static_cast<S*>(dw), static_cast<S*>(dpeep), static_cast<float*>(wslices), \
    static_cast<float*>(dwacc), static_cast<float*>(dwpart), static_cast<float*>(ppart), \
    static_cast<unsigned*>(counters), static_cast<unsigned long long*>(phase_ns), \
    static_cast<float*>(xch), T, B, H, reverse, act_in, act_gate, act_state, w_smem, dw_smem, st
  // (tanh, sigmoid, sigmoid) and (tanh, sigmoid, tanh) compiled in, the rest at run time
  const int fixed = runtime_acts || act_in != 0 || act_gate != 1 ? -1
                    : act_state == 1 ? 1 : act_state == 0 ? 0 : -1;
  if (plan.N == 8) {
    err = fixed == 1   ? launch<8, 0, 1, 1, S>(LSTM_BWD_ARGS)
          : fixed == 0 ? launch<8, 0, 1, 0, S>(LSTM_BWD_ARGS)
                       : launch<8, -1, -1, -1, S>(LSTM_BWD_ARGS);
  } else {
    err = fixed == 1   ? launch<4, 0, 1, 1, S>(LSTM_BWD_ARGS)
          : fixed == 0 ? launch<4, 0, 1, 0, S>(LSTM_BWD_ARGS)
                       : launch<4, -1, -1, -1, S>(LSTM_BWD_ARGS);
  }
#undef LSTM_BWD_ARGS
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dy [T, B, H] and mask [T, B] are addressed through their time and batch
// strides (in elements; the last dimension is contiguous). acts [T, B, 4H],
// hprev, cprev [T, B, H] (the residuals of lstm_fwd_train), w [H, 4H], peep
// [3, H], and the outputs dx4 [T, B, 4H], dw [H, 4H] and dpeep [3, H] are
// contiguous. `reverse` and act_* (act_f32 codes) are the forward's. The
// grid: num_sms (the card's SM count) and row_groups P (1 <= P <= num_sms;
// fused_lstm.grid_plan); w_smem and dw_smem say whether a block keeps its
// rows of w and of dW in shared memory. Scratch: where not, wslices and
// dwacc (each blocks * bundles * 4H * N floats); dwpart ((P - 1) H 4H
// floats) and ppart (3 P H floats) when P > 1; counters (P + 1 unsigned).
// runtime_acts = 1 reads the activation codes at run time even for a
// compiled-in triple (to time the two forms). phase_ns, when not null ([T][3]
// unsigned 64-bit integers), receives block 0's clock in ns at each step's
// start, at the end of its phase 1 (with its barrier) and of phase 2.
// Launches the whole backward, dW and dpeep included, on `stream`
// (cooperatively; T = 0 writes dW = 0 and dpeep = 0); returns the launch's
// error, cudaErrorCooperativeLaunchTooLarge, or cudaErrorInvalidValue for a
// plan past what a block may hold or a missing scratch buffer.
extern "C" int lstm_bwd(const void* dy, long long dy_st, long long dy_sb,
                        const void* acts, const void* hprev, const void* cprev,
                        const void* mask, long long m_st, long long m_sb,
                        const void* w, const void* peep,
                        void* dx4, void* dw, void* dpeep, void* wslices, void* dwacc,
                        void* dwpart, void* ppart, void* counters, void* phase_ns,
                        int T, int B, int H, int reverse,
                        int act_in, int act_gate, int act_state, int num_sms, int row_groups,
                        int w_smem, int dw_smem, int runtime_acts, void* stream) {
  return run<float>(dy, dy_st, dy_sb, acts, hprev, cprev, mask, m_st, m_sb, w, peep, dx4, dw,
                    dpeep, wslices, dwacc, dwpart, ppart, counters, phase_ns, nullptr, T, B, H,
                    reverse, act_in, act_gate, act_state, num_sms, row_groups, w_smem, dw_smem,
                    runtime_acts, stream);
}

// lstm_bwd's bf16 instance: dy, acts, hprev, w, peep and the outputs dx4,
// dw and dpeep are bf16 (__nv_bfloat16); cprev and mask float32, the
// scratch as lstm_bwd's, and xch, the unrounded gate gradients of the even
// and odd steps, [2][B][4H] floats (16-byte aligned).
extern "C" int lstm_bwd_bf16(const void* dy, long long dy_st, long long dy_sb,
                             const void* acts, const void* hprev, const void* cprev,
                             const void* mask, long long m_st, long long m_sb,
                             const void* w, const void* peep,
                             void* dx4, void* dw, void* dpeep, void* wslices, void* dwacc,
                             void* dwpart, void* ppart, void* counters, void* phase_ns,
                             void* xch, int T, int B, int H, int reverse,
                             int act_in, int act_gate, int act_state, int num_sms,
                             int row_groups, int w_smem, int dw_smem, int runtime_acts,
                             void* stream) {
  return run<__nv_bfloat16>(dy, dy_st, dy_sb, acts, hprev, cprev, mask, m_st, m_sb, w, peep,
                            dx4, dw, dpeep, wslices, dwacc, dwpart, ppart, counters, phase_ns,
                            xch, T, B, H, reverse, act_in, act_gate, act_state, num_sms,
                            row_groups, w_smem, dw_smem, runtime_acts, stream);
}
