// lstm_fwd / lstm_fwd_train — the masked peephole LSTM over a whole sequence
// in one launch.
//
// Replaces: paddle_tpu/ops/pallas_lstm.py _fwd_kernel_light (lstm_fwd, the
// inference variant launched by pl.pallas_call in _run_fwd, entry
// fused_lstm), which runs the lstmemory layer of the LSTM text classifier
// in test and eval passes; and _fwd_kernel (lstm_fwd_train, the training
// variant: the same scan plus the residuals its backward reads, the
// custom-VJP forward of fused_lstm). As in the JAX package the two differ
// only in the residual stores, here a template parameter.
//
// Per step t (time reversed when `reverse` is set), with h0 = c0 = 0, the
// weight w [H, 4H] split [candidate | input | forget | output], the gate
// biases already folded into x4 and the peepholes peep [3, H] = (pi, pf, po):
//   g  = x4[t] + h . w                       ga, gi, gf, go = g[:, kH:(k+1)H]
//   i  = act_gate(gi + pi * c)    f = act_gate(gf + pf * c)    a = act_in(ga)
//   c' = f * c + i * a            o = act_gate(go + po * c')   h' = o * act_state(c')
//   ys[t] = m * h';   carries h = m * h' + (1 - m) * h,  c = m * c' + (1 - m) * c
// with m = mask[t, b]. Training residuals, at the step's own time index t:
//   acts[t] = [a | i | f | o] [T, B, 4H]     hprev[t] = h     cprev[t] = c   [T, B, H]
//
// What bounds it on an H100: at T = 64, B = 256, H = 512 the function moves
// about 0.2 GB (x4, w, ys; 0.5 GB with the residuals), some 0.06-0.15 ms at
// 3.35 TB/s, and does 34.5 GFLOP (kernel_flops.lstm_fwd_flops), 0.52 ms at
// the 67 TFLOP/s float32 rate: operations bound it. The time loop is
// sequential and every step needs all of w (4 MB at H = 512) against every
// row's h, so how often w is read from L2 decides how near the kernel gets.
//
// What the design does about that: a thread-block cluster of C blocks (up
// to 8) shares one tile of 32 batch rows (16 when H > 512); block c owns
// the hidden units [c U, (c+1) U) and reads only their four gate columns of
// w, once per step for all rows of the tile (one block per row would read
// the whole w per row and step, 32x the L2 traffic). The slice streams
// through shared memory in chunks of KC rows of w, kStages of them in
// flight with cp.async, so the copies of the next chunks overlap the
// products of this one; w does not change between steps, so the stream runs
// on across step boundaries. A thread owns one unit and 4 rows: its 16 gate
// sums stay in registers, so the cell update needs no exchange of gates and
// c stays in registers for the whole sequence. h is double-buffered in each
// block's shared memory as [H][rows]; after a step every block writes its
// units' new h into all blocks of its cluster (distributed shared memory),
// and one cluster barrier per step separates the steps.
//
// Measured on an H100 (chip_smoke.py, PERF.md): reading w straight from L2
// in the product loop ran ~100 us a step, bound by load latency; staging
// it with 16-row tiles was 1.6x faster; 32-row tiles (half the L2 traffic,
// 16 warps a block, more work between a copy and its use) faster again.
// At one block per SM an H100 does not place at once all 16 clusters of 8
// that 16-row tiles of a 256-row batch make, so those would run in two
// waves; the 8 clusters of 32-row tiles run in one.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRpt = 4;                      // rows per thread
constexpr int kMaxThreads = 512;
constexpr int kMaxCluster = 8;
constexpr int kStages = 3;                   // chunks of w in flight
constexpr int kChunk = 32;                   // rows of w per chunk (fewer for large H)
constexpr size_t kMaxSmem = 227 * 1024;

// kRowGroups groups of kRpt rows: a tile of 32 rows where 8 U threads fit
// in a block, else 16.
template <bool kResiduals, int kRowGroups>
__global__ void __launch_bounds__(kMaxThreads)
lstm_fwd_kernel(const float* __restrict__ x4, long long x_st, long long x_sb,
                const float* __restrict__ mask, long long m_st, long long m_sb,
                const float* __restrict__ w, const float* __restrict__ peep,
                float* __restrict__ ys, long long y_st, long long y_sb,
                float* __restrict__ acts, float* __restrict__ hprev,
                float* __restrict__ cprev,
                int T, int B, int H, int U, int KC, int reverse,
                int act_in, int act_gate, int act_state) {
  constexpr int kRows = kRpt * kRowGroups;   // batch rows per cluster
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  extern __shared__ float4 smem4[];
  const int HR = H * kRows;
  const int W4 = 4 * U;
  float* hbuf = reinterpret_cast<float*>(smem4);          // [2][H][kRows]
  float* wbuf = hbuf + 2 * HR;                            // [kStages][KC][4 U]
  const int row0 = blockIdx.y * kRows;
  const int u = threadIdx.x % U;
  const int rg = threadIdx.x / U;
  const int j = rank * U + u;                             // this thread's unit
  const bool active = rg < kRowGroups && j < H;
  const bool stager = rg < 4 && j < H;
  const long long H4 = 4LL * H;

  // Thread (rg < 4, u) also stages column rg * U + u of the chunks: gate rg
  // of unit j, w[k, rg H + j] to wbuf[stage][k][rg U + u].
  const int NC = (H + KC - 1) / KC;                       // chunks per step
  const int total = T * NC;
  const float* wsrc = w + rg * H + j;
  auto issue = [&](int q) {
    if (!stager) return;
    const int k0 = (q % NC) * KC;
    const int kc = min(KC, H - k0);
    float* dst = wbuf + (q % kStages) * KC * W4 + threadIdx.x;
    for (int k = 0; k < kc; ++k) cp_async4(dst + k * W4, wsrc + (k0 + k) * H4);
  };

  for (int e = threadIdx.x; e < HR; e += blockDim.x) hbuf[e] = 0.0f;
  float c[kRpt];
#pragma unroll
  for (int i = 0; i < kRpt; ++i) c[i] = 0.0f;
  float pi = 0.0f, pf = 0.0f, po = 0.0f;
  if (active) {
    pi = peep[j];
    pf = peep[H + j];
    po = peep[2 * H + j];
  }
  for (int q = 0; q < kStages - 1; ++q) {
    if (q < total) issue(q);
    cp_async_commit();
  }
  cluster.sync();   // every block of the cluster runs and has zeroed h

  int q = 0;                                              // chunks consumed
  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    const float* hc = hbuf + (s & 1) * HR;
    float* hn = hbuf + ((s + 1) & 1) * HR;
    // this step's x4 and mask, loaded now and used after the product
    float xv[kRpt][4], mv[kRpt];
#pragma unroll
    for (int i = 0; i < kRpt; ++i) {
      const int b = row0 + rg * kRpt + i;
      const bool ok = active && b < B;
      const float* xr = x4 + t * x_st + b * x_sb + j;
#pragma unroll
      for (int g = 0; g < 4; ++g) xv[i][g] = ok ? xr[g * H] : 0.0f;
      mv[i] = ok ? mask[t * m_st + b * m_sb] : 0.0f;
    }
    float acc[kRpt][4];
#pragma unroll
    for (int i = 0; i < kRpt; ++i)
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[i][g] = 0.0f;
    for (int ch = 0; ch < NC; ++ch, ++q) {
      cp_async_wait<kStages - 2>();   // this thread's copies of chunk q landed
      __syncthreads();                // everyone's; and chunk q - 1 is consumed
      if (q + kStages - 1 < total) issue(q + kStages - 1);
      cp_async_commit();
      if (!active) continue;
      const int k0 = ch * KC;
      const int kc = min(KC, H - k0);
      const float* ws = wbuf + (q % kStages) * KC * W4 + u;
      const float* hk = hc + k0 * kRows + rg * kRpt;
#pragma unroll 4
      for (int k = 0; k < kc; ++k) {
        const float4 hv = *reinterpret_cast<const float4*>(hk + k * kRows);
        const float* wk = ws + k * W4;
        const float wv[4] = {wk[0], wk[U], wk[2 * U], wk[3 * U]};
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          acc[0][g] = fmaf(hv.x, wv[g], acc[0][g]);
          acc[1][g] = fmaf(hv.y, wv[g], acc[1][g]);
          acc[2][g] = fmaf(hv.z, wv[g], acc[2][g]);
          acc[3][g] = fmaf(hv.w, wv[g], acc[3][g]);
        }
      }
    }
    if (active) {
      float hnext[kRpt];
#pragma unroll
      for (int i = 0; i < kRpt; ++i) {
        const int b = row0 + rg * kRpt + i;
        const float m = mv[i];
        const float hp = hc[j * kRows + rg * kRpt + i];
        const float cp = c[i];
        const float ig = act_f32(act_gate, xv[i][1] + acc[i][1] + pi * cp);
        const float fg = act_f32(act_gate, xv[i][2] + acc[i][2] + pf * cp);
        const float a = act_f32(act_in, xv[i][0] + acc[i][0]);
        const float cn = fg * cp + ig * a;
        const float og = act_f32(act_gate, xv[i][3] + acc[i][3] + po * cn);
        const float hnew = og * act_f32(act_state, cn);
        if (b < B) {
          ys[t * y_st + b * y_sb + j] = m * hnew;
          if (kResiduals) {
            const long long row = static_cast<long long>(t) * B + b;
            float* ar = acts + row * H4 + j;
            ar[0] = a;
            ar[H] = ig;
            ar[2 * H] = fg;
            ar[3 * H] = og;
            hprev[row * H + j] = hp;
            cprev[row * H + j] = cp;
          }
        }
        hnext[i] = m * hnew + (1.0f - m) * hp;
        c[i] = m * cn + (1.0f - m) * cp;
      }
      const float4 hv = make_float4(hnext[0], hnext[1], hnext[2], hnext[3]);
      for (int p = 0; p < C; ++p) {
        float* dst = cluster.map_shared_rank(hn, p);
        *reinterpret_cast<float4*>(dst + j * kRows + rg * kRpt) = hv;
      }
    }
    cluster.sync();   // the new h is everywhere; nobody reads the old one
  }
}

template <bool kResiduals, int kRowGroups>
int launch_tiles(const void* x4, long long x_st, long long x_sb,
                 const void* mask, long long m_st, long long m_sb,
                 const void* w, const void* peep, void* ys, long long y_st, long long y_sb,
                 void* acts, void* hprev, void* cprev, int T, int B, int H, int C, int U,
                 int reverse, int act_in, int act_gate, int act_state, void* stream) {
  constexpr int kRows = kRpt * kRowGroups;
  const int threads = ((U * kRowGroups + 31) / 32) * 32;
  if (threads > kMaxThreads) return static_cast<int>(cudaErrorInvalidConfiguration);
  auto smem_for = [&](int kc) {
    return (2 * static_cast<size_t>(H) * kRows + kStages * static_cast<size_t>(kc) * 4 * U) *
           sizeof(float);
  };
  int KC = kChunk;
  while (KC > 1 && smem_for(KC) > kMaxSmem) KC /= 2;
  const size_t smem = smem_for(KC);
  cudaError_t err = allow_smem(lstm_fwd_kernel<kResiduals, kRowGroups>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (T > 0 && B > 0 && H > 0) {
    const dim3 grid(C, (B + kRows - 1) / kRows);
    err = launch_cluster(lstm_fwd_kernel<kResiduals, kRowGroups>, grid, dim3(threads), smem,
                         static_cast<cudaStream_t>(stream), C,
                         static_cast<const float*>(x4), x_st, x_sb,
                         static_cast<const float*>(mask), m_st, m_sb,
                         static_cast<const float*>(w), static_cast<const float*>(peep),
                         static_cast<float*>(ys), y_st, y_sb,
                         static_cast<float*>(acts), static_cast<float*>(hprev),
                         static_cast<float*>(cprev), T, B, H, U, KC, reverse,
                         act_in, act_gate, act_state);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kResiduals>
int launch(const void* x4, long long x_st, long long x_sb,
           const void* mask, long long m_st, long long m_sb,
           const void* w, const void* peep, void* ys, long long y_st, long long y_sb,
           void* acts, void* hprev, void* cprev, int T, int B, int H, int reverse,
           int act_in, int act_gate, int act_state, void* stream) {
  int C = (H + 63) / 64;
  C = C < 1 ? 1 : (C > kMaxCluster ? kMaxCluster : C);
  const int U = (H + C - 1) / C;
  auto tiles = U * 8 <= kMaxThreads ? launch_tiles<kResiduals, 8> : launch_tiles<kResiduals, 4>;
  return tiles(x4, x_st, x_sb, mask, m_st, m_sb, w, peep, ys, y_st, y_sb, acts, hprev, cprev,
               T, B, H, C, U, reverse, act_in, act_gate, act_state, stream);
}

}  // namespace

// x4 [T, B, 4H], mask [T, B] and ys [T, B, H] are addressed through their
// time and batch strides (in elements; the last dimension is contiguous);
// w [H, 4H] and peep [3, H] are contiguous. act_* are the activation codes
// of common.cuh (0 tanh, 1 sigmoid, 2 relu, 3 linear). H <= 1024. Launches
// on `stream`, returns cudaGetLastError() (or the launch's own error).
extern "C" int lstm_fwd(const void* x4, long long x_st, long long x_sb,
                        const void* mask, long long m_st, long long m_sb,
                        const void* w, const void* peep,
                        void* ys, long long y_st, long long y_sb,
                        int T, int B, int H, int reverse,
                        int act_in, int act_gate, int act_state, void* stream) {
  return launch<false>(x4, x_st, x_sb, mask, m_st, m_sb, w, peep, ys, y_st, y_sb,
                       nullptr, nullptr, nullptr, T, B, H, reverse,
                       act_in, act_gate, act_state, stream);
}

// As lstm_fwd, plus the residuals: acts [T, B, 4H] (post-activation a, i, f,
// o), hprev and cprev [T, B, H], all contiguous.
extern "C" int lstm_fwd_train(const void* x4, long long x_st, long long x_sb,
                              const void* mask, long long m_st, long long m_sb,
                              const void* w, const void* peep,
                              void* ys, long long y_st, long long y_sb,
                              void* acts, void* hprev, void* cprev,
                              int T, int B, int H, int reverse,
                              int act_in, int act_gate, int act_state, void* stream) {
  return launch<true>(x4, x_st, x_sb, mask, m_st, m_sb, w, peep, ys, y_st, y_sb,
                      acts, hprev, cprev, T, B, H, reverse,
                      act_in, act_gate, act_state, stream);
}
