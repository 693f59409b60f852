// gru_fwd / gru_fwd_train — the masked GRU over a whole sequence in one
// launch (kernels 1 and 2).
//
// Replaces: paddle_tpu/ops/pallas_gru.py _fwd_kernel_light (gru_fwd, the
// inference variant launched by pl.pallas_call in _run_fwd, entry
// fused_gru), which runs the bidirectional GRU encoder of the seqToseq
// model at prefill, twice per admission; and _fwd_kernel (gru_fwd_train,
// the training variant: the same scan plus the residuals its backward,
// gru_bwd.cu, reads; the custom-VJP forward of fused_gru, twice per
// training step). As in the JAX package the two differ only in the
// residual stores: here one body, with kResiduals a template parameter.
//
// Per step t (time reversed when `reverse` is set), with h0 = 0, the
// weight w [H, 3H] split [update | reset | candidate] and the bias already
// folded into x3, and act_gate, act_in each one of tanh, sigmoid, relu and
// linear (common.cuh act_f32; the defaults are sigmoid and tanh):
//   g   = act_gate(x3[t, :, :2H] + h . w[:, :2H])      u = g[:, :H], r = g[:, H:]
//   c   = act_in(x3[t, :, 2H:] + (r * h) . w[:, 2H:])
//   h'  = u * h + (1 - u) * c
//   ys[t] = m * h';   carry h = m * h' + (1 - m) * h    (m = mask[t, b])
// Training residuals, at the step's own time index t:
//   acts[t] = [u | r | c]   [T, B, 3H]       hprev[t] = h   [T, B, H]
//
// What bounds it on an H100: its float32 operations (T (6 B H^2 + 14 B H):
// 3.2 GFLOP at T = 32, B = 64, H = 512, some 48 us at 67 TFLOP/s) over its
// bytes (x3, w, ys: about 20 MB, 6 us at 3.35 TB/s; 37 MB, 11 us, with the
// residuals). The time loop is sequential, and every step needs the whole
// carry of the step before against all of w (3 MB at H = 512).
//
// What the design does about that: a persistent, cooperative grid
// (persistent_grid.cuh), one block on each SM up to one per unit group of
// 4 hidden units, each block owning groups blockIdx.x, blockIdx.x +
// blocks, ... (the plan of kernel 3, fused_gru.grid_plan; fused_gru.fwd_plan
// mirrors this one). Both per-step products produce columns, so unit group
// g (units k = 4g .. 4g+3) is w's COLUMNS of those units: update k, reset
// H + k ([H][8]) and candidate 2H + k ([H][4]), 24 KB at H = 512, held in
// shared memory for the whole launch (the first designs, one block per
// batch row, read all of w from L2 at every step of every row: some 6 GB a
// launch, 2.4-2.6 ms for kernel 1 at the serve's shape on an H100 SXM at
// 700 W, against 0.38 ms of device time here; PERF.md). Each product
// covers all B rows at once (block_product). Two phases a step, each
// ending in a grid barrier:
//   A  u and r of the owned units from h . w[:, {k, H+k}] (and their
//      residual columns), and r * h into the [B, H] buffer rh;
//   B  c from (r h) . w[:, 2H+k], the blend, ys[t] (and the candidate's
//      residual column), and the masked carry.
// The carry passes between blocks through L2 (written with __stcg, read
// with __ldcg): kernel 2 writes it into the residual hprev at the next
// step's own time index, which is exactly the carry, so it needs no
// scratch (as kernel 5 passes h); kernel 1 writes it into a [B, H] scratch
// buffer. The owner also keeps its units' carry in shared memory. Every
// buffer's readers in a step are done a barrier before its next writer
// (rh: written in A, read in B; the carry: written in B, read in A of the
// next step), so no buffer needs a second copy. The first step's carry is
// 0 and is not read, so kernel 1 never reads its scratch before writing
// it. Where a block's columns of w do not fit in shared memory beside the
// state of its rows (wide H, many rows), they are kept in device memory
// that only the block touches, in the same layout. Every sum runs in a
// fixed order, the same in both instances: two launches give the same
// bits, and kernel 1's ys equal kernel 2's. The activation codes are read
// at run time (the forwards ran as fast that way as with templates).
//
// bf16 instances (gru_fwd_bf16, gru_fwd_train_bf16; the storage type S is a
// template parameter) keep the Pallas kernels' bf16 contract
// (pallas_gru.py _cell_fwd, _fwd_kernel): x3 and w are bf16, widened on
// load (w into the same float32 slices in shared memory), the carry stays
// float32 in the owner's shared memory, and the vectors that pass between
// blocks are the products' operands rounded to bf16: the carry buffer holds
// round(h) (kernel 2's residual hprev, which is exactly Pallas's
// h_prev.astype(bf16)) and rh holds round(r * h). Products multiply those
// bf16 values widened in float32 FMA, which is exact, and accumulate in
// float32. ys and acts are stored bf16. The mask is float32 in both.

#include "common.cuh"
#include "persistent_grid.cuh"

namespace {

using namespace pgrid;

// Floats of state a unit group keeps per batch row: h . w's update and
// reset columns [8], the candidate's product [4], u [4] and the carry [4].
constexpr int kState = 20;

// The shared memory of a block, in floats: per unit group its columns of
// w ([H][8] then [H][4], when w_smem) and the state [B][20].
inline size_t fwd_smem_floats(int B, int H, int gpb, bool w_smem) {
  return static_cast<size_t>(gpb) * ((w_smem ? 12LL * H : 0) + static_cast<long long>(kState) * B);
}

// `carry` is kernel 2's residual hprev [T, B, H], the carry of step s at
// its own time index; kernel 1's [B, H] scratch, one copy for every step.
// acts is unused (null) without residuals.
template <bool kResiduals, typename S>
__global__ void __launch_bounds__(kThreads, 1)
gru_fwd_kernel(const S* __restrict__ x3, long long x_st, long long x_sb,
               const float* __restrict__ mask, long long m_st, long long m_sb,
               const S* __restrict__ w, S* __restrict__ ys, long long y_st,
               long long y_sb, S* __restrict__ acts, S* carry, S* rh,
               float* wslices, unsigned* counter, int T, int B, int H, int reverse,
               int act_in, int act_gate, int gpb, int w_smem) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int nblk = gridDim.x;
  const int groups = (H + kUnits - 1) / kUnits;
  const long long H3 = 3LL * H;
  const long long slice = 12LL * H;
  const long long state = static_cast<long long>(kState) * B;
  const long long per_group = (w_smem ? slice : 0) + state;
  GridBarrier bar{counter, 0};
  // the carry of the step at time index tt
  auto carry_at = [&](int tt) {
    return kResiduals ? carry + static_cast<long long>(tt) * B * H : carry;
  };
  // unit group gl's columns of w (WG [H][8]: update then reset of its 4
  // units; WC [H][4]: candidate) and its state: SG [B][8], SC [B][4],
  // SU [B][4] and the carry HO [B][4]
  auto WG = [&](int gl) {
    return w_smem ? smem + gl * per_group : wslices + (blockIdx.x + gl * nblk) * slice;
  };
  auto WC = [&](int gl) { return WG(gl) + 8LL * H; };
  auto SG = [&](int gl) { return smem + gl * per_group + (per_group - state); };
  auto SC = [&](int gl) { return SG(gl) + 8LL * B; };
  auto SU = [&](int gl) { return SG(gl) + 12LL * B; };
  auto HO = [&](int gl) { return SG(gl) + 16LL * B; };

  // the block's columns of w and a zero carry; units past H are 0
  for (int gl = 0; gl < gpb; ++gl) {
    const int g = blockIdx.x + gl * nblk;
    if (g >= groups) break;
    float* wg = WG(gl);
    for (long long i = tid; i < slice; i += kThreads) {
      long long src;
      int j;
      if (i < 8LL * H) {                      // WG[kk][c]: column q H + 4g + c % 4
        const int kk = static_cast<int>(i / 8), c = static_cast<int>(i % 8);
        j = kUnits * g + c % 4;
        src = kk * H3 + (c / 4) * H + j;
      } else {                                // WC[kk][c]: column 2H + 4g + c
        const long long ii = i - 8LL * H;
        const int kk = static_cast<int>(ii / 4), c = static_cast<int>(ii % 4);
        j = kUnits * g + c;
        src = kk * H3 + 2LL * H + j;
      }
      if (j >= H) {
        wg[i] = 0.0f;
      } else if (w_smem) {
        stage_f32(wg + i, w + src);           // all of a thread's in flight at once
      } else {
        wg[i] = to_f32(w[src]);
      }
    }
    float* ho = HO(gl);
    for (int i = tid; i < 4 * B; i += kThreads) ho[i] = 0.0f;
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    const long long tB = static_cast<long long>(t) * B;

    // A: u, r and r * h of the owned units (the first step's carry is 0)
    if (s > 0) {
      for (int gl = 0; gl < gpb; ++gl) {
        if (blockIdx.x + gl * nblk >= groups) break;
        block_product<8>(SG(gl), 8, B, carry_at(t), H, H, WG(gl));
      }
      __syncthreads();
    }
    for (int gl = 0; gl < gpb; ++gl) {
      const int g = blockIdx.x + gl * nblk;
      if (g >= groups) break;
      const float* sg = SG(gl);
      float* su = SU(gl);
      const float* ho = HO(gl);
      for (int i = tid; i < 4 * B; i += kThreads) {
        const int b = i / 4, c = i % 4, k = kUnits * g + c;
        if (k >= H) continue;
        const S* xr = x3 + t * x_st + b * x_sb;
        const float pu = s > 0 ? sg[b * 8 + c] : 0.0f;
        const float pr = s > 0 ? sg[b * 8 + 4 + c] : 0.0f;
        const float u = act_f32(act_gate, to_f32(xr[k]) + pu);
        const float r = act_f32(act_gate, to_f32(xr[H + k]) + pr);
        if (kResiduals) {
          const long long row = tB + b;
          acts[row * H3 + k] = from_f32<S>(u);
          acts[row * H3 + H + k] = from_f32<S>(r);
          if (s == 0) carry[row * H + k] = from_f32<S>(0.0f);
        }
        su[i] = u;
        stcg_as(rh + static_cast<long long>(b) * H + k, r * ho[i]);
      }
    }
    bar.sync();

    // B: the candidate, the blend, the masked output and the carry
    for (int gl = 0; gl < gpb; ++gl) {
      if (blockIdx.x + gl * nblk >= groups) break;
      block_product<4>(SC(gl), 4, B, rh, H, H, WC(gl));
    }
    __syncthreads();
    const bool next = s + 1 < T;
    // the carry that A of the next step reads
    S* hnext = carry_at(!next ? t : reverse ? t - 1 : t + 1);
    for (int gl = 0; gl < gpb; ++gl) {
      const int g = blockIdx.x + gl * nblk;
      if (g >= groups) break;
      const float* sc = SC(gl);
      const float* su = SU(gl);
      float* ho = HO(gl);
      for (int i = tid; i < 4 * B; i += kThreads) {
        const int b = i / 4, k = kUnits * g + i % 4;
        if (k >= H) continue;
        const float m = mask[t * m_st + b * m_sb];
        const float c = act_f32(act_in, to_f32(x3[t * x_st + b * x_sb + 2 * H + k]) + sc[i]);
        const float u = su[i];
        const float hp = ho[i];
        const float hn = u * hp + (1.0f - u) * c;
        if (kResiduals) acts[(tB + b) * H3 + 2 * H + k] = from_f32<S>(c);
        ys[t * y_st + b * y_sb + k] = from_f32<S>(m * hn);
        const float h = m * hn + (1.0f - m) * hp;
        ho[i] = h;
        if (next) stcg_as(hnext + static_cast<long long>(b) * H + k, h);
      }
    }
    if (next) bar.sync();
  }
}

// The launch both entries share: zero the barrier's counter, then the grid
// cooperatively (nothing for T = 0 or B = 0).
template <bool kResiduals, typename S>
int launch_fwd(const void* x3, long long x_st, long long x_sb, const void* mask, long long m_st,
               long long m_sb, const void* w, void* ys, long long y_st, long long y_sb,
               void* acts, void* carry, void* rh, void* wslices, void* counter, int T, int B,
               int H, int reverse, int act_in, int act_gate, int num_sms, int w_smem,
               void* stream) {
  if (T <= 0 || B <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // unit groups of 4 hidden units, one block per SM up to one per group
  // (mirrored by paddle_tpu_torch/ops/fused_gru.py fwd_plan)
  const int groups = (H + kUnits - 1) / kUnits;
  const int blocks = groups < num_sms ? groups : num_sms;
  const int gpb = (groups + blocks - 1) / blocks;
  const size_t smem = fwd_smem_floats(B, H, gpb, w_smem) * sizeof(float);
  if (smem > kSmemLimit || (!w_smem && wslices == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(counter, 0, sizeof(unsigned), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_cooperative(gru_fwd_kernel<kResiduals, S>, blocks, smem, st,
                           static_cast<const S*>(x3), x_st, x_sb,
                           static_cast<const float*>(mask), m_st, m_sb,
                           static_cast<const S*>(w), static_cast<S*>(ys), y_st, y_sb,
                           static_cast<S*>(acts), static_cast<S*>(carry),
                           static_cast<S*>(rh), static_cast<float*>(wslices),
                           static_cast<unsigned*>(counter), T, B, H, reverse, act_in, act_gate,
                           gpb, w_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x3 [T, B, 3H], mask [T, B] and ys [T, B, H] are addressed through their
// time and batch strides (in elements; the last dimension is contiguous);
// w [H, 3H] is contiguous; act_in and act_gate are act_f32 codes. Scratch:
// carry and rh, [B, H] each; wslices (ceil(H / 4) * 12 H floats) where
// w_smem is 0, a block then keeping its columns of w in device memory;
// counter, one unsigned. num_sms is the card's SM count (the grid:
// fused_gru.fwd_plan). Launches on `stream` (cooperatively; nothing for
// T = 0 or B = 0); returns the launch's error,
// cudaErrorCooperativeLaunchTooLarge, or cudaErrorInvalidValue for a
// shared memory past what a block may hold.
extern "C" int gru_fwd(const void* x3, long long x_st, long long x_sb,
                       const void* mask, long long m_st, long long m_sb,
                       const void* w, void* ys, long long y_st, long long y_sb,
                       void* carry, void* rh, void* wslices, void* counter,
                       int T, int B, int H, int reverse, int act_in, int act_gate,
                       int num_sms, int w_smem, void* stream) {
  return launch_fwd<false, float>(x3, x_st, x_sb, mask, m_st, m_sb, w, ys, y_st, y_sb, nullptr,
                                  carry, rh, wslices, counter, T, B, H, reverse, act_in, act_gate,
                                  num_sms, w_smem, stream);
}

// As gru_fwd, and the residuals acts [T, B, 3H] and hprev [T, B, H]
// (contiguous), hprev in place of the carry scratch.
extern "C" int gru_fwd_train(const void* x3, long long x_st, long long x_sb,
                             const void* mask, long long m_st, long long m_sb,
                             const void* w, void* ys, long long y_st, long long y_sb,
                             void* acts, void* hprev, void* rh, void* wslices, void* counter,
                             int T, int B, int H, int reverse, int act_in, int act_gate,
                             int num_sms, int w_smem, void* stream) {
  return launch_fwd<true, float>(x3, x_st, x_sb, mask, m_st, m_sb, w, ys, y_st, y_sb, acts,
                                 hprev, rh, wslices, counter, T, B, H, reverse, act_in, act_gate,
                                 num_sms, w_smem, stream);
}

// gru_fwd's bf16 instance: x3, w, ys and the scratch carry and rh are
// bf16 (__nv_bfloat16); mask, wslices and counter as gru_fwd's.
extern "C" int gru_fwd_bf16(const void* x3, long long x_st, long long x_sb,
                            const void* mask, long long m_st, long long m_sb,
                            const void* w, void* ys, long long y_st, long long y_sb,
                            void* carry, void* rh, void* wslices, void* counter,
                            int T, int B, int H, int reverse, int act_in, int act_gate,
                            int num_sms, int w_smem, void* stream) {
  return launch_fwd<false, __nv_bfloat16>(x3, x_st, x_sb, mask, m_st, m_sb, w, ys, y_st, y_sb,
                                          nullptr, carry, rh, wslices, counter, T, B, H, reverse,
                                          act_in, act_gate, num_sms, w_smem, stream);
}

// gru_fwd_train's bf16 instance: also acts and hprev in bf16.
extern "C" int gru_fwd_train_bf16(const void* x3, long long x_st, long long x_sb,
                                  const void* mask, long long m_st, long long m_sb,
                                  const void* w, void* ys, long long y_st, long long y_sb,
                                  void* acts, void* hprev, void* rh, void* wslices, void* counter,
                                  int T, int B, int H, int reverse, int act_in, int act_gate,
                                  int num_sms, int w_smem, void* stream) {
  return launch_fwd<true, __nv_bfloat16>(x3, x_st, x_sb, mask, m_st, m_sb, w, ys, y_st, y_sb,
                                         acts, hprev, rh, wslices, counter, T, B, H, reverse,
                                         act_in, act_gate, num_sms, w_smem, stream);
}
