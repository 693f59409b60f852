// gru_bwd — the backward of the masked GRU scan: dx3 and dW from the
// residuals of gru_fwd_train, in one launch.
//
// Replaces: paddle_tpu/ops/pallas_gru.py _bwd_kernel (launched by
// pl.pallas_call in _run_bwd, the custom-VJP backward of fused_gru), which
// walks time backwards carrying dh in VMEM and accumulates dW there.
//
// Per step, walked in the opposite order of the forward (t = T-1 .. 0, or
// 0 .. T-1 for a reversed sequence), for every batch row at once, with DH
// [B, H] the gradient carried into the step's output carry, m = mask[t],
// (u, r, c, h_prev) the residuals and act' the derivative of an activation
// from its saved output (common.cuh dact_f32: 1 - y^2 for tanh, y (1 - y)
// for sigmoid):
//   dh     = m * (DH + dy[t])                       (a padded step passes DH on)
//   du     = dh * (h_prev - c)
//   dcand  = dh * (1 - u) * act_in'(c)
//   drh    = dcand . Wc^T                            Wc = w[:, 2H:]
//   dg     = [du * act_gate'(u) | drh * h_prev * act_gate'(r)]
//   dx3[t] = [dg | dcand]
//   DH     = dh * u + drh * r + dg . Wg^T + (1 - m) * DH      Wg = w[:, :2H]
// and, summed over every step and row:
//   dW[:, :2H] += h_prev^T . dg        dW[:, 2H:] += (r * h_prev)^T . dcand
//
// What bounds it on an H100: its float32 operations (12 T B H^2: 6.4 GFLOP
// at T = 32, B = 64, H = 512, some 0.1 ms at 67 TFLOP/s) over its bytes
// (dy, the residuals, w, dx3, dW: about 40 MB). The reversed time loop is
// sequential, and every step needs all B rows of the one after.
//
// What the design does about that: one persistent block on each SM (a
// cooperative launch, persistent_grid.cuh). Both per-step products take w
// transposed, so a block owns ROWS: unit group g (hidden units k = 4g ..
// 4g+3) is rows k of w, all 3H columns, 24 KB at H = 512, held in shared
// memory for the whole launch (the first design read a whole row of w per
// warp from L2 for every batch row at every step, some 6 GB a launch).
// The block that owns unit k also owns dW's rows k, accumulated over the
// steps in shared memory and written once at the end, as the TPU kernel
// accumulates dW in VMEM: its two sums use the rows that the products
// already read (product_colsum4), so dW costs no second pass over dx3 and
// no separate launch. Three
// phases a step, the first two ending in a grid barrier; the gradients
// other blocks read pass through L2 in dx3[t] itself, one row of steps
// each, so no buffer is reused while a block may still read it:
//   1  dh, du and dcand of the owned units: dx3[t]'s update and candidate
//      columns;
//   2  drh = dcand . w[k, 2H:]^T and the reset-gate column of dx3[t];
//      dW[k, 2H:] += (r h_prev)^T dcand;
//   3  DH = dh u + drh r + dg . w[k, :2H]^T + (1 - m) DH, kept in the
//      owner's shared memory, which phase 1 of the next step reads on the
//      same block: no barrier between them; dW[k, :2H] += h_prev^T dg.
// That is 2 barriers a step, 2 T a launch. Where a block's rows of w and
// dW do not fit in shared memory beside the state of its rows (wide H, or
// many rows), dW's rows and then w's are kept in device memory the block
// alone reads and writes, in the same layout (the wrapper chooses, by
// fused_gru.grid_plan). Every sum runs in a fixed order and nothing is
// summed by atomics: two launches give the same bits. The two activations
// are template parameters, one instance for each of the 16 pairs: with the
// codes read at run time the first design ran markedly slower on an H100
// at the train path's shape (chip_smoke.py), the forwards not.
//
// bf16 instance (gru_bwd_bf16; the storage type S is a template
// parameter): the Pallas kernel's bf16 contract (pallas_gru.py _bwd_kernel).
// dy, the residuals and w are bf16, widened on load; dh, DH and every
// gradient are float32; dx3 is stored bf16; the products with w
// transposed take dcand and dg rounded to bf16, while dW sums them
// unrounded in float32 and is rounded to bf16 once, at the end. So the
// gradients other blocks read pass through a float32 exchange buffer
// [2][B][3H] (one buffer for even steps, one for odd: phase 3 of a step
// reads it with no barrier before phase 1 of the next, which writes the
// other), and product_colsum4 rounds them for the product alone.

#include "common.cuh"
#include "persistent_grid.cuh"

namespace {

using namespace pgrid;

// Floats of state a unit group keeps per batch row: DH, dh, drh, h_prev
// and r * h_prev of its 4 units.
constexpr int kState = 20;
// The cross-warp sums of one row tile of a product.
constexpr int kRedFloats = kWarps * kRowTile * 4;

// The shared memory of a block, in floats: per unit group its rows of w
// ([3H][4], when w_smem), its rows of dW ([3H][4], when dw_smem) and the
// state [5][B][4]; then the cross-warp sums.
inline size_t bwd_smem_floats(int B, int H, int gpb, bool w_smem, bool dw_smem) {
  const long long slice = 12LL * H;
  return static_cast<size_t>(gpb) * ((w_smem ? slice : 0) + (dw_smem ? slice : 0)
                                     + static_cast<long long>(kState) * B)
         + kRedFloats;
}

template <int kActIn, int kActGate, typename S>
__global__ void __launch_bounds__(kThreads, 1)
gru_bwd_kernel(const S* __restrict__ dy, long long dy_st, long long dy_sb,
               const S* __restrict__ acts, const S* __restrict__ hprev,
               const float* __restrict__ mask, long long m_st, long long m_sb,
               const S* __restrict__ w, S* dx3, S* __restrict__ dw,
               float* wslices, float* dwacc, unsigned* counter,
               unsigned long long* phase_ns, float* xch,
               int T, int B, int H, int reverse, int gpb, int w_smem, int dw_smem) {
  constexpr bool kF32 = IsF32<S>::value;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int nblk = gridDim.x;
  const int groups = (H + kUnits - 1) / kUnits;
  const long long H3 = 3LL * H;
  const long long slice = 12LL * H;
  const long long state = static_cast<long long>(kState) * B;
  const long long per_group = (w_smem ? slice : 0) + (dw_smem ? slice : 0) + state;
  float* red = smem + gpb * per_group;
  GridBarrier bar{counter, 0};
  // block 0's clock at each step's start and phases' ends, when asked
  const bool clocked = phase_ns != nullptr && blockIdx.x == 0 && tid == 0;
  // unit group gl's rows of w and dW ([3H][4]: W[j][c] = w[4g + c, j]) and
  // its state: DH, dh, drh, h_prev and r * h_prev, each [B][4]
  auto W = [&](int gl) {
    return w_smem ? smem + gl * per_group : wslices + (blockIdx.x + gl * nblk) * slice;
  };
  auto DW = [&](int gl) {
    return dw_smem ? smem + gl * per_group + (w_smem ? slice : 0)
                   : dwacc + (blockIdx.x + gl * nblk) * slice;
  };
  auto DH = [&](int gl) { return smem + gl * per_group + (per_group - state); };
  auto DHN = [&](int gl) { return DH(gl) + 4LL * B; };
  auto DRH = [&](int gl) { return DH(gl) + 8LL * B; };
  auto HP = [&](int gl) { return DH(gl) + 12LL * B; };
  auto RHP = [&](int gl) { return DH(gl) + 16LL * B; };

  // the block's rows of w, zeroed dW rows and state; units past H are 0
  for (int gl = 0; gl < gpb; ++gl) {
    const int g = blockIdx.x + gl * nblk;
    if (g >= groups) break;
    float* wg = W(gl);
    float* dwg = DW(gl);
    for (long long i = tid; i < slice; i += kThreads) {
      const int c = static_cast<int>(i / H3), k = kUnits * g + c;
      const long long j = i % H3;
      if (k >= H) {
        wg[j * 4 + c] = 0.0f;
      } else if (w_smem) {
        stage_f32(wg + j * 4 + c, w + k * H3 + j);   // all of a thread's in flight at once
      } else {
        wg[j * 4 + c] = to_f32(w[k * H3 + j]);
      }
      dwg[j * 4 + c] = 0.0f;
    }
    float* st = DH(gl);
    for (long long i = tid; i < state; i += kThreads) st[i] = 0.0f;
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    if (clocked) phase_ns[4 * s] = global_ns();
    const int t = reverse ? s : T - 1 - s;
    const long long tB = static_cast<long long>(t) * B;
    // the gradients the products read: dx3[t] itself, or in bf16 the
    // float32 exchange buffer of the step's parity (dx3[t] stored beside)
    float* xt;
    if constexpr (kF32) {
      xt = dx3 + tB * H3;
    } else {
      xt = xch + static_cast<long long>(s & 1) * B * H3;
    }
    S* dxt = dx3 + tB * H3;
    auto put = [&](long long off, float v) {
      __stcg(xt + off, v);
      if constexpr (!kF32) dxt[off] = from_f32<S>(v);
    };

    // 1: dh, the update-gate and candidate gradients of the owned units
    for (int gl = 0; gl < gpb; ++gl) {
      const int g = blockIdx.x + gl * nblk;
      if (g >= groups) break;
      const float* dh_in = DH(gl);
      float* dhn = DHN(gl);
      float* hps = HP(gl);
      float* rhps = RHP(gl);
      for (int i = tid; i < 4 * B; i += kThreads) {
        const int b = i / 4, k = kUnits * g + i % 4;
        if (k >= H) continue;
        const long long row = tB + b;
        const float m = mask[t * m_st + b * m_sb];
        const S* a = acts + row * H3;              // [u | r | c]
        const float u = to_f32(a[k]), r = to_f32(a[H + k]), c = to_f32(a[2 * H + k]);
        const float hp = to_f32(hprev[row * H + k]);
        const float d = m * (dh_in[i] + to_f32(dy[t * dy_st + b * dy_sb + k]));
        dhn[i] = d;
        hps[i] = hp;
        rhps[i] = r * hp;
        put(b * H3 + k, d * (hp - c) * dact_f32(kActGate, u));
        put(b * H3 + 2 * H + k, d * (1.0f - u) * dact_f32(kActIn, c));
      }
    }
    bar.sync();
    if (clocked) phase_ns[4 * s + 1] = global_ns();

    // 2: drh = dcand . w[k, 2H:]^T and the reset-gate gradient;
    //    dW[k, 2H:] += (r * h_prev)^T . dcand
    for (int gl = 0; gl < gpb; ++gl) {
      const int g = blockIdx.x + gl * nblk;
      if (g >= groups) break;
      float* drh = DRH(gl);
      const float* hps = HP(gl);
      product_colsum4<2, 16, !kF32>(xt + 2 * H, H3, B, H, W(gl) + 8LL * H, RHP(gl),
                                    DW(gl) + 8LL * H, red, [&](int b, int c, float v) {
                                      const int i = b * 4 + c, k = kUnits * g + c;
                                      drh[i] = v;
                                      if (k >= H) return;
                                      const float r = to_f32(acts[(tB + b) * H3 + H + k]);
                                      put(b * H3 + H + k, v * hps[i] * dact_f32(kActGate, r));
                                    });
    }
    bar.sync();
    if (clocked) phase_ns[4 * s + 2] = global_ns();

    // 3: DH = dh u + drh r + dg . w[k, :2H]^T + (1 - m) DH;
    //    dW[k, :2H] += h_prev^T . dg
    for (int gl = 0; gl < gpb; ++gl) {
      const int g = blockIdx.x + gl * nblk;
      if (g >= groups) break;
      float* dh = DH(gl);
      const float* dhn = DHN(gl);
      const float* drh = DRH(gl);
      product_colsum4<4, 16, !kF32>(xt, H3, B, 2 * H, W(gl), HP(gl), DW(gl), red,
                                    [&](int b, int c, float v) {
                                      const int i = b * 4 + c, k = kUnits * g + c;
                                      if (k >= H) return;
                                      const S* a = acts + (tB + b) * H3;
                                      const float m = mask[t * m_st + b * m_sb];
                                      dh[i] = dhn[i] * to_f32(a[k]) + drh[i] * to_f32(a[H + k])
                                              + v + (1.0f - m) * dh[i];
                                    });
    }
    if (clocked) phase_ns[4 * s + 3] = global_ns();
  }

  // dW: the block's rows, written once
  for (int gl = 0; gl < gpb; ++gl) {
    const int g = blockIdx.x + gl * nblk;
    if (g >= groups) break;
    const float* dwg = DW(gl);
    for (long long i = tid; i < slice; i += kThreads) {
      const int c = static_cast<int>(i / H3), k = kUnits * g + c;
      const long long j = i % H3;
      if (k < H) dw[k * H3 + j] = from_f32<S>(dwg[j * 4 + c]);
    }
  }
}

template <int kActIn, int kActGate, typename S>
cudaError_t launch(const S* dy, long long dy_st, long long dy_sb, const S* acts,
                   const S* hprev, const float* mask, long long m_st, long long m_sb,
                   const S* w, S* dx3, S* dw, float* wslices, float* dwacc,
                   unsigned* counter, unsigned long long* phase_ns, float* xch, int T, int B,
                   int H, int reverse, int num_sms, int w_smem, int dw_smem, cudaStream_t st) {
  // unit groups of 4 hidden units, one block per SM up to one per group
  // (mirrored by paddle_tpu_torch/ops/fused_gru.py grid_plan)
  const int groups = (H + kUnits - 1) / kUnits;
  const int blocks = groups < num_sms ? groups : num_sms;
  const int gpb = (groups + blocks - 1) / blocks;
  const size_t smem = bwd_smem_floats(B, H, gpb, w_smem, dw_smem) * sizeof(float);
  if (smem > kSmemLimit || (!w_smem && wslices == nullptr) || (!dw_smem && dwacc == nullptr)
      || (!IsF32<S>::value && xch == nullptr))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(counter, 0, sizeof(unsigned), st);
  if (err != cudaSuccess) return err;
  err = launch_cooperative(gru_bwd_kernel<kActIn, kActGate, S>, blocks, smem, st,
                           dy, dy_st, dy_sb, acts, hprev, mask, m_st, m_sb, w, dx3, dw,
                           wslices, dwacc, counter, phase_ns, xch, T, B, H, reverse, gpb,
                           w_smem, dw_smem);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// launch<act_in, act_gate> for the act_f32 codes, each in 0..3
template <typename S, int kActIn = -1>
cudaError_t launch_acts(int act_in, int act_gate, const S* dy, long long dy_st,
                        long long dy_sb, const S* acts, const S* hprev,
                        const float* mask, long long m_st, long long m_sb, const S* w,
                        S* dx3, S* dw, float* wslices, float* dwacc, unsigned* counter,
                        unsigned long long* phase_ns, float* xch, int T, int B, int H,
                        int reverse, int num_sms, int w_smem, int dw_smem, cudaStream_t st) {
#define GRU_BWD_ARGS dy, dy_st, dy_sb, acts, hprev, mask, m_st, m_sb, w, dx3, dw, wslices, \
                     dwacc, counter, phase_ns, xch, T, B, H, reverse, num_sms, w_smem, dw_smem, \
                     st
  if constexpr (kActIn < 0) {
    switch (act_in) {
      case 0: return launch_acts<S, 0>(act_in, act_gate, GRU_BWD_ARGS);
      case 1: return launch_acts<S, 1>(act_in, act_gate, GRU_BWD_ARGS);
      case 2: return launch_acts<S, 2>(act_in, act_gate, GRU_BWD_ARGS);
      default: return launch_acts<S, 3>(act_in, act_gate, GRU_BWD_ARGS);
    }
  } else {
    switch (act_gate) {
      case 0: return launch<kActIn, 0, S>(GRU_BWD_ARGS);
      case 1: return launch<kActIn, 1, S>(GRU_BWD_ARGS);
      case 2: return launch<kActIn, 2, S>(GRU_BWD_ARGS);
      default: return launch<kActIn, 3, S>(GRU_BWD_ARGS);
    }
  }
#undef GRU_BWD_ARGS
}

template <typename S>
int gru_bwd_entry(const void* dy, long long dy_st, long long dy_sb, const void* acts,
                  const void* hprev, const void* mask, long long m_st, long long m_sb,
                  const void* w, void* dx3, void* dw, void* wslices, void* dwacc, void* counter,
                  void* phase_ns, void* xch, int T, int B, int H, int reverse, int act_in,
                  int act_gate, int num_sms, int w_smem, int dw_smem, void* stream) {
  if (T < 0 || B < 0 || H <= 0) return static_cast<int>(cudaSuccess);
  return static_cast<int>(launch_acts<S>(
      act_in, act_gate, static_cast<const S*>(dy), dy_st, dy_sb,
      static_cast<const S*>(acts), static_cast<const S*>(hprev),
      static_cast<const float*>(mask), m_st, m_sb, static_cast<const S*>(w),
      static_cast<S*>(dx3), static_cast<S*>(dw), static_cast<float*>(wslices),
      static_cast<float*>(dwacc), static_cast<unsigned*>(counter),
      static_cast<unsigned long long*>(phase_ns), static_cast<float*>(xch), T, B, H, reverse,
      num_sms, w_smem, dw_smem, static_cast<cudaStream_t>(stream)));
}

}  // namespace

// dy [T, B, H] and mask [T, B] are addressed through their time and batch
// strides (in elements; the last dimension is contiguous). acts [T, B, 3H],
// hprev [T, B, H] (the residuals of gru_fwd_train), w [H, 3H], and the
// outputs dx3 [T, B, 3H] and dw [H, 3H] are contiguous. `reverse` is the
// forward's, and so are act_in and act_gate (act_f32 codes). num_sms is the
// card's SM count; w_smem and dw_smem say whether a block keeps its rows of
// w and of dW in shared memory, and where not, wslices and dwacc (each
// ceil(H / 4) * 12 H floats) hold them in device memory; counter is one
// unsigned of scratch. phase_ns, when not null ([T][4] unsigned 64-bit
// integers), receives block 0's clock in ns at each step's start and at
// the ends of its phases 1 and 2 (each with its barrier) and 3.
// Launches the whole backward, dW included, on
// `stream` (cooperatively); returns the launch's error,
// cudaErrorCooperativeLaunchTooLarge, or cudaErrorInvalidValue for a
// shared memory past what a block may hold.
extern "C" int gru_bwd(const void* dy, long long dy_st, long long dy_sb,
                       const void* acts, const void* hprev,
                       const void* mask, long long m_st, long long m_sb,
                       const void* w, void* dx3, void* dw, void* wslices, void* dwacc,
                       void* counter, void* phase_ns, int T, int B, int H, int reverse,
                       int act_in, int act_gate, int num_sms, int w_smem, int dw_smem,
                       void* stream) {
  return gru_bwd_entry<float>(dy, dy_st, dy_sb, acts, hprev, mask, m_st, m_sb, w, dx3, dw,
                              wslices, dwacc, counter, phase_ns, nullptr, T, B, H, reverse,
                              act_in, act_gate, num_sms, w_smem, dw_smem, stream);
}

// gru_bwd's bf16 instance: dy, acts, hprev, w, dx3 and dw are bf16
// (__nv_bfloat16); xch is float32 scratch [2, B, 3H] (the unrounded
// gradients the blocks exchange).
extern "C" int gru_bwd_bf16(const void* dy, long long dy_st, long long dy_sb,
                            const void* acts, const void* hprev,
                            const void* mask, long long m_st, long long m_sb,
                            const void* w, void* dx3, void* dw, void* wslices, void* dwacc,
                            void* counter, void* phase_ns, void* xch, int T, int B, int H,
                            int reverse, int act_in, int act_gate, int num_sms, int w_smem,
                            int dw_smem, void* stream) {
  return gru_bwd_entry<__nv_bfloat16>(dy, dy_st, dy_sb, acts, hprev, mask, m_st, m_sb, w, dx3,
                                      dw, wslices, dwacc, counter, phase_ns, xch, T, B, H,
                                      reverse, act_in, act_gate, num_sms, w_smem, dw_smem,
                                      stream);
}
