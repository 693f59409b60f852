// gru_fwd — the masked GRU over a whole sequence in one launch, inference
// (kernel 1).
//
// Replaces: paddle_tpu/ops/pallas_gru.py _fwd_kernel_light (launched by
// pl.pallas_call in _run_fwd, entry fused_gru), which runs the
// bidirectional GRU encoder of the seqToseq model at prefill. The training
// variant, which also saves the residuals its backward reads, is the
// persistent grid of gru_fwd_train.cu (kernel 2).
//
// Per step t (time reversed when `reverse` is set), with h0 = 0, the
// weight w [H, 3H] split [update | reset | candidate] and the bias already
// folded into x3, and act_gate, act_in each one of tanh, sigmoid, relu and
// linear (common.cuh act_f32; the defaults are sigmoid and tanh):
//   g   = act_gate(x3[t, :, :2H] + h . w[:, :2H])      u = g[:, :H], r = g[:, H:]
//   c   = act_in(x3[t, :, 2H:] + (r * h) . w[:, 2H:])
//   h'  = u * h + (1 - u) * c
//   ys[t] = m * h';   carry h = m * h' + (1 - m) * h    (m = mask[t, b])
//
// What bounds it on an H100: the time loop is sequential, and every step
// reads the whole recurrent weight (3 MB at H = 512) once per batch row.
// The bytes the function must move (x3, w, ys: about 20 MB at T = 32,
// B = 64, H = 512) take some 6 us at 3.35 TB/s and its 3.2 GFLOP some
// 48 us at the 67 TFLOP/s float32 rate, but this kernel re-reads w from
// L2 at every step of every row, so the SM's L2 read rate is what limits
// it.
//
// What the design does about that: one thread block per batch row keeps
// its carry h, the update gate u and r*h in shared memory for the whole
// sequence, so nothing but x3, w and ys touches device memory; threads own
// output columns, so each warp reads a row of w as one coalesced 128-byte
// line. Sharing w across rows is kernel 2's design (gru_fwd_train.cu) and
// is left to a later change here.

#include "common.cuh"

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
gru_fwd_kernel(const float* __restrict__ x3, long long x_st, long long x_sb,
               const float* __restrict__ mask, long long m_st, long long m_sb,
               const float* __restrict__ w,
               float* __restrict__ ys, long long y_st, long long y_sb,
               int T, int B, int H, int reverse, int act_in, int act_gate) {
  extern __shared__ float smem[];
  float* h = smem;           // [H] carry
  float* u = smem + H;       // [H] update gate
  float* rh = smem + 2 * H;  // [H] reset gate * carry
  const int b = blockIdx.x;
  const long long H3 = 3LL * H;

  for (int j = threadIdx.x; j < H; j += blockDim.x) h[j] = 0.0f;
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    const float* xt = x3 + t * x_st + b * x_sb;
    const float m = mask[t * m_st + b * m_sb];

    // update and reset gates: columns [0, 2H) of w
    for (int j = threadIdx.x; j < 2 * H; j += blockDim.x) {
      const float* wj = w + j;
      float acc = 0.0f;
#pragma unroll 8
      for (int k = 0; k < H; ++k) acc = fmaf(h[k], wj[k * H3], acc);
      const float g = act_f32(act_gate, xt[j] + acc);
      if (j < H) {
        u[j] = g;
      } else {
        rh[j - H] = g * h[j - H];
      }
    }
    __syncthreads();

    // candidate, blend, masked output and carry: columns [2H, 3H) of w.
    // Thread j reads only rh[] and its own h[j], so h[j] is updated in place.
    for (int j = threadIdx.x; j < H; j += blockDim.x) {
      const float* wj = w + 2 * H + j;
      float acc = 0.0f;
#pragma unroll 8
      for (int k = 0; k < H; ++k) acc = fmaf(rh[k], wj[k * H3], acc);
      const float c = act_f32(act_in, xt[2 * H + j] + acc);
      const float hp = h[j];
      const float hn = u[j] * hp + (1.0f - u[j]) * c;
      ys[t * y_st + b * y_sb + j] = m * hn;
      h[j] = m * hn + (1.0f - m) * hp;
    }
    __syncthreads();
  }
}

}  // namespace

// x3 [T, B, 3H], mask [T, B] and ys [T, B, H] are addressed through their
// time and batch strides (in elements; the last dimension is contiguous);
// w [H, 3H] is contiguous; act_in and act_gate are act_f32 codes. Launches
// on `stream`, returns cudaGetLastError().
extern "C" int gru_fwd(const void* x3, long long x_st, long long x_sb,
                       const void* mask, long long m_st, long long m_sb,
                       const void* w, void* ys, long long y_st, long long y_sb,
                       int T, int B, int H, int reverse, int act_in, int act_gate,
                       void* stream) {
  const size_t smem = 3 * static_cast<size_t>(H) * sizeof(float);
  cudaError_t err = allow_smem(gru_fwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (T > 0 && B > 0 && H > 0) {
    gru_fwd_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x3), x_st, x_sb,
        static_cast<const float*>(mask), m_st, m_sb,
        static_cast<const float*>(w),
        static_cast<float*>(ys), y_st, y_sb, T, B, H, reverse, act_in, act_gate);
  }
  return static_cast<int>(cudaGetLastError());
}
