// gru_bwd — the backward of the masked GRU scan: dx3 and dW from the
// residuals of gru_fwd_train.
//
// Replaces: paddle_tpu/ops/pallas_gru.py _bwd_kernel (launched by
// pl.pallas_call in _run_bwd, the custom-VJP backward of fused_gru), which
// walks time backwards carrying dh in VMEM and accumulates dW there.
//
// Per step, walked in the opposite order of the forward (t = T-1 .. 0, or
// 0 .. T-1 for a reversed sequence), with DH the gradient carried into the
// step's output carry, m = mask[t, b] and (u, r, c, h_prev) the residuals:
//   dh     = m * (DH + dy[t])                       (a padded step passes DH on)
//   du     = dh * (h_prev - c)
//   dcand  = dh * (1 - u) * (1 - c^2)
//   drh    = dcand . Wc^T                            Wc = w[:, 2H:]
//   dg     = [du * u(1-u) | drh * h_prev * r(1-r)]
//   dx3[t] = [dg | dcand]
//   DH     = dh * u + drh * r + dg . Wg^T + (1 - m) * DH      Wg = w[:, :2H]
// and, over every row n = (t, b):
//   dW[:, :2H] = h_prev^T . dg        dW[:, 2H:] = (r * h_prev)^T . dcand
//
// What bounds it on an H100: as the forward, the time loop is sequential and
// every step reads all of w (3 MB at H = 512) per batch row, now twice (by
// rows, for the two transposed products), so the L2 read rate limits the
// recurrence. The function's own cost (dy, the residuals, w, dx3, dW: about
// 40 MB; 6.4 GFLOP at T = 32, B = 64, H = 512) is bounded by operations,
// some 0.1 ms at the 67 TFLOP/s float32 rate.
//
// What the design does about that: one thread block per batch row carries
// DH in shared memory over the whole reversed loop; the two products with
// w^T give each warp one row of w at a time, read as coalesced lines and
// summed with shuffles. dW sums over all T*B rows, so instead of atomics
// into one [H, 3H] buffer a second kernel (atb_gemm.cuh, a tiled
// shared-memory product) contracts h_prev and r*h_prev (rebuilt from the
// saved r and h_prev as it loads them) against dx3 — deterministic, and
// the sequential loop carries no weight-gradient work.

#include "atb_gemm.cuh"
#include "common.cuh"

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
gru_bwd_kernel(const float* __restrict__ dy, long long dy_st, long long dy_sb,
               const float* __restrict__ acts, const float* __restrict__ hprev,
               const float* __restrict__ mask, long long m_st, long long m_sb,
               const float* __restrict__ w, float* __restrict__ dx3,
               int T, int B, int H, int reverse) {
  extern __shared__ float smem[];
  float* DH = smem;              // [H]  gradient carried into the step's carry
  float* dh = DH + H;            // [H]  gradient of the step's new state
  float* dcand = dh + H;         // [H]  candidate pre-activation gradient
  float* drh = dcand + H;        // [H]  gradient of r * h_prev
  float* dg = drh + H;           // [2H] gate pre-activation gradients
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const long long H3 = 3LL * H;

  for (int j = threadIdx.x; j < H; j += blockDim.x) DH[j] = 0.0f;
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const int t = reverse ? s : T - 1 - s;
    const long long row = static_cast<long long>(t) * B + b;
    const float m = mask[t * m_st + b * m_sb];
    const float* a = acts + row * H3;          // [u | r | c]
    const float* hp = hprev + row * H;
    const float* dyt = dy + t * dy_st + b * dy_sb;

    for (int j = threadIdx.x; j < H; j += blockDim.x) {
      const float d = m * (DH[j] + dyt[j]);
      const float u = a[j], c = a[2 * H + j];
      dh[j] = d;
      dcand[j] = d * (1.0f - u) * (1.0f - c * c);
      dg[j] = d * (hp[j] - c) * u * (1.0f - u);
    }
    __syncthreads();

    // drh[k] = sum_j dcand[j] * w[k, 2H + j]: one warp per row k of w
    for (int k = warp; k < H; k += nwarps) {
      const float* wk = w + k * H3 + 2 * H;
      float part = 0.0f;
      for (int j = lane; j < H; j += 32) part = fmaf(dcand[j], wk[j], part);
      part = warp_sum(part);
      if (lane == 0) drh[k] = part;
    }
    __syncthreads();

    float* dxt = dx3 + row * H3;
    for (int j = threadIdx.x; j < H; j += blockDim.x) {
      const float r = a[H + j];
      const float dgr = drh[j] * hp[j] * r * (1.0f - r);
      dg[H + j] = dgr;
      dxt[j] = dg[j];
      dxt[H + j] = dgr;
      dxt[2 * H + j] = dcand[j];
    }
    __syncthreads();

    // DH[k] = dh[k] u[k] + drh[k] r[k] + sum_j dg[j] w[k, j] + (1 - m) DH[k]
    for (int k = warp; k < H; k += nwarps) {
      const float* wk = w + k * H3;
      float part = 0.0f;
      for (int j = lane; j < 2 * H; j += 32) part = fmaf(dg[j], wk[j], part);
      part = warp_sum(part);
      if (lane == 0) DH[k] = dh[k] * a[k] + drh[k] * a[H + k] + part + (1.0f - m) * DH[k];
    }
    __syncthreads();
  }
}

}  // namespace

// dy [T, B, H] and mask [T, B] are addressed through their time and batch
// strides (in elements; the last dimension is contiguous). acts [T, B, 3H],
// hprev [T, B, H] (the residuals of gru_fwd_train), w [H, 3H], and the
// outputs dx3 [T, B, 3H] and dw [H, 3H] are contiguous. `reverse` is the
// forward's. Launches the reversed-time recurrence and then the dW
// contraction on `stream`; returns cudaGetLastError().
extern "C" int gru_bwd(const void* dy, long long dy_st, long long dy_sb,
                       const void* acts, const void* hprev,
                       const void* mask, long long m_st, long long m_sb,
                       const void* w, void* dx3, void* dw,
                       int T, int B, int H, int reverse, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = 6 * static_cast<size_t>(H) * sizeof(float);
  cudaError_t err = allow_smem(gru_bwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (T > 0 && B > 0 && H > 0) {
    gru_bwd_kernel<<<B, kThreads, smem, st>>>(
        static_cast<const float*>(dy), dy_st, dy_sb,
        static_cast<const float*>(acts), static_cast<const float*>(hprev),
        static_cast<const float*>(mask), m_st, m_sb,
        static_cast<const float*>(w), static_cast<float*>(dx3), T, B, H, reverse);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const float* hp = static_cast<const float*>(hprev);
  const float* a = static_cast<const float*>(acts);
  const float* dx = static_cast<const float*>(dx3);
  float* dW = static_cast<float*>(dw);
  const int N = T * B;
  const long long H3 = 3LL * H;
  // dWg = h_prev^T . dg (columns [0, 2H)); dWc = (r * h_prev)^T . dcand
  err = atb(hp, H, nullptr, 0, dx, H3, dW, H3, N, H, 2 * H, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(atb(hp, H, a + H, H3, dx + 2 * H, H3, dW + 2 * H, H3, N, H, H, st));
}
