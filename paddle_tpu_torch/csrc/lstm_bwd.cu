// lstm_bwd — the backward of the masked peephole LSTM scan: dx4, dW and
// dpeep from the residuals of lstm_fwd_train.
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
//
// What the design does about that: the recurrence is the forward's shape
// turned around. A cluster of C blocks shares one tile of 16 batch rows and
// block c owns the hidden units [c U, (c+1) U): it computes its units' four
// gate gradients for the 16 rows, then its share of the next DH for every
// unit, P_c = dgates[:, own columns] . w[:, own columns]^T, reading only the
// own rows of a transposed copy of w (made once per launch, so the loads
// are coalesced). The shares are summed in a fixed rank order by the block
// that owns each unit, reading its peers' shares through distributed shared
// memory after one cluster barrier per step (the shares are double-
// buffered). DH, DC and the peephole sums stay in shared memory; dx4 is
// streamed to device memory. dW sums over all T * B rows, so the tiled
// contraction of atb_gemm.cuh forms it after the recurrence, and the
// per-tile peephole partials are summed there too in a fixed order:
// deterministic, no atomics, and no weight-gradient work on the sequential
// loop.

#include <cooperative_groups.h>

#include "atb_gemm.cuh"
#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 16;                    // batch rows per cluster
constexpr int kThreads = 256;
constexpr int kMaxCluster = 8;

__global__ void __launch_bounds__(kThreads)
lstm_bwd_kernel(const float* __restrict__ dy, long long dy_st, long long dy_sb,
                const float* __restrict__ acts, const float* __restrict__ cprev,
                const float* __restrict__ mask, long long m_st, long long m_sb,
                const float* __restrict__ wt, const float* __restrict__ peep,
                float* __restrict__ dx4, float* __restrict__ peep_part,
                int T, int B, int H, int U, int reverse,
                int act_in, int act_gate, int act_state) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int k0 = rank * U;                               // first own unit
  const int Uc = max(0, min(U, H - k0));                 // own units
  const int UR = U * kRows;
  const int HR = H * kRows;
  extern __shared__ float4 smem4[];
  float* part = reinterpret_cast<float*>(smem4);         // [2][H][kRows] DH shares
  float* dg = part + 2 * HR;                             // [4][U][kRows] own dgates
  float* DH = dg + 4 * UR;                               // [U][kRows]
  float* DC = DH + UR;                                   // [U][kRows]
  float* DHm = DC + UR;                                  // [U][kRows] (1 - m) DH
  float* pacc = DHm + UR;                                // [3][U][kRows] peephole sums
  const int row0 = blockIdx.y * kRows;
  const long long H4 = 4LL * H;

  for (int e = threadIdx.x; e < 10 * UR; e += blockDim.x) dg[e] = 0.0f;   // dg .. pacc
  cluster.sync();   // every block of the cluster runs and has zeroed its state

  for (int s = 0; s < T; ++s) {
    const int t = reverse ? s : T - 1 - s;
    float* pcur = part + (s & 1) * HR;

    // gate gradients of the own units, one (unit, row) item at a time
    for (int it = threadIdx.x; it < UR; it += blockDim.x) {
      const int u = it % U, r = it / U;
      const int k = k0 + u, b = row0 + r;
      if (u >= Uc) continue;
      const int q = u * kRows + r;
      if (b >= B) {
#pragma unroll
        for (int g = 0; g < 4; ++g) dg[g * UR + q] = 0.0f;
        continue;
      }
      const long long row = static_cast<long long>(t) * B + b;
      const float m = mask[t * m_st + b * m_sb];
      const float* ar = acts + row * H4 + k;
      const float a = ar[0], ig = ar[H], fg = ar[2 * H], og = ar[3 * H];
      const float cp = cprev[row * H + k];
      const float cn = fg * cp + ig * a;
      const float sc = act_f32(act_state, cn);
      const float dhv = DH[q], dcv = DC[q];
      const float dh = m * (dhv + dy[t * dy_st + b * dy_sb + k]);
      const float dgo = dh * sc * dact_f32(act_gate, og);
      const float dc = dh * og * dact_f32(act_state, sc) + m * dcv + dgo * peep[2 * H + k];
      const float dgi = dc * a * dact_f32(act_gate, ig);
      const float dgf = dc * cp * dact_f32(act_gate, fg);
      const float dga = dc * ig * dact_f32(act_in, a);
      float* dxr = dx4 + row * H4 + k;
      dxr[0] = dga;
      dxr[H] = dgi;
      dxr[2 * H] = dgf;
      dxr[3 * H] = dgo;
      dg[q] = dga;
      dg[UR + q] = dgi;
      dg[2 * UR + q] = dgf;
      dg[3 * UR + q] = dgo;
      DC[q] = dc * fg + dgi * peep[k] + dgf * peep[H + k] + (1.0f - m) * dcv;
      DHm[q] = (1.0f - m) * dhv;
      pacc[q] += dgi * cp;
      pacc[UR + q] += dgf * cp;
      pacc[2 * UR + q] += dgo * cn;
    }
    __syncthreads();

    // this block's share of the next DH for every unit kk:
    //   pcur[kk][r] = sum over own columns j of dg[j][r] * w[kk, j]
    for (int kk = threadIdx.x; kk < H; kk += blockDim.x) {
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
      for (int g = 0; g < 4; ++g) {
        const float* wrow = wt + (g * H + k0) * static_cast<long long>(H) + kk;
        const float* dgg = dg + g * UR;
#pragma unroll 2
        for (int u = 0; u < Uc; ++u) {
          const float wv = wrow[u * static_cast<long long>(H)];
          const float4* d = reinterpret_cast<const float4*>(dgg + u * kRows);
#pragma unroll
          for (int q4 = 0; q4 < kRows / 4; ++q4) {
            const float4 dv = d[q4];
            acc[4 * q4 + 0] = fmaf(dv.x, wv, acc[4 * q4 + 0]);
            acc[4 * q4 + 1] = fmaf(dv.y, wv, acc[4 * q4 + 1]);
            acc[4 * q4 + 2] = fmaf(dv.z, wv, acc[4 * q4 + 2]);
            acc[4 * q4 + 3] = fmaf(dv.w, wv, acc[4 * q4 + 3]);
          }
        }
      }
      float4* out = reinterpret_cast<float4*>(pcur + kk * kRows);
#pragma unroll
      for (int q4 = 0; q4 < kRows / 4; ++q4)
        out[q4] = make_float4(acc[4 * q4], acc[4 * q4 + 1], acc[4 * q4 + 2], acc[4 * q4 + 3]);
    }
    cluster.sync();   // every share of this step is written

    // DH of the own units: the C shares in rank order, plus (1 - m) DH
    for (int it = threadIdx.x; it < UR; it += blockDim.x) {
      const int u = it % U, r = it / U;
      if (u >= Uc) continue;
      const int q = u * kRows + r;
      float sum = 0.0f;
      for (int p = 0; p < C; ++p) sum += cluster.map_shared_rank(pcur, p)[(k0 + u) * kRows + r];
      DH[q] = sum + DHm[q];
    }
  }
  cluster.sync();   // no peer still reads this block's shares when it exits

  // this tile's peephole partials, each summed over its rows in order
  for (int e = threadIdx.x; e < 3 * Uc; e += blockDim.x) {
    const int g = e / Uc, u = e % Uc;
    const float* src = pacc + g * UR + u * kRows;
    float sum = 0.0f;
    for (int r = 0; r < kRows; ++r) sum += src[r];
    peep_part[blockIdx.y * 3LL * H + g * H + k0 + u] = sum;
  }
}

__global__ void transpose_kernel(const float* __restrict__ in, float* __restrict__ out,
                                 int rows, int cols) {
  __shared__ float tile[32][33];
  int x = blockIdx.x * 32 + threadIdx.x;
  int y = blockIdx.y * 32 + threadIdx.y;
  for (int i = 0; i < 32; i += 8)
    if (x < cols && y + i < rows) tile[threadIdx.y + i][threadIdx.x] = in[(y + i) * static_cast<long long>(cols) + x];
  __syncthreads();
  x = blockIdx.y * 32 + threadIdx.x;
  y = blockIdx.x * 32 + threadIdx.y;
  for (int i = 0; i < 32; i += 8)
    if (x < rows && y + i < cols) out[(y + i) * static_cast<long long>(rows) + x] = tile[threadIdx.x][threadIdx.y + i];
}

}  // namespace

// dy [T, B, H] and mask [T, B] are addressed through their time and batch
// strides (in elements; the last dimension is contiguous). acts [T, B, 4H],
// hprev, cprev [T, B, H] (the residuals of lstm_fwd_train), w [H, 4H], peep
// [3, H], and the outputs dx4 [T, B, 4H], dw [H, 4H] and dpeep [3, H] are
// contiguous. Scratch: wt [4H, H] and peep_part [ceil(B / 16), 3H] (any
// buffer of at least that many rows). `reverse` and act_* are the
// forward's. H <= 1024. Launches the transposed copy of w, the reversed-time
// recurrence and the two contractions on `stream`; returns
// cudaGetLastError() (or the first launch error).
extern "C" int lstm_bwd(const void* dy, long long dy_st, long long dy_sb,
                        const void* acts, const void* hprev, const void* cprev,
                        const void* mask, long long m_st, long long m_sb,
                        const void* w, const void* peep,
                        void* dx4, void* dw, void* dpeep, void* wt, void* peep_part,
                        int T, int B, int H, int reverse,
                        int act_in, int act_gate, int act_state, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int C = (H + 63) / 64;
  C = C < 1 ? 1 : (C > kMaxCluster ? kMaxCluster : C);
  const int U = (H + C - 1) / C;
  const size_t smem = (2 * static_cast<size_t>(H) + 10 * static_cast<size_t>(U)) * kRows * sizeof(float);
  cudaError_t err = allow_smem(lstm_bwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (H <= 0) return static_cast<int>(cudaGetLastError());
  const int tiles = (B + kRows - 1) / kRows;
  float* wtp = static_cast<float*>(wt);
  float* part = static_cast<float*>(peep_part);
  if (T > 0 && B > 0) {
    transpose_kernel<<<dim3((4 * H + 31) / 32, (H + 31) / 32), dim3(32, 8), 0, st>>>(
        static_cast<const float*>(w), wtp, H, 4 * H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    err = launch_cluster(lstm_bwd_kernel, dim3(C, tiles), dim3(kThreads), smem, st, C,
                         static_cast<const float*>(dy), dy_st, dy_sb,
                         static_cast<const float*>(acts), static_cast<const float*>(cprev),
                         static_cast<const float*>(mask), m_st, m_sb,
                         static_cast<const float*>(wtp), static_cast<const float*>(peep),
                         static_cast<float*>(dx4), part, T, B, H, U, reverse,
                         act_in, act_gate, act_state);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int N = T * B;
  // dW = hprev^T . dx4 over all N rows (zero when N = 0)
  err = atb(static_cast<const float*>(hprev), H, nullptr, 0,
            static_cast<const float*>(dx4), 4LL * H, static_cast<float*>(dw), 4LL * H,
            N, H, 4 * H, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  // dpeep = the column sums of the tiles' partials
  return static_cast<int>(atb(nullptr, 0, nullptr, 0, part, 3LL * H,
                              static_cast<float*>(dpeep), 3LL * H,
                              T > 0 ? tiles : 0, 1, 3 * H, st));
}
