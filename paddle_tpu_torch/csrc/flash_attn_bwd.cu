// flash_attn_dq / flash_attn_dkv — the backward of flash_attn_fwd, scores
// recomputed from the saved log-sum-exp, FlashAttention-2's split in two
// kernels as the JAX package's.
//
// Replaces: paddle_tpu/ops/pallas_attention.py _dq_kernel (flash_attn_dq)
// and _dkv_kernel (flash_attn_dkv), both launched by pl.pallas_call in
// _run_bwd, the custom-VJP backward of the JAX package's flash attention.
// With scale = 1 / sqrt(D), the mask of flash_attn_fwd, lse from it and
// delta[q] = sum_d dout[q, d] out[q, d] (computed by the caller, as the JAX
// package computes it outside its kernels):
//   s  = (q . k) scale             p  = exp(s - lse[q]) where visible else 0
//   dp = dout . v                  ds = p (dp - delta[q]) scale
//   dq = sum_k ds k                dk = sum_q ds q        dv = sum_q p dout
// The mask is applied to p explicitly: at a query that sees no key
// s = lse = -1e30 and exp(s - lse) would be 1.
//
// What bounds them on an H100: at B = 8, H = 8, T = 2048, D = 64, causal,
// dq does 3 B H T^2 D = 51.5 GFLOP (0.769 ms at 67 TFLOP/s float32) on
// ~169 MB, dkv 4 B H T^2 D = 68.7 GFLOP (1.025 ms) on ~202 MB: operations
// bound both.
//
// Design: flash_attn_dq runs one block per (query tile, head, batch row) and
// walks the key tiles up to the tile's last query and the length, as the
// forward does; flash_attn_dkv one block per (key tile, head, batch row),
// walking the query tiles from the one holding the tile's first key (causal)
// to the end. A key tile wholly at or past the length gets dk = dv = 0 and
// reads nothing. Each block writes only its own rows, summing over the
// streamed tiles in order: no atomics, two launches give equal bits.

#include "flash_attn.cuh"

namespace {

using flash::Operand;
using flash::Output;

template <int RM, int DMAX>
__global__ void __launch_bounds__(flash::kThreads)
flash_dq_kernel(Operand q, Operand k, Operand v, Operand dout, const float* __restrict__ lse,
                const float* __restrict__ delta, const int* __restrict__ lengths, Output dq,
                int T, int H, int D, int causal, float scale) {
  constexpr int R = 16 * RM;
  constexpr int C = flash::kC;
  constexpr int LD = flash::Dims<DMAX>::LD;
  constexpr int NJD = flash::Dims<DMAX>::NJD;
  extern __shared__ float smem[];
  float* sq = smem;                       // [R][LD]
  float* sdo = sq + R * LD;               // [R][LD]
  float* sk = sdo + R * LD;               // [C][LD]
  float* sv = sk + C * LD;                // [C][LD]

  const int iq = gridDim.x - 1 - blockIdx.x;   // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = iq * R;
  const int len = flash::clamp_length(lengths, b, T);
  const int lane = threadIdx.x % 32;
  const int cg = lane % 8;
  const int r0 = (threadIdx.x / 32) * 4 * RM + (lane / 8) * RM;
  const long long stat = (static_cast<long long>(b) * H + h) * T;

  flash::load_tile<DMAX>(sq, q.head(b, h), q.st, q0, R, T, D, 1.0f);
  flash::load_tile<DMAX>(sdo, dout.head(b, h), dout.st, q0, R, T, D, 1.0f);
  float acc[RM][NJD], row_lse[RM], row_delta[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qp = q0 + r0 + i;
    row_lse[i] = qp < T ? lse[stat + qp] : 0.0f;
    row_delta[i] = qp < T ? delta[stat + qp] : 0.0f;
#pragma unroll
    for (int jd = 0; jd < NJD; ++jd) acc[i][jd] = 0.0f;
  }
  const int kend = causal ? min(len, q0 + R) : len;
  const int tiles = (kend + C - 1) / C;
  for (int it = 0; it < tiles; ++it) {
    const int k0 = it * C;
    __syncthreads();
    flash::load_tile<DMAX>(sk, k.head(b, h), k.st, k0, C, T, D, 1.0f);
    flash::load_tile<DMAX>(sv, v.head(b, h), v.st, k0, C, T, D, 1.0f);
    __syncthreads();
    float s[RM][flash::kNJ], dp[RM][flash::kNJ];
    flash::score_tile<RM, DMAX>(s, sq, sk, r0, cg);
    flash::score_tile<RM, DMAX>(dp, sdo, sv, r0, cg);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qp = q0 + r0 + i;
#pragma unroll
      for (int j = 0; j < flash::kNJ; ++j) {
        const float p = flash::visible(qp, k0 + cg + 8 * j, len, causal)
                            ? expf(s[i][j] * scale - row_lse[i]) : 0.0f;
        s[i][j] = p * (dp[i][j] - row_delta[i]) * scale;      // ds
      }
    }
    flash::accumulate_tile<RM, DMAX>(acc, s, sk, lane, cg);
  }
  flash::store_rows<RM, DMAX>(dq.head(b, h), dq.st, acc, q0, r0, cg, T, D);
}

template <int RM, int DMAX>
__global__ void __launch_bounds__(flash::kThreads)
flash_dkv_kernel(Operand q, Operand k, Operand v, Operand dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, const int* __restrict__ lengths, Output dk,
                 Output dv, int T, int H, int D, int causal, float scale) {
  constexpr int R = 16 * RM;
  constexpr int C = flash::kC;
  constexpr int LD = flash::Dims<DMAX>::LD;
  constexpr int NJD = flash::Dims<DMAX>::NJD;
  extern __shared__ float smem[];
  float* sk = smem;                       // [R][LD]
  float* sv = sk + R * LD;                // [R][LD]
  float* sq = sv + R * LD;                // [C][LD]
  float* sdo = sq + C * LD;               // [C][LD]
  float* slse = sdo + C * LD;             // [C]
  float* sdelta = slse + C;               // [C]

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = blockIdx.x * R;          // the first key tiles see the most queries
  const int len = flash::clamp_length(lengths, b, T);
  const int lane = threadIdx.x % 32;
  const int cg = lane % 8;
  const int r0 = (threadIdx.x / 32) * 4 * RM + (lane / 8) * RM;
  const long long stat = (static_cast<long long>(b) * H + h) * T;

  float acc_k[RM][NJD], acc_v[RM][NJD];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int jd = 0; jd < NJD; ++jd) acc_k[i][jd] = acc_v[i][jd] = 0.0f;
  if (k0 < len) {                         // else every key of the tile is masked
    flash::load_tile<DMAX>(sk, k.head(b, h), k.st, k0, R, T, D, 1.0f);
    flash::load_tile<DMAX>(sv, v.head(b, h), v.st, k0, R, T, D, 1.0f);
    const int tiles = (T + C - 1) / C;
    for (int it = causal ? k0 / C : 0; it < tiles; ++it) {
      const int t0 = it * C;
      __syncthreads();
      flash::load_tile<DMAX>(sq, q.head(b, h), q.st, t0, C, T, D, 1.0f);
      flash::load_tile<DMAX>(sdo, dout.head(b, h), dout.st, t0, C, T, D, 1.0f);
      for (int c = threadIdx.x; c < C; c += flash::kThreads) {
        const int qp = t0 + c;
        slse[c] = qp < T ? lse[stat + qp] : 0.0f;
        sdelta[c] = qp < T ? delta[stat + qp] : 0.0f;
      }
      __syncthreads();
      float s[RM][flash::kNJ], dp[RM][flash::kNJ];
      flash::score_tile<RM, DMAX>(s, sk, sq, r0, cg);        // (q . k)^T
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int kp = k0 + r0 + i;
#pragma unroll
        for (int j = 0; j < flash::kNJ; ++j) {
          const int c = cg + 8 * j;
          const int qp = t0 + c;
          s[i][j] = qp < T && flash::visible(qp, kp, len, causal)
                        ? expf(s[i][j] * scale - slse[c]) : 0.0f;   // p^T
        }
      }
      flash::accumulate_tile<RM, DMAX>(acc_v, s, sdo, lane, cg);  // dv += p^T dout
      flash::score_tile<RM, DMAX>(dp, sv, sdo, r0, cg);       // (dout . v)^T
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < flash::kNJ; ++j) {
          const int c = cg + 8 * j;
          s[i][j] = s[i][j] * (dp[i][j] - sdelta[c]) * scale;  // ds^T
        }
      flash::accumulate_tile<RM, DMAX>(acc_k, s, sq, lane, cg);   // dk += ds^T q
    }
  }
  flash::store_rows<RM, DMAX>(dk.head(b, h), dk.st, acc_k, k0, r0, cg, T, D);
  flash::store_rows<RM, DMAX>(dv.head(b, h), dv.st, acc_v, k0, r0, cg, T, D);
}

template <int RM, int DMAX>
int launch_dq(Operand q, Operand k, Operand v, Operand dout, const float* lse,
              const float* delta, const int* lengths, Output dq, int B, int T, int H, int D,
              int causal, cudaStream_t stream) {
  constexpr int R = 16 * RM;
  const size_t smem =
      static_cast<size_t>(2 * R + 2 * flash::kC) * flash::Dims<DMAX>::LD * sizeof(float);
  cudaError_t err = allow_smem(flash_dq_kernel<RM, DMAX>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + R - 1) / R, H, B);
  flash_dq_kernel<RM, DMAX><<<grid, flash::kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, lengths, dq, T, H, D, causal, flash::softmax_scale(D));
  return static_cast<int>(cudaGetLastError());
}

template <int RM, int DMAX>
int launch_dkv(Operand q, Operand k, Operand v, Operand dout, const float* lse,
               const float* delta, const int* lengths, Output dk, Output dv, int B, int T,
               int H, int D, int causal, cudaStream_t stream) {
  constexpr int R = 16 * RM;
  const size_t smem =
      (static_cast<size_t>(2 * R + 2 * flash::kC) * flash::Dims<DMAX>::LD + 2 * flash::kC) *
      sizeof(float);
  cudaError_t err = allow_smem(flash_dkv_kernel<RM, DMAX>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + R - 1) / R, H, B);
  flash_dkv_kernel<RM, DMAX><<<grid, flash::kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, lengths, dk, dv, T, H, D, causal, flash::softmax_scale(D));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, dout, dq, dk and dv [B, T, H, D] through their batch, time and
// head strides (in elements; the last dimension contiguous); lse and delta
// [B, H, T] contiguous; lengths [B] int32. 1 <= D <= 256, T >= 1, H and
// B <= 65535. Launch on `stream`, return cudaGetLastError() (or the launch's
// own error).
extern "C" int flash_attn_dq(const void* q, long long q_sb, long long q_st, long long q_sh,
                             const void* k, long long k_sb, long long k_st, long long k_sh,
                             const void* v, long long v_sb, long long v_st, long long v_sh,
                             const void* dout, long long g_sb, long long g_st, long long g_sh,
                             const void* lse, const void* delta, const void* lengths,
                             void* dq, long long d_sb, long long d_st, long long d_sh,
                             int B, int T, int H, int D, int causal, void* stream) {
  const Operand oq{static_cast<const float*>(q), q_sb, q_st, q_sh};
  const Operand okk{static_cast<const float*>(k), k_sb, k_st, k_sh};
  const Operand ov{static_cast<const float*>(v), v_sb, v_st, v_sh};
  const Operand og{static_cast<const float*>(dout), g_sb, g_st, g_sh};
  const Output od{static_cast<float*>(dq), d_sb, d_st, d_sh};
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_DQ(RM, DMAX) \
  launch_dq<RM, DMAX>(oq, okk, ov, og, l, dl, len, od, B, T, H, D, causal, s)
  if (D <= 16) return FLASH_DQ(4, 16);
  if (D <= 32) return FLASH_DQ(4, 32);
  if (D <= 64) return FLASH_DQ(4, 64);
  if (D <= 128) return FLASH_DQ(2, 128);
  if (D <= 256) return FLASH_DQ(1, 256);
#undef FLASH_DQ
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int flash_attn_dkv(const void* q, long long q_sb, long long q_st, long long q_sh,
                              const void* k, long long k_sb, long long k_st, long long k_sh,
                              const void* v, long long v_sb, long long v_st, long long v_sh,
                              const void* dout, long long g_sb, long long g_st, long long g_sh,
                              const void* lse, const void* delta, const void* lengths,
                              void* dk, long long dk_sb, long long dk_st, long long dk_sh,
                              void* dv, long long dv_sb, long long dv_st, long long dv_sh,
                              int B, int T, int H, int D, int causal, void* stream) {
  const Operand oq{static_cast<const float*>(q), q_sb, q_st, q_sh};
  const Operand okk{static_cast<const float*>(k), k_sb, k_st, k_sh};
  const Operand ov{static_cast<const float*>(v), v_sb, v_st, v_sh};
  const Operand og{static_cast<const float*>(dout), g_sb, g_st, g_sh};
  const Output odk{static_cast<float*>(dk), dk_sb, dk_st, dk_sh};
  const Output odv{static_cast<float*>(dv), dv_sb, dv_st, dv_sh};
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_DKV(RM, DMAX) \
  launch_dkv<RM, DMAX>(oq, okk, ov, og, l, dl, len, odk, odv, B, T, H, D, causal, s)
  if (D <= 16) return FLASH_DKV(4, 16);
  if (D <= 32) return FLASH_DKV(4, 32);
  if (D <= 64) return FLASH_DKV(4, 64);
  if (D <= 128) return FLASH_DKV(2, 128);
  if (D <= 256) return FLASH_DKV(1, 256);
#undef FLASH_DKV
  return static_cast<int>(cudaErrorInvalidValue);
}
