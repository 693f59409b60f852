// The semantics the flash-attention kernels share (flash_attn_fwd.cu,
// flash_attn_bwd.cu): their strided operand types, the JAX package's mask
// and -1e30, the length clamp and the softmax scale. Their tensor-core
// machinery is flash_mma.cuh's.
#pragma once

#include <cuda_runtime.h>

#include <cmath>

#include "common.cuh"

namespace flash {

constexpr float kNeg = -1e30f;         // the JAX package's _NEG
constexpr unsigned kFull = 0xffffffffu;

// Strided [B, T, H, D] operand with a contiguous last dimension, of
// storage type S (float or __nv_bfloat16).
template <typename S>
struct Operand {
  const S* ptr;
  long long sb, st, sh;
  __device__ __forceinline__ const S* head(int b, int h) const {
    return ptr + b * sb + h * sh;
  }
};

template <typename S>
struct Output {
  S* ptr;
  long long sb, st, sh;
  __device__ __forceinline__ S* head(int b, int h) const { return ptr + b * sb + h * sh; }
};

// The JAX package's mask (_mask): key kp is visible to query qp when it lies
// before the length and, with `causal`, not after the query.
__device__ __forceinline__ bool visible(int qp, int kp, int len, int causal) {
  return kp < len && (!causal || kp <= qp);
}

__device__ __forceinline__ int clamp_length(const int* lengths, int b, int T) {
  const int len = lengths[b];
  return len < 0 ? 0 : (len > T ? T : len);
}

// The JAX package's scale, 1 / sqrt(D) rounded once to float.
inline float softmax_scale(int D) {
  return static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
}

// Whether the scale is a power of two (D a power of 4: 16, 64, 256), so
// that q * scale of a bf16 q is exact in TF32 too.
inline bool scale_is_pow2(int D) {
  int e = 0;
  return std::frexp(static_cast<double>(softmax_scale(D)), &e) == 0.5;
}

}  // namespace flash
