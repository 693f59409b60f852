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

// Strided [B, T, H, D] operand with a contiguous last dimension.
struct Operand {
  const float* ptr;
  long long sb, st, sh;
  __device__ __forceinline__ const float* head(int b, int h) const {
    return ptr + b * sb + h * sh;
  }
};

struct Output {
  float* ptr;
  long long sb, st, sh;
  __device__ __forceinline__ float* head(int b, int h) const { return ptr + b * sb + h * sh; }
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

}  // namespace flash
