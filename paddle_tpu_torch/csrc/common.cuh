// Helpers shared by the paddle_tpu_torch kernels. Plain C interface: no
// PyTorch headers, so each source builds with nvcc in seconds.
#pragma once

#include <cuda_runtime.h>

// The activation pair the GRU kernels take: act_gate = sigmoid,
// act_in = tanh (the config DSL's defaults for gated_recurrent/gru_step).
__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Kernels above 48 KB of dynamic shared memory must opt in first.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}
