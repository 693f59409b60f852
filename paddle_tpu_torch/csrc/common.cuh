// Helpers shared by the paddle_tpu_torch kernels. Plain C interface: no
// PyTorch headers, so each source builds with nvcc in seconds.
#pragma once

#include <cuda_runtime.h>

// The sigmoid of act_f32, and the gate activation of the attention-GRU
// kernels (which take only the DSL's defaults: sigmoid gates, tanh input).
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

// The activations the LSTM and GRU kernels take in each of their slots, by
// the codes the Python wrappers pass: 0 tanh, 1 sigmoid, 2 relu, 3 linear.
__device__ __forceinline__ float act_f32(int kind, float x) {
  switch (kind) {
    case 0: return tanhf(x);
    case 1: return sigmoid_f32(x);
    case 2: return fmaxf(x, 0.0f);
    default: return x;
  }
}

// Its derivative from the saved post-activation value y = act(x).
__device__ __forceinline__ float dact_f32(int kind, float y) {
  switch (kind) {
    case 0: return 1.0f - y * y;
    case 1: return y * (1.0f - y);
    case 2: return y > 0.0f ? 1.0f : 0.0f;
    default: return 1.0f;
  }
}

// Asynchronous 4-byte copies from device to shared memory (cp.async), for
// staging a weight slice while the previous one is in use: issue copies,
// close the group with cp_async_commit(), and cp_async_wait<N>() until at
// most N of this thread's groups are still in flight.
__device__ __forceinline__ void cp_async4(float* smem_dst, const float* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem_src) : "memory");
}

// The same for 16 bytes, bypassing L1 (data other SMs wrote): the first
// `bytes` (0 to 16) are read and the rest of the 16 zero-filled.
__device__ __forceinline__ void cp_async16_cg_part(float* smem_dst, const float* gmem_src,
                                                   int bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem_src),
               "r"(bytes) : "memory");
}

// All 16 bytes, or with `valid` false none read and all zero-filled.
__device__ __forceinline__ void cp_async16_cg(float* smem_dst, const float* gmem_src,
                                              bool valid) {
  cp_async16_cg_part(smem_dst, gmem_src, valid ? 16 : 0);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
