// Helpers shared by the paddle_tpu_torch kernels. Plain C interface: no
// PyTorch headers, so each source builds with nvcc in seconds.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// The operand types of the kernels with a bf16 instance (the GRU and
// attention-GRU bodies): S is float or __nv_bfloat16. Operands are widened
// to float on load and every sum runs in float32; a value stored in S is
// rounded to the nearest (ties to even), as the JAX package's astype rounds.
template <typename S>
struct IsF32 {
  static constexpr bool value = false;
};
template <>
struct IsF32<float> {
  static constexpr bool value = true;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename S>
__device__ __forceinline__ S from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to bf16 and widened again: the value a bf16 operand of a
// product holds (the Pallas kernels' astype(bf16) before their dots).
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// x as two bf16 pieces: hi = x rounded to bf16, lo = (x - hi) rounded to
// bf16. x - hi is exact in float32, so hi + lo keeps ~16 significant bits of
// x (bf16 has float32's exponent range: no scaling).
__device__ __forceinline__ void split_bf16(float x, __nv_bfloat16& hi, __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(x);
  lo = __float2bfloat16_rn(x - __bfloat162float(hi));
}

// Loads and stores through L2 (data other blocks of the launch wrote or
// read), in either operand type.
__device__ __forceinline__ float ldcg_f32(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ldcg_f32(const __nv_bfloat16* p) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p))));
}
__device__ __forceinline__ void stcg_as(float* p, float v) { __stcg(p, v); }
__device__ __forceinline__ void stcg_as(__nv_bfloat16* p, float v) {
  __stcg(reinterpret_cast<unsigned short*>(p), __bfloat16_as_ushort(__float2bfloat16_rn(v)));
}

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

// One element of a weight slice into shared memory as float: a float by
// cp.async (wait with cp_async_commit / cp_async_wait as above), a bf16
// widened through a register.
__device__ __forceinline__ void stage_f32(float* smem_dst, const float* gmem_src) {
  cp_async4(smem_dst, gmem_src);
}
__device__ __forceinline__ void stage_f32(float* smem_dst, const __nv_bfloat16* gmem_src) {
  *smem_dst = __bfloat162float(*gmem_src);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
