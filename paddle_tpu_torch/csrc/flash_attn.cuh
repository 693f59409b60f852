// The semantics the flash-attention kernels share (flash_attn_fwd.cu,
// flash_attn_bwd.cu): their strided operand types, the JAX package's mask
// and -1e30, the length clamp and the softmax scale, and the bf16 Hopper
// bodies' tensor map of an operand. Their tensor-core machinery is
// flash_mma.cuh's (mma.sync) and hopper.cuh's (wgmma, TMA).
#pragma once

#include <cuda_runtime.h>

#include <cmath>

#include "common.cuh"
#include "hopper.cuh"

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

// 2^x on the MUFU unit, a subnormal result flushed to zero: the softmax's
// p = 2^(s - m) <= 1, where a term below 2^-126 adds nothing to a float32
// sum that holds a 1. exp2f would add a fix-up of subnormal results that
// waits on each MUFU result.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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

// The tensor map of a strided [B, T, H, D] bf16 operand for the Hopper
// bodies: dims (D, H, T, B), a box of 64 features of `rows` rows of one
// (batch, head), read as one [rows][64] image per 64 features.
inline bool operand_map(CUtensorMap* map, const void* p, long long sb, long long st,
                        long long sh, int B, int T, int H, int D, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(T), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2, static_cast<cuuint64_t>(st) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  return hopper::tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p, 4, dims, strides, box);
}

// Phase clocks of the Hopper bodies, for tools/flash_sm90_phases.py, which
// builds them with -DFLASH_SM90_PHASES: thread 0 of each warpgroup of the
// block that `pick` names records clock64() at boundary k (0-5) of its tile
// `tile` (< 64), read back by phase_clocks(). Nothing in any other build.
#ifdef FLASH_SM90_PHASES
__device__ long long g_phase_clock[2][64][8];
#define FLASH_SM90_PHASE(pick, wg, tile, k)                                  \
  do {                                                                       \
    if ((pick) && threadIdx.x % 128 == 0 && (tile) < 64)                     \
      flash::g_phase_clock[wg][tile][k] = clock64();                         \
  } while (0)
#else
#define FLASH_SM90_PHASE(pick, wg, tile, k) \
  do {                                      \
  } while (0)
#endif

}  // namespace flash

#ifdef FLASH_SM90_PHASES
extern "C" int phase_clocks(void* dst) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(dst, flash::g_phase_clock, sizeof(flash::g_phase_clock)));
}

// Zero the clocks, so that the next body's read holds only its own tiles.
extern "C" int phase_clocks_reset() {
  static const long long zeros[2][64][8] = {};
  return static_cast<int>(cudaMemcpyToSymbol(flash::g_phase_clock, zeros, sizeof(zeros)));
}
#endif
