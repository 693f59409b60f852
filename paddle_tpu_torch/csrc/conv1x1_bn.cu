// conv1x1_stats — kernel 9: a 1x1 stride-1 convolution over NHWC pixel rows
// with the per-channel batch-norm statistics of its output.
//
// Replaces paddle_tpu/ops/pallas_conv1x1_bn.py::_kernel (pallas_call in _run):
//
//   y[m, n] = sum_k x[m, k] * w[n, k] + b[n]        (accumulated in float32)
//   s[n]    = sum_m y[m, n]
//   q[n]    = sum_m y[m, n]^2                        (of the stored y)
//
//   x [M, K]  row-major: the [B*H*W, C] view of a contiguous NHWC activation
//   w [N, K]  row-major: the conv parameter as stored (OIHW flattened), so
//             the product is x . w^T and no transposed copy is made
//   b [N]     or null (ResNet's convs have no bias)
//
// What bounds it on an H100: at ResNet-50's shapes (M = 4,096 .. 207,936
// rows, K and N 64 .. 2048) 1.7-6.8 GFLOP against 35-266 MB a launch. On the
// CUDA cores (67 TFLOP/s float32) operations bound every shape; the first
// design, a register-tiled SGEMM there, ran a train step's 30 launches at
// 2.2-2.7x that bound and lost to cuBLAS's. On the tensor cores, with the
// three TF32 products of the float32-accurate split (flash_mma.cuh) at 495
// TFLOP/s, the stage-2 shapes (K or N = 64, 207,936 rows) are bound by their
// bytes (3.35 TB/s) and the rest by operations: 1.57 ms a step together.
//
// Design:
//  1. conv1x1_split_w: w is split once per launch into big and small halves
//     (TF32 big = w rounded, small = w - big), stored as [2][N][Kp] in
//     scratch with K zero-padded to Kp, a multiple of 32.
//  2. conv1x1_stats_tile: persistent blocks of two warpgroups. Block (p, nt)
//     owns the columns [nt BN, nt BN + BN) and walks the row tiles p, p + P,
//     ... of 128 rows. Per tile and per slice of 32 features, thread 0 fills
//     one stage of a ring in shared memory, STAGES - 1 slices ahead: the x
//     tile [128][32] and both halves of w [BN][32], by TMA with the 128-byte
//     swizzle, completing on the stage's mbarrier; it refills a stage once
//     both warpgroups have released it. Each warpgroup owns 64 rows of the
//     tile: it reads its A fragments of x from
//     the stage (conflict-free through the swizzle), splits them in
//     registers, and issues wgmma m64nBNk8 TF32 with A from registers and B
//     from the stage's w halves: small(x) big(w) + big(x) small(w) +
//     big(x) big(w) per 8 features. The tensor core truncates as it
//     accumulates, so each slice is summed apart (12 passes) and added to
//     the tile's accumulator with rounded float32 adds. The epilogue stages
//     the tile through shared memory, adds b, writes y with coalesced
//     16-byte stores, and adds the stored values and their squares into
//     per-thread column sums that stay in registers across the block's row
//     tiles. At the end the block sums its threads' column sums in a fixed
//     order into one partial row: part[p, 0 | 1, n].
//  3. conv1x1_stats_reduce sums the partials over p, 32 columns a block,
//     each of 32 warps a fixed subset of p, then the warp sums in order.
// No atomics anywhere, so two launches give the same bits. Ragged edges
// (M, N and K not multiples of the tile) are zeros in the stages and masked
// in the epilogue; rows past M add nothing to the statistics. Where TMA
// cannot read x (K % 4 != 0, or x not 16-byte aligned) warp 0 fills the
// same swizzled stage with 4-byte cp.async copies instead.
//
// The bf16 instance (conv1x1_stats_bf16) keeps the Pallas kernel's bf16
// contract: x, w and b bf16, the product accumulated in float32, b added
// widened, y rounded to bf16 and stored, s and q float32 sums of the
// rounded y. The same persistent tile body, templated on the storage type
// S: a stage holds 64 bf16 features (one 128-byte swizzle row, as 32
// floats do), x and w go through TMA as bf16 (w as stored, [N][K]: no
// split launch and no scratch copy), and each 16 features are one
// wgmma m64nBNk16 bf16 pass with both operands from shared memory. Its
// products are exact in float32, so one pass meets the contract (the
// float32 instance needs three). The accumulator runs as the float32
// one's: each stage summed apart and added to the tile's sum. The epilogue
// rounds y + b to bf16, stores it (8-byte stores) and sums the rounded
// values. Where TMA cannot read x or w (K % 8 != 0, or a base not 16-byte
// aligned) warp 0 fills the swizzled stages with 2-byte loads and a proxy
// fence. At 2-byte operands a launch moves half the float32 bytes and its
// products run at the bf16 rate (989 TFLOP/s): the bytes bound most of
// ResNet-50's shapes.
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "flash_mma.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBM = 128;                 // rows of y per tile
// Two warpgroups of 64 rows each, and no warp of its own for the loads: a
// wgmma kernel's registers are allotted per warpgroup, so a third one (even
// for one producer warp) cut every thread to 168 registers and spilled the
// BN = 128 accumulators (ptxas: 227 registers without it).
constexpr int kThreads = 256;
constexpr int kReduceWarps = 32;

// S: the storage type of x, w, b and y (float or __nv_bfloat16).
template <int BN, typename S>
struct Geo {
  static constexpr bool F32 = IsF32<S>::value;
  static constexpr int BK = 128 / sizeof(S);                // features per stage: 128 bytes
  static constexpr int STAGES = F32 ? (BN == 128 ? 3 : 5) : (BN == 128 ? 4 : 6);
  static constexpr int X_BYTES = kBM * 128;                 // 16 KB
  static constexpr int W_BYTES = BN * 128;                  // one half of w (float32), or w
  static constexpr int STAGE_BYTES = X_BYTES + (F32 ? 2 : 1) * W_BYTES;
  static constexpr int LDY = BN + 8;                        // staged y rows, see epilogue
  static constexpr int Y_BYTES = 2 * 64 * LDY * 4;
  static constexpr int CPR = BN / 4;                        // 16-byte chunks in a row
  static constexpr int RPP = 128 / CPR;                     // rows a warpgroup reads per pass
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + Y_BYTES + 2 * STAGES * 8;
  static_assert(STAGE_BYTES % 1024 == 0 && W_BYTES % 1024 == 0, "swizzle atoms");
  static_assert(2 * RPP * 2 * BN * 4 <= Y_BYTES, "the final reduction fits the staging");
};

// ---- the kernels ----

__global__ void conv1x1_split_w(const float* __restrict__ w, float* __restrict__ ws, int N,
                                int K, int Kp) {
  const long long total = static_cast<long long>(N) * Kp;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long n = i / Kp;
    const int k = static_cast<int>(i % Kp);
    unsigned big, small;
    flash_mma::split(k < K ? w[n * K + k] : 0.0f, big, small);
    ws[i] = __uint_as_float(big);
    ws[total + i] = __uint_as_float(small);
  }
}

template <int BN, typename S>
__global__ void __launch_bounds__(kThreads, 1)
conv1x1_stats_tile(const __grid_constant__ CUtensorMap x_map,
                   const __grid_constant__ CUtensorMap w_map, const S* __restrict__ x,
                   const S* __restrict__ w, const S* __restrict__ b, S* __restrict__ y,
                   float* __restrict__ part, int M, int K, int N, int vec) {
  using G = Geo<BN, S>;
  constexpr bool F32 = G::F32;
  constexpr int S_ = G::STAGES;
  constexpr int BK = G::BK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  float* ystage = reinterpret_cast<float*>(base + S_ * G::STAGE_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + S_ * G::STAGE_BYTES + G::Y_BYTES);
  uint64_t* empty = full + S_;
  auto xs = [&](int s) { return reinterpret_cast<S*>(base + s * G::STAGE_BYTES); };
  // float32: w's big half, then its small half; bf16: w
  auto wbig = [&](int s) { return base + s * G::STAGE_BYTES + G::X_BYTES; };
  auto wsmall = [&](int s) { return base + s * G::STAGE_BYTES + G::X_BYTES + G::W_BYTES; };

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int P = gridDim.x;
  const int p = blockIdx.x;
  const int n0 = blockIdx.y * BN;
  const int m_tiles = (M + kBM - 1) / kBM;
  const int KC = (K + BK - 1) / BK;

  if (tid == 0) {
    // the expect_tx arrival; without TMA for x, 32 more (cp.async or, for
    // bf16, warp 0's copies of x and w, which arrive in place of TMA's)
    const int arrivals = vec ? 1 : (F32 ? 33 : 32);
    for (int s = 0; s < S_; ++s) {
      bar_init(&full[s], arrivals);
      bar_init(&empty[s], kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Fill the stage of slice j (the block's j-th slice in the consumers'
  // order): TMA by thread 0, or x (bf16: and w) by warp 0's copies.
  const int my_tiles = (m_tiles - p + P - 1) / P;
  const int total = my_tiles * KC;
  auto produce = [&](int j) {
    const int s = j % S_;
    const int mt = p + (j / KC) * P, kc = j % KC;
    if constexpr (F32) {
      if (tid == 0) {
        bar_expect(&full[s], vec ? G::STAGE_BYTES : 2 * G::W_BYTES);
        if (vec) tma_load_2d(xs(s), &x_map, kc * BK, mt * kBM, &full[s]);
        tma_load_3d(wbig(s), &w_map, kc * BK, n0, 0, &full[s]);
        tma_load_3d(wsmall(s), &w_map, kc * BK, n0, 1, &full[s]);
      }
      if (!vec) {
        // the swizzled image TMA would write: 16-byte chunk c of row r at
        // chunk c ^ (r % 8)
        float* dst = xs(s);
        for (int e = lane; e < kBM * BK; e += 32) {
          const int r = e / BK, c = e % BK;
          const long long row = static_cast<long long>(mt) * kBM + r;
          const int col = kc * BK + c;
          const bool ok = row < M && col < K;
          flash_mma::cp_async4z(dst + r * BK + (((c >> 2) ^ (r & 7)) << 2) + (c & 3),
                                ok ? x + row * K + col : x, ok);
        }
        bar_arrive_cp_async(&full[s]);
      }
    } else if (vec) {
      if (tid == 0) {
        bar_expect(&full[s], G::STAGE_BYTES);
        tma_load_2d(xs(s), &x_map, kc * BK, mt * kBM, &full[s]);
        tma_load_2d(wbig(s), &w_map, kc * BK, n0, &full[s]);
      }
    } else {
      const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
      S* xd = xs(s);
      S* wd = reinterpret_cast<S*>(wbig(s));
      for (int e = lane; e < kBM * BK; e += 32) {
        const int r = e / BK, c = e % BK;
        const long long row = static_cast<long long>(mt) * kBM + r;
        const int col = kc * BK + c;
        put_bf16(xd, r, c, row < M && col < K ? x[row * K + col] : zero);
      }
      for (int e = lane; e < BN * BK; e += 32) {
        const int r = e / BK, c = e % BK;
        const long long n = static_cast<long long>(n0) + r;
        const int col = kc * BK + c;
        put_bf16(wd, r, c, n < N && col < K ? w[n * K + col] : zero);
      }
      fence_proxy_async();
      bar_arrive(&full[s]);
    }
  };
  if (warp == 0)
    for (int j = 0; j < S_ - 1 && j < total; ++j) produce(j);

  const int wg = warp / 4;                // rows [64 wg, 64 wg + 64) of a tile
  const int wtid = tid % 128;
  const int g = lane / 4, t = lane % 4;
  const int ra = 64 * wg + 16 * (warp % 4) + g;   // A rows ra, ra + 8; ra % 8 == g
  const int cc = wtid % G::CPR;           // epilogue: columns n0 + 4 cc .. + 3
  const int r0 = wtid / G::CPR;           // and rows r0, r0 + RPP, ...
  float bias[4], cs[4], cq[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int n = n0 + 4 * cc + e;
    bias[e] = (b != nullptr && n < N) ? to_f32(b[n]) : 0.0f;
    cs[e] = 0.0f;
    cq[e] = 0.0f;
  }
  const bool vec_store = N % 4 == 0 && n0 + 4 * cc + 4 <= N;
  float* st = ystage + wg * 64 * G::LDY;

  float acc[BN / 2], slice[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) slice[i] = 0.0f;
  int it = 0;
  for (int mt = p; mt < m_tiles; mt += P) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
    for (int kc = 0; kc < KC; ++kc, ++it) {
      // refill the stage slice it - 1 used, once every thread released it
      if (warp == 0 && it + S_ - 1 < total) {
        if (it > 0) bar_wait(&empty[(it - 1) % S_], ((it - 1) / S_) & 1);
        produce(it + S_ - 1);
      }
      const int s = it % S_;
      bar_wait(&full[s], (it / S_) & 1);
      const uint64_t db = desc_sw128(wbig(s));
      if constexpr (F32) {
        const float* xt = xs(s);
        flash_mma::FragA a[BK / 8];
#pragma unroll
        for (int ks = 0; ks < BK / 8; ++ks) {
          // columns 8 ks + t and 8 ks + t + 4: chunks 2 ks and 2 ks + 1
          const float* lo = xt + ra * BK + t;
          const float* hi = lo + 8 * BK;
          const int c0 = ((2 * ks) ^ g) << 2, c1 = ((2 * ks + 1) ^ g) << 2;
          a[ks].set(lo[c0], hi[c0], lo[c1], hi[c1]);
        }
        const uint64_t dsm = desc_sw128(wsmall(s));
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) fence_operand(slice[i]);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < BK / 8; ++ks) {   // 8 features = 32 bytes = 2 descriptor units
          wgmma_tf32<BN>(slice, a[ks].small, db + 2 * ks, ks > 0);
          wgmma_tf32<BN>(slice, a[ks].big, dsm + 2 * ks, 1);
          wgmma_tf32<BN>(slice, a[ks].big, db + 2 * ks, 1);
        }
      } else {
        // the warpgroup's 64 rows of x: 8 KB into the stage, a swizzle atom multiple
        const uint64_t da = desc_sw128(reinterpret_cast<const uint8_t*>(xs(s)) + wg * 64 * 128);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) fence_operand(slice[i]);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < BK / 16; ++ks)    // 16 features = 32 bytes = 2 descriptor units
          wgmma_bf16<BN>(slice, da + 2 * ks, db + 2 * ks, ks > 0);
      }
      wgmma_commit_and_wait();
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) fence_operand(slice[i]);
      bar_arrive(&empty[s]);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] += slice[i];
    }

    // epilogue: the warpgroup's 64 rows through shared memory. LDY = 8
    // (mod 32) makes the 8-byte fragment stores conflict-free; each thread
    // then reads 16-byte chunks of consecutive columns.
    named_sync(1 + wg, 128);              // the previous tile's reads are done
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      float* p0 = st + (ra - 64 * wg) * G::LDY + 8 * j + 2 * t;
      *reinterpret_cast<float2*>(p0) = make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(p0 + 8 * G::LDY) = make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
    named_sync(1 + wg, 128);
    const long long row0 = static_cast<long long>(mt) * kBM + 64 * wg;
#pragma unroll 4
    for (int r = r0; r < 64; r += G::RPP) {
      if (row0 + r >= M) break;
      const float4 v4 = *reinterpret_cast<const float4*>(st + r * G::LDY + 4 * cc);
      // y + b rounded to S, and the statistics of the rounded values
      S v[4] = {from_f32<S>(v4.x + bias[0]), from_f32<S>(v4.y + bias[1]),
                from_f32<S>(v4.z + bias[2]), from_f32<S>(v4.w + bias[3])};
      S* dst = y + (row0 + r) * N + n0 + 4 * cc;
      if (vec_store) {
        if constexpr (F32) {
          *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
          *reinterpret_cast<uint2*>(dst) = make_uint2(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]));
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float f = to_f32(v[e]);
          cs[e] += f;
          cq[e] = fmaf(f, f, cq[e]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (n0 + 4 * cc + e < N) {
            const float f = to_f32(v[e]);
            dst[e] = v[e];
            cs[e] += f;
            cq[e] = fmaf(f, f, cq[e]);
          }
        }
      }
    }
  }

  // the block's partial row: the 2 RPP column sums of each column in order
  named_sync(3, kThreads);              // both warpgroups are done with the staging
  float* red = ystage;                    // [2 RPP][2][BN]
  const int idx = wg * G::RPP + r0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    red[(idx * 2 + 0) * BN + 4 * cc + e] = cs[e];
    red[(idx * 2 + 1) * BN + 4 * cc + e] = cq[e];
  }
  named_sync(3, kThreads);
  for (int c = tid; c < 2 * BN; c += kThreads) {
    const int stat = c / BN, col = c % BN;
    if (n0 + col >= N) continue;
    float total = 0.0f;
    for (int i = 0; i < 2 * G::RPP; ++i) total += red[(i * 2 + stat) * BN + col];
    part[(static_cast<long long>(p) * 2 + stat) * N + n0 + col] = total;
  }
}

// s and q from part [tiles, 2, N]: column c of the 2N (s then q) is summed
// over the tiles by lane c % 32 of each warp, warp w taking tiles w, w + 32,
// ..., then the warps' sums in order.
__global__ void __launch_bounds__(32 * kReduceWarps)
conv1x1_stats_reduce(const float* __restrict__ part, float* __restrict__ s,
                     float* __restrict__ q, int tiles, int N) {
  __shared__ float red[kReduceWarps][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  const int two_n = 2 * N;
  float acc = 0.0f;
  if (c < two_n) {
#pragma unroll 4
    for (int t = threadIdx.y; t < tiles; t += kReduceWarps)
      acc += part[static_cast<long long>(t) * two_n + c];
  }
  red[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && c < two_n) {
    float total = 0.0f;
#pragma unroll
    for (int i = 0; i < kReduceWarps; ++i) total += red[i][threadIdx.x];
    if (c < N) s[c] = total;
    else q[c - N] = total;
  }
}

// The persistent tiles' launch. float32: w is wsplit, its TF32 halves
// [2][N][Kp]; bf16: w as stored, [N][K] (read by TMA when vec).
template <int BN, typename S>
int launch_tile(const S* x, const S* w, const S* b, S* y, float* part, int M, int K, int N,
                int Kp, int vec, int* blocks, cudaStream_t st) {
  using G = Geo<BN, S>;
  constexpr CUtensorMapDataType kType =
      G::F32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  constexpr cuuint64_t kElem = sizeof(S);
  CUtensorMap x_map = {}, w_map = {};
  if (vec) {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(M)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K) * kElem};
    const cuuint32_t box[2] = {G::BK, kBM};
    if (!tensor_map(&x_map, kType, x, 2, dims, strides, box))
      return static_cast<int>(cudaErrorNotSupported);
  }
  if constexpr (G::F32) {
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(Kp), static_cast<cuuint64_t>(N), 2};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(Kp) * 4,
                                   static_cast<cuuint64_t>(N) * Kp * 4};
    const cuuint32_t box[3] = {G::BK, BN, 1};
    if (!tensor_map(&w_map, kType, w, 3, dims, strides, box))
      return static_cast<int>(cudaErrorNotSupported);
  } else if (vec) {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(N)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K) * kElem};
    const cuuint32_t box[2] = {G::BK, BN};
    if (!tensor_map(&w_map, kType, w, 2, dims, strides, box))
      return static_cast<int>(cudaErrorNotSupported);
  }

  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int m_tiles = (M + kBM - 1) / kBM;
  const int n_tiles = (N + BN - 1) / BN;
  int P = sms / n_tiles;
  P = P < 1 ? 1 : (P > m_tiles ? m_tiles : P);
  *blocks = P;
  cudaError_t err = allow_smem(conv1x1_stats_tile<BN, S>, G::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  conv1x1_stats_tile<BN, S><<<dim3(P, n_tiles), kThreads, G::SMEM, st>>>(
      x_map, w_map, x, w, b, y, part, M, K, N, vec);
  return static_cast<int>(cudaGetLastError());
}

// The tiles, then s and q from their partial rows.
template <typename S>
int run(const S* x, const S* w, const S* b, S* y, float* s, float* q, float* part, int M,
        int K, int N, int Kp, int vec, cudaStream_t st) {
  int tiles = 0;
  const int err = (N <= 64 ? launch_tile<64, S> : launch_tile<128, S>)(
      x, w, b, y, part, M, K, N, Kp, vec, &tiles, st);
  if (err != 0) return err;
  const dim3 grid((2 * N + 31) / 32);
  conv1x1_stats_reduce<<<grid, dim3(32, kReduceWarps), 0, st>>>(part, s, q, tiles, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch the three kernels on `stream`. part is scratch of min(ceil(M /
// 128), SMs) * 2 * N floats (one row per persistent block), wsplit of 2 *
// N * Kp (Kp = K rounded up to a multiple of 32); vec != 0 promises K % 4
// == 0 and a 16-byte aligned x (TMA reads it). The shapes it takes are
// fused_conv1x1_bn.supported's: M + 127 and Kp within an int, every
// block's stage count (at most ceil(M / 128) * Kp / 32) within an int,
// ceil(N / 128) <= 65535, N * Kp * 4 < 2^40 (the tensor maps' strides).
// Returns cudaGetLastError(), or the error of a step that failed.
extern "C" int conv1x1_stats(const void* x, const void* w, const void* b, void* y,
                             void* s, void* q, void* part, void* wsplit, int M, int K, int N,
                             int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr int kBK = Geo<128, float>::BK;
  const int Kp = (K + kBK - 1) / kBK * kBK;
  float* ws = static_cast<float*>(wsplit);
  const long long nkp = static_cast<long long>(N) * Kp;
  const int split_blocks = static_cast<int>(nkp / 256 + 1 < 1024 ? nkp / 256 + 1 : 1024);
  conv1x1_split_w<<<split_blocks, 256, 0, st>>>(static_cast<const float*>(w), ws, N, K, Kp);
  return run<float>(static_cast<const float*>(x), ws, static_cast<const float*>(b),
                    static_cast<float*>(y), static_cast<float*>(s), static_cast<float*>(q),
                    static_cast<float*>(part), M, K, N, Kp, vec, st);
}

// The bf16 instance: x, w, b and y __nv_bfloat16, s, q and part float32;
// two kernels (the tiles and the reduction), no split of w. vec != 0
// promises K % 8 == 0 and 16-byte aligned x and w (TMA reads both; rows of
// 16-byte multiples). It takes every shape conv1x1_stats takes.
extern "C" int conv1x1_stats_bf16(const void* x, const void* w, const void* b, void* y,
                                  void* s, void* q, void* part, int M, int K, int N, int vec,
                                  void* stream) {
  using bf16 = __nv_bfloat16;
  return run<bf16>(static_cast<const bf16*>(x), static_cast<const bf16*>(w),
                   static_cast<const bf16*>(b), static_cast<bf16*>(y), static_cast<float*>(s),
                   static_cast<float*>(q), static_cast<float*>(part), M, K, N, 0, vec,
                   static_cast<cudaStream_t>(stream));
}
