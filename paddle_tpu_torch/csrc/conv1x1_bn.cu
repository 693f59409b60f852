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
// The bf16 body (conv1x1_stats_bf16) keeps the Pallas kernel's bf16
// contract: x, w and b bf16, the product accumulated in float32, b added
// widened, y rounded to bf16 and stored, s and q float32 sums of the
// rounded y. At 2-byte operands the bytes bind 7 of ResNet-50's 9 shapes
// (3.35 TB/s; a step's 30 launches 0.565 ms) and the products, at the bf16
// rate (989 TFLOP/s), the other two (4,096 rows, K or N = 2048). The first
// bf16 body (the float32 template on bf16 storage) ran 5.6-7.8x that: no wgmma
// stayed in flight across stages (each 64-feature stage summed apart and
// added with rounded float32 adds, the float32 split's answer to the
// truncating accumulator), warp 0 both loaded and multiplied (a refill
// waited on the slowest warpgroup's release), and each tile's epilogue
// staged float32 y through 70 KB of shared memory and stored it with
// synchronous 8-byte stores while no product ran. What this body does
// (conv1x1_bf16_tile):
//  - One float32 accumulator over the whole K loop with one wgmma group in
//    flight: a stage's four wgmma m64nBNk16 (A = x, B = w, both K-major
//    from the swizzled stage) are committed, then wgmma.wait_group 1
//    retires the previous stage's group, and that stage is released. bf16
//    products are exact in float32; the accumulator's truncation over up
//    to 128 k-steps (K = 2048) stays far inside y's bf16 rounding
//    (tests/test_torch_conv1x1_bn.py emulates it).
//  - A loading warp of its own (a ninth warp, 288 threads): it keeps up to
//    STAGES stages of x and w ahead by TMA, each refill waiting only on the
//    consumers' release of that stage. The accumulator is BN / 2 floats a
//    thread and nothing else holds a stage's products, so the 168
//    registers a thread of a 288-thread block gets are enough (160 at
//    BN = 128, 126 at 64, no spill). Chosen from the phase probe: in the
//    first body the warpgroup whose warp 0 also loaded waited 794 cycles a
//    row tile for its stages at K = 64, the other 239; with the loading
//    warp both wait ~140, and the loads are ready before the consumers.
//  - An asynchronous epilogue: each warpgroup rounds y + b to bf16 into its
//    own bf16 staging tile (the swizzled [64][64] images TMA reads, 16 KB
//    at BN = 128), and one thread stores the tile by TMA
//    (cp.async.bulk.tensor shared -> global, clipped at M and N) and waits
//    for its read only before the staging is written again, a tile later.
//    The statistics are summed from the staged bf16 values, 8 columns of a
//    16-byte chunk a thread over a group of rows, while the store and the
//    next tile's loads run.
//  - Persistent blocks as the float32 kernel's (block (p, nt) walks the row
//    tiles p, p + P, ... of its column tile), the statistics in a fixed
//    order: per thread over its rows and tiles, then the block's threads in
//    order into its partial row, then conv1x1_stats_reduce. No atomics: two
//    launches give equal bits.
// Where TMA cannot read x or w (K % 8 != 0, or a base not 16-byte aligned)
// the loading warp fills the swizzled stages with 2-byte loads and a proxy
// fence; where it cannot write y (N % 8 != 0) each thread stores its
// columns' values from the staging as it sums them.
// What holds it back (tools/conv1x1_phases.py; PERF.md): at K = 64 a row
// tile's epilogue (staging ~1,200 cycles with the products' wait, stores
// and statistics ~1,000) outweighs its products, and the launch's fixed
// costs (the prologue, the tail, the reduction's launch) weigh on
// launches of 30-60 us; at 4,096 rows and K = 2,048 the block waits about
// half its tile for stages that other blocks read again (x by N / BN
// column blocks, w by every row block). Ping-pong turns of the two
// warpgroups at K <= 256 ran no faster and spilled; BN = 256 at N >= 256
// needs 128 accumulator floats a thread, past the 168-register cap.
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "flash_mma.cuh"
#include "hopper.cuh"

// Phase clocks of the bf16 tile body, for tools/conv1x1_phases.py, which
// builds this source with -DCONV1X1_PHASES: thread 0 of each warpgroup of
// block (0, 0) adds the cycles of each phase of its row tile `tile` (< 64)
// into g_conv_phase[wg][tile][k]: 0 waiting for stages, 1 products, 2 the
// epilogue's staging, 3 its stores and statistics. Nothing in any other
// build.
#ifdef CONV1X1_PHASES
__device__ long long g_conv_phase[2][64][4];
#define CONV1X1_TICK(t) const long long t = clock64()
#define CONV1X1_PHASE(pick, wg, tile, k, t0, t1)                                 \
  do {                                                                         \
    if ((pick) && threadIdx.x % 128 == 0 && (tile) < 64)                       \
      g_conv_phase[wg][tile][k] += (t1) - (t0);                                \
  } while (0)
extern "C" int conv1x1_phase_clocks(void* dst) {
  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_conv_phase, sizeof(g_conv_phase)));
}
extern "C" int conv1x1_phase_reset() {
  static const long long zeros[2][64][4] = {};
  return static_cast<int>(cudaMemcpyToSymbol(g_conv_phase, zeros, sizeof(zeros)));
}
#else
#define CONV1X1_TICK(t) \
  do {                  \
  } while (0)
#define CONV1X1_PHASE(pick, wg, tile, k, t0, t1) \
  do {                                           \
  } while (0)
#endif

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kBM = 128;                 // rows of y per tile
// Two warpgroups of 64 rows each, and no warp of its own for the loads: a
// wgmma kernel's registers are allotted per warpgroup, so a third one (even
// for one producer warp) cut every thread to 168 registers and spilled the
// BN = 128 accumulators (ptxas: 227 registers without it).
constexpr int kThreads = 256;
constexpr int kReduceWarps = 32;

template <int BN>
struct Geo {
  static constexpr int BK = 32;                             // features per stage: 128 bytes
  static constexpr int STAGES = BN == 128 ? 3 : 5;
  static constexpr int X_BYTES = kBM * 128;                 // 16 KB
  static constexpr int W_BYTES = BN * 128;                  // one half of w
  static constexpr int STAGE_BYTES = X_BYTES + 2 * W_BYTES;
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

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
conv1x1_stats_tile(const __grid_constant__ CUtensorMap x_map,
                   const __grid_constant__ CUtensorMap w_map, const float* __restrict__ x,
                   const float* __restrict__ b, float* __restrict__ y,
                   float* __restrict__ part, int M, int K, int N, int vec) {
  using G = Geo<BN>;
  constexpr int S_ = G::STAGES;
  constexpr int BK = G::BK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  float* ystage = reinterpret_cast<float*>(base + S_ * G::STAGE_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + S_ * G::STAGE_BYTES + G::Y_BYTES);
  uint64_t* empty = full + S_;
  auto xs = [&](int s) { return reinterpret_cast<float*>(base + s * G::STAGE_BYTES); };
  // w's big half, then its small half
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
    // the expect_tx arrival; without TMA for x, 32 more (cp.async)
    const int arrivals = vec ? 1 : 33;
    for (int s = 0; s < S_; ++s) {
      bar_init(&full[s], arrivals);
      bar_init(&empty[s], kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Fill the stage of slice j (the block's j-th slice in the consumers'
  // order): TMA by thread 0, or x by warp 0's copies.
  const int my_tiles = (m_tiles - p + P - 1) / P;
  const int total = my_tiles * KC;
  auto produce = [&](int j) {
    const int s = j % S_;
    const int mt = p + (j / KC) * P, kc = j % KC;
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
    bias[e] = (b != nullptr && n < N) ? b[n] : 0.0f;
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
      // y + b, and the statistics of the stored values
      const float v[4] = {v4.x + bias[0], v4.y + bias[1], v4.z + bias[2], v4.w + bias[3]};
      float* dst = y + (row0 + r) * N + n0 + 4 * cc;
      if (vec_store) {
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          cs[e] += v[e];
          cq[e] = fmaf(v[e], v[e], cq[e]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (n0 + 4 * cc + e < N) {
            dst[e] = v[e];
            cs[e] += v[e];
            cq[e] = fmaf(v[e], v[e], cq[e]);
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

// ---- the bf16 body ----

constexpr int kBf16Consumers = 256;     // two warpgroups of 64 rows
constexpr int kBf16Threads = kBf16Consumers + 32;   // and the loading warp

template <int BN>
struct GeoBf16 {
  static constexpr int BK = 64;                             // features per stage: 128 bytes
  static constexpr int STAGES = BN == 128 ? 5 : 7;
  static constexpr int X_BYTES = kBM * 128;                 // 16 KB
  static constexpr int W_BYTES = BN * 128;
  static constexpr int STAGE_BYTES = X_BYTES + W_BYTES;
  static constexpr int Y_BYTES = 64 * BN * 2;               // a warpgroup's staged y
  static constexpr int CH = BN / 8;                         // 16-byte chunks in a staged row
  static constexpr int RG = 128 / CH;                       // statistics: row groups of a tile
  static constexpr int RPG = 64 / RG;                       // and their rows
  static constexpr int RED_FLOATS = 2 * RG * 2 * BN;        // [wg][rg][s | q][BN]
  static constexpr int SMEM =
      1024 + STAGES * STAGE_BYTES + 2 * Y_BYTES + 4 * (BN + RED_FLOATS) + 2 * STAGES * 8;
  static_assert(STAGE_BYTES % 1024 == 0 && Y_BYTES % 1024 == 0, "swizzle atoms");
};

template <int BN>
__global__ void __launch_bounds__(kBf16Threads, 1)
conv1x1_bf16_tile(const __grid_constant__ CUtensorMap x_map,
                  const __grid_constant__ CUtensorMap w_map,
                  const __grid_constant__ CUtensorMap y_map, const bf16* __restrict__ x,
                  const bf16* __restrict__ w, const bf16* __restrict__ b, bf16* __restrict__ y,
                  float* __restrict__ part, int M, int K, int N, int vec, int tma_y) {
  using G = GeoBf16<BN>;
  constexpr int S_ = G::STAGES;
  constexpr int BK = G::BK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* ystage = base + S_ * G::STAGE_BYTES;                     // [2][BN / 64][64][64]
  float* bias = reinterpret_cast<float*>(ystage + 2 * G::Y_BYTES);  // [BN]
  float* red = bias + BN;                                           // [2][RP][2][BN]
  uint64_t* full = reinterpret_cast<uint64_t*>(red + G::RED_FLOATS);
  uint64_t* empty = full + S_;
  auto xs = [&](int s) { return base + s * G::STAGE_BYTES; };
  auto ws = [&](int s) { return base + s * G::STAGE_BYTES + G::X_BYTES; };

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int P = gridDim.x;
  const int p = blockIdx.x;
  const int n0 = blockIdx.y * BN;
  const int m_tiles = (M + kBM - 1) / kBM;
  const int KC = (K + BK - 1) / BK;
  const int total = (m_tiles - p + P - 1) / P * KC;   // the block's stages

  if (tid == 0) {
    // the expect_tx arrival, or the loading warp's 32 after its copies
    for (int s = 0; s < S_; ++s) {
      bar_init(&full[s], vec ? 1 : 32);
      bar_init(&empty[s], kBf16Consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int c = tid; c < BN; c += kBf16Threads)
    bias[c] = b != nullptr && n0 + c < N ? __bfloat162float(b[n0 + c]) : 0.0f;
  __syncthreads();

  if (warp == kBf16Consumers / 32) {
    // The loading warp: stage j of the block's sequence once the consumers
    // have released its previous use, TMA by lane 0 or the warp's copies
    // (the swizzled image TMA would write).
    if (vec && lane != 0) return;
    for (int j = 0; j < total; ++j) {
      const int s = j % S_;
      const int mt = p + (j / KC) * P, kc = j % KC;
      if (j >= S_) bar_wait(&empty[s], (j / S_ - 1) & 1);
      if (vec) {
        bar_expect(&full[s], G::STAGE_BYTES);
        tma_load_2d(xs(s), &x_map, kc * BK, mt * kBM, &full[s]);
        tma_load_2d(ws(s), &w_map, kc * BK, n0, &full[s]);
        continue;
      }
      const bf16 zero = __float2bfloat16_rn(0.0f);
      bf16* xd = reinterpret_cast<bf16*>(xs(s));
      bf16* wd = reinterpret_cast<bf16*>(ws(s));
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
    return;
  }

  const int wg = warp / 4;                // rows [64 wg, 64 wg + 64) of a tile
  const int wtid = tid % 128;
  const int g = lane / 4, t = lane % 4;
  const int rr = 16 * (warp % 4) + g;     // the thread's rows rr, rr + 8 of the warpgroup's
  uint8_t* st = ystage + wg * G::Y_BYTES;
  // statistics: the 8 columns of staged chunk cc (image cc / 8, chunk cc % 8
  // of a row) over rows [RPG rg, RPG rg + RPG) of each tile; a quarter warp
  // reads one row's 8 chunks, conflict-free
  const int cc = wtid % G::CH;
  const int rg = wtid / G::CH;
  const uint8_t* cst = st + (cc / 8) * 8192;
  const int c0 = n0 + 8 * cc;             // the chunk's first column of y
  float cs[8], cq[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    cs[e] = 0.0f;
    cq[e] = 0.0f;
  }
  const bool probed = p == 0 && blockIdx.y == 0;   // CONV1X1_PHASE's block
  (void)probed;

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  int it = 0;
  for (int mt = p; mt < m_tiles; mt += P) {
    const int tile = (mt - p) / P;
    (void)tile;
    // the K loop: stage it's products are issued while stage it - 1's are
    // in flight; once they retire (wait_group 1) stage it - 1 is released
    for (int kc = 0; kc < KC; ++kc, ++it) {
      CONV1X1_TICK(t_wait);
      const int s = it % S_;
      bar_wait(&full[s], (it / S_) & 1);
      CONV1X1_TICK(t_full);
      CONV1X1_PHASE(probed, wg, tile, 0, t_wait, t_full);
      // the warpgroup's 64 rows of x: 8 KB into the stage, a swizzle atom multiple
      const uint64_t da = desc_sw128(xs(s) + wg * 64 * 128);
      const uint64_t db = desc_sw128(ws(s));
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks)    // 16 features = 32 bytes = 2 descriptor units
        wgmma_bf16<BN>(acc, da + 2 * ks, db + 2 * ks, kc > 0 || ks > 0);
      wgmma_commit();
      wgmma_wait<1>();
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);
      if (kc > 0) bar_arrive(&empty[(it - 1) % S_]);
      CONV1X1_TICK(t_done);
      CONV1X1_PHASE(probed, wg, tile, 1, t_full, t_done);
    }
    CONV1X1_TICK(t_epi);
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);
    bar_arrive(&empty[(it - 1) % S_]);

    // epilogue: y + b rounded to bf16 into the warpgroup's staging (the
    // swizzled images TMA reads; conflict-free: the chunk moves with the
    // row), once the previous tile's store has read it
    const long long row0 = static_cast<long long>(mt) * kBM + 64 * wg;
    if (wtid == 0) bulk_wait_read<0>();
    named_sync(1 + wg, 128);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = 8 * j + 2 * t;
      uint8_t* at = st + (j / 8) * 8192 + rr * 128 + (((j % 8) ^ g) << 4) + 4 * t;
      const __nv_bfloat162 lo =
          __floats2bfloat162_rn(acc[4 * j] + bias[c], acc[4 * j + 1] + bias[c + 1]);
      const __nv_bfloat162 hi =
          __floats2bfloat162_rn(acc[4 * j + 2] + bias[c], acc[4 * j + 3] + bias[c + 1]);
      *reinterpret_cast<__nv_bfloat162*>(at) = lo;
      *reinterpret_cast<__nv_bfloat162*>(at + 8 * 128) = hi;
    }
    fence_proxy_async();
    named_sync(1 + wg, 128);
    CONV1X1_TICK(t_staged);
    CONV1X1_PHASE(probed, wg, tile, 2, t_epi, t_staged);
    const int rows = row0 < M ? static_cast<int>(min(64ll, M - row0)) : 0;
    if (tma_y && wtid == 0 && rows > 0) {
#pragma unroll
      for (int i = 0; i < BN / 64; ++i)
        tma_store_2d(&y_map, st + i * 8192, n0 + 64 * i, static_cast<int>(row0));
      bulk_commit();
    }
    // the statistics of this thread's 8 columns over its rows, from the
    // stored bf16 values (and, where TMA cannot write y, the stores)
#pragma unroll
    for (int i = 0; i < G::RPG; ++i) {
      const int r = G::RPG * rg + i;
      if (r >= rows) break;
      const uint4 v = *reinterpret_cast<const uint4*>(cst + r * 128 + (((cc % 8) ^ (r & 7)) << 4));
      const unsigned words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const unsigned wd = words[e / 2];
        const float f = __uint_as_float(e % 2 ? wd & 0xffff0000u : wd << 16);
        cs[e] += f;
        cq[e] = fmaf(f, f, cq[e]);
        if (!tma_y && c0 + e < N)
          y[(row0 + r) * N + c0 + e] = __ushort_as_bfloat16(static_cast<unsigned short>(
              e % 2 ? wd >> 16 : wd & 0xffffu));
      }
    }
    CONV1X1_TICK(t_stored);
    CONV1X1_PHASE(probed, wg, tile, 3, t_staged, t_stored);
  }
  if (wtid == 0) bulk_wait<0>();

  // the block's partial row: each column's 2 RG group sums in order
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    red[((wg * G::RG + rg) * 2 + 0) * BN + 8 * cc + e] = cs[e];
    red[((wg * G::RG + rg) * 2 + 1) * BN + 8 * cc + e] = cq[e];
  }
  named_sync(3, kBf16Consumers);
  for (int c = tid; c < 2 * BN; c += kBf16Consumers) {
    const int stat = c / BN, cl = c % BN;
    if (n0 + cl >= N) continue;
    float sum = 0.0f;
    for (int i = 0; i < 2 * G::RG; ++i) sum += red[(i * 2 + stat) * BN + cl];
    part[(static_cast<long long>(p) * 2 + stat) * N + n0 + cl] = sum;
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

// Blocks per column tile: the card's SMs shared out, at most one per row tile.
inline int persistent_blocks(int M, int n_tiles) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int m_tiles = (M + kBM - 1) / kBM;
  const int P = sms / n_tiles;
  return P < 1 ? 1 : (P > m_tiles ? m_tiles : P);
}

// The float32 tiles' launch: w is wsplit, its TF32 halves [2][N][Kp].
template <int BN>
int launch_tile(const float* x, const float* w, const float* b, float* y, float* part, int M,
                int K, int N, int Kp, int vec, int* blocks, cudaStream_t st) {
  using G = Geo<BN>;
  CUtensorMap x_map = {}, w_map = {};
  if (vec) {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(M)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K) * 4};
    const cuuint32_t box[2] = {G::BK, kBM};
    if (!tensor_map(&x_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, x, 2, dims, strides, box))
      return static_cast<int>(cudaErrorNotSupported);
  }
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(Kp), static_cast<cuuint64_t>(N), 2};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(Kp) * 4,
                                 static_cast<cuuint64_t>(N) * Kp * 4};
  const cuuint32_t box[3] = {G::BK, BN, 1};
  if (!tensor_map(&w_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, w, 3, dims, strides, box))
    return static_cast<int>(cudaErrorNotSupported);
  const int n_tiles = (N + BN - 1) / BN;
  const int P = persistent_blocks(M, n_tiles);
  *blocks = P;
  cudaError_t err = allow_smem(conv1x1_stats_tile<BN>, G::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  conv1x1_stats_tile<BN><<<dim3(P, n_tiles), kThreads, G::SMEM, st>>>(x_map, w_map, x, b, y,
                                                                       part, M, K, N, vec);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 tiles' launch: x and w read as stored (by TMA when vec), y
// written by TMA where its rows are 16-byte multiples.
template <int BN>
int launch_bf16(const bf16* x, const bf16* w, const bf16* b, bf16* y, float* part, int M, int K,
                int N, int vec, int* blocks, cudaStream_t st) {
  using G = GeoBf16<BN>;
  constexpr auto kType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap x_map = {}, w_map = {}, y_map = {};
  if (vec) {
    const cuuint64_t xd[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(M)};
    const cuuint64_t wd[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(N)};
    const cuuint64_t rows[1] = {static_cast<cuuint64_t>(K) * 2};
    const cuuint32_t xbox[2] = {G::BK, kBM}, wbox[2] = {G::BK, BN};
    if (!tensor_map(&x_map, kType, x, 2, xd, rows, xbox) ||
        !tensor_map(&w_map, kType, w, 2, wd, rows, wbox))
      return static_cast<int>(cudaErrorNotSupported);
  }
  const int tma_y = N % 8 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  if (tma_y) {
    const cuuint64_t yd[2] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(M)};
    const cuuint64_t rows[1] = {static_cast<cuuint64_t>(N) * 2};
    const cuuint32_t box[2] = {64, 64};
    if (!tensor_map(&y_map, kType, y, 2, yd, rows, box))
      return static_cast<int>(cudaErrorNotSupported);
  }
  const int n_tiles = (N + BN - 1) / BN;
  const int P = persistent_blocks(M, n_tiles);
  *blocks = P;
  cudaError_t err = allow_smem(conv1x1_bf16_tile<BN>, G::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  conv1x1_bf16_tile<BN><<<dim3(P, n_tiles), kBf16Threads, G::SMEM, st>>>(
      x_map, w_map, y_map, x, w, b, y, part, M, K, N, vec, tma_y);
  return static_cast<int>(cudaGetLastError());
}

// s and q from the tiles' partial rows.
int reduce_stats(const float* part, float* s, float* q, int tiles, int N, cudaStream_t st) {
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
  constexpr int kBK = Geo<128>::BK;
  const int Kp = (K + kBK - 1) / kBK * kBK;
  float* ws = static_cast<float*>(wsplit);
  const long long nkp = static_cast<long long>(N) * Kp;
  const int split_blocks = static_cast<int>(nkp / 256 + 1 < 1024 ? nkp / 256 + 1 : 1024);
  conv1x1_split_w<<<split_blocks, 256, 0, st>>>(static_cast<const float*>(w), ws, N, K, Kp);
  int tiles = 0;
  const int err = (N <= 64 ? launch_tile<64> : launch_tile<128>)(
      static_cast<const float*>(x), ws, static_cast<const float*>(b), static_cast<float*>(y),
      static_cast<float*>(part), M, K, N, Kp, vec, &tiles, st);
  if (err != 0) return err;
  return reduce_stats(static_cast<float*>(part), static_cast<float*>(s), static_cast<float*>(q),
                      tiles, N, st);
}

// The bf16 body: x, w, b and y __nv_bfloat16, s, q and part float32; two
// kernels (the tiles and the reduction), no split of w. vec != 0 promises
// K % 8 == 0 and 16-byte aligned x and w (TMA reads both; rows of 16-byte
// multiples). It takes every shape conv1x1_stats takes.
extern "C" int conv1x1_stats_bf16(const void* x, const void* w, const void* b, void* y,
                                  void* s, void* q, void* part, int M, int K, int N, int vec,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int tiles = 0;
  const int err = (N <= 64 ? launch_bf16<64> : launch_bf16<128>)(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const bf16*>(b),
      static_cast<bf16*>(y), static_cast<float*>(part), M, K, N, vec, &tiles, st);
  if (err != 0) return err;
  return reduce_stats(static_cast<float*>(part), static_cast<float*>(s), static_cast<float*>(q),
                      tiles, N, st);
}
