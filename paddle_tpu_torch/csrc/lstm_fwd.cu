// lstm_fwd / lstm_fwd_train — the masked peephole LSTM over a whole sequence
// in one launch (kernels 7a and 7b).
//
// Replaces: paddle_tpu/ops/pallas_lstm.py _fwd_kernel_light (lstm_fwd, the
// inference variant launched by pl.pallas_call in _run_fwd, entry
// fused_lstm), which runs the lstmemory layer of the LSTM text classifier
// in test and eval passes; and _fwd_kernel (lstm_fwd_train, the training
// variant: the same scan plus the residuals its backward reads, the
// custom-VJP forward of fused_lstm). As in the JAX package the two differ
// only in the residual stores: here one body, with kResiduals a template
// parameter.
//
// Per step t (time reversed when `reverse` is set), with h0 = c0 = 0, the
// weight w [H, 4H] split [candidate | input | forget | output], the gate
// biases already folded into x4 and the peepholes peep [3, H] = (pi, pf, po):
//   g  = x4[t] + h . w                       ga, gi, gf, go = g[:, kH:(k+1)H]
//   i  = act_gate(gi + pi * c)    f = act_gate(gf + pf * c)    a = act_in(ga)
//   c' = f * c + i * a            o = act_gate(go + po * c')   h' = o * act_state(c')
//   ys[t] = m * h';   carries h = m * h' + (1 - m) * h,  c = m * c' + (1 - m) * c
// with m = mask[t, b]. Training residuals, at the step's own time index t:
//   acts[t] = [a | i | f | o] [T, B, 4H]     hprev[t] = h     cprev[t] = c   [T, B, H]
//
// What bounds it on an H100: at T = 64, B = 256, H = 512 the function moves
// about 0.2 GB (x4, w, ys; 0.5 GB with the residuals), some 0.06-0.15 ms at
// 3.35 TB/s, and does 34.5 GFLOP (kernel_flops.lstm_fwd_flops), 0.52 ms at
// the 67 TFLOP/s float32 rate: operations bound it. The time loop is
// sequential and every step needs all of w (4 MB at H = 512) against every
// row's h. The first design (thread-block clusters of 8 blocks on tiles of
// 32 rows) streamed each block's columns of w from L2 again at every step,
// 32 MB of L2 reads a step on 64 SMs, ~51 us a step.
//
// What the design does about that: a persistent, cooperative grid
// (persistent_grid.cuh), one 256-thread block on each SM it uses, in P row
// groups of G blocks (fused_lstm.fwd_plan chooses P and mirrors the plan).
// Batch rows are independent in this recurrence, so row group p owns rows
// [p R, (p + 1) R) and waits only on its own blocks (a barrier counter of
// its own): one barrier a step, none over the whole grid. Within a group,
// block q owns gpb unit groups of 4 hidden units, contiguous (U = 4 gpb
// units), and keeps their four gate columns of w ([H][4 U] floats, 128 KB
// at U = 16, H = 512) in shared memory for the whole launch, loaded once by
// cp.async: w is never read again inside the time loop. Where they do not
// fit beside the state of the block's rows they stay in device memory that
// only the block touches, in the same layout: quads of 4 units, each
// [H][16] (the columns in the order the mma's n-tiles take them, below).
//
// A step's product is [R rows x H] . [H x 4 U], on the tensor cores:
// mma.sync m16n8k8 TF32 with the float32-accurate 3-pass split of
// flash_mma.cuh (w and h split into TF32 big and small halves as their
// fragments load), each chunk's products summed apart (the big one and the
// two small ones in accumulators of their own) and added to the
// accumulator in float32. On the CUDA cores the same product ran slower at
// this shape (PERF.md, PR 11), bound by the shared memory that feeds the
// FMAs (each FMA lane needs its operands through 16-byte loads); an mma
// takes 1024 products for 6 operands a lane. A warp owns an M tile of 16 rows
// and a pair of unit quads (8 units): 4 n-tiles of 8 columns, the gates 0
// and 1, then 2 and 3, of each quad, so that lane (g, t) ends up holding
// all four gates of units t and 4 + t of its pair for rows g and g + 8:
// no partial sum crosses lanes, and the cell runs in the lane that holds
// its sums. QP (a power of 2 at least ceil(U / 8)) warps share an M tile,
// so a pass covers RT = 16 * 8 / QP rows. The cell: x4 and the mask are
// loaded before the product and used after it (loading them a step ahead,
// before the barrier, measured slower), c and the carried h stay
// in the block's shared memory for the whole launch, the peepholes in
// registers, and the activation codes are read at run time. The group's
// rows of h (written by the group's other blocks) are staged by
// cp.async.cg (through L2: an SM's L1 is not coherent with the other SMs'
// writes) in chunks of KC columns of a pass, kStages - 1 chunks ahead of
// the products. Banks: a staged row is KC + 4 = 4 (mod 32) floats, so an A
// fragment's 32 words fall in 32 banks; w's quads are [k][16] with the
// column XORed with 8 on rows k = 2, 3 (mod 4), so a B fragment's too.
//
// The carry between blocks: for 7b it is the hprev residual at the next
// step's own time index (t + 1, or t - 1 reversed), which is exactly the
// next step's carry: no scratch, as kernel 2 passes it. 7a has no
// residual, and with one barrier a step a single [B, H] buffer would be
// overwritten by a fast block while a slow one still reads it: it carries
// h through a ping-pong scratch [2][B][Hp] (Hp = H rounded up to 4, so
// that every row starts on 16 bytes; 7b too where H % 4 != 0). The first
// step's carry is 0 and is not read; 7b writes hprev[t0] = 0. Every sum
// runs in a fixed order and nothing is summed by atomics: two launches
// give the same bits.
//
// bf16 instances (lstm_fwd_bf16, lstm_fwd_train_bf16; the storage type S is
// a template parameter) keep the Pallas kernels' bf16 contract
// (pallas_lstm.py _cell_fwd, _fwd_kernel): x4, w and peep are bf16,
// widened on load (w into the same float32 quads in shared memory, so the
// plan and the shared memory are the float32 instances'); c and the
// block's h stay float32 in its shared memory; every consumer of h reads
// it rounded to bf16 (the product, the hprev residual, which is exactly
// Pallas's h_prev.astype(bf16), and the masked pass-through that only
// feeds those two), so the carry between blocks passes as bf16, through
// hprev or a bf16 hbuf ([2][B][Hp], Hp = H rounded up to 8: rows of 16
// bytes), staged as bf16 rows of KC + 8 values (16 bytes of padding) in
// the float ring's carve. The product: a bf16 value is exact in TF32, so
// the split's small halves are 0 and one TF32 mma.sync pass (big . big)
// gives the exact products, summed in float32. ys, acts and hprev are
// stored bf16, cprev float32. The mask is float32 in both.

#include <cstdint>

#include "common.cuh"
#include "flash_mma.cuh"
#include "persistent_grid.cuh"

namespace {

using namespace pgrid;

constexpr int kStages = 2;          // ring slots of staged h chunks
constexpr int kSlotFloats = 12800;  // floats of a ring slot, at most
constexpr int kPad = 4;             // floats after each staged row
constexpr int kWarpsPerPass = kThreads / 32;

// How the grid is cut (mirrored by paddle_tpu_torch/ops/fused_lstm.py
// fwd_plan): P row groups of R = ceil(B / P) rows; in each, G blocks of
// gpb unit groups (U = 4 gpb units, contiguous, U <= 64). QP warps (a
// power of 2 at least ceil(U / 8)) share an M tile of 16 rows, so a pass
// covers RT = 16 * 8 / QP rows; h is staged in chunks of KC columns (the
// largest power of 2 from 32 with RT (KC + 4) <= kSlotFloats).
struct FwdPlan {
  int P, G, gpb, U, R, QP, RT, KC;
};

inline FwdPlan make_fwd_plan(int B, int H, int num_sms, int P) {
  FwdPlan p;
  const int groups = (H + kUnits - 1) / kUnits;
  p.P = P;
  int G = num_sms / P < groups ? num_sms / P : groups;
  if (G < 1) G = 1;
  p.gpb = (groups + G - 1) / G;
  p.G = (groups + p.gpb - 1) / p.gpb;
  p.U = kUnits * p.gpb;
  p.R = (B + P - 1) / P;
  p.QP = 1;
  while (8 * p.QP < p.U) p.QP *= 2;
  p.RT = p.QP <= kWarpsPerPass ? 16 * (kWarpsPerPass / p.QP) : 0;   // 0: U > 64, refused
  p.KC = 32;
  while (p.RT > 0 && p.RT * (2 * p.KC + kPad) <= kSlotFloats) p.KC *= 2;
  return p;
}

// Floats of a quad (4 units) of w's columns: [H8][16], H rounded up to 8
// (the mma's k steps), and 16 of padding: 16 ceil(H / 8) 8 + 16.
__host__ __device__ inline long long quad_floats(int H) { return 16LL * ((H + 7) / 8 * 8) + 16; }

// The shared memory of a block, in floats: its columns of w (when w_smem),
// c and the carried h of its rows ([R][U] each), then the ring of staged
// h chunks [kStages][RT][KC + kPad].
inline size_t fwd_smem_floats(const FwdPlan& p, int H, bool w_smem) {
  const long long w = w_smem ? (p.U / 4) * quad_floats(H) : 0;
  const long long state = 2LL * p.R * p.U;
  const long long ring = static_cast<long long>(kStages) * p.RT * (p.KC + kPad);
  return static_cast<size_t>(w + state + ring);
}

template <bool kResiduals, typename S>
__global__ void __launch_bounds__(kThreads, 1)
lstm_fwd_kernel(const S* __restrict__ x4, long long x_st, long long x_sb,
                const float* __restrict__ mask, long long m_st, long long m_sb,
                const S* __restrict__ w, const S* __restrict__ peep,
                S* __restrict__ ys, long long y_st, long long y_sb,
                S* __restrict__ acts, S* hprev, float* __restrict__ cprev,
                S* hbuf, float* wslices, unsigned* counters,
                unsigned long long* phase_ns, int T, int B, int H, int reverse,
                int act_in, int act_gate, int act_state, int G, int gpb, int R, int QP, int KC,
                int w_smem) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;              // the mma fragments' lane coordinates
  const int p = blockIdx.x / G;                       // row group
  const int row0 = p * R;                             // its first row
  const int rows = max(0, min(B, row0 + R) - row0);   // and how many (0 when B < P R)
  const int U = kUnits * gpb;
  const int u0 = (blockIdx.x % G) * U;                // the block's first unit
  const int u1 = min(H, u0 + U);                      // and its end
  const int nq = U / 4;                               // quads
  const int RT = 16 * (kWarpsPerPass / QP);           // rows of a pass
  constexpr int kV = 16 / static_cast<int>(sizeof(S));  // values in 16 bytes
  const int SR = KC + kV;                             // values of a staged row
  const long long Hp = (H + kV - 1) / kV * kV;
  const long long WQ = quad_floats(H);
  const long long H4 = 4LL * H;
  float* W = w_smem ? smem : wslices + static_cast<long long>(blockIdx.x) * nq * WQ;
  float* CS = smem + (w_smem ? nq * WQ : 0);          // c of the owned cells [R][U]
  float* HS = CS + static_cast<long long>(R) * U;     // the carried h [R][U]
  // the staged h chunks, in S
  S* ring = reinterpret_cast<S*>(HS + static_cast<long long>(R) * U);
  // 7b carries h in its hprev residual when every row starts on 16 bytes
  const bool hres = kResiduals && hbuf == nullptr;
  const long long ldh = hres ? H : Hp;
  GridBarrier bar{counters + p, 0, static_cast<unsigned>(G)};
  const bool clocked = phase_ns != nullptr && blockIdx.x == 0 && tid == 0;

  // this warp's M tile of each pass (rows mt 16 ..) and quad pair (quads
  // 2 qp, 2 qp + 1); this lane's cells: rows mt 16 + g + 8 hh, units
  // 4 (2 qp + qq) + t, for hh, qq < 2 (cell 2 hh + qq)
  const int mt = warp / QP, qp = warp % QP;
  int jc[2];                                          // the lane's units, or -1
#pragma unroll
  for (int qq = 0; qq < 2; ++qq) {
    const int j = u0 + 4 * (2 * qp + qq) + t;
    jc[qq] = 2 * qp + qq < nq && j < u1 ? j : -1;
  }

  // the block's columns of w: quad q's column c (of 16) holds unit
  // (c % 8) / 2 of the quad, gate 2 (c / 8) + c % 2 (n-tile 0 of a quad is
  // gates 0 and 1 of its 4 units, n-tile 1 gates 2 and 3), stored on row k
  // at c ^ swz(k) (swz(k) = 8 on rows k = 2, 3 mod 4); units past the
  // block's own and rows past H are 0
  for (long long i = tid; i < nq * WQ; i += kThreads) {
    const int q = static_cast<int>(i / WQ);
    const long long e = i % WQ;
    const int k = static_cast<int>(e / 16);
    const int c = static_cast<int>(e % 16) ^ (8 * ((k >> 1) & 1));
    const int jj = u0 + 4 * q + (c % 8) / 2, gate = 2 * (c / 8) + c % 2;
    if (k >= H || jj >= u1) {
      W[i] = 0.0f;
    } else if (w_smem) {
      stage_f32(W + i, w + k * H4 + gate * static_cast<long long>(H) + jj);
    } else {
      W[i] = to_f32(w[k * H4 + gate * static_cast<long long>(H) + jj]);
    }
  }
  for (long long i = tid; i < 2LL * R * U; i += kThreads) CS[i] = 0.0f;
  float pi[2], pf[2], po[2];
#pragma unroll
  for (int qq = 0; qq < 2; ++qq) {
    const int j = jc[qq] < 0 ? 0 : jc[qq];
    pi[qq] = to_f32(peep[j]);
    pf[qq] = to_f32(peep[H + j]);
    po[qq] = to_f32(peep[2 * H + j]);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int passes = (rows + RT - 1) / RT;
  const int NC = (H + KC - 1) / KC;                   // chunks of a pass
  // this thread's copies of a chunk: its column group c4 (of KC / kV, a
  // power of 2 that divides 256) of rows rs, rs + rstep, ...
  const int c4 = tid % (KC / kV), rs = tid / (KC / kV), rstep = kThreads / (KC / kV);
  const float* Wq[2] = {W + (2 * qp) * WQ, W + (2 * qp + 1) * WQ};
  const bool quad_ok[2] = {2 * qp < nq, 2 * qp + 1 < nq};
  // the x4 and mask of this lane's cells at time index tt, rows r0 + g
  // (+ 8) of the group
  float xv[4][4], mv[2];
  auto load_x = [&](int tt, int r0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r0 + g + 8 * hh;
      mv[hh] = r < rows ? mask[tt * m_st + (row0 + r) * m_sb] : 0.0f;
#pragma unroll
      for (int qq = 0; qq < 2; ++qq) {
        const bool ok = jc[qq] >= 0 && r < rows;
        const S* xr = x4 + tt * x_st + (row0 + (ok ? r : 0)) * x_sb + (ok ? jc[qq] : 0);
#pragma unroll
        for (int gate = 0; gate < 4; ++gate)
          xv[2 * hh + qq][gate] = ok ? to_f32(xr[gate * H]) : 0.0f;
      }
    }
  };
  for (int s = 0; s < T; ++s) {
    if (clocked) phase_ns[3 * s] = global_ns();
    const int tt = reverse ? T - 1 - s : s;
    const long long tB = static_cast<long long>(tt) * B;
    const bool next = s + 1 < T;
    const int tn = reverse ? tt - 1 : tt + 1;
    // the carry into this step (none at the first) and out of it
    const S* hin = s == 0 ? nullptr
                   : hres ? hprev + tB * H
                          : hbuf + static_cast<long long>(s & 1) * B * Hp;
    S* hout = !next ? nullptr
                  : hres ? hprev + static_cast<long long>(tn) * B * H
                         : hbuf + static_cast<long long>((s + 1) & 1) * B * Hp;

    // the staged chunks of this step: pass q / NC, columns (q % NC) KC ..,
    // 16 bytes a copy, zero past H and past the group's rows
    const int total = s > 0 ? passes * NC : 0;
    auto issue = [&](int q) {
      const int r0 = (q / NC) * RT, k = (q % NC) * KC + kV * c4;
      // bytes of this column group
      const int n = k < H ? static_cast<int>(sizeof(S)) * min(kV, H - k) : 0;
      S* dst = ring + (q % kStages) * RT * SR + kV * c4;
      const S* src = hin + static_cast<long long>(row0 + r0) * ldh + k;
      for (int r = rs; r < RT; r += rstep) {
        const bool ok = n > 0 && r0 + r < rows;
        cp_async16_cg_part(reinterpret_cast<float*>(dst + r * SR),
                           reinterpret_cast<const float*>(ok ? src + r * ldh : hin), ok ? n : 0);
      }
    };
    for (int c = 0; c < kStages - 1; ++c) {
      if (c < total) issue(c);
      cp_async_commit();
    }

    int q = 0;                                        // chunks consumed this step
    for (int pass = 0; pass < passes; ++pass) {
      const int r0 = pass * RT + 16 * mt;             // this warp's M tile
      // the x4 and mask of this lane's cells, loaded now and used after
      // the product
      load_x(tt, r0);
      // acc[qq][n-tile][fragment]: C fragment c0 (g, 2t), c1 (g, 2t + 1),
      // c2 (g + 8, 2t), c3 (g + 8, 2t + 1) of n-tile 2 qq + j
      float acc[2][2][4];
#pragma unroll
      for (int qq = 0; qq < 2; ++qq)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[qq][j][e] = 0.0f;
      if (s > 0) {
        for (int ch = 0; ch < NC; ++ch, ++q) {
          // chunk q has landed (kStages - 2 later ones may be in flight),
          // every thread sees it, and every thread is done with chunk
          // q - 1, whose slot chunk q + kStages - 1 takes
          cp_async_wait<kStages - 2>();
          __syncthreads();
          if (q + kStages - 1 < total) issue(q + kStages - 1);
          cp_async_commit();
          const int k0 = ch * KC;
          const int steps = (min(KC, H - k0) + 7) / 8;
          const S* hs = ring + (q % kStages) * RT * SR + (16 * mt + g) * SR + t;
          // the chunk's sums apart, the big TF32 product and the two
          // small ones in accumulators of their own (independent mmas;
          // bf16 operands have no small halves: one pass)
          float pb[2][2][4], ps[2][2][4];
#pragma unroll
          for (int qq = 0; qq < 2; ++qq)
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) pb[qq][j][e] = ps[qq][j][e] = 0.0f;
          for (int kk = 0; kk < steps; ++kk) {
            flash_mma::FragA a;
            const S* ap = hs + 8 * kk;
            a.set(to_f32(ap[0]), to_f32(ap[8 * SR]), to_f32(ap[4]), to_f32(ap[8 * SR + 4]));
            // B (k, n) of n-tile j of a quad: w row k0 + 8 kk + k, column
            // 8 j + n, XOR 8 on rows 2, 3 (mod 4): t >> 1 for k = t, t + 4
            const int krow = (k0 + 8 * kk + t) * 16;
#pragma unroll
            for (int qq = 0; qq < 2; ++qq) {
              if (!quad_ok[qq]) continue;             // uniform over the warp
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                const int col = (8 * j + g) ^ (8 * (t >> 1));
                flash_mma::FragB b;
                b.set(Wq[qq][krow + col], Wq[qq][krow + 64 + col]);
                if constexpr (IsF32<S>::value) {
                  flash_mma::mma_tf32(ps[qq][j], a.small, b.big);
                  flash_mma::mma_tf32(ps[qq][j], a.big, b.small);
                }
                flash_mma::mma_tf32(pb[qq][j], a.big, b.big);
              }
            }
          }
#pragma unroll
          for (int qq = 0; qq < 2; ++qq)
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[qq][j][e] += ps[qq][j][e] + pb[qq][j][e];
        }
      }
      if (clocked && pass + 1 == passes) phase_ns[3 * s + 1] = global_ns();

      // the cells this lane holds: gates 0 and 1 in n-tile 0, 2 and 3 in 1
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = r0 + g + 8 * hh;
#pragma unroll
        for (int qq = 0; qq < 2; ++qq) {
          const int j = jc[qq];
          if (j < 0 || r >= rows) continue;
          const float* xg = xv[2 * hh + qq];
          const float ga = acc[qq][0][2 * hh], gi = acc[qq][0][2 * hh + 1];
          const float gf = acc[qq][1][2 * hh], go = acc[qq][1][2 * hh + 1];
          const int b = row0 + r;
          const long long row = tB + b;
          float* cs = CS + r * U + (j - u0);
          float* hs = HS + r * U + (j - u0);
          const float cp = *cs, hp = *hs, m = mv[hh];
          const float ig = act_f32(act_gate, xg[1] + gi + pi[qq] * cp);
          const float fg = act_f32(act_gate, xg[2] + gf + pf[qq] * cp);
          const float a = act_f32(act_in, xg[0] + ga);
          const float cn = fg * cp + ig * a;
          const float og = act_f32(act_gate, xg[3] + go + po[qq] * cn);
          const float hnew = og * act_f32(act_state, cn);
          const float h = m * hnew + (1.0f - m) * hp;
          if (next) stcg_as(hout + b * ldh + j, h);
          *hs = h;
          *cs = m * cn + (1.0f - m) * cp;
          ys[tt * y_st + b * y_sb + j] = from_f32<S>(m * hnew);
          if (kResiduals) {
            S* ar = acts + row * H4 + j;
            ar[0] = from_f32<S>(a);
            ar[H] = from_f32<S>(ig);
            ar[2 * H] = from_f32<S>(fg);
            ar[3 * H] = from_f32<S>(og);
            cprev[row * H + j] = cp;
            // with hres the previous step wrote hprev[tt] as its carry
            if (!hres || s == 0) hprev[row * H + j] = from_f32<S>(hp);
          }
        }
      }
    }
    if (clocked) phase_ns[3 * s + 2] = global_ns();
    if (next) bar.sync();                             // the group's carry is written
  }
}

template <bool kResiduals, typename S>
cudaError_t launch(const FwdPlan& plan, size_t smem, const S* x4, long long x_st,
                   long long x_sb, const float* mask, long long m_st, long long m_sb,
                   const S* w, const S* peep, S* ys, long long y_st, long long y_sb,
                   S* acts, S* hprev, float* cprev, S* hbuf, float* wslices,
                   unsigned* counters, unsigned long long* phase_ns, int T, int B, int H,
                   int reverse, int act_in, int act_gate, int act_state, int w_smem,
                   cudaStream_t st) {
  return launch_cooperative(lstm_fwd_kernel<kResiduals, S>, plan.P * plan.G, smem, st,
                            x4, x_st, x_sb, mask, m_st, m_sb, w, peep, ys, y_st, y_sb, acts,
                            hprev, cprev, hbuf, wslices, counters, phase_ns, T, B, H, reverse,
                            act_in, act_gate, act_state, plan.G, plan.gpb, plan.R, plan.QP,
                            plan.KC, w_smem);
}

template <bool kResiduals, typename S>
int run(const void* x4, long long x_st, long long x_sb, const void* mask, long long m_st,
        long long m_sb, const void* w, const void* peep, void* ys, long long y_st,
        long long y_sb, void* acts, void* hprev, void* cprev, void* hbuf, void* wslices,
        void* counters, void* phase_ns, int T, int B, int H, int reverse, int act_in,
        int act_gate, int act_state, int num_sms, int row_groups, int w_smem, void* stream) {
  if (T < 0 || B < 0 || H <= 0 || row_groups < 1 || row_groups > num_sms)
    return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0 || B == 0) return static_cast<int>(cudaSuccess);
  const FwdPlan plan = make_fwd_plan(B, H, num_sms, row_groups);
  const size_t smem = fwd_smem_floats(plan, H, w_smem) * sizeof(float);
  // 7b without the scratch carries h in hprev: rows of 16 bytes (H a
  // multiple of 4 floats or 8 bf16)
  const bool hres_ok = kResiduals && (H * sizeof(S)) % 16 == 0
                       && reinterpret_cast<uintptr_t>(hprev) % 16 == 0;
  if (plan.RT < 1 || smem > kSmemLimit || (!w_smem && wslices == nullptr)
      || (hbuf == nullptr && !hres_ok) || reinterpret_cast<uintptr_t>(hbuf) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(counters, 0, plan.P * sizeof(unsigned), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch<kResiduals, S>(
      plan, smem, static_cast<const S*>(x4), x_st, x_sb, static_cast<const float*>(mask),
      m_st, m_sb, static_cast<const S*>(w), static_cast<const S*>(peep),
      static_cast<S*>(ys), y_st, y_sb, static_cast<S*>(acts), static_cast<S*>(hprev),
      static_cast<float*>(cprev), static_cast<S*>(hbuf), static_cast<float*>(wslices),
      static_cast<unsigned*>(counters), static_cast<unsigned long long*>(phase_ns), T, B, H,
      reverse, act_in, act_gate, act_state, w_smem, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x4 [T, B, 4H], mask [T, B] and ys [T, B, H] are addressed through their
// time and batch strides (in elements; the last dimension is contiguous);
// w [H, 4H] and peep [3, H] are contiguous. act_* are the activation codes
// of common.cuh (0 tanh, 1 sigmoid, 2 relu, 3 linear). The grid: num_sms
// (the card's SM count) and row_groups P (1 <= P <= num_sms;
// fused_lstm.fwd_plan); w_smem says whether a block keeps its columns of w
// in shared memory. Scratch: hbuf, the carry [2][B][Hp] (Hp = H rounded up
// to a multiple of 4; 16-byte aligned); wslices (blocks * U / 4 quads of
// 16 ceil(H / 8) 8 + 16 floats each) where w_smem is 0; counters (P
// unsigned). phase_ns, when not null ([T][3] unsigned 64-bit integers),
// receives block 0's clock in ns at each step's start, at the end of its
// product and at the end of its cells (before the barrier). Launches on `stream`
// (cooperatively; nothing for T = 0 or B = 0); returns the launch's error,
// cudaErrorCooperativeLaunchTooLarge, or cudaErrorInvalidValue for a plan
// past what a block may hold or a missing scratch buffer.
extern "C" int lstm_fwd(const void* x4, long long x_st, long long x_sb,
                        const void* mask, long long m_st, long long m_sb,
                        const void* w, const void* peep,
                        void* ys, long long y_st, long long y_sb,
                        void* hbuf, void* wslices, void* counters, void* phase_ns,
                        int T, int B, int H, int reverse,
                        int act_in, int act_gate, int act_state, int num_sms, int row_groups,
                        int w_smem, void* stream) {
  return run<false, float>(x4, x_st, x_sb, mask, m_st, m_sb, w, peep, ys, y_st, y_sb, nullptr,
                    nullptr, nullptr, hbuf, wslices, counters, phase_ns, T, B, H, reverse,
                    act_in, act_gate, act_state, num_sms, row_groups, w_smem, stream);
}

// As lstm_fwd, plus the residuals: acts [T, B, 4H] (post-activation a, i, f,
// o), hprev and cprev [T, B, H], all contiguous. hbuf may be null where H %
// 4 == 0: the carry then passes through hprev.
extern "C" int lstm_fwd_train(const void* x4, long long x_st, long long x_sb,
                              const void* mask, long long m_st, long long m_sb,
                              const void* w, const void* peep,
                              void* ys, long long y_st, long long y_sb,
                              void* acts, void* hprev, void* cprev,
                              void* hbuf, void* wslices, void* counters, void* phase_ns,
                              int T, int B, int H, int reverse,
                              int act_in, int act_gate, int act_state, int num_sms,
                              int row_groups, int w_smem, void* stream) {
  return run<true, float>(x4, x_st, x_sb, mask, m_st, m_sb, w, peep, ys, y_st, y_sb, acts, hprev,
                   cprev, hbuf, wslices, counters, phase_ns, T, B, H, reverse, act_in,
                   act_gate, act_state, num_sms, row_groups, w_smem, stream);
}

// lstm_fwd's bf16 instance: x4, w, peep, ys and the scratch carry hbuf
// ([2][B][Hp], Hp = H rounded up to a multiple of 8) are bf16
// (__nv_bfloat16); mask, wslices and counters as lstm_fwd's.
extern "C" int lstm_fwd_bf16(const void* x4, long long x_st, long long x_sb,
                             const void* mask, long long m_st, long long m_sb,
                             const void* w, const void* peep,
                             void* ys, long long y_st, long long y_sb,
                             void* hbuf, void* wslices, void* counters, void* phase_ns,
                             int T, int B, int H, int reverse,
                             int act_in, int act_gate, int act_state, int num_sms,
                             int row_groups, int w_smem, void* stream) {
  return run<false, __nv_bfloat16>(x4, x_st, x_sb, mask, m_st, m_sb, w, peep, ys, y_st, y_sb,
                                   nullptr, nullptr, nullptr, hbuf, wslices, counters, phase_ns,
                                   T, B, H, reverse, act_in, act_gate, act_state, num_sms,
                                   row_groups, w_smem, stream);
}

// lstm_fwd_train's bf16 instance: also acts and hprev in bf16, cprev in
// float32. hbuf may be null where H % 8 == 0: the carry then passes
// through hprev.
extern "C" int lstm_fwd_train_bf16(const void* x4, long long x_st, long long x_sb,
                                   const void* mask, long long m_st, long long m_sb,
                                   const void* w, const void* peep,
                                   void* ys, long long y_st, long long y_sb,
                                   void* acts, void* hprev, void* cprev,
                                   void* hbuf, void* wslices, void* counters, void* phase_ns,
                                   int T, int B, int H, int reverse,
                                   int act_in, int act_gate, int act_state, int num_sms,
                                   int row_groups, int w_smem, void* stream) {
  return run<true, __nv_bfloat16>(x4, x_st, x_sb, mask, m_st, m_sb, w, peep, ys, y_st, y_sb,
                                  acts, hprev, cprev, hbuf, wslices, counters, phase_ns, T, B,
                                  H, reverse, act_in, act_gate, act_state, num_sms, row_groups,
                                  w_smem, stream);
}
