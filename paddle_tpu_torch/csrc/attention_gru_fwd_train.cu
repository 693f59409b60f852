// attention_gru_fwd_train — the fused attention-GRU decoder loop over a
// whole target sequence in one launch, saving the residuals its backward
// reads (kernel 5).
//
// Replaces: paddle_tpu/ops/pallas_attention_gru.py _fwd_kernel with
// residuals (the custom-VJP forward of fused_attention_gru, launched by
// pl.pallas_call in _run_fwd, one launch per training step).
//
// The kernel is attention_gru_fwd.cuh's persistent grid with kResiduals
// set: what it computes, what bounds it and its design are described
// there. Kernel 4 (attention_gru_fwd.cu) is the same body without them.

#include "attention_gru_fwd.cuh"

namespace {

// Measures the grid barrier alone: `iters` barriers over `blocks` blocks
// holding `smem` bytes each (so that they sit one to an SM, as the
// attention-GRU kernels do).
__global__ void __launch_bounds__(kThreads, 1) grid_barrier_bench_kernel(unsigned* counter,
                                                                        int iters) {
  GridBarrier bar{counter, 0};
  for (int i = 0; i < iters; ++i) bar.sync();
}

}  // namespace

// ep [Te, B, D], ev [Te, B, E] and em [Te, B] are addressed through their
// time and batch strides (in elements; the last dimension is contiguous).
// xw [Td, B, 3D], dmask [Td, B], h0 [B, D], wa [D, D], ba [D], v [D],
// wctx [E, 3D], wg [D, 3D], the outputs ys [Td, B, D], hprev [Td, B, D],
// acts [Td, B, 3D], alpha [Td, B, Te], ctxs [Td, B, E], m_all [Td, B, D]
// and the scratch rhbuf [B, D] are contiguous; counter is one unsigned of
// scratch.
// num_sms is the card's SM count. Launches on `stream` (cooperatively);
// returns the launch's error, cudaErrorCooperativeLaunchTooLarge or the
// shared-memory opt-in's error for a shape the grid cannot hold.
extern "C" int attention_gru_fwd_train(const void* ep, long long ep_st, long long ep_sb,
                                       const void* ev, long long ev_st, long long ev_sb,
                                       const void* em, long long em_st, long long em_sb,
                                       const void* xw, const void* dmask, const void* h0,
                                       const void* wa, const void* ba, const void* v,
                                       const void* wctx, const void* wg, void* ys,
                                       void* hprev, void* acts, void* alpha, void* ctxs,
                                       void* m_all, void* rhbuf, void* counter,
                                       int Td, int B, int Te, int D, int E, int num_sms,
                                       void* stream) {
  if (Td <= 0 || B <= 0 || Te <= 0 || D <= 0 || E <= 0) return static_cast<int>(cudaSuccess);
  return launch_fwd<true>(ep, ep_st, ep_sb, ev, ev_st, ev_sb, em, em_st, em_sb, xw, dmask, h0,
                          wa, ba, v, wctx, wg, ys, hprev, acts, alpha, ctxs, m_all, rhbuf,
                          counter, Td, B, Te, D, E, num_sms, stream);
}

// attention_gru_fwd_train's bf16 instance: every pointer argument but
// m_all (float32) and counter is bf16 (__nv_bfloat16), em and dmask too.
extern "C" int attention_gru_fwd_train_bf16(
    const void* ep, long long ep_st, long long ep_sb, const void* ev, long long ev_st,
    long long ev_sb, const void* em, long long em_st, long long em_sb, const void* xw,
    const void* dmask, const void* h0, const void* wa, const void* ba, const void* v,
    const void* wctx, const void* wg, void* ys, void* hprev, void* acts, void* alpha,
    void* ctxs, void* m_all, void* rhbuf, void* counter, int Td, int B, int Te, int D, int E,
    int num_sms, void* stream) {
  if (Td <= 0 || B <= 0 || Te <= 0 || D <= 0 || E <= 0) return static_cast<int>(cudaSuccess);
  return launch_fwd<true, __nv_bfloat16>(ep, ep_st, ep_sb, ev, ev_st, ev_sb, em, em_st, em_sb,
                                         xw, dmask, h0, wa, ba, v, wctx, wg, ys, hprev, acts,
                                         alpha, ctxs, m_all, rhbuf, counter, Td, B, Te, D, E,
                                         num_sms, stream);
}

// `iters` grid barriers of `blocks` blocks with `smem` bytes of shared
// memory each, cooperatively on `stream` (counter: one unsigned of scratch).
extern "C" int grid_barrier_bench(void* counter, int iters, int blocks, int smem,
                                  void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(counter, 0, sizeof(unsigned), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_cooperative(grid_barrier_bench_kernel, blocks, static_cast<size_t>(smem), st,
                           static_cast<unsigned*>(counter), iters);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
