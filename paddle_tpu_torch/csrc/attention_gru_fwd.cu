// attention_gru_fwd — the fused attention-GRU decoder loop in one launch,
// inference form (kernel 4).
//
// Replaces: paddle_tpu/ops/pallas_attention_gru.py _fwd_kernel_light
// (the inference variant launched by pl.pallas_call in _run_fwd, entry
// fused_attention_gru; attention_gru_step is its one-step form; serving
// launches it with Td = 1 once per decode micro-step, the decoder route
// without gradients with Td = T).
//
// The kernel is attention_gru_fwd.cuh's persistent grid without the
// residuals: what it computes, what bounds it and its design are described
// there. At Td = 1 one launch is one step of kernel 5 (three grid
// barriers) plus what every launch pays: the cooperative launch and each
// block's load of its ~80 KB weight slice, which the serve path finds in
// device memory (its 61 MB output product evicts the L2 between steps).
// attention_gru_fwd_slices times that load alone.

#include "attention_gru_fwd.cuh"

// ep [Te, B, D], ev [Te, B, E] and em [Te, B] are addressed through their
// time and batch strides (in elements; the last dimension is contiguous).
// xw [Td, B, 3D], dmask [Td, B], h0 [B, D], wa [D, D], ba [D], v [D],
// wctx [E, 3D], wg [D, 3D] and ys [Td, B, D] are contiguous, and so is the
// scratch: the carry hbuf [B, D], m [B, D], ctx [B, E], rhbuf [B, D] and
// the barrier's counter (one unsigned). num_sms is the card's SM count.
// Launches on `stream` (cooperatively); returns the launch's error,
// cudaErrorCooperativeLaunchTooLarge or the shared-memory opt-in's error
// for a shape the grid cannot hold.
extern "C" int attention_gru_fwd(const void* ep, long long ep_st, long long ep_sb,
                                 const void* ev, long long ev_st, long long ev_sb,
                                 const void* em, long long em_st, long long em_sb,
                                 const void* xw, const void* dmask, const void* h0,
                                 const void* wa, const void* ba, const void* v,
                                 const void* wctx, const void* wg, void* ys,
                                 void* hbuf, void* m, void* ctx, void* rhbuf, void* counter,
                                 int Td, int B, int Te, int D, int E, int num_sms,
                                 void* stream) {
  if (Td <= 0 || B <= 0 || Te <= 0 || D <= 0 || E <= 0) return static_cast<int>(cudaSuccess);
  return launch_fwd<false>(ep, ep_st, ep_sb, ev, ev_st, ev_sb, em, em_st, em_sb, xw, dmask, h0,
                           wa, ba, v, wctx, wg, ys, hbuf, nullptr, nullptr, ctx, m, rhbuf,
                           counter, Td, B, Te, D, E, num_sms, stream);
}

// The same launch with no step: each block loads its weight slices and
// ends. Its time less an empty cooperative launch's on the same grid is
// the slice load's.
extern "C" int attention_gru_fwd_slices(const void* ep, long long ep_st, long long ep_sb,
                                        const void* ev, long long ev_st, long long ev_sb,
                                        const void* em, long long em_st, long long em_sb,
                                        const void* xw, const void* dmask, const void* h0,
                                        const void* wa, const void* ba, const void* v,
                                        const void* wctx, const void* wg, void* ys,
                                        void* hbuf, void* m, void* ctx, void* rhbuf,
                                        void* counter, int Td, int B, int Te, int D, int E,
                                        int num_sms, void* stream) {
  if (B <= 0 || Te <= 0 || D <= 0 || E <= 0) return static_cast<int>(cudaSuccess);
  (void)Td;
  return launch_fwd<false>(ep, ep_st, ep_sb, ev, ev_st, ev_sb, em, em_st, em_sb, xw, dmask, h0,
                           wa, ba, v, wctx, wg, ys, hbuf, nullptr, nullptr, ctx, m, rhbuf,
                           counter, 0, B, Te, D, E, num_sms, stream);
}
