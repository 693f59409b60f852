"""The fused attention-GRU decoder loop: CUDA kernels 4-6 and their plain versions.

Port of ``paddle_tpu/ops/pallas_attention_gru.py``: ``fused_attention_gru``
with its inference kernel (``_fwd_kernel_light`` ->
``csrc/attention_gru_fwd.cu::attention_gru_fwd``), its training forward
that also saves the residuals (``_fwd_kernel`` ->
``csrc/attention_gru_fwd_train.cu``; the two share one body,
``csrc/attention_gru_fwd.cuh``)
and its backward (``_bwd_kernel`` -> ``csrc/attention_gru_bwd.cu``), and
the one-step form ``attention_gru_step``, which is the serve decode step.
Per decoder step:

    m     = h @ wa + ba
    s     = sum_D tanh(ep + m) * v            [Te, B], -1e30 where em = 0
    alpha = masked softmax of s over Te       (0 at padding; an all-masked row gives 0)
    ctx   = sum_Te alpha * ev                 [B, E]
    din   = ctx @ wctx + xw_t                 (word projection and biases ride xw)
    h'    = GRU(h, din) with wg [D, 3D]

The output stream is the raw h'; the carry is h' where dmask = 1 and h
where dmask = 0. :func:`fused_attention_gru` launches the kernels for CUDA
tensors and raises on anything they do not take: the training pair (a
``torch.autograd.Function``) when grad mode is on and an input requires a
gradient, the light forward otherwise. For CPU tensors it runs
:func:`attention_gru_reference`, and autograd through it gives the
gradients.

The backward kernel computes the kernel's own outputs of the JAX package
(d_din = dxw, the d_ctx stream, dh0, d_enc_proj, dWa, dba, dv); dW_ctx,
dW_gru and d_enc_vec are products of those streams, taken with
``torch.matmul`` / ``torch.einsum`` as the JAX package leaves them to XLA.
The masks get no gradient.

All three kernels run as persistent, cooperative grids (one block on each
SM, its weight slices held in shared memory for the whole launch; see
``csrc/persistent_grid.cuh``). :func:`supported` states the shapes they
take. The decoder route (``graph/fused_decoder.py``) asks it before any
launch and runs the recurrent group's loop for anything else, and the
serve step (:func:`attention_gru_step`) asks it and runs the plain step;
both count that in ``EAGER_ROUTES``. The wrappers raise on a shape it
refuses.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from paddle_tpu_torch.ops import kernel_flops
from paddle_tpu_torch.ops._build import (
    I32, I64, PTR, SMEM_LIMIT, CudaKernel, card_sms, check, ptr)
from paddle_tpu_torch.ops.fused_gru import KERNEL_ACTS, _last_dim_contiguous, gru_cell

Tensor = torch.Tensor

_FWD_ARGS = [PTR, I64, I64,            # ep, its time and batch strides
             PTR, I64, I64,            # ev
             PTR, I64, I64,            # em
             PTR, PTR, PTR,            # xw, dmask, h0
             PTR, PTR, PTR,            # wa, ba, v
             PTR, PTR, PTR]            # wctx, wg, ys
_DIMS = [I32, I32, I32, I32, I32]      # Td, B, Te, D, E
_LIGHT_ARGS = (_FWD_ARGS + [PTR, PTR, PTR, PTR, PTR]   # scratch: h, m, ctx, r*h, the counter
               + _DIMS + [I32])                        # num_sms
ATTENTION_GRU_FWD = CudaKernel("attention_gru_fwd.cu", "attention_gru_fwd", _LIGHT_ARGS)
# kernel 4's launch with no step: its weight-slice load alone (chip_smoke.py)
ATTENTION_GRU_FWD_SLICES = CudaKernel("attention_gru_fwd.cu", "attention_gru_fwd_slices",
                                      _LIGHT_ARGS)
ATTENTION_GRU_FWD_TRAIN = CudaKernel(
    "attention_gru_fwd_train.cu", "attention_gru_fwd_train",
    _FWD_ARGS + [PTR, PTR, PTR, PTR, PTR]   # hprev, acts, alpha, ctxs, m
    + [PTR, PTR]                            # scratch: r*h [B, D], the barrier counter
    + _DIMS + [I32])                        # num_sms
ATTENTION_GRU_BWD = CudaKernel(
    "attention_gru_bwd.cu", "attention_gru_bwd",
    [PTR, I64, I64,            # dy, its time and batch strides
     PTR, I64, I64,            # ep
     PTR, I64, I64,            # ev
     PTR, PTR, PTR, PTR, PTR,  # dmask, hprev, acts, alpha, m
     PTR, PTR, PTR, PTR,       # wa, v, wctx, wg
     PTR, PTR, PTR,            # dxw, dctx, dh0
     PTR, I64, I64,            # dep, its time and batch strides
     PTR, PTR, PTR,            # dwa, dba, dv
     PTR, PTR, PTR]            # scratch: d_m rows, dv and dba partials, the barrier counter
    + _DIMS + [I32])           # num_sms
KERNELS = (ATTENTION_GRU_FWD, ATTENTION_GRU_FWD_TRAIN, ATTENTION_GRU_BWD)

# Decoder groups that matched the template and serve steps that ran their
# plain computation because supported() refused their shapes
# (graph/fused_decoder.py, attention_gru_step).
EAGER_ROUTES = 0

# How kernels 4-6 cut the work: csrc/persistent_grid.cuh make_plan and
# the shared-memory sums of attention_gru_fwd.cuh and attention_gru_bwd.cu,
# mirrored here.
UNITS = 4               # hidden units in a unit group: a block's slice of D
E_ROWS = 8              # rows of wctx in an e-group (the backward's d_ctx)
DWA_STAGE = 4 * 32 * (32 + 64)   # bytes: the backward's staged dWa operands


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def grid_plan(B: int, Te: int, D: int, E: int, sms: int) -> Dict[str, int]:
    """Blocks, shared memory per block and work split of kernels 4-6
    (kernel 4 is kernel 5's body without the residuals: the same grid and
    ``fwd_smem_bytes``).

    ceil(D / 4) unit groups of 4 hidden units go to min(sms, groups)
    blocks, one to an SM, and each block keeps its groups' weight slices
    (in the backward also ceil(E / 8) e-groups of wctx rows, spread over the
    same blocks) for the whole launch. The attention phase splits each
    batch row over ``parts`` blocks when there are more blocks than rows.
    The backward keeps d_enc_proj in shared memory when it fits, else in
    place in its output."""
    groups = _cdiv(D, UNITS)
    blocks = min(sms, groups)
    gpb = _cdiv(groups, blocks)
    epb = _cdiv(_cdiv(E, E_ROWS), blocks)
    parts = max(1, blocks // B)
    ipb = _cdiv(B * parts, blocks)
    dlen = _cdiv(D, parts)
    fwd = 4 * (gpb * (16 * D + 12 * E + 32 * B) + 2 * D + Te)
    bwd = 4 * (gpb * (16 * D + 16 * B) + epb * 24 * D + 8 * B + D + E
               + _cdiv(Te, 4) * 4 + 2 * ipb * dlen)
    dep_in_smem = max(bwd + 4 * ipb * dlen * Te, DWA_STAGE) <= SMEM_LIMIT
    if dep_in_smem:
        bwd += 4 * ipb * dlen * Te
    bwd = max(bwd, DWA_STAGE)
    return dict(blocks=blocks, unit_groups_per_block=gpb, e_groups_per_block=epb,
                parts=parts, fwd_smem_bytes=fwd, bwd_smem_bytes=bwd,
                bwd_dep_in_smem=int(dep_in_smem))


def grid_barriers(Td: int) -> Tuple[int, int]:
    """The grid barriers one launch of kernel 4 or 5, and of kernel 6, passes."""
    return 4 * Td - 1, 4 * Td


def supported(B: int, Te: int, D: int, E: int, num_sms: Optional[int] = None) -> bool:
    """Whether kernels 4-6 take a decoder of batch B over Te encoder
    positions, width D and encoder width E.

    Every dimension is at least 1 and the shared memory of a block of each
    kernel is within SMEM_LIMIT (kernel 4's is kernel 5's); the grid is at
    most one block per SM, so the card holds it at once. ``num_sms``
    defaults to the current card's count (132 where there is no card)."""
    if min(B, Te, D, E) < 1:
        return False
    plan = grid_plan(B, Te, D, E, card_sms() if num_sms is None else num_sms)
    return max(plan["fwd_smem_bytes"], plan["bwd_smem_bytes"]) <= SMEM_LIMIT


def _check_supported(B, Te, D, E, dev):
    if not supported(B, Te, D, E, card_sms(dev)):
        raise ValueError(
            f"the attention-GRU kernels do not take B={B}, Te={Te}, D={D}, "
            f"E={E} (fused_attention_gru.supported: every dimension at least 1 and "
            f"a block's shared memory within {SMEM_LIMIT} bytes)")


def _step(h, ep, ev, em, xw_t, wa, ba, v, wctx, wg, acts, residuals=False):
    """One decoder step of the plain version; h [B, D] -> h' [B, D], or
    (h', u, r, c, alpha [Te, B], ctx [B, E]) with ``residuals``."""
    D = h.shape[-1]
    m = h @ wa + ba.reshape(1, D)                               # [B, D]
    s = (torch.tanh(ep + m[None]) @ v.reshape(D, 1))[..., 0]     # [Te, B]
    valid = em[:, :, 0] > 0                                     # [Te, B]
    s = torch.where(valid, s, torch.full_like(s, -1e30))
    e = torch.exp(s - torch.max(s, dim=0, keepdim=True).values)
    alpha = e / torch.sum(e, dim=0, keepdim=True)
    alpha = torch.where(valid, alpha, torch.zeros_like(alpha))
    ctx = torch.einsum("tb,tbe->be", alpha, ev)                 # [B, E]
    din = ctx @ wctx + xw_t                                     # [B, 3D]
    if not residuals:
        return gru_cell(din, h, wg, acts)
    return gru_cell(din, h, wg, acts, gates=True) + (alpha, ctx)


def attention_gru_reference(ep, ev, em, xw, dmask, h0, wa, ba, v, wctx, wg,
                            acts: Tuple[str, str] = KERNEL_ACTS, residuals: bool = False):
    """Plain PyTorch version of the kernels (shapes as :func:`fused_attention_gru`).

    ``residuals=True`` also returns what ``attention_gru_fwd_train`` saves:
    (ys, hprev [Td, B, D], acts = [u | r | c] [Td, B, 3D], alpha
    [Td, B, Te], ctx [Td, B, E]); the kernel also saves m [Td, B, D]."""
    h = h0
    ys, saved = [], []
    for t in range(xw.shape[0]):
        out = _step(h, ep, ev, em, xw[t], wa, ba, v, wctx, wg, acts, residuals)
        h_new = out[0] if residuals else out
        if residuals:
            u, r, c, alpha, ctx = out[1:]
            saved.append((h, torch.cat([u, r, c], dim=-1), alpha.transpose(0, 1), ctx))
        ys.append(h_new)
        dm = dmask[t]
        h = dm * h_new + (1.0 - dm) * h
    ys = torch.stack(ys)
    if not residuals:
        return ys
    return (ys,) + tuple(torch.stack(z) for z in zip(*saved))


def _check_operands(ep, ev, em, xw, dmask, h0, wa, ba, v, wctx, wg, acts):
    Te, B, D = ep.shape
    E = ev.shape[2]
    Td = xw.shape[0]
    dev = ep.device
    if tuple(acts) != KERNEL_ACTS:
        raise ValueError(
            f"attention_gru_fwd takes activations {KERNEL_ACTS}, got {tuple(acts)}")
    check(ep, "ep", (Te, B, D), dev, contiguous=False)
    check(ev, "ev", (Te, B, E), dev, contiguous=False)
    check(em, "em", (Te, B, 1), dev, contiguous=False)
    check(xw, "xw", (Td, B, 3 * D), dev)
    check(dmask, "dmask", (Td, B, 1), dev)
    check(h0, "h0", (B, D), dev)
    check(wa, "wa", (D, D), dev)
    check(ba, "ba", (1, D), dev)
    check(v, "v", (1, D), dev)
    check(wctx, "wctx", (E, 3 * D), dev)
    check(wg, "wg", (D, 3 * D), dev)
    return Td, B, Te, D, E, dev


def _light_scratch(B, D, E, dev):
    """Pointers to kernel 4's scratch: the carry [B, D], m [B, D], ctx
    [B, E], r*h [B, D] and the barrier's counter (4 bytes, zeroed by the
    launch), in one allocation (the serve step's host time counts)."""
    flat = torch.empty(B * (3 * D + E) + 1, device=dev)
    base, f = flat.data_ptr(), flat.element_size()
    h, m, rh, ctx, counter = (base + f * B * o for o in (0, D, 2 * D, 3 * D, 3 * D + E))
    return flat, (h, m, ctx, rh, counter)


def _launch_fwd(ep, ev, em, xw, dmask, h0, wa, ba, v, wctx, wg, acts, residuals,
                kernel=ATTENTION_GRU_FWD):
    Td, B, Te, D, E, dev = _check_operands(ep, ev, em, xw, dmask, h0, wa, ba, v,
                                           wctx, wg, acts)
    _check_supported(B, Te, D, E, dev)
    kernel_flops.record(kernel_flops.attention_gru_fwd_flops(Td, B, Te, D, E))
    ys = torch.empty((Td, B, D), device=dev)
    args = [ptr(ep), ep.stride(0), ep.stride(1),
            ptr(ev), ev.stride(0), ev.stride(1),
            ptr(em), em.stride(0), em.stride(1),
            ptr(xw), ptr(dmask), ptr(h0),
            ptr(wa), ptr(ba), ptr(v),
            ptr(wctx), ptr(wg), ptr(ys)]
    if not residuals:
        flat, scratch = _light_scratch(B, D, E, dev)    # flat: held until the launch is queued
        kernel.launch(dev, *args, *scratch, Td, B, Te, D, E, card_sms(dev))
        return ys
    saved = (torch.empty((Td, B, D), device=dev), torch.empty((Td, B, 3 * D), device=dev),
             torch.empty((Td, B, Te), device=dev), torch.empty((Td, B, E), device=dev),
             torch.empty((Td, B, D), device=dev))
    scratch = (torch.empty((B, D), device=dev), torch.empty(1, dtype=torch.int32, device=dev))
    ATTENTION_GRU_FWD_TRAIN.launch(dev, *args, *[ptr(z) for z in saved + scratch],
                                   Td, B, Te, D, E, card_sms(dev))
    return (ys,) + saved


def _launch_bwd(dy, ep, ev, dmask, hprev, saved, alpha, m, wa, v, wctx, wg, h0_grad=True):
    """The backward kernel's outputs: dxw, dctx, dh0, dep, dwa, dba, dv.
    ``h0_grad``: whether h0 takes a gradient, for the FLOPs recorded."""
    Te, B, D = ep.shape
    E = ev.shape[2]
    Td = dy.shape[0]
    dev = ep.device
    dy = _last_dim_contiguous(dy)
    check(dy, "dy", (Td, B, D), dev, contiguous=False)
    check(hprev, "hprev", (Td, B, D), dev)
    check(saved, "acts", (Td, B, 3 * D), dev)
    check(alpha, "alpha", (Td, B, Te), dev)
    check(m, "m", (Td, B, D), dev)
    _check_supported(B, Te, D, E, dev)
    dxw = torch.empty((Td, B, 3 * D), device=dev)
    dctx = torch.empty((Td, B, E), device=dev)
    dh0 = torch.empty((B, D), device=dev)
    dep = torch.empty((B, Te, D), device=dev).transpose(0, 1)
    dwa = torch.empty((D, D), device=dev)
    dba = torch.empty((1, D), device=dev)
    dv = torch.empty((1, D), device=dev)
    dm_rows = torch.empty((Td, B, D), device=dev)
    dv_part = torch.empty((2, B, D), device=dev)
    counter = torch.empty(1, dtype=torch.int32, device=dev)
    kernel_flops.record(kernel_flops.attention_gru_bwd_flops(Td, B, Te, D, E, h0_grad))
    ATTENTION_GRU_BWD.launch(
        dev,
        ptr(dy), dy.stride(0), dy.stride(1),
        ptr(ep), ep.stride(0), ep.stride(1),
        ptr(ev), ev.stride(0), ev.stride(1),
        ptr(dmask), ptr(hprev), ptr(saved), ptr(alpha), ptr(m),
        ptr(wa), ptr(v), ptr(wctx), ptr(wg),
        ptr(dxw), ptr(dctx), ptr(dh0),
        ptr(dep), dep.stride(0), dep.stride(1),
        ptr(dwa), ptr(dba), ptr(dv),
        ptr(dm_rows), ptr(dv_part), ptr(counter),
        Td, B, Te, D, E, card_sms(dev),
    )
    return dxw, dctx, dh0, dep, dwa, dba, dv


class _FusedAttentionGRU(torch.autograd.Function):
    """The training pair on the card: attention_gru_fwd_train, then
    attention_gru_bwd plus the three stream products."""

    @staticmethod
    def forward(ctx, ep, ev, em, xw, dmask, h0, wa, ba, v, wctx, wg, acts):
        ys, hprev, saved, alpha, ctxs, m = _launch_fwd(ep, ev, em, xw, dmask, h0, wa, ba, v,
                                                       wctx, wg, acts, residuals=True)
        ctx.save_for_backward(ep, ev, dmask, hprev, saved, alpha, ctxs, m, wa, v, wctx, wg)
        return ys

    @staticmethod
    def backward(ctx, dy):
        ep, ev, dmask, hprev, saved, alpha, ctxs, m, wa, v, wctx, wg = ctx.saved_tensors
        D, E = ep.shape[2], ev.shape[2]
        dxw, dctx, dh0, dep, dwa, dba, dv = _launch_bwd(
            dy, ep, ev, dmask, hprev, saved, alpha, m, wa, v, wctx, wg,
            h0_grad=ctx.needs_input_grad[5])
        dxw2 = dxw.reshape(-1, 3 * D)
        hp2 = hprev.reshape(-1, D)
        r2 = saved.reshape(-1, 3 * D)[:, D: 2 * D]
        dwctx = ctxs.reshape(-1, E).t() @ dxw2
        dwg = torch.cat([hp2.t() @ dxw2[:, : 2 * D], (r2 * hp2).t() @ dxw2[:, 2 * D:]], dim=1)
        # d_ev[te, b, :] = sum_td alpha[td, b, te] * d_ctx[td, b, :]
        dev_ = torch.einsum("tbe,tbd->ebd", alpha, dctx)
        return dep, dev_, None, dxw, None, dh0, dwa, dba, dv, dwctx, dwg, None


def fused_attention_gru(ep, ev, em, xw, dmask, h0, wa, ba, v, wctx, wg,
                        acts: Tuple[str, str] = KERNEL_ACTS) -> Tensor:
    """Raw per-step GRU outputs [Td, B, D] of the decoder loop.

    ep [Te, B, D] encoder projection; ev [Te, B, E] encoder states;
    em [Te, B, 1] encoder validity (these three may be any time/batch
    strides, such as transposed views of batch-major buffers); xw
    [Td, B, 3D] word-side inputs with every bias folded in; dmask
    [Td, B, 1]; h0 [B, D]; wa [D, D]; ba [1, D]; v [1, D]; wctx [E, 3D];
    wg [D, 3D]."""
    if ep.device.type == "cpu":
        return attention_gru_reference(ep, ev, em, xw, dmask, h0, wa, ba, v,
                                       wctx, wg, acts)
    operands = (ep, ev, em, xw, dmask, h0, wa, ba, v, wctx, wg)
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        _check_operands(*operands, acts)
        return _FusedAttentionGRU.apply(ep, ev, em.detach(), xw, dmask.detach(), h0,
                                        wa, ba, v, wctx, wg, tuple(acts))
    return _launch_fwd(*operands, acts, residuals=False)


def attention_gru_step(h_prev, ep, ev, em, xw_t, wa, ba, v, wctx, wg,
                       acts: Tuple[str, str] = KERNEL_ACTS) -> Tensor:
    """ONE decoder step, the JAX package's signature: h_prev [B, D],
    xw_t [B, 3D], the rest as :func:`fused_attention_gru`; returns h' [B, D].

    The serve decode step. It asks :func:`supported` first, as the decoder
    route does: a shape it refuses runs the plain step, counted in
    ``EAGER_ROUTES``. Otherwise, on the card, this is one launch of kernel 4
    with Td = 1 (on the CPU the kernel's plain version)."""
    global EAGER_ROUTES
    Te, B, D = ep.shape
    if not supported(B, Te, D, ev.shape[2], card_sms(ep.device)):
        EAGER_ROUTES += 1
        return _step(h_prev, ep, ev, em, xw_t, wa, ba, v, wctx, wg, acts)
    if ep.device.type == "cpu":
        return _step(h_prev, ep, ev, em, xw_t, wa, ba, v, wctx, wg, acts)
    dmask = torch.ones((1, h_prev.shape[0], 1), device=h_prev.device)
    return fused_attention_gru(ep, ev, em, xw_t[None], dmask, h_prev, wa, ba, v,
                               wctx, wg, acts)[0]
