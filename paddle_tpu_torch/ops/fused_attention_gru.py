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

bf16 operands (a bf16 model's decoder, ``graph/fused_decoder.py``) take the
bf16 instances of kernels 5 and 6 (``attention_gru_fwd_train_bf16``,
``attention_gru_bwd_bf16``), which keep the Pallas kernels' bf16 contract:
ep, ev, xw, the masks, h0 and the weights bf16, widened on load; the
scores, the softmax, the context sums and the carry in float32; h, r * h
and ctx rounded to bf16 before their products; ys and the residuals
(hprev, acts, alpha, ctx) stored bf16; in the backward d_din, d_ctx and dh0
in bf16, d_din, dg and d_m rounded before their products, d_enc_proj, dWa,
dba and dv summed in float32 and rounded at the end, and the stream
products (dW_ctx, dW_gru, d_enc_vec) taken on bf16 operands with float32
accumulation. :func:`attention_gru_reference` and
:func:`attention_gru_backward_reference` are their plain versions, with
the same rounding points; on the CPU a bf16 decoder runs them as an
autograd Function. Kernel 4 (serving) has no bf16 instance: the serve path
computes in float32 (``graph/decode_step.py::plan_fused_step``).

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
from paddle_tpu_torch.ops.precision import bf16_pieces, round_to

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
     PTR, PTR, PTR,            # scratch: d_m rows, dv and dba partials, the barrier counter
     PTR]                      # phase clocks [Td, 5] int64, or null
    + _DIMS + [I32])           # num_sms
# the bf16 instances of kernels 5 and 6: the same arguments, bf16 operands
# and residuals (m stays float32), and kernel 6 a float32 d_ctx row buffer
ATTENTION_GRU_FWD_TRAIN_BF16 = CudaKernel(
    "attention_gru_fwd_train.cu", "attention_gru_fwd_train_bf16",
    ATTENTION_GRU_FWD_TRAIN.argtypes[:-1])
ATTENTION_GRU_BWD_BF16 = CudaKernel(
    "attention_gru_bwd.cu", "attention_gru_bwd_bf16",
    ATTENTION_GRU_BWD.argtypes[:30] + [PTR]      # + d_ctx in float32 [B, E]
    + ATTENTION_GRU_BWD.argtypes[30:-1])
# kernel 6's bf16 body for Hopper (csrc/attention_gru_bwd_sm90.cu), where
# sm90_takes: the bf16 instance's arguments, but d_m's two bf16 pieces
# [Td, B, D] in place of the d_m rows and before the clocks, and the
# barrier counters one a row group
ATTENTION_GRU_BWD_BF16_SM90 = CudaKernel(
    "attention_gru_bwd_sm90.cu", "attention_gru_bwd_bf16_sm90",
    ATTENTION_GRU_BWD_BF16.argtypes[:31] + [PTR] + ATTENTION_GRU_BWD_BF16.argtypes[31:-1])
KERNELS = (ATTENTION_GRU_FWD, ATTENTION_GRU_FWD_TRAIN, ATTENTION_GRU_BWD,
           ATTENTION_GRU_FWD_TRAIN_BF16, ATTENTION_GRU_BWD_BF16, ATTENTION_GRU_BWD_BF16_SM90)
OPERAND_DTYPES = (torch.float32, torch.bfloat16)
_FWD_TRAIN = {torch.float32: ATTENTION_GRU_FWD_TRAIN, torch.bfloat16: ATTENTION_GRU_FWD_TRAIN_BF16}
_BWD = {torch.float32: ATTENTION_GRU_BWD, torch.bfloat16: ATTENTION_GRU_BWD_BF16}

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


SM90_WARPS = 8          # kernel 6's Hopper body: warps a block, rows a product tile
SM90_ROWS = 16
SM90_ER = (8, 16, 32)   # the rows of wctx a block of it owns, compiled in


def sm90_plan(B: int, Te: int, D: int, E: int, sms: int) -> Optional[Dict[str, int]]:
    """The grid of kernel 6's bf16 body for Hopper
    (``csrc/attention_gru_bwd_sm90.cu`` make_plan), or None where it does
    not fit.

    D a multiple of 256 (each warp's share of every contraction is whole
    32-k chunks). The first of (P, U) = (4, 16), (2, 8), (1, 8) with P <= B
    row groups of G = D / U blocks within sms, a block owning U hidden units
    and ER = E / G rows of wctx (8, 16 or 32), R = ceil(B / P) rows a group,
    the attention's (row, part of D) items spread over the group's blocks
    as the persistent body spreads them over the grid, and a block's shared
    memory within SMEM_LIMIT: the weights' rows in bf16, the warps' partial
    tiles, the state of its rows and the items' d_enc_proj sums."""
    if min(B, Te, E) < 1 or D <= 0 or D % 256:
        return None
    for P, U in ((4, 16), (2, 8), (1, 8)):
        G = D // U
        if P > B or P * G > sms or E % G or E // G not in SM90_ER:
            continue
        ER = E // G
        R = _cdiv(B, P)
        parts = max(1, G // R)
        plen = _cdiv(D, parts)
        ipb = _cdiv(R * parts, G)
        items = ipb * plen
        smem = (2 * (4 * U * D + 3 * ER * D)
                + 4 * (SM90_WARPS * SM90_ROWS * max(U, ER) + 4 * R * U + R * ER + D + E
                       + _cdiv(Te, 4) * 4 + 2 * items + items * Te))
        if smem <= SMEM_LIMIT:
            return dict(row_groups=P, blocks_per_group=G, units_per_block=U,
                        wctx_rows_per_block=ER, rows_per_group=R, parts=parts,
                        blocks=P * G, smem_bytes=smem)
    return None


def sm90_takes(B: int, Te: int, D: int, E: int, num_sms: Optional[int] = None,
               *operands: Tensor) -> bool:
    """Whether kernel 6's bf16 backward runs on its Hopper body
    (``attention_gru_bwd_bf16_sm90``): :func:`sm90_plan` fits on a card of
    ``num_sms`` SMs (the current card's by default), and each of
    ``operands`` (the weights and ev, which it reads as 16-byte vectors)
    starts on 16 bytes with every stride but the last a multiple of 8
    values. Other bf16 shapes take ``attention_gru_bwd_bf16``; float32 takes
    ``attention_gru_bwd``. Reads shapes, strides and base addresses only."""
    sms = card_sms() if num_sms is None else num_sms
    return sm90_plan(B, Te, D, E, sms) is not None and all(
        t.data_ptr() % 16 == 0 and all(x % 8 == 0 for x in t.stride()[:-1]) for t in operands)


def grid_barriers(Td: int) -> Tuple[int, int]:
    """The grid barriers one launch of kernel 4 or 5, and of kernel 6, passes."""
    return 4 * Td - 1, 4 * Td


def supported(B: int, Te: int, D: int, E: int, num_sms: Optional[int] = None) -> bool:
    """Whether kernels 4-6 take a decoder of batch B over Te encoder
    positions, width D and encoder width E, in float32 operands (or bf16,
    which kernels 5 and 6 take).

    Every dimension is at least 1 and the shared memory of a block of each
    kernel is within SMEM_LIMIT (kernel 4's is kernel 5's); the grid is at
    most one block per SM, so the card holds it at once. Both instances
    hold the weight slices and the state in float32 in shared memory, so
    the plan is the same for either operand type
    (``pallas_attention_gru.supported`` takes the operand size for its VMEM
    budget; here it decides nothing). ``num_sms`` defaults to the current
    card's count (132 where there is no card)."""
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


def _step_mixed(h, ep, ev, valid, xw_t, wa, ba, v, wctx, wg, od):
    """One decoder step of the bf16 plain version (``pallas_attention_gru
    ._fwd_kernel`` in bf16): every operand widened to float32 (ep, ev and
    the weights by the caller), h the float32 carry, h, ctx and r * h
    rounded to ``od`` before their products. Returns (h', u, r, c, alpha
    [Te, B], ctx [B, E]), all float32."""
    D = h.shape[-1]
    m = round_to(h, od) @ wa + ba                                # [B, D]
    s = (torch.tanh(ep + m[None]) @ v.reshape(D, 1))[..., 0]     # [Te, B]
    s = torch.where(valid, s, torch.full_like(s, -1e30))
    e = torch.exp(s - torch.max(s, dim=0, keepdim=True).values)
    alpha = e / torch.sum(e, dim=0, keepdim=True)
    alpha = torch.where(valid, alpha, torch.zeros_like(alpha))
    ctx = torch.einsum("tb,tbe->be", alpha, ev)                 # [B, E]
    din = round_to(ctx, od) @ wctx + xw_t.float()               # [B, 3D]
    g = torch.sigmoid(din[:, :2 * D] + round_to(h, od) @ wg[:, :2 * D])
    u, r = g[:, :D], g[:, D:]
    c = torch.tanh(din[:, 2 * D:] + round_to(r * h, od) @ wg[:, 2 * D:])
    return u * h + (1.0 - u) * c, u, r, c, alpha, ctx


def _attention_gru_mixed(ep, ev, em, xw, dmask, h0, wa, ba, v, wctx, wg, residuals):
    od = ep.dtype
    f = lambda t: t.float()
    epf, evf, waf, baf, vf, wctxf, wgf = map(f, (ep, ev, wa, ba.reshape(1, -1), v, wctx, wg))
    valid = em[:, :, 0] > 0
    h = h0.float()
    ys, saved = [], []
    for t in range(xw.shape[0]):
        h_new, u, r, c, alpha, ctx = _step_mixed(h, epf, evf, valid, xw[t], waf, baf, vf,
                                                 wctxf, wgf, od)
        ys.append(h_new.to(od))
        if residuals:
            saved.append((h.to(od), torch.cat([u, r, c], dim=-1).to(od),
                          alpha.transpose(0, 1).to(od), ctx.to(od)))
        dm = dmask[t].float()
        h = dm * h_new + (1.0 - dm) * h
    ys = torch.stack(ys)
    if not residuals:
        return ys
    return (ys,) + tuple(torch.stack(z) for z in zip(*saved))


def attention_gru_reference(ep, ev, em, xw, dmask, h0, wa, ba, v, wctx, wg,
                            acts: Tuple[str, str] = KERNEL_ACTS, residuals: bool = False):
    """Plain PyTorch version of the kernels (shapes as :func:`fused_attention_gru`).

    ``residuals=True`` also returns what ``attention_gru_fwd_train`` saves:
    (ys, hprev [Td, B, D], acts = [u | r | c] [Td, B, 3D], alpha
    [Td, B, Te], ctx [Td, B, E]); the kernel also saves m [Td, B, D]. bf16
    operands follow the kernels' bf16 contract (carry, scores, softmax and
    sums in float32; h, ctx and r * h rounded before their products; the
    outputs in bf16)."""
    if ep.dtype == torch.bfloat16:
        if tuple(acts) != KERNEL_ACTS:
            raise ValueError(f"the bf16 attention-GRU takes activations {KERNEL_ACTS}")
        return _attention_gru_mixed(ep, ev, em, xw, dmask, h0, wa, ba, v, wctx, wg, residuals)
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


def _sliced_mm(a: Tensor, b: Tensor, slices: int) -> Tensor:
    """a @ b with the contraction cut into ``slices`` equal slices, each
    product summed on its own and the slices added in order (one slice: the
    plain product)."""
    if slices <= 1:
        return a @ b
    step = a.shape[1] // slices
    out = a[:, :step] @ b[:step]
    for i in range(1, slices):
        out = out + a[:, i * step:(i + 1) * step] @ b[i * step:(i + 1) * step]
    return out


def attention_gru_backward_reference(dy, ep, ev, dmask, hprev, saved, alpha, wa, ba, v,
                                     wctx, wg, slices: int = 1, dwa_pieces: int = 0,
                                     dxw_forced: Optional[Tensor] = None):
    """Plain PyTorch version of kernel 6 (``pallas_attention_gru._bwd_kernel``):
    from dy [Td, B, D] and the residuals of :func:`attention_gru_reference`,
    its outputs (dxw [Td, B, 3D], dctx [Td, B, E] and dh0 [B, D] in dy's
    dtype; d_enc_proj [Te, B, D], dWa, dba [1, D] and dv [1, D] in float32).
    Per step, walked Td-1 .. 0, in float32: the GRU backward (drh from
    dcand rounded), d_din = [dg | dcand], d_ctx from d_din rounded, the
    attention's backward from the unrounded d_ctx, and DH from dg and d_m
    rounded. The roundings are to the residuals' dtype (none in float32).
    ``slices`` = SM90_WARPS sums each per-step product as the Hopper body
    (``attention_gru_bwd_bf16_sm90``) does: its contraction cut among the
    warps, DH's as one product over [dg | d_m], the warps' sums added in
    order. ``dwa_pieces`` = 2 sums dWa from d_m as two bf16 pieces (hi =
    bf16(d_m), lo = bf16(d_m - hi)), as that body does; 1 from hi alone (the
    one-piece control); 0 (the kernels' contract) from d_m unrounded.
    ``dxw_forced`` (a kernel's dxw) replaces each step's rounded d_din in its
    three products, so that the reference walks the kernel's own
    recurrence (as ``lstm_backward_reference``'s ``dx4_forced``)."""
    Td, B, D = hprev.shape
    od = saved.dtype
    f = lambda t: t.float()
    epf, evf, waf, vf, wctxf, wgf = map(f, (ep, ev, wa, v.reshape(1, 1, D), wctx, wg))
    baf = ba.float().reshape(1, D)
    DH = hprev.new_zeros(B, D, dtype=torch.float32)
    dep = torch.zeros_like(epf)
    dwa = torch.zeros_like(waf)
    dba = hprev.new_zeros(1, D, dtype=torch.float32)
    dv = hprev.new_zeros(1, D, dtype=torch.float32)
    dxw, dctx = [None] * Td, [None] * Td
    for t in range(Td - 1, -1, -1):
        hp, a = hprev[t].float(), saved[t].float()
        u, r, c = a[:, :D], a[:, D:2 * D], a[:, 2 * D:]
        al = alpha[t].float().t()                                  # [Te, B]
        dm = dmask[t].float()                                      # [B, 1]
        dhn = dy[t].float() + dm * DH
        dcand = dhn * (1.0 - u) * (1.0 - c * c)
        forced = None if dxw_forced is None else dxw_forced[t].float()
        dcand_r = round_to(dcand, od) if forced is None else forced[:, 2 * D:]
        drh = _sliced_mm(dcand_r, wgf[:, 2 * D:].t(), slices)
        dg = torch.cat([dhn * (hp - c) * u * (1.0 - u), drh * hp * r * (1.0 - r)], dim=1)
        d_din = torch.cat([dg, dcand], dim=1)
        dxw[t] = d_din.to(dy.dtype)
        d_din_r = round_to(d_din, od) if forced is None else forced
        d_ctx = _sliced_mm(d_din_r, wctxf.t(), slices)             # [B, E]
        dctx[t] = d_ctx.to(dy.dtype)
        comb = torch.tanh(epf + (round_to(hp, od) @ waf + baf)[None])
        dalpha = torch.sum(evf * d_ctx[None], dim=-1)              # [Te, B]
        ds = al * (dalpha - torch.sum(al * dalpha, dim=0, keepdim=True))
        dv = dv + torch.sum(comb * ds[:, :, None], dim=(0, 1))[None]
        dtanh = (1.0 - comb * comb) * ds[:, :, None] * vf
        dep = dep + dtanh
        d_m = torch.sum(dtanh, dim=0)                              # [B, D]
        dba = dba + torch.sum(d_m, dim=0)[None]
        dwa = dwa + hp.t() @ bf16_pieces(d_m, dwa_pieces)
        dg_r = d_din_r[:, :2 * D]
        if slices > 1:
            prod = _sliced_mm(torch.cat([dg_r, round_to(d_m, od)], dim=1),
                              torch.cat([wgf[:, :2 * D].t(), waf.t()], dim=0), slices)
        else:
            prod = dg_r @ wgf[:, :2 * D].t() + round_to(d_m, od) @ waf.t()
        DH = dhn * u + drh * r + prod + (1.0 - dm) * DH
    return torch.stack(dxw), torch.stack(dctx), DH.to(dy.dtype), dep, dwa, dba, dv


def _mm(a: Tensor, b: Tensor) -> Tensor:
    """a @ b with float32 accumulation and the result in a's dtype: on the
    card a bf16 product is cuBLAS's (float32 accumulation, the reduced-
    precision reduction switched off by ``resolve_device``); on the CPU
    a bf16 product is taken in float32 and rounded."""
    if a.device.type == "cpu" and a.dtype == torch.bfloat16:
        return (a.float() @ b.float()).to(a.dtype)
    return a @ b


def _input_grads(dxw, dctx, dh0, dep, dwa, dba, dv, ep, ev, hprev, saved, alpha, ctxs,
                 wa, ba, v, wctx, wg):
    """The gradients of fused_attention_gru's inputs from kernel 6's
    outputs: dW_ctx, dW_gru and d_enc_vec as products of the streams (the
    JAX package leaves them to XLA), d_enc_proj, dWa, dba and dv rounded to
    their inputs' dtypes. Returns (dep, dev, dxw, dh0, dwa, dba, dv, dwctx,
    dwg)."""
    D, E = ep.shape[2], ev.shape[2]
    dxw2 = dxw.reshape(-1, 3 * D)
    hp2 = hprev.reshape(-1, D)
    r2 = saved.reshape(-1, 3 * D)[:, D: 2 * D]
    dwctx = _mm(ctxs.reshape(-1, E).t(), dxw2)
    dwg = torch.cat([_mm(hp2.t(), dxw2[:, : 2 * D]), _mm((r2 * hp2).t(), dxw2[:, 2 * D:])], dim=1)
    # d_ev[te, b, :] = sum_td alpha[td, b, te] * d_ctx[td, b, :]
    if alpha.device.type == "cpu" and alpha.dtype == torch.bfloat16:
        dev_ = torch.einsum("tbe,tbd->ebd", alpha.float(), dctx.float()).to(ev.dtype)
    else:
        dev_ = torch.einsum("tbe,tbd->ebd", alpha, dctx)
    return (dep.to(ep.dtype), dev_, dxw, dh0, dwa.to(wa.dtype), dba.to(ba.dtype),
            dv.to(v.dtype), dwctx.to(wctx.dtype), dwg.to(wg.dtype))


class _PlainAttentionGRU(torch.autograd.Function):
    """The bf16 decoder on the CPU: the kernels' plain forward with residuals
    and their plain backward, rounding where the kernels (and the Pallas
    custom VJP) round."""

    @staticmethod
    def forward(ctx, ep, ev, em, xw, dmask, h0, wa, ba, v, wctx, wg):
        ys, hprev, saved, alpha, ctxs = attention_gru_reference(
            ep, ev, em, xw, dmask, h0, wa, ba, v, wctx, wg, residuals=True)
        ctx.save_for_backward(ep, ev, dmask, hprev, saved, alpha, ctxs, wa, ba, v, wctx, wg)
        return ys

    @staticmethod
    def backward(ctx, dy):
        ep, ev, dmask, hprev, saved, alpha, ctxs, wa, ba, v, wctx, wg = ctx.saved_tensors
        outs = attention_gru_backward_reference(dy, ep, ev, dmask, hprev, saved, alpha,
                                                wa, ba, v, wctx, wg)
        dep, dev_, dxw, dh0, dwa, dba, dv, dwctx, dwg = _input_grads(
            *outs, ep, ev, hprev, saved, alpha, ctxs, wa, ba, v, wctx, wg)
        return dep, dev_, None, dxw, None, dh0, dwa, dba, dv, dwctx, dwg


def _check_operands(ep, ev, em, xw, dmask, h0, wa, ba, v, wctx, wg, acts, residuals=True):
    """Every operand in the operand dtype (float32, or bf16 for kernels 5 and
    6: ``residuals``), of its shape, on ep's device."""
    Te, B, D = ep.shape
    E = ev.shape[2]
    Td = xw.shape[0]
    dev = ep.device
    od = ep.dtype
    if tuple(acts) != KERNEL_ACTS:
        raise ValueError(
            f"attention_gru_fwd takes activations {KERNEL_ACTS}, got {tuple(acts)}")
    if od not in (OPERAND_DTYPES if residuals else (torch.float32,)):
        # kernel 4 (the serve step) takes float32 only: serving stays float32
        # in both packages
        raise ValueError(f"the attention-GRU {'training ' if residuals else ''}kernels do "
                         f"not take {od} operands"
                         + ("" if residuals else " (serving stays float32)"))
    check(ep, "ep", (Te, B, D), dev, contiguous=False, dtype=od)
    check(ev, "ev", (Te, B, E), dev, contiguous=False, dtype=od)
    check(em, "em", (Te, B, 1), dev, contiguous=False, dtype=od)
    check(xw, "xw", (Td, B, 3 * D), dev, dtype=od)
    check(dmask, "dmask", (Td, B, 1), dev, dtype=od)
    check(h0, "h0", (B, D), dev, dtype=od)
    check(wa, "wa", (D, D), dev, dtype=od)
    check(ba, "ba", (1, D), dev, dtype=od)
    check(v, "v", (1, D), dev, dtype=od)
    check(wctx, "wctx", (E, 3 * D), dev, dtype=od)
    check(wg, "wg", (D, 3 * D), dev, dtype=od)
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
                                           wctx, wg, acts, residuals)
    od = ep.dtype
    _check_supported(B, Te, D, E, dev)
    kernel_flops.record(kernel_flops.attention_gru_fwd_flops(Td, B, Te, D, E))
    ys = torch.empty((Td, B, D), device=dev, dtype=od)
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
    # hprev, acts, alpha and ctx in the operand dtype; m in float32
    saved = (torch.empty((Td, B, D), device=dev, dtype=od),
             torch.empty((Td, B, 3 * D), device=dev, dtype=od),
             torch.empty((Td, B, Te), device=dev, dtype=od),
             torch.empty((Td, B, E), device=dev, dtype=od),
             torch.empty((Td, B, D), device=dev))
    scratch = (torch.empty((B, D), device=dev, dtype=od),
               torch.empty(1, dtype=torch.int32, device=dev))
    _FWD_TRAIN[od].launch(dev, *args, *[ptr(z) for z in saved + scratch],
                          Td, B, Te, D, E, card_sms(dev))
    return (ys,) + saved


def _launch_bwd(dy, ep, ev, dmask, hprev, saved, alpha, m, wa, v, wctx, wg, h0_grad=True,
                phase_ns=None):
    """The backward kernel's outputs: dxw, dctx, dh0, dep, dwa, dba, dv.
    ``h0_grad``: whether h0 takes a gradient, for the FLOPs recorded.
    ``phase_ns`` (an int64 [Td, 5] tensor on the card, or None) receives
    block 0's clock in ns at the end of each phase of each step, in the
    loop's order. bf16 residuals take the Hopper body
    (:func:`_launch_bwd_sm90`) where :func:`sm90_takes`, every other shape
    the persistent body (:func:`_launch_bwd_persistent`)."""
    sm90 = saved.dtype == torch.bfloat16 and sm90_takes(
        ep.shape[1], ep.shape[0], ep.shape[2], ev.shape[2], card_sms(ep.device), wa, wctx, wg,
        ev)
    return _launch_bwd_on(sm90, dy, ep, ev, dmask, hprev, saved, alpha, m, wa, v, wctx, wg,
                          h0_grad, phase_ns)


def _launch_bwd_persistent(*args, **kwargs):
    """Kernel 6 on its persistent body (``attention_gru_bwd``, or
    ``attention_gru_bwd_bf16`` for bf16 residuals), whatever the shape:
    :func:`_launch_bwd`'s arguments and outputs."""
    return _launch_bwd_on(False, *args, **kwargs)


def _launch_bwd_sm90(*args, **kwargs):
    """Kernel 6's bf16 backward on its Hopper body
    (``attention_gru_bwd_bf16_sm90``): :func:`_launch_bwd`'s arguments and
    outputs. A shape that :func:`sm90_takes` refuses raises."""
    return _launch_bwd_on(True, *args, **kwargs)


def _launch_bwd_on(sm90, dy, ep, ev, dmask, hprev, saved, alpha, m, wa, v, wctx, wg,
                   h0_grad=True, phase_ns=None):
    """Kernel 6 launched on the Hopper body (``sm90``) or the persistent one."""
    Te, B, D = ep.shape
    E = ev.shape[2]
    Td = dy.shape[0]
    dev = ep.device
    od = saved.dtype
    if od not in OPERAND_DTYPES:
        raise ValueError(f"the attention-GRU backward does not take {od} residuals")
    dy = _last_dim_contiguous(dy)
    check(dy, "dy", (Td, B, D), dev, contiguous=False, dtype=od)
    check(hprev, "hprev", (Td, B, D), dev, dtype=od)
    check(saved, "acts", (Td, B, 3 * D), dev, dtype=od)
    check(alpha, "alpha", (Td, B, Te), dev, dtype=od)
    check(m, "m", (Td, B, D), dev)
    _check_supported(B, Te, D, E, dev)
    if phase_ns is not None and (phase_ns.device != dev or phase_ns.dtype != torch.int64
                                 or tuple(phase_ns.shape) != (Td, 5)
                                 or not phase_ns.is_contiguous()):
        raise ValueError(f"phase_ns must be a contiguous int64 [{Td}, 5] tensor on {dev}")
    sms = card_sms(dev)
    if sm90 and not (od == torch.bfloat16 and sm90_takes(B, Te, D, E, sms, wa, wctx, wg, ev)):
        raise ValueError(f"attention_gru_bwd_bf16_sm90 takes bf16, D a multiple of 256 within "
                         f"a block's {SMEM_LIMIT} bytes of shared memory and its weights and ev "
                         f"on 16 bytes; got {od}, B={B}, Te={Te}, D={D}, E={E}")
    # d_din, the d_ctx stream and dh0 in the operand dtype; d_enc_proj, dWa,
    # dba and dv summed in float32 (the caller rounds them)
    dxw = torch.empty((Td, B, 3 * D), device=dev, dtype=od)
    dctx = torch.empty((Td, B, E), device=dev, dtype=od)
    dh0 = torch.empty((B, D), device=dev, dtype=od)
    dep = torch.empty((B, Te, D), device=dev).transpose(0, 1)
    dwa = torch.empty((D, D), device=dev)
    dba = torch.empty((1, D), device=dev)
    dv = torch.empty((1, D), device=dev)
    # d_m for dWa: float32 rows, or in the Hopper body two bf16 pieces (hi,
    # which its DH product reads, and lo)
    dm_rows = torch.empty((Td, B, D), device=dev, dtype=od if sm90 else torch.float32)
    dv_part = torch.empty((2, B, D), device=dev)
    P = sm90_plan(B, Te, D, E, sms)["row_groups"] if sm90 else 1
    counter = torch.empty(P, dtype=torch.int32, device=dev)
    # bf16: the attention phase reads d_ctx unrounded, from a float32 row
    # buffer (each scratch tensor held until the launch is queued: one freed
    # sooner could be handed out again as the next one)
    dctx32 = [] if od == torch.float32 else [torch.empty((B, E), device=dev)]
    dm_lo = [torch.empty((Td, B, D), device=dev, dtype=od)] if sm90 else []
    kernel_flops.record(kernel_flops.attention_gru_bwd_flops(Td, B, Te, D, E, h0_grad))
    (ATTENTION_GRU_BWD_BF16_SM90 if sm90 else _BWD[od]).launch(
        dev,
        ptr(dy), dy.stride(0), dy.stride(1),
        ptr(ep), ep.stride(0), ep.stride(1),
        ptr(ev), ev.stride(0), ev.stride(1),
        ptr(dmask), ptr(hprev), ptr(saved), ptr(alpha), ptr(m),
        ptr(wa), ptr(v), ptr(wctx), ptr(wg),
        ptr(dxw), ptr(dctx), ptr(dh0),
        ptr(dep), dep.stride(0), dep.stride(1),
        ptr(dwa), ptr(dba), ptr(dv),
        ptr(dm_rows), ptr(dv_part), ptr(counter), *map(ptr, dctx32 + dm_lo),
        None if phase_ns is None else ptr(phase_ns), Td, B, Te, D, E, sms,
    )
    return dxw, dctx, dh0, dep, dwa, dba, dv


class _FusedAttentionGRU(torch.autograd.Function):
    """The training pair on the card: attention_gru_fwd_train, then
    attention_gru_bwd plus the three stream products."""

    @staticmethod
    def forward(ctx, ep, ev, em, xw, dmask, h0, wa, ba, v, wctx, wg, acts):
        ys, hprev, saved, alpha, ctxs, m = _launch_fwd(ep, ev, em, xw, dmask, h0, wa, ba, v,
                                                       wctx, wg, acts, residuals=True)
        ctx.save_for_backward(ep, ev, dmask, hprev, saved, alpha, ctxs, m, wa, ba, v, wctx, wg)
        return ys

    @staticmethod
    def backward(ctx, dy):
        ep, ev, dmask, hprev, saved, alpha, ctxs, m, wa, ba, v, wctx, wg = ctx.saved_tensors
        outs = _launch_bwd(dy, ep, ev, dmask, hprev, saved, alpha, m, wa, v, wctx, wg,
                           h0_grad=ctx.needs_input_grad[5])
        dep, dev_, dxw, dh0, dwa, dba, dv, dwctx, dwg = _input_grads(
            *outs, ep, ev, hprev, saved, alpha, ctxs, wa, ba, v, wctx, wg)
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
    operands = (ep, ev, em, xw, dmask, h0, wa, ba, v, wctx, wg)
    if ep.device.type == "cpu":
        if (ep.dtype == torch.bfloat16 and torch.is_grad_enabled()
                and any(t.requires_grad for t in operands)):
            return _PlainAttentionGRU.apply(ep, ev, em.detach(), xw, dmask.detach(), h0,
                                            wa, ba, v, wctx, wg)
        return attention_gru_reference(*operands, acts)
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
