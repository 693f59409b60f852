"""The masked GRU over a whole sequence: CUDA kernels 1-3 and their plain versions.

Port of ``paddle_tpu/ops/pallas_gru.py::fused_gru``: the inference forward
(``_fwd_kernel_light`` -> ``csrc/gru_fwd.cu::gru_fwd``), the training
forward that also saves the residuals (``_fwd_kernel`` ->
``gru_fwd.cu::gru_fwd_train``) and its backward (``_bwd_kernel`` ->
``csrc/gru_bwd.cu::gru_bwd``). Cell semantics are exactly
``gru_cell_step``: the weight [H, 3H] is split [update, reset | candidate],
the bias is folded into x3 beforehand, and h' = u * h + (1 - u) * c.
Padded steps pass the carry through, so a reversed sequence stays at
h0 = 0 until it starts. The kernels take tanh, sigmoid, relu and linear in
each of the two activation slots (act_in, act_gate), as the Pallas kernels
do; :func:`supported` states what they take, and the ``gated_recurrent``
layer runs its eager time loop (counted in ``EAGER_ROUTES``) for anything
else.

:func:`fused_gru` launches the kernels for a CUDA tensor and raises on
anything they do not take (a shape :func:`supported` refuses included):
the training pair when grad mode is on and an input requires a gradient
(a ``torch.autograd.Function``), the light forward otherwise. For a CPU
tensor it runs :func:`gru_forward_reference`, and autograd through it
gives the gradients.

bf16 operands (a bf16 model, ``GradientMachine(compute_dtype=bfloat16)``)
take the kernels' bf16 instances (``gru_fwd_bf16``, ``gru_fwd_train_bf16``,
``gru_bwd_bf16``), which keep the Pallas kernels' bf16 contract: x3 and w
are bf16, widened on load; the carry is float32; h and r * h are rounded
to bf16 before their products, which accumulate in float32; ys, the
residuals and dx3 are stored bf16; the backward rounds dcand and dg before
the products with w transposed, sums dW from the unrounded float32 values
and rounds it once at the end. :func:`gru_forward_reference` and
:func:`gru_backward_reference` are their plain versions, with the same
rounding points; on the CPU a bf16 GRU runs them as an autograd Function
(``_PlainGRU``), as the Pallas function's custom VJP does.

All three kernels run as persistent, cooperative grids (one block on each
SM, each owning unit groups of 4 hidden units: the forwards their columns
of w, the backward their rows of w and of dW, in shared memory for the
whole launch; see ``csrc/gru_fwd.cu`` and ``csrc/gru_bwd.cu``). The two
forwards are one body, with and without the residual stores, on one plan
(:func:`fwd_plan`); :func:`grid_plan` is the backward's, and
:func:`supported` bounds both.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from paddle_tpu_torch.ops import kernel_flops
from paddle_tpu_torch.ops._build import (
    I32, I64, PTR, SMEM_LIMIT, CudaKernel, card_sms, check, ptr)
from paddle_tpu_torch.ops.activations import apply_activation
from paddle_tpu_torch.ops.precision import round_to

Tensor = torch.Tensor
KERNEL_ACTS = ("tanh", "sigmoid")    # the default (act_in, act_gate)
# the activation codes of csrc/common.cuh act_f32
ACT_CODES = {"tanh": 0, "sigmoid": 1, "relu": 2, "linear": 3}
# the widest GRU the gate takes, kept from the first designs of kernels 1
# and 2 (which held 3 H floats a block); within it kernel 3's grid bounds H
# and the batch together (grid_plan), and the forwards keep w's columns in
# device memory where they do not fit beside the rows' state (fwd_plan)
MAX_H = 232448 // (6 * 4)
# How kernel 3 cuts the work (csrc/gru_bwd.cu): unit groups of UNITS hidden
# units, one block per SM up to one per group, each block owning its
# groups' rows of w and dW ([3H][4] floats each) and, per batch row, STATE
# floats of each group, beside the cross-warp sums of one 64-row tile.
UNITS = 4
STATE = 20
RED_FLOATS = 8 * 64 * 4
# layer calls that ran the eager time loop because supported() refused
EAGER_ROUTES = 0

_FWD_ARGS = [PTR, I64, I64,          # x3, its time and batch strides
             PTR, I64, I64,          # mask
             PTR,                    # w
             PTR, I64, I64]          # ys
_TAIL = [I32, I32, I32, I32,         # T, B, H, reverse
         I32, I32]                   # act_in, act_gate
_FWD_SCRATCH = [PTR, PTR, PTR]      # r * h [B, H], w's columns where not in shared memory, the counter
_FWD_GRID = [I32, I32]               # num_sms, w_smem
GRU_FWD = CudaKernel("gru_fwd.cu", "gru_fwd",
                     _FWD_ARGS + [PTR]                  # the carry [B, H]
                     + _FWD_SCRATCH + _TAIL + _FWD_GRID)
GRU_FWD_TRAIN = CudaKernel("gru_fwd.cu", "gru_fwd_train",
                           _FWD_ARGS + [PTR, PTR]       # acts, hprev (the carry)
                           + _FWD_SCRATCH + _TAIL + _FWD_GRID)
GRU_BWD = CudaKernel(
    "gru_bwd.cu", "gru_bwd",
    [PTR, I64, I64,                  # dy, its time and batch strides
     PTR, PTR,                       # acts, hprev
     PTR, I64, I64,                  # mask
     PTR, PTR, PTR,                  # w, dx3, dw
     PTR, PTR, PTR,                  # scratch: w's and dW's rows where not in shared memory, the counter
     PTR]                            # phase clocks [T][4] int64, or null
    + _TAIL + [I32, I32, I32],       # num_sms, w_smem, dw_smem
)
# the bf16 instances of the same bodies: the same arguments, bf16 x3, w,
# ys and residuals (kernel 3 also a float32 exchange buffer)
GRU_FWD_BF16 = CudaKernel("gru_fwd.cu", "gru_fwd_bf16", GRU_FWD.argtypes[:-1])
GRU_FWD_TRAIN_BF16 = CudaKernel("gru_fwd.cu", "gru_fwd_train_bf16",
                                GRU_FWD_TRAIN.argtypes[:-1])
GRU_BWD_BF16 = CudaKernel("gru_bwd.cu", "gru_bwd_bf16",
                          GRU_BWD.argtypes[:15] + [PTR]   # + dg | dcand in float32 [2, B, 3H]
                          + GRU_BWD.argtypes[15:-1])
KERNELS = (GRU_FWD, GRU_FWD_TRAIN, GRU_BWD, GRU_FWD_BF16, GRU_FWD_TRAIN_BF16, GRU_BWD_BF16)
# the operand dtypes the kernels take, and each entry by operand dtype
OPERAND_DTYPES = (torch.float32, torch.bfloat16)
_FWD = {torch.float32: GRU_FWD, torch.bfloat16: GRU_FWD_BF16}
_FWD_TRAIN = {torch.float32: GRU_FWD_TRAIN, torch.bfloat16: GRU_FWD_TRAIN_BF16}
_BWD = {torch.float32: GRU_BWD, torch.bfloat16: GRU_BWD_BF16}


def gru_cell(x3: Tensor, h: Tensor, w: Tensor,
             acts: Tuple[str, str] = KERNEL_ACTS, gates: bool = False):
    """One GRU step: x3 [B, 3H] (biases folded in), h [B, H], w [H, 3H].
    Returns h', or (h', u, r, c) with ``gates``."""
    H = h.shape[-1]
    act_in, act_gate = acts
    g = apply_activation(act_gate, x3[..., : 2 * H] + h @ w[:, : 2 * H])
    u, r = g[..., :H], g[..., H:]
    c = apply_activation(act_in, x3[..., 2 * H:] + (r * h) @ w[:, 2 * H:])
    h_new = u * h + (1.0 - u) * c
    return (h_new, u, r, c) if gates else h_new


def dact(name: str, y: Tensor) -> Tensor:
    """The derivative of activation ``name`` from its output y = act(x), as
    the kernels take it (csrc/common.cuh dact_f32)."""
    if name == "tanh":
        return 1.0 - y * y
    if name == "sigmoid":
        return y * (1.0 - y)
    if name == "relu":
        return (y > 0).to(y.dtype)
    if name == "linear":
        return torch.ones_like(y)
    raise ValueError(f"no kernel derivative for activation {name!r}")


def gru_forward_reference(x3: Tensor, mask: Tensor, w: Tensor, reverse: bool = False,
                          acts: Tuple[str, str] = KERNEL_ACTS, residuals: bool = False):
    """Plain PyTorch version of the kernels: x3 [T, B, 3H], mask [T, B],
    w [H, 3H] -> ys [T, B, H], with ys[t] = 0 at padded steps.

    ``residuals=True`` also returns what ``gru_fwd_train`` saves, each at
    its step's own time index: acts = [u | r | c] [T, B, 3H] and h_prev
    [T, B, H]. bf16 operands follow the kernels' bf16 contract
    (:func:`_gru_forward_mixed`); float32 runs :func:`gru_loop`."""
    if x3.dtype == torch.bfloat16:
        return _gru_forward_mixed(x3, mask, w, reverse, acts, residuals)
    return gru_loop(x3, mask, w, reverse, acts, residuals)


def gru_loop(x3: Tensor, mask: Tensor, w: Tensor, reverse: bool = False,
             acts: Tuple[str, str] = KERNEL_ACTS, residuals: bool = False):
    """The GRU as a time loop with every operation in x3's dtype: the
    float32 kernels' plain version, and the ``gated_recurrent`` layer's
    eager route (in bf16 it runs as the JAX layer's ``lax.scan`` does, the
    carry bf16 too). Arguments and results as :func:`gru_forward_reference`."""
    T, B, H3 = x3.shape
    h = x3.new_zeros(B, H3 // 3)
    ys, saved, hprev = [None] * T, [None] * T, [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        h_new, u, r, c = gru_cell(x3[t], h, w, acts, gates=True)
        m = mask[t][:, None]
        ys[t] = m * h_new
        saved[t], hprev[t] = torch.cat([u, r, c], dim=-1), h
        h = m * h_new + (1.0 - m) * h
    ys = torch.stack(ys) if T else x3.new_zeros(0, B, H3 // 3)
    if not residuals:
        return ys
    if not T:
        return ys, x3.new_zeros(0, B, H3), x3.new_zeros(0, B, H3 // 3)
    return ys, torch.stack(saved), torch.stack(hprev)


def _gru_forward_mixed(x3, mask, w, reverse, acts, residuals):
    """The bf16 kernels' plain version (``pallas_gru._cell_fwd`` in bf16):
    the carry h in float32, x3 and w widened, h and r * h rounded to bf16
    before their products (exact in float32), ys, the gates and h_prev
    stored bf16."""
    T, B, H3 = x3.shape
    H, od = H3 // 3, x3.dtype
    act_in, act_gate = acts
    wf = w.float()
    h = x3.new_zeros(B, H, dtype=torch.float32)
    ys, saved, hprev = [None] * T, [None] * T, [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        x = x3[t].float()
        g = apply_activation(act_gate, x[:, :2 * H] + round_to(h, od) @ wf[:, :2 * H])
        u, r = g[:, :H], g[:, H:]
        c = apply_activation(act_in, x[:, 2 * H:] + round_to(r * h, od) @ wf[:, 2 * H:])
        h_new = u * h + (1.0 - u) * c
        m = mask[t][:, None].float()
        ys[t] = (m * h_new).to(od)
        saved[t], hprev[t] = torch.cat([u, r, c], dim=-1).to(od), h.to(od)
        h = m * h_new + (1.0 - m) * h
    ys = torch.stack(ys) if T else x3.new_zeros(0, B, H)
    if not residuals:
        return ys
    if not T:
        return ys, x3.new_zeros(0, B, H3), x3.new_zeros(0, B, H)
    return ys, torch.stack(saved), torch.stack(hprev)


def gru_backward_reference(dy: Tensor, saved: Tensor, hprev: Tensor, mask: Tensor,
                           w: Tensor, reverse: bool = False,
                           acts: Tuple[str, str] = KERNEL_ACTS) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of kernel 3 (``pallas_gru._bwd_kernel``): dx3
    [T, B, 3H] in dy's dtype and dW [H, 3H] in w's, from dy [T, B, H] and
    the residuals of :func:`gru_forward_reference`. Per step, walked
    against the forward's order, in float32: dh = m (DH + dy), the update
    and candidate gradients, drh = round(dcand) . Wc^T, dg, dx3[t] =
    [dg | dcand], DH = dh u + drh r + round(dg) . Wg^T + (1 - m) DH; dW sums
    h_prev^T dg and (r h_prev)^T dcand unrounded and is rounded once. The
    roundings are to the residuals' dtype (none in float32)."""
    T, B, H3 = saved.shape
    H, od = H3 // 3, saved.dtype
    act_in, act_gate = acts
    wf = w.float()
    wg_t, wc_t = wf[:, :2 * H].t(), wf[:, 2 * H:].t()
    DH = saved.new_zeros(B, H, dtype=torch.float32)
    dwg = saved.new_zeros(H, 2 * H, dtype=torch.float32)
    dwc = saved.new_zeros(H, H, dtype=torch.float32)
    dx3 = [None] * T
    for t in (range(T) if reverse else range(T - 1, -1, -1)):
        a = saved[t].float()
        u, r, c = a[:, :H], a[:, H:2 * H], a[:, 2 * H:]
        hp = hprev[t].float()
        m = mask[t][:, None].float()
        dh = m * (DH + dy[t].float())
        dcand = dh * (1.0 - u) * dact(act_in, c)
        drh = round_to(dcand, od) @ wc_t
        dg = torch.cat([dh * (hp - c) * dact(act_gate, u), drh * hp * dact(act_gate, r)], 1)
        dx3[t] = torch.cat([dg, dcand], dim=1).to(dy.dtype)
        DH = dh * u + drh * r + round_to(dg, od) @ wg_t + (1.0 - m) * DH
        dwg = dwg + hp.t() @ dg
        dwc = dwc + (r * hp).t() @ dcand
    dx3 = torch.stack(dx3) if T else dy.new_zeros(0, B, H3)
    return dx3, torch.cat([dwg, dwc], dim=1).to(w.dtype)


class _PlainGRU(torch.autograd.Function):
    """The bf16 GRU on the CPU: the kernels' plain forward with residuals
    and their plain backward, so that the gradients round where the
    kernels' (and the Pallas custom VJP's) do."""

    @staticmethod
    def forward(ctx, x3, mask, w, reverse, acts):
        ys, saved, hprev = gru_forward_reference(x3, mask, w, reverse, acts, residuals=True)
        ctx.save_for_backward(saved, hprev, mask, w)
        ctx.reverse, ctx.acts = reverse, acts
        return ys

    @staticmethod
    def backward(ctx, dy):
        saved, hprev, mask, w = ctx.saved_tensors
        dx3, dw = gru_backward_reference(dy, saved, hprev, mask, w, ctx.reverse, ctx.acts)
        return dx3, None, dw, None, None


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def grid_plan(B: int, H: int, sms: int) -> Dict[str, int]:
    """Blocks, shared memory per block and placement of kernel 3.

    ceil(H / 4) unit groups go to min(sms, groups) blocks, one to an SM.
    A block keeps the state of its groups' rows in shared memory, and its
    rows of w, then of dW, there too where they fit (12 H floats each a
    group); the rest in device memory it alone touches."""
    groups = _cdiv(H, UNITS)
    blocks = min(sms, groups)
    gpb = _cdiv(groups, blocks)
    state = 4 * (gpb * STATE * B + RED_FLOATS)
    rows = 4 * gpb * 12 * H
    w_in_smem = state + rows <= SMEM_LIMIT
    dw_in_smem = state + 2 * rows <= SMEM_LIMIT
    return dict(blocks=blocks, unit_groups_per_block=gpb,
                smem_bytes=state + rows * (int(w_in_smem) + int(dw_in_smem)),
                w_in_smem=int(w_in_smem), dw_in_smem=int(dw_in_smem))


def grid_barriers(T: int) -> int:
    """The grid barriers one launch of kernel 3 passes."""
    return 2 * T


def fwd_plan(B: int, H: int, sms: int) -> Dict[str, int]:
    """Blocks, shared memory per block and placement of kernels 1 and 2.

    Kernel 3's blocks and unit groups (:func:`grid_plan`); a block keeps
    STATE floats a row and unit group in shared memory, and its groups'
    columns of w there too where they fit (12 H floats a group), else in
    device memory it alone touches. Its state is kernel 3's without the
    cross-warp sums, so it fits wherever kernel 3's plan does."""
    plan = grid_plan(B, H, sms)
    gpb = plan["unit_groups_per_block"]
    state = 4 * gpb * STATE * B
    cols = 4 * gpb * 12 * H
    w_in_smem = state + cols <= SMEM_LIMIT
    return dict(blocks=plan["blocks"], unit_groups_per_block=gpb,
                smem_bytes=state + cols * int(w_in_smem), w_in_smem=int(w_in_smem))


def fwd_barriers(T: int) -> int:
    """The grid barriers one launch of kernel 1 or 2 passes: two a step,
    but after the last."""
    return max(0, 2 * T - 1)


def supported(acts, H: int, B: int, num_sms: Optional[int] = None) -> bool:
    """Whether kernels 1-3 take a GRU with activations ``acts`` = (act_in,
    act_gate), width ``H`` and batch ``B``, in float32 or bf16 operands.

    Both at least 1, H at most MAX_H, and kernel 3's grid fits: the state
    of a block's rows in shared memory (its rows of w and dW go to device
    memory when they do not fit beside it); the forwards' plan
    (:func:`fwd_plan`) then fits too. Both instances hold w and the state
    in float32 in shared memory, so the plan is the same for either
    operand type (``pallas_gru.supported`` takes the operand size for its
    VMEM budget; here it decides nothing). ``num_sms`` defaults to the
    current card's count (132 where there is no card)."""
    if not (len(acts) == 2 and all(a in ACT_CODES for a in acts)):
        return False
    if not (1 <= H <= MAX_H and B >= 1):
        return False
    plan = grid_plan(B, H, card_sms() if num_sms is None else num_sms)
    return plan["smem_bytes"] <= SMEM_LIMIT


def _check_supported(acts, B, H, dev):
    if not supported(acts, H, B, card_sms(dev)):
        raise ValueError(
            f"the GRU kernels do not take B={B}, H={H} (fused_gru.supported: both at "
            f"least 1, H <= {MAX_H}, and a block's state within {SMEM_LIMIT} bytes)")


def _act_codes(acts) -> Tuple[int, int]:
    acts = tuple(acts)
    if len(acts) != 2 or any(a not in ACT_CODES for a in acts):
        raise ValueError(f"the GRU kernels take activations from {sorted(ACT_CODES)} "
                         f"in each of (act_in, act_gate), got {acts}")
    return tuple(ACT_CODES[a] for a in acts)


def _operand_dtype(t: Tensor) -> torch.dtype:
    if t.dtype not in OPERAND_DTYPES:
        raise ValueError(f"the GRU kernels take float32 or bf16 operands, got {t.dtype}")
    return t.dtype


def _check_operands(x3, mask, w, acts):
    T, B, H3 = x3.shape
    H = H3 // 3
    dev = x3.device
    codes = _act_codes(acts)
    od = _operand_dtype(x3)
    if H3 != 3 * H:
        raise ValueError(f"x3 width {H3} is not 3 * H")
    if H > MAX_H:
        raise ValueError(f"H = {H}: the GRU kernels take H <= {MAX_H}")
    check(x3, "x3", (T, B, H3), dev, contiguous=False, dtype=od)
    check(mask, "mask", (T, B), dev, contiguous=False)
    check(w, "w", (H, H3), dev, dtype=od)
    return T, B, H, dev, codes


def _float_mask(mask: Tensor) -> Tensor:
    """The kernels read the mask in float32 (a bf16 layer passes it in bf16:
    0 and 1 are exact in both)."""
    return mask if mask.dtype == torch.float32 else mask.float()


def _launch_fwd(x3, mask, w, reverse, acts, residuals):
    """Kernel 1 (ys) or, with ``residuals``, kernel 2 (ys, acts, hprev):
    one persistent grid, on :func:`fwd_plan`; the instance of x3's dtype,
    whose outputs are in that dtype."""
    mask = _float_mask(mask)
    T, B, H, dev, codes = _check_operands(x3, mask, w, acts)
    od = x3.dtype
    _check_supported(acts, B, H, dev)
    sms = card_sms(dev)
    plan = fwd_plan(B, H, sms)
    ys = torch.empty((B, T, H), device=dev, dtype=od).transpose(0, 1)
    rh = torch.empty((B, H), device=dev, dtype=od)
    wslices = (None if plan["w_in_smem"] else
               torch.empty(_cdiv(H, UNITS) * 12 * H, device=dev))
    counter = torch.empty(1, dtype=torch.int32, device=dev)
    args = [ptr(x3), x3.stride(0), x3.stride(1),
            ptr(mask), mask.stride(0), mask.stride(1),
            ptr(w), ptr(ys), ys.stride(0), ys.stride(1)]
    scratch = [ptr(rh), None if wslices is None else ptr(wslices), ptr(counter),
               T, B, H, int(bool(reverse)), *codes, sms, plan["w_in_smem"]]
    kernel_flops.record(kernel_flops.gru_fwd_flops(T, B, H))
    if not residuals:
        carry = torch.empty((B, H), device=dev, dtype=od)
        _FWD[od].launch(dev, *args, ptr(carry), *scratch)
        return ys
    saved = torch.empty((T, B, 3 * H), device=dev, dtype=od)
    hprev = torch.empty((T, B, H), device=dev, dtype=od)
    _FWD_TRAIN[od].launch(dev, *args, ptr(saved), ptr(hprev), *scratch)
    return ys, saved, hprev


def _last_dim_contiguous(t: Tensor) -> Tensor:
    """Autograd may hand a gradient in any layout; the kernels read the
    outer dimensions through strides but need the last one contiguous."""
    return t if t.dim() == 0 or t.shape[-1] <= 1 or t.stride(-1) == 1 else t.contiguous()


def _launch_bwd(dy, saved, hprev, mask, w, reverse, acts, phase_ns=None):
    """dx3 [T, B, 3H] and dW [H, 3H]. ``phase_ns`` (an int64 [T, 4] tensor
    on the card, or None) receives block 0's clock in ns at each step's
    start and at the ends of its three phases (the first two with their
    grid barriers)."""
    T, B, H3 = saved.shape
    H = H3 // 3
    dev = saved.device
    codes = _act_codes(acts)
    od = _operand_dtype(saved)
    dy = _last_dim_contiguous(dy)
    mask = _float_mask(mask)
    check(dy, "dy", (T, B, H), dev, contiguous=False, dtype=od)
    check(saved, "acts", (T, B, H3), dev, dtype=od)
    check(hprev, "hprev", (T, B, H), dev, dtype=od)
    check(mask, "mask", (T, B), dev, contiguous=False)
    check(w, "w", (H, H3), dev, dtype=od)
    _check_supported(acts, B, H, dev)
    sms = card_sms(dev)
    plan = grid_plan(B, H, sms)
    dx3 = torch.empty((T, B, H3), device=dev, dtype=od)
    dw = torch.empty((H, H3), device=dev, dtype=od)
    # bf16: the products read dg | dcand rounded (dx3 itself), dW sums them
    # unrounded from a float32 copy, one buffer each for even and odd steps
    xch = None if od == torch.float32 else torch.empty((2, B, H3), device=dev)
    rows = _cdiv(H, UNITS) * 12 * H          # every group's [3H][4] rows
    wslices = None if plan["w_in_smem"] else torch.empty(rows, device=dev)
    dwacc = None if plan["dw_in_smem"] else torch.empty(rows, device=dev)
    counter = torch.empty(1, dtype=torch.int32, device=dev)
    if phase_ns is not None and (phase_ns.device != dev or phase_ns.dtype != torch.int64
                                 or tuple(phase_ns.shape) != (T, 4)
                                 or not phase_ns.is_contiguous()):
        raise ValueError(f"phase_ns must be a contiguous int64 [{T}, 4] tensor on {dev}")
    kernel_flops.record(kernel_flops.gru_bwd_flops(T, B, H))
    args = [ptr(dy), dy.stride(0), dy.stride(1), ptr(saved), ptr(hprev),
            ptr(mask), mask.stride(0), mask.stride(1), ptr(w), ptr(dx3), ptr(dw),
            None if wslices is None else ptr(wslices),
            None if dwacc is None else ptr(dwacc), ptr(counter),
            None if phase_ns is None else ptr(phase_ns)]
    if xch is not None:
        args.append(ptr(xch))
    _BWD[od].launch(dev, *args, T, B, H, int(bool(reverse)), *codes, sms, plan["w_in_smem"],
                    plan["dw_in_smem"])
    return dx3, dw


class _FusedGRU(torch.autograd.Function):
    """The training pair on the card: gru_fwd_train, then gru_bwd."""

    @staticmethod
    def forward(ctx, x3, mask, w, reverse, acts):
        ys, saved, hprev = _launch_fwd(x3, mask, w, reverse, acts, residuals=True)
        ctx.save_for_backward(saved, hprev, mask, w)
        ctx.reverse, ctx.acts = reverse, acts
        return ys

    @staticmethod
    def backward(ctx, dy):
        saved, hprev, mask, w = ctx.saved_tensors
        dx3, dw = _launch_bwd(dy, saved, hprev, mask, w, ctx.reverse, ctx.acts)
        return dx3, None, dw, None, None


def fused_gru(x3: Tensor, mask: Tensor, w: Tensor, reverse: bool = False,
              acts: Tuple[str, str] = KERNEL_ACTS) -> Tensor:
    """Masked GRU over the sequence: x3 [T, B, 3H] (bias folded in, any
    time/batch strides), mask [T, B], w [H, 3H] -> ys [T, B, H].

    On the card ys is a time-major view of batch-major storage, so
    ``ys.transpose(0, 1)`` is a contiguous [B, T, H] tensor. The mask gets
    no gradient. ys is in x3's dtype (float32 or bf16; w in the same)."""
    if x3.device.type == "cpu":
        if (x3.dtype == torch.bfloat16 and torch.is_grad_enabled()
                and (x3.requires_grad or w.requires_grad)):
            return _PlainGRU.apply(x3, mask.detach(), w, bool(reverse), tuple(acts))
        return gru_forward_reference(x3, mask, w, reverse, acts)
    if torch.is_grad_enabled() and (x3.requires_grad or w.requires_grad):
        return _FusedGRU.apply(x3, mask.detach(), w, bool(reverse), tuple(acts))
    return _launch_fwd(x3, mask, w, reverse, acts, residuals=False)
