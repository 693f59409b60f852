"""The masked peephole LSTM over a whole sequence: CUDA kernels 7a, 7b and 8
and their plain versions.

Port of ``paddle_tpu/ops/pallas_lstm.py::fused_lstm``: the inference
forward (``_fwd_kernel_light`` -> ``csrc/lstm_fwd.cu::lstm_fwd``), the
training forward that also saves the residuals (``_fwd_kernel`` ->
``lstm_fwd_train``) and its backward (``_bwd_kernel`` ->
``csrc/lstm_bwd.cu::lstm_bwd``). Cell semantics are exactly ``_cell_fwd``:
gates [candidate, input, forget, output], the gate biases folded into x4
beforehand, peepholes peep [3, H] = (input, forget, output), and padded
steps pass both carries through, so a reversed sequence stays at
h0 = c0 = 0 until it starts. The kernels take tanh, sigmoid, relu and
linear in each of the three activation slots (act_in, act_gate,
act_state), as the Pallas kernels do, and H up to ``MAX_H``. All three
run as persistent, cooperative grids in row groups of blocks, each block
owning unit groups of 4 hidden units for the whole launch: the forwards
their columns of w (one body, ``csrc/lstm_fwd.cu``, plan
:func:`fwd_plan`), the backward their rows of w and of dW
(``csrc/lstm_bwd.cu``, plan :func:`grid_plan`), in shared memory where
they fit beside the state of the block's rows; the batch bounds them.
:func:`supported` states what the kernels take, and the ``lstmemory``
layer runs its eager time loop (counted in ``EAGER_ROUTES``) for anything
else.

:func:`fused_lstm` launches the kernels for a CUDA tensor and raises on
anything they do not take: the training pair when grad mode is on and an
input requires a gradient (a ``torch.autograd.Function`` returning the
gradients of x4, w and peep), the light forward otherwise. For a CPU
tensor it runs :func:`lstm_forward_reference`, and autograd through it
gives the gradients.

bf16 operands (a bf16 model, ``GradientMachine(compute_dtype=bfloat16)``)
take the kernels' bf16 instances (``lstm_fwd_bf16``, ``lstm_fwd_train_bf16``,
``lstm_bwd_bf16``), which keep the Pallas kernels' bf16 contract: x4, w and
peep are bf16, widened on load; the cell c is carried in float32; h is
rounded to bf16 before its product with w, which accumulates in float32;
ys, the gates and h_prev are stored bf16 and c_prev float32; the backward
rounds the gate gradients before their product with w transposed, sums dW
and dpeep from the unrounded float32 values and rounds them once at the
end. :func:`lstm_forward_reference` and :func:`lstm_backward_reference`
are their plain versions, with the same rounding points; on the CPU a
bf16 LSTM under grad runs them as an autograd Function (``_PlainLSTM``),
as the Pallas function's custom VJP does.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from paddle_tpu_torch.ops import kernel_flops
from paddle_tpu_torch.ops._build import (
    I32, I64, PTR, SMEM_LIMIT, CudaKernel, card_sms, check, ptr)
from paddle_tpu_torch.ops.activations import apply_activation
from paddle_tpu_torch.ops.fused_gru import (
    ACT_CODES, OPERAND_DTYPES, _cdiv, _float_mask, _last_dim_contiguous, dact)
from paddle_tpu_torch.ops.precision import bf16_pieces, round_to

Tensor = torch.Tensor
Acts = Tuple[str, str, str]
DEFAULT_ACTS: Acts = ("tanh", "sigmoid", "sigmoid")
MAX_H = 1024        # the forwards' limit: threads per block and shared memory
# How kernel 8 cuts the work (csrc/lstm_bwd.cu): P row groups of blocks;
# in each, blocks of unit groups of UNITS hidden units in bundles of 4 or
# 8 units, each block keeping per bundle its rows of w and dW ([4H][N]
# floats each) and STATE floats a row and unit of its group's rows, beside
# the cross-warp sums of one 64-row tile (8 x 64 x N floats), the
# peephole accumulators (3 x 256 floats a bundle) and the ring that stages
# the rows of dx4 (RING_FLOATS).
UNITS = 4
STATE = 3
RING_FLOATS = 16384     # 2 slots of 4 rows x 2048 columns (N = 8), or of 8 x 1024 (N = 4)
# How kernels 7a and 7b cut the work (csrc/lstm_fwd.cu): kernel 8's row
# groups and unit groups; a block of 8 warps owns U <= 64 units, their
# four gate columns of w in quads of 4 units ([H rounded up to 8][16]
# floats and 16 of padding each) and FWD_STATE floats a row and unit (c
# and the carried h). A warp takes 16 rows and two quads (tensor-core
# tiles), QP warps (a power of 2) a pass's 16 rows, so a pass covers
# 16 * 8 // QP rows; a ring of FWD_STAGES slots stages at most FWD_SLOT
# floats of h a slot (a pass's rows by a chunk of columns, a power of 2
# from 32, each row padded by FWD_PAD floats).
FWD_WARPS = 8
# kernel 8's bf16 Hopper body (csrc/lstm_bwd_sm90.cu): 8 warps split the
# product's contraction; their partial tiles are SM90_ROWS rows
SM90_WARPS = 8
SM90_ROWS = 32
FWD_UNIT_GROUPS = 4     # unit groups a block of the forwards' default plan, where they fit
FWD_STATE = 2
FWD_STAGES = 2
FWD_SLOT = 12800
FWD_PAD = 4
# layer calls that ran the eager time loop because supported() refused
# (under remat="full" the backward's recompute runs the layer again and
# counts again, as it launches the training forward again)
EAGER_ROUTES = 0

_FWD_ARGS = [PTR, I64, I64,          # x4, its time and batch strides
             PTR, I64, I64,          # mask
             PTR, PTR,               # w, peep
             PTR, I64, I64]          # ys
_TAIL = [I32, I32, I32, I32,         # T, B, H, reverse
         I32, I32, I32]              # act_in, act_gate, act_state
_FWD_SCRATCH = [PTR, PTR, PTR,       # the carry [2][B][Hp], w's columns where not in shared memory, the counters
                PTR]                 # phase clocks [T][3] int64, or null
_FWD_GRID = [I32, I32, I32]          # num_sms, row groups, w_smem
LSTM_FWD = CudaKernel("lstm_fwd.cu", "lstm_fwd", _FWD_ARGS + _FWD_SCRATCH + _TAIL + _FWD_GRID)
LSTM_FWD_TRAIN = CudaKernel("lstm_fwd.cu", "lstm_fwd_train",
                            _FWD_ARGS + [PTR, PTR, PTR]      # acts, hprev, cprev
                            + _FWD_SCRATCH + _TAIL + _FWD_GRID)
LSTM_BWD = CudaKernel(
    "lstm_bwd.cu", "lstm_bwd",
    [PTR, I64, I64,                  # dy, its time and batch strides
     PTR, PTR, PTR,                  # acts, hprev, cprev
     PTR, I64, I64,                  # mask
     PTR, PTR,                       # w, peep
     PTR, PTR, PTR,                  # dx4, dw, dpeep
     PTR, PTR,                       # scratch: w's and dW's rows where not in shared memory
     PTR, PTR, PTR,                  # the other row groups' dW and dpeep partials, the counters
     PTR]                            # phase clocks [T][3] int64, or null
    + _TAIL + [I32, I32,             # num_sms, row groups
               I32, I32, I32],       # w_smem, dw_smem, runtime_acts
)
# the bf16 instances of the same bodies: the same arguments, bf16 x4, w,
# peep, ys, acts, hprev (cprev float32), kernel 8 also a float32 exchange
# buffer of the unrounded gate gradients
LSTM_FWD_BF16 = CudaKernel("lstm_fwd.cu", "lstm_fwd_bf16", LSTM_FWD.argtypes[:-1])
LSTM_FWD_TRAIN_BF16 = CudaKernel("lstm_fwd.cu", "lstm_fwd_train_bf16",
                                 LSTM_FWD_TRAIN.argtypes[:-1])
LSTM_BWD_BF16 = CudaKernel("lstm_bwd.cu", "lstm_bwd_bf16",
                           LSTM_BWD.argtypes[:20] + [PTR]   # + dgates in float32 [2, B, 4H]
                           + LSTM_BWD.argtypes[20:-1])
# kernel 8's bf16 body for Hopper (csrc/lstm_bwd_sm90.cu), where
# sm90_takes: lstm_bwd_bf16's operands, lo and the dpeep partials as scratch
LSTM_BWD_BF16_SM90 = CudaKernel(
    "lstm_bwd_sm90.cu", "lstm_bwd_bf16_sm90",
    LSTM_BWD.argtypes[:14]           # dy .. dpeep
    + [PTR, PTR, PTR, PTR]           # lo [T, B, 4H], dpeep partials, counters, phase clocks
    + _TAIL + [I32])                 # num_sms
KERNELS = (LSTM_FWD, LSTM_FWD_TRAIN, LSTM_BWD,
           LSTM_FWD_BF16, LSTM_FWD_TRAIN_BF16, LSTM_BWD_BF16, LSTM_BWD_BF16_SM90)
# each entry by operand dtype (OPERAND_DTYPES: float32 and bf16)
_FWD = {torch.float32: LSTM_FWD, torch.bfloat16: LSTM_FWD_BF16}
_FWD_TRAIN = {torch.float32: LSTM_FWD_TRAIN, torch.bfloat16: LSTM_FWD_TRAIN_BF16}
_BWD = {torch.float32: LSTM_BWD, torch.bfloat16: LSTM_BWD_BF16}


def lstm_cell(x4: Tensor, h: Tensor, c: Tensor, w: Tensor, peep: Tensor,
              acts: Acts = DEFAULT_ACTS, gates: bool = False):
    """One LSTM step: x4 [B, 4H] (gate biases folded in), h, c [B, H],
    w [H, 4H], peep [3, H]. Returns (h', c'), or (h', c', a, i, f, o) with
    ``gates``."""
    H = h.shape[-1]
    act_in, act_gate, act_state = acts
    g = x4 + h @ w
    ga, gi, gf, go = g[..., :H], g[..., H:2 * H], g[..., 2 * H:3 * H], g[..., 3 * H:]
    i = apply_activation(act_gate, gi + peep[0] * c)
    f = apply_activation(act_gate, gf + peep[1] * c)
    a = apply_activation(act_in, ga)
    c_new = f * c + i * a
    o = apply_activation(act_gate, go + peep[2] * c_new)
    h_new = o * apply_activation(act_state, c_new)
    return (h_new, c_new, a, i, f, o) if gates else (h_new, c_new)


def lstm_forward_reference(x4: Tensor, mask: Tensor, w: Tensor, peep: Tensor,
                           reverse: bool = False, acts: Acts = DEFAULT_ACTS,
                           residuals: bool = False):
    """Plain PyTorch version of the kernels: x4 [T, B, 4H], mask [T, B],
    w [H, 4H], peep [3, H] -> ys [T, B, H], with ys[t] = 0 at padded steps.

    ``residuals=True`` also returns what ``lstm_fwd_train`` saves, each at
    its step's own time index: acts = [a | i | f | o] [T, B, 4H] (after the
    activations), h_prev and c_prev [T, B, H]. bf16 operands follow the
    kernels' bf16 contract (:func:`_lstm_forward_mixed`); float32 runs
    :func:`lstm_loop`."""
    if x4.dtype == torch.bfloat16:
        return _lstm_forward_mixed(x4, mask, w, peep, reverse, acts, residuals)
    return lstm_loop(x4, mask, w, peep, reverse, acts, residuals)


def lstm_loop(x4: Tensor, mask: Tensor, w: Tensor, peep: Tensor, reverse: bool = False,
              acts: Acts = DEFAULT_ACTS, residuals: bool = False):
    """The LSTM as a time loop with every operation in x4's dtype: the
    float32 kernels' plain version, and the ``lstmemory`` layer's eager
    route (in bf16 it runs as the JAX layer's ``lax.scan`` does, both
    carries bf16 too). Arguments and results as
    :func:`lstm_forward_reference`."""
    T, B, H4 = x4.shape
    H = H4 // 4
    h = x4.new_zeros(B, H)
    c = x4.new_zeros(B, H)
    ys, saved, hprev, cprev = [None] * T, [None] * T, [None] * T, [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        h_new, c_new, a, i, f, o = lstm_cell(x4[t], h, c, w, peep, acts, gates=True)
        m = mask[t][:, None]
        ys[t] = m * h_new
        saved[t], hprev[t], cprev[t] = torch.cat([a, i, f, o], dim=-1), h, c
        h = m * h_new + (1.0 - m) * h
        c = m * c_new + (1.0 - m) * c
    return _stacked(x4, ys, saved, hprev, cprev, residuals, x4.dtype)


def _stacked(x4, ys, saved, hprev, cprev, residuals, c_dtype):
    """The per-step lists as [T, ...] tensors (empty ones of the right
    shapes for T = 0), c_prev in ``c_dtype``."""
    T, B, H4 = x4.shape
    H = H4 // 4
    if not T:
        empty = x4.new_zeros(0, B, H)
        return ((empty, x4.new_zeros(0, B, H4), empty, x4.new_zeros(0, B, H, dtype=c_dtype))
                if residuals else empty)
    ys = torch.stack(ys)
    if not residuals:
        return ys
    return ys, torch.stack(saved), torch.stack(hprev), torch.stack(cprev)


def _lstm_forward_mixed(x4, mask, w, peep, reverse, acts, residuals):
    """The bf16 kernels' plain version (``pallas_lstm._fwd_kernel`` in
    bf16): both carries in float32, x4, w and peep widened, h rounded to
    bf16 before its product with w (exact in float32, summed in float32),
    ys, the gates and h_prev stored bf16, c_prev float32."""
    T, B, H4 = x4.shape
    H, od = H4 // 4, x4.dtype
    act_in, act_gate, act_state = acts
    wf, pf = w.float(), peep.float()
    h = x4.new_zeros(B, H, dtype=torch.float32)
    c = x4.new_zeros(B, H, dtype=torch.float32)
    ys, saved, hprev, cprev = [None] * T, [None] * T, [None] * T, [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        g = x4[t].float() + round_to(h, od) @ wf
        i = apply_activation(act_gate, g[:, H:2 * H] + pf[0] * c)
        f = apply_activation(act_gate, g[:, 2 * H:3 * H] + pf[1] * c)
        a = apply_activation(act_in, g[:, :H])
        c_new = f * c + i * a
        o = apply_activation(act_gate, g[:, 3 * H:] + pf[2] * c_new)
        h_new = o * apply_activation(act_state, c_new)
        m = mask[t][:, None].float()
        ys[t] = (m * h_new).to(od)
        saved[t], hprev[t], cprev[t] = torch.cat([a, i, f, o], dim=-1).to(od), h.to(od), c
        h = m * h_new + (1.0 - m) * h
        c = m * c_new + (1.0 - m) * c
    return _stacked(x4, ys, saved, hprev, cprev, residuals, torch.float32)


def lstm_backward_reference(dy: Tensor, saved: Tensor, hprev: Tensor, cprev: Tensor,
                            mask: Tensor, w: Tensor, peep: Tensor, reverse: bool = False,
                            acts: Acts = DEFAULT_ACTS, dw_pieces: int = 0,
                            dx4_forced: Optional[Tensor] = None) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain PyTorch version of kernel 8 (``pallas_lstm._bwd_kernel``): dx4
    [T, B, 4H] in dy's dtype, dW [H, 4H] in w's and dpeep [3, H] in peep's,
    from dy [T, B, H] and the residuals of :func:`lstm_forward_reference`.
    Per step, walked against the forward's order, in float32: c' = f c + i a
    (from the saved gates and c_prev), dh = m (DH + dy), dgo, dc' =
    dh o act_state'(s) + m DC + dgo po, dgi, dgf, dga, dx4[t] = [dga | dgi |
    dgf | dgo], DH = round(dx4[t]) . w^T + (1 - m) DH, DC = dc' f + dgi pi +
    dgf pf + (1 - m) DC; dW sums h_prev^T dx4[t] and dpeep the peephole
    terms, unrounded, each rounded once. The rounding is to the residuals'
    dtype (none in float32). ``dw_pieces`` = 2 sums dW from the gate
    gradients as two bf16 pieces, hi = bf16(g) and lo = bf16(g - hi), as the
    Hopper body (``lstm_bwd_bf16_sm90``) does; 1 from hi alone (the one-piece
    control); 0 (the kernels' contract) from g unrounded. ``dx4_forced`` (a
    kernel's dx4) replaces each step's rounded gate gradients in the DH
    product: the reference then walks the kernel's own recurrence, whose
    bf16 roundings otherwise part from its own over the steps, so that a
    kernel's dW can be held to the float32 sums of its own gate gradients
    within bf16 spacings."""
    T, B, H4 = saved.shape
    H, od = H4 // 4, saved.dtype
    act_in, act_gate, act_state = acts
    wt, pf = w.float().t(), peep.float()
    DH = saved.new_zeros(B, H, dtype=torch.float32)
    DC = saved.new_zeros(B, H, dtype=torch.float32)
    dw = saved.new_zeros(H, H4, dtype=torch.float32)
    dp = saved.new_zeros(3, H, dtype=torch.float32)
    dx4 = [None] * T
    for t in (range(T) if reverse else range(T - 1, -1, -1)):
        g = saved[t].float()
        a, i, f, o = g[:, :H], g[:, H:2 * H], g[:, 2 * H:3 * H], g[:, 3 * H:]
        cp, hp = cprev[t].float(), hprev[t].float()
        m = mask[t][:, None].float()
        c_new = f * cp + i * a
        sc = apply_activation(act_state, c_new)
        dh = m * (DH + dy[t].float())
        dgo = dh * sc * dact(act_gate, o)
        dc = dh * o * dact(act_state, sc) + m * DC + dgo * pf[2]
        dgi = dc * a * dact(act_gate, i)
        dgf = dc * cp * dact(act_gate, f)
        dga = dc * i * dact(act_in, a)
        dg = torch.cat([dga, dgi, dgf, dgo], dim=1)
        dx4[t] = dg.to(dy.dtype)
        gr = round_to(dg, od) if dx4_forced is None else dx4_forced[t].float()
        DH = gr @ wt + (1.0 - m) * DH
        DC = dc * f + dgi * pf[0] + dgf * pf[1] + (1.0 - m) * DC
        dw = dw + hp.t() @ bf16_pieces(dg, dw_pieces)
        dp = dp + torch.stack([(dgi * cp).sum(0), (dgf * cp).sum(0), (dgo * c_new).sum(0)])
    dx4 = torch.stack(dx4) if T else dy.new_zeros(0, B, H4)
    return dx4, dw.to(w.dtype), dp.to(peep.dtype)


class _PlainLSTM(torch.autograd.Function):
    """The bf16 LSTM on the CPU: the kernels' plain forward with residuals
    and their plain backward, so that the gradients round where the
    kernels' (and the Pallas custom VJP's) do."""

    @staticmethod
    def forward(ctx, x4, mask, w, peep, reverse, acts):
        ys, saved, hprev, cprev = lstm_forward_reference(x4, mask, w, peep, reverse, acts,
                                                         residuals=True)
        ctx.save_for_backward(saved, hprev, cprev, mask, w, peep)
        ctx.reverse, ctx.acts = reverse, acts
        return ys

    @staticmethod
    def backward(ctx, dy):
        saved, hprev, cprev, mask, w, peep = ctx.saved_tensors
        dx4, dw, dpeep = lstm_backward_reference(dy, saved, hprev, cprev, mask, w, peep,
                                                 ctx.reverse, ctx.acts)
        return dx4, None, dw, dpeep, None, None


def grid_plan(B: int, H: int, sms: int, row_groups: Optional[int] = None) -> Dict[str, int]:
    """Blocks, row groups, shared memory per block and placement of kernel 8.

    ceil(H / 4) unit groups go to G blocks of each of P row groups, at
    most sms blocks in all; a row group owns ceil(B / P) rows. By default
    P = sms // ceil(groups / 2), at most B and at least 1: as many row
    groups as the card holds with two unit groups a block. A block's
    units are processed in bundles of N = 8 (4 when it owns one group),
    each reading its group's rows once. A block keeps the state of its
    rows in shared memory, and its rows of w, then of dW, there too where
    they fit (4H N floats each a bundle); the rest in device memory it
    alone touches."""
    groups = _cdiv(H, UNITS)
    if row_groups is None:
        row_groups = max(1, min(B, sms // _cdiv(groups, 2)))
    P = row_groups
    G = max(1, min(groups, sms // P))
    gpb = _cdiv(groups, G)
    G = _cdiv(groups, gpb)
    N = 8 if gpb >= 2 else 4
    bundles = _cdiv(UNITS * gpb, N)
    R = _cdiv(B, P)
    state = 4 * (bundles * STATE * R * N + 8 * 64 * N + 3 * 256 * bundles + RING_FLOATS)
    rows = 4 * bundles * 4 * H * N
    w_in_smem = state + rows <= SMEM_LIMIT
    dw_in_smem = state + 2 * rows <= SMEM_LIMIT
    return dict(blocks=P * G, row_groups=P, blocks_per_group=G, unit_groups_per_block=gpb,
                units_per_bundle=N, bundles=bundles, rows_per_group=R,
                smem_bytes=state + rows * (int(w_in_smem) + int(dw_in_smem)),
                w_in_smem=int(w_in_smem), dw_in_smem=int(dw_in_smem))


def sm90_plan(B: int, H: int, sms: int) -> Optional[Dict[str, int]]:
    """The grid of kernel 8's bf16 body for Hopper (``csrc/lstm_bwd_sm90.cu``
    make_plan), or None where it does not fit.

    H a multiple of 64 (a warp's share of the 4H contraction is whole 32-k
    chunks); blocks of U = 32 hidden units, else 16, their rows of w in bf16
    in shared memory beside SM90_WARPS partial product tiles of SM90_ROWS
    rows and the float32 DH and DC of their group's rows; G = H / U blocks a
    row group, P = sms // G row groups (at most B), R = ceil(B / P) rows
    each; the first U whose block fits SMEM_LIMIT."""
    if B < 1 or H <= 0 or H % 64:
        return None
    for U in (32, 16):
        G = H // U
        if G > sms:
            continue
        P = max(1, min(B, sms // G))
        R = _cdiv(B, P)
        smem = 2 * U * 4 * H + 4 * SM90_WARPS * SM90_ROWS * U + 8 * R * U + 12 * U
        if smem <= SMEM_LIMIT:
            return dict(units_per_block=U, blocks_per_group=G, row_groups=P,
                        rows_per_group=R, blocks=P * G, smem_bytes=smem)
    return None


def sm90_takes(B: int, H: int, num_sms: Optional[int] = None, *operands: Tensor) -> bool:
    """Whether kernel 8's bf16 backward runs on its Hopper body
    (``lstm_bwd_bf16_sm90``) at batch B and width H: :func:`sm90_plan` fits
    on a card of ``num_sms`` SMs (the current card's by default), and each of
    ``operands`` (w and hprev, which it reads as 16-byte vectors) starts on
    16 bytes. Other bf16 shapes take ``lstm_bwd_bf16`` (the persistent body); the
    float32 instance is ``lstm_bwd``. Reads shapes and base addresses only."""
    sms = card_sms() if num_sms is None else num_sms
    return sm90_plan(B, H, sms) is not None and all(t.data_ptr() % 16 == 0 for t in operands)


def fwd_plan(B: int, H: int, sms: int, row_groups: Optional[int] = None) -> Dict[str, int]:
    """Blocks, row groups, shared memory per block and placement of
    kernels 7a and 7b.

    Kernel 8's cut (:func:`grid_plan`: P row groups of G blocks, a block
    owning gpb unit groups, U = 4 gpb units). By default as many row
    groups (at most B) as give blocks of FWD_UNIT_GROUPS unit groups,
    where their columns of w then fit in shared memory (at the
    classifier's shape a block then reads half the rows of h a step that
    it reads with kernel 8's P), else kernel 8's P. QP, the least power
    of 2 at least U / 8, warps share each 16 rows, so a pass covers
    16 * 8 // QP rows (none past 64 units), and h is staged in chunks of
    the most columns, a power of 2 from 32, that keep a slot within
    FWD_SLOT floats. A block keeps c and the carried h of its
    rows (FWD_STATE floats a row and unit) and the ring in shared
    memory, and its columns of w there too where they fit, else in device
    memory it alone touches. Without w that is at most kernel 8's state:
    2 floats a row and unit against its 3, and a ring of at most 17,408
    floats (two slots of 128 rows x 68) against its ring, cross-warp sums
    and peephole sums (at least 19,200 floats), so this plan fits wherever
    kernel 8's does."""
    groups = _cdiv(H, UNITS)
    if row_groups is None:
        wide = fwd_plan(B, H, sms, max(1, min(B, sms // _cdiv(groups, FWD_UNIT_GROUPS))))
        if wide["w_in_smem"]:
            return wide
        row_groups = grid_plan(B, H, sms)["row_groups"]
    P = row_groups
    G = max(1, min(groups, sms // P))
    gpb = _cdiv(groups, G)
    G = _cdiv(groups, gpb)
    U = UNITS * gpb
    R = _cdiv(B, P)
    QP = 1
    while 8 * QP < U:
        QP *= 2
    rows_per_pass = 16 * (FWD_WARPS // QP) if QP <= FWD_WARPS else 0
    chunk = 32
    while rows_per_pass and rows_per_pass * (2 * chunk + FWD_PAD) <= FWD_SLOT:
        chunk *= 2
    ring = FWD_STAGES * rows_per_pass * (chunk + FWD_PAD)
    state = 4 * (FWD_STATE * R * U + ring)
    cols = 4 * (U // 4) * (16 * _cdiv(H, 8) * 8 + 16)
    w_in_smem = state + cols <= SMEM_LIMIT
    return dict(blocks=P * G, row_groups=P, blocks_per_group=G, unit_groups_per_block=gpb,
                units_per_block=U, rows_per_group=R, rows_per_pass=rows_per_pass,
                chunk=chunk, smem_bytes=state + cols * int(w_in_smem),
                w_in_smem=int(w_in_smem), wslice_floats=cols // 4)


def _fwd_fits(plan: Dict[str, int], sms: int) -> bool:
    """Whether kernels 7a and 7b take ``plan`` (:func:`fwd_plan`) on a card
    of ``sms`` SMs: 1 <= P <= sms, at most 8 * FWD_WARPS units a block (a
    pass then has rows), and a block's shared memory within SMEM_LIMIT."""
    return (1 <= plan["row_groups"] <= sms and plan["rows_per_pass"] > 0
            and plan["smem_bytes"] <= SMEM_LIMIT)


def fwd_barriers(T: int) -> int:
    """The barriers one launch of kernels 7a and 7b passes: one a step
    within its row group, but after the last."""
    return max(0, T - 1)


def grid_barriers(T: int, row_groups: int) -> int:
    """The barriers one launch of kernel 8 passes: one a step within its
    row group, and one over the whole grid when there are several."""
    return T + int(row_groups > 1)


def supported(acts, H: int, B: int, num_sms: Optional[int] = None) -> bool:
    """Whether kernels 7a, 7b and 8 take an LSTM with activations ``acts`` =
    (act_in, act_gate, act_state), width ``H`` and batch ``B``.

    Both at least 1, H at most MAX_H, and both grids fit, kernel 8's and
    the forwards': the state of a block's rows in shared memory (the
    blocks' slices of w and dW go to device memory when they do not fit
    beside it). The float32 and bf16 instances hold w, the state and the
    ring in the same float32 carve of shared memory, so the plan is the
    same for either operand type (``pallas_lstm.supported`` takes the
    operand size for its VMEM budget; here it decides nothing). ``num_sms``
    defaults to the current card's count (132 where there is no card)."""
    if not (len(acts) == 3 and all(a in ACT_CODES for a in acts)):
        return False
    if not (1 <= H <= MAX_H and B >= 1):
        return False
    sms = card_sms() if num_sms is None else num_sms
    return (grid_plan(B, H, sms)["smem_bytes"] <= SMEM_LIMIT
            and _fwd_fits(fwd_plan(B, H, sms), sms))


def _check_supported(acts, B, H, dev):
    if not supported(acts, H, B, card_sms(dev)):
        raise ValueError(
            f"the LSTM kernels do not take B={B}, H={H} (fused_lstm.supported: both at "
            f"least 1, H <= {MAX_H}, and a block's state within {SMEM_LIMIT} bytes)")


def _act_codes(acts) -> Tuple[int, int, int]:
    acts = tuple(acts)
    if len(acts) != 3 or any(a not in ACT_CODES for a in acts):
        raise ValueError(f"the LSTM kernels take activations from {sorted(ACT_CODES)} "
                         f"in each of (act_in, act_gate, act_state), got {acts}")
    return tuple(ACT_CODES[a] for a in acts)


def _operand_dtype(t: Tensor) -> torch.dtype:
    if t.dtype not in OPERAND_DTYPES:
        raise ValueError(f"the LSTM kernels take float32 or bf16 operands, got {t.dtype}")
    return t.dtype


def _check_operands(x4, mask, w, peep, acts):
    """x4, w and peep in one operand dtype (float32 or bf16), the mask in
    float32 (:func:`_float_mask` first)."""
    T, B, H4 = x4.shape
    H = H4 // 4
    dev = x4.device
    codes = _act_codes(acts)
    od = _operand_dtype(x4)
    if H4 != 4 * H:
        raise ValueError(f"x4 width {H4} is not 4 * H")
    if H > MAX_H:
        raise ValueError(f"H = {H}: the LSTM kernels take H <= {MAX_H}")
    check(x4, "x4", (T, B, H4), dev, contiguous=False, dtype=od)
    check(mask, "mask", (T, B), dev, contiguous=False)
    check(w, "w", (H, H4), dev, dtype=od)
    check(peep, "peep", (3, H), dev, dtype=od)
    return T, B, H, dev, codes


def _launch_fwd(x4, mask, w, peep, reverse, acts, residuals, row_groups=None,
                phase_ns=None):
    """ys [T, B, H] (kernel 7a), or with ``residuals`` also acts, hprev and
    cprev (kernel 7b). ``row_groups`` overrides the plan's P (to time the
    alternatives); ``phase_ns`` (an int64 [T, 3] tensor on the card, or
    None) receives block 0's clock in ns at each step's start and at the
    ends of its product and of its cells. The instance of x4's dtype, whose
    outputs are in that dtype but cprev, float32 in both."""
    mask = _float_mask(mask)
    T, B, H, dev, codes = _check_operands(x4, mask, w, peep, acts)
    od = x4.dtype
    sms = card_sms(dev)
    plan = fwd_plan(B, H, sms, row_groups)
    P = plan["row_groups"]
    if not _fwd_fits(plan, sms):
        raise ValueError(f"kernels 7a and 7b take 1 <= row_groups <= {sms}, at most "
                         f"{8 * FWD_WARPS} units a block and {SMEM_LIMIT} bytes of shared "
                         f"memory, got {plan}")
    if phase_ns is not None and (phase_ns.device != dev or phase_ns.dtype != torch.int64
                                 or tuple(phase_ns.shape) != (T, 3)
                                 or not phase_ns.is_contiguous()):
        raise ValueError(f"phase_ns must be a contiguous int64 [{T}, 3] tensor on {dev}")
    ys = torch.empty((B, T, H), device=dev, dtype=od).transpose(0, 1)
    # the carry between steps: 7b's own hprev where its rows start on 16
    # bytes (H a multiple of 4 floats or 8 bf16), else rows of Hp, H rounded
    # up to that multiple
    per16 = 16 // ys.element_size()
    hbuf = (torch.empty(2 * B * _cdiv(H, per16) * per16, device=dev, dtype=od)
            if not residuals or H % per16 else None)
    wslices = None if plan["w_in_smem"] else torch.empty(
        plan["blocks"] * plan["wslice_floats"], device=dev)
    counters = torch.empty(P, dtype=torch.int32, device=dev)
    opt = lambda t: None if t is None else ptr(t)
    args = [ptr(x4), x4.stride(0), x4.stride(1),
            ptr(mask), mask.stride(0), mask.stride(1),
            ptr(w), ptr(peep), ptr(ys), ys.stride(0), ys.stride(1)]
    tail = [opt(hbuf), opt(wslices), ptr(counters), opt(phase_ns),
            T, B, H, int(bool(reverse)), *codes, sms, P, plan["w_in_smem"]]
    if not residuals:
        kernel_flops.record(kernel_flops.lstm_fwd_flops(T, B, H))
        _FWD[od].launch(dev, *args, *tail)
        return ys
    saved = torch.empty((T, B, 4 * H), device=dev, dtype=od)
    hprev = torch.empty((T, B, H), device=dev, dtype=od)
    cprev = torch.empty((T, B, H), device=dev)
    kernel_flops.record(kernel_flops.lstm_fwd_flops(T, B, H))
    _FWD_TRAIN[od].launch(dev, *args, ptr(saved), ptr(hprev), ptr(cprev), *tail)
    return ys, saved, hprev, cprev


def _launch_bwd(dy, saved, hprev, cprev, mask, w, peep, reverse, acts, phase_ns=None):
    """dx4 [T, B, 4H], dW [H, 4H] and dpeep [3, H], in the residuals' dtype
    (dy, acts, hprev, w and peep in it, cprev float32). ``phase_ns`` (an
    int64 [T, 3] tensor on the card, or None) receives block 0's clock in
    ns at each step's start and at the ends of its two phases (the first
    with its barrier). bf16 residuals take the Hopper body
    (:func:`_launch_bwd_sm90`) where :func:`sm90_takes`, every other shape
    the persistent body (:func:`_launch_bwd_persistent`)."""
    if saved.dtype == torch.bfloat16 and sm90_takes(
            saved.shape[1], saved.shape[2] // 4, card_sms(saved.device), w, hprev):
        return _launch_bwd_sm90(dy, saved, hprev, cprev, mask, w, peep, reverse, acts, phase_ns)
    return _launch_bwd_persistent(dy, saved, hprev, cprev, mask, w, peep, reverse, acts,
                                  phase_ns)


def _check_bwd(dy, saved, hprev, cprev, mask, w, peep, acts, phase_ns):
    """Kernel 8's operands checked: (dy, mask) as the bodies read them, the
    operand dtype, the activation codes and the card's SMs."""
    T, B, H4 = saved.shape
    H = H4 // 4
    dev = saved.device
    codes = _act_codes(acts)
    od = _operand_dtype(saved)
    dy = _last_dim_contiguous(dy)
    mask = _float_mask(mask)
    check(dy, "dy", (T, B, H), dev, contiguous=False, dtype=od)
    check(saved, "acts", (T, B, H4), dev, dtype=od)
    check(hprev, "hprev", (T, B, H), dev, dtype=od)
    check(cprev, "cprev", (T, B, H), dev)
    check(mask, "mask", (T, B), dev, contiguous=False)
    check(w, "w", (H, H4), dev, dtype=od)
    check(peep, "peep", (3, H), dev, dtype=od)
    _check_supported(acts, max(B, 1), H, dev)
    if phase_ns is not None and (phase_ns.device != dev or phase_ns.dtype != torch.int64
                                 or tuple(phase_ns.shape) != (T, 3)
                                 or not phase_ns.is_contiguous()):
        raise ValueError(f"phase_ns must be a contiguous int64 [{T}, 3] tensor on {dev}")
    return dy, mask, od, codes, card_sms(dev)


def _launch_bwd_persistent(dy, saved, hprev, cprev, mask, w, peep, reverse, acts,
                           phase_ns=None, row_groups=None, runtime_acts=False):
    """Kernel 8 on its persistent body (``lstm_bwd``, or ``lstm_bwd_bf16``
    for bf16 residuals), whatever the shape: :func:`_launch_bwd`'s outputs.
    ``row_groups`` overrides the plan's P, and ``runtime_acts`` reads the
    activation codes at run time even for a triple compiled into the kernel
    (both to time the alternatives)."""
    dy, mask, od, codes, sms = _check_bwd(dy, saved, hprev, cprev, mask, w, peep, acts,
                                          phase_ns)
    T, B, H4 = saved.shape
    H = H4 // 4
    dev = saved.device
    plan = grid_plan(B, H, sms, row_groups)
    P = plan["row_groups"]
    if not 1 <= P <= sms or plan["smem_bytes"] > SMEM_LIMIT:
        raise ValueError(f"kernel 8 takes 1 <= row_groups <= {sms} within {SMEM_LIMIT} "
                         f"bytes of shared memory a block, got {plan}")
    dx4 = torch.empty((T, B, H4), device=dev, dtype=od)
    dw = torch.empty((H, H4), device=dev, dtype=od)
    dpeep = torch.empty((3, H), device=dev, dtype=od)
    # bf16: DH's product reads the gate gradients rounded (dx4 itself), dW
    # sums them unrounded from a float32 copy, one buffer each for even and
    # odd steps
    xch = None if od == torch.float32 else torch.empty((2, B, H4), device=dev)
    rows = plan["blocks"] * plan["bundles"] * H4 * plan["units_per_bundle"]
    wslices = None if plan["w_in_smem"] else torch.empty(rows, device=dev)
    dwacc = None if plan["dw_in_smem"] else torch.empty(rows, device=dev)
    dwpart = torch.empty(((P - 1) * H * H4,), device=dev) if P > 1 else None
    ppart = torch.empty((P * 3 * H,), device=dev) if P > 1 else None
    counters = torch.empty(P + 1, dtype=torch.int32, device=dev)
    opt = lambda t: None if t is None else ptr(t)
    kernel_flops.record(kernel_flops.lstm_bwd_flops(T, B, H))
    args = [ptr(dy), dy.stride(0), dy.stride(1), ptr(saved), ptr(hprev), ptr(cprev),
            ptr(mask), mask.stride(0), mask.stride(1), ptr(w), ptr(peep),
            ptr(dx4), ptr(dw), ptr(dpeep), opt(wslices), opt(dwacc), opt(dwpart),
            opt(ppart), ptr(counters), opt(phase_ns)]
    if xch is not None:
        args.append(ptr(xch))
    _BWD[od].launch(dev, *args, T, B, H, int(bool(reverse)), *codes, sms, P,
                    plan["w_in_smem"], plan["dw_in_smem"], int(bool(runtime_acts)))
    return dx4, dw, dpeep


def _launch_bwd_sm90(dy, saved, hprev, cprev, mask, w, peep, reverse, acts, phase_ns=None):
    """Kernel 8's bf16 backward on its Hopper body (``lstm_bwd_bf16_sm90``):
    :func:`_launch_bwd`'s outputs from the recurrence, then dW = hprev^T
    (hi + lo) over every row, lo = the bf16 rest of each gate gradient in a
    [T, B, 4H] scratch. A shape that :func:`sm90_takes` refuses raises."""
    dy, mask, od, codes, sms = _check_bwd(dy, saved, hprev, cprev, mask, w, peep, acts,
                                          phase_ns)
    T, B, H4 = saved.shape
    H = H4 // 4
    dev = saved.device
    if od != torch.bfloat16 or not sm90_takes(B, H, sms, w, hprev):
        raise ValueError(f"lstm_bwd_bf16_sm90 takes bf16, H a multiple of 64 within a block's "
                         f"{SMEM_LIMIT} bytes of shared memory and w, hprev on 16 bytes; got "
                         f"{od}, B={B}, H={H}")
    plan = sm90_plan(B, H, sms)
    dx4 = torch.empty((T, B, H4), device=dev, dtype=torch.bfloat16)
    dw = torch.empty((H, H4), device=dev, dtype=torch.bfloat16)
    dpeep = torch.empty((3, H), device=dev, dtype=torch.bfloat16)
    lo = torch.empty((T, B, H4), device=dev, dtype=torch.bfloat16)
    ppart = torch.empty((plan["row_groups"] * 3 * H,), device=dev)
    counters = torch.empty(plan["row_groups"], dtype=torch.int32, device=dev)
    kernel_flops.record(kernel_flops.lstm_bwd_flops(T, B, H))
    LSTM_BWD_BF16_SM90.launch(
        dev, ptr(dy), dy.stride(0), dy.stride(1), ptr(saved), ptr(hprev), ptr(cprev),
        ptr(mask), mask.stride(0), mask.stride(1), ptr(w), ptr(peep), ptr(dx4), ptr(dw),
        ptr(dpeep), ptr(lo), ptr(ppart), ptr(counters),
        None if phase_ns is None else ptr(phase_ns),
        T, B, H, int(bool(reverse)), *codes, sms)
    return dx4, dw, dpeep


class _FusedLSTM(torch.autograd.Function):
    """The training pair on the card: lstm_fwd_train, then lstm_bwd."""

    @staticmethod
    def forward(ctx, x4, mask, w, peep, reverse, acts):
        ys, saved, hprev, cprev = _launch_fwd(x4, mask, w, peep, reverse, acts, residuals=True)
        ctx.save_for_backward(saved, hprev, cprev, mask, w, peep)
        ctx.reverse, ctx.acts = reverse, acts
        return ys

    @staticmethod
    def backward(ctx, dy):
        saved, hprev, cprev, mask, w, peep = ctx.saved_tensors
        dx4, dw, dpeep = _launch_bwd(dy, saved, hprev, cprev, mask, w, peep,
                                     ctx.reverse, ctx.acts)
        return dx4, None, dw, dpeep, None, None


def fused_lstm(x4: Tensor, mask: Tensor, w: Tensor, peep: Tensor, reverse: bool = False,
               acts: Acts = DEFAULT_ACTS) -> Tensor:
    """Masked peephole LSTM over the sequence: x4 [T, B, 4H] (gate biases
    folded in, any time/batch strides), mask [T, B], w [H, 4H], peep [3, H]
    -> ys [T, B, H].

    On the card ys is a time-major view of batch-major storage, so
    ``ys.transpose(0, 1)`` is a contiguous [B, T, H] tensor. The mask gets
    no gradient. ys is in x4's dtype (float32 or bf16; w and peep in the
    same)."""
    wants_grad = torch.is_grad_enabled() and (
        x4.requires_grad or w.requires_grad or peep.requires_grad)
    if x4.device.type == "cpu":
        if x4.dtype == torch.bfloat16 and wants_grad:
            return _PlainLSTM.apply(x4, mask.detach(), w, peep, bool(reverse), tuple(acts))
        return lstm_forward_reference(x4, mask, w, peep, reverse, acts)
    if wants_grad:
        mask = _float_mask(mask.detach())
        _, B, H, dev, _ = _check_operands(x4, mask, w, peep, acts)
        _check_supported(acts, B, H, dev)            # before the forward launches
        return _FusedLSTM.apply(x4, mask, w, peep, bool(reverse), tuple(acts))
    return _launch_fwd(x4, mask, w, peep, reverse, acts, residuals=False)
