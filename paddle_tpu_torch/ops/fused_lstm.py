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
act_state), as the Pallas kernels do.

:func:`fused_lstm` launches the kernels for a CUDA tensor and raises on
anything they do not take: the training pair when grad mode is on and an
input requires a gradient (a ``torch.autograd.Function`` returning the
gradients of x4, w and peep), the light forward otherwise. For a CPU
tensor it runs :func:`lstm_forward_reference`, and autograd through it
gives the gradients.
"""

from __future__ import annotations

from typing import Tuple

import torch

from paddle_tpu_torch.ops._build import I32, I64, PTR, CudaKernel, check, ptr
from paddle_tpu_torch.ops.activations import apply_activation
from paddle_tpu_torch.ops.fused_gru import _last_dim_contiguous

Tensor = torch.Tensor
Acts = Tuple[str, str, str]
DEFAULT_ACTS: Acts = ("tanh", "sigmoid", "sigmoid")
# the activation codes of csrc/common.cuh act_f32
ACT_CODES = {"tanh": 0, "sigmoid": 1, "relu": 2, "linear": 3}
MAX_H = 1024        # the kernels' limit: threads per block and shared memory

_FWD_ARGS = [PTR, I64, I64,          # x4, its time and batch strides
             PTR, I64, I64,          # mask
             PTR, PTR,               # w, peep
             PTR, I64, I64]          # ys
_TAIL = [I32, I32, I32, I32,         # T, B, H, reverse
         I32, I32, I32]              # act_in, act_gate, act_state
LSTM_FWD = CudaKernel("lstm_fwd.cu", "lstm_fwd", _FWD_ARGS + _TAIL)
LSTM_FWD_TRAIN = CudaKernel("lstm_fwd.cu", "lstm_fwd_train",
                            _FWD_ARGS + [PTR, PTR, PTR] + _TAIL)   # acts, hprev, cprev
LSTM_BWD = CudaKernel(
    "lstm_bwd.cu", "lstm_bwd",
    [PTR, I64, I64,                  # dy, its time and batch strides
     PTR, PTR, PTR,                  # acts, hprev, cprev
     PTR, I64, I64,                  # mask
     PTR, PTR,                       # w, peep
     PTR, PTR, PTR, PTR, PTR]        # dx4, dw, dpeep; scratch wt, peep partials
    + _TAIL,
)
KERNELS = (LSTM_FWD, LSTM_FWD_TRAIN, LSTM_BWD)


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
    activations), h_prev and c_prev [T, B, H]."""
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
    if not T:
        empty = x4.new_zeros(0, B, H)
        return (empty, x4.new_zeros(0, B, H4), empty, empty) if residuals else empty
    ys = torch.stack(ys)
    if not residuals:
        return ys
    return ys, torch.stack(saved), torch.stack(hprev), torch.stack(cprev)


def _act_codes(acts) -> Tuple[int, int, int]:
    acts = tuple(acts)
    if len(acts) != 3 or any(a not in ACT_CODES for a in acts):
        raise ValueError(f"the LSTM kernels take activations from {sorted(ACT_CODES)} "
                         f"in each of (act_in, act_gate, act_state), got {acts}")
    return tuple(ACT_CODES[a] for a in acts)


def _check_operands(x4, mask, w, peep, acts):
    T, B, H4 = x4.shape
    H = H4 // 4
    dev = x4.device
    codes = _act_codes(acts)
    if H4 != 4 * H:
        raise ValueError(f"x4 width {H4} is not 4 * H")
    if H > MAX_H:
        raise ValueError(f"H = {H}: the LSTM kernels take H <= {MAX_H}")
    check(x4, "x4", (T, B, H4), dev, contiguous=False)
    check(mask, "mask", (T, B), dev, contiguous=False)
    check(w, "w", (H, H4), dev)
    check(peep, "peep", (3, H), dev)
    return T, B, H, dev, codes


def _launch_fwd(x4, mask, w, peep, reverse, acts, residuals):
    T, B, H, dev, codes = _check_operands(x4, mask, w, peep, acts)
    ys = torch.empty((B, T, H), device=dev).transpose(0, 1)
    args = [ptr(x4), x4.stride(0), x4.stride(1),
            ptr(mask), mask.stride(0), mask.stride(1),
            ptr(w), ptr(peep), ptr(ys), ys.stride(0), ys.stride(1)]
    tail = [T, B, H, int(bool(reverse)), *codes]
    if not residuals:
        LSTM_FWD.launch(dev, *args, *tail)
        return ys
    saved = torch.empty((T, B, 4 * H), device=dev)
    hprev = torch.empty((T, B, H), device=dev)
    cprev = torch.empty((T, B, H), device=dev)
    LSTM_FWD_TRAIN.launch(dev, *args, ptr(saved), ptr(hprev), ptr(cprev), *tail)
    return ys, saved, hprev, cprev


def _launch_bwd(dy, saved, hprev, cprev, mask, w, peep, reverse, acts):
    T, B, H4 = saved.shape
    H = H4 // 4
    dev = saved.device
    codes = _act_codes(acts)
    dy = _last_dim_contiguous(dy)
    check(dy, "dy", (T, B, H), dev, contiguous=False)
    check(saved, "acts", (T, B, H4), dev)
    check(hprev, "hprev", (T, B, H), dev)
    check(cprev, "cprev", (T, B, H), dev)
    dx4 = torch.empty((T, B, H4), device=dev)
    dw = torch.empty((H, H4), device=dev)
    dpeep = torch.empty((3, H), device=dev)
    wt = torch.empty((H4, H), device=dev)                 # scratch: w transposed
    part = torch.empty((max(B, 1), 3 * H), device=dev)    # scratch: per-tile peephole sums
    LSTM_BWD.launch(dev, ptr(dy), dy.stride(0), dy.stride(1),
                    ptr(saved), ptr(hprev), ptr(cprev),
                    ptr(mask), mask.stride(0), mask.stride(1), ptr(w), ptr(peep),
                    ptr(dx4), ptr(dw), ptr(dpeep), ptr(wt), ptr(part),
                    T, B, H, int(bool(reverse)), *codes)
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
    no gradient."""
    if x4.device.type == "cpu":
        return lstm_forward_reference(x4, mask, w, peep, reverse, acts)
    if torch.is_grad_enabled() and (x4.requires_grad or w.requires_grad or peep.requires_grad):
        _check_operands(x4, mask, w, peep, acts)
        return _FusedLSTM.apply(x4, mask.detach(), w, peep, bool(reverse), tuple(acts))
    return _launch_fwd(x4, mask, w, peep, reverse, acts, residuals=False)
