"""The masked GRU over a whole sequence: CUDA kernels 1-3 and their plain versions.

Port of ``paddle_tpu/ops/pallas_gru.py::fused_gru``: the inference forward
(``_fwd_kernel_light`` -> ``csrc/gru_fwd.cu::gru_fwd``), the training
forward that also saves the residuals (``_fwd_kernel`` ->
``gru_fwd_train``) and its backward (``_bwd_kernel`` ->
``csrc/gru_bwd.cu::gru_bwd``). Cell semantics are exactly
``gru_cell_step``: the weight [H, 3H] is split [update, reset | candidate],
the bias is folded into x3 beforehand, and h' = u * h + (1 - u) * c.
Padded steps pass the carry through, so a reversed sequence stays at
h0 = 0 until it starts.

:func:`fused_gru` launches the kernels for a CUDA tensor and raises on
anything they do not take: the training pair when grad mode is on and an
input requires a gradient (a ``torch.autograd.Function``), the light
forward otherwise. For a CPU tensor it runs :func:`gru_forward_reference`,
and autograd through it gives the gradients.
"""

from __future__ import annotations

from typing import Tuple

import torch

from paddle_tpu_torch.ops._build import I32, I64, PTR, CudaKernel, check, ptr
from paddle_tpu_torch.ops.activations import apply_activation

Tensor = torch.Tensor
KERNEL_ACTS = ("tanh", "sigmoid")

_FWD_ARGS = [PTR, I64, I64,          # x3, its time and batch strides
             PTR, I64, I64,          # mask
             PTR,                    # w
             PTR, I64, I64]          # ys
GRU_FWD = CudaKernel("gru_fwd.cu", "gru_fwd", _FWD_ARGS + [I32, I32, I32, I32])  # T, B, H, reverse
GRU_FWD_TRAIN = CudaKernel(
    "gru_fwd.cu", "gru_fwd_train",
    _FWD_ARGS + [PTR, PTR,           # acts, hprev
                 I32, I32, I32, I32])
GRU_BWD = CudaKernel(
    "gru_bwd.cu", "gru_bwd",
    [PTR, I64, I64,                  # dy, its time and batch strides
     PTR, PTR,                       # acts, hprev
     PTR, I64, I64,                  # mask
     PTR, PTR, PTR,                  # w, dx3, dw
     I32, I32, I32, I32],            # T, B, H, reverse
)
KERNELS = (GRU_FWD, GRU_FWD_TRAIN, GRU_BWD)


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


def gru_forward_reference(x3: Tensor, mask: Tensor, w: Tensor, reverse: bool = False,
                          acts: Tuple[str, str] = KERNEL_ACTS, residuals: bool = False):
    """Plain PyTorch version of the kernels: x3 [T, B, 3H], mask [T, B],
    w [H, 3H] -> ys [T, B, H], with ys[t] = 0 at padded steps.

    ``residuals=True`` also returns what ``gru_fwd_train`` saves, each at
    its step's own time index: acts = [u | r | c] [T, B, 3H] and h_prev
    [T, B, H]."""
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


def _check_operands(x3, mask, w, acts):
    T, B, H3 = x3.shape
    H = H3 // 3
    dev = x3.device
    if tuple(acts) != KERNEL_ACTS:
        raise ValueError(f"gru_fwd takes activations {KERNEL_ACTS}, got {tuple(acts)}")
    if H3 != 3 * H:
        raise ValueError(f"x3 width {H3} is not 3 * H")
    check(x3, "x3", (T, B, H3), dev, contiguous=False)
    check(mask, "mask", (T, B), dev, contiguous=False)
    check(w, "w", (H, H3), dev)
    return T, B, H, dev


def _launch_fwd(x3, mask, w, reverse, acts, residuals):
    T, B, H, dev = _check_operands(x3, mask, w, acts)
    ys = torch.empty((B, T, H), device=dev).transpose(0, 1)
    args = [ptr(x3), x3.stride(0), x3.stride(1),
            ptr(mask), mask.stride(0), mask.stride(1),
            ptr(w), ptr(ys), ys.stride(0), ys.stride(1)]
    if not residuals:
        GRU_FWD.launch(dev, *args, T, B, H, int(bool(reverse)))
        return ys
    saved = torch.empty((T, B, 3 * H), device=dev)
    hprev = torch.empty((T, B, H), device=dev)
    GRU_FWD_TRAIN.launch(dev, *args, ptr(saved), ptr(hprev), T, B, H, int(bool(reverse)))
    return ys, saved, hprev


def _last_dim_contiguous(t: Tensor) -> Tensor:
    """Autograd may hand a gradient in any layout; the kernels read the
    outer dimensions through strides but need the last one contiguous."""
    return t if t.dim() == 0 or t.shape[-1] <= 1 or t.stride(-1) == 1 else t.contiguous()


def _launch_bwd(dy, saved, hprev, mask, w, reverse):
    T, B, H3 = saved.shape
    H = H3 // 3
    dev = saved.device
    dy = _last_dim_contiguous(dy)
    check(dy, "dy", (T, B, H), dev, contiguous=False)
    check(saved, "acts", (T, B, H3), dev)
    check(hprev, "hprev", (T, B, H), dev)
    dx3 = torch.empty((T, B, H3), device=dev)
    dw = torch.empty((H, H3), device=dev)
    GRU_BWD.launch(dev, ptr(dy), dy.stride(0), dy.stride(1), ptr(saved), ptr(hprev),
                   ptr(mask), mask.stride(0), mask.stride(1), ptr(w), ptr(dx3), ptr(dw),
                   T, B, H, int(bool(reverse)))
    return dx3, dw


class _FusedGRU(torch.autograd.Function):
    """The training pair on the card: gru_fwd_train, then gru_bwd."""

    @staticmethod
    def forward(ctx, x3, mask, w, reverse, acts):
        ys, saved, hprev = _launch_fwd(x3, mask, w, reverse, acts, residuals=True)
        ctx.save_for_backward(saved, hprev, mask, w)
        ctx.reverse = reverse
        return ys

    @staticmethod
    def backward(ctx, dy):
        saved, hprev, mask, w = ctx.saved_tensors
        dx3, dw = _launch_bwd(dy, saved, hprev, mask, w, ctx.reverse)
        return dx3, None, dw, None, None


def fused_gru(x3: Tensor, mask: Tensor, w: Tensor, reverse: bool = False,
              acts: Tuple[str, str] = KERNEL_ACTS) -> Tensor:
    """Masked GRU over the sequence: x3 [T, B, 3H] (bias folded in, any
    time/batch strides), mask [T, B], w [H, 3H] -> ys [T, B, H].

    On the card ys is a time-major view of batch-major storage, so
    ``ys.transpose(0, 1)`` is a contiguous [B, T, H] tensor. The mask gets
    no gradient."""
    if x3.device.type == "cpu":
        return gru_forward_reference(x3, mask, w, reverse, acts)
    if torch.is_grad_enabled() and (x3.requires_grad or w.requires_grad):
        _check_operands(x3, mask, w, acts)
        return _FusedGRU.apply(x3, mask.detach(), w, bool(reverse), tuple(acts))
    return _launch_fwd(x3, mask, w, reverse, acts, residuals=False)
