"""The masked GRU over a whole sequence: CUDA kernel 1 and its plain version.

Port of ``paddle_tpu/ops/pallas_gru.py::fused_gru`` (inference forward,
``_fwd_kernel_light``). Cell semantics are exactly ``gru_cell_step``: the
weight [H, 3H] is split [update, reset | candidate], the bias is folded into
x3 beforehand, and h' = u * h + (1 - u) * c. Padded steps pass the carry
through, so a reversed sequence stays at h0 = 0 until it starts.

:func:`fused_gru` launches ``csrc/gru_fwd.cu`` for a CUDA tensor and raises
on anything that kernel does not take; for a CPU tensor it runs
:func:`gru_forward_reference`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from paddle_tpu_torch.ops._build import I32, I64, PTR, CudaKernel, check, ptr
from paddle_tpu_torch.ops.activations import apply_activation

Tensor = torch.Tensor
KERNEL_ACTS = ("tanh", "sigmoid")

GRU_FWD = CudaKernel(
    "gru_fwd.cu", "gru_fwd",
    [PTR, I64, I64,          # x3, its time and batch strides
     PTR, I64, I64,          # mask
     PTR,                    # w
     PTR, I64, I64,          # ys
     I32, I32, I32, I32],    # T, B, H, reverse
)


def gru_cell(x3: Tensor, h: Tensor, w: Tensor,
             acts: Tuple[str, str] = KERNEL_ACTS) -> Tensor:
    """One GRU step: x3 [B, 3H] (biases folded in), h [B, H], w [H, 3H]."""
    H = h.shape[-1]
    act_in, act_gate = acts
    g = apply_activation(act_gate, x3[..., : 2 * H] + h @ w[:, : 2 * H])
    u, r = g[..., :H], g[..., H:]
    c = apply_activation(act_in, x3[..., 2 * H:] + (r * h) @ w[:, 2 * H:])
    return u * h + (1.0 - u) * c


def gru_forward_reference(x3: Tensor, mask: Tensor, w: Tensor, reverse: bool = False,
                          acts: Tuple[str, str] = KERNEL_ACTS) -> Tensor:
    """Plain PyTorch version of the kernel: x3 [T, B, 3H], mask [T, B],
    w [H, 3H] -> ys [T, B, H], with ys[t] = 0 at padded steps."""
    T, B, H3 = x3.shape
    h = x3.new_zeros(B, H3 // 3)
    ys = x3.new_empty(T, B, H3 // 3)
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        h_new = gru_cell(x3[t], h, w, acts)
        m = mask[t][:, None]
        ys[t] = m * h_new
        h = m * h_new + (1.0 - m) * h
    return ys


def fused_gru(x3: Tensor, mask: Tensor, w: Tensor, reverse: bool = False,
              acts: Tuple[str, str] = KERNEL_ACTS) -> Tensor:
    """Masked GRU over the sequence: x3 [T, B, 3H] (bias folded in, any
    time/batch strides), mask [T, B], w [H, 3H] -> ys [T, B, H].

    On the card ys is a time-major view of batch-major storage, so
    ``ys.transpose(0, 1)`` is a contiguous [B, T, H] tensor."""
    if x3.device.type == "cpu":
        return gru_forward_reference(x3, mask, w, reverse, acts)
    T, B, H3 = x3.shape
    H = H3 // 3
    dev = x3.device
    if tuple(acts) != KERNEL_ACTS:
        raise ValueError(f"gru_fwd takes activations {KERNEL_ACTS}, got {tuple(acts)}")
    if H3 != 3 * H:
        raise ValueError(f"x3 width {H3} is not 3 * H")
    check(x3, "x3", (T, B, H3), dev, contiguous=False)
    check(mask, "mask", (T, B), dev)
    check(w, "w", (H, H3), dev)
    ys = torch.empty((B, T, H), device=dev).transpose(0, 1)
    GRU_FWD.launch(
        dev,
        ptr(x3), x3.stride(0), x3.stride(1),
        ptr(mask), mask.stride(0), mask.stride(1),
        ptr(w),
        ptr(ys), ys.stride(0), ys.stride(1),
        T, B, H, int(bool(reverse)),
    )
    return ys
