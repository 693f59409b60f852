"""The 1x1 stride-1 convolution with the batch-norm statistics of its output:
CUDA kernel 9 and its plain version.

Port of ``paddle_tpu/ops/pallas_conv1x1_bn.py::conv1x1_stats``: y = x·wᵀ + b
over the [M, K] pixel rows of an NHWC activation, with the per-channel sum
s and sum of squares q of y, so that a downstream batch norm in a training
pass takes its statistics from the conv and does not read y again. The
forward is ``csrc/conv1x1_bn.cu::conv1x1_stats`` (the Pallas ``_kernel``);
the backward is the JAX package's ``_bwd``, plain XLA there and two
``torch.matmul`` here, on y saved by the forward:

    g = dy + ds + 2·y·dq,   dx = g·w,   dw = gᵀ·x,   db = Σ_m g

w is the conv parameter as stored, [N, K] (OIHW flattened), where the JAX
function takes its transpose [K, N].

:func:`conv1x1_stats` checks its operands on every device: float32, x
contiguous [M, K], w contiguous [N, K], b absent or [N]; it raises on
anything else and never copies. It launches the kernel for a CUDA tensor
and runs :func:`conv1x1_stats_reference` for a CPU tensor; under autograd
both go through the same backward.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from paddle_tpu_torch.ops._build import I32, PTR, CudaKernel, check, ptr

Tensor = torch.Tensor

CONV1X1_STATS = CudaKernel(
    "conv1x1_bn.cu", "conv1x1_stats",
    [PTR, PTR, PTR,                  # x, w, b (null: no bias)
     PTR, PTR, PTR,                  # y, s, q
     PTR, PTR,                       # scratch: per-block partial sums, w's TF32 halves
     I32, I32, I32, I32])            # M, K, N, vec
KERNELS = (CONV1X1_STATS,)
TILE_M = 128                         # rows of y per tile: at most one partial row per tile
TILE_K = 32                          # the kernel pads w's halves to a multiple of this
MAX_M = 65535 * TILE_M


def conv1x1_stats_reference(x: Tensor, w: Tensor, b: Optional[Tensor] = None):
    """Plain PyTorch version: x [M, K], w [N, K], b [N] or None ->
    (y [M, N], s [N], q [N]) with s and q the column sums of y and y²."""
    y = x @ w.t()
    if b is not None:
        y = y + b
    return y, y.sum(0), (y * y).sum(0)


def _check_operands(x: Tensor, w: Tensor, b: Optional[Tensor]) -> Tuple[int, int, int]:
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError(f"conv1x1_stats takes x [M, K] and w [N, K], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    (M, K), N = x.shape, w.shape[0]
    dev = x.device
    check(x, "x", (M, K), dev)
    check(w, "w", (N, K), dev)
    if b is not None:
        check(b, "b", (N,), dev)
    if min(M, K, N) == 0 or M > MAX_M:
        raise ValueError(f"conv1x1_stats takes 1 <= M <= {MAX_M} and K, N >= 1, "
                         f"got M={M}, K={K}, N={N}")
    return M, K, N


def _launch(x: Tensor, w: Tensor, b: Optional[Tensor], M: int, K: int, N: int):
    dev = x.device
    y = torch.empty((M, N), device=dev)
    s = torch.empty((N,), device=dev)
    q = torch.empty((N,), device=dev)
    part = torch.empty((-(-M // TILE_M), 2, N), device=dev)
    wsplit = torch.empty((2, N, -(-K // TILE_K) * TILE_K), device=dev)
    vec = int(K % 4 == 0 and ptr(x) % 16 == 0)       # TMA reads x; else 4-byte copies
    CONV1X1_STATS.launch(dev, ptr(x), ptr(w), None if b is None else ptr(b),
                         ptr(y), ptr(s), ptr(q), ptr(part), ptr(wsplit), M, K, N, vec)
    return y, s, q


def _forward(x: Tensor, w: Tensor, b: Optional[Tensor]):
    M, K, N = _check_operands(x, w, b)
    if x.device.type == "cpu":
        return conv1x1_stats_reference(x, w, b)
    return _launch(x, w, b, M, K, N)


class _Conv1x1Stats(torch.autograd.Function):
    """Kernel 9 (or the plain version on the CPU) forward; the JAX ``_bwd``."""

    @staticmethod
    def forward(ctx, x, w, b):
        y, s, q = _forward(x, w, b)
        ctx.save_for_backward(x, w, y)
        ctx.has_bias = b is not None
        return y, s, q

    @staticmethod
    def backward(ctx, dy, ds, dq):
        x, w, y = ctx.saved_tensors
        g = dy + ds[None, :] + 2.0 * y * dq[None, :]
        dx = g @ w if ctx.needs_input_grad[0] else None
        dw = g.t() @ x if ctx.needs_input_grad[1] else None
        db = g.sum(0) if ctx.has_bias and ctx.needs_input_grad[2] else None
        return dx, dw, db


def conv1x1_stats(x: Tensor, w: Tensor, b: Optional[Tensor] = None):
    """y = x·wᵀ + b with s = Σ_m y and q = Σ_m y²: x [M, K] float32 rows
    (contiguous), w [N, K], b [N] or None -> (y [M, N], s [N], q [N])."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, w, b)):
        return _Conv1x1Stats.apply(x, w, b)
    return _forward(x, w, b)
