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

Operand types (``OPERAND_DTYPES``): x, w and b float32 or bf16, all of one
type, each type with its own instance of the kernel. The bf16 contract is
the Pallas kernel's: the product accumulates in float32 over the bf16
operands, b is added widened, y is rounded to bf16 and stored, and s and q
are float32 sums over the rounded y. The backward rounds g = g32 to y's
type for the two products (which accumulate in float32 and round to x's
and w's type), and db sums g32 unrounded.

:func:`conv1x1_stats` checks its operands on every device: float32 or
bf16, one type, x contiguous [M, K], w contiguous [N, K], b absent or
[N], and M, K, N at least 1; it raises on anything else and never
copies. For a CPU tensor it runs :func:`conv1x1_stats_reference`, which
takes any such shape; for a CUDA tensor it launches the kernel, and raises
on a shape that :func:`supported` refuses. Under autograd both go through the same
backward. The conv layer asks :func:`supported` before any launch and
runs the plain conv and batch norm for a shape it refuses, counted in
``EAGER_ROUTES``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from paddle_tpu_torch.ops import kernel_flops
from paddle_tpu_torch.ops._build import I32, PTR, CudaKernel, card_sms, check, ptr
from paddle_tpu_torch.ops.fused_gru import OPERAND_DTYPES

Tensor = torch.Tensor

CONV1X1_STATS = CudaKernel(
    "conv1x1_bn.cu", "conv1x1_stats",
    [PTR, PTR, PTR,                  # x, w, b (null: no bias)
     PTR, PTR, PTR,                  # y, s, q
     PTR, PTR,                       # scratch: per-block partial sums, w's TF32 halves
     I32, I32, I32, I32])            # M, K, N, vec
# the bf16 instance: x and w read as they are (no split, no scratch copy of w)
CONV1X1_STATS_BF16 = CudaKernel(
    "conv1x1_bn.cu", "conv1x1_stats_bf16",
    [PTR, PTR, PTR, PTR, PTR, PTR,   # x, w, b; y, s, q
     PTR,                            # scratch: per-block partial sums
     I32, I32, I32, I32])            # M, K, N, vec
KERNELS = (CONV1X1_STATS, CONV1X1_STATS_BF16)
TILE_M = 128                         # rows of y per tile
TILE_K = 32                          # the kernel pads w's halves to a multiple of this
# What csrc/conv1x1_bn.cu takes. M, K and N are ints there: the row tiles
# (M + 127) / 128, so M + 127 within the int range; K padded to Kp, a
# multiple of 32. Each block counts the stages it consumes (its row tiles
# times ceil(K / 32)) in an int, every row tile in one block at worst.
# The column tiles of 128 are the grid's y dimension (at most 65535). The
# tensor maps' outer strides (bytes) stay below 2^40: w's halves are
# [2][N][Kp] floats. M's limit is the int range; what bounded it before
# (65535 row tiles, a grid dimension) went with PR 7's persistent blocks.
# The bf16 instance takes every shape these limits admit: its stages hold
# 64 features (fewer stages a block), its tensor maps' strides are x's and
# w's rows (2K bytes), and its grid is the float32 one.
INT_MAX = 2 ** 31 - 1
MAX_M = INT_MAX - (TILE_M - 1)
MAX_K = INT_MAX - (TILE_K - 1)
MAX_N = 65535 * 128
MAX_STAGES = INT_MAX - 8             # the stage counter plus the ring's look-ahead
# layer calls that ran the plain conv and batch norm because supported() refused
EAGER_ROUTES = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def supported(M: int, K: int, N: int) -> bool:
    """Whether kernel 9 takes x [M, K] and w [N, K] on the card (the limits
    above, for both instances); the plain version takes any M, K, N >= 1."""
    if not (1 <= M <= MAX_M and 1 <= K <= MAX_K and 1 <= N <= MAX_N):
        return False
    Kp = _cdiv(K, TILE_K) * TILE_K
    return _cdiv(M, TILE_M) * (Kp // TILE_K) <= MAX_STAGES and 4 * N * Kp < 2 ** 40


def _acc(t: Tensor) -> torch.dtype:
    return torch.promote_types(t.dtype, torch.float32)


def conv1x1_stats_reference(x: Tensor, w: Tensor, b: Optional[Tensor] = None):
    """Plain PyTorch version: x [M, K], w [N, K], b [N] or None ->
    (y [M, N] in x's dtype, s [N], q [N] in at least float32) with s and q
    the column sums of the stored y and y². The product and the bias in at
    least float32, y rounded once."""
    acc = _acc(x)
    y32 = x.to(acc) @ w.to(acc).t()
    if b is not None:
        y32 = y32 + b.to(acc)
    y = y32.to(x.dtype)
    yf = y.to(acc)
    return y, yf.sum(0), (yf * yf).sum(0)


def _check_operands(x: Tensor, w: Tensor, b: Optional[Tensor]) -> Tuple[int, int, int]:
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError(f"conv1x1_stats takes x [M, K] and w [N, K], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    (M, K), N = x.shape, w.shape[0]
    dev, od = x.device, x.dtype
    if od not in OPERAND_DTYPES:
        raise ValueError(f"conv1x1_stats takes float32 or bf16 x, w and b; got {od}")
    check(x, "x", (M, K), dev, dtype=od)
    check(w, "w", (N, K), dev, dtype=od)
    if b is not None:
        check(b, "b", (N,), dev, dtype=od)
    if min(M, K, N) == 0:
        raise ValueError(f"conv1x1_stats takes M, K, N >= 1, got M={M}, K={K}, N={N}")
    return M, K, N


def _launch(x: Tensor, w: Tensor, b: Optional[Tensor], M: int, K: int, N: int):
    if not supported(M, K, N):
        raise ValueError(f"kernel 9 does not take M={M}, K={K}, N={N} "
                         f"(fused_conv1x1_bn.supported: M <= {MAX_M}, N <= {MAX_N}, ...)")
    dev = x.device
    y = torch.empty((M, N), device=dev, dtype=x.dtype)
    s = torch.empty((N,), device=dev)
    q = torch.empty((N,), device=dev)
    # one partial row per persistent block: at most one per row tile and per SM
    part = torch.empty((min(_cdiv(M, TILE_M), card_sms(dev)), 2, N), device=dev)
    bias = None if b is None else ptr(b)
    kernel_flops.record(kernel_flops.conv1x1_flops(M, K, N))
    if x.dtype == torch.bfloat16:
        # TMA reads x and w (rows of 16-byte multiples); else warp 0 copies them
        vec = int(K % 8 == 0 and ptr(x) % 16 == 0 and ptr(w) % 16 == 0)
        CONV1X1_STATS_BF16.launch(dev, ptr(x), ptr(w), bias, ptr(y), ptr(s), ptr(q),
                                  ptr(part), M, K, N, vec)
        return y, s, q
    wsplit = torch.empty((2, N, _cdiv(K, TILE_K) * TILE_K), device=dev)
    vec = int(K % 4 == 0 and ptr(x) % 16 == 0)       # TMA reads x; else 4-byte copies
    CONV1X1_STATS.launch(dev, ptr(x), ptr(w), bias, ptr(y), ptr(s), ptr(q), ptr(part),
                         ptr(wsplit), M, K, N, vec)
    return y, s, q


def _forward(x: Tensor, w: Tensor, b: Optional[Tensor]):
    M, K, N = _check_operands(x, w, b)
    if x.device.type == "cpu":
        return conv1x1_stats_reference(x, w, b)
    return _launch(x, w, b, M, K, N)


class _Conv1x1Stats(torch.autograd.Function):
    """Kernel 9 (or the plain version on the CPU) forward; the JAX ``_bwd``:
    g32 = dy + ds + 2·y·dq in at least float32, g = g32 rounded to y's
    dtype for the products, db = Σ g32."""

    @staticmethod
    def forward(ctx, x, w, b):
        y, s, q = _forward(x, w, b)
        ctx.save_for_backward(x, w, y)
        ctx.has_bias = b is not None
        return y, s, q

    @staticmethod
    def backward(ctx, dy, ds, dq):
        x, w, y = ctx.saved_tensors
        acc = _acc(y)
        g32 = dy.to(acc) + ds[None, :].to(acc) + 2.0 * y.to(acc) * dq[None, :].to(acc)
        # in bf16 the products take bf16 g, w and x and accumulate in float32
        # (reduced-precision reduction off, device.resolve_device), rounding once
        g = g32.to(y.dtype)
        dx = g @ w if ctx.needs_input_grad[0] else None
        dw = g.t() @ x if ctx.needs_input_grad[1] else None
        db = g32.sum(0).to(x.dtype) if ctx.has_bias and ctx.needs_input_grad[2] else None
        return dx, dw, db


def conv1x1_stats(x: Tensor, w: Tensor, b: Optional[Tensor] = None):
    """y = x·wᵀ + b with s = Σ_m y and q = Σ_m y²: x [M, K] float32 or bf16
    rows (contiguous), w [N, K] and b [N] or None of x's dtype -> (y [M, N]
    in x's dtype, s [N], q [N] float32)."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, w, b)):
        return _Conv1x1Stats.apply(x, w, b)
    return _forward(x, w, b)
