"""Mixed-precision helpers shared across layers and activations.

Port of ``paddle_tpu/ops/precision.py``. The float32-island rule: loss
math, softmax internals, batch-norm statistics and the CRF/CTC recursions
run in at least float32 even when activations are bf16
(``LayerContext.compute_dtype``). :func:`hp` is the single upcast point,
so the promotion policy lives in one place.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def hp(x: Tensor) -> Tensor:
    """Upcast half-precision values to float32; float32 and float64 pass."""
    hi = torch.promote_types(x.dtype, torch.float32)
    return x.to(hi) if hi != x.dtype else x


def round_to(x: Tensor, dtype: torch.dtype) -> Tensor:
    """``x`` rounded to ``dtype`` and widened back to x's own type (to the
    nearest, ties to even, as ``astype`` rounds): the value a kernel holds
    after it stores ``x`` in a narrower operand type and loads it again.
    The identity where ``dtype`` is x's type or wider."""
    if torch.finfo(dtype).bits >= torch.finfo(x.dtype).bits:
        return x
    return x.to(dtype).to(x.dtype)


def bf16_pieces(x: Tensor, n: int) -> Tensor:
    """float32 ``x`` as the sum of its first ``n`` bf16 pieces: hi = bf16(x),
    lo = bf16(x - hi) (x - hi is exact in float32, so hi + lo keeps ~16
    significant bits). n = 0 leaves x whole. What a kernel that multiplies x
    on the bf16 tensor cores in n pieces multiplies."""
    if not n:
        return x
    hi = x.to(torch.bfloat16).float()
    return hi if n == 1 else hi + (x - hi).to(torch.bfloat16).float()
