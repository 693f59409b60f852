"""Attention over [B, T, H, D] on one device.

Port of ``paddle_tpu/parallel/sequence_parallel.py::full_attention``. On
the card, self-attention shapes (no offsets, q and k of one shape) that
``flash_attention.supported`` accepts (head dim 1..256, B and H up to
65535) go to the flash kernels of ``paddle_tpu_torch.ops.flash_attention``
(O(T) activation memory), as the JAX package sends the shapes its
``supported()`` accepts to a flash kernel on a TPU; everything else takes
the eager path below, which materialises [B, H, Tq, Tk] (the JAX package's
XLA branch) and is counted in ``flash_attention.EAGER_ROUTES``. Ring and
all-to-all attention wait for the distribution slice.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops.flash_attention import flash_attention

Tensor = torch.Tensor

_NEG = -1e30  # big-negative instead of -inf: keeps fully-masked rows NaN-free


def full_attention(q: Tensor, k: Tensor, v: Tensor, lengths: Optional[Tensor] = None,
                   causal: bool = False, q_offset: int = 0, kv_offset: int = 0) -> Tensor:
    """Single-device attention over [B, T, H, D] tensors.

    Outputs at padded query rows (positions >= lengths) are unspecified
    and differ between the flash and plain paths (a row of length 0 gives
    zeros on the flash path, the mean of v on the plain one): callers must
    mask them (the mha layer does)."""
    if (q_offset == 0 and kv_offset == 0 and q.shape == k.shape and q.is_cuda
            and fa.supported(*q.shape)):
        return flash_attention(q, k, v, lengths=lengths, causal=causal)
    fa.EAGER_ROUTES += 1
    D = q.shape[-1]
    # scores, softmax and the PV product in at least float32 (bf16 products
    # are exact there, as the JAX package's preferred_element_type), out
    # rounded once to q's dtype
    acc = torch.promote_types(q.dtype, torch.float32)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)) / math.sqrt(D)
    Tq, Tk = q.shape[1], k.shape[1]
    q_pos = q_offset + torch.arange(Tq, device=q.device)
    kv_pos = kv_offset + torch.arange(Tk, device=q.device)
    mask = torch.ones((Tq, Tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kv_pos[None, :] <= q_pos[:, None]
    mask = mask.expand(q.shape[0], 1, Tq, Tk)
    if lengths is not None:
        mask = mask & (kv_pos[None, None, None, :] < lengths.long()[:, None, None, None])
    s = torch.where(mask, s, torch.full_like(s, _NEG))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.to(acc)).to(q.dtype)
