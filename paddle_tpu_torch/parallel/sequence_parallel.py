"""Attention over [B, T, H, D] on one device.

Port of ``paddle_tpu/parallel/sequence_parallel.py::full_attention``. On
the card, self-attention shapes (no offsets, q and k of one shape) go to
the flash kernels of ``paddle_tpu_torch.ops.flash_attention`` (O(T)
activation memory), as the JAX package sends them to a flash kernel on a
TPU; everything else takes the plain path below, which materialises
[B, H, Tq, Tk] (the JAX package's XLA branch). The port's kernels take any
T and any head dim up to 256, so there is no ``supported()`` gate.
Ring and all-to-all attention wait for the distribution slice.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

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
    if q_offset == 0 and kv_offset == 0 and q.shape == k.shape and q.is_cuda:
        return flash_attention(q, k, v, lengths=lengths, causal=causal)
    D = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(D)
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
    return torch.einsum("bhqk,bkhd->bqhd", p, v)
