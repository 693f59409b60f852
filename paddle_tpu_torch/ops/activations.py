"""Activation functions, registered by the names the config DSL emits.

This slice ports the five the seqToseq serve graph uses. ``sequence_softmax``
normalizes over the *time* axis of a padded sequence using the validity
mask, as the JAX package's does.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from paddle_tpu_torch.utils.registry import Registry

Tensor = torch.Tensor

# activation(value, mask) -> value. mask is [B, T] (or None for non-seq).
activation_registry: Registry[Callable] = Registry("activation")


def identity(x: Tensor) -> Tensor:
    return x


for _name, _fn in (("", identity), ("linear", identity),
                   ("sigmoid", torch.sigmoid), ("tanh", torch.tanh)):
    activation_registry.register_obj(_name, lambda x, mask=None, _f=_fn: _f(x))


def softmax(x: Tensor, mask: Optional[Tensor] = None) -> Tensor:
    """Feature-axis softmax (last dim)."""
    return torch.softmax(x, dim=-1)


activation_registry.register_obj("softmax", softmax)


def sequence_softmax(x: Tensor, mask: Optional[Tensor] = None) -> Tensor:
    """Softmax across the timesteps of each sequence.

    x: [B, T, 1] (or [B, T]) scores; mask: [B, T] validity. Padded steps
    get probability 0."""
    squeeze = x.dim() == 3
    s = x[..., 0] if squeeze else x
    if mask is not None:
        s = torch.where(mask > 0, s, torch.full_like(s, -torch.inf))
    out = torch.softmax(s, dim=-1)
    if mask is not None:
        out = torch.where(mask > 0, out, torch.zeros_like(out))
    return out[..., None] if squeeze else out


activation_registry.register_obj("sequence_softmax", sequence_softmax)


def apply_activation(name: str, x: Tensor, mask: Optional[Tensor] = None) -> Tensor:
    return activation_registry.get(name)(x, mask)
