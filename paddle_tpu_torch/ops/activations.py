"""Activation functions, registered by the names the config DSL emits.

Every activation of the JAX package, each a plain PyTorch function
(autograd gives the backward). ``sequence_softmax`` normalizes over the
*time* axis of a padded sequence using the validity mask, as the JAX
package's does.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from paddle_tpu_torch.ops.precision import hp
from paddle_tpu_torch.utils.registry import Registry

Tensor = torch.Tensor

# activation(value, mask) -> value. mask is [B, T] (or None for non-seq).
activation_registry: Registry[Callable] = Registry("activation")


def identity(x: Tensor) -> Tensor:
    return x


# strictly elementwise activations: they commute with any layout
# permutation, so the vision layers may apply them to the NHWC view
ELEMENTWISE_ACTS = set()


def is_elementwise(name: str) -> bool:
    return name in ELEMENTWISE_ACTS


def stanh(x: Tensor) -> Tensor:
    # scaled tanh, 1.7159 * tanh(2/3 x) (LeCun), the reference's STanh
    return 1.7159 * torch.tanh((2.0 / 3.0) * x)


def brelu(x: Tensor) -> Tensor:
    # bounded relu: clipped to [0, 24], the reference's BRelu bound
    return torch.clamp(x, 0.0, 24.0)


def softrelu(x: Tensor) -> Tensor:
    # log(1 + e^x) with the reference's +-40 input clamp
    return torch.log1p(torch.exp(torch.clamp(x, -40.0, 40.0)))


for _name, _fn in (("", identity), ("linear", identity),
                   ("sigmoid", torch.sigmoid), ("tanh", torch.tanh),
                   ("stanh", stanh), ("relu", torch.relu), ("brelu", brelu),
                   ("softrelu", softrelu), ("abs", torch.abs),
                   ("square", lambda x: x * x), ("exponential", torch.exp)):
    activation_registry.register_obj(_name, lambda x, mask=None, _f=_fn: _f(x))
    ELEMENTWISE_ACTS.add(_name)


def softmax(x: Tensor, mask: Optional[Tensor] = None) -> Tensor:
    """Feature-axis softmax (last dim): the exp and the sum run in float32
    even for bf16 activations (a mixed-precision island), and the result
    returns in x's dtype."""
    return torch.softmax(hp(x), dim=-1).to(x.dtype)


activation_registry.register_obj("softmax", softmax)


def sequence_softmax(x: Tensor, mask: Optional[Tensor] = None) -> Tensor:
    """Softmax across the timesteps of each sequence.

    x: [B, T, 1] (or [B, T]) scores; mask: [B, T] validity. Padded steps
    get probability 0."""
    squeeze = x.dim() == 3
    s = hp(x[..., 0] if squeeze else x)              # float32 island
    if mask is not None:
        s = torch.where(mask > 0, s, torch.full_like(s, -torch.inf))
    out = torch.softmax(s, dim=-1)
    if mask is not None:
        out = torch.where(mask > 0, out, torch.zeros_like(out))
    out = out.to(x.dtype)
    return out[..., None] if squeeze else out


activation_registry.register_obj("sequence_softmax", sequence_softmax)


def apply_activation(name: str, x: Tensor, mask: Optional[Tensor] = None) -> Tensor:
    return activation_registry.get(name)(x, mask)
