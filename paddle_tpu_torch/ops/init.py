"""Parameter initialization strategies (the JAX package's semantics).

``initial_strategy`` 0 = normal(mean, std), 1 = uniform(mean ± std);
``initial_smart`` = normal with std 1/sqrt(fan_in). The draws come from an
explicit ``torch.Generator``, so they differ from the JAX package's bits
for the same seed: parity tests carry the JAX parameters across with
:mod:`paddle_tpu_torch.bridge` instead.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from paddle_tpu_torch.proto import ParameterConfig


def param_shape(cfg: ParameterConfig) -> Tuple[int, ...]:
    if cfg.dims:
        return tuple(int(d) for d in cfg.dims)
    return (int(cfg.size),)


def init_parameter(gen: torch.Generator, cfg: ParameterConfig,
                   dtype=torch.float32, device=None) -> torch.Tensor:
    shape = param_shape(cfg)
    if cfg.initial_smart and len(shape) >= 2:
        std = 1.0 / math.sqrt(float(shape[0]))
        return std * torch.randn(shape, generator=gen, dtype=dtype, device=device)
    if cfg.initial_strategy == 1:
        lo = cfg.initial_mean - cfg.initial_std
        out = torch.rand(shape, generator=gen, dtype=dtype, device=device)
        return lo + (2.0 * cfg.initial_std) * out
    if cfg.initial_std == 0.0:
        return torch.full(shape, float(cfg.initial_mean), dtype=dtype, device=device)
    return cfg.initial_mean + cfg.initial_std * torch.randn(
        shape, generator=gen, dtype=dtype, device=device)
