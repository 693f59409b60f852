"""Carry parameters across between numpy and the port's tensors.

Parameter names and shapes are the JAX package's (the same DSL builds the
same config), so a dict of numpy arrays moves either way unchanged.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from paddle_tpu_torch.device import DeviceLike, resolve_device


def params_from_numpy(params: Dict[str, np.ndarray],
                      device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    return {name: torch.from_numpy(np.array(v, dtype=np.float32)).to(dev)
            for name, v in params.items()}


def params_to_numpy(params: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {name: v.detach().cpu().numpy() for name, v in params.items()}
