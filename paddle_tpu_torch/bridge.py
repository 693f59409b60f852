"""Carry parameters and optimizer state across between numpy and the
port's tensors.

Parameter names and shapes are the JAX package's (the same DSL builds the
same config), so a dict of numpy arrays moves either way unchanged. The
optimizer state travels as the JAX package's ``UpdaterState`` fields
(step, num_samples, slots, avg_sum, avg_count, avg_old_sum,
avg_old_count): a dict of numpy arrays and numbers, or any object with
those attributes (the JAX ``UpdaterState`` itself).
"""

from __future__ import annotations

from typing import Any, Dict

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


def opt_state_from_numpy(state: Any, device: DeviceLike = None):
    """The port's :class:`~paddle_tpu_torch.optimizer.UpdaterState` from
    numpy (or array-like) fields; tensors land on ``device``, float32 but
    for an integer slot (``t_last``), which keeps its dtype."""
    from paddle_tpu_torch.optimizer.updater import UpdaterState

    get = state.get if isinstance(state, dict) else (lambda k: getattr(state, k, None))
    dev = resolve_device(device)

    def leaf(v):
        a = np.asarray(v)
        # an integer slot (a sparse table's t_last, int32) keeps its dtype
        return torch.from_numpy(np.array(a if a.dtype.kind in "iu" else a.astype(np.float32))
                                ).to(dev)

    def tree(d):
        if d is None:
            return None
        return {k: tree(v) if isinstance(v, dict) else leaf(v) for k, v in d.items()}

    old_count = get("avg_old_count")
    return UpdaterState(
        step=int(np.asarray(get("step"))),
        num_samples=float(np.asarray(get("num_samples"))),
        slots=tree(get("slots")),
        avg_sum=tree(get("avg_sum")),
        avg_count=float(np.asarray(get("avg_count"))),
        avg_old_sum=tree(get("avg_old_sum")),
        avg_old_count=None if old_count is None else float(np.asarray(old_count)),
    )


def opt_state_to_numpy(state) -> Dict[str, Any]:
    """A dict of the state's fields: tensors as numpy arrays, counters as
    numpy scalars of the JAX package's dtypes (int32 step, float32 rest)."""

    def tree(d):
        if d is None:
            return None
        return {k: tree(v) if isinstance(v, dict) else v.detach().cpu().numpy()
                for k, v in d.items()}

    return {
        "step": np.int32(state.step),
        "num_samples": np.float32(state.num_samples),
        "slots": tree(state.slots),
        "avg_sum": tree(state.avg_sum),
        "avg_count": np.float32(state.avg_count),
        "avg_old_sum": tree(state.avg_old_sum),
        "avg_old_count": None if state.avg_old_count is None else np.float32(state.avg_old_count),
    }
