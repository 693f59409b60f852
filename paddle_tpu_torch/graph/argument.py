"""Argument — the universal inter-layer value type.

The JAX package's layout, kept so that every parity comparison is
elementwise: a batch is a padded dense tensor plus a lengths vector, and
masking (not ragged indexing) removes the padding's influence.

Shapes:
- non-sequence:   value [B, D]            ids [B]
- sequence:       value [B, T, D]         ids [B, T]        seq_lengths [B]
- nested seq:     value [B, S, T, D]      ids [B, S, T]     sub_seq_lengths [B, S]

All fields are optional; a layer populates what it produces. A plain
dataclass takes the place of the JAX package's flax pytree.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from paddle_tpu_torch.device import DeviceLike

Tensor = torch.Tensor


@dataclasses.dataclass
class Argument:
    value: Optional[Tensor] = None
    ids: Optional[Tensor] = None
    seq_lengths: Optional[Tensor] = None       # int32 [B]
    sub_seq_lengths: Optional[Tensor] = None   # int32 [B, S]
    weight: Optional[Tensor] = None

    @property
    def is_seq(self) -> bool:
        return self.seq_lengths is not None

    @property
    def is_nested_seq(self) -> bool:
        return self.sub_seq_lengths is not None

    def _ref(self) -> Tensor:
        ref = self.value if self.value is not None else self.ids
        if ref is None:
            raise ValueError("empty Argument")
        return ref

    @property
    def batch_size(self) -> int:
        return self._ref().shape[0]

    @property
    def max_len(self) -> int:
        return self._ref().shape[1]

    def seq_mask(self, dtype=torch.float32) -> Tensor:
        """[B, T] mask of valid timesteps (1 inside the sequence)."""
        ref = self._ref()
        pos = torch.arange(ref.shape[1], device=ref.device)[None, :]
        return (pos < self.seq_lengths[:, None]).to(dtype)


def _tensor(x, dtype=None, device: DeviceLike = None) -> Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return torch.as_tensor(x, dtype=dtype, device=device)


def make_seq(value, lengths, ids=None, device: DeviceLike = None) -> Argument:
    return Argument(
        value=None if value is None else _tensor(value, device=device),
        ids=None if ids is None else _tensor(ids, torch.int32, device),
        seq_lengths=_tensor(lengths, torch.int32, device),
    )
