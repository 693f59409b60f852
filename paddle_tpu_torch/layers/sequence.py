"""Sequence layers of the ported slices: max and average (pooling),
seqlastins, expand.

Masked reductions and gathers on padded [B, T, D], as in the JAX package.
Nested (sub-sequence) inputs and ``output_max_index`` are not ported yet.
"""

from __future__ import annotations

from typing import List

import torch

from paddle_tpu_torch.graph.argument import Argument
from paddle_tpu_torch.layers.base import LayerContext, finalize_output, register_layer
from paddle_tpu_torch.proto import LayerConfig

Tensor = torch.Tensor


def _flat_seq(cfg: LayerConfig, a: Argument) -> None:
    if a.is_nested_seq or cfg.trans_type == "seq":
        raise NotImplementedError(
            f"{cfg.name}: nested sequences are not ported yet")
    if not a.is_seq:
        raise ValueError(f"{cfg.name}: input is not a sequence")


@register_layer("max")
def max_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    a = inputs[0]
    _flat_seq(cfg, a)
    if cfg.output_max_index:
        raise NotImplementedError(f"{cfg.name}: output_max_index is not ported yet")
    x = a.value                                            # [B, T, D]
    valid = a.seq_mask(x.dtype)[..., None] > 0
    # torch.amax, not torch.max(dim): like jnp.max it splits the gradient
    # evenly among tied maxima
    out = torch.amax(torch.where(valid, x, torch.full_like(x, torch.finfo(x.dtype).min)),
                     dim=1)
    out = torch.where(a.seq_lengths[:, None] > 0, out, torch.zeros_like(out))
    return Argument(value=finalize_output(cfg, out, ctx))


@register_layer("average")
def average_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    a = inputs[0]
    _flat_seq(cfg, a)
    mode = cfg.average_strategy or "average"
    x = a.value                                            # [B, T, D]
    s = torch.sum(x * a.seq_mask(x.dtype)[..., None], dim=1)
    n = torch.clamp(a.seq_lengths[:, None].to(x.dtype), min=1.0)
    if mode == "sum":
        out = s
    elif mode == "squarerootn":
        out = s / torch.sqrt(n)
    else:
        out = s / n
    return Argument(value=finalize_output(cfg, out, ctx))


@register_layer("seqlastins")
def seq_last_ins_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    # carries first_seq too: cfg.select_first picks the first instance
    a = inputs[0]
    _flat_seq(cfg, a)
    lengths = a.seq_lengths.long()
    idx = (torch.zeros_like(lengths) if cfg.select_first
           else torch.clamp(lengths - 1, min=0))
    rows = torch.arange(a.value.shape[0], device=idx.device)
    return Argument(value=finalize_output(cfg, a.value[rows, idx], ctx))


@register_layer("expand")
def expand_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    # broadcast a dense input along the sequence layout of the second input
    src, layout = inputs[0], inputs[1]
    if layout.is_nested_seq:
        raise NotImplementedError(f"{cfg.name}: nested expand is not ported yet")
    B, D = src.value.shape
    out = src.value[:, None, :].expand(B, layout.max_len, D)
    return Argument(value=out, seq_lengths=layout.seq_lengths)
