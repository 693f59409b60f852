"""Sequence layers: max and average (pooling), seqlastins and
seqfirstins, expand, seqconcat, seqreshape, subseq.

Masked reductions and gathers on padded [B, T, D], as in the JAX package.
A layer that changes T or the valid lengths (seqconcat, seqreshape,
subseq) gives zero rows past each new length. Nested (sub-sequence)
inputs are ROADMAP Queue 1 item 5.
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
            f"{cfg.name}: nested sequences are not ported yet (ROADMAP Queue 1 item 5)")
    if not a.is_seq:
        raise ValueError(f"{cfg.name}: input is not a sequence")


@register_layer("max")
def max_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    a = inputs[0]
    _flat_seq(cfg, a)
    x = a.value                                            # [B, T, D]
    valid = a.seq_mask(x.dtype)[..., None] > 0
    masked = torch.where(valid, x, torch.full_like(x, torch.finfo(x.dtype).min))
    if cfg.output_max_index:
        # the step of each feature's maximum (the first among ties)
        return Argument(ids=torch.argmax(masked, dim=1).int())
    # torch.amax, not torch.max(dim): like jnp.max it splits the gradient
    # evenly among tied maxima
    out = torch.amax(masked, dim=1)
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


def _select_instance(cfg: LayerConfig, a: Argument, first: bool) -> Tensor:
    _flat_seq(cfg, a)
    lengths = a.seq_lengths.long()
    idx = torch.zeros_like(lengths) if first else torch.clamp(lengths - 1, min=0)
    rows = torch.arange(a.value.shape[0], device=idx.device)
    return a.value[rows, idx]


@register_layer("seqlastins")
def seq_last_ins_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    # carries first_seq too: cfg.select_first picks the first instance
    out = _select_instance(cfg, inputs[0], first=cfg.select_first)
    return Argument(value=finalize_output(cfg, out, ctx))


@register_layer("seqfirstins")
def seq_first_ins_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    out = _select_instance(cfg, inputs[0], first=True)
    return Argument(value=finalize_output(cfg, out, ctx))


@register_layer("expand")
def expand_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    # broadcast a dense input along the sequence layout of the second input
    src, layout = inputs[0], inputs[1]
    if layout.is_nested_seq:
        raise NotImplementedError(
            f"{cfg.name}: nested expand is not ported yet (ROADMAP Queue 1 item 5)")
    B, D = src.value.shape
    out = src.value[:, None, :].expand(B, layout.max_len, D)
    return Argument(value=out, seq_lengths=layout.seq_lengths)


def _zero_past(value: Tensor, lengths: Tensor) -> Tensor:
    """value [B, T, D] with the rows at or past each length set to zero."""
    pos = torch.arange(value.shape[1], device=value.device)
    valid = pos[None, :] < lengths[:, None]
    return torch.where(valid[..., None], value, value.new_zeros(()))


@register_layer("seqconcat")
def seq_concat_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    # each sample's b placed after its a's valid steps
    a, b = inputs[0], inputs[1]
    Ta, Tb = a.max_len, b.max_len
    la, lb = a.seq_lengths.long(), b.seq_lengths.long()
    pos = torch.arange(Ta + Tb, device=a.value.device)[None, :]      # [1, T]
    idx_a = torch.clamp(pos, max=Ta - 1).expand(a.value.shape[0], -1)
    idx_b = torch.clamp(pos - la[:, None], 0, Tb - 1)
    D = a.value.shape[-1]
    ga = torch.gather(a.value, 1, idx_a[..., None].expand(-1, -1, D))
    gb = torch.gather(b.value, 1, idx_b[..., None].expand(-1, -1, D))
    out = torch.where((pos < la[:, None])[..., None], ga, gb)
    lengths = (la + lb).int()
    return Argument(value=_zero_past(finalize_output(cfg, _zero_past(out, lengths), ctx),
                                     lengths), seq_lengths=lengths)


@register_layer("seqreshape")
def seq_reshape_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    # [B, T, D] read as [B, T*D/size, size]; each length scales by D/size
    a = inputs[0]
    B, T, D = a.value.shape
    out = a.value.reshape(B, T * D // cfg.size, cfg.size)
    lengths = torch.div(a.seq_lengths * D, cfg.size, rounding_mode="floor").int()
    return Argument(value=_zero_past(finalize_output(cfg, out, ctx), lengths),
                    seq_lengths=lengths)


def _ids_of(arg: Argument) -> Tensor:
    return (arg.ids if arg.ids is not None else arg.value[..., 0]).long().reshape(-1)


@register_layer("subseq")
def sub_seq_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    # inputs (sequence, offsets, sizes): each sequence's steps
    # [offset, offset + size)
    a, o, s = inputs[0], _ids_of(inputs[1]), _ids_of(inputs[2])
    T, D = a.max_len, a.value.shape[-1]
    pos = torch.arange(T, device=a.value.device)[None, :]
    idx = torch.clamp(pos + o[:, None], 0, T - 1)
    out = torch.gather(a.value, 1, idx[..., None].expand(-1, -1, D))
    lengths = s.int()
    return Argument(value=_zero_past(finalize_output(cfg, _zero_past(out, lengths), ctx),
                                     lengths), seq_lengths=lengths)
