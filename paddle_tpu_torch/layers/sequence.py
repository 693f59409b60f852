"""Sequence layers: max and average (pooling), seqlastins and
seqfirstins, expand, seqconcat, seqreshape, subseq.

Masked reductions and gathers on padded [B, T, D], as in the JAX package.
A layer that changes T or the valid lengths (seqconcat, seqreshape,
subseq) gives zero rows past each new length.

``trans_type`` ("non-seq" | "seq") is the reference's pooling level
(AggregateLevel), as in the JAX package: "non-seq" (the default)
aggregates the whole outer sequence, so a nested [B, S, T, D] input gives
one row per sample over every valid token; "seq" aggregates each
sub-sequence of a nested input, giving a plain sequence over its S
sub-sequences.
"""

from __future__ import annotations

from typing import List

import torch

from paddle_tpu_torch.graph.argument import Argument
from paddle_tpu_torch.layers.base import LayerContext, finalize_output, register_layer
from paddle_tpu_torch.proto import LayerConfig

Tensor = torch.Tensor


def _pool_view(cfg: LayerConfig, a: Argument):
    """(x, mask, dims, lengths, seq_lengths of the output) of a pooling at
    the configured ``trans_type`` level (see the module docstring)."""
    if cfg.trans_type == "seq":
        if not a.is_nested_seq:
            raise ValueError(f"{cfg.name}: trans_type='seq' needs a nested (sub-sequence) "
                             "input (reference: 'input must hasSubseq')")
        return a.value, a.sub_seq_mask(a.value.dtype), 2, a.sub_seq_lengths, a.seq_lengths
    if a.is_nested_seq:
        # one row per sample over every valid token of every sub-sequence
        return (a.value, a.sub_seq_mask(a.value.dtype), (1, 2),
                torch.sum(a.sub_seq_lengths, dim=1), None)
    if not a.is_seq:
        raise ValueError(f"{cfg.name}: pooling a non-sequence input")
    return a.value, a.seq_mask(a.value.dtype), 1, a.seq_lengths, None


@register_layer("max")
def max_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    a = inputs[0]
    x, mask, dims, lengths, out_lengths = _pool_view(cfg, a)
    masked = torch.where(mask[..., None] > 0, x, torch.full_like(x, torch.finfo(x.dtype).min))
    if cfg.output_max_index:
        if a.is_nested_seq and cfg.trans_type != "seq":
            raise NotImplementedError(
                f"{cfg.name}: output_max_index over a whole nested sequence "
                "(trans_type='non-seq') is unsupported — use trans_type='seq' "
                "for per-subsequence indices")
        # the step of each feature's maximum (the first among ties)
        return Argument(ids=torch.argmax(masked, dim=dims).int(), seq_lengths=out_lengths)
    # torch.amax, not torch.max(dim): like jnp.max it splits the gradient
    # evenly among tied maxima
    out = torch.amax(masked, dim=dims)
    out = torch.where(lengths[..., None] > 0, out, torch.zeros_like(out))
    return Argument(value=finalize_output(cfg, out, ctx), seq_lengths=out_lengths)


@register_layer("average")
def average_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    mode = cfg.average_strategy or "average"
    x, mask, dims, lengths, out_lengths = _pool_view(cfg, inputs[0])
    s = torch.sum(x * mask[..., None], dim=dims)
    n = torch.clamp(lengths[..., None].to(x.dtype), min=1.0)
    if mode == "sum":
        out = s
    elif mode == "squarerootn":
        out = s / torch.sqrt(n)
    else:
        out = s / n
    return Argument(value=finalize_output(cfg, out, ctx), seq_lengths=out_lengths)


def _pick(x: Tensor, idx: Tensor) -> Tensor:
    """x [N, T, ...] at step idx [N] of each row."""
    return x[torch.arange(x.shape[0], device=idx.device), idx]


def _select_instance(cfg: LayerConfig, a: Argument, first: bool) -> Argument:
    """The first or last instance at the configured ``trans_type`` level."""
    if cfg.trans_type == "seq":
        if not a.is_nested_seq:
            raise ValueError(f"{cfg.name}: trans_type='seq' needs a nested (sub-sequence) "
                             "input (reference: 'input must hasSubseq')")
        B, S = a.sub_seq_lengths.shape
        lengths = a.sub_seq_lengths.long().reshape(-1)
        idx = torch.zeros_like(lengths) if first else torch.clamp(lengths - 1, min=0)
        rows = a.value.reshape((B * S,) + tuple(a.value.shape[2:]))
        return Argument(value=_pick(rows, idx).reshape((B, S) + tuple(a.value.shape[3:])),
                        seq_lengths=a.seq_lengths)
    if a.is_nested_seq:
        # the first token of the first non-empty sub-sequence, or the last
        # token of the last non-empty one (an empty one holds only padding)
        B, S = a.sub_seq_lengths.shape
        s_iota = torch.arange(S, device=a.value.device)[None, :]
        n_subs = a.seq_lengths[:, None] if a.seq_lengths is not None else S
        valid = (s_iota < n_subs) & (a.sub_seq_lengths > 0)
        if first:
            s_idx = torch.amin(torch.where(valid, s_iota, S), dim=1)
        else:
            s_idx = torch.amax(torch.where(valid, s_iota, -1), dim=1)
        s_idx = torch.clamp(s_idx, 0, S - 1)
        sub_len = _pick(a.sub_seq_lengths, s_idx).long()
        t_idx = torch.zeros_like(sub_len) if first else torch.clamp(sub_len - 1, min=0)
        return Argument(value=_pick(_pick(a.value, s_idx), t_idx))
    if not a.is_seq:
        raise ValueError(f"{cfg.name}: input is not a sequence")
    lengths = a.seq_lengths.long()
    idx = torch.zeros_like(lengths) if first else torch.clamp(lengths - 1, min=0)
    return Argument(value=_pick(a.value, idx))


@register_layer("seqlastins")
def seq_last_ins_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    # carries first_seq too: cfg.select_first picks the first instance
    out = _select_instance(cfg, inputs[0], first=cfg.select_first)
    return Argument(value=finalize_output(cfg, out.value, ctx), seq_lengths=out.seq_lengths)


@register_layer("seqfirstins")
def seq_first_ins_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    out = _select_instance(cfg, inputs[0], first=True)
    return Argument(value=finalize_output(cfg, out.value, ctx), seq_lengths=out.seq_lengths)


@register_layer("expand")
def expand_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    # broadcast the first input along the sequence layout of the second: a
    # dense row over every step, or a sequence over sub-sequences over each
    # sub-sequence's steps
    src, layout = inputs[0], inputs[1]
    D = src.value.shape[-1]
    if layout.is_nested_seq and src.is_seq:
        B, S, T = layout._ref().shape[:3]
        return Argument(value=src.value[:, :, None, :].expand(B, S, T, D),
                        seq_lengths=layout.seq_lengths,
                        sub_seq_lengths=layout.sub_seq_lengths)
    B = src.value.shape[0]
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
