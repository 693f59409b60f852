"""Core layers: data, fc, mixed (table/fc/identity projections), concat.

Sequence inputs are padded [B, T, D] and the matmuls batch over B*T, as
in the JAX package. Projections and operators outside this slice raise
``NotImplementedError``.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from paddle_tpu_torch.graph.argument import Argument
from paddle_tpu_torch.layers.base import (
    LayerContext,
    finalize_output,
    first_seq_meta,
    input_mask,
    register_layer,
    with_seq_meta,
)
from paddle_tpu_torch.proto import LayerConfig, LayerInputConfig, ProjectionConfig

Tensor = torch.Tensor


@register_layer("data")
def data_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    if len(inputs) != 1:
        raise ValueError(f"data layer {cfg.name} not fed")
    a = inputs[0]
    if a.value is not None and cfg.size > 0 and a.value.shape[-1] != cfg.size:
        raise ValueError(
            f"data layer {cfg.name!r} declares size={cfg.size} but was fed "
            f"width {a.value.shape[-1]} (shape {tuple(a.value.shape)})")
    return a


@register_layer("fc")
def fc_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    acc: Optional[Tensor] = None
    for in_cfg, arg in zip(cfg.inputs, inputs):
        y = arg.value @ ctx.param(in_cfg.input_parameter_name)
        acc = y if acc is None else acc + y
    meta = first_seq_meta(inputs)
    return with_seq_meta(meta, finalize_output(cfg, acc, ctx, input_mask(meta)))


def apply_projection(p: ProjectionConfig, in_cfg: LayerInputConfig,
                     arg: Argument, ctx: LayerContext) -> Tensor:
    t = p.type
    pname = in_cfg.input_parameter_name
    if t == "identity":
        return arg.value
    if t == "table":
        table = ctx.param(pname)                           # [vocab, dim]
        return table[arg.ids.long()]
    if t == "fc":                                          # FullMatrixProjection
        return arg.value @ ctx.param(pname)
    raise NotImplementedError(f"projection type {t!r} is not ported yet")


@register_layer("mixed")
def mixed_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    if cfg.operator_confs:
        raise NotImplementedError(
            f"mixed layer {cfg.name!r}: operators are not ported yet")
    acc: Optional[Tensor] = None
    for in_cfg, arg in zip(cfg.inputs, inputs):
        if in_cfg.proj_conf is None:
            continue
        y = apply_projection(in_cfg.proj_conf, in_cfg, arg, ctx)
        acc = y if acc is None else acc + y
    meta = first_seq_meta(inputs)
    return with_seq_meta(meta, finalize_output(cfg, acc, ctx, input_mask(meta)))


@register_layer("concat")
def concat_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    out = torch.cat([a.value for a in inputs], dim=-1)
    meta = first_seq_meta(inputs)
    return with_seq_meta(meta, finalize_output(cfg, out, ctx, input_mask(meta)))
