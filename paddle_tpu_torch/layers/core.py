"""Core layers: data, fc, mixed (table/fc/identity projections), addto, concat.

Sequence inputs are padded [B, T, D] and the matmuls batch over B*T, as
in the JAX package; a projection applies as well to a time-major stacked
[T, B, D] input (the recurrent group's prologue). Projections and
operators outside this slice raise ``NotImplementedError``.
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
from paddle_tpu_torch.ops.activations import apply_activation, is_elementwise
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
    # inside a recurrent-group step, projections of plain scan inputs may
    # have been hoisted before the loop: the sum then starts from the
    # precomputed slice and skips those inputs
    pro = ctx.mixed_prologue.get(cfg.name) if ctx.mixed_prologue else None
    skip_idx = frozenset(pro[0]) if pro else frozenset()
    acc: Optional[Tensor] = pro[1] if pro else None
    for i, (in_cfg, arg) in enumerate(zip(cfg.inputs, inputs)):
        if in_cfg.proj_conf is None or i in skip_idx:
            continue
        y = apply_projection(in_cfg.proj_conf, in_cfg, arg, ctx)
        acc = y if acc is None else acc + y
    meta = first_seq_meta(inputs)
    return with_seq_meta(meta, finalize_output(cfg, acc, ctx, input_mask(meta)))


@register_layer("addto")
def addto_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    # NHWC fast path: a residual junction between conv-family layers (the
    # ResNet shortcut) stays in the published layout (LayerContext.nhwc)
    from paddle_tpu_torch.layers.vision import _publish_nhwc

    nh = [ctx.nhwc.get(ic.input_layer_name) for ic in cfg.inputs]
    if (all(x is not None for x in nh)
            and len({tuple(x.shape) for x in nh}) == 1
            and not cfg.bias_parameter_name
            and cfg.drop_rate == 0.0
            and is_elementwise(cfg.active_type)):
        acc = nh[0]
        for x in nh[1:]:
            acc = acc + x
        return _publish_nhwc(ctx, cfg, apply_activation(cfg.active_type, acc))
    acc = inputs[0].value
    for a in inputs[1:]:
        acc = acc + a.value
    meta = first_seq_meta(inputs)
    return with_seq_meta(meta, finalize_output(cfg, acc, ctx, input_mask(meta)))


@register_layer("concat")
def concat_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    out = torch.cat([a.value for a in inputs], dim=-1)
    meta = first_seq_meta(inputs)
    return with_seq_meta(meta, finalize_output(cfg, out, ctx, input_mask(meta)))
