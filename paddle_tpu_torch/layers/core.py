"""Core layers: data, fc, mixed (projections and operators), concat,
concat2, addto, tensor, prelu, maxid, eos_id, trans, get_output,
sampling_id.

Sequence inputs are padded [B, T, D] and the matmuls batch over B*T, as
in the JAX package; a projection applies as well to a time-major stacked
[T, B, D] input (the recurrent group's prologue).
"""

from __future__ import annotations

import dataclasses
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
    # under mixed precision float FEATURES enter the graph in the compute
    # dtype; pure cost inputs (targets, labels, weights) stay float32
    if a.value is not None and cfg.name not in ctx.no_cast_inputs:
        cast = ctx.cast_compute(a.value)
        if cast is not a.value:
            a = dataclasses.replace(a, value=cast)
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
        if ctx.table_overrides is not None:
            ov = ctx.table_overrides.get((pname, in_cfg.input_layer_name))
            if ov is not None:                             # prefetched rows
                return ctx.cast_compute(ov)
        # gather from the master-dtype table, THEN cast: casting the whole
        # [V, D] table each step would be a pass over the full vocabulary
        table = ctx.param(pname, cast=False)               # [vocab, dim]
        return ctx.cast_compute(table[arg.ids.long()])
    if t == "fc":                                          # FullMatrixProjection
        return arg.value @ ctx.param(pname)
    if t == "trans_fc":                                    # TransposedFullMatrixProjection
        return arg.value @ ctx.param(pname).t()
    if t == "identity_offset":
        return arg.value[..., p.offset:p.offset + p.output_size]
    if t == "dot_mul":
        return arg.value * ctx.param(pname)
    if t == "context":
        return _context_projection(p, arg, ctx.param(pname) if pname else None)
    raise NotImplementedError(f"projection type {t!r}")


def _context_projection(p: ProjectionConfig, arg: Argument, w: Optional[Tensor]) -> Tensor:
    """Sliding-window concat of neighbouring timesteps (ContextProjection).

    For offset o in [context_start, context_start + context_length), step t
    takes input[t + o]; an offset outside the sequence reads zeros, or with
    trainable padding w [|start| + max(0, start + len - 1), D] a pad row
    keyed by how far the position lies outside (before the start: rows
    [0, begin_pad); past the end: rows from begin_pad on). Rows past each
    sequence's length come out zero."""
    x = arg.value                                          # [B, T, D]
    B, T, _ = x.shape
    lengths = (arg.seq_lengths.long() if arg.seq_lengths is not None
               else torch.full((B,), T, dtype=torch.long, device=x.device))
    t_idx = torch.arange(T, device=x.device)
    begin_pad = max(0, -p.context_start)
    zero = x.new_zeros(())
    cols = []
    for k in range(p.context_length):
        off = p.context_start + k
        pos = t_idx[None, :] + off                         # [1, T]
        valid = (pos >= 0) & (pos < lengths[:, None])      # [B, T]
        col = torch.where(valid[..., None], torch.roll(x, -off, dims=1), zero)
        if w is not None and off < 0:
            # the pad row of the position, not of the offset
            rows = w[torch.clamp(begin_pad + pos[0], 0, begin_pad - 1)]       # [T, D]
            col = torch.where((pos < 0)[..., None], rows[None], col)
        elif w is not None and off > 0:
            over = pos - lengths[:, None]                  # [B, T] steps past the end
            rows = w[begin_pad + torch.clamp(over, 0, w.shape[0] - begin_pad - 1)]
            col = torch.where((over >= 0)[..., None], rows, col)
        cols.append(col)
    out = torch.cat(cols, dim=-1)
    return torch.where((t_idx[None, :] < lengths[:, None])[..., None], out, zero)


def _operator(op, op_ins: List[Argument]) -> Tensor:
    if op.type == "dot_mul":
        return op.dotmul_scale * op_ins[0].value * op_ins[1].value
    if op.type == "conv":
        from paddle_tpu_torch.layers.vision import conv_operator_forward

        return conv_operator_forward(op, op_ins)
    raise NotImplementedError(f"operator type {op.type!r}")


@register_layer("mixed")
def mixed_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
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
    for op in cfg.operator_confs:
        y = _operator(op, [inputs[i] for i in op.input_indices])
        acc = y if acc is None else acc + y
    meta = first_seq_meta(inputs)
    return with_seq_meta(meta, finalize_output(cfg, acc, ctx, input_mask(meta)))


@register_layer("concat2")
def concat2_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    # ConcatenateLayer2: each input passes through its own projection and
    # the projections' outputs are concatenated (mixed sums them)
    parts = []
    for in_cfg, arg in zip(cfg.inputs, inputs):
        if in_cfg.proj_conf is None:
            raise ValueError(f"concat2 {cfg.name}: input needs a projection")
        parts.append(apply_projection(in_cfg.proj_conf, in_cfg, arg, ctx))
    meta = first_seq_meta(inputs)
    return with_seq_meta(meta, finalize_output(cfg, torch.cat(parts, dim=-1), ctx,
                                               input_mask(meta)))


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


@register_layer("tensor")
def tensor_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    # out[..., k] = sum_ij x_i W^k_ij y_j; the parameter is stored flat as
    # [in1, size * in2] (the reference's layout) or as [size, in1, in2]
    x, y = inputs[0].value, inputs[1].value
    w = ctx.param(cfg.inputs[0].input_parameter_name)
    if w.dim() == 2:
        w = w.reshape(x.shape[-1], cfg.size, y.shape[-1]).transpose(0, 1)
    out = torch.einsum("...i,kij,...j->...k", x, w, y)
    meta = first_seq_meta(inputs)
    return with_seq_meta(meta, finalize_output(cfg, out, ctx, input_mask(meta)))


@register_layer("prelu")
def prelu_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    # ParameterReluLayer: one leaky slope per partition of partial_sum units
    x = inputs[0].value
    w = ctx.param(cfg.inputs[0].input_parameter_name).reshape(-1)
    slope = torch.repeat_interleave(w, cfg.partial_sum)
    return with_seq_meta(first_seq_meta(inputs), torch.where(x > 0, x, x * slope))


@register_layer("maxid")
def maxid_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    # argmax over the features (the lowest index among ties) and its value
    a = inputs[0]
    return Argument(ids=torch.argmax(a.value, dim=-1).int(),
                    value=torch.amax(a.value, dim=-1, keepdim=True),
                    seq_lengths=a.seq_lengths, sub_seq_lengths=a.sub_seq_lengths)


@register_layer("eos_id")
def eos_id_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    # 1.0 where the input id is eos_id
    a = inputs[0]
    out = (a.ids == cfg.eos_id).to(torch.float32)[..., None]
    return Argument(value=out, seq_lengths=a.seq_lengths, sub_seq_lengths=a.sub_seq_lengths)


@register_layer("trans")
def trans_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    # the transpose of the [batch, feature] matrix
    return Argument(value=inputs[0].value.t())


@register_layer("get_output")
def get_output_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    # the network already looked up the named output (input_layer_argument)
    return inputs[0]


@register_layer("sampling_id")
def sampling_id_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    # one id a row drawn from the row's distribution, with the layer's own
    # generator (LayerContext.layer_generator)
    a = inputs[0]
    p = torch.clamp(a.value, min=1e-20)
    gen = ctx.layer_generator(cfg.name, "sample", p.device)
    ids = torch.multinomial(p.reshape(-1, p.shape[-1]), 1, generator=gen)
    return Argument(ids=ids.reshape(p.shape[:-1]).int(), seq_lengths=a.seq_lengths,
                    sub_seq_lengths=a.sub_seq_lengths)
