"""Cost layers: multi-class cross-entropy (with and without self
normalisation), square error, binary and soft binary cross-entropy, rank
cost, huber, the validation layers and classification_error.

Port of ``paddle_tpu/layers/cost.py``. A cost layer outputs the
per-sample cost [B, 1] (sequences: summed over the valid timesteps;
nested sequences: over every valid step of every sub-sequence),
scaled by ``coeff`` and the optional per-sample weight; the gradient
machine averages it over the batch into the loss.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from paddle_tpu_torch.graph.argument import Argument
from paddle_tpu_torch.layers.base import LayerContext, TimeMajorLogits, register_layer
from paddle_tpu_torch.ops.precision import hp
from paddle_tpu_torch.proto import LayerConfig

Tensor = torch.Tensor
_EPS = 1e-10


def _finish_cost(cfg: LayerConfig, per_step: Tensor, arg: Argument,
                 weight_arg: Optional[Argument]) -> Argument:
    """Reduce the per-step cost over time (masked) and apply coeff and weight."""
    if arg.is_nested_seq:
        cost = torch.sum(per_step * arg.sub_seq_mask(per_step.dtype), dim=(1, 2))
    elif arg.is_seq:
        cost = torch.sum(per_step * arg.seq_mask(per_step.dtype), dim=1)
    else:
        cost = per_step
    if weight_arg is not None and weight_arg.value is not None:
        cost = cost * weight_arg.value.reshape(cost.shape)
    return Argument(value=(cfg.coeff * cost)[:, None])


def _label_ids(label: Argument) -> Tensor:
    if label.ids is not None:
        return label.ids.long()
    return torch.argmax(label.value, dim=-1)


def _fused_softmax_ce(z: Tensor, ids: Tensor) -> Tensor:
    """-log softmax(z)[ids] from the logits, without the probabilities. The
    max is exact in any float dtype and exp runs in the logits' dtype; only
    the sum accumulates in (at least) float32, as the JAX package's does."""
    m = torch.amax(z, dim=-1, keepdim=True).detach()
    se = torch.sum(torch.exp(z - m), dim=-1, dtype=torch.promote_types(z.dtype, torch.float32))
    lse = hp(m[..., 0]) + torch.log(se)
    return lse - hp(torch.gather(z, -1, ids[..., None])[..., 0])


def _fused_or_plain_ce(z, out: Argument, ids: Tensor) -> Tensor:
    """Per-step CE: fused from the logits when the published view matches,
    else -log(p) from the probabilities. A hoisted recurrent out-link
    publishes TimeMajorLogits (flat [T*B, V]); the CE then runs in that
    layout and only the [T, B] per-step costs are transposed."""
    if isinstance(z, TimeMajorLogits):
        v = out.value
        if v.dim() == 3 and (z.T, z.B) == (v.shape[1], v.shape[0]) \
                and tuple(z.flat.shape) == (z.T * z.B, v.shape[2]):
            ids_flat = ids.transpose(0, 1).reshape(-1)              # [T*B]
            per_flat = _fused_softmax_ce(z.flat, ids_flat)
            return per_flat.reshape(z.T, z.B).transpose(0, 1)       # [B, T]
        z = None
    if z is not None and z.shape == out.value.shape:
        return _fused_softmax_ce(z, ids)
    p = torch.gather(hp(out.value), -1, ids[..., None])[..., 0]
    return -torch.log(torch.clamp(p, min=_EPS))


@register_layer("multi-class-cross-entropy")
def multi_class_cross_entropy(cfg: LayerConfig, inputs: List[Argument],
                              ctx: LayerContext) -> Argument:
    # inputs: [probabilities (post-softmax), label(, weight)]
    out, label = inputs[0], inputs[1]
    weight = inputs[2] if len(inputs) > 2 else None
    ids = _label_ids(label)
    z = (ctx.logits.get(cfg.inputs[0].input_layer_name)
         if not cfg.inputs[0].input_layer_argument else None)
    per_step = _fused_or_plain_ce(z, out, ids)
    return _finish_cost(cfg, per_step, out, weight)


@register_layer("multi_class_cross_entropy_with_selfnorm")
def selfnorm_cross_entropy(cfg: LayerConfig, inputs: List[Argument],
                           ctx: LayerContext) -> Argument:
    # CE on the unnormalised output plus alpha * log(Z)^2, which keeps Z near 1
    out, label = inputs[0], inputs[1]
    v = hp(out.value)
    z = torch.sum(v, dim=-1)
    p = torch.gather(v, -1, _label_ids(label)[..., None])[..., 0]
    per_step = -torch.log(torch.clamp(p / torch.clamp(z, min=_EPS), min=_EPS))
    per_step = per_step + cfg.softmax_selfnorm_alpha * torch.log(torch.clamp(z, min=_EPS)) ** 2
    return _finish_cost(cfg, per_step, out, None)


@register_layer("square_error")
def square_error(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    out, label = inputs[0], inputs[1]
    weight = inputs[2] if len(inputs) > 2 else None
    v = hp(out.value)
    target = hp(label.value) if label.value is not None else label.ids.to(v.dtype)
    if target.dim() < v.dim():
        target = target[..., None]
    return _finish_cost(cfg, torch.sum((v - target) ** 2, dim=-1), out, weight)


@register_layer("multi_binary_label_cross_entropy")
def multi_binary_label_cross_entropy(cfg: LayerConfig, inputs: List[Argument],
                                     ctx: LayerContext) -> Argument:
    out, label = inputs[0], inputs[1]
    p = torch.clamp(hp(out.value), _EPS, 1.0 - _EPS)
    y = hp(label.value)
    per_step = -torch.sum(y * torch.log(p) + (1.0 - y) * torch.log(1.0 - p), dim=-1)
    return _finish_cost(cfg, per_step, out, None)


@register_layer("soft_binary_class_cross_entropy")
def soft_binary_class_cross_entropy(cfg: LayerConfig, inputs: List[Argument],
                                    ctx: LayerContext) -> Argument:
    return multi_binary_label_cross_entropy(cfg, inputs, ctx)


@register_layer("rank-cost")
def rank_cost(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    # inputs: left score, right score, label (1 when left should rank
    # higher, 0.5 for a tie), optional weight
    left, right, label = inputs[0], inputs[1], inputs[2]
    weight = inputs[3] if len(inputs) > 3 else None
    o = (hp(left.value) - hp(right.value))[..., 0]
    t = label.value[..., 0] if label.value is not None else label.ids.to(o.dtype)
    per_step = torch.logaddexp(torch.zeros_like(o), o) - t * o
    return _finish_cost(cfg, per_step, left, weight)


@register_layer("huber")
def huber_two_class(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    # HuberTwoClass: labels {0, 1} -> y in {-1, +1}; a = y f is quadratic
    # in (-1, 1), linear below, zero from 1 on
    out, label = inputs[0], inputs[1]
    f = hp(out.value)[..., 0]
    a = (2.0 * _label_ids(label).to(f.dtype) - 1.0) * f
    per_step = torch.where(a < -1.0, -4.0 * a,
                           torch.where(a < 1.0, (1.0 - a) ** 2, torch.zeros_like(a)))
    return _finish_cost(cfg, per_step, out, None)


@register_layer("auc-validation", "pnpair-validation")
def validation_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    # metric-only nodes: zero cost, no gradient; the metric accumulates in
    # the evaluator the DSL registers beside them (trainer/evaluators.py)
    out = inputs[0]
    ref = out.value if out.value is not None else out.ids
    shape = ref.shape[:-1] if out.value is not None else ref.shape
    return _finish_cost(cfg, torch.zeros(shape, dtype=torch.float32, device=ref.device),
                        out, None)


@register_layer("classification_error")
def classification_error_layer(cfg: LayerConfig, inputs: List[Argument],
                               ctx: LayerContext) -> Argument:
    # 1.0 where argmax(output) != label
    out, label = inputs[0], inputs[1]
    err = (torch.argmax(out.value, dim=-1) != _label_ids(label)).to(
        torch.promote_types(out.value.dtype, torch.float32))
    return _finish_cost(cfg, err, out, inputs[2] if len(inputs) > 2 else None)
