"""Cost layers of this slice: multi-class cross-entropy.

Port of ``paddle_tpu/layers/cost.py``. A cost layer outputs the
per-sample cost [B, 1] (sequences: summed over the valid timesteps),
scaled by ``coeff`` and the optional per-sample weight; the gradient
machine averages it over the batch into the loss.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from paddle_tpu_torch.graph.argument import Argument
from paddle_tpu_torch.layers.base import LayerContext, TimeMajorLogits, register_layer
from paddle_tpu_torch.proto import LayerConfig

Tensor = torch.Tensor
_EPS = 1e-10


def _finish_cost(cfg: LayerConfig, per_step: Tensor, arg: Argument,
                 weight_arg: Optional[Argument]) -> Argument:
    """Reduce the per-step cost over time (masked) and apply coeff and weight."""
    if arg.is_nested_seq:
        raise NotImplementedError("costs over nested sequences are not ported yet")
    if arg.is_seq:
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
    """-log softmax(z)[ids] from the logits, without the probabilities."""
    m = torch.amax(z, dim=-1, keepdim=True).detach()
    lse = m[..., 0] + torch.log(torch.sum(torch.exp(z - m), dim=-1))
    return lse - torch.gather(z, -1, ids[..., None])[..., 0]


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
    p = torch.gather(out.value, -1, ids[..., None])[..., 0]
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
