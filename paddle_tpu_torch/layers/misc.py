"""Elementwise layers of this slice: scaling."""

from __future__ import annotations

from typing import List

from paddle_tpu_torch.graph.argument import Argument
from paddle_tpu_torch.layers.base import LayerContext, register_layer, with_seq_meta
from paddle_tpu_torch.proto import LayerConfig


@register_layer("scaling")
def scaling_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    # out = w * x ; w is [B, 1] (or [B, T, 1] per step) scale
    w, x = inputs[0].value, inputs[1].value
    return with_seq_meta(inputs[1], w * x)
