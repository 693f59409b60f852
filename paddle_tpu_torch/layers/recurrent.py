"""GRU layers: gated_recurrent (the whole sequence) and gru_step (one step).

Layout contract (from config_parser GatedRecurrentLayer): the input is
the 3*size x-projection, the weight [size, 3*size] is split
[update, reset | candidate], and the bias is 3*size.

``gated_recurrent`` always goes through :func:`~paddle_tpu_torch.ops.
fused_gru.fused_gru`: on the card that launches the GRU kernels (the
training forward and backward when a gradient is wanted, the light forward
otherwise; the ``settings(pallas_rnn=...)`` switch is a TPU choice and
chooses nothing here), on the CPU it runs the kernels' plain version and
autograd through it gives the gradients.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from paddle_tpu_torch.graph.argument import Argument
from paddle_tpu_torch.layers.base import LayerContext, register_layer
from paddle_tpu_torch.ops.fused_gru import fused_gru, gru_cell
from paddle_tpu_torch.proto import LayerConfig

Tensor = torch.Tensor


def _acts(cfg: LayerConfig):
    return (cfg.active_type or "tanh", cfg.active_gate_type or "sigmoid")


def gru_cell_step(cfg: LayerConfig, x3: Tensor, h_prev: Tensor, w: Tensor,
                  bias: Optional[Tensor]) -> Tensor:
    """x3 [B, 3*size] x-projection, w [size, 3*size], bias [3*size] or None."""
    if bias is not None:
        x3 = x3 + bias
    return gru_cell(x3, h_prev, w, _acts(cfg))


def _weights(cfg: LayerConfig, ctx: LayerContext):
    size = cfg.size
    w = ctx.param(cfg.inputs[0].input_parameter_name).reshape(size, 3 * size)
    bias = (ctx.param(cfg.bias_parameter_name).reshape(-1)
            if cfg.bias_parameter_name else None)
    return w, bias


@register_layer("gated_recurrent")
def gated_recurrent_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    a = inputs[0]
    w, bias = _weights(cfg, ctx)
    x = a.value if bias is None else a.value + bias             # [B, T, 3H]
    T = x.shape[1]
    pos = torch.arange(T, device=x.device)[:, None]
    mask = (pos < a.seq_lengths[None, :]).to(x.dtype)           # [T, B]
    ys = fused_gru(x.transpose(0, 1), mask, w, reverse=cfg.reversed,
                   acts=_acts(cfg))
    return Argument(value=ys.transpose(0, 1), seq_lengths=a.seq_lengths)


@register_layer("gru_step")
def gru_step_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    # inputs: [x-projection 3*size, previous output]
    w, bias = _weights(cfg, ctx)
    h = gru_cell_step(cfg, inputs[0].value, inputs[1].value, w, bias)
    return Argument(value=h, seq_lengths=inputs[0].seq_lengths)
