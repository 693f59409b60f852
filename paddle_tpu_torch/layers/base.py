"""Layer forward framework.

A layer is a function ``(LayerConfig, [Argument], LayerContext) ->
Argument`` registered by the type string the config DSL emits, as in the
JAX package. This slice runs inference only: dropout and error clipping
act in training, so a forward here leaves them out (error clipping is the
identity in a forward pass) and a training pass raises.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import torch

from paddle_tpu_torch.graph.argument import Argument
from paddle_tpu_torch.ops.activations import apply_activation
from paddle_tpu_torch.proto import LayerConfig, ModelConfig
from paddle_tpu_torch.utils.error import layer_scope
from paddle_tpu_torch.utils.registry import Registry

Tensor = torch.Tensor

LayerFn = Callable[[LayerConfig, List[Argument], "LayerContext"], Argument]
layer_registry: Registry[LayerFn] = Registry("layer type")


def register_layer(*type_names: str):
    return layer_registry.register(*type_names)


@dataclass
class LayerContext:
    """Mutable context threaded through one network forward pass."""

    params: Dict[str, Tensor]
    model: ModelConfig
    pass_type: str = "test"                     # test | gen (train: later slice)
    outputs: Dict[str, Argument] = field(default_factory=dict)
    # enclosing scope for recurrent-group steps: group-ENTRY resolution
    # (static links, memory boot layers) may walk up this chain; ordinary
    # layer-input lookup deliberately cannot
    parent: Optional["LayerContext"] = None
    # generation-capture sink (graph/decode_step.py): when a dict is
    # supplied, a generator recurrent group stores its prepared decode
    # inputs (static-link Arguments, unexpanded memory boots) here and
    # skips the beam-search loop — the serving engine's prefill path
    gen_capture: Optional[Dict[str, Any]] = None

    def param(self, name: str) -> Tensor:
        try:
            return self.params[name]
        except KeyError:
            known = ", ".join(sorted(self.params))
            raise KeyError(f"parameter {name!r} not found (have: {known})") from None


def input_mask(arg: Argument) -> Optional[Tensor]:
    """[B, T] float validity mask if arg is a sequence, else None."""
    if arg.is_nested_seq:
        raise NotImplementedError("nested sequences are not ported yet")
    return arg.seq_mask() if arg.is_seq else None


def finalize_output(cfg: LayerConfig, value: Tensor, ctx: LayerContext,
                    mask: Optional[Tensor] = None) -> Tensor:
    """Shared bias + activation tail of a layer forward."""
    if cfg.bias_parameter_name:
        value = value + ctx.param(cfg.bias_parameter_name)
    return apply_activation(cfg.active_type, value, mask)


def forward_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    if ctx.pass_type == "train":
        raise NotImplementedError(
            "training is not ported yet: the train step, with dropout and "
            "the backward kernels, is the next slice of paddle_tpu_torch")
    fn = layer_registry.get(cfg.type)
    with layer_scope(f"{cfg.name}({cfg.type})"):
        out = fn(cfg, inputs, ctx)
    ctx.outputs[cfg.name] = out
    return out


def first_seq_meta(inputs: List[Argument]) -> Argument:
    """Propagate sequence metadata from the first sequence input."""
    for a in inputs:
        if a.is_seq or a.is_nested_seq:
            return a
    return inputs[0] if inputs else Argument()


def with_seq_meta(template: Argument, value: Tensor) -> Argument:
    return Argument(
        value=value,
        seq_lengths=template.seq_lengths,
        sub_seq_lengths=template.sub_seq_lengths,
    )
