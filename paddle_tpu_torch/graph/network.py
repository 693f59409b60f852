"""Network — topological execution of a layer graph.

A ``recurrent_layer_group`` layer in the parent list hands off to the
recurrent-group executor (:mod:`paddle_tpu_torch.graph.recurrent_group`).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from paddle_tpu_torch.graph.argument import Argument
from paddle_tpu_torch.layers.base import LayerContext, forward_layer
from paddle_tpu_torch.proto import LayerConfig, ModelConfig, SubModelConfig


class Network:
    """Executable view of (a sub-model of) a ModelConfig."""

    def __init__(self, model: ModelConfig, submodel: Optional[SubModelConfig] = None):
        self.model = model
        self.layer_map: Dict[str, LayerConfig] = {l.name: l for l in model.layers}
        self.submodel_map: Dict[str, SubModelConfig] = {s.name: s for s in model.sub_models}
        if submodel is None and model.sub_models:
            submodel = self.submodel_map.get("root")
        self.submodel = submodel
        if submodel is not None:
            names = list(submodel.layer_names)
            if submodel.name == "root":
                # multi_nn: plain non-recurrent sub-models are independent
                # sub-networks, executed after the root's layers
                for s in model.sub_models:
                    if s.name != "root" and not s.is_recurrent_layer_group:
                        names.extend(n for n in s.layer_names if n not in names)
            self.input_layer_names = list(submodel.input_layer_names)
            self.output_layer_names = list(submodel.output_layer_names)
        else:
            names = [l.name for l in model.layers]
            self.input_layer_names = list(model.input_layer_names)
            self.output_layer_names = list(model.output_layer_names)
        self.layers: List[LayerConfig] = [self.layer_map[n] for n in names]

    def forward(self, ctx: LayerContext, in_args: Dict[str, Argument]) -> Dict[str, Argument]:
        """Run all layers; returns ctx.outputs (every layer's output)."""
        for cfg in self.layers:
            if cfg.name in ctx.outputs:
                continue
            if cfg.type == "data":
                if cfg.name not in in_args:
                    raise KeyError(f"no data fed for input layer {cfg.name!r}")
                forward_layer(cfg, [in_args[cfg.name]], ctx)
            elif cfg.type == "recurrent_layer_group":
                from paddle_tpu_torch.graph.recurrent_group import forward_recurrent_group

                forward_recurrent_group(self, cfg, ctx)
            else:
                ins = [self._lookup_input(ctx, ic.input_layer_name, ic.input_layer_argument)
                       for ic in cfg.inputs]
                forward_layer(cfg, ins, ctx)
        return ctx.outputs

    def _lookup_input(self, ctx: LayerContext, name: str, arg_name: str = "") -> Argument:
        if not name:
            return Argument()  # parameter-only input slot
        key = f"{name}@{arg_name}" if arg_name else name
        if key not in ctx.outputs:
            raise KeyError(
                f"layer output {key!r} not available; computed: {sorted(ctx.outputs)}")
        return ctx.outputs[key]
