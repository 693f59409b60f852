"""GradientMachine — parameters + forward over a model, on one device.

This slice ports construction, ``init_params`` and ``forward`` (inference
and the serving engine's gen-capture prefill). Loss and gradients come
with the training slice.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from paddle_tpu_torch.device import DeviceLike, float32_only, resolve_device
from paddle_tpu_torch.graph.argument import Argument
from paddle_tpu_torch.graph.network import Network
from paddle_tpu_torch.layers.base import LayerContext
from paddle_tpu_torch.ops.init import init_parameter
from paddle_tpu_torch.proto import ModelConfig, ParameterConfig

Tensor = torch.Tensor
Params = Dict[str, Tensor]


class GradientMachine:
    """``device=None`` means the CUDA card (``RuntimeError`` without one);
    ``device="cpu"`` runs every kernel's plain version. ``compute_dtype``
    other than float32 (a bf16 model) is not ported yet and raises."""

    def __init__(self, model: ModelConfig, device: DeviceLike = None,
                 compute_dtype=None):
        float32_only(compute_dtype, "compute dtype")
        self.model = model
        self.device = resolve_device(device)
        self.dtype = torch.float32
        self.network = Network(model)
        self.param_configs: Dict[str, ParameterConfig] = {p.name: p for p in model.parameters}

    def init_params(self, seed: int = 1) -> Params:
        """Fresh parameters on the machine's device, drawn in sorted-name
        order from one ``torch.Generator`` seeded with ``seed``."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        return {name: init_parameter(gen, cfg, self.dtype, self.device)
                for name, cfg in sorted(self.param_configs.items())}

    def forward(self, params: Params, in_args: Dict[str, Argument],
                pass_type: str = "test",
                gen_capture: Optional[dict] = None) -> Tuple[Dict[str, Argument], Dict]:
        """Run the graph; returns (all layer outputs, state updates).

        ``gen_capture``: a dict sink making generator groups capture their
        prepared decode inputs instead of running the beam loop — the
        serving engine's prefill seam (graph/decode_step.py)."""
        ctx = LayerContext(params=params, model=self.model, pass_type=pass_type,
                           gen_capture=gen_capture)
        with torch.no_grad():
            self.network.forward(ctx, in_args)
        return ctx.outputs, {}
