"""GradientMachine — parameters, forward, loss and gradients over a model,
on one device.

Port of ``paddle_tpu/graph/machine.py``: ``forward`` walks the layer graph,
``loss_fn`` sums the cost layers' batch means, and ``grad_fn`` returns
dense gradients of every parameter from ``torch.autograd`` (static
parameters get zeros). Sparse row gradients, bf16 compute and meshes are
later slices.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

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
    other than float32 (a bf16 model) is not ported yet and raises.
    ``conv_s2d`` and ``conv_stats_mode`` are the OptimizationConfig fields
    of the same names (layers/vision.py)."""

    # layer types whose output is a differentiable per-sample cost: only
    # these contribute to the training loss
    COST_TYPES = frozenset({
        "multi-class-cross-entropy",
        "multi_class_cross_entropy_with_selfnorm",
        "square_error",
        "multi_binary_label_cross_entropy",
        "soft_binary_class_cross_entropy",
        "rank-cost",
        "huber",
        "lambda_cost",
        "ctc",
        "crf",
        "nce",
        "hsigmoid",
    })

    def __init__(self, model: ModelConfig, device: DeviceLike = None,
                 compute_dtype=None, conv_s2d: bool = False,
                 conv_stats_mode: str = ""):
        float32_only(compute_dtype, "compute dtype")
        self.model = model
        self.device = resolve_device(device)
        self.dtype = torch.float32
        # stem conv space-to-depth rewrite (layers/vision.py)
        self.conv_s2d = bool(conv_s2d)
        # fused 1x1-conv + BN-statistics mode ("gram" | "pallas" | "")
        self.conv_stats_mode = str(conv_stats_mode or "")
        if self.conv_stats_mode not in ("", "gram", "pallas"):
            # an unknown value would silently disable the feature and
            # poison the very A/B measurement the knob exists for
            raise ValueError(
                f"conv_stats_mode must be '', 'gram' or 'pallas', "
                f"got {conv_stats_mode!r}")
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
                gen_capture: Optional[dict] = None,
                seed: Optional[int] = None,
                ) -> Tuple[Dict[str, Argument], Dict]:
        """Run the graph; returns (all layer outputs, state updates).

        A test or gen pass runs under ``torch.no_grad()``; a train pass
        records the autograd graph. ``gen_capture``: a dict sink making
        generator groups capture their prepared decode inputs instead of
        running the beam loop — the serving engine's prefill seam
        (graph/decode_step.py). ``seed``: the pass's seed, from which each
        layer that draws (dropout, sampling_id, nce) seeds a generator of
        its own (``LayerContext.layer_generator``)."""
        ctx = LayerContext(params=params, model=self.model, pass_type=pass_type,
                           seed=seed, gen_capture=gen_capture,
                           conv_s2d=self.conv_s2d, conv_stats_mode=self.conv_stats_mode)
        if pass_type == "train":
            self.network.forward(ctx, in_args)
        else:
            with torch.no_grad():
                self.network.forward(ctx, in_args)
        return ctx.outputs, ctx.state_updates

    def output_args(self, outputs: Dict[str, Argument]) -> Dict[str, Argument]:
        return {n: outputs[n] for n in self.network.output_layer_names}

    # --------------------------------------------------------------- loss

    def cost_layer_names(self):
        layer_map = self.network.layer_map
        return [n for n in self.network.output_layer_names
                if n in layer_map and layer_map[n].type in self.COST_TYPES]

    def total_cost(self, outputs: Dict[str, Argument]) -> Tensor:
        """Mean per-sample cost summed across the cost-layer outputs, so
        gradients are per-sample means."""
        names = self.cost_layer_names()
        if not names:
            raise ValueError("no cost outputs among output layers")
        total = None
        for name in names:
            c = torch.mean(outputs[name].value[:, 0])
            total = c if total is None else total + c
        return total

    def loss_fn(self, params: Params, in_args: Dict[str, Argument],
                seed: Optional[int] = None, pass_type: str = "train"):
        outputs, state_updates = self.forward(params, in_args, pass_type, seed=seed)
        return self.total_cost(outputs), (outputs, state_updates)

    def grad_fn(self) -> Callable:
        """Returns f(params, in_args, seed=None) -> (loss,
        grads, outputs, state_updates). The loss is a detached scalar
        tensor; gradients are dense, keyed like ``params``."""

        def f(params: Params, in_args: Dict[str, Argument], seed: Optional[int] = None):
            leaves = {}
            for n, p in params.items():
                cfg = self.param_configs.get(n)
                leaves[n] = p.detach().requires_grad_(cfg is None or not cfg.is_static)
            loss, (outputs, state_updates) = self.loss_fn(leaves, in_args, seed)
            names = [n for n, p in leaves.items() if p.requires_grad]
            got = torch.autograd.grad(loss, [leaves[n] for n in names], allow_unused=True)
            got = dict(zip(names, got))
            # static and unused parameters get zeros
            grads = {n: got[n] if got.get(n) is not None else torch.zeros_like(p)
                     for n, p in params.items()}
            return loss.detach(), grads, outputs, state_updates

        return f
