"""GradientMachine — parameters, forward, loss and gradients over a model,
on one device.

Port of ``paddle_tpu/graph/machine.py``: ``forward`` walks the layer graph,
``loss_fn`` sums the cost layers' batch means, and ``grad_fn`` returns
the gradients of every parameter from ``torch.autograd`` (static
parameters get zeros). A ``sparse_update`` table that only data-fed table
projections read (``sparse_prefetch_plan``) gets a
:class:`~paddle_tpu_torch.optimizer.sparse.RowSparseGrad`: its occurrence
rows are gathered outside autograd and are the leaves, so the table is
never one and no [V, D] gradient is built. ``compute_dtype=bfloat16``
trains in mixed precision: master parameters, their gradients and the
optimizer state stay float32, activations and products run in bf16, and
the float32 islands (softmax, losses, batch-norm statistics, CRF/CTC)
upcast (``layers/base.py::LayerContext``). Meshes are a later slice.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from paddle_tpu_torch.device import DeviceLike, compute_dtype as resolve_compute_dtype
from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.graph.argument import Argument
from paddle_tpu_torch.graph.network import Network
from paddle_tpu_torch.layers.base import LayerContext
from paddle_tpu_torch.ops.init import init_parameter
from paddle_tpu_torch.optimizer.sparse import RowSparseGrad
from paddle_tpu_torch.proto import ModelConfig, ParameterConfig

Tensor = torch.Tensor
Params = Dict[str, Tensor]


def compute_dtype_of(opt_config) -> Optional[torch.dtype]:
    """Resolve OptimizationConfig.dtype ('float32' | 'bfloat16') to the
    narrow compute dtype, or None for plain float32 training; any other
    name raises ``ValueError``. The names are those of
    :func:`paddle_tpu_torch.device.compute_dtype`."""
    name = getattr(opt_config, "dtype", None)
    try:
        return resolve_compute_dtype(name, "OptimizationConfig.dtype")
    except NotImplementedError as e:
        raise ValueError(str(e)) from None


class GradientMachine:
    """``device=None`` means the CUDA card (``RuntimeError`` without one);
    ``device="cpu"`` runs every kernel's plain version. ``compute_dtype``:
    None or float32 trains in float32, bfloat16 in mixed precision (master
    parameters stay float32, :func:`compute_dtype_of`); any other raises.
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
        self.model = model
        self.device = resolve_device(device)
        self.dtype = torch.float32
        # mixed precision: master params stay `dtype`; activations and
        # products run in `compute_dtype` (None: everything in `dtype`)
        self.compute_dtype = resolve_compute_dtype(compute_dtype)
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
        # data layers whose every consumer is a cost layer carry targets,
        # labels or weights, not features: they skip the bf16 input cast,
        # so the float32 loss island sees un-rounded values
        data_names = {l.name for l in model.layers if l.type == "data"}
        consumers: Dict[str, set] = {}
        for layer in model.layers:
            for ic in layer.inputs:
                if ic.input_layer_name in data_names:
                    consumers.setdefault(ic.input_layer_name, set()).add(layer.type)
        costish = self.COST_TYPES | {"classification_error", "lambda_cost"}
        self.no_cast_inputs = frozenset(
            n for n, types in consumers.items() if types and types <= costish)

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
                table_overrides: Optional[Dict] = None,
                ) -> Tuple[Dict[str, Argument], Dict]:
        """Run the graph; returns (all layer outputs, state updates).

        A test or gen pass runs under ``torch.no_grad()``; a train pass
        records the autograd graph. ``gen_capture``: a dict sink making
        generator groups capture their prepared decode inputs instead of
        running the beam loop — the serving engine's prefill seam
        (graph/decode_step.py). ``seed``: the pass's seed, from which each
        layer that draws (dropout, sampling_id, nce) seeds a generator of
        its own (``LayerContext.layer_generator``). ``table_overrides``:
        prefetched table rows by (param, data layer), which the table
        projections return instead of gathering (``grad_fn``)."""
        ctx = LayerContext(params=params, model=self.model, pass_type=pass_type,
                           seed=seed, gen_capture=gen_capture, table_overrides=table_overrides,
                           compute_dtype=self.compute_dtype, no_cast_inputs=self.no_cast_inputs,
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
                seed: Optional[int] = None, pass_type: str = "train",
                table_overrides: Optional[Dict] = None):
        outputs, state_updates = self.forward(params, in_args, pass_type, seed=seed,
                                              table_overrides=table_overrides)
        return self.total_cost(outputs), (outputs, state_updates)

    # ------------------------------------------------------ sparse prefetch

    def sparse_prefetch_plan(self) -> List[Tuple[str, str]]:
        """The sparse_update tables that take the row-sparse gradient path,
        as [(param_name, data_layer_name)]: those whose every use is a table
        projection reading ids straight from a data layer (the reach of the
        reference's prefetch from the input arguments). A table used any
        other way keeps the dense gradient and the updater's row scan."""
        sparse_names = {n for n, c in self.param_configs.items()
                        if c.sparse_update and not c.is_static}
        if not sparse_names:
            return []
        layer_map = self.network.layer_map
        uses: Dict[str, list] = {n: [] for n in sparse_names}
        for layer in self.model.layers:
            for ic in layer.inputs:
                pn = ic.input_parameter_name
                if pn not in sparse_names:
                    continue
                src = layer_map.get(ic.input_layer_name)
                ok = (ic.proj_conf is not None and ic.proj_conf.type == "table"
                      and src is not None and src.type == "data")
                uses[pn].append((ic.input_layer_name, ok))
            if layer.bias_parameter_name in sparse_names:
                uses[layer.bias_parameter_name].append(("", False))
        plan = []
        for pn, sites in sorted(uses.items()):
            if sites and all(ok for _, ok in sites):
                plan.extend((pn, ln) for ln, _ in sites)
        return plan

    def grad_fn(self, remat: str = "none", sparse: bool = True) -> Callable:
        """Returns f(params, in_args, seed=None) -> (loss, grads, outputs,
        state_updates). The loss is a detached scalar tensor; gradients are
        keyed like ``params``: a RowSparseGrad for each table of
        ``sparse_prefetch_plan()``, dense tensors for the rest.
        ``sparse=False`` gives dense gradients everywhere (accumulation
        sums them over batches whose row sets differ).

        ``remat="full"`` (OptimizationConfig.remat) runs the loss under
        ``torch.utils.checkpoint``: the backward recomputes the forward
        instead of keeping its activations, as the JAX package's
        ``jax.checkpoint`` does, on the dense path and on the sparse one
        (the prefetched rows are leaves too). The recompute takes the same
        routes and draws the same dropout masks (each layer seeds a
        generator of its own from the step's seed), and its state updates
        are returned, not applied. A kernel's training forward then
        launches twice a step. Any mode but ``""``, ``"none"`` and
        ``"full"`` raises ``ValueError`` here."""
        if remat not in ("", "none", "full"):
            raise ValueError(f"unsupported remat mode {remat!r}")
        plan = self.sparse_prefetch_plan() if sparse else []
        sparse_names = {pn for pn, _ in plan}
        loss_fn = self.loss_fn
        if remat == "full":
            def loss_fn(leaves, in_args, seed, table_overrides=None):
                return checkpoint(self.loss_fn, leaves, in_args, seed,
                                  table_overrides=table_overrides, use_reentrant=False)

        def f(params: Params, in_args: Dict[str, Argument], seed: Optional[int] = None):
            leaves = {}
            for n, p in params.items():
                cfg = self.param_configs.get(n)
                leaves[n] = p.detach().requires_grad_(
                    n not in sparse_names and (cfg is None or not cfg.is_static))
            # the prefetch: each (table, data layer)'s occurrence rows,
            # gathered outside autograd, are the leaves
            rows: Dict[Tuple[str, str], Tensor] = {}
            with torch.no_grad():
                for key in plan:
                    if key not in rows:
                        rows[key] = params[key[0]][in_args[key[1]].ids.long()]
            for r in rows.values():
                r.requires_grad_(True)
            loss, (outputs, state_updates) = loss_fn(leaves, in_args, seed,
                                                     table_overrides=rows or None)
            names = [n for n, p in leaves.items() if p.requires_grad]
            got = torch.autograd.grad(loss, [leaves[n] for n in names] + list(rows.values()),
                                      allow_unused=True)
            dense = dict(zip(names, got))
            pieces: Dict[str, list] = {}
            for ((pn, dname), r), g in zip(rows.items(), got[len(names):]):
                ids = in_args[dname].ids.reshape(-1)
                g = torch.zeros_like(r) if g is None else g
                pieces.setdefault(pn, []).append((ids, g.reshape(ids.shape[0], -1)))
            grads = {}
            for n, p in params.items():
                if n in pieces:
                    ps = pieces[n]
                    grads[n] = RowSparseGrad(torch.cat([i for i, _ in ps]),
                                             torch.cat([g for _, g in ps]), p.shape[0])
                else:
                    # static and unused parameters get zeros
                    g = dense.get(n)
                    grads[n] = g if g is not None else torch.zeros_like(p)
            return loss.detach(), grads, outputs, state_updates

        return f
