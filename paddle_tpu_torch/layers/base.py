"""Layer forward framework.

A layer is a function ``(LayerConfig, [Argument], LayerContext) ->
Argument`` registered by the type string the config DSL emits, as in the
JAX package; gradients come from ``torch.autograd`` through the whole
forward. The shared tail of a layer (bias, activation, dropout after the
activation) lives here, with per-layer error clipping of the backward
signal (identity in the forward).
"""

from __future__ import annotations

import dataclasses
import zlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import torch

from paddle_tpu_torch.graph.argument import Argument
from paddle_tpu_torch.ops.activations import apply_activation
from paddle_tpu_torch.proto import LayerConfig, ModelConfig
from paddle_tpu_torch.utils.error import layer_scope
from paddle_tpu_torch.utils.registry import Registry

Tensor = torch.Tensor

LayerFn = Callable[[LayerConfig, List[Argument], "LayerContext"], Argument]
layer_registry: Registry[LayerFn] = Registry("layer type")


class TimeMajorLogits(NamedTuple):
    """Pre-softmax logits of a HOISTED recurrent out-link, kept in the
    vocab projection's flat [T*B, V] row order instead of the transposed
    [B, T, V] view; the fused cross-entropy reduces over V on this layout
    and transposes only the [T, B] per-step costs."""

    flat: Tensor   # [T*B, V]
    T: int
    B: int


def register_layer(*type_names: str):
    return layer_registry.register(*type_names)


_M64 = (1 << 64) - 1


def fold_seed(seed: Optional[int], *salts: int) -> Optional[int]:
    """``seed`` with each of ``salts`` folded in turn (a splitmix64 round
    each), as a 31-bit seed; None stays None. Every seed that reaches a
    draw comes from here: a training step's from --seed, the pass and the
    batch (``Trainer``), a recurrent step's from its forward's and t
    (``graph/recurrent_group.py``), and a layer's generator (dropout's,
    sampling_id's, nce's) from its pass's and crc32 of "{layer}/{salt}"
    (``LayerContext.layer_generator``).
    31 bits, because the CPU's generator reads only the low 32 of a seed."""
    if seed is None:
        return None
    x = int(seed) & _M64
    for s in salts:
        x = (x + (int(s) + 1) * 0x9E3779B97F4A7C15) & _M64
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
        x ^= x >> 31
    return x & ((1 << 31) - 1)


@dataclass
class LayerContext:
    """Mutable context threaded through one network forward pass."""

    params: Dict[str, Tensor]
    model: ModelConfig
    pass_type: str = "test"                     # train | test | gen
    # the pass's seed, the one channel of randomness: each layer that
    # draws (dropout, sampling_id, nce) seeds a generator of its own from
    # it (layer_generator); None where the caller gave none
    seed: Optional[int] = None
    outputs: Dict[str, Argument] = field(default_factory=dict)
    # mixed precision (OptimizationConfig.dtype="bfloat16"): master params
    # stay float32; activations and product operands are cast to
    # `compute_dtype` (param, cast_compute). Softmax, losses, batch-norm
    # statistics and the CRF/CTC recursions stay float32 (upcast at their
    # entry points, ops/precision.py::hp). Autograd through the cast gives
    # the master parameter a float32 gradient. None: no cast anywhere.
    compute_dtype: Optional[torch.dtype] = None
    # data layers feeding ONLY cost layers (regression targets, soft
    # labels, per-sample weights): their dense values are not narrowed, or
    # the float32 loss island would see pre-rounded targets
    # (GradientMachine computes this set from the graph)
    no_cast_inputs: frozenset = frozenset()
    # static parameter name -> its new value (batch norm's moving mean and
    # variance in a training pass); GradientMachine.forward returns them
    # and the trainer assigns them after the update
    state_updates: Dict[str, Tensor] = field(default_factory=dict)
    # OptimizationConfig.conv_s2d: few-channel 7x7/s2 stem convs rewrite
    # to a space-to-depth 4x4/s1 conv (layers/vision.py _stem_s2d_conv)
    conv_s2d: bool = False
    # OptimizationConfig.conv_stats_mode: 1x1 convs publish their output's
    # per-channel (sum, sumsq, rows) into `conv_stats` — from input-side
    # Gram algebra ("gram") or from kernel 9's epilogue ("pallas",
    # ops/fused_conv1x1_bn.py); "" = off
    conv_stats_mode: str = ""
    # NHWC side-table (layer name -> contiguous [B, H, W, C] tensor): the
    # conv family publishes its output here and prefers consuming it, so a
    # chain of conv/pool/batch_norm/addto never builds the flat NCHW value
    # (layers/vision.py ImageArgument builds it only for a consumer that
    # reads it)
    nhwc: Dict[str, Tensor] = field(default_factory=dict)
    # fused conv + BN statistics side-table (producer layer name -> (sum
    # [C], sumsq [C], rows)): a downstream batch_norm in a training pass
    # takes these instead of reducing the activation again
    conv_stats: Dict[str, Any] = field(default_factory=dict)
    # pre-softmax logits side-table (layer name -> pre-activation tensor,
    # or a TimeMajorLogits for a hoisted recurrent out-link): published by
    # finalize_output for a plain softmax without dropout, so the
    # cross-entropy can take log-softmax from the logits
    logits: Dict[str, Any] = field(default_factory=dict)
    # recurrent-group prologue hoisting (graph/recurrent_group.py
    # _plan_prologue): mixed layer name -> (skipped input indices,
    # precomputed [B, out] slice); set only on per-step contexts
    mixed_prologue: Optional[Dict[str, Any]] = None
    # sparse-embedding prefetch (GradientMachine::prefetch's role): rows
    # gathered outside autograd, keyed by (param_name, input_layer); the
    # table projection returns these instead of gathering, so autograd
    # gives row gradients, never a dense [V, D] one
    table_overrides: Optional[Dict[Any, Tensor]] = None
    # enclosing scope for recurrent-group steps: group-ENTRY resolution
    # (static links, memory boot layers) may walk up this chain; ordinary
    # layer-input lookup deliberately cannot
    parent: Optional["LayerContext"] = None
    # generation-capture sink (graph/decode_step.py): when a dict is
    # supplied, a generator recurrent group stores its prepared decode
    # inputs (static-link Arguments, unexpanded memory boots) here and
    # skips the beam-search loop — the serving engine's prefill path
    gen_capture: Optional[Dict[str, Any]] = None

    @property
    def is_training(self) -> bool:
        return self.pass_type == "train"

    def layer_generator(self, layer_name: str, salt: str, device) -> torch.Generator:
        """A generator of its own for one layer's draws, seeded from the
        pass's seed and crc32 of "{layer_name}/{salt}", the string the JAX
        package folds into its key (``LayerContext.layer_rng``)."""
        if self.seed is None:
            raise ValueError(f"layer {layer_name!r} draws random bits but the pass was "
                             "given no seed")
        gen = torch.Generator(device=device)
        gen.manual_seed(fold_seed(self.seed, zlib.crc32(f"{layer_name}/{salt}".encode())))
        return gen

    def param(self, name: str, cast: bool = True) -> Tensor:
        """The parameter ``name``, cast to the compute dtype unless ``cast``
        is False (a table read before its gather, batch-norm's gamma, beta
        and running statistics, the CRF transitions, the hsigmoid and nce
        weights: master-dtype reads)."""
        try:
            v = self.params[name]
        except KeyError:
            known = ", ".join(sorted(self.params))
            raise KeyError(f"parameter {name!r} not found (have: {known})") from None
        return self.cast_compute(v) if cast else v

    def cast_compute(self, x: Optional[Tensor]) -> Optional[Tensor]:
        """Cast a float tensor to the compute dtype (a no-op otherwise)."""
        if (x is not None and self.compute_dtype is not None and x.is_floating_point()
                and x.dtype != self.compute_dtype):
            return x.to(self.compute_dtype)
        return x


def input_mask(arg: Argument) -> Optional[Tensor]:
    """The float validity mask: [B, S, T] of a nested argument, [B, T] of a
    sequence, None otherwise."""
    if arg.is_nested_seq:
        return arg.sub_seq_mask()
    return arg.seq_mask() if arg.is_seq else None


def finalize_output(cfg: LayerConfig, value: Tensor, ctx: LayerContext,
                    mask: Optional[Tensor] = None) -> Tensor:
    """Shared bias + activation + dropout tail of a layer forward."""
    if cfg.bias_parameter_name:
        value = value + ctx.param(cfg.bias_parameter_name)
    # dropout after softmax would leave the probabilities the only honest
    # source, so the logits view is published only for dropout-free layers
    if cfg.active_type == "softmax" and not cfg.drop_rate:
        ctx.logits[cfg.name] = value
    value = apply_activation(cfg.active_type, value, mask)
    return apply_dropout(cfg, value, ctx)


def apply_dropout(cfg: LayerConfig, value: Tensor, ctx: LayerContext) -> Tensor:
    """The layer's dropout in a training pass; identity otherwise."""
    if cfg.drop_rate > 0.0 and ctx.is_training:
        keep = 1.0 - cfg.drop_rate
        gen = ctx.layer_generator(cfg.name, "dropout", value.device)
        draw = torch.rand(value.shape, generator=gen, device=value.device, dtype=value.dtype)
        # inverted dropout: scale at train time, as the reference does
        # (Layer.cpp forwardDropOut divides by 1 - drop_rate)
        value = torch.where(draw < keep, value / keep, torch.zeros_like(value))
    return value


class _ClipError(torch.autograd.Function):
    """Identity forward; the backward clips the gradient to [-t, t] (the
    reference's per-layer error clipping, ExtraAttr(error_clipping_threshold))."""

    @staticmethod
    def forward(ctx, x, t):
        ctx.t = t
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return g.clamp(-ctx.t, ctx.t), None


# JAX layer types the port does not have yet -> the ROADMAP Queue 1 item
# that brings them (none: every type of the JAX package is registered)
NOT_PORTED: Dict[str, int] = {}


def forward_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    if cfg.type in NOT_PORTED:
        raise NotImplementedError(
            f"layer {cfg.name!r}: type {cfg.type!r} is not ported yet "
            f"(ROADMAP Queue 1 item {NOT_PORTED[cfg.type]})")
    fn = layer_registry.get(cfg.type)
    with layer_scope(f"{cfg.name}({cfg.type})"):
        out = fn(cfg, inputs, ctx)
    if (cfg.error_clipping_threshold > 0 and out.value is not None
            and out.value.requires_grad):
        fields = {f.name: getattr(out, f.name) for f in dataclasses.fields(Argument)}
        fields["value"] = _ClipError.apply(out.value, float(cfg.error_clipping_threshold))
        out = Argument(**fields)
        # a published NHWC, logits or statistics view would bypass the clip
        ctx.nhwc.pop(cfg.name, None)
        ctx.logits.pop(cfg.name, None)
        ctx.conv_stats.pop(cfg.name, None)
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
