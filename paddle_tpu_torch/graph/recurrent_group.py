"""Recurrent-group executor — the part serving needs.

This slice runs a generator group in gen-capture mode only: the serving
engine's prefill runs the graph up to the group (encoder outputs as static
links, memory boots per sample), and the decode loop is the engine's, one
slot-batched step at a time (:mod:`paddle_tpu_torch.graph.decode_step`).
Beam search (a generator forward without ``gen_capture``) and the training
scan of a recurrent group are later slices and raise here.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from paddle_tpu_torch.graph.argument import Argument
from paddle_tpu_torch.layers.base import LayerContext, forward_layer, register_layer
from paddle_tpu_torch.ops.activations import apply_activation
from paddle_tpu_torch.proto import LayerConfig, SubModelConfig

Tensor = torch.Tensor


@register_layer(
    "agent",
    "sequence_agent",
    "scatter_agent",
    "sequence_scatter_agent",
    "gather_agent",
    "sequence_gather_agent",
)
def _agent_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    raise RuntimeError(
        f"agent layer {cfg.name!r} executed outside a recurrent group — "
        "agents are fed by the group executor")


def forward_recurrent_group(network, cfg: LayerConfig, ctx: LayerContext) -> None:
    sub = network.submodel_map.get(cfg.name)
    if sub is None:
        raise KeyError(f"no sub-model named {cfg.name!r}")
    if sub.generator is None:
        raise NotImplementedError(
            f"recurrent group {cfg.name!r}: the training scan is not ported "
            "yet (the train-step slice of paddle_tpu_torch)")
    _generate(network, cfg, sub, ctx)


def _resolve_outer(sub: SubModelConfig, name: str) -> str:
    """Map an in-group agent name back to the outer layer feeding it."""
    for link in list(sub.static_links) + list(sub.in_links):
        if link.link_name == name:
            return link.layer_name
    return name


def _scope_lookup(ctx: LayerContext, name: str) -> Argument:
    """Group-entry name resolution: this scope, then enclosing scopes.

    Used ONLY for static links and memory boot layers; ordinary layer-input
    lookup cannot walk up, so a step referencing an outer sequence without
    StaticInput still fails loudly."""
    c = ctx
    while c is not None:
        if name in c.outputs:
            return c.outputs[name]
        c = c.parent
    raise KeyError(f"layer output {name!r} not found in any enclosing scope")


def _memory_boot(network, mem, ctx: LayerContext, batch: int, dtype,
                 sub: SubModelConfig, device) -> Tensor:
    size = network.layer_map[mem.link_name].size
    if mem.boot_layer_name:
        boot = _scope_lookup(ctx, _resolve_outer(sub, mem.boot_layer_name)).value
    elif mem.boot_with_const_id >= 0:
        return torch.full((batch,), mem.boot_with_const_id, dtype=torch.int32,
                          device=device)
    else:
        boot = torch.zeros((batch, size), dtype=dtype, device=device)
    if mem.boot_bias_parameter_name:
        boot = boot + ctx.param(mem.boot_bias_parameter_name).reshape(-1)
        boot = apply_activation(mem.boot_bias_active_type, boot)
    return boot


def _run_submodel_step(network, sub: SubModelConfig, ctx: LayerContext,
                       fed: Dict[str, Argument]) -> Dict[str, Argument]:
    """Run the sub-model's layers once with pre-fed agent outputs."""
    step_ctx = LayerContext(params=ctx.params, model=ctx.model,
                            pass_type=ctx.pass_type, parent=ctx)
    step_ctx.outputs.update(fed)
    for name in sub.layer_names:
        lcfg = network.layer_map[name]
        if lcfg.name in step_ctx.outputs:
            continue
        if lcfg.type == "recurrent_layer_group":
            raise NotImplementedError("nested recurrent groups are not ported yet")
        ins = [network._lookup_input(step_ctx, ic.input_layer_name, ic.input_layer_argument)
               for ic in lcfg.inputs]
        forward_layer(lcfg, ins, step_ctx)
    return step_ctx.outputs


def _memory_feed_arg(mem, carry: Tensor) -> Argument:
    """Turn a flat carry back into the Argument fed to the step."""
    if mem.is_sequence:
        raise NotImplementedError("sequence-valued memories are not ported yet")
    if carry.dtype in (torch.int32, torch.int64):
        return Argument(ids=carry)
    return Argument(value=carry)


def _generate(network, cfg: LayerConfig, sub: SubModelConfig, ctx: LayerContext) -> None:
    """The gen-capture seam of the JAX package's ``_generate``."""
    if ctx.gen_capture is None:
        raise NotImplementedError(
            f"generator group {cfg.name!r}: beam search is not ported yet (a "
            "later slice of paddle_tpu_torch); serve greedy decode through "
            "paddle_tpu_torch.serving.frontend.build_engine")
    if sub.in_links:
        raise NotImplementedError("generation with sequence in-links is not ported yet")
    B: Optional[int] = None
    statics: Dict[str, Argument] = {}
    for link in sub.static_links:
        arg = _scope_lookup(ctx, link.layer_name)
        statics[link.link_name] = arg
        B = arg.batch_size if B is None else B
    for mem in sub.memories:
        if mem.boot_layer_name and B is None:
            B = _scope_lookup(ctx, mem.boot_layer_name).batch_size
    if B is None:
        raise ValueError(f"generation group {cfg.name}: cannot infer batch size")
    values = [a.value for a in statics.values() if a.value is not None]
    dtype = values[0].dtype if values else torch.float32
    device = values[0].device if values else None
    boots: List[Any] = [_memory_boot(network, mem, ctx, B, dtype, sub, device)
                        for mem in sub.memories]
    ctx.gen_capture.update(group=cfg.name, statics=statics, boots=boots,
                           batch=B, dtype=dtype)
