"""Template matcher wiring the fused attention-GRU decoder kernels into the
recurrent-group loop.

Port of ``paddle_tpu/graph/fused_decoder.py``. A training recurrent group
whose step graph is EXACTLY the attention-decoder template built by
``trainer_config_helpers.networks.simple_attention`` + ``gru_step_layer``
(the seqToseq decoder)

    memory(gru) -> [transform -> expand -> combine -> softmax
                    -> scaling -> pooling] -> mixed(din) -> gru_step

runs as :func:`~paddle_tpu_torch.ops.fused_attention_gru.fused_attention_gru`:
the CUDA training forward and backward on the card, their plain version
on the CPU. ``settings(pallas_decoder=...)`` is a TPU choice and chooses
nothing here. A group that deviates (extra layers, other activations,
dropout, error clipping, sequence memories, in-link consumers that are
not hoisted) does not match and takes the loop, a different graph with the
same semantics. A group that matches takes the kernels only for the shapes
``fused_attention_gru.supported`` accepts, as the JAX package asks
``pallas_attention_gru.supported``; for any other it takes the loop too,
counted in ``fused_attention_gru.EAGER_ROUTES``. The route is decided the
same way on the CPU. Nothing falls back: a kernel that fails raises.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

_AGENT_TYPES = ("agent", "sequence_agent", "scatter_agent", "gather_agent")


def _clean(cfg) -> bool:
    """No semantics outside the template on an in-loop layer."""
    return cfg.drop_rate == 0.0 and cfg.error_clipping_threshold == 0


def _single_proj(cfg, want_type: str):
    """The layer's single input if it is a `want_type` projection."""
    if len(cfg.inputs) != 1:
        return None
    ic = cfg.inputs[0]
    if ic.proj_conf is None or ic.proj_conf.type != want_type:
        return None
    return ic


def match_decoder(network, sub, ctx, statics, skip, pro_plan) -> Optional[Dict[str, Any]]:
    """The extraction plan, or None when the group is not the
    attention-GRU decoder template."""
    if not ctx.is_training or sub.reversed:
        return None
    if len(sub.memories) != 1 or sub.memories[0].is_sequence:
        return None
    mem = sub.memories[0]
    lm = network.layer_map
    step_layers = [lm[n] for n in sub.layer_names
                   if n not in skip and lm[n].type not in _AGENT_TYPES]
    by_name = {l.name: l for l in step_layers}
    if len(step_layers) != 8 or not all(_clean(l) for l in step_layers):
        return None

    # anchor: the gru_step owning the memory
    gru = next((l for l in step_layers if l.type == "gru_step"), None)
    if gru is None or gru.name != mem.layer_name or len(gru.inputs) != 2:
        return None
    if gru.inputs[1].input_layer_name != mem.link_name:
        return None
    D = gru.size

    din = by_name.get(gru.inputs[0].input_layer_name)
    if din is None or din.type != "mixed" or din.size != 3 * D:
        return None
    if din.active_type not in ("", "linear"):
        return None
    # every din input except the context projection must be hoisted
    hoisted = set(pro_plan.get(din.name, ()))
    ctx_idx = [i for i in range(len(din.inputs)) if i not in hoisted]
    if len(ctx_idx) != 1:
        return None
    ctx_ic = din.inputs[ctx_idx[0]]
    if ctx_ic.proj_conf is None or ctx_ic.proj_conf.type != "fc":
        return None

    pooling = by_name.get(ctx_ic.input_layer_name)
    if (pooling is None or pooling.type != "average"
            or (pooling.average_strategy or "average") != "sum"
            or pooling.trans_type == "seq"
            or pooling.active_type not in ("", "linear")
            or len(pooling.inputs) != 1):
        return None

    scaling = by_name.get(pooling.inputs[0].input_layer_name)
    if scaling is None or scaling.type != "scaling" or len(scaling.inputs) != 2:
        return None
    sm_name, ev_link = (scaling.inputs[0].input_layer_name,
                        scaling.inputs[1].input_layer_name)
    if ev_link not in statics:
        return None

    sm = by_name.get(sm_name)
    if (sm is None or sm.type != "fc" or sm.size != 1
            or sm.active_type != "sequence_softmax"
            or sm.bias_parameter_name or len(sm.inputs) != 1):
        return None

    combine = by_name.get(sm.inputs[0].input_layer_name)
    if (combine is None or combine.type != "mixed" or combine.active_type != "tanh"
            or combine.size != D or len(combine.inputs) != 2):
        return None
    comb_srcs = []
    for ic in combine.inputs:
        if ic.proj_conf is None or ic.proj_conf.type != "identity":
            return None
        comb_srcs.append(ic.input_layer_name)

    expand = next((by_name[n] for n in comb_srcs
                   if n in by_name and by_name[n].type == "expand"), None)
    ep_link = next((n for n in comb_srcs if n in statics), None)
    if expand is None or ep_link is None or ep_link == ev_link:
        return None
    if not expand.inputs or expand.inputs[0].input_layer_name not in by_name:
        return None

    transform = by_name.get(expand.inputs[0].input_layer_name)
    if (transform is None or transform.type != "mixed"
            or transform.active_type not in ("", "linear") or transform.size != D):
        return None
    tr_ic = _single_proj(transform, "fc")
    if tr_ic is None or tr_ic.input_layer_name != mem.link_name:
        return None

    # the whole template accounted for?
    template = {gru.name, din.name, pooling.name, scaling.name, sm.name,
                combine.name, expand.name, transform.name}
    if template != set(by_name):
        return None
    # in-links may only feed the hoisted din inputs
    in_link_names = {l.link_name for l in sub.in_links}
    for l in step_layers:
        for i, ic in enumerate(l.inputs):
            if ic.input_layer_name in in_link_names and not (l.name == din.name and i in hoisted):
                return None

    if (gru.active_type or "tanh", gru.active_gate_type or "sigmoid") != ("tanh", "sigmoid"):
        return None
    return dict(gru=gru, din=din, transform=transform, combine=combine, softmax=sm,
                ctx_ic=ctx_ic, tr_ic=tr_ic, ep_link=ep_link, ev_link=ev_link, D=D)


def run_fused_decoder(network, sub, ctx, statics, plan, pro_feeds,
                      boot_carry, mask_bt) -> Optional[torch.Tensor]:
    """Build the kernel operands from the matched plan and run it. Returns
    the RAW per-step GRU output stream [T, B, D], or None when the static
    links do not carry the template's encoder sequences or the kernels do
    not take their shapes (the loop runs the group then)."""
    from paddle_tpu_torch.ops import fused_attention_gru as fa

    D = plan["D"]
    gru, din = plan["gru"], plan["din"]
    ep_arg = statics[plan["ep_link"]]
    ev_arg = statics[plan["ev_link"]]
    if ep_arg.value is None or ev_arg.value is None or not ep_arg.is_seq:
        return None
    B, Te = ep_arg.value.shape[0], ep_arg.value.shape[1]
    E = ev_arg.value.shape[2]
    xw = pro_feeds.get(din.name)
    if xw is None or ep_arg.value.shape[2] != D:
        return None
    dtype = xw.dtype
    if dtype not in fa.OPERAND_DTYPES:
        return None
    if not fa.supported(B, Te, D, E):
        fa.EAGER_ROUTES += 1
        return None

    wa = ctx.param(plan["tr_ic"].input_parameter_name).reshape(D, D)
    v = ctx.param(plan["softmax"].inputs[0].input_parameter_name).reshape(1, D)
    wctx = ctx.param(plan["ctx_ic"].input_parameter_name).reshape(E, 3 * D)
    wg = ctx.param(gru.inputs[0].input_parameter_name).reshape(D, 3 * D)

    # the operands in xw's dtype, as the JAX package builds them: ba is
    # zeros in that dtype plus the biases, and xw, the masks and h0 are cast
    ba = torch.zeros((1, D), dtype=dtype, device=xw.device)
    if plan["transform"].bias_parameter_name:
        ba = ba + ctx.param(plan["transform"].bias_parameter_name).reshape(1, D)
    if plan["combine"].bias_parameter_name:
        ba = ba + ctx.param(plan["combine"].bias_parameter_name).reshape(1, D)
    if din.bias_parameter_name:
        xw = xw + ctx.param(din.bias_parameter_name).reshape(1, 1, 3 * D).to(dtype)
    if gru.bias_parameter_name:
        xw = xw + ctx.param(gru.bias_parameter_name).reshape(1, 1, 3 * D).to(dtype)

    ep = ep_arg.value.transpose(0, 1)                             # [Te, B, D]
    ev = ev_arg.value.transpose(0, 1)                             # [Te, B, E]
    em = ep_arg.seq_mask(dtype).transpose(0, 1)[:, :, None]
    dmask = mask_bt.transpose(0, 1)[:, :, None].to(dtype).contiguous()
    return fa.fused_attention_gru(ep, ev, em, xw.to(dtype).contiguous(), dmask,
                                  boot_carry.to(dtype).contiguous(), wa, ba.to(wa.dtype), v,
                                  wctx, wg)
