"""Per-step decoder seam — slot-batched greedy decode for serving.

A continuous-batching server needs the generation loop OPEN: admit and
evict sequences at every iteration boundary. This module is that opening,
as in the JAX package:

- :func:`plan_of` inspects a generation graph and returns a
  :class:`GenPlan` when the generator group is *slot-decodable*
  (statics-only conditioning, flat memories), else the reason.
- :func:`capture_prefill` runs the machine forward with the
  ``gen_capture`` sink: the encoder runs (on the card, through the GRU
  kernel), the generator group stores its prepared decode inputs and
  skips the loop. This is the prefill.
- :func:`make_greedy_step` builds one decode step over a [B, ...] slot
  batch: the unfused walk of the group's step sub-network, or — with a
  plan from :func:`plan_fused_step` — the fused attention-GRU step, whose
  core on the card is one launch of the attention-GRU kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from paddle_tpu_torch.graph.argument import Argument
from paddle_tpu_torch.graph.recurrent_group import _memory_feed_arg, _run_submodel_step
from paddle_tpu_torch.layers.base import LayerContext
from paddle_tpu_torch.ops.fused_attention_gru import attention_gru_step

Tensor = torch.Tensor


@dataclasses.dataclass
class GenPlan:
    """Static description of a slot-decodable generator group."""

    group: str                 # the recurrent_layer_group layer name
    sub: Any                   # SubModelConfig
    predict_agent: str         # the generated-id feed agent
    score_layer: str           # out-link producing the [B, V] probs
    bos: int
    eos: int
    max_length: int            # generator max_num_frames
    memories: List[Any]
    static_links: List[str]    # link names, capture/state dict keys


def plan_of(machine) -> Tuple[Optional[GenPlan], str]:
    """(plan, "") when the machine's generation graph supports slot-batched
    per-step decode, else (None, reason)."""
    subs = [s for s in machine.model.sub_models if s.generator is not None]
    if not subs:
        return None, "config declares no generator sub-model (beam_search)"
    sub = subs[0]
    if sub.in_links:
        return None, ("generator group has sequence in-links (per-step input "
                      "conditioning) — slot decode supports statics-only groups")
    if any(m.is_sequence for m in sub.memories):
        return None, ("generator group carries a sequence-valued memory — slot "
                      "decode supports flat carries only")
    cfg = machine.network.layer_map.get(sub.name)
    if cfg is None:
        return None, f"no group layer named {sub.name!r}"
    predict_agent = f"__generated_id@{sub.name}"
    if predict_agent not in machine.network.layer_map:
        return None, "generation group missing the generated-id agent"
    if not sub.out_links:
        return None, "generator group has no out-links"
    return GenPlan(
        group=sub.name,
        sub=sub,
        predict_agent=predict_agent,
        score_layer=sub.out_links[0].layer_name,
        bos=int(cfg.bos_id),
        eos=int(cfg.eos_id),
        max_length=int(sub.generator.max_num_frames),
        memories=list(sub.memories),
        static_links=[l.link_name for l in sub.static_links],
    ), ""


_FIELDS = ("value", "ids", "seq_lengths", "sub_seq_lengths")


def _static_tree(statics: Dict[str, Argument]) -> Dict[str, Dict[str, Tensor]]:
    """Argument dict -> {link: {field: tensor}} (absent fields omitted)."""
    return {name: {f: getattr(arg, f) for f in _FIELDS if getattr(arg, f) is not None}
            for name, arg in statics.items()}


def _static_args(tree: Dict[str, Dict[str, Tensor]]) -> Dict[str, Argument]:
    return {name: Argument(**d) for name, d in tree.items()}


def capture_prefill(machine, plan: GenPlan, params, in_args):
    """Run the full graph (encoder + boots) in capture mode; returns
    ``(statics_tree, carries)`` for the feed's batch — the per-sequence
    decode state the engine scatters into free slots."""
    cap: Dict[str, Any] = {}
    machine.forward(params, in_args, pass_type="gen", gen_capture=cap)
    if cap.get("group") != plan.group:
        raise RuntimeError(f"capture ran group {cap.get('group')!r}, planned {plan.group!r}")
    return _static_tree(cap["statics"]), tuple(cap["boots"])


# layer types that are wiring, not computation, in a step submodel
_AGENT_TYPES = ("agent", "sequence_agent", "scatter_agent", "gather_agent")


# Reduced-precision slot state: ``slot_dtype="bf16"`` STORES the slot state
# (GRU carries and captured statics) in bfloat16 while every step still
# COMPUTES in float32: the backend upcasts the statics once a launch and the
# carries before every micro-step, and downcasts only what it stores back.
# This is a storage plan; the model's compute dtype stays float32
# (plan_fused_step refuses any other).
SLOT_STORE_DTYPES: Dict[str, Optional[str]] = {"f32": None, "bf16": "bfloat16"}

# The parity gate per slot dtype: the largest share of emitted tokens that
# may differ from the float32-stored stream. float32 storage is exact; the
# bf16 carry's rounding may flip argmax near-ties.
SLOT_PARITY_TOL: Dict[str, float] = {"f32": 0.0, "bf16": 0.05}


def plan_slot_dtype(slot_dtype: str) -> Tuple[Optional[Dict[str, Any]], str]:
    """(storage plan, "") for a slot dtype spelling, else (None, reason).
    The plan names the storage dtype (None: the model's own) and the
    parity tolerance."""
    if slot_dtype not in SLOT_STORE_DTYPES:
        return None, (f"unknown slot dtype {slot_dtype!r} "
                      f"(supported: {tuple(SLOT_STORE_DTYPES)})")
    return {"store_dtype": SLOT_STORE_DTYPES[slot_dtype],
            "parity_tol": SLOT_PARITY_TOL[slot_dtype]}, ""


def plan_fused_step(machine, plan: GenPlan, slot_dtype: str = "f32"):
    """(extraction dict, "") when the generation step graph is EXACTLY the
    attention-GRU decoder template (simple_attention + gru_step + softmax
    out, the seqToseq shape), else (None, reason). The dict carries every
    parameter name and static-link key the fused step needs, and the
    :func:`plan_slot_dtype` storage plan for ``slot_dtype``. The fused
    step computes in float32 and refuses a machine with any other compute
    dtype, as the JAX plan does."""
    slot_plan, why = plan_slot_dtype(slot_dtype)
    if slot_plan is None:
        return None, why
    sub = plan.sub
    lm = machine.network.layer_map
    # under a reduced compute dtype the unfused graph walk rounds
    # differently per layer and near-tie argmax tokens could silently
    # diverge from the parity contract: refuse instead
    eff = machine.compute_dtype if machine.compute_dtype is not None else machine.dtype
    if eff != torch.float32:
        return None, ("fused step supports float32 compute only (model computes "
                      f"in {str(eff).replace('torch.', '')})")
    if len(plan.memories) != 1:
        return None, "fused step needs exactly one flat memory carry"
    mem = plan.memories[0]
    layers = [lm[n] for n in sub.layer_names if lm[n].type not in _AGENT_TYPES]
    by_name = {l.name: l for l in layers}
    if len(layers) != 10:
        return None, (f"step graph has {len(layers)} layers — not the attention-GRU "
                      "decoder template (embedding/attention/din/gru/out)")
    if not all(l.drop_rate == 0.0 and l.error_clipping_threshold == 0 for l in layers):
        return None, "step layers carry dropout/error-clipping"
    gru = next((l for l in layers if l.type == "gru_step"), None)
    if gru is None or gru.name != mem.layer_name or len(gru.inputs) != 2:
        return None, "no gru_step layer owning the memory"
    if gru.inputs[1].input_layer_name != mem.link_name:
        return None, "gru_step's second input is not the memory link"
    acts = (gru.active_type or "tanh", gru.active_gate_type or "sigmoid")
    if acts != ("tanh", "sigmoid"):
        return None, f"gru activations {acts} != ('tanh', 'sigmoid')"
    D = gru.size
    din = by_name.get(gru.inputs[0].input_layer_name)
    if (din is None or din.type != "mixed" or din.size != 3 * D
            or din.active_type not in ("", "linear") or len(din.inputs) != 2
            or any(ic.proj_conf is None or ic.proj_conf.type != "fc"
                   for ic in din.inputs)):
        return None, "gru input is not a linear mixed of two fc projections"
    emb = ctx_ic = word_ic = None
    for ic in din.inputs:
        src = by_name.get(ic.input_layer_name)
        if (src is not None and src.type == "mixed" and len(src.inputs) == 1
                and src.inputs[0].proj_conf is not None
                and src.inputs[0].proj_conf.type == "table"
                and src.inputs[0].input_layer_name == plan.predict_agent):
            emb, word_ic = src, ic
        else:
            ctx_ic = ic
    if emb is None or ctx_ic is None or emb.bias_parameter_name:
        return None, "no bias-free generated-word embedding feeding the gru"
    pooling = by_name.get(ctx_ic.input_layer_name)
    if (pooling is None or pooling.type != "average"
            or (pooling.average_strategy or "average") != "sum"
            or pooling.active_type not in ("", "linear")
            or len(pooling.inputs) != 1):
        return None, "context is not a sum-pooled attention readout"
    scaling = by_name.get(pooling.inputs[0].input_layer_name)
    if scaling is None or scaling.type != "scaling" or len(scaling.inputs) != 2:
        return None, "no attention scaling layer"
    sm = by_name.get(scaling.inputs[0].input_layer_name)
    ev_link = scaling.inputs[1].input_layer_name
    if ev_link not in plan.static_links:
        return None, "attention values are not a static link"
    if (sm is None or sm.type != "fc" or sm.size != 1
            or sm.active_type != "sequence_softmax"
            or sm.bias_parameter_name or len(sm.inputs) != 1):
        return None, "no sequence-softmax attention scorer"
    combine = by_name.get(sm.inputs[0].input_layer_name)
    if (combine is None or combine.type != "mixed"
            or combine.active_type != "tanh" or combine.size != D
            or len(combine.inputs) != 2
            or any(ic.proj_conf is None or ic.proj_conf.type != "identity"
                   for ic in combine.inputs)):
        return None, "no tanh combine of expanded transform + projection"
    comb_srcs = [ic.input_layer_name for ic in combine.inputs]
    expand = next((by_name[n] for n in comb_srcs
                   if n in by_name and by_name[n].type == "expand"), None)
    ep_link = next((n for n in comb_srcs if n in plan.static_links), None)
    if expand is None or ep_link is None or ep_link == ev_link:
        return None, "combine does not mix an expand with a static link"
    if not expand.inputs or expand.inputs[0].input_layer_name not in by_name:
        return None, "expand input missing from the step graph"
    transform = by_name.get(expand.inputs[0].input_layer_name)
    if (transform is None or transform.type != "mixed"
            or transform.active_type not in ("", "linear")
            or transform.size != D or len(transform.inputs) != 1
            or transform.inputs[0].proj_conf is None
            or transform.inputs[0].proj_conf.type != "fc"
            or transform.inputs[0].input_layer_name != mem.link_name):
        return None, "attention transform is not an fc of the decoder memory"
    out = by_name.get(plan.score_layer)
    if (out is None or out.type != "mixed" or out.active_type != "softmax"
            or len(out.inputs) != 1 or out.inputs[0].proj_conf is None
            or out.inputs[0].proj_conf.type != "fc"
            or out.inputs[0].input_layer_name != gru.name):
        return None, "score layer is not a softmax fc of the gru output"
    template = {gru.name, din.name, emb.name, pooling.name, scaling.name,
                sm.name, combine.name, expand.name, transform.name, out.name}
    if template != set(by_name):
        return None, "extra layers outside the attention-GRU template"
    return dict(
        D=D, E=pooling.size, word_dim=emb.size, vocab=out.size,
        ep_link=ep_link, ev_link=ev_link,
        emb_param=emb.inputs[0].input_parameter_name,
        word_param=word_ic.input_parameter_name,
        wctx_param=ctx_ic.input_parameter_name,
        wa_param=transform.inputs[0].input_parameter_name,
        v_param=sm.inputs[0].input_parameter_name,
        wg_param=gru.inputs[0].input_parameter_name,
        out_w_param=out.inputs[0].input_parameter_name,
        out_b_param=out.bias_parameter_name or "",
        ba_params=[p for p in (transform.bias_parameter_name,
                               combine.bias_parameter_name) if p],
        xw_bias_params=[p for p in (din.bias_parameter_name,
                                    gru.bias_parameter_name) if p],
        **slot_plan,
    ), ""


def _greedy_token(probs: Tensor, finished: Tensor, eos: int) -> Tensor:
    """argmax of the clipped log-probs (the JAX step's arithmetic, so tie
    behavior matches); finished rows emit ``eos``."""
    logp = torch.log(torch.clamp(probs, min=1e-20))
    token = torch.argmax(logp, dim=-1)
    return torch.where(finished, torch.full_like(token, eos), token)


def _freeze(finished: Tensor, old: Tensor, new: Tensor) -> Tensor:
    keep = finished.reshape((-1,) + (1,) * (new.dim() - 1))
    return torch.where(keep, old, new.to(old.dtype))


def _make_fused_step(machine, plan: GenPlan, fp: Dict[str, Any]):
    """The fused step body: ``attention_gru_step`` (one kernel launch on the
    card) plus the embedding lookup and the output softmax, from the
    weights :func:`plan_fused_step` extracted. Finished-row semantics are
    identical to the unfused step (eos emission, frozen carries)."""
    eos = plan.eos
    D, E, W, V = fp["D"], fp["E"], fp["word_dim"], fp["vocab"]

    def step(params, statics_tree, carries, prev_tok, finished):
        p = params.__getitem__
        ep_d = statics_tree[fp["ep_link"]]
        ep = ep_d["value"].transpose(0, 1)                   # [Te, B, D] view
        ev = statics_tree[fp["ev_link"]]["value"].transpose(0, 1)
        Te = ep.shape[0]
        lens = ep_d.get("seq_lengths")
        if lens is None:
            em = torch.ones((Te, ep.shape[1], 1), device=ep.device)
        else:
            em = (torch.arange(Te, device=ep.device)[:, None]
                  < lens[None, :]).to(torch.float32)[:, :, None]
        emb = p(fp["emb_param"]).reshape(-1, W)[prev_tok]    # [B, W]
        xw = emb @ p(fp["word_param"]).reshape(W, 3 * D)
        for name in fp["xw_bias_params"]:
            xw = xw + p(name).reshape(1, 3 * D)
        ba = torch.zeros((1, D), device=ep.device)
        for name in fp["ba_params"]:
            ba = ba + p(name).reshape(1, D)
        (h,) = carries
        h_new = attention_gru_step(
            h, ep, ev, em, xw,
            p(fp["wa_param"]).reshape(D, D), ba,
            p(fp["v_param"]).reshape(1, D),
            p(fp["wctx_param"]).reshape(E, 3 * D),
            p(fp["wg_param"]).reshape(D, 3 * D),
        )                                                    # [B, D]
        logits = h_new @ p(fp["out_w_param"]).reshape(D, V)
        if fp["out_b_param"]:
            logits = logits + p(fp["out_b_param"]).reshape(1, V)
        token = _greedy_token(torch.softmax(logits, dim=-1), finished, eos)
        return (_freeze(finished, h, h_new),), token, finished | (token == eos)

    return step


def make_greedy_step(machine, plan: GenPlan, fused_plan: Optional[Dict[str, Any]] = None):
    """Build ``step(params, statics_tree, carries, prev_tok, finished) ->
    (new_carries, token, new_finished)`` — one greedy decode step for every
    slot row. Finished rows freeze their carries and emit ``eos``. With
    ``fused_plan`` (from :func:`plan_fused_step`) the step is the fused
    attention-GRU math instead of the graph walk."""
    if fused_plan is not None:
        return _make_fused_step(machine, plan, fused_plan)
    network = machine.network
    eos = plan.eos

    def step(params, statics_tree, carries, prev_tok, finished):
        ctx = LayerContext(params=params, model=machine.model, pass_type="gen")
        fed: Dict[str, Argument] = {plan.predict_agent: Argument(ids=prev_tok)}
        fed.update(_static_args(statics_tree))
        for mem, carry in zip(plan.memories, carries):
            fed[mem.link_name] = _memory_feed_arg(mem, carry)
        outs = _run_submodel_step(network, plan.sub, ctx, fed)
        token = _greedy_token(outs[plan.score_layer].value, finished, eos)
        new_carries = []
        for mem, old in zip(plan.memories, carries):
            out_arg = outs[mem.layer_name]
            new = out_arg.value if out_arg.value is not None else out_arg.ids
            new_carries.append(_freeze(finished, old, new))
        return tuple(new_carries), token, finished | (token == eos)

    return step
