"""Recurrent-group executor.

Training and evaluation (``_forward_scan``, the JAX package's one
``lax.scan`` over the padded time axis) run as a Python loop over time:
in-links become per-step slices of [B, T, D], memories become carries
(masked, so padding passes the state through), out-links are the stacked
step outputs, and autograd differentiates through the loop. As in the JAX
package, pure per-row layers that only feed the out-links (the NMT vocab
projection) run once after the loop on the stacked rows (the epilogue),
time-parallel projections of plain in-links run once before it (the
prologue), and a training group that is exactly the attention-GRU decoder
template runs as the fused decoder kernels (:mod:`~paddle_tpu_torch.graph.
fused_decoder`).

Nested (sub-sequence) groups, as in the JAX package: an in-link marked
``has_subseq`` ([B, S, T, D]) makes the loop step over sub-sequences, each
step fed one whole [B, T, D] sub-sequence with its inner lengths; a
recurrent group inside the step loops over that sub-sequence's tokens, and
an out-link that gives a sequence frame each step becomes a nested
[B, S, T, D] result. A nested group hoists nothing and takes no fused
decoder. A sequence-valued memory (``memory(is_seq=True)``) carries a
whole padded sequence (value, lengths) from step to step, booted from a
sequence layer and clamped to the boot's padded length.

A generator group runs the JAX package's batched beam search
(``_generate``): statics and memory boots tiled K-fold, one walk of the
step sub-network per generated token over [B*K] rows, top-K over the
[B, K*V] candidates, the carries reindexed by the chosen beams, until
every beam of every sample has finished or ``max_length`` steps ran.
In gen-capture mode the serving engine's prefill runs the graph up to the
group instead (encoder outputs as static links, memory boots per sample),
and the decode loop is the engine's, one slot-batched step at a time
(:mod:`paddle_tpu_torch.graph.decode_step`, which refuses a group with
in-links or a sequence-valued memory). A nested in-link feeds one whole
sub-sequence per generated step; sequence-valued memories are carried per
beam, frozen and reordered as flat carries are.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from paddle_tpu_torch.graph.argument import Argument
from paddle_tpu_torch.layers.base import (LayerContext, TimeMajorLogits, fold_seed,
                                         forward_layer, register_layer)
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
        _forward_scan(network, cfg, sub, ctx)
    else:
        _generate(network, cfg, sub, ctx)


def _resolve_outer(sub: SubModelConfig, name: str) -> str:
    """Map an in-group agent name back to the outer layer feeding it."""
    for link in list(sub.static_links) + list(sub.in_links):
        if link.link_name == name:
            return link.layer_name
    return name


def _scope_lookup(ctx: LayerContext, name: str) -> Argument:
    """Group-entry name resolution: this scope, then enclosing scopes.

    Used ONLY for in-links, static links and memory boot layers (the
    references a nested group may make to layers outside its enclosing
    group); ordinary layer-input lookup cannot walk up, so a step
    referencing an outer sequence without StaticInput still fails loudly."""
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
                       fed: Dict[str, Argument], skip: frozenset = frozenset(),
                       mixed_prologue: Optional[Dict[str, Any]] = None, t: int = 0,
                       ) -> Dict[str, Argument]:
    """Run the sub-model's layers once, step ``t``, with pre-fed agent
    outputs. ``skip`` names epilogue layers hoisted out of the loop;
    ``mixed_prologue`` maps a mixed layer to (skipped input indices,
    precomputed [B, out] slice) for projections hoisted before it."""
    step_ctx = LayerContext(params=ctx.params, model=ctx.model,
                            pass_type=ctx.pass_type,
                            seed=fold_seed(ctx.seed, t), parent=ctx,
                            compute_dtype=ctx.compute_dtype,
                            no_cast_inputs=ctx.no_cast_inputs,
                            mixed_prologue=mixed_prologue)
    step_ctx.outputs.update(fed)
    for name in sub.layer_names:
        lcfg = network.layer_map[name]
        if lcfg.name in step_ctx.outputs or lcfg.name in skip:
            continue
        if lcfg.type == "recurrent_layer_group":
            # a nested group loops over the tokens of this step's sub-sequence
            forward_recurrent_group(network, lcfg, step_ctx)
            continue
        ins = [network._lookup_input(step_ctx, ic.input_layer_name, ic.input_layer_argument)
               for ic in lcfg.inputs]
        forward_layer(lcfg, ins, step_ctx)
    return step_ctx.outputs


def _memory_boot_seq(network, mem, ctx: LayerContext, sub: SubModelConfig):
    """The (value or ids, lengths) carry of a sequence-valued memory, from
    its boot layer, which must be a sequence (the reference's
    createMemoryFrameInfo seqFlag branch)."""
    if not mem.boot_layer_name:
        raise ValueError(f"sequence memory for {mem.layer_name!r} needs a sequence boot layer "
                         "(reference: 'boot layer must be a sequence when is_sequence = true')")
    boot = _scope_lookup(ctx, _resolve_outer(sub, mem.boot_layer_name))
    if not boot.is_seq:
        raise ValueError(f"boot layer {mem.boot_layer_name!r} of sequence memory is not a "
                         "sequence")
    return (boot.value if boot.value is not None else boot.ids), boot.seq_lengths


def _pad_time(x: Tensor, T: int) -> Tensor:
    """x with axis 1 padded with zeros or cut to exactly T."""
    if x.shape[1] >= T:
        return x[:, :T]
    return torch.cat([x, x.new_zeros((x.shape[0], T - x.shape[1]) + tuple(x.shape[2:]))], 1)


def _advance_seq_memory(mem, old, out_arg: Argument):
    """The new (value, lengths) of a sequence memory from its layer's step
    output, padded or cut to the carry's capacity, the boot's padded
    length, as the JAX package's fixed-shape carries are
    (doc/divergences.md). The caller applies its keep-mask."""
    old_v, _ = old
    n_rows, Tm = old_v.shape[:2]
    new_v = out_arg.ids if _is_int_carry(old_v) else out_arg.value
    if new_v.dim() != old_v.dim():
        raise ValueError(f"sequence memory {mem.layer_name!r}: linked layer must produce a "
                         "sequence frame")
    new_v = _pad_time(new_v, Tm).to(old_v.dtype)
    if out_arg.seq_lengths is not None:
        new_l = torch.clamp(out_arg.seq_lengths, max=Tm).to(torch.int32)
    else:
        new_l = torch.full((n_rows,), Tm, dtype=torch.int32, device=new_v.device)
    return new_v, new_l


def _boot_carries(network, memories, ctx, sub, B, dtype, device) -> list:
    """Each memory's first carry."""
    return [_memory_boot_seq(network, mem, ctx, sub) if mem.is_sequence
            else _memory_boot(network, mem, ctx, B, dtype, sub, device) for mem in memories]


def _keep(mask: Tensor, x: Tensor) -> Tensor:
    """A per-row mask [N] shaped to broadcast over x [N, ...]."""
    return mask.reshape((-1,) + (1,) * (x.dim() - 1))


# layer types that are pure per-row functions of their inputs (no
# sequence/time semantics, no randomness): safe to apply once to the
# stacked [T*B, D] rows after the loop instead of once per step
_HOISTABLE_TYPES = frozenset({"fc", "mixed", "addto", "slope_intercept", "concat"})


def _plan_epilogue(network, sub: SubModelConfig):
    """Split the step graph into (inside, epilogue), as the JAX package does.

    Layers that only feed the group's out-links (never a memory, never
    another inside layer) and are pure per-row ops run ONCE on the stacked
    step outputs: the NMT decoder's vocab projection becomes one
    [T*B, D] x [D, V] product instead of T weight reads. Returns
    (epilogue: ordered layer names, frontier: inside outputs the epilogue
    reads), or None when nothing can be hoisted."""
    layer_map = network.layer_map
    names = [n for n in sub.layer_names if n in layer_map]
    name_set = set(names)
    if any(layer_map[n].type == "recurrent_layer_group" for n in names):
        return None
    consumers: Dict[str, set] = {n: set() for n in names}
    for n in names:
        for ic in layer_map[n].inputs:
            if ic.input_layer_name in consumers:
                consumers[ic.input_layer_name].add(n)
    # everything a memory reads must stay inside (the carry depends on it)
    must_inside = set()
    stack = [m.layer_name for m in sub.memories if m.layer_name in name_set]
    while stack:
        n = stack.pop()
        if n in must_inside:
            continue
        must_inside.add(n)
        stack.extend(ic.input_layer_name for ic in layer_map[n].inputs
                     if ic.input_layer_name in name_set)
    out_names = {l.layer_name for l in sub.out_links}

    def hoistable(n):
        lc = layer_map[n]
        return lc.type in _HOISTABLE_TYPES and lc.drop_rate == 0.0 and n not in must_inside

    # reverse-topological growth: a layer joins the epilogue when every
    # step-graph consumer already did (out-link layers also have the
    # implicit "out" consumer, which the epilogue serves)
    epilogue: List[str] = []
    in_epi: set = set()
    for n in reversed(names):
        if not hoistable(n):
            continue
        if not consumers[n] and n not in out_names:
            continue  # dead layer: leave it alone
        if all(c in in_epi for c in consumers[n]):
            in_epi.add(n)
            epilogue.append(n)
    epilogue.reverse()
    if not any(n in out_names for n in epilogue):
        return None  # hoisting pays only when an out-link moves out
    frontier: List[str] = []
    for n in epilogue:
        for ic in layer_map[n].inputs:
            src = ic.input_layer_name
            if src not in in_epi and src not in frontier:
                frontier.append(src)
    return epilogue, frontier


def _plan_prologue(network, sub: SubModelConfig, epilogue: frozenset):
    """Projection prologue, the input-side dual of the epilogue: the
    weight-bearing projections (fc / trans_fc) of a mixed layer whose
    source is a plain in-link are time-parallel, so they run once before
    the loop as one [T, B, D] x [D, out] product and the step's mixed
    layer starts its sum from the precomputed slice. Returns
    {mixed_layer_name: (input_index, ...)}; epilogue layers are excluded."""
    layer_map = network.layer_map
    in_links = {l.link_name for l in sub.in_links if not l.has_subseq}
    plan = {}
    for n in sub.layer_names:
        lc = layer_map.get(n)
        if lc is None or lc.type != "mixed" or n in epilogue:
            continue
        idxs = tuple(idx for idx, ic in enumerate(lc.inputs)
                     if ic.proj_conf is not None
                     and ic.proj_conf.type in ("fc", "trans_fc")
                     and ic.input_layer_name in in_links)
        if idxs:
            plan[n] = idxs
    return plan


def _forward_scan(network, cfg: LayerConfig, sub: SubModelConfig, ctx: LayerContext) -> None:
    """The training/evaluation loop of a recurrent group: over the time
    steps of a flat group, over the sub-sequences of a nested one."""
    if not sub.in_links:
        raise ValueError(f"recurrent group {cfg.name} has no sequence inputs")
    nested = any(link.has_subseq for link in sub.in_links)
    if nested:
        ref_link = next(l for l in sub.in_links if l.has_subseq)
        first = _scope_lookup(ctx, ref_link.layer_name)
        if not first.is_nested_seq:
            raise ValueError(f"in-link {ref_link.layer_name!r} marked has_subseq but is not "
                             "nested")
    else:
        first = _scope_lookup(ctx, sub.in_links[0].layer_name)
        if not first.is_seq:
            raise ValueError(f"in-link {sub.in_links[0].layer_name!r} is not a sequence")
    lengths = first.seq_lengths            # [B]: valid steps, or sub-sequences
    B, T = first.batch_size, first.max_len
    mask_bt = first.seq_mask()             # [B, T] (T = S for a nested group)

    # time-major in-links; a nested link also gives each step's inner
    # lengths, so that every step is fed a real sequence
    xs_vals: Dict[str, Tensor] = {}
    xs_ids: Dict[str, Tensor] = {}
    xs_sublens: Dict[str, Tensor] = {}
    for link in sub.in_links:
        arg = _scope_lookup(ctx, link.layer_name)
        if arg.value is not None:
            xs_vals[link.link_name] = arg.value.transpose(0, 1)      # [T, B, ...]
        if arg.ids is not None:
            xs_ids[link.link_name] = arg.ids.transpose(0, 1)
        if link.has_subseq:
            xs_sublens[link.link_name] = arg.sub_seq_lengths.transpose(0, 1)  # [S, B]
    statics: Dict[str, Argument] = {
        link.link_name: _scope_lookup(ctx, link.layer_name) for link in sub.static_links}

    memories = list(sub.memories)
    ref = first.value if first.value is not None else first.ids
    carry_dtype = first.value.dtype if first.value is not None else torch.float32
    carries = _boot_carries(network, memories, ctx, sub, B, carry_dtype, ref.device)
    out_links = list(sub.out_links)

    # a nested group hoists nothing; a flat one hoists no layer that reads
    # a sequence-valued feed
    plan = None if nested else _plan_epilogue(network, sub)
    if plan is not None:
        seq_feeds = {m.link_name for m in memories if m.is_sequence}
        seq_feeds |= {l.link_name for l in sub.static_links if l.has_subseq}
        if any(f in seq_feeds for f in plan[1]):
            plan = None
    epilogue, frontier = plan if plan is not None else ([], [])
    # loop-invariant static feeds are rebuilt after the loop, not stacked
    dyn_frontier = [f for f in frontier if f not in statics]
    skip = frozenset(epilogue)
    inside_out_links = [l for l in out_links if l.layer_name not in skip]

    pro_plan = {} if nested else _plan_prologue(network, sub, skip)
    pro_feeds: Dict[str, Tensor] = {}
    if pro_plan:
        from paddle_tpu_torch.layers.core import apply_projection

        for lname, idxs in pro_plan.items():
            lc = network.layer_map[lname]
            acc = None
            for idx in idxs:
                ic = lc.inputs[idx]
                y = apply_projection(ic.proj_conf, ic,
                                     Argument(value=xs_vals[ic.input_layer_name]), ctx)
                acc = y if acc is None else acc + y
            pro_feeds[lname] = acc                                    # [T, B, out]

    # a training group that is exactly the attention-GRU decoder template
    # runs as the fused decoder kernels; any other group takes the loop
    # below, which is a different graph, not a fallback
    fused_ys = None
    if ctx.is_training and not nested:
        from paddle_tpu_torch.graph import fused_decoder

        fplan = fused_decoder.match_decoder(network, sub, ctx, statics, skip, pro_plan)
        if fplan is not None:
            gname = fplan["gru"].name
            if (all(f == gname for f in dyn_frontier)
                    and all(l.layer_name == gname for l in inside_out_links)):
                fused_ys = fused_decoder.run_fused_decoder(
                    network, sub, ctx, statics, fplan, pro_feeds, carries[0], mask_bt)

    if fused_ys is not None:
        # the (ys, frontier) the loop would give: masked out-link streams,
        # raw frontier values for the epilogue
        m3 = mask_bt.transpose(0, 1)[:, :, None].to(fused_ys.dtype)
        ys = [(fused_ys * m3, None) for _ in inside_out_links]
        frs = [(fused_ys, None) for _ in dyn_frontier]
    else:
        ys_t: List[List[Tuple[Tensor, Optional[Tensor]]]] = [[None] * T
                                                               for _ in inside_out_links]
        fr_t = [([None] * T, [None] * T) for _ in dyn_frontier]
        mask_tb = mask_bt.transpose(0, 1)
        for t in (range(T - 1, -1, -1) if sub.reversed else range(T)):
            fed: Dict[str, Argument] = {}
            for link in sub.in_links:
                name = link.link_name
                fed[name] = Argument(
                    value=xs_vals[name][t] if name in xs_vals else None,
                    ids=xs_ids[name][t] if name in xs_ids else None,
                    seq_lengths=xs_sublens[name][t] if name in xs_sublens else None)
            fed.update(statics)
            for mem, carry in zip(memories, carries):
                fed[mem.link_name] = _memory_feed_arg(mem, carry)
            mixed_pro = {lname: (pro_plan[lname], x[t]) for lname, x in pro_feeds.items()}
            outs = _run_submodel_step(network, sub, ctx, fed, skip=skip,
                                      mixed_prologue=mixed_pro, t=t)
            m_t = mask_tb[t]
            keep = m_t > 0
            new_carries = []
            for mem, old in zip(memories, carries):
                out_arg = outs[mem.layer_name]
                if mem.is_sequence:
                    new_v, new_l = _advance_seq_memory(mem, old, out_arg)
                    new_carries.append((torch.where(_keep(keep, new_v), new_v, old[0]),
                                        torch.where(keep, new_l, old[1])))
                    continue
                new = out_arg.ids if _is_int_carry(old) else out_arg.value
                new_carries.append(torch.where(_keep(keep, new), new.to(old.dtype), old))
            carries = new_carries
            for i, l in enumerate(inside_out_links):
                out_arg = outs[l.layer_name]
                v = out_arg.value
                if v.dim() >= 3 and out_arg.seq_lengths is not None:
                    # a sequence frame (an inner group's output): one row of
                    # a nested result, with its lengths
                    ys_t[i][t] = (v * _keep(m_t, v).to(v.dtype),
                                  out_arg.seq_lengths * m_t.to(torch.int32))
                else:
                    ys_t[i][t] = (v * m_t[:, None].to(v.dtype), None)
            # frontier values for the epilogue stay UNMASKED (the out-link
            # mask is applied after the epilogue)
            for i, f in enumerate(dyn_frontier):
                fr_t[i][0][t], fr_t[i][1][t] = outs[f].value, outs[f].ids
        ys = [(torch.stack([v for v, _ in y]),
               None if y[0][1] is None else torch.stack([l for _, l in y])) for y in ys_t]
        frs = [(None if vs[0] is None else torch.stack(vs),
                None if ids[0] is None else torch.stack(ids)) for vs, ids in fr_t]

    for link, (y, y_lens) in zip(inside_out_links, ys):
        # [S, B, T, D] -> a nested [B, S, T, D] with per-sub-sequence lengths
        ctx.outputs[link.link_name] = Argument(
            value=y.transpose(0, 1), seq_lengths=lengths,
            sub_seq_lengths=None if y_lens is None else y_lens.transpose(0, 1))
    if epilogue:
        _run_epilogue(network, ctx, epilogue, dyn_frontier, frs, statics, out_links,
                      B, T, mask_bt, lengths)
    # the group layer itself exposes the first out-link (its logits too, so
    # a cost wired to the group name keeps the fused cross-entropy)
    if out_links:
        ctx.outputs[cfg.name] = ctx.outputs[out_links[0].link_name]
        if out_links[0].link_name in ctx.logits:
            ctx.logits[cfg.name] = ctx.logits[out_links[0].link_name]


def _run_epilogue(network, ctx, epilogue, dyn_frontier, frs, statics,
                  out_links, B, T, mask_bt, lengths):
    """Apply the hoisted per-row layers once to the stacked loop outputs."""
    epi_ctx = LayerContext(params=ctx.params, model=ctx.model, pass_type=ctx.pass_type,
                           compute_dtype=ctx.compute_dtype, no_cast_inputs=ctx.no_cast_inputs)
    for name, (v, ids) in zip(dyn_frontier, frs):
        # [T, B, ...] -> rows [T*B, ...]
        epi_ctx.outputs[name] = Argument(
            value=None if v is None else v.reshape((-1,) + tuple(v.shape[2:])),
            ids=None if ids is None else ids.reshape((-1,) + tuple(ids.shape[2:])))

    def tile(x):
        # a loop-invariant [B, ...] feed, repeated for each of the T rows
        if x is None:
            return None
        return x[None].expand((T,) + tuple(x.shape)).reshape((-1,) + tuple(x.shape[1:]))

    for name, arg in statics.items():
        if name not in epi_ctx.outputs:
            epi_ctx.outputs[name] = Argument(value=tile(arg.value), ids=tile(arg.ids))
    for name in epilogue:
        lcfg = network.layer_map[name]
        ins = [network._lookup_input(epi_ctx, ic.input_layer_name, ic.input_layer_argument)
               for ic in lcfg.inputs]
        forward_layer(lcfg, ins, epi_ctx)
    hoisted = {l.layer_name for l in out_links} & set(epilogue)
    mask = mask_bt[..., None]
    for link in out_links:
        if link.layer_name not in hoisted:
            continue
        flat = epi_ctx.outputs[link.layer_name].value                  # [T*B, D]
        y = flat.reshape((T, B) + tuple(flat.shape[1:])).transpose(0, 1)
        ctx.outputs[link.link_name] = Argument(value=y * mask.to(y.dtype),
                                               seq_lengths=lengths)
        z = epi_ctx.logits.get(link.layer_name)
        if z is not None:
            # the hoisted layer's pre-softmax logits, kept in their flat
            # [T*B, V] row order for the fused cross-entropy
            ctx.logits[link.link_name] = TimeMajorLogits(z, T, B)


def _memory_feed_arg(mem, carry) -> Argument:
    """Turn a carry back into the Argument fed to the step (a sequence
    memory's carry is its (value or ids, lengths) pair)."""
    if mem.is_sequence:
        v, sl = carry
        if _is_int_carry(v):
            return Argument(ids=v, seq_lengths=sl)
        return Argument(value=v, seq_lengths=sl)
    if _is_int_carry(carry):
        return Argument(ids=carry)
    return Argument(value=carry)


def _is_int_carry(carry: Tensor) -> bool:
    return carry.dtype in (torch.int32, torch.int64)


# ------------------------------------------------------------ generation

# beam-search steps run by generator groups in this process: the loop's trip
# count depends on the data (it stops once every beam has finished), so
# chip_smoke.py zeroes this just before a generation run and reads it after
BEAM_STEPS = 0

_NEG_INF = -1e30


def _expand_beams(arg: Argument, K: int) -> Argument:
    """Tile an Argument's batch dim by the beam width: [B, ...] -> [B*K, ...],
    each row repeated K times in place (``jnp.repeat``, not a tiling of the
    whole batch)."""

    def rep(x):
        return None if x is None else torch.repeat_interleave(x, K, dim=0)

    return Argument(value=rep(arg.value), ids=rep(arg.ids), seq_lengths=rep(arg.seq_lengths),
                    sub_seq_lengths=rep(arg.sub_seq_lengths), weight=rep(arg.weight))


def _top_k_lower_index_first(flat: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest values, in
    descending order, the lower index first among equal values.

    ``torch.topk`` promises no order among equal values, so each float is
    mapped to an int32 in the same total order as XLA's (-0.0 below +0.0)
    and packed above its reversed index into one int64 key. The keys are
    unique, and their top k are the reference's picks."""
    n = flat.shape[-1]
    bits = flat.contiguous().view(torch.int32)
    ordered = bits ^ ((bits >> 31) & 0x7FFFFFFF)  # negative floats: flip the magnitude
    rev = (n - 1) - torch.arange(n, device=flat.device)
    key = ordered.to(torch.int64) * (1 << 32) + rev
    idx = (n - 1) - (torch.topk(key, k, dim=-1).values & 0xFFFFFFFF)
    return torch.gather(flat, -1, idx), idx


def _generate(network, cfg: LayerConfig, sub: SubModelConfig, ctx: LayerContext) -> None:
    """Batched beam search, the JAX package's ``_generate`` (ref:
    RecurrentGradientMachine::beamSearch and oneWaySearch; greedy is
    beam_size=1). Outputs: ``cfg.name`` (the best beam's ids and length),
    ``cfg.name@beams`` (ids [B, K, L], scores [B, K], lengths [B, K]) and
    the score layer's name as an alias of the first."""
    global BEAM_STEPS
    gen = sub.generator
    K = max(int(cfg.beam_size or gen.beam_size), 1)
    L = int(gen.max_num_frames)
    if L <= 0:
        raise ValueError("generator needs max_num_frames (beam_search max_length)")
    bos, eos = int(cfg.bos_id), int(cfg.eos_id)

    B: Optional[int] = None
    statics: Dict[str, Argument] = {}
    for link in sub.static_links:
        arg = _scope_lookup(ctx, link.layer_name)
        statics[link.link_name] = arg
        B = arg.batch_size if B is None else B
    # sequence in-links: generation consumes one input frame per step
    # (per-step conditioning), or one whole sub-sequence of a nested
    # in-link, and ends with the shortest in-link of a sample
    in_args: Dict[str, Argument] = {}
    in_lengths: Optional[Tensor] = None
    for link in sub.in_links:
        arg = _scope_lookup(ctx, link.layer_name)
        if link.has_subseq and not (arg.is_nested_seq and arg.is_seq):
            raise ValueError(
                f"generation in-link {link.layer_name!r} marked has_subseq needs a nested "
                "sequence with outer lengths (seq_lengths = sub-sequence count per sample)")
        if not arg.is_seq:
            raise ValueError(
                f"generation in-link {link.layer_name!r} must be a sequence (wrap "
                "whole-sequence conditions in StaticInput(..., is_seq=True))")
        in_args[link.link_name] = arg
        B = arg.batch_size if B is None else B
        L = min(L, arg.max_len)
        in_lengths = (arg.seq_lengths if in_lengths is None
                      else torch.minimum(in_lengths, arg.seq_lengths))
    memories = list(sub.memories)
    for mem in memories:
        if mem.boot_layer_name and B is None:
            B = _scope_lookup(ctx, mem.boot_layer_name).batch_size
    if B is None:
        raise ValueError(f"generation group {cfg.name}: cannot infer batch size")
    given = list(statics.values()) + list(in_args.values())
    values = [a.value for a in given if a.value is not None]
    dtype = values[0].dtype if values else torch.float32
    tensors = values + [a.ids for a in given if a.ids is not None]
    device = tensors[0].device if tensors else next(iter(ctx.params.values())).device
    boots = _boot_carries(network, memories, ctx, sub, B, dtype, device)

    predict_agent = f"__generated_id@{cfg.name}"
    if predict_agent not in network.layer_map:
        raise ValueError(f"generation group {cfg.name}: missing the generated-id agent")
    score_layer = sub.out_links[0].layer_name

    if ctx.gen_capture is not None:
        # the serving engine's prefill: it takes over the decode loop itself,
        # one slot-batched step at a time (graph/decode_step.py)
        ctx.gen_capture.update(group=cfg.name, statics=statics, boots=boots,
                               batch=B, dtype=dtype)
        return

    statics = {name: _expand_beams(arg, K) for name, arg in statics.items()}
    in_v: Dict[str, Tensor] = {}                                # [T, B*K, ...]
    in_i: Dict[str, Tensor] = {}
    in_l: Dict[str, Tensor] = {}                                # nested: [S, B*K]
    for name, arg in in_args.items():
        ex = _expand_beams(arg, K)
        if ex.value is not None:
            in_v[name] = ex.value.transpose(0, 1)
        if ex.ids is not None:
            in_i[name] = ex.ids.transpose(0, 1)
        if ex.sub_seq_lengths is not None:
            in_l[name] = ex.sub_seq_lengths.transpose(0, 1)
    carries = [tuple(torch.repeat_interleave(x, K, dim=0) for x in boot) if mem.is_sequence
               else torch.repeat_interleave(boot, K, dim=0)
               for mem, boot in zip(memories, boots)]
    prev_tok = torch.full((B * K,), bos, dtype=torch.int32, device=device)
    cum = torch.zeros((B, K), dtype=dtype, device=device)      # cumulative log prob
    cum[:, 1:] = _NEG_INF
    # an empty in-link sequence is finished before step 0: it generates
    # length 0, not one token conditioned on padding
    finished = (torch.zeros((B, K), dtype=torch.bool, device=device) if in_lengths is None
                else (in_lengths <= 0)[:, None].expand(B, K).clone())
    history = torch.zeros((B, K, L), dtype=torch.int32, device=device)
    lens = torch.zeros((B, K), dtype=torch.int32, device=device)
    first_row = torch.arange(B, device=device)[:, None] * K

    # the reference's while_loop: stop once every beam of every sample has
    # finished, so history past that step stays 0. The condition is read on
    # the host, one device sync a step.
    t = 0
    while t < L and not bool(finished.all()):
        fed: Dict[str, Argument] = {predict_agent: Argument(ids=prev_tok)}
        for name in in_args:
            fed[name] = Argument(value=in_v[name][t] if name in in_v else None,
                                 ids=in_i[name][t] if name in in_i else None,
                                 seq_lengths=in_l[name][t] if name in in_l else None)
        fed.update(statics)
        for mem, carry in zip(memories, carries):
            fed[mem.link_name] = _memory_feed_arg(mem, carry)
        outs = _run_submodel_step(network, sub, ctx, fed, t=t)
        probs = outs[score_layer].value                           # [B*K, V]
        V = probs.shape[-1]
        logp = torch.log(torch.clamp(probs, min=1e-20)).reshape(B, K, V)
        # a finished beam may only "emit" eos, at no cost; every other
        # candidate of it is dead (-1e30, not the clip floor, else its V-1
        # ghosts could outrank live continuations)
        eos_row = torch.where(torch.arange(V, device=device) == eos, 0.0, _NEG_INF)
        logp = torch.where(finished[:, :, None], eos_row.to(logp.dtype), logp)
        total = cum[:, :, None] + logp                            # [B, K, V]
        top_scores, top_idx = _top_k_lower_index_first(total.reshape(B, K * V), K)
        beam_idx = top_idx // V                                   # [B, K]
        token = (top_idx % V).to(torch.int32)
        # advance the carries with this step's outputs (finished beams keep
        # theirs), then reindex them by the chosen beams
        flat_sel = (first_row + beam_idx).reshape(-1)
        keep = finished.reshape(-1)
        new_carries = []
        for mem, old in zip(memories, carries):
            out_arg = outs[mem.layer_name]
            if mem.is_sequence:
                new = _advance_seq_memory(mem, old, out_arg)
                new_carries.append(tuple(
                    torch.where(_keep(keep, o), o, n).index_select(0, flat_sel)
                    for o, n in zip(old, new)))
                continue
            new = out_arg.ids if _is_int_carry(old) else out_arg.value
            frozen = torch.where(_keep(keep, old), old, new.to(old.dtype))
            new_carries.append(frozen.index_select(0, flat_sel))
        carries = new_carries
        finished = torch.gather(finished, 1, beam_idx)
        lens = torch.gather(lens, 1, beam_idx)
        history = torch.gather(history, 1, beam_idx[:, :, None].expand(B, K, L))
        history[:, :, t] = torch.where(finished, eos, token)
        lens = torch.where(finished, lens, lens + 1)
        finished = finished | (token == eos)
        if in_lengths is not None:
            # an in-link bounds the generation: a sample ends with its last
            # input frame even without eos
            finished = finished | ((t + 1) >= in_lengths[:, None])
        prev_tok, cum = token.reshape(-1), top_scores
        t += 1
        BEAM_STEPS += 1

    # best beam per sample (top-K keeps the beams sorted; the pick is by
    # score all the same, the first maximum as jnp.argmax)
    best = torch.argmax(cum, dim=1)
    best_tokens = torch.gather(history, 1, best[:, None, None].expand(B, 1, L))[:, 0]
    best_lens = torch.gather(lens, 1, best[:, None])[:, 0]
    ctx.outputs[cfg.name] = Argument(ids=best_tokens, seq_lengths=best_lens)
    ctx.outputs[f"{cfg.name}@beams"] = Argument(
        ids=history, value=cum, sub_seq_lengths=lens,
        seq_lengths=torch.full((B,), K, dtype=torch.int32, device=device))
    ctx.outputs[score_layer] = ctx.outputs[cfg.name]


def beams_of(outputs: Dict[str, Argument], group: str):
    """A generator group's beams from its ``@beams`` output, as numpy: ids
    [B, K, L], scores [B, K] and lengths [B, K]."""
    beams = outputs[f"{group}@beams"]
    return (beams.ids.cpu().numpy(), beams.value.cpu().numpy(),
            beams.sub_seq_lengths.cpu().numpy())
