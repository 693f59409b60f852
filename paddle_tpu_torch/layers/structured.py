"""Structured-prediction layers: linear-chain CRF (crf, crf_decoding), CTC,
LambdaRank (lambda_cost) and selective fc.

Port of ``paddle_tpu/layers/structured.py``:
- the CRF parameter is [C+2, C]: row 0 the start weights a, row 1 the end
  weights b, rows 2.. the transitions w, so that
  P(s) ∝ exp(a_{s1} + b_{sL} + Σ x_{t,s_t} + Σ w_{s_{t-1}, s_t});
- crf_decoding is Viterbi, and with a label input it also gives each
  step's 0/1 mismatch;
- ctc's blank is num_classes - 1 and ``norm_by_times`` divides a
  sequence's cost by its length;
- lambda_cost's value is -NDCG@K, and its gradient the LambdaRank
  pairwise surrogate's, spliced in with a detached copy;
- selective fc is fc restricted to each row's selected columns.

The recursions are eager loops over the padded time axis with per-row
length masks, where the JAX package runs ``lax.scan``: T small launches a
layer on the card. Autograd through them gives the gradients.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from paddle_tpu_torch.graph.argument import Argument
from paddle_tpu_torch.layers.base import LayerContext, register_layer
from paddle_tpu_torch.layers.cost import _finish_cost
from paddle_tpu_torch.ops.activations import apply_activation
from paddle_tpu_torch.ops.precision import hp
from paddle_tpu_torch.proto import LayerConfig

Tensor = torch.Tensor
NEG = -1e30


def _crf_weights(param: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Split the [C+2, C] CRF parameter into (start a, end b, transitions w)."""
    return param[0], param[1], param[2:]


def _length_mask(lengths: Tensor, T: int) -> Tensor:
    return torch.arange(T, device=lengths.device)[None, :] < lengths[:, None]   # [B, T]


def crf_log_likelihood(x: Tensor, labels: Tensor, lengths: Tensor, param: Tensor) -> Tensor:
    """Per-sequence negative log likelihood [B]: x [B, T, C], labels [B, T],
    lengths [B], param [C+2, C]."""
    a, b, w = _crf_weights(param)
    B, T, C = x.shape
    labels = labels.long()
    lengths = lengths.long()
    mask = _length_mask(lengths, T)
    zero = x.new_zeros(())
    # the gold path's score
    emit = torch.gather(x, 2, labels[..., None])[..., 0]                  # [B, T]
    trans = w[labels[:, :-1], labels[:, 1:]]                              # [B, T-1]
    last = torch.gather(labels, 1, torch.clamp(lengths - 1, 0, T - 1)[:, None])[:, 0]
    gold = (torch.where(mask, emit, zero).sum(1) + torch.where(mask[:, 1:], trans, zero).sum(1)
            + a[labels[:, 0]] + b[last])
    # log Z by the forward recursion, held past each length
    alpha = a[None] + x[:, 0]
    for t in range(1, T):
        new = torch.logsumexp(alpha[:, :, None] + w[None], dim=1) + x[:, t]
        alpha = torch.where(mask[:, t, None], new, alpha)
    return torch.logsumexp(alpha + b[None], dim=1) - gold


def crf_decode(x: Tensor, lengths: Tensor, param: Tensor) -> Tensor:
    """Viterbi path [B, T] int32 (0 at padded steps): x [B, T, C], lengths [B]."""
    a, b, w = _crf_weights(param)
    B, T, C = x.shape
    lengths = lengths.long()
    mask = _length_mask(lengths, T)
    delta = a[None] + x[:, 0]
    deltas, tracks = [delta], []
    for t in range(1, T):
        scores = delta[:, :, None] + w[None]                              # [B, C_prev, C]
        # tracks[t-1][b, s_t] = the best s_{t-1} (the lowest among ties)
        tracks.append(torch.argmax(scores, dim=1))
        delta = torch.where(mask[:, t, None], torch.amax(scores, dim=1) + x[:, t], delta)
        deltas.append(delta)
    # the best end state at each step, for the sequences that end there
    end_choice = torch.argmax(torch.stack(deltas, dim=1) + b[None, None], dim=2)   # [B, T]
    rows = torch.arange(B, device=x.device)
    cur = torch.zeros(B, dtype=torch.long, device=x.device)
    path = [None] * T
    for t in range(T - 1, -1, -1):
        from_next = tracks[t][rows, cur] if t < T - 1 else cur
        cur = torch.where(t == lengths - 1, end_choice[:, t],
                          torch.where(t < lengths - 1, from_next, torch.zeros_like(cur)))
        path[t] = cur
    path = torch.stack(path, dim=1)
    return torch.where(mask, path, torch.zeros_like(path)).int()


@register_layer("crf")
def crf_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    feats, label = inputs[0], inputs[1]
    weight = inputs[2] if len(inputs) > 2 else None
    # the recursions are logsumexp chains: float32 even for bf16 features,
    # and the transitions are read in the master dtype
    nll = crf_log_likelihood(hp(feats.value), label.ids, feats.seq_lengths,
                             ctx.param(cfg.inputs[0].input_parameter_name, cast=False))
    # already reduced over time: a non-sequence view takes only coeff and weight
    return _finish_cost(cfg, nll, Argument(value=nll), weight)


@register_layer("crf_decoding")
def crf_decoding_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    feats = inputs[0]
    path = crf_decode(hp(feats.value), feats.seq_lengths,
                      ctx.param(cfg.inputs[0].input_parameter_name, cast=False))
    if len(inputs) == 1:
        return Argument(ids=path, seq_lengths=feats.seq_lengths)
    # with a label: each step's 0/1 mismatch
    err = (path != inputs[1].ids).to(torch.float32) * feats.seq_mask()
    return Argument(ids=path, value=err[..., None], seq_lengths=feats.seq_lengths)


def ctc_loss(log_probs: Tensor, in_lengths: Tensor, labels: Tensor, label_lengths: Tensor,
             blank: int) -> Tensor:
    """Per-sequence CTC negative log likelihood [B]: log_probs [B, T, C],
    in_lengths [B], labels [B, S] (no blanks), label_lengths [B]. The
    alpha recursion (Graves 2006) in log space over the extended sequence
    blank, l1, blank, l2, ..., blank of length 2S + 1."""
    B, T, C = log_probs.shape
    S = labels.shape[1]
    U = 2 * S + 1
    dev = log_probs.device
    label_lengths = label_lengths.long()
    u = torch.arange(U, device=dev)
    # even u: blank; odd u: labels[(u - 1) / 2]
    ext = torch.where(u % 2 == 1, labels.long()[:, torch.clamp((u - 1) // 2, 0, S - 1)],
                      torch.full_like(u, blank))                          # [B, U]
    u_valid = u[None, :] < 2 * label_lengths[:, None] + 1
    # the skip from u - 2 where ext[u] is a label unlike ext[u - 2]
    ext_m2 = torch.cat([torch.full((B, 2), -1, device=dev, dtype=ext.dtype), ext[:, :-2]], 1)
    can_skip = (u[None, :] % 2 == 1) & (ext != ext_m2)
    mask = _length_mask(in_lengths.long(), T)
    neg = log_probs.new_full((), NEG)
    neg1, neg2 = log_probs.new_full((B, 1), NEG), log_probs.new_full((B, 2), NEG)
    alpha = torch.where((u[None, :] <= 1) & u_valid, torch.gather(log_probs[:, 0], 1, ext), neg)
    for t in range(1, T):
        a_m1 = torch.cat([neg1, alpha[:, :-1]], 1)
        a_m2 = torch.where(can_skip, torch.cat([neg2, alpha[:, :-2]], 1), neg)
        merged = (torch.logsumexp(torch.stack([alpha, a_m1, a_m2]), dim=0)
                  + torch.gather(log_probs[:, t], 1, ext))
        alpha = torch.where(mask[:, t, None], torch.where(u_valid, merged, neg), alpha)
    u_last = 2 * label_lengths                                            # the final blank
    a_last = torch.gather(alpha, 1, u_last[:, None])[:, 0]
    a_prev = torch.gather(alpha, 1, torch.clamp(u_last - 1, 0, U - 1)[:, None])[:, 0]
    a_prev = torch.where(label_lengths > 0, a_prev, neg)
    return -torch.logaddexp(a_last, a_prev)


@register_layer("ctc")
def ctc_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    # input 0: softmax probabilities [B, T, C]; input 1: the label ids;
    # blank = size - 1
    probs, label = inputs[0], inputs[1]
    log_p = torch.log(torch.clamp(hp(probs.value), min=1e-10))
    cost = ctc_loss(log_p, probs.seq_lengths, label.ids, label.seq_lengths, blank=cfg.size - 1)
    if cfg.norm_by_times:
        cost = cost / torch.clamp(probs.seq_lengths.to(cost.dtype), min=1.0)
    return _finish_cost(cfg, cost, Argument(value=cost), None)


def _descending_ranks(scores: Tensor) -> Tuple[Tensor, Tensor]:
    """(order, rank): the items by score descending, ties in index order,
    and each item's place in that order."""
    order = torch.sort(-scores, dim=1, stable=True).indices
    rank = torch.sort(order, dim=1, stable=True).indices
    return order, rank


def _ndcg_at_k(scores: Tensor, rels: Tensor, mask: Tensor, k: int):
    """NDCG@k [B], each item's discount at its rank [B, T], and IDCG [B]."""
    neg = torch.where(mask, scores, scores.new_full((), NEG))
    order, rank = _descending_ranks(neg)
    rels_m = torch.where(mask, rels, torch.zeros_like(rels))
    pos = torch.arange(scores.shape[1], device=scores.device, dtype=scores.dtype)
    disc = torch.where(pos < k, 1.0 / torch.log2(pos + 2.0), torch.zeros_like(pos))[None]
    dcg = torch.sum((2.0 ** torch.gather(rels_m, 1, order) - 1.0) * disc, dim=1)
    idcg = torch.sum((2.0 ** torch.sort(rels_m, dim=1, descending=True).values - 1.0) * disc,
                     dim=1)
    ndcg = torch.where(idcg > 0, dcg / torch.clamp(idcg, min=1e-10), torch.zeros_like(dcg))
    rank = rank.to(scores.dtype)
    rank_disc = torch.where(rank < k, 1.0 / torch.log2(rank + 2.0), torch.zeros_like(rank))
    return ndcg, rank_disc, idcg


@register_layer("lambda_cost")
def lambda_cost_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    # inputs: model scores and relevance scores, sequences of width 1
    out, score = inputs[0], inputs[1]
    s, r = hp(out.value)[..., 0], hp(score.value)[..., 0].detach()       # [B, T]
    mask = out.seq_mask() > 0
    ndcg, disc, idcg = _ndcg_at_k(s.detach(), r, mask, cfg.NDCG_num or 5)
    pair = (mask[:, :, None] & mask[:, None, :]).to(s.dtype)
    better = ((r[:, :, None] - r[:, None, :]) > 0).to(s.dtype) * pair
    gain = 2.0 ** r - 1.0
    # |ΔNDCG| of swapping i and j at their current ranks
    dg = torch.abs((gain[:, :, None] - gain[:, None, :]) * (disc[:, :, None] - disc[:, None, :])
                   ) / torch.clamp(idcg, min=1e-10)[:, None, None]
    s_diff = s[:, :, None] - s[:, None, :]
    surrogate = torch.sum((better * dg) * torch.logaddexp(torch.zeros_like(s_diff), -s_diff),
                          dim=(1, 2))
    cost = -ndcg + (surrogate - surrogate.detach())
    return _finish_cost(cfg, cost, Argument(value=cost), None)


@register_layer("selective_fc")
def selective_fc_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    # the inputs with a parameter are data; a trailing one without is the
    # selected column ids (zero-padded rows of a sequence of ids); with no
    # selection the layer is fc
    n_data = sum(1 for ic in cfg.inputs if ic.input_parameter_name)
    acc: Optional[Tensor] = None
    for ic, arg in zip(cfg.inputs[:n_data], inputs[:n_data]):
        y = arg.value @ ctx.param(ic.input_parameter_name)
        acc = y if acc is None else acc + y
    if cfg.bias_parameter_name:
        acc = acc + ctx.param(cfg.bias_parameter_name)
    sel = inputs[n_data] if len(inputs) > n_data else None
    meta = inputs[0]
    if sel is None or sel.ids is None:
        value = apply_activation(cfg.active_type, acc, None)
    else:
        ids = sel.ids.long().reshape(acc.shape[0], -1)                   # [B, K]
        if sel.seq_lengths is not None:
            valid = _length_mask(sel.seq_lengths.long(), ids.shape[1]).to(acc.dtype)
        else:
            valid = torch.ones(ids.shape, dtype=acc.dtype, device=acc.device)
        m = acc.new_zeros(acc.shape).scatter_reduce(1, ids, valid, reduce="amax")
        if cfg.active_type in ("softmax", "sequence_softmax"):
            value = torch.softmax(torch.where(m > 0, acc, acc.new_full((), NEG)), dim=-1) * m
        else:
            value = apply_activation(cfg.active_type, acc, None) * m
    return Argument(value=value, seq_lengths=meta.seq_lengths,
                    sub_seq_lengths=meta.sub_seq_lengths)
