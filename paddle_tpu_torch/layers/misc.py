"""Elementwise and miscellaneous layers: interpolation, power, scaling,
slope_intercept, sum_to_one_norm, convex_comb, cos, cos_vm, out_prod,
conv_shift, multiplex, data_norm, and the hsigmoid and nce costs.

Port of ``paddle_tpu/layers/misc.py``. hsigmoid and nce gather the rows
of their classes' table that a sample's path or samples need ([B, L, D])
and never form the full [V, D] product.
"""

from __future__ import annotations

from typing import List

import torch

from paddle_tpu_torch.graph.argument import Argument
from paddle_tpu_torch.layers.base import (
    LayerContext,
    first_seq_meta,
    register_layer,
    with_seq_meta,
)
from paddle_tpu_torch.ops.precision import hp
from paddle_tpu_torch.proto import LayerConfig

Tensor = torch.Tensor
_EPS = 1e-10


@register_layer("interpolation")
def interpolation_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    # out = w * x + (1 - w) * y; w is [B, 1]
    w, x, y = inputs[0].value, inputs[1].value, inputs[2].value
    return with_seq_meta(first_seq_meta(inputs[1:]), w * x + (1.0 - w) * y)


@register_layer("power")
def power_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    # out = x ^ w; w is [B, 1], one exponent a sample
    w, x = inputs[0].value, inputs[1].value
    return with_seq_meta(inputs[1], torch.pow(torch.clamp(x, min=_EPS), w))


@register_layer("scaling")
def scaling_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    # out = w * x ; w is [B, 1] (or [B, T, 1] per step) scale
    w, x = inputs[0].value, inputs[1].value
    return with_seq_meta(inputs[1], w * x)


@register_layer("slope_intercept")
def slope_intercept_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    return with_seq_meta(inputs[0], cfg.slope * inputs[0].value + cfg.intercept)


@register_layer("sum_to_one_norm")
def sum_to_one_norm_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    x = inputs[0].value
    s = torch.sum(x, dim=-1, keepdim=True)
    return with_seq_meta(inputs[0], x / torch.where(torch.abs(s) < _EPS, torch.ones_like(s), s))


@register_layer("convex_comb")
def convex_comb_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    # inputs (weights [B, M], vectors [B, M*size]): out[b] = sum_m w[b,m] v[b,m,:]
    w, v = inputs[0].value, inputs[1].value
    vv = v.reshape(v.shape[0], w.shape[-1], cfg.size)
    return Argument(value=torch.einsum("bm,bmd->bd", w, vv))


@register_layer("cos")
def cos_sim_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    x, y = inputs[0].value, inputs[1].value
    dot = torch.sum(x * y, dim=-1, keepdim=True)
    norms = torch.linalg.vector_norm(x, dim=-1, keepdim=True) * \
        torch.linalg.vector_norm(y, dim=-1, keepdim=True)
    return with_seq_meta(first_seq_meta(inputs),
                         cfg.cos_scale * dot / torch.clamp(norms, min=_EPS))


@register_layer("cos_vm")
def cos_vec_mat_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    # the cosine of x [B, D] against each of the K rows of m [B, K*D]
    x, m = inputs[0].value, inputs[1].value
    mm = m.reshape(m.shape[0], cfg.size, x.shape[-1])
    dot = torch.einsum("bd,bkd->bk", x, mm)
    norms = torch.linalg.vector_norm(x, dim=-1, keepdim=True) * \
        torch.linalg.vector_norm(mm, dim=-1)
    return Argument(value=cfg.cos_scale * dot / torch.clamp(norms, min=_EPS))


@register_layer("out_prod")
def outer_prod_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    x, y = inputs[0].value, inputs[1].value
    return Argument(value=(x[:, :, None] * y[:, None, :]).reshape(x.shape[0], -1))


@register_layer("conv_shift")
def conv_shift_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    # circular convolution (the NTM shift): out[i] = sum_j a[(i + j - (K-1)/2) mod D] b[j]
    a, b = inputs[0].value, inputs[1].value
    D, K = a.shape[-1], b.shape[-1]
    dev = a.device
    idx = (torch.arange(D, device=dev)[:, None] + torch.arange(K, device=dev)[None, :]
           - (K - 1) // 2) % D                                         # [D, K]
    return Argument(value=torch.einsum("bdk,bk->bd", a[:, idx], b))


@register_layer("multiplex")
def multiplex_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    # the first input's ids choose which of the others gives each row
    sel = inputs[0].ids.long()
    stacked = torch.stack([a.value for a in inputs[1:]], dim=0)        # [N, B, D]
    rows = torch.arange(sel.shape[0], device=sel.device)
    return Argument(value=stacked[sel, rows])


@register_layer("data_norm")
def data_norm_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    # features normalised by statistics held in the (static) input
    # parameter, rows min, max, sum, sum of squares, count
    x = inputs[0].value
    mn, mx, sm, ssq, cnt = ctx.param(cfg.inputs[0].input_parameter_name).reshape(5, cfg.size)
    cnt = torch.clamp(cnt, min=1.0)
    mean = sm / cnt
    strat = cfg.data_norm_strategy
    if strat == "z-score":
        out = (x - mean) / torch.sqrt(torch.clamp(ssq / cnt - mean * mean, min=_EPS))
    elif strat == "min-max":
        out = (x - mn) / torch.clamp(mx - mn, min=_EPS)
    else:                                                  # decimal-scaling
        digits = torch.ceil(torch.log10(torch.clamp(torch.abs(mx), min=1.0)))
        out = x / torch.clamp(torch.pow(10.0, digits), min=1.0)
    return with_seq_meta(inputs[0], out)


def _label_of(label: Argument) -> Tensor:
    return (label.ids if label.ids is not None else torch.argmax(label.value, -1)).long()


@register_layer("hsigmoid")
def hsigmoid_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    """Hierarchical sigmoid cost: the binary code of class c is the bits of
    c + num_classes below its top bit; bit j's node is
    ((c + num_classes) >> (j + 1)) - 1, and each node on the path adds the
    binary cross-entropy of its bit."""
    label, feats = inputs[-1], inputs[:-1]
    n = cfg.num_classes
    code = _label_of(label) + n
    js = torch.arange(max(1, (n - 1).bit_length()), device=code.device)
    node = (code[:, None] >> (js[None, :] + 1)) - 1                    # [B, L]
    bit = ((code[:, None] >> js[None, :]) & 1).to(torch.float32)
    node_c = torch.clamp(node, 0, n - 2)
    acc = None
    for in_cfg, f in zip(cfg.inputs[:-1], feats):
        # the path rows gathered from the master-dtype table (casting the
        # whole table would be a full pass); the cost is a float32 island
        w = ctx.param(in_cfg.input_parameter_name, cast=False)
        y = torch.einsum("bd,bld->bl", hp(f.value), w[node_c])
        acc = y if acc is None else acc + y
    if cfg.bias_parameter_name:
        acc = acc + ctx.param(cfg.bias_parameter_name, cast=False).reshape(-1)[node_c]
    per_node = torch.logaddexp(torch.zeros_like(acc), acc) - bit * acc
    cost = torch.sum(torch.where(node >= 0, per_node, torch.zeros_like(per_node)), dim=1)
    return Argument(value=cost[:, None])


def nce_negatives(cfg: LayerConfig, B: int, ctx: LayerContext, device) -> Tensor:
    """The [B, num_neg_samples] negative classes of one nce layer, from
    neg_sampling_dist (or uniform) with the layer's own generator."""
    gen = ctx.layer_generator(cfg.name, "nce", device)
    k = cfg.num_neg_samples
    if cfg.neg_sampling_dist:
        dist = torch.clamp(torch.tensor(list(cfg.neg_sampling_dist), dtype=torch.float32,
                                        device=device), min=_EPS)
        return torch.multinomial(dist, B * k, replacement=True, generator=gen).reshape(B, k)
    return torch.randint(0, cfg.num_classes, (B, k), generator=gen, device=device)


def nce_cost(cfg: LayerConfig, feats: List[Argument], pos: Tensor, neg: Tensor,
             ctx: LayerContext) -> Tensor:
    """Per-sample NCE cost [B] of the true classes pos [B] against the
    negatives neg [B, k]: the logistic loss of telling each class's logit
    minus log(k P_noise) apart, data against noise."""
    B, k = neg.shape
    samples = torch.cat([pos[:, None], neg], dim=1)                    # [B, 1+k]
    acc = None
    for in_cfg, f in zip(cfg.inputs[:len(feats)], feats):
        # sampled rows from the master-dtype table: nce's point is to avoid
        # O(vocab) work, so the table is never cast whole
        w = ctx.param(in_cfg.input_parameter_name, cast=False)
        y = torch.einsum("bd,bkd->bk", hp(f.value), w[samples])
        acc = y if acc is None else acc + y
    if cfg.bias_parameter_name:
        acc = acc + ctx.param(cfg.bias_parameter_name, cast=False).reshape(-1)[samples]
    if cfg.neg_sampling_dist:
        p_noise = torch.tensor(list(cfg.neg_sampling_dist), dtype=acc.dtype,
                               device=acc.device)[samples]
    else:
        p_noise = torch.full_like(acc, 1.0 / cfg.num_classes)
    delta = acc - torch.log(k * torch.clamp(p_noise, min=_EPS))
    per = torch.logaddexp(torch.zeros_like(delta), delta)
    per = torch.cat([per[:, :1] - delta[:, :1], per[:, 1:]], dim=1)
    return torch.sum(per, dim=1)


@register_layer("nce")
def nce_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    """Noise-contrastive estimation cost: features (the inputs with a
    parameter), the label, an optional per-sample weight."""
    n_feat = sum(1 for ic in cfg.inputs if ic.input_parameter_name)
    feats, label = inputs[:n_feat], inputs[n_feat]
    weight = inputs[n_feat + 1] if len(inputs) > n_feat + 1 else None
    pos = _label_of(label)
    cost = nce_cost(cfg, feats, pos, nce_negatives(cfg, pos.shape[0], ctx, pos.device), ctx)
    if weight is not None and weight.value is not None:
        cost = cost * weight.value.reshape(cost.shape)
    return Argument(value=cost[:, None])
