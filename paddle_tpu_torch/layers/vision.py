"""Vision layers: conv, pool, batch norm and cross-map norm over NHWC
tensors, blockexpand, featmap_expand, resize, and the mixed layer's conv
operator.

Port of ``paddle_tpu/layers/vision.py``. The data contract is the JAX package's: images
flow between layers as flat NCHW rows [B, C*H*W], and the conv family
publishes its output's contiguous NHWC tensor in ``LayerContext.nhwc`` and
prefers consuming it. Where XLA drops a flat value that nobody reads, eager
PyTorch would copy every layer's output into NCHW order; so the conv family
returns an :class:`ImageArgument`, which builds its flat value only when a
consumer reads it (in ResNet only the fc after the global pool, where the
map is 1x1 and the flat value a view).

Convolutions go to ``F.conv2d`` on the channels_last view of the NHWC
tensor, so cuDNN reads and writes NHWC and the output's permuted view is
contiguous. With ``conv_stats_mode="pallas"`` a 1x1 stride-1 conv in a
training pass runs kernel 9 (``ops/fused_conv1x1_bn.py``) and publishes
its output's per-channel sum and sum of squares in
``LayerContext.conv_stats``; ``"gram"`` publishes the same statistics
from input-side algebra in plain PyTorch. A downstream batch norm takes
them instead of reducing the activation.

Weight layout (set by the config DSL): conv filters are stored flat as
[num_filters, filter_channels * fh * fw], which is OIHW.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch.graph.argument import Argument
from paddle_tpu_torch.layers.base import LayerContext, apply_dropout, register_layer
from paddle_tpu_torch.ops.activations import apply_activation, is_elementwise
from paddle_tpu_torch.ops import fused_conv1x1_bn
from paddle_tpu_torch.ops.precision import hp
from paddle_tpu_torch.ops.fused_conv1x1_bn import conv1x1_stats
from paddle_tpu_torch.proto import LayerConfig

Tensor = torch.Tensor


def _nchw_to_nhwc(x: Tensor, channels: int, h: int, w: int) -> Tensor:
    return x.reshape(x.shape[0], channels, h, w).permute(0, 2, 3, 1).contiguous()


def _nhwc_to_flat(x: Tensor) -> Tensor:
    return x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)


class ImageArgument(Argument):
    """The Argument of a conv-family layer. It holds the layer's [B, H, W, C]
    output and builds the flat NCHW value [B, C*H*W] on first read."""

    def __init__(self, nhwc: Tensor):
        super().__init__()
        self.nhwc = nhwc

    @property
    def value(self) -> Tensor:
        if self._flat is None:
            self._flat = _nhwc_to_flat(self.nhwc)
        return self._flat

    @value.setter
    def value(self, v: Optional[Tensor]) -> None:
        self._flat = v

    @property
    def flat_built(self) -> bool:
        return self._flat is not None

    @property
    def batch_size(self) -> int:
        return self.nhwc.shape[0]

    def __repr__(self) -> str:
        return f"ImageArgument(nhwc={tuple(self.nhwc.shape)}, flat_built={self.flat_built})"


def _take_nhwc(ctx: LayerContext, input_layer_name: str, arg: Argument, channels: int,
               h: int, w: int) -> Tensor:
    """The producer's published NHWC tensor when shapes agree, else convert
    from the flat NCHW value (one copy, as the JAX package's transpose)."""
    x = ctx.nhwc.get(input_layer_name)
    if x is not None and tuple(x.shape[1:]) == (h, w, channels):
        return x
    return _nchw_to_nhwc(arg.value, channels, h, w)


def _publish_nhwc(ctx: LayerContext, cfg: LayerConfig, y_nhwc: Tensor) -> Argument:
    ctx.nhwc[cfg.name] = y_nhwc
    return ImageArgument(y_nhwc)


def _conv2d(x_nhwc: Tensor, w_oihw: Tensor, stride: Tuple[int, int],
            padding: Tuple[int, int], groups: int) -> Tensor:
    """NHWC in, NHWC out: cuDNN (or the CPU's conv) sees the channels_last
    view and answers in channels_last, so the result is a contiguous NHWC
    tensor when the input is one."""
    y = F.conv2d(x_nhwc.permute(0, 3, 1, 2), w_oihw, stride=stride, padding=padding,
                 groups=groups)
    return y.permute(0, 2, 3, 1)


def _stem_s2d_conv(x: Tensor, w_oihw: Tensor) -> Tensor:
    """Space-to-depth rewrite of the 7x7/stride-2/pad-3 few-channel stem conv
    (the ResNet conv1), exactly as the JAX package's ``_stem_s2d_conv``: a
    4x4/stride-1 VALID conv over a 2x2 space-to-depth view with 4C input
    channels. With x padded (4, 2) per spatial dim and the kernel
    zero-padded 7 -> 8 at the front, y[i,j] = sum_{u',v'<8} w'[u',v']
    xp[2i+u', 2j+v']; u' = 2a+c turns the sum into a 4x4 conv over
    X[i,j,(c,d,ch)] = xp[2i+c, 2j+d, ch]."""
    B, H, W, C = x.shape
    O = w_oihw.shape[0]
    xp = F.pad(x, (0, 0, 4, 2, 4, 2))
    Hp, Wp = H + 6, W + 6
    X = (xp.reshape(B, Hp // 2, 2, Wp // 2, 2, C)
         .permute(0, 1, 3, 2, 4, 5)
         .reshape(B, Hp // 2, Wp // 2, 4 * C))
    w_hwio = w_oihw.permute(2, 3, 1, 0)
    w8 = F.pad(w_hwio, (0, 0, 0, 0, 1, 0, 1, 0))          # 7 -> 8, zero row/col first
    w4 = (w8.reshape(4, 2, 4, 2, C, O)
          .permute(0, 2, 1, 3, 4, 5)
          .reshape(4, 4, 4 * C, O))
    return _conv2d(X, w4.permute(3, 2, 0, 1), (1, 1), (0, 0), 1)


def _stem_s2d_applies(ctx, cc, fy, sy, py, h, w) -> bool:
    return (ctx.conv_s2d and cc.channels <= 4 and fy == cc.filter_size == 7
            and sy == cc.stride == 2 and py == cc.padding == 3 and cc.groups == 1
            and h % 2 == 0 and w % 2 == 0)


def _fused_stats_gates(cfg: LayerConfig, ctx: LayerContext, allow_stride: bool = False):
    """Shared gate of both fused conv + BN-statistics modes: a single-input
    1x1/p0 ungrouped conv whose output is exactly what a downstream batch
    norm would reduce (identity activation, no dropout, shared or no bias),
    in a training pass. Returns the conv input config, or None.
    ``allow_stride`` admits strided 1x1 convs under caffe-mode output
    sizing, where the output rows are exactly the ::s input positions."""
    if not ctx.is_training or len(cfg.inputs) != 1:
        return None
    in_cfg = cfg.inputs[0]
    cc = in_cfg.conv_conf
    fy = cc.filter_size_y or cc.filter_size
    sy = cc.stride_y or cc.stride
    py = cc.padding_y if cc.padding_y >= 0 else cc.padding
    stride_ok = (sy == 1 and cc.stride == 1
                 or (allow_stride and cc.caffe_mode and sy >= 1 and cc.stride >= 1))
    if not (fy == 1 and cc.filter_size == 1 and stride_ok
            and py == 0 and cc.padding == 0 and cc.groups == 1):
        return None
    if cfg.active_type not in ("", "linear") or cfg.drop_rate > 0.0:
        return None
    if cfg.bias_parameter_name and not cfg.shared_biases:
        return None
    return in_cfg


def _conv1x1_stats_forward(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext):
    """A 1x1/s1 conv through kernel 9: publishes (sum, sumsq, rows) of its
    output into ctx.conv_stats. None when the layer gate refuses the layer,
    or when ``fused_conv1x1_bn.supported(M, K, N)`` refuses its shape (then
    counted in ``fused_conv1x1_bn.EAGER_ROUTES``): the caller runs the plain
    conv and the batch norm reduces its output, as the JAX package does for
    a shape ``pcb.supported`` refuses. Unlike the JAX package there is no
    device or mesh gate: the CPU runs the kernel's plain version."""
    in_cfg = _fused_stats_gates(cfg, ctx)
    if in_cfg is None:
        return None
    cc = in_cfg.conv_conf
    h = w = cc.img_size
    x = _take_nhwc(ctx, in_cfg.input_layer_name, inputs[0], cc.channels, h, w)
    B = x.shape[0]
    M, K, N = B * h * w, cc.channels, cfg.num_filters
    if not fused_conv1x1_bn.supported(M, K, N):
        fused_conv1x1_bn.EAGER_ROUTES += 1
        return None
    wf = ctx.param(in_cfg.input_parameter_name).reshape(N, K)
    # b in x's dtype, as the JAX layer casts it (None: the kernel adds no bias)
    b = (ctx.param(cfg.bias_parameter_name).reshape(N).to(x.dtype)
         if cfg.bias_parameter_name else None)
    # view, not reshape: a non-contiguous activation raises here instead of
    # being copied behind the caller's back
    y2, s, q = conv1x1_stats(x.view(M, K), wf, b)
    ctx.conv_stats[cfg.name] = (s, q, M)
    return _publish_nhwc(ctx, cfg, y2.view(B, h, w, N))


def _gram_stats_gates(cfg: LayerConfig, ctx: LayerContext):
    """The shared gate plus the width ratio at which input-side statistics
    read fewer bytes than the output: N >= 2K at stride 1, N >= 4K strided
    (the JAX package's derivation in ``_gram_stats_gates``)."""
    in_cfg = _fused_stats_gates(cfg, ctx, allow_stride=True)
    if in_cfg is None:
        return None
    cc = in_cfg.conv_conf
    strided = cc.stride_y > 1 or cc.stride > 1
    need = 4 if strided else 2
    if cfg.num_filters < need * cc.channels:
        return None
    return in_cfg


def _publish_gram_stats(cfg: LayerConfig, ctx: LayerContext, x_nhwc: Tensor,
                        w2: Tensor, bias: Optional[Tensor]) -> None:
    """Per-channel sum and sumsq of y = x·w + b from the input side:

        sum_m(y)   = colsum(x)·w + M·b
        sum_m(y^2) = diag(wᵀ (xᵀx) w) + 2·b·(colsum(x)·w) + M·b²
    """
    C = x_nhwc.shape[-1]
    M = x_nhwc.shape[0] * x_nhwc.shape[1] * x_nhwc.shape[2]
    xr = x_nhwc.reshape(M, C)
    cs = xr.sum(0)                                        # [K]
    gram = xr.t() @ xr                                    # [K, K]
    csw = cs @ w2                                         # [N]
    s = csw
    q = torch.einsum("kn,kl,ln->n", w2, gram, w2)
    if bias is not None:
        s = s + M * bias
        q = q + 2.0 * bias * csw + M * bias * bias
    ctx.conv_stats[cfg.name] = (s, q, M)


@register_layer("conv", "exconv", "cudnn_conv")
def conv_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    if ctx.conv_stats_mode == "pallas":
        out = _conv1x1_stats_forward(cfg, inputs, ctx)
        if out is not None:
            return out
    gram_in = _gram_stats_gates(cfg, ctx) if ctx.conv_stats_mode == "gram" else None
    acc = None
    for in_cfg, arg in zip(cfg.inputs, inputs):
        cc = in_cfg.conv_conf
        h = w = cc.img_size
        fy = cc.filter_size_y or cc.filter_size
        sy = cc.stride_y or cc.stride
        py = cc.padding_y if cc.padding_y >= 0 else cc.padding
        x = _take_nhwc(ctx, in_cfg.input_layer_name, arg, cc.channels, h, w)
        wf = ctx.param(in_cfg.input_parameter_name).reshape(
            cfg.num_filters, cc.filter_channels, fy, cc.filter_size)
        if gram_in is not None:
            # a strided 1x1/p0 conv reads only the ::s positions, so the
            # statistics of the sliced input are exact
            x_stats = x[:, ::sy, ::cc.stride, :] if (sy > 1 or cc.stride > 1) else x
            gram_operands = (x_stats, wf.reshape(cfg.num_filters, cc.channels).t())
        if _stem_s2d_applies(ctx, cc, fy, sy, py, h, w):
            y = _stem_s2d_conv(x, wf)
        else:
            y = _conv2d(x, wf, (sy, cc.stride), (py, cc.padding), cc.groups)
        acc = y if acc is None else acc + y
    if gram_in is not None:
        bias = (ctx.param(cfg.bias_parameter_name).reshape(cfg.num_filters)
                if cfg.bias_parameter_name else None)
        _publish_gram_stats(cfg, ctx, *gram_operands, bias)
    if cfg.bias_parameter_name:
        b = ctx.param(cfg.bias_parameter_name)
        if cfg.shared_biases:
            acc = acc + b.reshape(1, 1, 1, cfg.num_filters)
        else:
            # the flat layout is filter-major [F, H, W] (the reference's
            # addUnsharedBias over NCHW rows)
            acc = acc + b.reshape(cfg.num_filters, acc.shape[1], acc.shape[2]).permute(1, 2, 0)
    if not is_elementwise(cfg.active_type):
        out = apply_activation(cfg.active_type, _nhwc_to_flat(acc))
        return Argument(value=apply_dropout(cfg, out, ctx))
    acc = apply_dropout(cfg, apply_activation(cfg.active_type, acc), ctx)
    return _publish_nhwc(ctx, cfg, acc)


def _axis_counts(n_out: int, stride: int, pad: int, k: int, img: int) -> np.ndarray:
    """In-image elements of each window along one axis."""
    starts = np.arange(n_out) * stride - pad
    return np.clip(np.minimum(starts + k, img) - np.maximum(starts, 0), 0, None)


@register_layer("pool")
def pool_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    pc = cfg.inputs[0].pool_conf
    h = pc.img_size_y or pc.img_size
    w = pc.img_size
    ky = pc.size_y or pc.size_x
    sy = pc.stride_y or pc.stride
    py = pc.padding_y or pc.padding
    x = _take_nhwc(ctx, cfg.inputs[0].input_layer_name, inputs[0], pc.channels, h, w)
    # the config declares ceil-mode output sizes (reference outputSize with
    # caffeMode=false): extend the high-edge padding so the last window fits
    oy = pc.output_y or pc.output_x
    ox = pc.output_x
    hi_y = max(0, (oy - 1) * sy + ky - h - py)
    hi_x = max(0, (ox - 1) * pc.stride + pc.size_x - w - pc.padding)
    pads = (pc.padding, hi_x, py, hi_y)                   # F.pad order: W, then H
    counts_np = np.outer(_axis_counts(oy, sy, py, ky, h),
                         _axis_counts(ox, pc.stride, pc.padding, pc.size_x, w))
    xc = x.permute(0, 3, 1, 2)                            # channels_last view
    if "max" in pc.pool_type:
        # explicit -inf padding: F.max_pool2d refuses padding above half
        # the window, and a ceil-mode window may lie wholly in the padding
        y = F.max_pool2d(F.pad(xc, pads, value=-float("inf")), (ky, pc.size_x),
                         (sy, pc.stride)).permute(0, 2, 3, 1)
        if (counts_np == 0).any():
            keep = torch.as_tensor(counts_np > 0, device=x.device)[None, :, :, None]
            y = torch.where(keep, y, torch.zeros((), dtype=y.dtype, device=y.device))
    else:
        # average pooling divides each window by its in-image area (the
        # reference's avgPoolForward clips the window to the image first)
        y = F.avg_pool2d(F.pad(xc, pads), (ky, pc.size_x), (sy, pc.stride),
                         divisor_override=1).permute(0, 2, 3, 1)
        counts = torch.as_tensor(np.maximum(counts_np, 1), dtype=y.dtype, device=x.device)
        y = y / counts[None, :, :, None]
    if not is_elementwise(cfg.active_type):
        return Argument(value=apply_activation(cfg.active_type, _nhwc_to_flat(y)))
    return _publish_nhwc(ctx, cfg, apply_activation(cfg.active_type, y))


@register_layer("batch_norm", "cudnn_batch_norm")
def batch_norm_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    """ref: BatchNormalizationLayer.cpp, with the JAX package's formulas
    (not ``F.batch_norm``, which updates the moving variance with the
    unbiased estimate and weights the moving average the other way):

    - training: one-pass mean and E[x²], var = max(E[x²] - mean², 0), or
      mean = s/M and E[x²] = q/M from statistics a 1x1 conv published;
      moving = f·old + (1 - f)·batch, f = moving_average_fraction, returned
      as state updates;
    - test, or ``use_global_stats``: the moving mean and variance;
    - y = act((x - mean) · gamma / sqrt(var + 1e-5) + beta).

    gamma is the input parameter, beta the bias; the moving mean and
    variance are the 2nd and 3rd input parameters (static)."""
    ic = cfg.inputs[0].image_conf
    a = inputs[0]
    seq_shape = None
    x_nhwc = None
    if ic is not None and ic.img_size > 0:
        C, hw = ic.channels, ic.img_size * ic.img_size
        if not a.is_seq:
            # NHWC flattens to per-pixel rows of C: the same rows as the
            # NCHW transpose, so the same statistics
            x_nhwc = _take_nhwc(ctx, cfg.inputs[0].input_layer_name, a, C,
                                ic.img_size, ic.img_size)
            xr = x_nhwc.reshape(-1, C)
        else:
            seq_shape = a.value.shape
            x = a.value.reshape(-1, seq_shape[-1])
            xr = x.reshape(x.shape[0], C, hw).transpose(1, 2).reshape(-1, C)
    else:
        C = cfg.size
        x = a.value
        if a.is_seq:
            seq_shape = x.shape
            x = x.reshape(-1, seq_shape[-1])
        xr = x
    # the statistics and the centering run in float32 even for bf16
    # activations, on one float32 copy of the activation (x32; the JAX
    # package's XLA fuses the widening into its reductions, eager PyTorch
    # cannot), and the normalisation applies as a per-channel scale in the
    # activation's dtype. gamma, beta and the running statistics are
    # master-dtype reads.
    x32 = hp(xr)
    gamma = ctx.param(cfg.inputs[0].input_parameter_name, cast=False).reshape(C)
    beta = (ctx.param(cfg.bias_parameter_name, cast=False).reshape(C)
            if cfg.bias_parameter_name else None)
    mean_name = cfg.inputs[1].input_parameter_name
    var_name = cfg.inputs[2].input_parameter_name
    eps = 1e-5
    if cfg.use_global_stats or not ctx.is_training:
        mean = ctx.params[mean_name].reshape(C)
        var = ctx.params[var_name].reshape(C)
    else:
        pub = (ctx.conv_stats.get(cfg.inputs[0].input_layer_name)
               if x_nhwc is not None and x32.dtype == torch.float32 else None)
        if pub is not None and pub[2] == xr.shape[0] and tuple(pub[0].shape) == (C,):
            s_pub, q_pub, rows = pub
            mean = s_pub / rows
            msq = q_pub / rows
        else:
            mean = x32.mean(0)
            msq = (x32 * x32).mean(0)
        var = torch.clamp(msq - mean * mean, min=0.0)
        f = cfg.moving_average_fraction
        for name, batch in ((mean_name, mean), (var_name, var)):
            old = ctx.params[name]
            ctx.state_updates[name] = (f * old.reshape(C) + (1.0 - f) * batch.detach()).reshape(
                old.shape)
    # center against the exact mean, then scale (folding the mean into an
    # offset would cancel for channels whose mean is large against their std)
    centered = (x32 - mean).to(xr.dtype)
    yn = centered * (hp(gamma) * torch.rsqrt(hp(var) + eps)).to(xr.dtype)
    if beta is not None:
        yn = yn + beta.to(xr.dtype)
    if x_nhwc is not None and is_elementwise(cfg.active_type):
        return _publish_nhwc(ctx, cfg, apply_activation(cfg.active_type,
                                                        yn.reshape(x_nhwc.shape)))
    if x_nhwc is not None:
        y = _nhwc_to_flat(yn.reshape(x_nhwc.shape))
    elif ic is not None and ic.img_size > 0:
        y = yn.reshape(-1, hw, C).transpose(1, 2).reshape(-1, C * hw)
    else:
        y = yn
    if seq_shape is not None:
        y = y.reshape(seq_shape)
        return Argument(value=apply_activation(cfg.active_type, y),
                        seq_lengths=a.seq_lengths)
    return Argument(value=apply_activation(cfg.active_type, y))


def conv_operator_forward(op, inputs: List[Argument]) -> Tensor:
    """ConvOperator in a mixed layer: conv(image, filters), where the second
    input's row *is* each sample's filter bank [F, C/groups, k, k]. One
    grouped conv over the batch folded into the channels: B * groups
    groups. Returns the flat NCHW output [B, F*Ho*Wo]."""
    cc = op.conv_conf
    x = inputs[0].value
    B = x.shape[0]
    k, F_ = cc.filter_size, op.num_filters
    xs = x.reshape(1, B * cc.channels, cc.img_size, cc.img_size)
    wf = inputs[1].value.reshape(B * F_, cc.filter_channels, k, k)
    y = F.conv2d(xs, wf, stride=cc.stride, padding=cc.padding, groups=B * cc.groups)
    return y.reshape(B, -1)


@register_layer("norm", "norm-projection")
def norm_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    # cmrnorm-projection, cross-map local response normalisation:
    # y = x / (1 + scale * sum_window x^2)^pow over `size` channels around
    # each one (NormConfig.scale already holds scale / size)
    nc = cfg.inputs[0].norm_conf
    x = _take_nhwc(ctx, cfg.inputs[0].input_layer_name, inputs[0],
                   nc.channels, nc.img_size, nc.img_size)
    half = nc.size // 2
    sq = F.pad(x * x, (half, nc.size - 1 - half))                       # channels padded
    acc = sq.unfold(-1, nc.size, 1).sum(-1)                             # [B, H, W, C]
    return _publish_nhwc(ctx, cfg, x / torch.pow(1.0 + nc.scale * acc, nc.pow))


@register_layer("blockexpand")
def block_expand_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    # sliding blocks as a sequence of flattened patches, output_x * output_y
    # steps an image, each step C*by*bx wide in (channel, y, x) order
    bc = cfg.inputs[0].block_expand_conf
    x = _take_nhwc(ctx, cfg.inputs[0].input_layer_name, inputs[0],
                   bc.channels, bc.img_size_y, bc.img_size_x)
    patches = F.unfold(x.permute(0, 3, 1, 2), (bc.block_y, bc.block_x),
                       padding=(bc.padding_y, bc.padding_x),
                       stride=(bc.stride_y, bc.stride_x))                # [B, C*by*bx, L]
    B, _, L = patches.shape
    return Argument(value=patches.transpose(1, 2),
                    seq_lengths=torch.full((B,), L, dtype=torch.int32, device=x.device))


@register_layer("featmap_expand")
def featmap_expand_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    # the features tiled num_filters times
    a = inputs[0]
    out = a.value.repeat(*([1] * (a.value.dim() - 1)), cfg.num_filters)
    return Argument(value=out, seq_lengths=a.seq_lengths)


@register_layer("resize")
def resize_layer(cfg: LayerConfig, inputs: List[Argument], ctx: LayerContext) -> Argument:
    # the rows read with a new feature width
    return Argument(value=inputs[0].value.reshape(-1, cfg.size))
