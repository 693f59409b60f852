"""Composed networks (reference: trainer_config_helpers/networks.py).

simple_lstm:436, lstmemory_unit:505, lstmemory_group:606, gru_unit:689,
gru_group:741, simple_gru:806, bidirectional_lstm:872, simple_attention:943,
sequence_conv_pool:41, img_conv_group:279, small_vgg:359,
vgg_16_network:384, outputs:1055 — same math, rebuilt on the paddle_tpu DSL.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

from paddle_tpu_torch.config.builder import current_context
from paddle_tpu_torch.trainer_config_helpers.activations import (
    BaseActivation,
    IdentityActivation,
    LinearActivation,
    ReluActivation,
    SequenceSoftmaxActivation,
    SigmoidActivation,
    TanhActivation,
)
from paddle_tpu_torch.trainer_config_helpers.attrs import ExtraLayerAttribute, ParameterAttribute
from paddle_tpu_torch.trainer_config_helpers.layers import (
    LayerOutput,
    batch_norm_layer,
    concat_layer,
    context_projection,
    dropout_layer,
    embedding_layer,
    expand_layer,
    fc_layer,
    full_matrix_projection,
    get_output_layer,
    grumemory,
    gru_step_layer,
    identity_projection,
    img_conv_layer,
    img_pool_layer,
    last_seq,
    lstm_step_layer,
    lstmemory,
    memory,
    mixed_layer,
    pooling_layer,
    recurrent_group,
    scaling_layer,
)
from paddle_tpu_torch.trainer_config_helpers.poolings import MaxPooling, SumPooling

__all__ = [
    "sequence_conv_pool",
    "simple_lstm",
    "lstmemory_unit",
    "lstmemory_group",
    "gru_unit",
    "gru_group",
    "simple_gru",
    "bidirectional_lstm",
    "simple_attention",
    "simple_img_conv_pool",
    "img_conv_bn_pool",
    "img_conv_group",
    "small_vgg",
    "vgg_16_network",
    "outputs",
]


def sequence_conv_pool(
    input: LayerOutput,
    context_len: int,
    hidden_size: int,
    name: Optional[str] = None,
    context_start: Optional[int] = None,
    pool_type=None,
    context_proj_layer_name: Optional[str] = None,
    context_proj_param_attr=False,
    fc_layer_name: Optional[str] = None,
    fc_param_attr=None,
    fc_bias_attr=None,
    fc_act=None,
    pool_bias_attr=False,
    fc_attr=None,
    context_attr=None,
    pool_attr=None,
) -> LayerOutput:
    """Text CNN: context projection (n-gram window) → fc → seq pooling."""
    name = name or current_context().unique_name("sequence_conv_pool")
    context_proj_layer_name = context_proj_layer_name or f"{name}_conv_proj"
    m = mixed_layer(
        name=context_proj_layer_name,
        size=input.size * context_len,
        input=[
            context_projection(
                input,
                context_len=context_len,
                context_start=context_start,
                padding_attr=context_proj_param_attr,
            )
        ],
        act=LinearActivation(),
        layer_attr=context_attr,
    )
    fc_layer_name = fc_layer_name or f"{name}_fc"
    fc = fc_layer(
        name=fc_layer_name,
        input=m,
        size=hidden_size,
        act=fc_act or TanhActivation(),
        param_attr=fc_param_attr,
        bias_attr=fc_bias_attr if fc_bias_attr is not None else True,
        layer_attr=fc_attr,
    )
    return pooling_layer(
        name=f"{name}_pool",
        input=fc,
        pooling_type=pool_type or MaxPooling(),
        bias_attr=pool_bias_attr,
        layer_attr=pool_attr,
    )


def simple_lstm(
    input: LayerOutput,
    size: int,
    name: Optional[str] = None,
    reverse: bool = False,
    mat_param_attr=None,
    bias_param_attr=None,
    inner_param_attr=None,
    act=None,
    gate_act=None,
    state_act=None,
    mixed_layer_attr=None,
    lstm_cell_attr=None,
) -> LayerOutput:
    """x → [W x] (mixed) → lstmemory (ref: networks.py:436)."""
    name = name or current_context().unique_name("lstm")
    m = mixed_layer(
        name=f"lstm_transform_{name}",
        size=size * 4,
        input=[full_matrix_projection(input, param_attr=mat_param_attr)],
        act=IdentityActivation(),
        bias_attr=False,
        layer_attr=mixed_layer_attr,
    )
    return lstmemory(
        name=name,
        input=m,
        reverse=reverse,
        bias_attr=bias_param_attr if bias_param_attr is not None else True,
        param_attr=inner_param_attr,
        act=act,
        gate_act=gate_act,
        state_act=state_act,
        layer_attr=lstm_cell_attr,
    )


def lstmemory_unit(
    input: LayerOutput,
    name: Optional[str] = None,
    size: Optional[int] = None,
    param_attr=None,
    act=None,
    gate_act=None,
    state_act=None,
    mixed_bias_attr=None,
    lstm_bias_attr=None,
    mixed_layer_attr=None,
    lstm_layer_attr=None,
    get_output_layer_attr=None,
) -> LayerOutput:
    """One LSTM step for use inside recurrent_group (ref: networks.py:505):
    out/state memories + [identity(x) + W_h h_prev] mixed + lstm_step."""
    name = name or current_context().unique_name("lstm_unit")
    if size is None:
        assert input.size % 4 == 0
        size = input.size // 4
    out_mem = memory(name=name, size=size)
    state_mem = memory(name=f"{name}_state", size=size)
    m = mixed_layer(
        name=f"{name}_input_recurrent",
        size=size * 4,
        input=[
            identity_projection(input),
            full_matrix_projection(out_mem, param_attr=param_attr),
        ],
        bias_attr=mixed_bias_attr if mixed_bias_attr is not None else False,
        act=IdentityActivation(),
        layer_attr=mixed_layer_attr,
    )
    lstm_out = lstm_step_layer(
        name=name,
        input=m,
        state=state_mem,
        size=size,
        bias_attr=lstm_bias_attr if lstm_bias_attr is not None else True,
        act=act,
        gate_act=gate_act,
        state_act=state_act,
        layer_attr=lstm_layer_attr,
    )
    get_output_layer(
        name=f"{name}_state", input=lstm_out, arg_name="state", layer_attr=get_output_layer_attr
    )
    return lstm_out


def lstmemory_group(
    input: LayerOutput,
    size: Optional[int] = None,
    name: Optional[str] = None,
    reverse: bool = False,
    param_attr=None,
    act=None,
    gate_act=None,
    state_act=None,
    mixed_bias_attr=None,
    lstm_bias_attr=None,
    mixed_layer_attr=None,
    lstm_layer_attr=None,
    get_output_layer_attr=None,
) -> LayerOutput:
    name = name or current_context().unique_name("lstm_group")

    def _step(ipt):
        return lstmemory_unit(
            input=ipt,
            name=name,
            size=size,
            param_attr=param_attr,
            act=act,
            gate_act=gate_act,
            state_act=state_act,
            mixed_bias_attr=mixed_bias_attr,
            lstm_bias_attr=lstm_bias_attr,
            mixed_layer_attr=mixed_layer_attr,
            lstm_layer_attr=lstm_layer_attr,
            get_output_layer_attr=get_output_layer_attr,
        )

    return recurrent_group(
        name=f"{name}_recurrent_group", step=_step, reverse=reverse, input=input
    )


def gru_unit(
    input: LayerOutput,
    size: Optional[int] = None,
    name: Optional[str] = None,
    gru_bias_attr=None,
    act=None,
    gate_act=None,
    gru_layer_attr=None,
) -> LayerOutput:
    name = name or current_context().unique_name("gru_unit")
    assert input.size % 3 == 0
    if size is None:
        size = input.size // 3
    out_mem = memory(name=name, size=size)
    return gru_step_layer(
        name=name,
        input=input,
        output_mem=out_mem,
        size=size,
        bias_attr=gru_bias_attr if gru_bias_attr is not None else True,
        act=act,
        gate_act=gate_act,
        layer_attr=gru_layer_attr,
    )


def gru_group(
    input: LayerOutput,
    size: Optional[int] = None,
    name: Optional[str] = None,
    reverse: bool = False,
    gru_bias_attr=None,
    act=None,
    gate_act=None,
    gru_layer_attr=None,
    force_group: bool = False,
) -> LayerOutput:
    name = name or current_context().unique_name("gru_group")
    # The fixed step here is exactly one gru_unit, and the reference
    # documents gru_group as "exactly the same calculation as the
    # grumemory layer" (reference networks.py:741-755) — so at top level
    # lower straight to the fused gated_recurrent layer: identical layer
    # name, parameter names and shapes (checkpoint-compatible), one
    # lax.scan instead of a per-step layer group, and the fused Pallas
    # kernel applies under settings(pallas_rnn=True). Inside another
    # recurrent_group the group form is kept (nested sub-scan contract).
    # Consequence (doc/divergences.md): the '<name>_recurrent_group'
    # submodel and its step-level memory no longer exist at top level —
    # configs that reference them (get_output/memory against the step
    # form) pass force_group=True to keep the group form.
    if not current_context().submodel_stack and not force_group:
        assert size is None or input.size == 3 * size, (
            f"gru_group size {size} does not match input size {input.size}"
        )
        return grumemory(
            input=input,
            name=name,
            reverse=reverse,
            act=act,
            gate_act=gate_act,
            bias_attr=gru_bias_attr if gru_bias_attr is not None else True,
            layer_attr=gru_layer_attr,
        )

    def _step(ipt):
        return gru_unit(
            input=ipt,
            name=name,
            size=size,
            gru_bias_attr=gru_bias_attr,
            act=act,
            gate_act=gate_act,
            gru_layer_attr=gru_layer_attr,
        )

    return recurrent_group(
        name=f"{name}_recurrent_group", step=_step, reverse=reverse, input=input
    )


def simple_gru(
    input: LayerOutput,
    size: int,
    name: Optional[str] = None,
    reverse: bool = False,
    mixed_param_attr=None,
    mixed_bias_param_attr=None,
    mixed_layer_attr=None,
    gru_bias_attr=None,
    act=None,
    gate_act=None,
    gru_layer_attr=None,
) -> LayerOutput:
    name = name or current_context().unique_name("simple_gru")
    m = mixed_layer(
        name=f"{name}_transform",
        size=size * 3,
        input=[full_matrix_projection(input, param_attr=mixed_param_attr)],
        bias_attr=mixed_bias_param_attr if mixed_bias_param_attr is not None else False,
        layer_attr=mixed_layer_attr,
    )
    return gru_group(
        name=name,
        size=size,
        input=m,
        reverse=reverse,
        gru_bias_attr=gru_bias_attr,
        act=act,
        gate_act=gate_act,
        gru_layer_attr=gru_layer_attr,
    )


def bidirectional_lstm(
    input: LayerOutput,
    size: int,
    name: Optional[str] = None,
    return_seq: bool = False,
    fwd_mat_param_attr=None,
    fwd_bias_param_attr=None,
    fwd_inner_param_attr=None,
    bwd_mat_param_attr=None,
    bwd_bias_param_attr=None,
    bwd_inner_param_attr=None,
    last_seq_attr=None,
    first_seq_attr=None,
    concat_attr=None,
    concat_act=None,
) -> LayerOutput:
    """Forward + backward LSTM, concatenated (ref: networks.py:872)."""
    name = name or current_context().unique_name("bidirectional_lstm")
    fw = simple_lstm(
        name=f"{name}_fw",
        input=input,
        size=size,
        mat_param_attr=fwd_mat_param_attr,
        bias_param_attr=fwd_bias_param_attr,
        inner_param_attr=fwd_inner_param_attr,
    )
    bw = simple_lstm(
        name=f"{name}_bw",
        input=input,
        size=size,
        reverse=True,
        mat_param_attr=bwd_mat_param_attr,
        bias_param_attr=bwd_bias_param_attr,
        inner_param_attr=bwd_inner_param_attr,
    )
    if return_seq:
        return concat_layer(input=[fw, bw], name=name, act=concat_act, layer_attr=concat_attr)
    fw_end = last_seq(input=fw, name=f"{name}_fw_last", layer_attr=last_seq_attr)
    from paddle_tpu_torch.trainer_config_helpers.layers import first_seq

    bw_end = first_seq(input=bw, name=f"{name}_bw_first", layer_attr=first_seq_attr)
    return concat_layer(input=[fw_end, bw_end], name=name, act=concat_act, layer_attr=concat_attr)


def simple_attention(
    encoded_sequence: LayerOutput,
    encoded_proj: LayerOutput,
    decoder_state: LayerOutput,
    transform_param_attr=None,
    softmax_param_attr=None,
    weight_act=None,
    name: Optional[str] = None,
) -> LayerOutput:
    """Bahdanau additive attention (ref: networks.py:943):
    scores = v·act(W s_{t-1} + U h_j); context = Σ softmax(scores)_j h_j."""
    name = name or current_context().unique_name("attention")
    assert encoded_proj.size == decoder_state.size
    proj_size = encoded_proj.size
    m = mixed_layer(
        size=proj_size,
        name=f"{name}_transform",
        input=[full_matrix_projection(decoder_state, param_attr=transform_param_attr)],
    )
    expanded = expand_layer(input=m, expand_as=encoded_sequence, name=f"{name}_expand")
    combined = mixed_layer(
        size=proj_size,
        name=f"{name}_combine",
        act=weight_act or TanhActivation(),
        input=[identity_projection(expanded), identity_projection(encoded_proj)],
    )
    attention_weight = fc_layer(
        input=combined,
        size=1,
        act=SequenceSoftmaxActivation(),
        param_attr=softmax_param_attr,
        name=f"{name}_softmax",
        bias_attr=False,
    )
    scaled = scaling_layer(weight=attention_weight, input=encoded_sequence, name=f"{name}_scaling")
    return pooling_layer(input=scaled, pooling_type=SumPooling(), name=f"{name}_pooling")


# ------------------------------------------------------------ vision nets


def simple_img_conv_pool(
    input: LayerOutput,
    filter_size: int,
    num_filters: int,
    pool_size: int,
    name: Optional[str] = None,
    pool_type=None,
    act=None,
    groups: int = 1,
    conv_stride: int = 1,
    conv_padding: int = 0,
    bias_attr=None,
    num_channel: Optional[int] = None,
    param_attr=None,
    shared_bias: bool = True,
    conv_layer_attr=None,
    pool_stride: int = 1,
    pool_start: int = 0,
    pool_padding: int = 0,
    pool_layer_attr=None,
) -> LayerOutput:
    name = name or current_context().unique_name("conv_pool")
    conv = img_conv_layer(
        name=f"{name}_conv",
        input=input,
        filter_size=filter_size,
        num_filters=num_filters,
        num_channels=num_channel,
        act=act,
        groups=groups,
        stride=conv_stride,
        padding=conv_padding,
        bias_attr=bias_attr if bias_attr is not None else True,
        param_attr=param_attr,
        shared_biases=shared_bias,
        layer_attr=conv_layer_attr,
    )
    return img_pool_layer(
        name=f"{name}_pool",
        input=conv,
        pool_size=pool_size,
        pool_type=pool_type or MaxPooling(),
        stride=pool_stride,
        start=pool_start,
        padding=pool_padding,
        layer_attr=pool_layer_attr,
    )


def img_conv_bn_pool(
    input: LayerOutput,
    filter_size: int,
    num_filters: int,
    pool_size: int,
    name: Optional[str] = None,
    pool_type=None,
    act=None,
    groups: int = 1,
    conv_stride: int = 1,
    conv_padding: int = 0,
    conv_bias_attr=None,
    num_channel: Optional[int] = None,
    conv_param_attr=None,
    shared_bias: bool = True,
    conv_layer_attr=None,
    bn_param_attr=None,
    bn_bias_attr=None,
    bn_layer_attr=None,
    pool_stride: int = 1,
    pool_start: int = 0,
    pool_padding: int = 0,
    pool_layer_attr=None,
) -> LayerOutput:
    name = name or current_context().unique_name("conv_bn_pool")
    conv = img_conv_layer(
        name=f"{name}_conv",
        input=input,
        filter_size=filter_size,
        num_filters=num_filters,
        num_channels=num_channel,
        act=LinearActivation(),
        groups=groups,
        stride=conv_stride,
        padding=conv_padding,
        bias_attr=conv_bias_attr if conv_bias_attr is not None else True,
        param_attr=conv_param_attr,
        shared_biases=shared_bias,
        layer_attr=conv_layer_attr,
    )
    bn = batch_norm_layer(
        name=f"{name}_bn",
        input=conv,
        act=act or ReluActivation(),
        bias_attr=bn_bias_attr if bn_bias_attr is not None else True,
        param_attr=bn_param_attr,
        layer_attr=bn_layer_attr,
    )
    return img_pool_layer(
        name=f"{name}_pool",
        input=bn,
        pool_size=pool_size,
        pool_type=pool_type or MaxPooling(),
        stride=pool_stride,
        start=pool_start,
        padding=pool_padding,
        layer_attr=pool_layer_attr,
    )


def img_conv_group(
    input: LayerOutput,
    conv_num_filter: Sequence[int],
    pool_size: int,
    num_channels: Optional[int] = None,
    conv_padding: Union[int, Sequence[int]] = 1,
    conv_filter_size: Union[int, Sequence[int]] = 3,
    conv_act: Optional[BaseActivation] = None,
    conv_with_batchnorm: Union[bool, Sequence[bool]] = False,
    conv_batchnorm_drop_rate: Union[float, Sequence[float]] = 0,
    pool_stride: int = 1,
    pool_type=None,
) -> LayerOutput:
    """Stack of convs (optionally with BN+dropout) followed by one pool
    (ref: networks.py:279 — the VGG building block)."""
    n = len(conv_num_filter)
    expand = lambda v: list(v) if isinstance(v, (list, tuple)) else [v] * n
    paddings = expand(conv_padding)
    fsizes = expand(conv_filter_size)
    with_bn = expand(conv_with_batchnorm)
    drop_rates = expand(conv_batchnorm_drop_rate)
    tmp = input
    channels = num_channels
    for i in range(n):
        tmp = img_conv_layer(
            input=tmp,
            padding=paddings[i],
            filter_size=fsizes[i],
            num_filters=conv_num_filter[i],
            num_channels=channels,
            act=LinearActivation() if with_bn[i] else (conv_act or ReluActivation()),
        )
        channels = None
        if with_bn[i]:
            dr = drop_rates[i]
            tmp = batch_norm_layer(
                input=tmp,
                act=conv_act or ReluActivation(),
                layer_attr=ExtraLayerAttribute(drop_rate=dr) if dr else None,
            )
    return img_pool_layer(
        input=tmp, pool_size=pool_size, stride=pool_stride, pool_type=pool_type or MaxPooling()
    )


def small_vgg(input_image: LayerOutput, num_channels: int, num_classes: int) -> LayerOutput:
    """VGG-style CIFAR net (ref: networks.py:359)."""

    def _vgg_block(ipt, num_filter, times, dropouts, channels=None):
        return img_conv_group(
            input=ipt,
            num_channels=channels,
            pool_size=2,
            pool_stride=2,
            conv_num_filter=[num_filter] * times,
            conv_filter_size=3,
            conv_act=ReluActivation(),
            conv_with_batchnorm=True,
            conv_batchnorm_drop_rate=dropouts,
            pool_type=MaxPooling(),
        )

    tmp = _vgg_block(input_image, 64, 2, [0.3, 0], channels=num_channels)
    tmp = _vgg_block(tmp, 128, 2, [0.4, 0])
    tmp = _vgg_block(tmp, 256, 3, [0.4, 0.4, 0])
    tmp = _vgg_block(tmp, 512, 3, [0.4, 0.4, 0])
    tmp = img_pool_layer(input=tmp, stride=2, pool_size=2, pool_type=MaxPooling())
    tmp = dropout_layer(input=tmp, dropout_rate=0.5)
    tmp = fc_layer(
        input=tmp,
        size=512,
        act=LinearActivation(),
        bias_attr=False,
    )
    tmp = batch_norm_layer(
        input=tmp, act=ReluActivation(), layer_attr=ExtraLayerAttribute(drop_rate=0.5)
    )
    tmp = fc_layer(input=tmp, size=512, act=LinearActivation())
    from paddle_tpu_torch.trainer_config_helpers.activations import SoftmaxActivation

    return fc_layer(input=tmp, size=num_classes, act=SoftmaxActivation())


def vgg_16_network(input_image: LayerOutput, num_channels: int, num_classes: int = 1000) -> LayerOutput:
    """VGG-16 (ref: networks.py:384)."""
    tmp = img_conv_group(
        input=input_image,
        num_channels=num_channels,
        conv_padding=1,
        conv_num_filter=[64, 64],
        conv_filter_size=3,
        conv_act=ReluActivation(),
        pool_size=2,
        pool_stride=2,
        pool_type=MaxPooling(),
    )
    for filters, times in [(128, 2), (256, 3), (512, 3), (512, 3)]:
        tmp = img_conv_group(
            input=tmp,
            conv_padding=1,
            conv_num_filter=[filters] * times,
            conv_filter_size=3,
            conv_act=ReluActivation(),
            pool_size=2,
            pool_stride=2,
            pool_type=MaxPooling(),
        )
    tmp = fc_layer(
        input=tmp, size=4096, act=ReluActivation(),
        layer_attr=ExtraLayerAttribute(drop_rate=0.5),
    )
    tmp = fc_layer(
        input=tmp, size=4096, act=ReluActivation(),
        layer_attr=ExtraLayerAttribute(drop_rate=0.5),
    )
    from paddle_tpu_torch.trainer_config_helpers.activations import SoftmaxActivation

    return fc_layer(input=tmp, size=num_classes, act=SoftmaxActivation())


def outputs(layers, *args) -> None:
    """Declare the network outputs (ref: networks.py:1055)."""
    ctx = current_context()
    if isinstance(layers, LayerOutput):
        layers = [layers]
    layers = list(layers) + [a for a in args]
    for l in layers:
        ctx.mark_output(l.name)
