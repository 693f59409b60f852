"""trainer_config_helpers.layers — the user-facing layer DSL.

API-compatible rebuild of /root/reference/python/paddle/
trainer_config_helpers/layers.py (fc_layer:658, data_layer:599,
lstmemory:788, recurrent_group:2141, beam_search:2363, ...). Functions
return ``LayerOutput`` handles and append LayerConfig/ParameterConfig
records to the active ConfigContext. No numerics here — the runtime
compiles the resulting ModelConfig (paddle_tpu_torch.graph).
"""

from __future__ import annotations

import math
from typing import Any, Callable, List, Optional, Sequence, Union

from paddle_tpu_torch.config.builder import current_context
from paddle_tpu_torch.proto import (
    ConvConfig,
    EvaluatorConfig,
    GeneratorConfig,
    ImageConfig,
    LayerConfig,
    LayerInputConfig,
    LinkConfig,
    MemoryConfig,
    NormConfig,
    OperatorConfig,
    ParameterConfig,
    PoolConfig,
    ProjectionConfig,
    BlockExpandConfig,
)
from paddle_tpu_torch.trainer_config_helpers.activations import (
    BaseActivation,
    IdentityActivation,
    ReluActivation,
    SigmoidActivation,
    TanhActivation,
)
from paddle_tpu_torch.trainer_config_helpers.attrs import ExtraLayerAttribute, ParameterAttribute
from paddle_tpu_torch.trainer_config_helpers.poolings import AvgPooling, BasePoolingType, MaxPooling

__all__ = [
    "LayerOutput",
    "StaticInput",
    "SubsequenceInput",
    "GeneratedInput",
    "AggregateLevel",
    "ExpandLevel",
    "full_matrix_projection",
    "trans_full_matrix_projection",
    "table_projection",
    "identity_projection",
    "dotmul_projection",
    "context_projection",
    "conv_operator",
    "dotmul_operator",
    "mixed_layer",
    "data_layer",
    "embedding_layer",
    "sparse_embedding",
    "fc_layer",
    "pooling_layer",
    "lstmemory",
    "grumemory",
    "recurrent_layer",
    "last_seq",
    "first_seq",
    "expand_layer",
    "interpolation_layer",
    "power_layer",
    "scaling_layer",
    "trans_layer",
    "cos_sim",
    "hsigmoid",
    "img_conv_layer",
    "img_pool_layer",
    "img_cmrnorm_layer",
    "batch_norm_layer",
    "sum_to_one_norm_layer",
    "addto_layer",
    "concat_layer",
    "memory",
    "lstm_step_layer",
    "gru_step_layer",
    "get_output_layer",
    "recurrent_group",
    "maxid_layer",
    "eos_layer",
    "beam_search",
    "regression_cost",
    "classification_cost",
    "auc_validation",
    "pnpair_validation",
    "conv_shift_layer",
    "tensor_layer",
    "selective_fc_layer",
    "sampling_id_layer",
    "slope_intercept_layer",
    "convex_comb_layer",
    "block_expand_layer",
    "ctc_layer",
    "crf_layer",
    "crf_decoding_layer",
    "rank_cost",
    "lambda_cost",
    "cross_entropy",
    "cross_entropy_with_selfnorm",
    "huber_cost",
    "multi_binary_label_cross_entropy",
    "nce_layer",
    "dropout_layer",
    "out_prod_layer",
    "multiplex_layer",
    "multi_head_attention_layer",
    "mdlstm_layer",
    "sub_network",
]


class AggregateLevel:
    EACH_TIMESTEP = "non-seq"
    EACH_SEQUENCE = "seq"


class ExpandLevel:
    FROM_TIMESTEP = "non-seq"
    FROM_SEQUENCE = "seq"


class LayerOutput:
    """Handle to a configured layer (reference: layers.py LayerOutput)."""

    def __init__(
        self,
        name: str,
        layer_type: str,
        parents: Optional[List["LayerOutput"]] = None,
        size: Optional[int] = None,
        activation: Optional[BaseActivation] = None,
        reverse: Optional[bool] = None,
        outputs: Optional[List[str]] = None,
    ):
        self.name = name
        self.layer_type = layer_type
        self.parents = parents or []
        self.size = size
        self.activation = activation
        self.reverse = reverse
        self.outputs = outputs

    def __repr__(self):
        return f"LayerOutput({self.name!r}, type={self.layer_type!r}, size={self.size})"


class StaticInput:
    """Whole-value input to a recurrent_group (same value every step)."""

    def __init__(self, input: LayerOutput, is_seq: bool = False, size: Optional[int] = None):
        self.input = input
        self.is_seq = is_seq
        self.size = size or input.size


class SubsequenceInput:
    """Nested-sequence in-link: the group steps over subsequences."""

    def __init__(self, input: LayerOutput):
        self.input = input


class GeneratedInput:
    """Generation-time input: embedding of the previously generated token."""

    def __init__(
        self,
        size: int,
        embedding_name: str,
        embedding_size: int,
        eos_id: Optional[int] = None,
    ):
        self.size = size
        self.embedding_name = embedding_name
        self.embedding_size = embedding_size
        self.eos_id = eos_id


# --------------------------------------------------------------- helpers


def _ctx():
    return current_context()


def _act_name(act: Optional[BaseActivation]) -> str:
    if act is None:
        return ""
    return act.name


def _apply_layer_attr(cfg: LayerConfig, layer_attr: Optional[ExtraLayerAttribute]) -> None:
    if layer_attr is not None:
        layer_attr.apply_to(cfg)


def _create_parameter(
    name: str,
    size: int,
    dims: Sequence[int],
    attr: Optional[Union[ParameterAttribute, bool]] = None,
    is_bias: bool = False,
    sparse: bool = False,
) -> str:
    """Create (or share) a ParameterConfig; returns its name.

    Default init mirrors the reference (config_parser.py:2780-2840):
    weights N(0, 0.01) unless initial_smart/attr overrides; biases zero.
    """
    ctx = _ctx()
    d = ctx.defaults
    pc = ParameterConfig(name=name, size=int(size), dims=[int(x) for x in dims])
    pc.momentum = d.get("momentum", 0.0)
    pc.decay_rate = d.get("decay_rate", 0.0)
    pc.decay_rate_l1 = d.get("decay_rate_l1", 0.0)
    pc.gradient_clipping_threshold = d.get("gradient_clipping_threshold", 0.0)
    if is_bias:
        pc.initial_mean = 0.0
        pc.initial_std = 0.0
    else:
        pc.initial_mean = d.get("initial_mean", 0.0)
        pc.initial_std = d.get("initial_std", 0.01)
        pc.initial_strategy = d.get("initial_strategy", 0)
        # reference semantics: a weight with no explicit init attr gets
        # "smart" init, std = 1/sqrt(fan_in) (attrs.py:67 ParamAttr() →
        # {'initial_smart': True}); the 0.01 default only applies when the
        # user set default_initial_std()/settings overrides.
        pc.initial_smart = d.get(
            "initial_smart",
            not isinstance(attr, ParameterAttribute) and "initial_std" not in d,
        )
    if isinstance(attr, ParameterAttribute):
        if attr.name:
            # shared parameter: reuse existing config if present
            pc.name = attr.name
            if attr.name in ctx.param_map:
                existing = ctx.param_map[attr.name]
                if existing.size != pc.size:
                    raise ValueError(
                        f"shared parameter {attr.name!r} size mismatch: "
                        f"{existing.size} vs {pc.size}"
                    )
                existing.is_shared = True
                return attr.name
        attr.apply_to(pc)
    if sparse:
        pc.is_sparse = True
    if pc.initial_smart:
        pc.initial_mean = 0.0
        fan = pc.dims[0] if pc.dims else pc.size
        pc.initial_std = 1.0 / math.sqrt(fan)
    ctx.add_parameter(pc)
    return pc.name


def _bias_name(
    layer_name: str,
    size: int,
    bias_attr: Union[bool, ParameterAttribute, None],
) -> str:
    """Resolve the bias_attr convention: False/None→no bias unless
    ParamAttr; True→default bias. Returns '' for no bias."""
    if bias_attr is False or bias_attr is None:
        return ""
    attr = bias_attr if isinstance(bias_attr, ParameterAttribute) else None
    name = (attr.name if attr and attr.name else f"_{layer_name}.wbias")
    ctx = _ctx()
    if name in ctx.param_map:
        return name
    return _create_parameter(name, size, [1, size], attr, is_bias=True)


def _add_layer(cfg: LayerConfig, layer_attr=None) -> LayerConfig:
    _apply_layer_attr(cfg, layer_attr)
    return _ctx().add_layer(cfg)


def _input(
    layer: LayerOutput,
    param_name: str = "",
    **kw,
) -> LayerInputConfig:
    return LayerInputConfig(input_layer_name=layer.name, input_parameter_name=param_name, **kw)


def _name(name: Optional[str], prefix: str) -> str:
    if name is not None:
        return name
    return _ctx().unique_name(prefix)


def _to_list(x) -> list:
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


# ------------------------------------------------------------ projections


class _Projection:
    """Deferred projection: materialized when attached to a mixed layer."""

    def __init__(self, type_: str, input: LayerOutput, size: int, param_attr=None, **extra):
        self.type = type_
        self.input = input
        self.size = size
        self.param_attr = param_attr
        self.extra = extra

    def materialize(self, mixed_name: str, mixed_size: int, idx: int) -> LayerInputConfig:
        out_size = self.size or mixed_size
        in_size = self.input.size
        proj = ProjectionConfig(
            type=self.type, name=f"{mixed_name}.proj{idx}", input_size=in_size, output_size=out_size
        )
        pname = ""
        if self.type == "fc":
            pname = _create_parameter(
                f"_{mixed_name}.w{idx}", in_size * out_size, [in_size, out_size], self.param_attr
            )
        elif self.type == "trans_fc":
            pname = _create_parameter(
                f"_{mixed_name}.w{idx}", in_size * out_size, [out_size, in_size], self.param_attr
            )
        elif self.type == "table":
            pname = _create_parameter(
                f"_{mixed_name}.w{idx}",
                in_size * out_size,
                [in_size, out_size],
                self.param_attr,
                sparse=bool(self.extra.get("sparse", False)),
            )
        elif self.type == "dot_mul":
            pname = _create_parameter(
                f"_{mixed_name}.w{idx}", out_size, [1, out_size], self.param_attr
            )
        elif self.type == "context":
            proj.context_start = self.extra["context_start"]
            proj.context_length = self.extra["context_length"]
            proj.trainable_padding = self.extra.get("trainable_padding", False)
            if proj.trainable_padding:
                total_pad = max(0, -proj.context_start) + max(
                    0, proj.context_start + proj.context_length - 1
                )
                pname = _create_parameter(
                    f"_{mixed_name}.w{idx}", total_pad * in_size, [total_pad, in_size], self.param_attr
                )
            proj.output_size = in_size * proj.context_length
        elif self.type == "identity_offset":
            proj.offset = self.extra.get("offset", 0)
        return LayerInputConfig(
            input_layer_name=self.input.name, input_parameter_name=pname, proj_conf=proj
        )

    def output_size(self, mixed_size: int) -> int:
        if self.type == "context":
            return self.input.size * self.extra["context_length"]
        return self.size or mixed_size


def full_matrix_projection(input: LayerOutput, size: int = 0, param_attr=None) -> _Projection:
    return _Projection("fc", input, size, param_attr)


def trans_full_matrix_projection(input: LayerOutput, size: int = 0, param_attr=None) -> _Projection:
    return _Projection("trans_fc", input, size, param_attr)


def table_projection(input: LayerOutput, size: int = 0, param_attr=None) -> _Projection:
    return _Projection("table", input, size, param_attr)


def identity_projection(input: LayerOutput, offset: Optional[int] = None) -> _Projection:
    if offset is None:
        return _Projection("identity", input, input.size)
    return _Projection("identity_offset", input, 0, offset=offset)


def dotmul_projection(input: LayerOutput, param_attr=None, scale: float = 1.0) -> _Projection:
    return _Projection("dot_mul", input, input.size, param_attr)


def context_projection(
    input: LayerOutput,
    context_len: int,
    context_start: Optional[int] = None,
    padding_attr: Union[bool, ParameterAttribute] = False,
) -> _Projection:
    start = context_start if context_start is not None else -(context_len // 2)
    trainable = isinstance(padding_attr, ParameterAttribute) or padding_attr is True
    return _Projection(
        "context",
        input,
        0,
        padding_attr if isinstance(padding_attr, ParameterAttribute) else None,
        context_start=start,
        context_length=context_len,
        trainable_padding=trainable,
    )


class _Operator:
    def __init__(self, type_: str, inputs: List[LayerOutput], conf: OperatorConfig):
        self.type = type_
        self.inputs = inputs
        self.conf = conf


def dotmul_operator(a: LayerOutput, b: LayerOutput, scale: float = 1.0) -> _Operator:
    conf = OperatorConfig(
        type="dot_mul", output_size=a.size, input_sizes=[a.size, b.size], dotmul_scale=scale
    )
    return _Operator("dot_mul", [a, b], conf)


def conv_operator(
    input: Sequence[LayerOutput],
    filter_size: int,
    num_filters: int,
    num_channel: Optional[int] = None,
    stride: int = 1,
    padding: int = 0,
    filter_size_y: Optional[int] = None,
    stride_y: Optional[int] = None,
    padding_y: Optional[int] = None,
) -> _Operator:
    img, filt = input[0], input[1]
    num_channel = num_channel or 1
    img_size = int(math.sqrt(img.size // num_channel))
    out_x = _conv_out(img_size, filter_size, padding, stride, caffe_mode=True)
    cc = ConvConfig(
        filter_size=filter_size,
        channels=num_channel,
        stride=stride,
        padding=padding,
        groups=1,
        filter_channels=num_channel,
        output_x=out_x,
        img_size=img_size,
        filter_size_y=filter_size_y or filter_size,
        stride_y=stride_y or stride,
        padding_y=padding_y or padding,
    )
    conf = OperatorConfig(
        type="conv",
        output_size=out_x * out_x * num_filters,
        input_sizes=[img.size, filt.size],
        conv_conf=cc,
        num_filters=num_filters,
    )
    return _Operator("conv", [img, filt], conf)


# ----------------------------------------------------------- mixed layer


class _MixedLayer(LayerOutput):
    """mixed_layer handle supporting `with ... as m: m += proj` style."""

    def __init__(self, name, size, act, bias_attr, layer_attr):
        super().__init__(name, "mixed", [], size, act)
        self._pending: List[Union[_Projection, _Operator]] = []
        self._bias_attr = bias_attr
        self._layer_attr = layer_attr
        self._finalized = False

    def __iadd__(self, other):
        assert not self._finalized, "mixed_layer already finalized"
        self._pending.append(other)
        return self

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self._finalize()

    def _finalize(self):
        if self._finalized:
            return
        self._finalized = True
        cfg = LayerConfig(name=self.name, type="mixed", active_type=_act_name(self.activation))
        size = self.size or 0
        # infer size from first projection/operator if not given
        for item in self._pending:
            if size:
                break
            if isinstance(item, _Projection):
                size = item.output_size(0)
            else:
                size = item.conf.output_size
        self.size = size
        cfg.size = size
        idx = 0
        op_layer_index = {}
        for item in self._pending:
            if isinstance(item, _Projection):
                cfg.inputs.append(item.materialize(self.name, size, idx))
                self.parents.append(item.input)
                op_layer_index[id(item.input)] = len(cfg.inputs) - 1
                idx += 1
            else:
                indices = []
                for l in item.inputs:
                    cfg.inputs.append(LayerInputConfig(input_layer_name=l.name))
                    self.parents.append(l)
                    indices.append(len(cfg.inputs) - 1)
                item.conf.input_indices = indices
                item.conf.output_size = item.conf.output_size or size
                cfg.operator_confs.append(item.conf)
        cfg.bias_parameter_name = _bias_name(self.name, size, self._bias_attr)
        _add_layer(cfg, self._layer_attr)


def mixed_layer(
    size: int = 0,
    input: Optional[Sequence[Union[_Projection, _Operator]]] = None,
    name: Optional[str] = None,
    act: Optional[BaseActivation] = None,
    bias_attr: Union[bool, ParameterAttribute] = False,
    layer_attr: Optional[ExtraLayerAttribute] = None,
) -> LayerOutput:
    name = _name(name, "mixed")
    m = _MixedLayer(name, size, act or IdentityActivation(), bias_attr, layer_attr)
    if input is not None:
        for item in _to_list(input):
            m += item
        m._finalize()
    return m


# ------------------------------------------------------------ basic layers


def data_layer(name: str, size: int, layer_attr=None) -> LayerOutput:
    cfg = LayerConfig(name=name, type="data", size=size)
    _add_layer(cfg, layer_attr)
    _ctx().mark_input(name)
    return LayerOutput(name, "data", size=size)


def fc_layer(
    input: Union[LayerOutput, Sequence[LayerOutput]],
    size: int,
    act: Optional[BaseActivation] = None,
    name: Optional[str] = None,
    param_attr: Optional[Union[ParameterAttribute, Sequence[ParameterAttribute]]] = None,
    bias_attr: Union[bool, ParameterAttribute] = True,
    layer_attr: Optional[ExtraLayerAttribute] = None,
) -> LayerOutput:
    name = _name(name, "fc")
    inputs = _to_list(input)
    attrs = param_attr if isinstance(param_attr, (list, tuple)) else [param_attr] * len(inputs)
    cfg = LayerConfig(name=name, type="fc", size=size, active_type=_act_name(act or TanhActivation()))
    for i, (inp, attr) in enumerate(zip(inputs, attrs)):
        pname = _create_parameter(
            f"_{name}.w{i}", inp.size * size, [inp.size, size], attr
        )
        cfg.inputs.append(_input(inp, pname))
    cfg.bias_parameter_name = _bias_name(name, size, bias_attr)
    _add_layer(cfg, layer_attr)
    return LayerOutput(name, "fc", inputs, size, act)


def embedding_layer(
    input: LayerOutput,
    size: int,
    name: Optional[str] = None,
    param_attr: Optional[ParameterAttribute] = None,
    layer_attr=None,
) -> LayerOutput:
    return mixed_layer(
        size=size,
        input=[table_projection(input, size, param_attr)],
        name=_name(name, "embedding"),
        act=IdentityActivation(),
        bias_attr=False,
        layer_attr=layer_attr,
    )


def sparse_embedding(
    input: LayerOutput,
    size: int,
    name: Optional[str] = None,
    param_attr: Optional[ParameterAttribute] = None,
    layer_attr=None,
) -> LayerOutput:
    """An :func:`embedding_layer` whose table trains on the row-sparse
    path (doc/sparse.md): ``sparse_update=True`` is forced onto the
    table's :class:`ParameterAttribute`, so gradients stay per-row
    (``RowSparseGrad``), optimizer slots update only touched rows, the
    durable checkpoint stamps ``row_range`` into the table's shard
    records, and multi-host relaunches reshard the rows. The config
    helper the CTR demo (demo/ctr/) builds its id features with."""
    if param_attr is None:
        param_attr = ParameterAttribute(sparse_update=True)
    else:
        param_attr.sparse_update = True
    return embedding_layer(
        input, size, name=_name(name, "sparse_embedding"),
        param_attr=param_attr, layer_attr=layer_attr,
    )


def pooling_layer(
    input: LayerOutput,
    pooling_type: Optional[BasePoolingType] = None,
    name: Optional[str] = None,
    bias_attr: Union[bool, ParameterAttribute] = False,
    agg_level: str = AggregateLevel.EACH_TIMESTEP,
    layer_attr=None,
) -> LayerOutput:
    pooling_type = pooling_type or MaxPooling()
    type_map = {"max": "max", "average": "average", "sum": "average", "squarerootn": "average"}
    ltype = type_map[pooling_type.name]
    name = _name(name, "pool")
    cfg = LayerConfig(name=name, type=ltype, size=input.size, trans_type=agg_level)
    if ltype == "average":
        cfg.average_strategy = pooling_type.name if pooling_type.name != "average" else "average"
    cfg.inputs.append(_input(input))
    cfg.bias_parameter_name = _bias_name(name, input.size, bias_attr)
    _add_layer(cfg, layer_attr)
    return LayerOutput(name, ltype, [input], input.size)


def lstmemory(
    input: LayerOutput,
    name: Optional[str] = None,
    reverse: bool = False,
    act: Optional[BaseActivation] = None,
    gate_act: Optional[BaseActivation] = None,
    state_act: Optional[BaseActivation] = None,
    bias_attr: Union[bool, ParameterAttribute] = True,
    param_attr: Optional[ParameterAttribute] = None,
    layer_attr=None,
) -> LayerOutput:
    assert input.size % 4 == 0, "lstmemory input size must be 4*size"
    size = input.size // 4
    name = _name(name, "lstmemory")
    cfg = LayerConfig(
        name=name,
        type="lstmemory",
        size=size,
        active_type=_act_name(act or TanhActivation()),
        active_gate_type=_act_name(gate_act or SigmoidActivation()),
        active_state_type=_act_name(state_act or TanhActivation()),
        reversed=reverse,
    )
    pname = _create_parameter(f"_{name}.w0", size * size * 4, [size, 4 * size], param_attr)
    cfg.inputs.append(_input(input, pname))
    if bias_attr is not False and bias_attr is not None:
        attr = bias_attr if isinstance(bias_attr, ParameterAttribute) else None
        bname = (attr.name if attr and attr.name else f"_{name}.wbias")
        if bname not in _ctx().param_map:
            bname = _create_parameter(bname, 7 * size, [1, 7 * size], attr, is_bias=True)
        cfg.bias_parameter_name = bname
    _add_layer(cfg, layer_attr)
    return LayerOutput(name, "lstmemory", [input], size, act, reverse)


def grumemory(
    input: LayerOutput,
    name: Optional[str] = None,
    reverse: bool = False,
    act: Optional[BaseActivation] = None,
    gate_act: Optional[BaseActivation] = None,
    bias_attr: Union[bool, ParameterAttribute] = True,
    param_attr: Optional[ParameterAttribute] = None,
    layer_attr=None,
) -> LayerOutput:
    assert input.size % 3 == 0, "grumemory input size must be 3*size"
    size = input.size // 3
    name = _name(name, "grumemory")
    cfg = LayerConfig(
        name=name,
        type="gated_recurrent",
        size=size,
        active_type=_act_name(act or TanhActivation()),
        active_gate_type=_act_name(gate_act or SigmoidActivation()),
        reversed=reverse,
    )
    pname = _create_parameter(f"_{name}.w0", size * size * 3, [size, 3 * size], param_attr)
    cfg.inputs.append(_input(input, pname))
    if bias_attr is not False and bias_attr is not None:
        attr = bias_attr if isinstance(bias_attr, ParameterAttribute) else None
        bname = (attr.name if attr and attr.name else f"_{name}.wbias")
        if bname not in _ctx().param_map:
            bname = _create_parameter(bname, 3 * size, [1, 3 * size], attr, is_bias=True)
        cfg.bias_parameter_name = bname
    _add_layer(cfg, layer_attr)
    return LayerOutput(name, "gated_recurrent", [input], size, act, reverse)


def recurrent_layer(
    input: LayerOutput,
    act: Optional[BaseActivation] = None,
    bias_attr: Union[bool, ParameterAttribute] = True,
    param_attr: Optional[ParameterAttribute] = None,
    name: Optional[str] = None,
    reverse: bool = False,
    layer_attr=None,
) -> LayerOutput:
    size = input.size
    name = _name(name, "recurrent")
    cfg = LayerConfig(
        name=name, type="recurrent", size=size, active_type=_act_name(act or TanhActivation()),
        reversed=reverse,
    )
    pname = _create_parameter(f"_{name}.w0", size * size, [size, size], param_attr)
    cfg.inputs.append(_input(input, pname))
    cfg.bias_parameter_name = _bias_name(name, size, bias_attr)
    _add_layer(cfg, layer_attr)
    return LayerOutput(name, "recurrent", [input], size, act, reverse)


def last_seq(
    input: LayerOutput,
    name: Optional[str] = None,
    agg_level: str = AggregateLevel.EACH_TIMESTEP,
    layer_attr=None,
) -> LayerOutput:
    name = _name(name, "seqlastins")
    cfg = LayerConfig(name=name, type="seqlastins", size=input.size, trans_type=agg_level)
    cfg.inputs.append(_input(input))
    _add_layer(cfg, layer_attr)
    return LayerOutput(name, "seqlastins", [input], input.size)


def first_seq(
    input: LayerOutput,
    name: Optional[str] = None,
    agg_level: str = AggregateLevel.EACH_TIMESTEP,
    layer_attr=None,
) -> LayerOutput:
    name = _name(name, "seqfirstins")
    cfg = LayerConfig(
        name=name, type="seqlastins", size=input.size, trans_type=agg_level, select_first=True
    )
    cfg.inputs.append(_input(input))
    _add_layer(cfg, layer_attr)
    return LayerOutput(name, "seqfirstins", [input], input.size)


def expand_layer(
    input: LayerOutput,
    expand_as: LayerOutput,
    name: Optional[str] = None,
    bias_attr: Union[bool, ParameterAttribute] = False,
    expand_level: str = ExpandLevel.FROM_TIMESTEP,
    layer_attr=None,
) -> LayerOutput:
    name = _name(name, "expand")
    cfg = LayerConfig(name=name, type="expand", size=input.size, trans_type=expand_level)
    cfg.inputs.append(_input(input))
    cfg.inputs.append(_input(expand_as))
    cfg.bias_parameter_name = _bias_name(name, input.size, bias_attr)
    _add_layer(cfg, layer_attr)
    return LayerOutput(name, "expand", [input, expand_as], input.size)


def interpolation_layer(input: Sequence[LayerOutput], weight: LayerOutput, name=None, layer_attr=None):
    a, b = input[0], input[1]
    name = _name(name, "interpolation")
    cfg = LayerConfig(name=name, type="interpolation", size=a.size)
    cfg.inputs.append(_input(weight))
    cfg.inputs.append(_input(a))
    cfg.inputs.append(_input(b))
    _add_layer(cfg, layer_attr)
    return LayerOutput(name, "interpolation", [weight, a, b], a.size)


def power_layer(input: LayerOutput, weight: LayerOutput, name=None, layer_attr=None):
    name = _name(name, "power")
    cfg = LayerConfig(name=name, type="power", size=input.size)
    cfg.inputs.append(_input(weight))
    cfg.inputs.append(_input(input))
    _add_layer(cfg, layer_attr)
    return LayerOutput(name, "power", [weight, input], input.size)


def scaling_layer(input: LayerOutput, weight: LayerOutput, name=None, layer_attr=None):
    name = _name(name, "scaling")
    cfg = LayerConfig(name=name, type="scaling", size=input.size)
    cfg.inputs.append(_input(weight))
    cfg.inputs.append(_input(input))
    _add_layer(cfg, layer_attr)
    return LayerOutput(name, "scaling", [weight, input], input.size)


def trans_layer(input: LayerOutput, name=None, layer_attr=None):
    name = _name(name, "trans")
    cfg = LayerConfig(name=name, type="trans", size=input.size)
    cfg.inputs.append(_input(input))
    _add_layer(cfg, layer_attr)
    return LayerOutput(name, "trans", [input], input.size)


def cos_sim(a: LayerOutput, b: LayerOutput, scale: float = 5.0, size: int = 1, name=None, layer_attr=None):
    name = _name(name, "cos")
    if size == 1:
        cfg = LayerConfig(name=name, type="cos", size=1, cos_scale=scale)
    else:
        cfg = LayerConfig(name=name, type="cos_vm", size=size, cos_scale=scale)
    cfg.inputs.append(_input(a))
    cfg.inputs.append(_input(b))
    _add_layer(cfg, layer_attr)
    return LayerOutput(name, cfg.type, [a, b], size)


def hsigmoid(
    input: Union[LayerOutput, Sequence[LayerOutput]],
    label: LayerOutput,
    num_classes: int,
    name: Optional[str] = None,
    bias_attr: Union[bool, ParameterAttribute] = True,
    param_attr: Optional[Union[ParameterAttribute, Sequence]] = None,
    layer_attr=None,
) -> LayerOutput:
    name = _name(name, "hsigmoid")
    inputs = _to_list(input)
    attrs = param_attr if isinstance(param_attr, (list, tuple)) else [param_attr] * len(inputs)
    cfg = LayerConfig(name=name, type="hsigmoid", size=1, num_classes=num_classes)
    for i, (inp, attr) in enumerate(zip(inputs, attrs)):
        pname = _create_parameter(
            f"_{name}.w{i}", (num_classes - 1) * inp.size, [num_classes - 1, inp.size], attr
        )
        cfg.inputs.append(_input(inp, pname))
    cfg.inputs.append(_input(label))
    cfg.bias_parameter_name = _bias_name(name, num_classes - 1, bias_attr)
    _add_layer(cfg, layer_attr)
    out = LayerOutput(name, "hsigmoid", inputs + [label], 1)
    _ctx().mark_output(name)
    return out


def _conv_out(img: int, f: int, p: int, s: int, caffe_mode: bool = True) -> int:
    if caffe_mode:
        return (img - f + 2 * p) // s + 1
    return (img - f + 2 * p + s - 1) // s + 1


def img_conv_layer(
    input: LayerOutput,
    filter_size: int,
    num_filters: int,
    name: Optional[str] = None,
    num_channels: Optional[int] = None,
    act: Optional[BaseActivation] = None,
    groups: int = 1,
    stride: int = 1,
    padding: int = 0,
    bias_attr: Union[bool, ParameterAttribute] = True,
    param_attr: Optional[ParameterAttribute] = None,
    shared_biases: bool = True,
    layer_attr=None,
    filter_size_y: Optional[int] = None,
    stride_y: Optional[int] = None,
    padding_y: Optional[int] = None,
) -> LayerOutput:
    name = _name(name, "conv")
    if num_channels is None:
        num_channels = input.num_filters if hasattr(input, "num_filters") and input.num_filters else 1
        if getattr(input, "num_filters", None) is None and input.size is not None:
            # infer: input is a square image with unknown channels = 1
            pass
    img_size = int(round(math.sqrt(input.size / num_channels)))
    assert img_size * img_size * num_channels == input.size, (
        f"img_conv_layer {name}: input size {input.size} does not factor into "
        f"{num_channels} x {img_size}^2"
    )
    out_x = _conv_out(img_size, filter_size, padding, stride)
    filter_channels = num_channels // groups
    cc = ConvConfig(
        filter_size=filter_size,
        channels=num_channels,
        stride=stride,
        padding=padding,
        groups=groups,
        filter_channels=filter_channels,
        output_x=out_x,
        img_size=img_size,
        filter_size_y=filter_size_y or filter_size,
        stride_y=stride_y or stride,
        padding_y=padding_y if padding_y is not None else padding,
    )
    cfg = LayerConfig(
        name=name,
        type="exconv",
        size=out_x * out_x * num_filters,
        active_type=_act_name(act or ReluActivation()),
        num_filters=num_filters,
        shared_biases=shared_biases,
    )
    fy = filter_size_y or filter_size
    wsize = num_filters * filter_channels * filter_size * fy
    pname = _create_parameter(
        f"_{name}.w0", wsize, [num_filters, filter_channels * filter_size * fy], param_attr
    )
    cfg.inputs.append(LayerInputConfig(input_layer_name=input.name, input_parameter_name=pname, conv_conf=cc))
    bias_size = num_filters if shared_biases else cfg.size
    cfg.bias_parameter_name = _bias_name(name, bias_size, bias_attr)
    _add_layer(cfg, layer_attr)
    out = LayerOutput(name, "exconv", [input], cfg.size, act)
    out.num_filters = num_filters
    out.img_size = out_x
    return out


def img_pool_layer(
    input: LayerOutput,
    pool_size: int,
    name: Optional[str] = None,
    num_channels: Optional[int] = None,
    pool_type: Optional[BasePoolingType] = None,
    stride: int = 1,
    start: int = 0,
    padding: int = 0,
    layer_attr=None,
    pool_size_y: Optional[int] = None,
    stride_y: Optional[int] = None,
    padding_y: Optional[int] = None,
) -> LayerOutput:
    name = _name(name, "pool")
    if num_channels is None:
        num_channels = getattr(input, "num_filters", None) or 1
    img_size = getattr(input, "img_size", None) or int(round(math.sqrt(input.size / num_channels)))
    pool_type = pool_type or MaxPooling()
    type_name = ("max" if pool_type.name == "max" else "avg") + "-projection"
    out_x = _conv_out(img_size, pool_size, padding, stride, caffe_mode=False)
    pc = PoolConfig(
        pool_type=type_name,
        channels=num_channels,
        size_x=pool_size,
        start=start,
        stride=stride,
        output_x=out_x,
        img_size=img_size,
        padding=padding,
        size_y=pool_size_y or pool_size,
        stride_y=stride_y or stride,
        padding_y=padding_y if padding_y is not None else padding,
        output_y=out_x,
        img_size_y=img_size,
    )
    cfg = LayerConfig(name=name, type="pool", size=out_x * out_x * num_channels)
    cfg.inputs.append(LayerInputConfig(input_layer_name=input.name, pool_conf=pc))
    _add_layer(cfg, layer_attr)
    out = LayerOutput(name, "pool", [input], cfg.size)
    out.num_filters = num_channels
    out.img_size = out_x
    return out


def img_cmrnorm_layer(
    input: LayerOutput,
    size: int,
    scale: float = 0.0128,
    power: float = 0.75,
    name: Optional[str] = None,
    num_channels: Optional[int] = None,
    layer_attr=None,
) -> LayerOutput:
    name = _name(name, "norm")
    if num_channels is None:
        num_channels = getattr(input, "num_filters", None) or 1
    img_size = getattr(input, "img_size", None) or int(round(math.sqrt(input.size / num_channels)))
    nc = NormConfig(
        norm_type="cmrnorm-projection",
        channels=num_channels,
        size=size,
        # the stored value is scale/size (reference config_parser.py
        # divides before writing the proto; the kernel uses it directly)
        scale=scale / size,
        pow=power,
        output_x=img_size,
        img_size=img_size,
    )
    cfg = LayerConfig(name=name, type="norm", size=input.size)
    cfg.inputs.append(LayerInputConfig(input_layer_name=input.name, norm_conf=nc))
    _add_layer(cfg, layer_attr)
    out = LayerOutput(name, "norm", [input], input.size)
    out.num_filters = num_channels
    out.img_size = img_size
    return out


def batch_norm_layer(
    input: LayerOutput,
    act: Optional[BaseActivation] = None,
    name: Optional[str] = None,
    num_channels: Optional[int] = None,
    bias_attr: Union[bool, ParameterAttribute] = True,
    param_attr: Optional[ParameterAttribute] = None,
    layer_attr=None,
    batch_norm_type: Optional[str] = None,
    moving_average_fraction: float = 0.9,
    use_global_stats: Optional[bool] = None,
) -> LayerOutput:
    name = _name(name, "batch_norm")
    if num_channels is None:
        num_channels = getattr(input, "num_filters", None) or input.size
    img_size = getattr(input, "img_size", None) or (
        int(round(math.sqrt(input.size / num_channels))) if input.size != num_channels else 0
    )
    ic = ImageConfig(channels=num_channels, img_size=img_size or 0)
    cfg = LayerConfig(
        name=name,
        type="batch_norm",
        size=input.size,
        active_type=_act_name(act or ReluActivation()),
        moving_average_fraction=moving_average_fraction,
        use_global_stats=bool(use_global_stats) if use_global_stats is not None else False,
    )
    gamma = _create_parameter(
        f"_{name}.w0",
        num_channels,
        [1, num_channels],
        param_attr or ParameterAttribute(initial_mean=1.0, initial_std=0.0),
    )
    cfg.inputs.append(LayerInputConfig(input_layer_name=input.name, input_parameter_name=gamma, image_conf=ic))
    # moving mean / variance: static state parameters
    mean_p = _create_parameter(
        f"_{name}.w1", num_channels, [1, num_channels],
        ParameterAttribute(initial_mean=0.0, initial_std=0.0, is_static=True),
    )
    var_p = _create_parameter(
        f"_{name}.w2", num_channels, [1, num_channels],
        ParameterAttribute(initial_mean=1.0, initial_std=0.0, is_static=True),
    )
    cfg.inputs.append(LayerInputConfig(input_parameter_name=mean_p))
    cfg.inputs.append(LayerInputConfig(input_parameter_name=var_p))
    cfg.bias_parameter_name = _bias_name(name, num_channels, bias_attr)
    _add_layer(cfg, layer_attr)
    out = LayerOutput(name, "batch_norm", [input], input.size, act)
    out.num_filters = num_channels if img_size else None
    out.img_size = img_size or None
    return out


def sum_to_one_norm_layer(input: LayerOutput, name=None, layer_attr=None):
    name = _name(name, "sum_to_one_norm")
    cfg = LayerConfig(name=name, type="sum_to_one_norm", size=input.size)
    cfg.inputs.append(_input(input))
    _add_layer(cfg, layer_attr)
    return LayerOutput(name, "sum_to_one_norm", [input], input.size)


def addto_layer(
    input: Union[LayerOutput, Sequence[LayerOutput]],
    act: Optional[BaseActivation] = None,
    name: Optional[str] = None,
    bias_attr: Union[bool, ParameterAttribute] = False,
    layer_attr=None,
) -> LayerOutput:
    name = _name(name, "addto")
    inputs = _to_list(input)
    cfg = LayerConfig(
        name=name, type="addto", size=inputs[0].size, active_type=_act_name(act or IdentityActivation())
    )
    for inp in inputs:
        cfg.inputs.append(_input(inp))
    cfg.bias_parameter_name = _bias_name(name, inputs[0].size, bias_attr)
    _add_layer(cfg, layer_attr)
    out = LayerOutput(name, "addto", inputs, inputs[0].size, act)
    out.num_filters = getattr(inputs[0], "num_filters", None)
    out.img_size = getattr(inputs[0], "img_size", None)
    return out


def concat_layer(
    input: Sequence[LayerOutput],
    act: Optional[BaseActivation] = None,
    name: Optional[str] = None,
    layer_attr=None,
) -> LayerOutput:
    name = _name(name, "concat")
    inputs = _to_list(input)
    if any(isinstance(i, _Projection) for i in inputs):
        # projections in the list -> concat2 (reference ConcatenateLayer2:
        # project each input, concatenate the projection outputs)
        assert all(isinstance(i, _Projection) for i in inputs), (
            "concat_layer: mix of projections and layers is not supported — "
            "wrap plain layers in identity_projection()"
        )
        def _c2_size(p):
            # per-projection output width; identity falls back to the
            # input width, identity_offset to the remaining slice, and
            # context to in_size * context_length (output_size helper)
            if p.type == "identity_offset":
                off = p.extra.get("offset", 0)
                assert 0 <= off < p.input.size, (
                    f"identity_projection offset {off} out of range for "
                    f"input of size {p.input.size}"
                )
                return p.size or (p.input.size - off)
            return p.output_size(p.input.size)

        sizes = [_c2_size(p) for p in inputs]
        size = sum(sizes)
        cfg = LayerConfig(
            name=name, type="concat2", size=size,
            active_type=_act_name(act or IdentityActivation()),
        )
        for idx, (p, out_size) in enumerate(zip(inputs, sizes)):
            cfg.inputs.append(p.materialize(name, out_size, idx))
        _add_layer(cfg, layer_attr)
        return LayerOutput(name, "concat2", [p.input for p in inputs], size, act)
    size = sum(i.size for i in inputs)
    cfg = LayerConfig(
        name=name, type="concat", size=size, active_type=_act_name(act or IdentityActivation())
    )
    for inp in inputs:
        cfg.inputs.append(_input(inp))
    _add_layer(cfg, layer_attr)
    return LayerOutput(name, "concat", inputs, size, act)


def dropout_layer(input: LayerOutput, dropout_rate: float, name=None) -> LayerOutput:
    return addto_layer(
        input=input,
        name=_name(name, "dropout"),
        act=IdentityActivation(),
        bias_attr=False,
        layer_attr=ExtraLayerAttribute(drop_rate=dropout_rate),
    )


# --------------------------------------------------- recurrent group DSL


def memory(
    name: str,
    size: int,
    is_seq: bool = False,
    boot_layer: Optional[LayerOutput] = None,
    boot_bias: Union[bool, ParameterAttribute, None] = None,
    boot_bias_active_type: Optional[BaseActivation] = None,
    boot_with_const_id: Optional[int] = None,
) -> LayerOutput:
    """Declare a recurrence edge: reads layer ``name``'s output from the
    previous timestep (reference: layers.py memory:1853)."""
    ctx = _ctx()
    assert ctx.in_recurrent_group, "memory() must be called inside a recurrent_group step"
    sub = ctx.current_submodel()
    agent_name = f"{name}@{sub.name}@memory"
    agent_cfg = LayerConfig(name=agent_name, type="agent", size=size)
    ctx.add_layer(agent_cfg)
    mem = MemoryConfig(layer_name=name, link_name=agent_name)
    if boot_layer is not None:
        mem.boot_layer_name = boot_layer.name
    if isinstance(boot_bias, ParameterAttribute) or boot_bias is True:
        attr = boot_bias if isinstance(boot_bias, ParameterAttribute) else None
        mem.boot_bias_parameter_name = _create_parameter(
            f"_{agent_name}.wbias", size, [1, size], attr, is_bias=True
        )
        mem.boot_bias_active_type = _act_name(boot_bias_active_type)
    if boot_with_const_id is not None:
        mem.boot_with_const_id = boot_with_const_id
    mem.is_sequence = is_seq
    sub.memories.append(mem)
    return LayerOutput(agent_name, "agent", [], size)



def _subseq_inlink_proxy(ctx, sub, outer, group_name):
    """Emit the nested in-link triple (sequence_scatter_agent layer,
    has_subseq LinkConfig, step proxy) shared by recurrent_group and
    beam_search."""
    agent_name = f"{outer.name}@{group_name}"
    ctx.add_layer(
        LayerConfig(name=agent_name, type="sequence_scatter_agent", size=outer.size)
    )
    sub.in_links.append(
        LinkConfig(layer_name=outer.name, link_name=agent_name, has_subseq=True)
    )
    return LayerOutput(agent_name, "sequence_scatter_agent", [outer], outer.size)


def recurrent_group(
    step: Callable,
    input,
    reverse: bool = False,
    name: Optional[str] = None,
) -> Union[LayerOutput, List[LayerOutput]]:
    """Build a recurrent sub-model from a per-timestep ``step`` function
    (reference: layers.py recurrent_group:2141). Sequence inputs are
    scattered per timestep; StaticInput passes whole; memory() edges carry
    state between steps."""
    ctx = _ctx()
    name = _name(name, "recurrent_group")
    inputs = _to_list(input)
    sub = ctx.begin_submodel(name)
    sub.reversed = reverse
    proxies: List[LayerOutput] = []
    for item in inputs:
        if isinstance(item, GeneratedInput):
            raise ValueError(
                "GeneratedInput is only valid with beam_search(); use "
                "beam_search(step=..., input=[...]) for generation groups"
            )
        if isinstance(item, SubsequenceInput):
            proxies.append(_subseq_inlink_proxy(ctx, sub, item.input, name))
        elif isinstance(item, StaticInput):
            outer = item.input
            agent_name = f"{outer.name}@{name}"
            ltype = "sequence_agent" if item.is_seq else "agent"
            ctx.add_layer(LayerConfig(name=agent_name, type=ltype, size=item.size))
            sub.static_links.append(LinkConfig(layer_name=outer.name, link_name=agent_name, has_subseq=item.is_seq))
            proxies.append(LayerOutput(agent_name, ltype, [outer], item.size))
        else:
            outer = item
            agent_name = f"{outer.name}@{name}"
            ctx.add_layer(LayerConfig(name=agent_name, type="scatter_agent", size=outer.size))
            sub.in_links.append(LinkConfig(layer_name=outer.name, link_name=agent_name))
            proxies.append(LayerOutput(agent_name, "scatter_agent", [outer], outer.size))
    outs = step(*proxies)
    out_list = _to_list(outs)
    for o in out_list:
        sub.out_links.append(LinkConfig(layer_name=o.name, link_name=o.name))
    ctx.end_submodel()
    # the parent-scope group layer that triggers sub-model execution
    group_cfg = LayerConfig(name=name, type="recurrent_layer_group", size=out_list[0].size)
    for item in inputs:
        outer = item.input if isinstance(item, (StaticInput, SubsequenceInput)) else item
        group_cfg.inputs.append(LayerInputConfig(input_layer_name=outer.name))
    for m in sub.memories:
        if m.boot_layer_name:
            group_cfg.inputs.append(LayerInputConfig(input_layer_name=m.boot_layer_name))
    ctx.add_layer(group_cfg)
    return outs


def lstm_step_layer(
    input: LayerOutput,
    state: LayerOutput,
    size: int,
    act: Optional[BaseActivation] = None,
    name: Optional[str] = None,
    gate_act: Optional[BaseActivation] = None,
    state_act: Optional[BaseActivation] = None,
    bias_attr: Union[bool, ParameterAttribute] = True,
    layer_attr=None,
) -> LayerOutput:
    name = _name(name, "lstm_step")
    cfg = LayerConfig(
        name=name,
        type="lstm_step",
        size=size,
        active_type=_act_name(act or TanhActivation()),
        active_gate_type=_act_name(gate_act or SigmoidActivation()),
        active_state_type=_act_name(state_act or TanhActivation()),
    )
    cfg.inputs.append(_input(input))
    cfg.inputs.append(_input(state))
    if bias_attr is not False and bias_attr is not None:
        attr = bias_attr if isinstance(bias_attr, ParameterAttribute) else None
        bname = attr.name if attr and attr.name else f"_{name}.wbias"
        if bname not in _ctx().param_map:
            bname = _create_parameter(bname, 7 * size, [1, 7 * size], attr, is_bias=True)
        cfg.bias_parameter_name = bname
    _add_layer(cfg, layer_attr)
    out = LayerOutput(name, "lstm_step", [input, state], size, act, outputs=["default", "state"])
    return out


def gru_step_layer(
    input: LayerOutput,
    output_mem: LayerOutput,
    size: Optional[int] = None,
    act: Optional[BaseActivation] = None,
    name: Optional[str] = None,
    gate_act: Optional[BaseActivation] = None,
    bias_attr: Union[bool, ParameterAttribute] = True,
    param_attr: Optional[ParameterAttribute] = None,
    layer_attr=None,
) -> LayerOutput:
    size = size or input.size // 3
    name = _name(name, "gru_step")
    cfg = LayerConfig(
        name=name,
        type="gru_step",
        size=size,
        active_type=_act_name(act or TanhActivation()),
        active_gate_type=_act_name(gate_act or SigmoidActivation()),
    )
    pname = _create_parameter(f"_{name}.w0", size * size * 3, [size, 3 * size], param_attr)
    cfg.inputs.append(_input(input, pname))
    cfg.inputs.append(_input(output_mem))
    cfg.bias_parameter_name = _bias_name(name, 3 * size, bias_attr)
    _add_layer(cfg, layer_attr)
    return LayerOutput(name, "gru_step", [input, output_mem], size, act)


def get_output_layer(input: LayerOutput, arg_name: str, name=None, layer_attr=None) -> LayerOutput:
    name = _name(name, "get_output")
    cfg = LayerConfig(name=name, type="get_output", size=input.size)
    cfg.inputs.append(
        LayerInputConfig(input_layer_name=input.name, input_layer_argument=arg_name)
    )
    _add_layer(cfg, layer_attr)
    return LayerOutput(name, "get_output", [input], input.size)


def maxid_layer(input: LayerOutput, name=None, layer_attr=None) -> LayerOutput:
    name = _name(name, "maxid")
    cfg = LayerConfig(name=name, type="maxid", size=1)
    cfg.inputs.append(_input(input))
    _add_layer(cfg, layer_attr)
    return LayerOutput(name, "maxid", [input], 1)


def eos_layer(input: LayerOutput, eos_id: int, name=None, layer_attr=None) -> LayerOutput:
    name = _name(name, "eos")
    cfg = LayerConfig(name=name, type="eos_id", size=1, eos_id=eos_id)
    cfg.inputs.append(_input(input))
    _add_layer(cfg, layer_attr)
    return LayerOutput(name, "eos_id", [input], 1)


def beam_search(
    step: Callable,
    input,
    bos_id: int,
    eos_id: int,
    beam_size: int,
    max_length: int = 500,
    name: Optional[str] = None,
    num_results_per_sample: Optional[int] = None,
    id_input=None,
    dict_file: Optional[str] = None,
    result_file: Optional[str] = None,
) -> LayerOutput:
    """Configure beam-search generation over a recurrent step function
    (reference: layers.py beam_search:2363). The GeneratedInput in
    ``input`` names the embedding used to feed back generated tokens."""
    ctx = _ctx()
    name = _name(name, "beam_search")
    num_results_per_sample = num_results_per_sample or beam_size
    inputs = _to_list(input)
    gen: Optional[GeneratedInput] = None
    real_inputs = []
    gen_pos = 0
    for i, item in enumerate(inputs):
        if isinstance(item, GeneratedInput):
            assert gen is None, "only one GeneratedInput allowed"
            gen = item
            gen_pos = i
        else:
            real_inputs.append(item)
    assert gen is not None, "beam_search needs a GeneratedInput"

    sub = ctx.begin_submodel(name)
    proxies = []
    for item in real_inputs:
        outer = item.input if isinstance(item, (StaticInput, SubsequenceInput)) else item
        agent_name = f"{outer.name}@{name}"
        if isinstance(item, StaticInput):
            ltype = "sequence_agent" if item.is_seq else "agent"
            ctx.add_layer(LayerConfig(name=agent_name, type=ltype, size=item.size))
            sub.static_links.append(
                LinkConfig(layer_name=outer.name, link_name=agent_name, has_subseq=item.is_seq)
            )
            proxies.append(LayerOutput(agent_name, ltype, [outer], item.size))
        elif isinstance(item, SubsequenceInput):
            # nested in-link: each generated step consumes one whole
            # subsequence (the step sees it as a flat sequence)
            proxies.append(_subseq_inlink_proxy(ctx, sub, outer, name))
        else:
            ctx.add_layer(LayerConfig(name=agent_name, type="scatter_agent", size=outer.size))
            sub.in_links.append(LinkConfig(layer_name=outer.name, link_name=agent_name))
            proxies.append(LayerOutput(agent_name, "scatter_agent", [outer], outer.size))
    # the predecessor-token embedding: a table projection over the ids
    # generated at the previous step, fed through the shared embedding.
    predict_id_name = f"__generated_id@{name}"
    ctx.add_layer(LayerConfig(name=predict_id_name, type="agent", size=1))
    emb = mixed_layer(
        size=gen.embedding_size,
        input=[
            table_projection(
                LayerOutput(predict_id_name, "agent", [], gen.size),
                gen.embedding_size,
                ParameterAttribute(name=gen.embedding_name),
            )
        ],
        name=f"__generated_emb@{name}",
        bias_attr=False,
    )
    proxies.insert(gen_pos, emb)
    outs = step(*proxies)
    out = outs if isinstance(outs, LayerOutput) else outs[0]
    sub.out_links.append(LinkConfig(layer_name=out.name, link_name=out.name))
    sub.generator = GeneratorConfig(
        max_num_frames=max_length,
        eos_layer_name="",
        num_results_per_sample=num_results_per_sample,
        beam_size=beam_size,
        result_file=result_file or "",
        dict_file=dict_file or "",
        id_input_layer=id_input.name if id_input is not None else "",
    )
    # record bos/eos on the scoring layer config for the executor
    score_cfg = ctx.get_layer(out.name)
    score_cfg.bos_id = bos_id
    score_cfg.eos_id = eos_id
    ctx.end_submodel()
    group_cfg = LayerConfig(
        name=name, type="recurrent_layer_group", size=out.size, bos_id=bos_id, eos_id=eos_id,
        beam_size=beam_size,
    )
    for item in real_inputs:
        outer = item.input if isinstance(item, (StaticInput, SubsequenceInput)) else item
        group_cfg.inputs.append(LayerInputConfig(input_layer_name=outer.name))
    for m in sub.memories:
        if m.boot_layer_name:
            group_cfg.inputs.append(LayerInputConfig(input_layer_name=m.boot_layer_name))
    ctx.add_layer(group_cfg)
    result = LayerOutput(name, "recurrent_layer_group", real_inputs, out.size)
    _ctx().mark_output(name)
    return result


# ------------------------------------------------------------------ costs


def _cost_layer(
    cost_type: str,
    name: str,
    inputs: List[LayerOutput],
    coeff: float = 1.0,
    **cfg_kw,
) -> LayerOutput:
    cfg = LayerConfig(name=name, type=cost_type, size=1, coeff=coeff, **cfg_kw)
    for inp in inputs:
        cfg.inputs.append(_input(inp))
    _add_layer(cfg)
    out = LayerOutput(name, cost_type, inputs, 1)
    _ctx().mark_output(name)
    return out


def regression_cost(input: LayerOutput, label: LayerOutput, cost: str = "square_error", name=None):
    return _cost_layer(cost, _name(name, "cost"), [input, label])


def classification_cost(
    input: LayerOutput,
    label: LayerOutput,
    name: Optional[str] = None,
    cost: str = "multi-class-cross-entropy",
    evaluator=None,
    coeff: float = 1.0,
) -> LayerOutput:
    name = _name(name, "cost")
    out = _cost_layer(cost, name, [input, label], coeff=coeff)
    # default classification-error evaluator (reference behavior)
    from paddle_tpu_torch.trainer_config_helpers.evaluators import classification_error_evaluator

    if evaluator is None:
        evaluator = classification_error_evaluator
    evaluator(input=input, label=label, name=f"{name}.classification_error")
    return out


def auc_validation(input, label, weight=None, name=None, coeff=1.0):
    """AUC validation layer (ref: AucValidation,
    paddle/gserver/layers/ValidationLayer.h:52, registered cost type
    'auc-validation', config_parser.py:1703): a zero-gradient cost-family
    node; its AUC accumulates in the evaluator runtime and reports at
    every log period and pass end."""
    name = _name(name, "auc_validation")
    inputs = [input, label] + ([weight] if weight is not None else [])
    out = _cost_layer("auc-validation", name, inputs, coeff=coeff)
    from paddle_tpu_torch.trainer_config_helpers.evaluators import evaluator_base

    evaluator_base("last-column-auc", [input, label], weight=weight,
                   name=f"{name}.auc")
    return out


def pnpair_validation(input, label, info, weight=None, name=None, coeff=1.0):
    """Positive-negative pair validation layer (ref: PnpairValidation,
    paddle/gserver/layers/ValidationLayer.h:84, cost type
    'pnpair-validation', config_parser.py:1704): info carries the query id
    grouping; pair ordering accuracy reports via the evaluator runtime."""
    name = _name(name, "pnpair_validation")
    inputs = [input, label, info] + ([weight] if weight is not None else [])
    out = _cost_layer("pnpair-validation", name, inputs, coeff=coeff)
    from paddle_tpu_torch.trainer_config_helpers.evaluators import evaluator_base

    evaluator_base("pnpair", [input, label, info], weight=weight,
                   name=f"{name}.pnpair")
    return out


def cross_entropy(input, label, name=None, coeff=1.0):
    return _cost_layer("multi-class-cross-entropy", _name(name, "cost"), [input, label], coeff)


def cross_entropy_with_selfnorm(input, label, name=None, coeff=1.0, softmax_selfnorm_alpha=0.1):
    return _cost_layer(
        "multi_class_cross_entropy_with_selfnorm",
        _name(name, "cost"),
        [input, label],
        coeff,
        softmax_selfnorm_alpha=softmax_selfnorm_alpha,
    )


def huber_cost(input, label, name=None, coeff=1.0):
    return _cost_layer("huber", _name(name, "cost"), [input, label], coeff)


def multi_binary_label_cross_entropy(input, label, name=None, coeff=1.0):
    return _cost_layer("multi_binary_label_cross_entropy", _name(name, "cost"), [input, label], coeff)


def rank_cost(left, right, lable=None, label=None, weight=None, name=None, coeff=1.0):
    # (the reference misspells the arg as `lable`; accept both)
    lab = label if label is not None else lable
    ins = [left, right, lab] + ([weight] if weight is not None else [])
    return _cost_layer("rank-cost", _name(name, "cost"), ins, coeff)


def lambda_cost(input, score, NDCG_num=5, max_sort_size=-1, coeff=1.0, name=None):
    return _cost_layer(
        "lambda_cost",
        _name(name, "cost"),
        [input, score],
        coeff,
        NDCG_num=NDCG_num,
        max_sort_size=max_sort_size,
    )


def ctc_layer(input, label, size, name=None, norm_by_times=False):
    name = _name(name, "ctc")
    cfg = LayerConfig(name=name, type="ctc", size=size, norm_by_times=norm_by_times)
    cfg.inputs.append(_input(input))
    cfg.inputs.append(_input(label))
    _add_layer(cfg)
    out = LayerOutput(name, "ctc", [input, label], size)
    _ctx().mark_output(name)
    return out


def crf_layer(input, label, size=None, weight=None, param_attr=None, name=None):
    size = size or input.size
    name = _name(name, "crf")
    cfg = LayerConfig(name=name, type="crf", size=size)
    pname = _create_parameter(f"_{name}.w0", (size + 2) * size, [size + 2, size], param_attr)
    cfg.inputs.append(_input(input, pname))
    cfg.inputs.append(_input(label))
    if weight is not None:
        cfg.inputs.append(_input(weight))
    _add_layer(cfg)
    out = LayerOutput(name, "crf", [input, label], size)
    _ctx().mark_output(name)
    return out


def crf_decoding_layer(input, size=None, label=None, param_attr=None, name=None):
    size = size or input.size
    name = _name(name, "crf_decoding")
    cfg = LayerConfig(name=name, type="crf_decoding", size=size)
    pname = _create_parameter(f"_{name}.w0", (size + 2) * size, [size + 2, size], param_attr)
    cfg.inputs.append(_input(input, pname))
    if label is not None:
        cfg.inputs.append(_input(label))
    _add_layer(cfg)
    return LayerOutput(name, "crf_decoding", [input], size)


def nce_layer(
    input,
    label,
    num_classes,
    weight=None,
    num_neg_samples=10,
    neg_distribution=None,
    name=None,
    bias_attr=True,
    param_attr=None,
):
    name = _name(name, "nce")
    inputs = _to_list(input)
    attrs = param_attr if isinstance(param_attr, (list, tuple)) else [param_attr] * len(inputs)
    cfg = LayerConfig(
        name=name, type="nce", size=1, num_classes=num_classes, num_neg_samples=num_neg_samples
    )
    if neg_distribution is not None:
        cfg.neg_sampling_dist = list(neg_distribution)
    for i, (inp, attr) in enumerate(zip(inputs, attrs)):
        pname = _create_parameter(
            f"_{name}.w{i}", num_classes * inp.size, [num_classes, inp.size], attr
        )
        cfg.inputs.append(_input(inp, pname))
    cfg.inputs.append(_input(label))
    if weight is not None:
        cfg.inputs.append(_input(weight))
    cfg.bias_parameter_name = _bias_name(name, num_classes, bias_attr)
    _add_layer(cfg)
    out = LayerOutput(name, "nce", inputs + [label], 1)
    _ctx().mark_output(name)
    return out


# ----------------------------------------------------------- other layers


def conv_shift_layer(input: Sequence[LayerOutput], name=None):
    a, b = input[0], input[1]
    name = _name(name, "conv_shift")
    cfg = LayerConfig(name=name, type="conv_shift", size=a.size)
    cfg.inputs.append(_input(a))
    cfg.inputs.append(_input(b))
    _add_layer(cfg)
    return LayerOutput(name, "conv_shift", [a, b], a.size)


def tensor_layer(
    input: Sequence[LayerOutput],
    size: int,
    act=None,
    name=None,
    param_attr=None,
    bias_attr=True,
    layer_attr=None,
) -> LayerOutput:
    a, b = input[0], input[1]
    name = _name(name, "tensor")
    cfg = LayerConfig(name=name, type="tensor", size=size, active_type=_act_name(act or TanhActivation()))
    pname = _create_parameter(
        f"_{name}.w0", a.size * size * b.size, [a.size, size * b.size], param_attr
    )
    cfg.inputs.append(_input(a, pname))
    cfg.inputs.append(_input(b))
    cfg.bias_parameter_name = _bias_name(name, size, bias_attr)
    _add_layer(cfg, layer_attr)
    return LayerOutput(name, "tensor", [a, b], size, act)


def selective_fc_layer(
    input,
    size,
    select=None,
    act=None,
    name=None,
    pass_generation=False,
    has_selected_colums=True,
    mul_ratio=0.02,
    param_attr=None,
    bias_attr=True,
    layer_attr=None,
) -> LayerOutput:
    name = _name(name, "selective_fc")
    inputs = _to_list(input)
    attrs = param_attr if isinstance(param_attr, (list, tuple)) else [param_attr] * len(inputs)
    cfg = LayerConfig(
        name=name,
        type="selective_fc",
        size=size,
        active_type=_act_name(act or TanhActivation()),
        selective_fc_pass_generation=pass_generation,
        has_selected_colums=has_selected_colums,
        selective_fc_full_mul_ratio=mul_ratio,
    )
    for i, (inp, attr) in enumerate(zip(inputs, attrs)):
        pname = _create_parameter(f"_{name}.w{i}", inp.size * size, [inp.size, size], attr)
        cfg.inputs.append(_input(inp, pname))
    if select is not None:
        cfg.inputs.append(_input(select))
    cfg.bias_parameter_name = _bias_name(name, size, bias_attr)
    _add_layer(cfg, layer_attr)
    return LayerOutput(name, "selective_fc", inputs, size, act)


def sampling_id_layer(input: LayerOutput, name=None) -> LayerOutput:
    name = _name(name, "sampling_id")
    cfg = LayerConfig(name=name, type="sampling_id", size=1)
    cfg.inputs.append(_input(input))
    _add_layer(cfg)
    return LayerOutput(name, "sampling_id", [input], 1)


def slope_intercept_layer(input: LayerOutput, name=None, slope=1.0, intercept=0.0) -> LayerOutput:
    name = _name(name, "slope_intercept")
    cfg = LayerConfig(name=name, type="slope_intercept", size=input.size, slope=slope, intercept=intercept)
    cfg.inputs.append(_input(input))
    _add_layer(cfg)
    return LayerOutput(name, "slope_intercept", [input], input.size)


def convex_comb_layer(input: Sequence[LayerOutput], size: int, name=None) -> LayerOutput:
    w, v = input[0], input[1]
    name = _name(name, "convex_comb")
    cfg = LayerConfig(name=name, type="convex_comb", size=size)
    cfg.inputs.append(_input(w))
    cfg.inputs.append(_input(v))
    _add_layer(cfg)
    return LayerOutput(name, "convex_comb", [w, v], size)


def block_expand_layer(
    input: LayerOutput,
    channel: int = 0,
    block_x: int = 0,
    block_y: int = 0,
    stride_x: int = 0,
    stride_y: int = 0,
    padding_x: int = 0,
    padding_y: int = 0,
    name=None,
) -> LayerOutput:
    name = _name(name, "blockexpand")
    img_x = getattr(input, "img_size", None) or int(round(math.sqrt(input.size / channel)))
    out_x = (img_x + 2 * padding_x - block_x + stride_x - 1) // stride_x + 1
    out_y = (img_x + 2 * padding_y - block_y + stride_y - 1) // stride_y + 1
    bc = BlockExpandConfig(
        channels=channel,
        stride_x=stride_x,
        stride_y=stride_y,
        padding_x=padding_x,
        padding_y=padding_y,
        block_x=block_x,
        block_y=block_y,
        output_x=out_x,
        output_y=out_y,
        img_size_x=img_x,
        img_size_y=img_x,
    )
    size = channel * block_x * block_y
    cfg = LayerConfig(name=name, type="blockexpand", size=size)
    cfg.inputs.append(LayerInputConfig(input_layer_name=input.name, block_expand_conf=bc))
    _add_layer(cfg)
    return LayerOutput(name, "blockexpand", [input], size)


def out_prod_layer(a: LayerOutput, b: LayerOutput, name=None) -> LayerOutput:
    name = _name(name, "out_prod")
    cfg = LayerConfig(name=name, type="out_prod", size=a.size * b.size)
    cfg.inputs.append(_input(a))
    cfg.inputs.append(_input(b))
    _add_layer(cfg)
    return LayerOutput(name, "out_prod", [a, b], a.size * b.size)


def multiplex_layer(input: Sequence[LayerOutput], name=None) -> LayerOutput:
    name = _name(name, "multiplex")
    inputs = _to_list(input)
    cfg = LayerConfig(name=name, type="multiplex", size=inputs[1].size)
    for inp in inputs:
        cfg.inputs.append(_input(inp))
    _add_layer(cfg)
    return LayerOutput(name, "multiplex", inputs, inputs[1].size)


def multi_head_attention_layer(
    input: LayerOutput,
    num_heads: int,
    size: Optional[int] = None,
    name: Optional[str] = None,
    causal: bool = False,
    seq_parallel: str = "",
    act: Optional[BaseActivation] = None,
    param_attr: Optional[ParameterAttribute] = None,
    bias_attr: Union[bool, ParameterAttribute] = False,
    layer_attr=None,
) -> LayerOutput:
    """Transformer-style multi-head self-attention over a sequence (TPU
    extension; the reference's only attention is simple_attention inside
    recurrent groups). ``seq_parallel``: "" | "ring" | "alltoall" — shard
    the context over the mesh "seq" axis (paddle_tpu_torch.parallel.
    sequence_parallel)."""
    assert seq_parallel in ("", "ring", "alltoall"), (
        f"seq_parallel must be '', 'ring' or 'alltoall', got {seq_parallel!r}"
    )
    name = _name(name, "mha")
    size = size or input.size
    cfg = LayerConfig(
        name=name,
        type="multi_head_attention",
        size=size,
        active_type=_act_name(act or IdentityActivation()),
    )
    cfg.num_heads = num_heads
    cfg.causal_attention = causal
    cfg.seq_parallel_mode = seq_parallel
    wqkv = _create_parameter(
        f"_{name}.wqkv", input.size * 3 * size, [input.size, 3 * size], param_attr
    )
    _create_parameter(f"_{name}.wo", size * size, [size, size], param_attr)
    cfg.inputs.append(_input(input, wqkv))
    cfg.bias_parameter_name = _bias_name(name, size, bias_attr)
    _add_layer(cfg, layer_attr)
    return LayerOutput(name, "multi_head_attention", [input], size, act)


def mdlstm_layer(
    input: LayerOutput,
    size: Optional[int] = None,
    directions: Sequence[bool] = (True, True),
    name: Optional[str] = None,
    act: Optional[BaseActivation] = None,
    gate_act: Optional[BaseActivation] = None,
    state_act: Optional[BaseActivation] = None,
    param_attr: Optional[ParameterAttribute] = None,
    bias_attr: Union[bool, ParameterAttribute] = True,
    layer_attr=None,
) -> LayerOutput:
    """Multi-dimensional LSTM over a 2-D grid (ref: config_parser.py:2608
    MDLstmLayer / MDLstmLayer.cpp). ``input`` holds the precomputed
    x-projections, size (3+len(directions))*size, over a nested
    [B, H, W, ...] grid; directions[d]=False scans dim d backwards."""
    D = len(directions)
    name = _name(name, "mdlstm")
    size = size or input.size // (3 + D)
    assert input.size == (3 + D) * size, (
        f"mdlstm input size {input.size} must be (3+{D})*size (= {(3 + D) * size})"
    )
    cfg = LayerConfig(
        name=name,
        type="mdlstmemory",
        size=size,
        active_type=_act_name(act or TanhActivation()),
        active_gate_type=_act_name(gate_act or SigmoidActivation()),
        active_state_type=_act_name(state_act or SigmoidActivation()),
    )
    cfg.directions = [bool(d) for d in directions]
    pname = _create_parameter(
        f"_{name}.w0", size * size * (3 + D), [size, (3 + D) * size], param_attr
    )
    cfg.inputs.append(_input(input, pname))
    cfg.bias_parameter_name = _bias_name(name, (5 + 2 * D) * size, bias_attr)
    _add_layer(cfg, layer_attr)
    return LayerOutput(name, "mdlstmemory", [input], size, act)


class sub_network:
    """Plain (non-recurrent) sub-network — multi-task / multi_nn configs.

    TPU analog of the reference's MultiNetwork machine
    (/root/reference/paddle/gserver/gradientmachines/MultiNetwork.h:25,
    selected by ModelConfig.type == 'multi_nn'): each ``with
    sub_network("task"):`` block is an independent sub-graph with its own
    data layers and cost; all of them train jointly in ONE fused step
    (their costs sum into the total loss), replacing the reference's
    split-by-dataId argument multiplexing.
    """

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        ctx = _ctx()
        ctx.model.type = "multi_nn"
        self.sub = ctx.begin_submodel(self.name, recurrent=False)
        return self.sub

    def __exit__(self, exc_type, exc, tb):
        _ctx().end_submodel()
        return False
