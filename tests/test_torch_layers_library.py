"""The layer library's tail against the JAX package, on the CPU.

Each case builds a small config with the DSL (explicit layer names), parses
it with the JAX package, takes ``init_params`` across with
``paddle_tpu_torch.bridge.params_from_numpy`` and runs the JAX forward with
``jax.grad`` beside the port's forward with autograd, on one seeded batch
with ragged lengths: every layer's output (the valid steps of a sequence)
within 1e-5 of max(1, max |JAX|), the loss within 1e-5 relative, and every
parameter's gradient within 1e-4 of max(1, max |JAX gradient|). Types the
DSL has no wrapper for run at the registry level: the layer function of
each package on the same config and inputs, with the gradient of a fixed
random projection of the output. ``jax.grad`` is compared directly: the
JAX package's ``check_gradient`` is broken on jax 0.9.0.

Also: the port's layer and activation registries are the JAX package's,
``mdlstmemory`` included (its cases are in ``tests/test_torch_nested.py``).
"""

import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.graph  # noqa: F401  (the JAX package's layers<->graph import order)
from paddle_tpu.config import parse_config as jax_parse_config
from paddle_tpu.graph import GradientMachine as JaxMachine
from paddle_tpu.graph.argument import Argument as JArg
from paddle_tpu.layers.base import LayerContext as JCtx
from paddle_tpu.layers.base import layer_registry as jax_layers
from paddle_tpu.ops.activations import activation_registry as jax_acts
from paddle_tpu.proto import LayerConfig as JLayerConfig
from paddle_tpu.proto import ModelConfig as JModelConfig
from paddle_tpu_torch.bridge import params_from_numpy
from paddle_tpu_torch.graph import GradientMachine
from paddle_tpu_torch.graph.argument import Argument
from paddle_tpu_torch.layers.base import NOT_PORTED, LayerContext, forward_layer, layer_registry
from paddle_tpu_torch.ops.activations import activation_registry
from paddle_tpu_torch.proto import LayerConfig, LayerInputConfig, ModelConfig

torch.set_num_threads(1)
OUT_TOL, GRAD_TOL = 1e-5, 1e-4
B, T = 4, 5
LENGTHS = np.array([5, 3, 1, 4], np.int32)

HEAD = """
from paddle.trainer_config_helpers import *
settings(batch_size=4, learning_rate=0.1)
"""
# a dense top through a softmax classifier
DENSE_TAIL = """
out = fc_layer(input=top, size=3, act=SoftmaxActivation(), name='out')
outputs(classification_cost(input=out, label=data_layer('label', size=3), name='cost'))
"""
# a sequence top pooled first
SEQ_TAIL = """
top = pooling_layer(input=top, pooling_type=AvgPooling(), name='pool')
""" + DENSE_TAIL


def _rand(shape, seed, positive=False):
    v = np.random.RandomState(seed).rand(*shape).astype(np.float32)
    return v + 0.1 if positive else v - 0.5


def dense(width, seed, positive=False):
    return {"value": _rand((B, width), seed, positive)}


def seq(width, seed, lengths=LENGTHS):
    return {"value": _rand((B, T, width), seed), "lengths": lengths}


def ids(n, seed, shape=(B,)):
    return {"ids": np.random.RandomState(seed).randint(0, n, shape).astype(np.int32)}


def id_seq(n, seed, lengths=LENGTHS):
    return dict(ids(n, seed, (B, T)), lengths=lengths)


def _jax_arg(spec):
    get = lambda k, dt=None: None if spec.get(k) is None else jnp.asarray(spec[k], dt)  # noqa
    return JArg(value=get("value"), ids=get("ids", jnp.int32), seq_lengths=get("lengths", jnp.int32))


def _port_arg(spec):
    get = lambda k, dt=None: None if spec.get(k) is None else torch.as_tensor(spec[k], dtype=dt)  # noqa
    return Argument(value=get("value", torch.float32), ids=get("ids", torch.int32),
                    seq_lengths=get("lengths", torch.int32))


def _valid_rows(x, lengths):
    """x [B, T, ...] with the steps at or past each length zeroed."""
    keep = np.arange(x.shape[1])[None, :] < np.asarray(lengths)[:, None]
    return np.where(keep.reshape(keep.shape + (1,) * (x.ndim - 2)), x, 0)


def assert_pad_rows_zero(arg, what):
    """The port's steps at or past each of ``arg``'s lengths are exactly 0:
    downstream pooling and costs mask by length, and the JAX values there
    are not held."""
    v = arg.value.detach().numpy()
    pad = v - _valid_rows(v, arg.seq_lengths.numpy())
    assert not np.any(pad), f"{what}: pad rows not 0 ({int((pad != 0).sum())} values)"


# the layers that remake a sequence's steps: their padded steps must be 0
ZERO_PAD = ("seqconcat", "seqreshape", "subseq")


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.size == 0:
        return
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max abs err {err} > {tol} * {scale}"


def compare_outputs(jouts, pouts, skip=()):
    """Every layer both packages output: values on the valid steps, ids equal."""
    checked = 0
    for name, j in jouts.items():
        p = pouts.get(name)
        if p is None or name in skip:
            continue
        lengths = None if j.seq_lengths is None else np.asarray(j.seq_lengths)
        if j.seq_lengths is not None:
            assert np.array_equal(np.asarray(p.seq_lengths), lengths), name
        if j.value is not None:
            want = np.asarray(j.value)
            got = p.value.detach().numpy()
            if lengths is not None and want.ndim == 3:
                want, got = _valid_rows(want, lengths), _valid_rows(got, lengths)
            _close(got, want, OUT_TOL, f"output {name}")
        if j.ids is not None:
            want, got = np.asarray(j.ids), p.ids.numpy()
            if lengths is not None and want.ndim == 2:
                want, got = _valid_rows(want, lengths), _valid_rows(got, lengths)
            assert np.array_equal(got, want), (name, got, want)
        checked += 1
    return checked


def run_config(tmp_path, body, feed, seed=7):
    """Parse `body` with the JAX package, run both machines' loss and
    gradients from the same parameters; returns (JAX outputs, port outputs)."""
    path = tmp_path / "conf.py"
    path.write_text(HEAD + textwrap.dedent(body))
    jtc = jax_parse_config(str(path))
    jm = JaxMachine(jtc.model_config)
    # jitted whole: one compile a case, not one per eager op
    jparams = jax.jit(lambda: jm.init_params(seed=seed))()
    jloss, jgrads, jouts, _ = jax.jit(jm.grad_fn(sparse=False))(
        jparams, {k: _jax_arg(s) for k, s in feed.items()}, jax.random.PRNGKey(0))
    pm = GradientMachine(ModelConfig.from_json(jtc.model_config.to_json()), device="cpu")
    pparams = params_from_numpy({k: np.asarray(v) for k, v in jparams.items()}, "cpu")
    ploss, pgrads, pouts, _ = pm.grad_fn()(pparams, {k: _port_arg(s) for k, s in feed.items()},
                                           seed=1)
    _close(float(ploss), float(jloss), OUT_TOL * max(1.0, abs(float(jloss))), "loss")
    assert compare_outputs(jouts, pouts) >= 2
    assert sorted(pgrads) == sorted(jgrads)
    for name in jgrads:
        _close(pgrads[name].numpy(), np.asarray(jgrads[name]), GRAD_TOL, f"grad {name}")
    return jtc.model_config, jouts, pouts


LABEL = {"label": ids(3, 9)}

# (config body, feed): each case's layer type must appear in the parsed config
CONFIG_CASES = {
    "context": (
        "emb = embedding_layer(input=data_layer('w', size=20), size=6, name='emb')\n"
        "top = mixed_layer(size=18, input=[context_projection(emb, context_len=3)],"
        " name='ctx')\n" + SEQ_TAIL,
        dict(w=id_seq(20, 1), **LABEL)),
    "context_trainable_padding": (
        "emb = embedding_layer(input=data_layer('w', size=20), size=6, name='emb')\n"
        "top = mixed_layer(size=30, input=[context_projection(emb, context_len=5,"
        " context_start=-1, padding_attr=ParamAttr(name='_ctx_pad'))], name='ctx')\n"
        + SEQ_TAIL,
        dict(w=id_seq(20, 1), **LABEL)),
    "context_trainable_padding_before": (
        "emb = embedding_layer(input=data_layer('w', size=20), size=6, name='emb')\n"
        "top = mixed_layer(size=24, input=[context_projection(emb, context_len=4,"
        " context_start=-3, padding_attr=ParamAttr(name='_ctx_pad'))], name='ctx')\n"
        + SEQ_TAIL,
        dict(w=id_seq(20, 1), **LABEL)),
    "trans_fc": (
        "a = fc_layer(input=data_layer('a', size=8), size=5, name='a_fc')\n"
        "top = mixed_layer(size=6, input=[trans_full_matrix_projection(a, size=6)],"
        " name='tfc')\n" + DENSE_TAIL,
        dict(a=dense(8, 1), **LABEL)),
    "dot_mul": (
        "a = fc_layer(input=data_layer('a', size=8), size=5, name='a_fc')\n"
        "top = mixed_layer(size=5, input=[dotmul_projection(a)], name='dm')\n" + DENSE_TAIL,
        dict(a=dense(8, 1), **LABEL)),
    "identity_offset": (
        "a = fc_layer(input=data_layer('a', size=8), size=7, name='a_fc')\n"
        "top = mixed_layer(size=3, input=[identity_projection(a, offset=2)], name='io')\n"
        + DENSE_TAIL,
        dict(a=dense(8, 1), **LABEL)),
    "dot_mul_operator": (
        "a = fc_layer(input=data_layer('a', size=8), size=5, name='a_fc')\n"
        "b = fc_layer(input=data_layer('b', size=8), size=5, name='b_fc')\n"
        "top = mixed_layer(size=5, input=[dotmul_operator(a, b, scale=2.0),"
        " full_matrix_projection(a)], name='dmo')\n" + DENSE_TAIL,
        dict(a=dense(8, 1), b=dense(8, 2), **LABEL)),
    "conv_operator": (
        "img = fc_layer(input=data_layer('a', size=8), size=72, name='img')\n"
        "filt = fc_layer(input=data_layer('b', size=8), size=36, name='filt')\n"
        "top = mixed_layer(size=32, input=[conv_operator([img, filt], filter_size=3,"
        " num_filters=2, num_channel=2, padding=0)], name='convop')\n" + DENSE_TAIL,
        dict(a=dense(8, 1), b=dense(8, 2), **LABEL)),
    "tensor": (
        "top = tensor_layer(input=[data_layer('a', size=5), data_layer('b', size=4)], size=6,"
        " name='tensor')\n" + DENSE_TAIL,
        dict(a=dense(5, 1), b=dense(4, 2), **LABEL)),
    "maxid": (
        "top = fc_layer(input=data_layer('a', size=8), size=6, name='scores')\n"
        "mid = maxid_layer(top, name='mid')\n"
        + DENSE_TAIL.replace("name='cost'))", "name='cost'), mid)"),
        dict(a=dense(8, 1), **LABEL)),
    "eos_id": (
        "top = fc_layer(input=data_layer('a', size=8), size=6, name='top')\n"
        "hit = eos_layer(input=data_layer('tok', size=6), eos_id=2, name='hit')\n"
        + DENSE_TAIL.replace("name='cost'))", "name='cost'), hit)"),
        dict(a=dense(8, 1), tok=ids(6, 5), **LABEL)),
    "trans": (
        "top = fc_layer(input=data_layer('a', size=8), size=6, name='top')\n"
        "tr = trans_layer(input=top, name='tr')\n"
        + DENSE_TAIL.replace("name='cost'))", "name='cost'), tr)"),
        dict(a=dense(8, 1), **LABEL)),
    "lstmemory_group": (
        "x = fc_layer(input=data_layer('x', size=6), size=20, name='x_fc')\n"
        "top = lstmemory_group(input=x, size=5, name='lg')\n" + SEQ_TAIL,
        dict(x=seq(6, 1), **LABEL)),
    "recurrent": (
        "x = fc_layer(input=data_layer('x', size=6), size=5, name='x_fc')\n"
        "top = recurrent_layer(input=x, name='rnn')\n" + SEQ_TAIL,
        dict(x=seq(6, 1), **LABEL)),
    "recurrent_reversed": (
        "x = fc_layer(input=data_layer('x', size=6), size=5, name='x_fc')\n"
        "top = recurrent_layer(input=x, reverse=True, act=ReluActivation(), name='rnn')\n"
        + SEQ_TAIL,
        dict(x=seq(6, 1), **LABEL)),
    "interpolation": (
        "w = fc_layer(input=data_layer('w', size=4), size=1, act=SigmoidActivation(),"
        " name='w_fc')\n"
        "a = fc_layer(input=data_layer('a', size=8), size=8, name='a_fc')\n"
        "b = fc_layer(input=data_layer('b', size=8), size=8, name='b_fc')\n"
        "top = interpolation_layer(input=[a, b], weight=w, name='interp')\n" + DENSE_TAIL,
        dict(w=dense(4, 0), a=dense(8, 1), b=dense(8, 2), **LABEL)),
    "power": (
        "a = fc_layer(input=data_layer('a', size=8), size=8, act=SigmoidActivation(),"
        " name='a_fc')\n"
        "top = power_layer(input=a, weight=data_layer('w', size=1), name='pow')\n" + DENSE_TAIL,
        dict(w=dense(1, 0, positive=True), a=dense(8, 1), **LABEL)),
    "slope_intercept": (
        "a = fc_layer(input=data_layer('a', size=8), size=8, name='a_fc')\n"
        "top = slope_intercept_layer(input=a, slope=2.0, intercept=0.5, name='si')\n"
        + DENSE_TAIL,
        dict(a=dense(8, 1), **LABEL)),
    "sum_to_one_norm": (
        "a = fc_layer(input=data_layer('a', size=8), size=8, act=SigmoidActivation(),"
        " name='a_fc')\n"
        "top = sum_to_one_norm_layer(input=a, name='s1')\n" + DENSE_TAIL,
        dict(a=dense(8, 1), **LABEL)),
    "convex_comb": (
        "w = fc_layer(input=data_layer('w', size=4), size=2, act=SoftmaxActivation(),"
        " name='w_fc')\n"
        "v = fc_layer(input=data_layer('v', size=8), size=16, name='v_fc')\n"
        "top = convex_comb_layer(input=[w, v], size=8, name='cc')\n" + DENSE_TAIL,
        dict(w=dense(4, 1), v=dense(8, 2), **LABEL)),
    "cos": (
        "a = fc_layer(input=data_layer('a', size=8), size=6, name='a_fc')\n"
        "b = fc_layer(input=data_layer('b', size=8), size=6, name='b_fc')\n"
        "top = cos_sim(a, b, name='cos')\n" + DENSE_TAIL,
        dict(a=dense(8, 1), b=dense(8, 2), **LABEL)),
    "cos_vm": (
        "a = fc_layer(input=data_layer('a', size=8), size=6, name='a_fc')\n"
        "m = fc_layer(input=data_layer('b', size=8), size=18, name='m_fc')\n"
        "top = cos_sim(a, m, size=3, name='cosvm')\n" + DENSE_TAIL,
        dict(a=dense(8, 1), b=dense(8, 2), **LABEL)),
    "out_prod": (
        "a = fc_layer(input=data_layer('a', size=8), size=4, name='a_fc')\n"
        "b = fc_layer(input=data_layer('b', size=8), size=3, name='b_fc')\n"
        "top = out_prod_layer(a, b, name='op')\n" + DENSE_TAIL,
        dict(a=dense(8, 1), b=dense(8, 2), **LABEL)),
    "conv_shift": (
        "a = fc_layer(input=data_layer('a', size=8), size=8, name='a_fc')\n"
        "b = fc_layer(input=data_layer('b', size=4), size=3, name='b_fc')\n"
        "top = conv_shift_layer(input=[a, b], name='cs')\n" + DENSE_TAIL,
        dict(a=dense(8, 1), b=dense(4, 2), **LABEL)),
    "multiplex": (
        "i1 = fc_layer(input=data_layer('x1', size=8), size=6, name='i1')\n"
        "i2 = fc_layer(input=data_layer('x2', size=8), size=6, name='i2')\n"
        "top = multiplex_layer(input=[data_layer('idx', size=2), i1, i2], name='mux')\n"
        + DENSE_TAIL,
        dict(idx={"ids": np.array([0, 1, 0, 1], np.int32)}, x1=dense(8, 1), x2=dense(8, 2),
             **LABEL)),
    "hsigmoid": (
        "h = fc_layer(input=data_layer('a', size=8), size=6, act=TanhActivation(), name='h')\n"
        "outputs(hsigmoid(input=h, label=data_layer('c', size=11), num_classes=11,"
        " name='hs'))\n",
        dict(a=dense(8, 1), c=ids(11, 3))),
    "multi_class_cross_entropy_with_selfnorm": (
        "p = fc_layer(input=data_layer('a', size=8), size=4, act=SoftmaxActivation(),"
        " name='p')\n"
        "outputs(cross_entropy_with_selfnorm(input=p, label=data_layer('l4', size=4),"
        " name='cost'))\n",
        dict(a=dense(8, 1), l4=ids(4, 3))),
    "square_error": (
        "p = fc_layer(input=data_layer('a', size=8), size=3, name='p')\n"
        "outputs(regression_cost(input=p, label=data_layer('y', size=3), name='cost'))\n",
        dict(a=dense(8, 1), y=dense(3, 2))),
    "square_error_sequence": (
        "p = fc_layer(input=data_layer('a', size=8), size=3, name='p')\n"
        "outputs(regression_cost(input=p, label=data_layer('y', size=3), name='cost'))\n",
        dict(a=seq(8, 1), y=seq(3, 2))),
    "multi_binary_label_cross_entropy": (
        "p = fc_layer(input=data_layer('a', size=8), size=6, act=SigmoidActivation(),"
        " name='p')\n"
        "outputs(multi_binary_label_cross_entropy(input=p, label=data_layer('m', size=6),"
        " name='cost'))\n",
        dict(a=dense(8, 1),
             m={"value": (np.random.RandomState(4).rand(B, 6) > 0.5).astype(np.float32)})),
    "rank-cost": (
        "left = fc_layer(input=data_layer('a', size=8), size=1, name='left')\n"
        "right = fc_layer(input=data_layer('b', size=8), size=1, name='right')\n"
        "outputs(rank_cost(left=left, right=right, label=data_layer('r', size=1),"
        " name='cost'))\n",
        dict(a=dense(8, 1), b=dense(8, 2),
             r={"value": np.array([[1.0], [0.0], [0.5], [1.0]], np.float32)})),
    "huber": (
        "s = fc_layer(input=data_layer('a', size=8), size=1, name='s')\n"
        "outputs(huber_cost(input=s, label=data_layer('h', size=2), name='cost'))\n",
        dict(a={"value": 3.0 * _rand((B, 8), 1)}, h=ids(2, 3))),
    "auc-validation": (
        "p = fc_layer(input=data_layer('a', size=8), size=2, act=SoftmaxActivation(),"
        " name='p')\n"
        "lab = data_layer('label', size=2)\n"
        "outputs(classification_cost(input=p, label=lab, name='cost'),"
        " auc_validation(input=p, label=lab, name='auc'))\n",
        dict(a=dense(8, 1), label=ids(2, 3))),
    "pnpair-validation": (
        "p = fc_layer(input=data_layer('a', size=8), size=1, name='p')\n"
        "outputs(regression_cost(input=p, label=data_layer('y', size=1), name='cost'),"
        " pnpair_validation(input=p, label=data_layer('lab', size=2),"
        " info=data_layer('q', size=2), name='pn'))\n",
        dict(a=dense(8, 1), y=dense(1, 2), lab=ids(2, 3), q=ids(2, 4))),
    "selective_fc": (
        "h = fc_layer(input=data_layer('a', size=8), size=6, name='h')\n"
        "top = selective_fc_layer(input=h, size=7, select=data_layer('sel', size=7),"
        " act=SigmoidActivation(), name='sfc')\n" + DENSE_TAIL,
        dict(a=dense(8, 1), sel=dict(ids(7, 3, (B, 3)), lengths=np.array([3, 1, 2, 3],
                                                                          np.int32)),
             **LABEL)),
    "selective_fc_softmax": (
        "h = fc_layer(input=data_layer('a', size=8), size=6, name='h')\n"
        "top = selective_fc_layer(input=h, size=7, select=data_layer('sel', size=7),"
        " act=SoftmaxActivation(), name='sfc')\n" + DENSE_TAIL,
        dict(a=dense(8, 1), sel=dict(ids(7, 3, (B, 3)), lengths=np.array([3, 1, 2, 3],
                                                                          np.int32)),
             **LABEL)),
    "norm": (
        "img = fc_layer(input=data_layer('a', size=8), size=6 * 16, name='img')\n"
        "top = img_cmrnorm_layer(input=img, size=3, num_channels=6, name='cmr')\n"
        + DENSE_TAIL,
        dict(a=dense(8, 1), **LABEL)),
    "blockexpand": (
        "img = fc_layer(input=data_layer('a', size=8), size=2 * 36, name='img')\n"
        "top = block_expand_layer(input=img, channel=2, block_x=3, block_y=3, stride_x=2,"
        " stride_y=2, padding_x=1, padding_y=1, name='be')\n" + SEQ_TAIL,
        dict(a=dense(8, 1), **LABEL)),
}

ACTIVATIONS = {"stanh": "STanhActivation", "brelu": "BReluActivation",
               "softrelu": "SoftReluActivation", "abs": "AbsActivation",
               "square": "SquareActivation", "exponential": "ExpActivation"}
for _act, _cls in ACTIVATIONS.items():
    CONFIG_CASES[f"act_{_act}"] = (
        f"top = fc_layer(input=data_layer('a', size=8), size=6, act={_cls}(), name='act')\n"
        + DENSE_TAIL, dict(a={"value": 4.0 * _rand((B, 8), 1)}, **LABEL))

# the layer type each case must put in the config
CASE_TYPE = {"context_trainable_padding": "mixed", "context_trainable_padding_before": "mixed",
             "context": "mixed", "trans_fc": "mixed", "dot_mul": "mixed",
             "identity_offset": "mixed", "dot_mul_operator": "mixed",
             "conv_operator": "mixed", "lstmemory_group": "lstm_step",
             "recurrent_reversed": "recurrent", "square_error_sequence": "square_error",
             "selective_fc_softmax": "selective_fc",
             **{f"act_{a}": "fc" for a in ACTIVATIONS}}


@pytest.mark.parametrize("case", sorted(CONFIG_CASES))
def test_layer_matches_the_jax_package(case, tmp_path):
    body, feed = CONFIG_CASES[case]
    model, _, pouts = run_config(tmp_path, body, feed)
    types = {l.type for l in model.layers}
    assert CASE_TYPE.get(case, case) in types, (case, types)
    if case.startswith("context"):
        assert_pad_rows_zero(pouts["ctx"], case)
    projections = {ic.proj_conf.type for l in model.layers for ic in l.inputs if ic.proj_conf}
    operators = {op.type for l in model.layers for op in l.operator_confs}
    want = {"context": "context", "context_trainable_padding": "context",
            "context_trainable_padding_before": "context", "trans_fc": "trans_fc",
            "dot_mul": "dot_mul", "identity_offset": "identity_offset"}.get(case)
    assert want is None or want in projections, (case, projections)
    want_op = {"dot_mul_operator": "dot_mul", "conv_operator": "conv"}.get(case)
    assert want_op is None or want_op in operators, (case, operators)
    if case.startswith("act_"):
        assert case[4:] in {l.active_type for l in model.layers}


# ------------------------------------------------------- registry level


def _layer_fns(cfg_kwargs, inputs):
    """The JAX and the port LayerConfig of one layer with named inputs."""
    from paddle_tpu.proto import LayerInputConfig

    jcfg = JLayerConfig(**cfg_kwargs)
    for name, pname in inputs:
        jcfg.inputs.append(LayerInputConfig(input_layer_name=name, input_parameter_name=pname))
    return jcfg, LayerConfig.from_json(jcfg.to_json())


def run_registry(cfg_kwargs, inputs, feed, params=None, grad_inputs=()):
    """One layer function of each package on the same config and inputs: the
    outputs, and the gradients of sum(out * R) (R a fixed random array of
    the output's shape, the valid steps only) by the parameters and the
    inputs named in grad_inputs."""
    params = params or {}
    jcfg, pcfg = _layer_fns(cfg_kwargs, inputs)
    names = [n for n, _ in inputs]

    def jax_loss(ps, vals):
        args = [_jax_arg(feed[n]) for n in names]
        args = [a.replace(value=vals[n]) if n in vals else a for n, a in zip(names, args)]
        ctx = JCtx(params=ps, model=JModelConfig(), pass_type="train")
        out = jax_layers.get(jcfg.type)(jcfg, args, ctx)
        v = out.value
        r = jnp.asarray(_rand(v.shape, 99))
        if out.seq_lengths is not None and v.ndim == 3:
            r = r * (jnp.arange(v.shape[1])[None, :] < out.seq_lengths[:, None])[..., None]
        return jnp.sum(v * r), out

    jps = {k: jnp.asarray(v) for k, v in params.items()}
    jvals = {n: jnp.asarray(feed[n]["value"]) for n in grad_inputs}
    (jl, jout), (jgp, jgv) = jax.jit(jax.value_and_grad(jax_loss, argnums=(0, 1),
                                                        has_aux=True))(jps, jvals)

    pps = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    args = [_port_arg(feed[n]) for n in names]
    for n, a in zip(names, args):
        if n in grad_inputs:
            a.value.requires_grad_(True)
    ctx = LayerContext(params=pps, model=ModelConfig(), pass_type="train")
    out = forward_layer(pcfg, args, ctx)
    v = out.value
    r = torch.as_tensor(_rand(tuple(v.shape), 99))
    if out.seq_lengths is not None and v.dim() == 3:
        r = r * (torch.arange(v.shape[1])[None, :] < out.seq_lengths[:, None])[..., None]
    loss = torch.sum(v * r)
    leaves = list(pps.values()) + [a.value for n, a in zip(names, args) if n in grad_inputs]
    grads = torch.autograd.grad(loss, leaves) if leaves else []
    assert compare_outputs({"out": jout}, {"out": out}) == 1
    _close(float(loss.detach()), float(jl), OUT_TOL * max(1.0, abs(float(jl))), "loss")
    want = [jgp[k] for k in pps] + [jgv[n] for n, a in zip(names, args) if n in grad_inputs]
    for i, (g, w) in enumerate(zip(grads, want)):
        _close(g.numpy(), np.asarray(w), GRAD_TOL, f"grad {i}")
    return jout, out


REGISTRY_CASES = {
    "concat2": None,  # built below: projections need a LayerInputConfig with proj_conf
    "prelu": (dict(name="prelu", type="prelu", size=6, partial_sum=2), [("x", "_w")],
              dict(x=dense(6, 1)), {"_w": np.array([0.1, 0.5, 2.0], np.float32)}, ("x",)),
    "seqfirstins": (dict(name="fi", type="seqfirstins", size=3), [("x", "")],
                    dict(x=seq(3, 1)), None, ("x",)),
    "seqconcat": (dict(name="sc", type="seqconcat", size=3), [("a", ""), ("b", "")],
                  dict(a=seq(3, 1), b=seq(3, 2, np.array([2, 5, 4, 1], np.int32))), None,
                  ("a", "b")),
    "seqreshape": (dict(name="sr", type="seqreshape", size=2), [("x", "")],
                   dict(x=seq(4, 1)), None, ("x",)),
    "subseq": (dict(name="ss", type="subseq", size=3, bias_parameter_name="_b",
                    active_type="tanh"), [("x", ""), ("o", ""), ("s", "")],
               dict(x=seq(3, 1), o={"ids": np.array([1, 0, 0, 2], np.int32)},
                    s={"ids": np.array([3, 3, 1, 2], np.int32)}),
               {"_b": np.array([0.3, -0.2, 0.1], np.float32)}, ("x",)),
    "soft_binary_class_cross_entropy": (
        dict(name="sb", type="soft_binary_class_cross_entropy", size=1, coeff=1.0),
        [("p", ""), ("y", "")],
        dict(p=dense(5, 1, positive=True), y={"value": _rand((B, 5), 2, positive=True)}),
        None, ("p",)),
    "classification_error": (
        dict(name="ce", type="classification_error", size=1, coeff=1.0),
        [("p", ""), ("y", "")], dict(p=dense(5, 1), y=ids(5, 2)), None, ()),
    "data_norm": (dict(name="dn", type="data_norm", size=3, data_norm_strategy="z-score"),
                  [("x", "_stats")], dict(x=dense(3, 1)),
                  {"_stats": np.array([[-1, -2, -3], [1, 2, 3], [4, 5, 6], [30, 40, 50],
                                       [10, 10, 10]], np.float32).reshape(1, 15)}, ("x",)),
    "featmap_expand": (dict(name="fe", type="featmap_expand", size=9, num_filters=3),
                       [("x", "")], dict(x=seq(3, 1)), None, ("x",)),
    "resize": (dict(name="rs", type="resize", size=6), [("x", "")], dict(x=dense(3, 1)), None,
               ("x",)),
    "max_output_max_index": (dict(name="mx", type="max", size=3, output_max_index=True),
                             [("x", "")], dict(x=seq(3, 1)), None, ()),
}


@pytest.mark.parametrize("case", sorted(REGISTRY_CASES))
def test_registry_layer_matches_the_jax_package(case):
    if case == "concat2":
        _concat2_case()
        return
    kw, inputs, feed, params, grad_inputs = REGISTRY_CASES[case]
    if case == "max_output_max_index":
        _ids_only(kw, inputs, feed)
    else:
        _, out = run_registry(kw, inputs, feed, params, grad_inputs)
        if case in ZERO_PAD:
            assert_pad_rows_zero(out, case)


def test_pad_row_check_fails_on_a_nonzero_pad_row():
    """The pad-row check above is not vacuous: each ZERO_PAD case has a pad
    step, and one pad value off 0 fails it."""
    for case in ZERO_PAD:
        kw, inputs, feed, params, grad_inputs = REGISTRY_CASES[case]
        _, out = run_registry(kw, inputs, feed, params, grad_inputs)
        v = out.value.detach().clone()
        b = int(torch.argmin(out.seq_lengths))
        assert int(out.seq_lengths[b]) < v.shape[1], case
        v[b, -1, 0] = 1e-6
        with pytest.raises(AssertionError, match="pad rows not 0"):
            assert_pad_rows_zero(Argument(value=v, seq_lengths=out.seq_lengths), case)


def _ids_only(kw, inputs, feed):
    jcfg, pcfg = _layer_fns(kw, inputs)
    jout = jax_layers.get(jcfg.type)(jcfg, [_jax_arg(feed[n]) for n, _ in inputs],
                                     JCtx(params={}, model=JModelConfig(), pass_type="test"))
    out = forward_layer(pcfg, [_port_arg(feed[n]) for n, _ in inputs],
                        LayerContext(params={}, model=ModelConfig()))
    assert np.array_equal(out.ids.numpy(), np.asarray(jout.ids))


def _concat2_case():
    from paddle_tpu.proto import LayerInputConfig, ProjectionConfig

    jcfg = JLayerConfig(name="c2", type="concat2", size=9, active_type="tanh")
    jcfg.inputs.append(LayerInputConfig(input_layer_name="a", input_parameter_name="_w",
                                        proj_conf=ProjectionConfig(type="fc", input_size=4,
                                                                   output_size=5)))
    jcfg.inputs.append(LayerInputConfig(input_layer_name="b", proj_conf=ProjectionConfig(
        type="identity", input_size=4, output_size=4)))
    feed = dict(a=dense(4, 1), b=dense(4, 2))
    params = {"_w": _rand((4, 5), 3)}
    pcfg = LayerConfig.from_json(jcfg.to_json())

    def jloss(ps):
        out = jax_layers.get("concat2")(jcfg, [_jax_arg(feed["a"]), _jax_arg(feed["b"])],
                                        JCtx(params=ps, model=JModelConfig()))
        return jnp.sum(out.value * _rand((B, 9), 99)), out

    (jl, jout), jg = jax.value_and_grad(jloss, has_aux=True)({"_w": jnp.asarray(params["_w"])})
    w = torch.tensor(params["_w"], requires_grad=True)
    out = forward_layer(pcfg, [_port_arg(feed["a"]), _port_arg(feed["b"])],
                        LayerContext(params={"_w": w}, model=ModelConfig(), pass_type="train"))
    loss = torch.sum(out.value * torch.as_tensor(_rand((B, 9), 99)))
    (g,) = torch.autograd.grad(loss, [w])
    _close(out.value.detach().numpy(), np.asarray(jout.value), OUT_TOL, "concat2")
    _close(g.numpy(), np.asarray(jg["_w"]), GRAD_TOL, "concat2 grad")


def test_norm_projection_is_the_norm_layer():
    assert layer_registry.get("norm-projection") is layer_registry.get("norm")


# --------------------------------------------------------- registries


def test_registries_are_the_jax_packages_but_mdlstmemory():
    """Once every type but mdlstmemory; now every type, mdlstmemory
    included: NOT_PORTED is empty and mdlstmemory's registry function runs
    a nested grid as the JAX package's does."""
    assert set(layer_registry.names()) == set(jax_layers.names())
    assert set(activation_registry.names()) == set(jax_acts.names())
    assert NOT_PORTED == {}
    cfg = LayerConfig(name="md", type="mdlstmemory", size=2, bias_parameter_name="_b")
    cfg.inputs.append(LayerInputConfig(input_layer_name="x", input_parameter_name="_w"))
    params = {"_w": _rand((2, 10), 1), "_b": _rand((18,), 2)}
    x = _rand((2, 3, 4, 10), 3)
    lens, sub = np.array([3, 2], np.int32), np.array([[4, 4, 4], [2, 1, 0]], np.int32)
    jcfg = JLayerConfig.from_json(cfg.to_json())
    want = jax_layers.get("mdlstmemory")(
        jcfg, [JArg(value=jnp.asarray(x), seq_lengths=jnp.asarray(lens),
                    sub_seq_lengths=jnp.asarray(sub))],
        JCtx(params={k: jnp.asarray(v) for k, v in params.items()}, model=JModelConfig()))
    got = forward_layer(cfg, [Argument(value=torch.from_numpy(x), seq_lengths=torch.from_numpy(lens),
                                       sub_seq_lengths=torch.from_numpy(sub))],
                        LayerContext(params={k: torch.from_numpy(v) for k, v in params.items()},
                                     model=ModelConfig()))
    _close(got.value.numpy(), np.asarray(want.value), OUT_TOL, "mdlstmemory")


@pytest.mark.parametrize("act", sorted(ACTIVATIONS) + ["", "linear", "sigmoid", "tanh", "relu"])
def test_elementwise_activations_are_elementwise_in_both(act):
    from paddle_tpu.ops.activations import ELEMENTWISE_ACTS as JAX_ELEMENTWISE
    from paddle_tpu_torch.ops.activations import ELEMENTWISE_ACTS, apply_activation

    assert (act in ELEMENTWISE_ACTS) == (act in JAX_ELEMENTWISE)
    x = np.linspace(-50, 50, 101, dtype=np.float32)
    got = apply_activation(act, torch.as_tensor(x)).numpy()
    want = np.asarray(jax_acts.get(act)(jnp.asarray(x), None))
    _close(got, want, OUT_TOL, act)


# ------------------------------------------------------- the layer zoo

# the layer types this slice ported: the layer zoo on the card runs each
PORTED = {
    "concat2", "tensor", "prelu", "maxid", "eos_id", "trans", "get_output", "sampling_id",
    "seqfirstins", "seqconcat", "seqreshape", "subseq",
    "multi_class_cross_entropy_with_selfnorm", "square_error",
    "multi_binary_label_cross_entropy", "soft_binary_class_cross_entropy", "rank-cost",
    "huber", "auc-validation", "pnpair-validation", "classification_error",
    "interpolation", "power", "slope_intercept", "sum_to_one_norm", "convex_comb", "cos",
    "cos_vm", "out_prod", "conv_shift", "multiplex", "data_norm", "hsigmoid", "nce",
    "recurrent", "lstm_step", "crf", "crf_decoding", "ctc", "lambda_cost", "selective_fc",
    "norm", "norm-projection", "blockexpand", "featmap_expand", "resize"}


def test_ported_types_are_the_registry_less_the_earlier_slices():
    earlier = {"data", "fc", "mixed", "addto", "concat", "max", "average", "seqlastins",
               "expand", "lstmemory", "gated_recurrent", "gru_step", "scaling",
               "multi-class-cross-entropy", "conv", "exconv", "cudnn_conv", "pool",
               "batch_norm", "cudnn_batch_norm", "multi_head_attention", "agent",
               "sequence_agent", "scatter_agent", "sequence_scatter_agent", "gather_agent",
               "sequence_gather_agent"}
    assert len(PORTED) == 46
    # mdlstmemory, the one type ported after this slice (the nested slice)
    assert PORTED | earlier | {"mdlstmemory"} >= set(layer_registry.names()) - {
        "recurrent_layer_group"}


def test_layer_zoo_covers_the_slice_and_runs_at_small_sizes():
    """chip_smoke.py's zoo at small sizes, CPU against CPU: every ported
    type, the four projections, both operators and the six activations
    are in it, it runs and its check passes; a perturbed value, gradient
    or id fails the check, as does a padded step off 0 where the layer
    must keep it 0, and an argmax id that differs on a tie passes."""
    from paddle_tpu_torch.tools import layer_zoo

    entries = layer_zoo.build(full=False)
    types = {e.cfg.type for e in entries}
    projections = {ic.proj_conf.type for e in entries for ic in e.cfg.inputs if ic.proj_conf}
    operators = {op.type for e in entries for op in e.cfg.operator_confs}
    acts = {e.cfg.active_type for e in entries}
    assert PORTED - {"sampling_id"} <= types          # sampling_id: drawn apart, chi-square
    assert {"context", "identity_offset", "dot_mul", "trans_fc"} <= projections
    assert {"dot_mul", "conv"} <= operators and set(ACTIVATIONS) <= acts
    assert any(e.cfg.inputs[0].input_parameter_name == "_pad" for e in entries)
    runs = {}
    for e in entries:
        got, step = layer_zoo.run(e, "cpu")
        ref, _ = layer_zoo.run(e, "cpu")
        layer_zoo.compare(e, got, ref)
        step()
        runs[e.name] = (e, got, ref)
    e, got, ref = runs["projection:trans_fc"]
    with pytest.raises(AssertionError, match="value"):
        layer_zoo.compare(e, dict(got, value=got["value"] + 1e-3), ref)
    with pytest.raises(AssertionError, match="grad"):
        layer_zoo.compare(e, dict(got, grads=[g + 1e-2 for g in got["grads"]]), ref)
    for name in ("seqconcat", "seqreshape", "subseq", "projection:context",
                 "projection:context_trainable_padding"):
        e, got, ref = runs[name]
        assert e.zero_pad
        v = got["value"].copy()
        b = int(np.argmin(got["lengths"]))
        assert got["lengths"][b] < v.shape[1], name
        v[b, -1, 0] = 1e-6
        with pytest.raises(AssertionError, match="pad rows not 0"):
            layer_zoo.compare(e, dict(got, value=v), ref)
    e, got, ref = runs["maxid"]
    x = e.inputs[0]["value"]
    b, t = 1, 2
    second = int(np.argsort(x[b, t])[-2])
    with pytest.raises(AssertionError, match="off a tie"):
        layer_zoo.compare(e, dict(got, ids=_with(got["ids"], (b, t), second)), ref)
    x[b, t, second] = x[b, t].max()                   # now a tie: the id may differ
    layer_zoo.compare(e, dict(got, ids=_with(got["ids"], (b, t), second)), ref)


def _with(a, ix, v):
    a = a.copy()
    a[ix] = v
    return a
