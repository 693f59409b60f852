"""Nested sequences and hierarchical RNNs of the port against the JAX
package, on the CPU.

Every case parses one config with both packages, carries the JAX
``init_params`` across with ``paddle_tpu_torch.bridge.params_from_numpy``
and feeds both the same numpy-seeded nested batch ([B, S, T, ...] with
``seq_lengths`` the sub-sequence count of each sample and
``sub_seq_lengths`` [B, S] the length of each sub-sequence, empty ones
included):

- the cases of ``tests/test_nested_recurrent.py``: a nested RNN (an outer
  group over sub-sequences, an inner group over their tokens) equal to the
  JAX package's and to the port's flat RNN run on each sub-sequence, an
  inner group reading an outer static, a sequence memory carrying a whole
  sequence, and the gradients through a nested group;
- ``tests/test_recurrent_group.py:80``'s ``gru_group`` inside a group,
  which keeps its group form: no GRU kernel runs inside a nested step;
- ``tests/test_mdlstm_multinn.py``'s ``mdlstmemory``: all four
  directions, its gradients, a ragged grid;
- the nested sequence layers: pooling, first and last instance at both
  ``trans_type`` levels, ``output_max_index``, nested ``expand``, an fc
  over a nested input and the costs over nested sequences;
- the hierarchical document classifier of ``chip_smoke.py``'s ``nested``
  phase (``flagship.hierarchical_config``) at width 8, one batch by
  ``grad_fn`` and one pass through each package's ``paddle train`` on a
  nested ``PyDataProvider2`` provider.

Tolerances, the JAX tests' own: every output within 2e-5 of max(1, max
|JAX|) (float32 sums in another order), the loss within 1e-5 relative,
every gradient within 1e-4 of max(1, max |JAX gradient|), ids equal.
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
from paddle_tpu_torch.bridge import params_from_numpy
from paddle_tpu_torch.config import parse_config
from paddle_tpu_torch.graph import GradientMachine, make_seq
from paddle_tpu_torch.graph.argument import Argument, degrade_sequence
from paddle_tpu_torch.layers import recurrent
from paddle_tpu_torch.ops import fused_gru, fused_lstm

torch.set_num_threads(1)
OUT_TOL, LOSS_TOL, GRAD_TOL = 2e-5, 1e-5, 1e-4


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, f"{what}: max abs err {err} > {tol} * {scale}"


def _parse_both(tmp_path, text):
    path = tmp_path / "conf.py"
    path.write_text(textwrap.dedent(text))
    return jax_parse_config(str(path)), parse_config(str(path))


def _spec_args(spec):
    """A feed spec {name: dict(value=, ids=, lengths=, sub_lengths=)} as the
    JAX package's Arguments and the port's."""
    def one(s, mk, arr):
        get = lambda k, dt: None if s.get(k) is None else arr(np.asarray(s[k], dt))  # noqa
        return mk(value=get("value", np.float32), ids=get("ids", np.int32),
                  seq_lengths=get("lengths", np.int32),
                  sub_seq_lengths=get("sub_lengths", np.int32))

    return ({k: one(s, JArg, jnp.asarray) for k, s in spec.items()},
            {k: one(s, Argument, torch.from_numpy) for k, s in spec.items()})


def _machines(jtc, ttc, seed):
    jm = JaxMachine(jtc.model_config)
    jp = jax.jit(lambda: jm.init_params(seed=seed))()
    tm = GradientMachine(ttc.model_config, device="cpu")
    return jm, jp, tm, params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, "cpu")


def _forward_both(tmp_path, text, spec, seed, pass_type="test"):
    jtc, ttc = _parse_both(tmp_path, text)
    jm, jp, tm, tp = _machines(jtc, ttc, seed)
    jfeed, tfeed = _spec_args(spec)
    jout, _ = jm.forward(jp, jfeed, pass_type)
    tout, _ = tm.forward(tp, tfeed, pass_type)
    return jout, tout, tp


def _grads_both(tmp_path, text, spec, seed, out_name):
    """Both packages' gradients of sum(out ** 2) in a training pass."""
    jtc, ttc = _parse_both(tmp_path, text)
    jm, jp, tm, tp = _machines(jtc, ttc, seed)
    jfeed, tfeed = _spec_args(spec)

    def jloss(p):
        outs, _ = jm.forward(p, jfeed, "train", rng=jax.random.PRNGKey(0))
        return jnp.sum(outs[out_name].value ** 2)

    jl, jg = jax.value_and_grad(jloss)(jp)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    outs, _ = tm.forward(leaves, tfeed, "train", seed=1)
    loss = torch.sum(outs[out_name].value ** 2)
    got = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    _close(float(loss.detach()), float(jl), LOSS_TOL * max(1.0, abs(float(jl))), "loss")
    return got, jg


def _nested(shape, seed, n_subs, sub_lens, scale=1.0):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32) * scale
    return dict(value=x, lengths=np.asarray(n_subs, np.int32),
                sub_lengths=np.asarray(sub_lens, np.int32))


# --------------------------------------------- tests/test_nested_recurrent.py

D, H = 5, 6
RNN_STEP = """
from paddle.trainer_config_helpers import *
settings(batch_size=4, learning_rate=1e-3)
x = data_layer(name="x", size=5)
def rnn_step(y):
    mem = memory(name="rnn_out", size=6)
    return mixed_layer(name="rnn_out", size=6, act=TanhActivation(), bias_attr=False,
        input=[full_matrix_projection(y, param_attr=ParamAttr(name="w_x")),
               full_matrix_projection(mem, param_attr=ParamAttr(name="w_h"))])
"""
FLAT_RNN = RNN_STEP + """
out = recurrent_group(step=rnn_step, input=x, name="flat_rnn")
outputs(out)
"""
NEST_RNN = RNN_STEP + """
def outer_step(sub):
    return recurrent_group(step=rnn_step, input=sub, name="inner_rnn")
out = recurrent_group(step=outer_step, input=SubsequenceInput(x), name="outer")
outputs(out)
"""


def _flat_of(x_nest, n_subs, sub_lens):
    """Every valid sub-sequence of a nested batch as its own sequence."""
    pairs = [(b, s) for b in range(len(n_subs)) for s in range(n_subs[b])]
    return (pairs, np.stack([x_nest[b, s] for b, s in pairs]),
            np.array([sub_lens[b][s] for b, s in pairs], np.int32))


def test_nested_rnn_matches_jax_and_the_flat_rnn(tmp_path):
    """An outer group over sub-sequences with an inner RNN: the JAX
    package's output and sub-sequence lengths, and on each valid
    sub-sequence the port's own flat RNN (the reference's equivalence
    test); the outer steps past a sample's count are zero."""
    n_subs, sub_lens = [3, 2], [[4, 2, 3], [1, 4, 0]]
    spec = {"x": _nested((2, 3, 4, D), 0, n_subs, sub_lens)}
    jout, tout, tp = _forward_both(tmp_path, NEST_RNN, spec, seed=3)
    nested = tout["outer"].value.numpy()
    _close(nested, np.asarray(jout["outer"].value), OUT_TOL, "outer")
    np.testing.assert_array_equal(tout["outer"].sub_seq_lengths.numpy(),
                                  np.asarray(jout["outer"].sub_seq_lengths))
    np.testing.assert_array_equal(tout["outer"].seq_lengths.numpy(), n_subs)
    np.testing.assert_array_equal(nested[1, 2], 0.0)

    pairs, x_flat, l_flat = _flat_of(spec["x"]["value"], n_subs, sub_lens)
    (tmp_path / "flat").mkdir()
    flat_tc = parse_config(str(_write(tmp_path / "flat", FLAT_RNN)))
    flat = GradientMachine(flat_tc.model_config, device="cpu").forward(
        tp, {"x": make_seq(x_flat, l_flat, device="cpu")}, "test")[0]["flat_rnn"].value.numpy()
    for i, (b, s) in enumerate(pairs):
        n = int(sub_lens[b][s])
        _close(nested[b, s, :n], flat[i, :n], OUT_TOL, f"sub-sequence {(b, s)}")


def _write(d, text):
    path = d / "conf.py"
    path.write_text(textwrap.dedent(text))
    return path


NEST_RNN_STATIC = """
from paddle.trainer_config_helpers import *
settings(batch_size=4, learning_rate=1e-3)
x = data_layer(name="x", size=5)
z = data_layer(name="z", size=4)
enc = fc_layer(input=z, size=6, act=TanhActivation(), name="enc",
               param_attr=ParamAttr(name="w_z"), bias_attr=False)
def rnn_step(y, c):
    mem = memory(name="rnn_out", size=6)
    return mixed_layer(name="rnn_out", size=6, act=TanhActivation(), bias_attr=False,
        input=[full_matrix_projection(y, param_attr=ParamAttr(name="w_x")),
               full_matrix_projection(mem, param_attr=ParamAttr(name="w_h")),
               full_matrix_projection(c, param_attr=ParamAttr(name="w_c"))])
def outer_step(sub):
    return recurrent_group(step=rnn_step, input=[sub, StaticInput(enc)],
                           name="inner_rnn")
out = recurrent_group(step=outer_step, input=SubsequenceInput(x), name="outer")
outputs(out)
"""


def test_inner_group_reads_an_outer_static(tmp_path):
    """An inner group's StaticInput names a layer outside the outer group
    (an encoder in the root scope): the hierarchical decoder's shape."""
    spec = {"x": _nested((2, 2, 3, D), 4, [2, 2], [[3, 2], [1, 3]]),
            "z": dict(value=np.random.RandomState(5).randn(2, 4).astype(np.float32))}
    jout, tout, _ = _forward_both(tmp_path, NEST_RNN_STATIC, spec, seed=11)
    _close(tout["outer"].value.numpy(), np.asarray(jout["outer"].value), OUT_TOL, "outer")
    np.testing.assert_array_equal(tout["outer"].sub_seq_lengths.numpy(),
                                  np.asarray(jout["outer"].sub_seq_lengths))


SEQ_MEM = """
from paddle.trainer_config_helpers import *
settings(batch_size=4, learning_rate=1e-3)
x = data_layer(name="x", size=5)
boot = data_layer(name="boot", size=5)
def outer_step(sub):
    mem = memory(name="acc", size=5, is_seq=True, boot_layer=boot)
    return addto_layer(input=[sub, mem], name="acc", act=LinearActivation(),
                       bias_attr=False)
out = recurrent_group(step=outer_step, input=SubsequenceInput(x), name="nacc")
outputs(out)
"""


def test_a_sequence_memory_carries_the_whole_sequence(tmp_path):
    """memory(is_seq=True) hands step s the whole output sequence of step
    s - 1: out = sub + mem is the cumulative sum over sub-sequences."""
    B, S, T = 2, 3, 4
    sub_lens = np.full((B, S), T, np.int32)
    sub_lens[1, 2] = 0
    spec = {"x": _nested((B, S, T, D), 1, [3, 2], sub_lens),
            "boot": dict(value=np.zeros((B, T, D), np.float32), lengths=[T, T])}
    jout, tout, _ = _forward_both(tmp_path, SEQ_MEM, spec, seed=5)
    got = tout["nacc"].value.numpy()
    _close(got, np.asarray(jout["nacc"].value), OUT_TOL, "nacc")
    want = np.cumsum(spec["x"]["value"], axis=1)
    for b, n in enumerate([3, 2]):
        _close(got[b, :n], want[b, :n], OUT_TOL, f"sample {b}")


def test_a_sequence_memory_is_clamped_to_the_boots_capacity(tmp_path):
    """A carried sequence longer than its boot is cut to the boot's padded
    length (doc/divergences.md): the boot here holds 3 steps, the
    sub-sequences 4."""
    B, S, T = 2, 2, 4
    spec = {"x": _nested((B, S, T, D), 8, [2, 1], [[4, 4], [4, 0]]),
            "boot": dict(value=np.random.RandomState(9).randn(B, 3, D).astype(np.float32),
                         lengths=[3, 2])}
    text = SEQ_MEM.replace("input=[sub, mem]", "input=[mem, mem]")
    jout, tout, _ = _forward_both(tmp_path, text, spec, seed=5)
    _close(tout["nacc"].value.numpy(), np.asarray(jout["nacc"].value), OUT_TOL, "nacc")
    np.testing.assert_array_equal(tout["nacc"].sub_seq_lengths.numpy(),
                                  np.asarray(jout["nacc"].sub_seq_lengths))


def test_gradients_through_a_nested_group(tmp_path):
    """Training through a nested group: every gradient equals the JAX
    package's (jax.grad through the scan in scan)."""
    spec = {"x": _nested((2, 3, 3, D), 3, [3, 2], [[3, 1, 2], [2, 3, 0]])}
    got, want = _grads_both(tmp_path, NEST_RNN, spec, seed=9, out_name="outer")
    for k in ("w_x", "w_h"):
        assert np.abs(got[k].numpy()).sum() > 0, k
        _close(got[k].numpy(), np.asarray(want[k]), GRAD_TOL, f"grad {k}")


# --------------------------------------------- tests/test_recurrent_group.py:80

GRU_IN_GROUP = """
from paddle.trainer_config_helpers import *
settings(batch_size=4, learning_rate=1e-3)
x = data_layer(name="x", size=12)
def outer_step(sub):
    m = mixed_layer(name="proj", size=18, bias_attr=False,
        input=[full_matrix_projection(sub, param_attr=ParamAttr(name="w_in"))])
    return gru_group(input=m, name="igru", size=6,
                     gru_bias_attr=ParamAttr(name="b_rec"))
out = recurrent_group(step=outer_step, input=SubsequenceInput(x), name="outer")
outputs(out)
"""


def test_gru_group_inside_a_group_keeps_its_group_form(tmp_path, monkeypatch):
    """gru_group inside another group's step stays a group of gru_step
    layers, as in the JAX package: no GRU kernel (nor its plain version)
    runs inside a nested step, and the output is the JAX package's."""
    _, ttc = _parse_both(tmp_path, GRU_IN_GROUP)
    assert {l.name: l.type for l in ttc.model_config.layers}["igru"] == "gru_step"

    def refuse(*a, **k):
        raise AssertionError("a GRU kernel ran inside a nested step")

    monkeypatch.setattr(recurrent, "fused_gru", refuse)
    eager = fused_gru.EAGER_ROUTES
    spec = {"x": _nested((2, 2, 4, 12), 1, [2, 1], [[4, 2], [3, 0]])}
    jout, tout, _ = _forward_both(tmp_path, GRU_IN_GROUP, spec, seed=3)
    assert fused_gru.EAGER_ROUTES == eager
    _close(tout["outer"].value.numpy(), np.asarray(jout["outer"].value), OUT_TOL, "outer")


# ------------------------------------------------ tests/test_mdlstm_multinn.py

MDLSTM = """
from paddle.trainer_config_helpers import *
settings(batch_size=4, learning_rate=1e-3)
x = data_layer(name="x", size=20)
out = mdlstm_layer(input=x, size=4, directions={dirs}, name="md",
                   param_attr=ParamAttr(name="w_md"),
                   bias_attr=ParamAttr(name="b_md"))
outputs(out)
"""
DIRS = [(True, True), (True, False), (False, True), (False, False)]


@pytest.mark.parametrize("dirs", DIRS, ids=lambda d: "".join("+" if x else "-" for x in d))
def test_mdlstm_matches_jax(tmp_path, dirs):
    """Every direction on a full 3 x 4 grid: the output and both
    gradients."""
    spec = {"x": _nested((2, 3, 4, 20), 0, [3, 3], np.full((2, 3), 4), scale=0.5)}
    text = MDLSTM.format(dirs=list(dirs))
    jout, tout, _ = _forward_both(tmp_path, text, spec, seed=2)
    _close(tout["md"].value.numpy(), np.asarray(jout["md"].value), OUT_TOL, "md")
    got, want = _grads_both(tmp_path, text, spec, seed=2, out_name="md")
    for k in ("w_md", "b_md"):
        assert np.abs(got[k].numpy()).sum() > 0, k
        _close(got[k].numpy(), np.asarray(want[k]), GRAD_TOL, f"grad {k}")


@pytest.mark.parametrize("dirs", DIRS, ids=lambda d: "".join("+" if x else "-" for x in d))
def test_mdlstm_ragged_grid_matches_jax_and_the_sample_alone(tmp_path, dirs):
    """Per-sample grids: sample 1 holds a 2 x 3 grid in a 4 x 5 batch. The
    whole output and the gradients equal the JAX package's, and sample 1's
    grid equals the port's run of it alone at its exact size."""
    x = np.random.RandomState(7).randn(2, 4, 5, 20).astype(np.float32) * 0.5
    spec = {"x": dict(value=x, lengths=[4, 2], sub_lengths=[[5] * 4, [3, 3, 0, 0]])}
    text = MDLSTM.format(dirs=list(dirs))
    jout, tout, tp = _forward_both(tmp_path, text, spec, seed=2)
    got = tout["md"].value.numpy()
    _close(got, np.asarray(jout["md"].value), OUT_TOL, "md")
    tm = GradientMachine(parse_config(str(tmp_path / "conf.py")).model_config, device="cpu")
    alone = tm.forward(tp, _spec_args({"x": dict(value=x[1:2, :2, :3], lengths=[2],
                                                 sub_lengths=[[3, 3]])})[1], "test")[0]
    _close(got[1, :2, :3], alone["md"].value.numpy()[0], OUT_TOL, "sample 1 alone")
    assert not got[1, 2:].any() and not got[1, :, 3:].any()
    grads, want = _grads_both(tmp_path, text, spec, seed=2, out_name="md")
    for k in ("w_md", "b_md"):
        _close(grads[k].numpy(), np.asarray(want[k]), GRAD_TOL, f"grad {k}")


# ----------------------------------------------- the nested sequence layers

NESTED_HEAD = """
from paddle.trainer_config_helpers import *
settings(batch_size=4, learning_rate=0.1)
x = data_layer(name="x", size=6)
h = fc_layer(input=x, size=5, act=TanhActivation(), name="h")
"""
DENSE_TAIL = """
out = fc_layer(input=top, size=3, act=SoftmaxActivation(), name="out")
outputs(classification_cost(input=out, label=data_layer("label", size=3), name="cost"))
"""
SEQ_TAIL = """
top = pooling_layer(input=top, pooling_type=AvgPooling(), name="pool")
""" + DENSE_TAIL
SEQ = "agg_level=AggregateLevel.EACH_SEQUENCE"
# a nested batch of 3 samples: 3, 2 and 2 sub-sequences, two of them empty
N_SUBS, SUB_LENS = [3, 2, 2], [[4, 2, 3], [1, 4, 0], [3, 0, 0]]
LAYER_CASES = {
    "max_seq": f"top = pooling_layer(input=h, pooling_type=MaxPooling(), {SEQ}, name='p')"
               + SEQ_TAIL,
    "max_non_seq": "top = pooling_layer(input=h, pooling_type=MaxPooling(), name='p')"
                   + DENSE_TAIL,
    "avg_seq": f"top = pooling_layer(input=h, pooling_type=AvgPooling(), {SEQ}, name='p')"
               + SEQ_TAIL,
    "avg_non_seq": "top = pooling_layer(input=h, pooling_type=AvgPooling(), name='p')"
                   + DENSE_TAIL,
    "sum_seq": f"top = pooling_layer(input=h, pooling_type=SumPooling(), {SEQ}, name='p')"
               + SEQ_TAIL,
    "sqrtn_non_seq": "top = pooling_layer(input=h, pooling_type=SquareRootNPooling(), "
                     "name='p')" + DENSE_TAIL,
    "last_seq": f"top = last_seq(input=h, {SEQ}, name='p')" + SEQ_TAIL,
    "first_seq": f"top = first_seq(input=h, {SEQ}, name='p')" + SEQ_TAIL,
    "last_non_seq": "top = last_seq(input=h, name='p')" + DENSE_TAIL,
    "first_non_seq": "top = first_seq(input=h, name='p')" + DENSE_TAIL,
    "expand_nested": (
        f"v = pooling_layer(input=h, pooling_type=AvgPooling(), {SEQ}, name='v')\n"
        "e = expand_layer(input=v, expand_as=h, expand_level=ExpandLevel.FROM_SEQUENCE, "
        "name='e')\n"
        "s = addto_layer(input=[e, h], act=TanhActivation(), name='s')\n"
        "top = pooling_layer(input=s, pooling_type=MaxPooling(), name='p')" + DENSE_TAIL),
    "classification_cost_nested": (
        "out = fc_layer(input=h, size=3, act=SoftmaxActivation(), name='out')\n"
        "outputs(classification_cost(input=out, label=data_layer('tags', size=3), "
        "name='cost'))"),
    "square_error_nested": (
        "out = fc_layer(input=h, size=2, name='out')\n"
        "outputs(regression_cost(input=out, label=data_layer('target', size=2), "
        "name='cost'))"),
}


def _layer_feed(case):
    spec = {"x": _nested((3, 3, 4, 6), 21, N_SUBS, SUB_LENS),
            "label": dict(ids=np.array([0, 2, 1], np.int32))}
    if case == "classification_cost_nested":
        spec["tags"] = dict(ids=np.random.RandomState(22).randint(0, 3, (3, 3, 4)),
                            lengths=N_SUBS, sub_lengths=SUB_LENS)
    if case == "square_error_nested":
        spec["target"] = _nested((3, 3, 4, 2), 23, N_SUBS, SUB_LENS)
    return spec


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_nested_sequence_layers_match_jax(tmp_path, case):
    """Each nested path of the sequence layers and costs in a small
    classifier: every layer's output, the loss and every gradient."""
    jtc, ttc = _parse_both(tmp_path, NESTED_HEAD + textwrap.dedent(LAYER_CASES[case]))
    jm, jp, tm, tp = _machines(jtc, ttc, seed=7)
    jfeed, tfeed = _spec_args(_layer_feed(case))
    jl, jg, jouts, _ = jax.jit(jm.grad_fn(sparse=False))(jp, jfeed, jax.random.PRNGKey(0))
    tl, tg, touts, _ = tm.grad_fn()(tp, tfeed, seed=1)
    _close(float(tl), float(jl), LOSS_TOL * max(1.0, abs(float(jl))), "loss")
    checked = 0
    for name, j in jouts.items():
        p = touts.get(name)
        if p is None or j.value is None:
            continue
        for field in ("seq_lengths", "sub_seq_lengths"):
            want = getattr(j, field)
            got = getattr(p, field)
            assert (want is None) == (got is None), (name, field)
            if want is not None:
                np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)
        _close(p.value.detach().numpy(), np.asarray(j.value), OUT_TOL, f"output {name}")
        checked += 1
    assert checked >= 4
    assert sorted(tg) == sorted(jg)
    for name in jg:
        _close(tg[name].numpy(), np.asarray(jg[name]), GRAD_TOL, f"grad {name}")


MAX_INDEX = NESTED_HEAD + """
p = pooling_layer(input=h, pooling_type=MaxPooling(), {level}name="p")
outputs(p)
"""


def test_max_index_per_sub_sequence_and_the_refusal_over_a_whole_nested_sequence(tmp_path):
    """output_max_index at trans_type='seq' gives each sub-sequence's step
    of each feature's maximum, the JAX package's ids; over a whole nested
    sequence both packages refuse it, with the JAX package's words."""
    spec = {"x": _nested((3, 3, 4, 6), 21, N_SUBS, SUB_LENS)}

    jtc, ttc = _parse_both(tmp_path, MAX_INDEX.format(level=SEQ + ", "))
    for tc in (jtc, ttc):
        next(l for l in tc.model_config.layers if l.name == "p").output_max_index = True
    jm, jp, tm, tp = _machines(jtc, ttc, seed=7)
    jfeed, tfeed = _spec_args(spec)
    want = jm.forward(jp, jfeed, "test")[0]["p"]
    got = tm.forward(tp, tfeed, "test")[0]["p"]
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.seq_lengths.numpy(), N_SUBS)

    jtc, ttc = _parse_both(tmp_path, MAX_INDEX.format(level=""))
    for tc in (jtc, ttc):
        next(l for l in tc.model_config.layers if l.name == "p").output_max_index = True
    jm, jp, tm, tp = _machines(jtc, ttc, seed=7)
    words = "output_max_index over a whole nested sequence"
    with pytest.raises(NotImplementedError, match=words):
        jm.forward(jp, jfeed, "test")
    with pytest.raises(NotImplementedError, match=words):
        tm.forward(tp, tfeed, "test")


def test_trans_type_seq_needs_a_nested_input(tmp_path):
    """Pooling or first/last at trans_type='seq' over a plain sequence is
    refused in both packages."""
    spec = {"x": dict(value=np.ones((2, 3, 6), np.float32), lengths=[3, 1])}
    for layer in (f"pooling_layer(input=h, pooling_type=AvgPooling(), {SEQ}, name='p')",
                  f"last_seq(input=h, {SEQ}, name='p')"):
        text = NESTED_HEAD + f"outputs({layer})\n"
        jtc, ttc = _parse_both(tmp_path, text)
        jm, jp, tm, tp = _machines(jtc, ttc, seed=7)
        jfeed, tfeed = _spec_args(spec)
        with pytest.raises(AssertionError, match="needs a nested"):
            jm.forward(jp, jfeed, "test")
        with pytest.raises(ValueError, match="needs a nested"):
            tm.forward(tp, tfeed, "test")


def test_argument_masks_and_degrade_sequence():
    """sub_seq_mask is the [B, S, T] mask of the JAX Argument's, and
    degrade_sequence keeps a nested argument's tensors and outer lengths
    with its nesting stripped."""
    spec = _nested((3, 3, 4, 6), 21, N_SUBS, SUB_LENS)
    (j,), (t,) = (list(a.values()) for a in _spec_args({"x": spec}))
    np.testing.assert_array_equal(t.sub_seq_mask().numpy(), np.asarray(j.sub_seq_mask()))
    np.testing.assert_array_equal(t.seq_mask().numpy(), np.asarray(j.seq_mask()))
    flat = degrade_sequence(t)
    assert flat.value is t.value and flat.seq_lengths is t.seq_lengths
    assert flat.is_seq and not flat.is_nested_seq


# ------------------------------------------ the nested phase's classifier

HIER_TEXT = """
from paddle.trainer_config_helpers import *
settings(batch_size=4, learning_rate=1e-3, learning_method=AdamOptimizer())
words = data_layer(name="words", size={vocab})
emb = embedding_layer(input=words, size={emb}, name="emb", param_attr=ParamAttr(name="_emb"))
def sentence(sub):
    proj = mixed_layer(size={gru3}, name="sent_proj",
                       input=[full_matrix_projection(sub, param_attr=ParamAttr(name="_sent_proj.w"))])
    gru = gru_group(input=proj, size={gru}, name="sent_gru")
    return last_seq(input=gru, name="sent_vec")
sents = recurrent_group(step=sentence, input=SubsequenceInput(emb), name="doc")
fc = fc_layer(input=sents, size={lstm4}, act=LinearActivation(), name="doc_fc")
lstm = lstmemory(input=fc, act=ReluActivation(), name="doc_lstm")
last = last_seq(input=lstm, name="doc_last")
out = fc_layer(input=last, size=2, act=SoftmaxActivation(), name="output")
outputs(classification_cost(input=out, label=data_layer(name="label", size=2)))
"""


def test_the_hierarchical_classifier_matches_jax_at_width_8(tmp_path):
    """The nested phase's classifier (flagship.hierarchical_config) at
    width 8 builds the JAX parse's graph, and one training batch of
    flagship.nested_doc_batch (an empty sentence in it) gives the JAX
    package's loss and gradients; the document LSTM takes the fused LSTM's
    route and no kernel runs in the nested step."""
    from paddle_tpu_torch.flagship import hierarchical_config, nested_doc_batch

    widths = dict(vocab=60, emb=8, gru=8, lstm=8)
    jtc = jax_parse_config(str(_write(tmp_path, HIER_TEXT.format(
        gru3=3 * widths["gru"], lstm4=4 * widths["lstm"], **widths))))
    ttc = hierarchical_config(vocab=60, emb_dim=8, hidden=8, lstm_size=8)
    assert [(l.name, l.type, l.size) for l in ttc.model_config.layers] == \
        [(l.name, l.type, l.size) for l in jtc.model_config.layers]
    jm, jp, tm, tp = _machines(jtc, ttc, seed=1)
    batch = nested_doc_batch(vocab=60, B=6, max_sents=4, max_words=7, seed=2, device="cpu")
    assert bool((batch["words"].sub_seq_lengths[
        torch.arange(4)[None, :] < batch["words"].seq_lengths[:, None]] == 0).any())
    jfeed = {k: JArg(**{f: None if getattr(a, f) is None else jnp.asarray(getattr(a, f).numpy())
                        for f in ("value", "ids", "seq_lengths", "sub_seq_lengths")})
             for k, a in batch.items()}
    lstm_routes, gru_routes = fused_lstm.EAGER_ROUTES, fused_gru.EAGER_ROUTES
    jl, jg, _, _ = jax.jit(jm.grad_fn(sparse=False))(jp, jfeed, jax.random.PRNGKey(0))
    tl, tg, touts, _ = tm.grad_fn()(tp, batch, seed=1)
    assert (fused_lstm.EAGER_ROUTES, fused_gru.EAGER_ROUTES) == (lstm_routes, gru_routes)
    _close(float(tl), float(jl), LOSS_TOL * max(1.0, abs(float(jl))), "loss")
    assert touts["doc"].value.shape[:2] == batch["words"].sub_seq_lengths.shape
    for name in jg:
        _close(tg[name].numpy(), np.asarray(jg[name]), GRAD_TOL, f"grad {name}")


DOC_PROVIDER = """
import random

from paddle.trainer.PyDataProvider2 import *


@provider(input_types={"words": integer_value_sub_sequence(60), "label": integer_value(2)})
def process(settings, file_name):
    rng = random.Random(file_name)
    for _ in range(48):
        label = rng.randint(0, 1)
        doc = [[rng.randrange(30) + 30 * label if rng.random() < 0.3 else rng.randrange(60)
                for _ in range(rng.randint(0, 7))] for _ in range(rng.randint(1, 4))]
        yield {"words": doc, "label": label}
"""


def test_the_classifier_trains_through_both_command_lines(tmp_path):
    """The width-8 classifier on a nested PyDataProvider2 provider (empty
    sentences included) through each package's `paddle train`, one pass
    from the JAX package's first parameters: the feeder's nested batches
    reach the nested group, and the test costs agree within 1e-4
    relative, the errors equal."""
    import sys

    from paddle_tpu.trainer import checkpoint as jax_ckpt
    from test_torch_cli import ERR_KEY, QUIET, _run

    text = HIER_TEXT.format(vocab=60, emb=8, gru=8, gru3=24, lstm4=32).replace(
        "settings(", 'define_py_data_sources2(train_list="train.list", test_list="test.list",\n'
        '                        module="docs", obj="process")\nsettings(')
    conf = _write(tmp_path, text)
    (tmp_path / "docs.py").write_text(DOC_PROVIDER)
    (tmp_path / "train.list").write_text("seed-train\n")
    (tmp_path / "test.list").write_text("seed-test\n")
    sys.path.insert(0, str(tmp_path))
    try:
        params = JaxMachine(jax_parse_config(str(conf)).model_config).init_params(seed=1)
    finally:
        sys.path.remove(str(tmp_path))
    init = jax_ckpt.save_checkpoint(str(tmp_path / "init"), 0, params)
    tests = {who: _run(who, ["train", "--config=conf.py", "--num_passes=1",
                             f"--init_model_path={init}", f"--save_dir={who}"] + QUIET,
                       str(tmp_path))
             for who in ("jax", "port")}
    (want,), (got,) = tests["jax"], tests["port"]
    assert abs(got["cost"] - want["cost"]) <= 1e-4 * want["cost"], tests
    assert got[ERR_KEY] == want[ERR_KEY], tests
