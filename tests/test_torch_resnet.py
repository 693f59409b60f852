"""The port's vision layers and ResNet against the JAX package, on the CPU.

Nets written in the config DSL are parsed by both packages' parsers (the
text has no import line: each parser puts its own helpers into the
namespace), get the same parameters (the JAX package's ``init_params``,
carried over with ``bridge``) and the same batch (the same numpy draws).
The port runs kernel 9's plain version here.

A small conv net (7x7/s2 stem, ceil-mode max pool, 1x1 convs into batch
norms, residual ``addto``s, a 3x3/s2 conv with unshared bias, a strided
1x1 projection, average pool, softmax fc) is compared layer by layer in
float32 in every ``conv_stats_mode`` and with ``conv_s2d``: outputs within
1e-5 of their scale, gradients within rtol 1e-4 / atol 1e-5 of theirs,
state updates within 1e-5. Spies prove which path each side took.

ResNet-50 itself is compared at full depth, at 32² and 16 classes, B = 8.
There the float32 gradients of two implementations cannot be held
tightly: rounding moves pre-ReLU values across 0, and a relative
perturbation of 1e-7 of the input already moves some float64 gradients
of this net by ~8% (measured on this model; 1e-9 moves them by 2e-7). So
every gradient and state update is compared in float64 (the port's plain
path against the JAX package under x64, within 1e-9 of scale), and the
port's float32 ``"pallas"`` run, the one the card takes, is held to the
JAX float64 loss (rtol 1e-5) and 106 state updates (1e-4 of scale).
"""

import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.graph  # noqa: F401  (break the layers<->graph import cycle)
from paddle_tpu.config import parse_config as jax_parse_config
from paddle_tpu.flagship import make_image_batch as jax_image_batch
from paddle_tpu.flagship import resnet_config as jax_resnet_config
from paddle_tpu.graph import GradientMachine as JaxMachine
from paddle_tpu.graph.argument import Argument as JaxArgument
from paddle_tpu.graph.argument import make_dense as jax_make_dense
from paddle_tpu.graph.argument import make_ids as jax_make_ids
from paddle_tpu.graph.argument import make_seq as jax_make_seq
from paddle_tpu.layers import vision as jax_vision
from paddle_tpu.ops import pallas_conv1x1_bn as pcb
from paddle_tpu_torch.bridge import params_from_numpy, params_to_numpy
from paddle_tpu_torch.config import parse_config
from paddle_tpu_torch.flagship import make_image_batch, resnet_config
from paddle_tpu_torch.graph import Argument, GradientMachine, make_dense, make_ids, make_seq
from paddle_tpu_torch.layers import vision
from paddle_tpu_torch.trainer import Trainer
from paddle_tpu_torch.utils.flags import _Flags

torch.set_num_threads(1)

NET = """
settings(batch_size=8, learning_rate=0.01, learning_method=MomentumOptimizer(0.9),
         regularization=L2Regularization(0.0001 * 8))
img = data_layer(name="image", size=3 * 8 * 8)
stem = img_conv_layer(name="stem", input=img, filter_size=7, num_filters=8, num_channels=3,
                      stride=2, padding=3, act=LinearActivation(), bias_attr=False)
stem_bn = batch_norm_layer(name="stem_bn", input=stem, act=ReluActivation())
pool1 = img_pool_layer(name="pool1", input=stem_bn, pool_size=3, stride=2, padding=1,
                       pool_type=MaxPooling())
expand = img_conv_layer(name="expand", input=pool1, filter_size=1, num_filters=128,
                        act=LinearActivation())
expand_bn = batch_norm_layer(name="expand_bn", input=expand, act=LinearActivation())
proj = img_conv_layer(name="proj", input=pool1, filter_size=1, num_filters=128,
                      act=LinearActivation(), bias_attr=False)
proj_bn = batch_norm_layer(name="proj_bn", input=proj, act=LinearActivation())
s1 = addto_layer(name="sum1", input=[expand_bn, proj_bn], act=ReluActivation())
reduce = img_conv_layer(name="reduce", input=s1, filter_size=1, num_filters=16,
                        act=LinearActivation())
reduce_bn = batch_norm_layer(name="reduce_bn", input=reduce, act=ReluActivation())
c3 = img_conv_layer(name="c3", input=reduce_bn, filter_size=3, num_filters=32, stride=2,
                    padding=1, shared_biases=False, act=ReluActivation())
ds = img_conv_layer(name="ds", input=pool1, filter_size=1, num_filters=32, stride=2,
                    act=LinearActivation(), bias_attr=False)
ds_bn = batch_norm_layer(name="ds_bn", input=ds, act=LinearActivation())
s2 = addto_layer(name="sum2", input=[c3, ds_bn], act=ReluActivation())
gpool = img_pool_layer(name="gpool", input=s2, pool_size=2, stride=1, pool_type=AvgPooling())
out = fc_layer(name="out", input=gpool, size=4, act=SoftmaxActivation())
outputs(classification_cost(input=out, label=data_layer(name="label", size=4)))
"""
B, CLASSES = 8, 4
# 1x1 stride-1 convs: kernel 9 on the port in "pallas" mode; the JAX kernel
# takes only N % 128 == 0, so not "reduce" (N = 16)
PORT_KERNEL_LAYERS = {"expand", "proj", "reduce"}
JAX_KERNEL_LAYERS = {"expand", "proj"}
GRAM_LAYERS = {"expand", "proj", "ds"}      # N >= 2K at stride 1, N >= 4K strided
ERR_KEY = "__cost_0__.classification_error.classification_error"


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _parse_both(tmp_path, text=NET):
    path = tmp_path / "net.py"
    path.write_text(textwrap.dedent(text))
    return jax_parse_config(str(path)), parse_config(str(path))


def _batches(seed):
    rng = np.random.RandomState(seed)
    img = rng.randn(B, 3 * 8 * 8).astype(np.float32)
    lbl = rng.randint(0, CLASSES, B).astype(np.int32)
    return ({"image": jax_make_dense(img), "label": jax_make_ids(lbl)},
            {"image": make_dense(img, device="cpu"), "label": make_ids(lbl, device="cpu")})


def _scale(a):
    return max(1.0, float(np.abs(a).max()))


def _close(got, want, tol, what):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max()) / _scale(want) if want.size else 0.0
    assert err <= tol, (what, err)


def _spy(monkeypatch, module, name):
    calls = []
    orig = getattr(module, name)

    def spy(*a, **k):
        calls.append(a)
        return orig(*a, **k)

    monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("mode,s2d", [("", False), ("pallas", False), ("gram", False),
                                      ("", True)])
def test_layers_match_the_jax_package(tmp_path, monkeypatch, mode, s2d):
    """Forward outputs of every layer, the loss, every gradient and the
    state updates of a training pass; then a test pass on the updated
    moving statistics."""
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    jtc, tc = _parse_both(tmp_path)
    jm = JaxMachine(jtc.model_config, conv_stats_mode=mode, conv_s2d=s2d)
    jparams = jm.init_params(seed=2)
    jbatch, batch = _batches(seed=3)
    j_kernel = _spy(monkeypatch, pcb, "conv1x1_stats")
    j_gram = _spy(monkeypatch, jax_vision, "_publish_gram_stats")
    j_s2d = _spy(monkeypatch, jax_vision, "_stem_s2d_conv")
    jloss, jgrads, jouts, jsu = jm.grad_fn()(jparams, jbatch, None)

    m = GradientMachine(tc.model_config, device="cpu", conv_stats_mode=mode, conv_s2d=s2d)
    kernel = _spy(monkeypatch, vision, "conv1x1_stats")
    gram = _spy(monkeypatch, vision, "_publish_gram_stats")
    stem_s2d = _spy(monkeypatch, vision, "_stem_s2d_conv")
    params = params_from_numpy(_np(jparams), "cpu")
    loss, grads, outs, su = m.grad_fn()(params, batch)

    assert len(j_kernel) == (len(JAX_KERNEL_LAYERS) if mode == "pallas" else 0)
    assert len(kernel) == (len(PORT_KERNEL_LAYERS) if mode == "pallas" else 0)
    assert [a[0].name for a in j_gram] == [a[0].name for a in gram] == \
        ([l.name for l in tc.model_config.layers if l.name in GRAM_LAYERS] if mode == "gram" else [])
    assert len(j_s2d) == len(stem_s2d) == int(s2d)

    for layer in tc.model_config.layers:
        if layer.name in ("image", "label"):
            continue
        _close(outs[layer.name].value, jouts[layer.name].value, 1e-5, layer.name)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert sorted(grads) == sorted(jgrads)
    for name in sorted(jgrads):
        want = np.asarray(jgrads[name])
        np.testing.assert_allclose(grads[name].numpy(), want, rtol=1e-4,
                                   atol=1e-5 * _scale(want), err_msg=name)
    assert sorted(su) == sorted(jsu) and len(su) == 2 * 5          # 5 batch norms
    for name in jsu:
        _close(su[name], jsu[name], 1e-5, name)

    # the test pass: global statistics, no kernel
    jparams = {**jparams, **jsu}
    params = params_from_numpy(_np(jparams), "cpu")
    jouts, jsu_test = jm.forward(jparams, jbatch, "test")
    n_kernel = len(kernel)
    outs, su_test = m.forward(params, batch, "test")
    assert len(kernel) == n_kernel and not su_test and not jsu_test
    for layer in tc.model_config.layers:
        if layer.name not in ("image", "label"):
            _close(outs[layer.name].value, jouts[layer.name].value, 1e-5, layer.name)


def test_a_shape_kernel9_refuses_takes_the_plain_conv_and_batch_norm(tmp_path, monkeypatch):
    """With ``fused_conv1x1_bn.supported`` refusing the "reduce" conv's
    shape (K = 128, N = 16), that layer runs the plain conv and its batch
    norm reduces the output, counted once in ``EAGER_ROUTES``; "expand" and
    "proj" still take the kernel's plain version. Every output, the loss,
    every gradient (``jax.grad`` through the JAX machine's ``grad_fn``
    against autograd) and the state updates match the JAX package in
    "pallas" mode, whose own gate refuses the same layer (N = 16 is not a
    multiple of 128), at the tolerances of the test above."""
    from paddle_tpu_torch.ops import fused_conv1x1_bn as fc

    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    jtc, tc = _parse_both(tmp_path)
    jm = JaxMachine(jtc.model_config, conv_stats_mode="pallas")
    jparams = jm.init_params(seed=4)
    jbatch, batch = _batches(seed=5)
    j_kernel = _spy(monkeypatch, pcb, "conv1x1_stats")
    jloss, jgrads, jouts, jsu = jm.grad_fn()(jparams, jbatch, None)

    asked = []
    monkeypatch.setattr(fc, "supported", lambda M, K, N: asked.append((M, K, N)) or N != 16)
    kernel = _spy(monkeypatch, vision, "conv1x1_stats")
    before = fc.EAGER_ROUTES
    m = GradientMachine(tc.model_config, device="cpu", conv_stats_mode="pallas")
    loss, grads, outs, su = m.grad_fn()(params_from_numpy(_np(jparams), "cpu"), batch)

    M = B * 3 * 3                      # 8² -> the s2 stem's 4² -> the ceil-mode pool's 3²
    assert sorted(asked) == sorted([(M, 8, 128)] * 2 + [(M, 128, 16)])
    assert fc.EAGER_ROUTES == before + 1
    assert len(kernel) == len(j_kernel) == len(JAX_KERNEL_LAYERS)
    for layer in tc.model_config.layers:
        if layer.name not in ("image", "label"):
            _close(outs[layer.name].value, jouts[layer.name].value, 1e-5, layer.name)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert sorted(grads) == sorted(jgrads)
    for name in sorted(jgrads):
        want = np.asarray(jgrads[name])
        np.testing.assert_allclose(grads[name].numpy(), want, rtol=1e-4,
                                   atol=1e-5 * _scale(want), err_msg=name)
    assert sorted(su) == sorted(jsu)
    for name in jsu:
        _close(su[name], jsu[name], 1e-5, name)


def test_use_global_stats_and_sequence_batch_norm_match_the_jax_package(tmp_path):
    """A batch norm with use_global_stats in a training pass (moving
    statistics, no state updates), and one over a padded sequence (the
    rows of every step, padding included, as the JAX package takes them)."""
    jtc, tc = _parse_both(tmp_path, """
    x = data_layer(name="x", size=6)
    g = batch_norm_layer(name="g", input=x, act=LinearActivation(), use_global_stats=True)
    s = batch_norm_layer(name="s", input=x, act=TanhActivation())
    outputs(g, s)
    """)
    jm = JaxMachine(jtc.model_config)
    jparams = jm.init_params(seed=1)
    rng = np.random.RandomState(4)
    jparams = {k: (v + rng.rand(*v.shape).astype(np.float32) if k.endswith((".w1", ".w2"))
                   else v) for k, v in jparams.items()}
    value = (rng.randn(3, 5, 6) * 2 + 1).astype(np.float32)
    lens = np.array([5, 2, 0], np.int32)
    jouts, jsu = jm.forward(jparams, {"x": jax_make_seq(value, lens)}, "train")
    m = GradientMachine(tc.model_config, device="cpu")
    outs, su = m.forward(params_from_numpy(_np(jparams), "cpu"),
                         {"x": make_seq(value, lens, device="cpu")}, "train")
    for name in ("g", "s"):
        _close(outs[name].value, jouts[name].value, 1e-5, name)
        assert torch.equal(outs[name].seq_lengths, torch.from_numpy(lens))
    assert sorted(su) == sorted(jsu) == ["_s.w1", "_s.w2"]
    for name in jsu:
        _close(su[name], jsu[name], 1e-5, name)


def _pool_cfgs(pool_type, img, size, stride, padding, channels=2):
    from paddle_tpu.proto import LayerConfig as JLayer
    from paddle_tpu.proto import LayerInputConfig as JInput
    from paddle_tpu.proto import PoolConfig as JPool
    from paddle_tpu_torch.proto import LayerConfig, LayerInputConfig, PoolConfig

    out = (img - size + 2 * padding + stride - 1) // stride + 1     # ceil mode
    kw = dict(pool_type=pool_type, channels=channels, size_x=size, stride=stride,
              output_x=out, img_size=img, padding=padding, size_y=size, stride_y=stride,
              padding_y=padding, output_y=out, img_size_y=img)
    size_out = out * out * channels
    return (JLayer(name="p", type="pool", size=size_out,
                   inputs=[JInput(input_layer_name="x", pool_conf=JPool(**kw))]),
            LayerConfig(name="p", type="pool", size=size_out,
                        inputs=[LayerInputConfig(input_layer_name="x", pool_conf=PoolConfig(**kw))]),
            out)


@pytest.mark.parametrize("pool_type", ["max-projection", "avg-projection"])
def test_pool_ties_and_padding_windows_match_the_jax_package(pool_type):
    """Ceil mode on a 5x5 image with 2x2/s2/p1 windows: the last row and
    column of windows lie wholly in the padding (output 0, no gradient).
    The input has whole windows of zeros (after a ReLU) and ties, where
    the max's gradient goes to one element, the first in window order."""
    from paddle_tpu.layers.base import LayerContext as JaxContext
    from paddle_tpu.proto import ModelConfig as JaxModel
    from paddle_tpu_torch.layers.base import LayerContext
    from paddle_tpu_torch.proto import ModelConfig

    jcfg, cfg, out = _pool_cfgs(pool_type, img=5, size=2, stride=2, padding=1)
    assert out == 4
    rng = np.random.RandomState(0)
    x = np.maximum(rng.randint(-2, 3, (3, 2, 5, 5)), 0).astype(np.float32)   # NCHW
    x[0, 0, :2, :2] = 0.0
    x[1, 1] = 7.0                                            # every window a tie
    flat = x.reshape(3, -1)
    cot = rng.randn(3, 2 * out * out).astype(np.float32)

    def jloss(v):
        y = jax_vision.pool_layer(jcfg, [JaxArgument(value=v)],
                                  JaxContext(params={}, model=JaxModel())).value
        return jnp.sum(y * cot), y

    (_, jy), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(flat))
    xt = torch.from_numpy(flat).requires_grad_()
    y = vision.pool_layer(cfg, [Argument(value=xt)], LayerContext(params={}, model=ModelConfig()))
    y = y.value
    (y * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad), rtol=1e-6, atol=1e-6)
    y4 = y.detach().numpy().reshape(3, 2, out, out)
    assert not y4[:, :, 3, :].any() and not y4[:, :, :, 3].any()   # windows in the padding
    if pool_type == "max-projection":
        # each tied window of sample 1, channel 1 sends its gradient to one element
        g = xt.grad.numpy().reshape(3, 2, 5, 5)[1, 1]
        assert np.count_nonzero(g) == 9 and g[0, 0] == cot[1, 16]


def test_resnet50_config_matches_the_jax_package():
    """The shape bench.py trains: the same layers and parameters, 267
    tensors (106 of them the moving statistics of 53 batch norms), and 30
    1x1 stride-1 convs for kernel 9."""
    ours, theirs = resnet_config(50, 224, 1000), jax_resnet_config(50, 224, 1000)
    for field in ("layers", "parameters", "evaluators", "input_layer_names", "output_layer_names"):
        assert repr(getattr(ours.model_config, field)) == repr(getattr(theirs.model_config, field))
    assert repr(ours.opt_config) == repr(theirs.opt_config)
    params = ours.model_config.parameters
    assert len(params) == 267 and sum(p.is_static for p in params) == 106
    assert sum(int(np.prod(p.dims)) for p in params) == 25610152
    shapes = sorted((64 * l.inputs[0].conv_conf.img_size ** 2, l.inputs[0].conv_conf.channels,
                     l.num_filters)
                    for l in ours.model_config.layers
                    if l.type == "exconv" and l.inputs[0].conv_conf.filter_size == 1
                    and l.inputs[0].conv_conf.stride == 1)
    assert len(shapes) == 30 and len(set(shapes)) == 9
    assert shapes[-1] == (207936, 256, 64)                  # stage 2 runs at 57x57


def test_resnet50_at_32px_matches_the_jax_package(monkeypatch):
    """The whole ResNet-50 (layer_num 50, 32², 16 classes, B = 8): every
    gradient and state update in float64, and the port's float32
    ``"pallas"`` run (30 kernel-9 calls) against the JAX float64 loss and
    state updates (see the module docstring for why)."""
    jm = JaxMachine(jax_resnet_config(50, 32, 16).model_config)
    jparams = _np(jm.init_params(seed=1))
    jbatch = jax_image_batch(8, 32, 16, seed=1)
    with jax.enable_x64(True):
        jm64 = JaxMachine(jax_resnet_config(50, 32, 16).model_config, dtype=jnp.float64)
        jloss, jgrads, _, jsu = jm64.grad_fn()(
            {k: jnp.asarray(v, jnp.float64) for k, v in jparams.items()},
            {"input": JaxArgument(value=jnp.asarray(jbatch["input"].value, jnp.float64)),
             "label": jbatch["label"]}, None)
        jloss, jgrads, jsu = float(jloss), _np(jgrads), _np(jsu)
    assert jgrads["_conv1.w0"].dtype == np.float64 and len(jsu) == 106

    # the bridge carries every parameter, the moving statistics included
    params = params_from_numpy(jparams, "cpu")
    assert sorted(params) == sorted(jparams) and all(
        np.array_equal(v, jparams[k]) for k, v in params_to_numpy(params).items())
    cfg = resnet_config(50, 32, 16).model_config
    m64 = GradientMachine(cfg, device="cpu")
    batch = make_image_batch(8, 32, 16, seed=1, device="cpu")
    loss, grads, _, su = m64.grad_fn()(
        {k: v.double() for k, v in params.items()},
        {"input": Argument(value=batch["input"].value.double()), "label": batch["label"]})
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-12)
    assert sorted(grads) == sorted(jgrads)
    for name in jgrads:
        _close(grads[name], jgrads[name], 1e-9, name)
    assert sorted(su) == sorted(jsu)
    for name in jsu:
        _close(su[name], jsu[name], 1e-9, name)

    kernel = _spy(monkeypatch, vision, "conv1x1_stats")
    m32 = GradientMachine(cfg, device="cpu", conv_stats_mode="pallas")
    loss, grads, outs, su = m32.grad_fn()(params, batch)
    assert len(kernel) == 30
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    assert sorted(su) == sorted(jsu)
    for name in jsu:
        _close(su[name], jsu[name], 1e-4, name)
    assert all(torch.isfinite(g).all() for g in grads.values())


def test_three_momentum_steps_follow_the_jax_loss_curve(tmp_path):
    """Momentum 0.9 with L2 decay and the BN state updates after each
    update, the port in ``"pallas"`` mode against the JAX package's plain
    path; parameters after 3 steps within rtol 1e-4."""
    from paddle_tpu.optimizer import Updater as JaxUpdater

    jtc, tc = _parse_both(tmp_path)
    tc.opt_config.conv_stats_mode = "pallas"
    jm = JaxMachine(jtc.model_config)
    jparams = jm.init_params(seed=4)
    upd = JaxUpdater(jtc.opt_config, jtc.model_config)
    state = upd.init_state(jparams)
    jbatch, batch = _batches(seed=7)
    grad_fn = jm.grad_fn()
    trainer = Trainer(tc, device="cpu")
    assert trainer.gm.conv_stats_mode == "pallas"
    trainer.params = params_from_numpy(_np(jparams), "cpu")
    trainer.opt_state = trainer.updater.init_state(trainer.params)
    jcurve, curve = [], []
    for _ in range(3):
        loss, grads, _, jsu = grad_fn(jparams, jbatch, None)
        jparams, state = upd(jparams, grads, state, B)
        jparams = {**jparams, **jsu}
        jcurve.append(float(loss))
        curve.append(float(trainer.train_one_batch(batch)))
    np.testing.assert_allclose(curve, jcurve, rtol=1e-5)
    assert curve[-1] < curve[0]
    for name in sorted(jparams):
        want = np.asarray(jparams[name])
        np.testing.assert_allclose(trainer.params[name].numpy(), want, rtol=1e-4,
                                   atol=1e-6 * _scale(want), err_msg=name)


def test_test_pass_matches_the_jax_evaluators(tmp_path, monkeypatch):
    """``Trainer.test`` (global statistics, no kernel launch) against the
    JAX forward's outputs fed to the JAX ``EvaluatorChain``, over three
    batches: the mean per-sample cost and classification_error."""
    from paddle_tpu.trainer.evaluators import EvaluatorChain as JaxChain

    jtc, tc = _parse_both(tmp_path)
    jm = JaxMachine(jtc.model_config)
    jparams = jm.init_params(seed=5)
    _, _, _, jsu = jm.grad_fn()(jparams, _batches(seed=9)[0], None)
    jparams = {**jparams, **jsu}                    # moving statistics away from 0 and 1
    chain = JaxChain(jtc.model_config)
    chain.start()
    total = 0.0
    for seed in range(3):
        outputs, _ = jm.forward(jparams, _batches(seed)[0], "test")
        total += float(jm.total_cost(outputs)) * B
        chain.eval_batch(outputs)
    want = {"cost": total / (3 * B), **chain.results()}

    tc.opt_config.conv_stats_mode = "pallas"
    trainer = Trainer(tc, device="cpu")
    trainer.params = params_from_numpy(_np(jparams), "cpu")
    kernel = _spy(monkeypatch, vision, "conv1x1_stats")
    got = trainer.test_batches([_batches(seed)[1] for seed in range(3)])
    assert kernel == []
    assert sorted(got) == sorted(want) == [ERR_KEY, "cost"]
    np.testing.assert_allclose(got["cost"], want["cost"], rtol=1e-5)
    assert got[ERR_KEY] == want[ERR_KEY]


def test_checkpoint_round_trip_keeps_the_moving_statistics(tmp_path):
    """pass-00000 after two steps, restored into a fresh Trainer: every
    parameter (the BN moving means and variances, which the steps moved,
    included) and every Momentum slot equal, and the same test results."""
    _, tc = _parse_both(tmp_path)
    tc.opt_config.conv_stats_mode = "pallas"
    trainer = Trainer(tc, _Flags(save_dir=str(tmp_path / "out")), device="cpu")
    fresh_stats = {k: v.clone() for k, v in trainer.params.items() if k.endswith((".w1", ".w2"))}
    assert len(fresh_stats) == 10
    batch = _batches(seed=1)[1]
    for _ in range(2):
        trainer.train_one_batch(batch)
    for name, v in fresh_stats.items():
        assert not torch.equal(trainer.params[name], v), name
    path = trainer.save(0)
    assert path.endswith("pass-00000")
    fresh = Trainer(tc, _Flags(seed=2), device="cpu")
    fresh.restore(path)
    assert fresh.opt_state.step == trainer.opt_state.step == 2
    for name, p in trainer.params.items():
        assert torch.equal(fresh.params[name], p), name
        for slot, v in trainer.opt_state.slots[name].items():
            assert torch.equal(fresh.opt_state.slots[name][slot], v), (name, slot)
    assert fresh.test_batches([batch]) == trainer.test_batches([batch])


def test_nhwc_chain_builds_no_flat_values(tmp_path, monkeypatch):
    """Between conv-family layers the activations stay contiguous NHWC: the
    image is converted once (the stem's input), the flat NCHW value is built
    once (for the fc after the global pool, where it is a view), and no
    other layer's flat value is ever built."""
    _, tc = _parse_both(tmp_path)
    to_nhwc = _spy(monkeypatch, vision, "_nchw_to_nhwc")
    to_flat = _spy(monkeypatch, vision, "_nhwc_to_flat")
    for mode in ("", "pallas"):
        m = GradientMachine(tc.model_config, device="cpu", conv_stats_mode=mode)
        params = m.init_params(seed=1)
        _, _, outs, _ = m.grad_fn()(params, _batches(seed=1)[1])
        images = {n: a for n, a in outs.items() if isinstance(a, vision.ImageArgument)}
        assert len(images) == 15
        assert [n for n, a in images.items() if a.flat_built] == ["gpool"]
        assert all(a.nhwc.is_contiguous() for a in images.values())
        gpool = outs["gpool"]
        assert gpool.value.data_ptr() == gpool.nhwc.data_ptr()      # a view, not a copy
    assert len(to_nhwc) == 2 and len(to_flat) == 2


def test_error_clipping_drops_the_nhwc_view(tmp_path):
    """A layer with error clipping hands its consumers the clipped flat
    value, never its NHWC view (which would bypass the clip)."""
    _, tc = _parse_both(tmp_path, NET.replace(
        'proj_bn = batch_norm_layer(name="proj_bn", input=proj, act=LinearActivation())',
        'proj_bn = batch_norm_layer(name="proj_bn", input=proj, act=LinearActivation(), '
        'layer_attr=ExtraAttr(error_clipping_threshold=1e-3))'))
    m = GradientMachine(tc.model_config, device="cpu")
    params = m.init_params(seed=1)
    loss, grads, outs, _ = m.grad_fn()(params, _batches(seed=1)[1])
    assert not isinstance(outs["proj_bn"], vision.ImageArgument)
    assert isinstance(outs["expand_bn"], vision.ImageArgument)
    assert torch.isfinite(loss)


BF16_NET = """
settings(batch_size=8, learning_rate=0.01, learning_method=MomentumOptimizer(0.9),
         regularization=L2Regularization(0.0001 * 8), dtype="bfloat16")
img = data_layer(name="image", size=16 * 4 * 4)
expand = img_conv_layer(name="expand", input=img, filter_size=1, num_filters=128,
                        num_channels=16, act=LinearActivation(), bias_attr=False)
expand_bn = batch_norm_layer(name="expand_bn", input=expand, act=ReluActivation())
mix = img_conv_layer(name="mix", input=expand_bn, filter_size=1, num_filters=128,
                     act=LinearActivation())
mix_bn = batch_norm_layer(name="mix_bn", input=mix, act=ReluActivation())
gpool = img_pool_layer(name="gpool", input=mix_bn, pool_size=4, stride=1,
                       pool_type=AvgPooling())
out = fc_layer(name="out", input=gpool, size=4, act=SoftmaxActivation())
outputs(classification_cost(input=out, label=data_layer(name="label", size=4)))
"""


def test_bf16_conv_bn_net_follows_the_jax_bf16_momentum_steps(tmp_path, monkeypatch):
    """A bf16 net of two 1x1 convs (one with a bias) into batch norms, in
    "pallas" mode on both sides: the JAX package's interpreted kernel 9
    (M = 128, N = 128, as its tiling takes) and the port's bf16 plain
    version, from the same parameters over 3 Momentum steps. Losses and
    the moving statistics within the JAX package's bf16 bound (rtol 0.05 /
    atol 0.02, tests/test_bf16.py)."""
    from paddle_tpu.optimizer import Updater as JaxUpdater

    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    jtc, tc = _parse_both(tmp_path, BF16_NET)
    assert jtc.opt_config.dtype == tc.opt_config.dtype == "bfloat16"
    tc.opt_config.conv_stats_mode = "pallas"
    jm = JaxMachine(jtc.model_config, conv_stats_mode="pallas", compute_dtype=jnp.bfloat16)
    jparams = jm.init_params(seed=11)
    upd = JaxUpdater(jtc.opt_config, jtc.model_config)
    state = upd.init_state(jparams)
    rng = np.random.RandomState(12)
    img = rng.randn(B, 16 * 4 * 4).astype(np.float32)
    lbl = rng.randint(0, CLASSES, B).astype(np.int32)
    jbatch = {"image": jax_make_dense(img), "label": jax_make_ids(lbl)}
    batch = {"image": make_dense(img, device="cpu"), "label": make_ids(lbl, device="cpu")}
    j_kernel = _spy(monkeypatch, pcb, "conv1x1_stats")
    kernel = _spy(monkeypatch, vision, "conv1x1_stats")
    trainer = Trainer(tc, device="cpu")
    assert trainer.gm.compute_dtype == torch.bfloat16
    trainer.params = params_from_numpy(_np(jparams), "cpu")
    trainer.opt_state = trainer.updater.init_state(trainer.params)
    grad_fn = jax.jit(jm.grad_fn())
    jcurve, curve = [], []
    for _ in range(3):
        loss, grads, _, jsu = grad_fn(jparams, jbatch, None)
        jparams, state = upd(jparams, grads, state, B)
        jparams = {**jparams, **jsu}
        jcurve.append(float(loss))
        curve.append(float(trainer.train_one_batch(batch)))
    assert len(j_kernel) == 2 and len(kernel) == 2 * 3      # traced once under jit
    assert all(a[0].dtype == torch.bfloat16 for a in kernel)
    np.testing.assert_allclose(curve, jcurve, rtol=0.05, atol=0.02)
    stats = sorted(jsu)
    assert len(stats) == 4
    for name in stats:
        np.testing.assert_allclose(trainer.params[name].numpy(), np.asarray(jparams[name]),
                                   rtol=0.05, atol=0.02, err_msg=name)
    assert all(p.dtype == torch.float32 for p in trainer.params.values())
