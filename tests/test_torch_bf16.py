"""bf16 mixed precision in the port against the JAX package, on the CPU.

OptimizationConfig.dtype = "bfloat16" trains with float32 master weights,
gradients and optimizer state, activations and products in bf16, and the
float32 islands (softmax, losses, batch-norm statistics, CRF/CTC) upcast
(``paddle_tpu_torch/layers/base.py::LayerContext``). The parameters come
from the JAX package's ``init_params`` through ``paddle_tpu_torch.bridge``
and the batches from the same numpy draws, so each case holds the port to
the JAX package's own bf16 tolerances (tests/test_bf16.py), with the JAX
side in bf16 too.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.graph  # noqa: F401  (break the layers<->graph import cycle)
from paddle_tpu.flagship import example_batch as jax_example_batch
from paddle_tpu.flagship import flagship_config as jax_flagship_config
from paddle_tpu.graph import GradientMachine as JaxMachine
from paddle_tpu.graph import make_dense as jax_dense
from paddle_tpu.graph import make_ids as jax_ids
from paddle_tpu.optimizer import Updater as JaxUpdater
from paddle_tpu_torch.bridge import params_from_numpy
from paddle_tpu_torch.flagship import example_batch, flagship_config
from paddle_tpu_torch.graph import GradientMachine, make_dense, make_ids
from paddle_tpu_torch.trainer import Trainer

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(dict_dim=50, emb_dim=8, hidden=16, classes=2)
BF16 = jnp.bfloat16


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _bf16(tc):
    tc.opt_config.dtype = "bfloat16"
    return tc


def _jax_curve(tc, jbatch, steps, seed):
    """The JAX package's bf16 training curve (tests/test_bf16.py::_train),
    from its init_params(seed): (losses, params, initial params)."""
    jm = JaxMachine(tc.model_config, compute_dtype=BF16)
    upd = JaxUpdater(tc.opt_config, tc.model_config)
    params = jm.init_params(seed=seed)
    first = dict(params)
    state = upd.init_state(params)
    grad_fn = jax.jit(jm.grad_fn())
    B = next(iter(jbatch.values())).batch_size
    losses = []
    for _ in range(steps):
        loss, grads, _, su = grad_fn(params, jbatch, None)
        params, state = upd(params, grads, state, float(B))
        params = {**params, **su}
        losses.append(float(loss))
    return losses, params, first


def _port_curve(tc, batch, steps, jparams0):
    trainer = Trainer(tc, device="cpu")
    trainer.params = params_from_numpy(_np(jparams0), "cpu")
    trainer.opt_state = trainer.updater.init_state(trainer.params)
    return [float(trainer.train_one_batch(batch)) for _ in range(steps)], trainer


def test_the_trainer_trains_in_the_configs_compute_dtype(monkeypatch):
    """settings(dtype="bfloat16") reaches the port's Trainer: its machine
    computes in bf16 (the embedding output is bf16, the cost float32) and
    its loss tracks the JAX package's bf16 loss from the same parameters
    more closely than the float32 loss does. The JAX package runs its
    Pallas LSTM (interpret mode; H = 128 and B = 8 for its tiling), whose
    bf16 rounding points the port's bf16 LSTM keeps, op by op (under jit
    XLA may keep a bf16 intermediate in float32)."""
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    widths = dict(SMALL, hidden=128)
    jbatch = jax_example_batch(50, B=8, T=6, seed=7)
    jm16 = JaxMachine(_bf16(jax_flagship_config(**widths)).model_config, compute_dtype=BF16,
                      pallas_rnn=True)
    jp0 = jm16.init_params(seed=4)
    jl16 = [float(jm16.grad_fn()(jp0, jbatch, None)[0])]
    jm32 = JaxMachine(jax_flagship_config(**widths).model_config, pallas_rnn=True)
    jl32 = float(jm32.grad_fn()(jp0, jbatch, None)[0])
    batch = example_batch(50, B=8, T=6, seed=7, device="cpu")
    curve, trainer = _port_curve(_bf16(flagship_config(**widths)), batch, 1, jp0)
    outs, _ = trainer.gm.forward(params_from_numpy(_np(jp0), "cpu"), batch, "train")
    assert outs["__embedding_0__"].value.dtype == torch.bfloat16
    assert outs["__cost_0__"].value.dtype == torch.float32
    assert abs(curve[0] - jl16[0]) < 0.5 * abs(jl32 - jl16[0]), (curve, jl16, jl32)
    assert trainer.gm.compute_dtype == torch.bfloat16


def test_compute_dtype_of():
    from paddle_tpu_torch.graph.machine import compute_dtype_of

    tc = flagship_config(**SMALL)
    assert compute_dtype_of(tc.opt_config) is None
    tc.opt_config.dtype = "bfloat16"
    assert compute_dtype_of(tc.opt_config) == torch.bfloat16
    tc.opt_config.dtype = "int8"
    with pytest.raises(ValueError):
        compute_dtype_of(tc.opt_config)
    with pytest.raises(NotImplementedError, match="float16"):
        GradientMachine(tc.model_config, device="cpu", compute_dtype="float16")
    assert GradientMachine(tc.model_config, device="cpu",
                           compute_dtype=torch.float32).compute_dtype is None


def test_bf16_activation_islands():
    """Activations bf16; the softmax output bf16 but normalised in float32;
    the cost float32 (tests/test_bf16.py::test_bf16_activation_islands)."""
    gm = GradientMachine(flagship_config(**SMALL).model_config, device="cpu",
                         compute_dtype="bfloat16")
    outs, _ = gm.forward(gm.init_params(seed=1), example_batch(50, B=4, T=8, device="cpu"),
                         "train", seed=0)
    assert outs["__embedding_0__"].value.dtype == torch.bfloat16
    assert outs["output"].value.dtype == torch.bfloat16
    assert outs["__cost_0__"].value.dtype == torch.float32
    np.testing.assert_allclose(outs["output"].value.float().sum(-1).numpy(), 1.0, atol=2e-2)


def _regression_config(pkg):
    builder = __import__(f"{pkg}.config.builder", fromlist=["fresh_context"])
    h = __import__(f"{pkg}.trainer_config_helpers", fromlist=["x"])
    with builder.fresh_context() as ctx:
        h.settings(batch_size=4, learning_rate=0.1, dtype="bfloat16")
        x = h.data_layer(name="x", size=8)
        y = h.data_layer(name="y", size=1)
        pred = h.fc_layer(input=x, size=1, act=h.LinearActivation(), name="pred")
        h.outputs(h.regression_cost(input=pred, label=y))
        return ctx.finalize()


def test_cost_only_data_layers_are_not_narrowed():
    """A regression target feeds only the cost: it reaches the float32 loss
    island un-rounded (tests/test_bf16.py::test_cost_only_data_layers_not_narrowed),
    and the loss equals the JAX package's."""
    tc = _regression_config("paddle_tpu_torch")
    gm = GradientMachine(tc.model_config, device="cpu", compute_dtype=tc.opt_config.dtype)
    assert gm.no_cast_inputs == frozenset({"y"})
    rng = np.random.RandomState(5)
    x = rng.randn(4, 8).astype(np.float32)
    y = np.full((4, 1), 0.123456, np.float32)
    jtc = _regression_config("paddle_tpu")
    jm = JaxMachine(jtc.model_config, compute_dtype=BF16)
    jp = jm.init_params(seed=1)
    jouts, _ = jm.forward(jp, {"x": jax_dense(x), "y": jax_dense(y)}, "train", None)
    outs, _ = gm.forward(params_from_numpy(_np(jp), "cpu"),
                         {"x": make_dense(x, device="cpu"), "y": make_dense(y, device="cpu")},
                         "train")
    assert outs["x"].value.dtype == torch.bfloat16
    assert outs["y"].value.dtype == torch.float32
    np.testing.assert_array_equal(outs["y"].value.numpy(), y)
    cost = [n for n in outs if n.startswith("__")][-1]
    np.testing.assert_allclose(outs[cost].value.numpy(), np.asarray(jouts[cost].value),
                               rtol=1e-2, atol=1e-4)


def _sparse_config(pkg):
    builder = __import__(f"{pkg}.config.builder", fromlist=["fresh_context"])
    h = __import__(f"{pkg}.trainer_config_helpers", fromlist=["x"])
    with builder.fresh_context() as ctx:
        h.settings(batch_size=4, learning_rate=0.1, dtype="bfloat16")
        words = h.data_layer(name="words", size=100)
        emb = h.embedding_layer(input=words, size=8,
                                param_attr=h.ParamAttr(name="emb", sparse_update=True))
        pool = h.pooling_layer(input=emb)
        out = h.fc_layer(input=pool, size=2, act=h.SoftmaxActivation(), name="out")
        label = h.data_layer(name="label", size=2)
        h.outputs(h.classification_cost(input=out, label=label))
        return ctx.finalize()


def test_sparse_table_gradients_stay_float32():
    """A sparse_update table: its prefetched rows are cast to bf16 in the
    compute, and its row gradients come back float32 for the master update
    (tests/test_bf16.py::test_sparse_table_grads_stay_f32_under_bf16),
    within bf16 noise of the JAX package's."""
    from paddle_tpu.optimizer.sparse import RowSparseGrad as JaxRows
    from paddle_tpu_torch.optimizer.sparse import RowSparseGrad

    jtc = _sparse_config("paddle_tpu")
    jm = JaxMachine(jtc.model_config, compute_dtype=BF16)
    jp = jm.init_params(seed=1)
    jloss, jg, _, _ = jm.grad_fn()(jp, jax_example_batch(dict_dim=100, B=4, T=8),
                                   jax.random.PRNGKey(0))
    tc = _sparse_config("paddle_tpu_torch")
    gm = GradientMachine(tc.model_config, device="cpu", compute_dtype=tc.opt_config.dtype)
    loss, g, outs, _ = gm.grad_fn()(params_from_numpy(_np(jp), "cpu"),
                                    example_batch(dict_dim=100, B=4, T=8, device="cpu"))
    assert isinstance(g["emb"], RowSparseGrad) and isinstance(jg["emb"], JaxRows)
    assert g["emb"].rows.dtype == torch.float32
    assert outs["__embedding_0__"].value.dtype == torch.bfloat16
    np.testing.assert_allclose(float(loss), float(jloss), rtol=5e-3, atol=1e-3)
    jd = np.zeros((100, 8), np.float32)
    np.add.at(jd, np.asarray(jg["emb"].ids).reshape(-1), np.asarray(jg["emb"].rows, np.float32))
    scale = float(np.abs(jd).max())
    np.testing.assert_allclose(g["emb"].to_dense().numpy() / scale, jd / scale, rtol=0, atol=0.05)


def test_lstm_classifier_bf16_steps_track_the_jax_package():
    """Five Adam steps of the LSTM classifier in bf16 (the port's plain LSTM
    on the CPU, the JAX scan), from the same parameters: the losses within
    rtol 0.05 / atol 0.02 (tests/test_bf16.py:74), both falling, the master
    parameters float32."""
    jbatch = jax_example_batch(50, B=8, T=16, seed=0)
    jl, _, jp0 = _jax_curve(_bf16(jax_flagship_config(**SMALL)), jbatch, 5, seed=1)
    curve, trainer = _port_curve(_bf16(flagship_config(**SMALL)),
                                 example_batch(50, B=8, T=16, seed=0, device="cpu"), 5, jp0)
    np.testing.assert_allclose(curve, jl, rtol=0.05, atol=0.02)
    assert curve[-1] < curve[0] and jl[-1] < jl[0]
    assert all(v.dtype == torch.float32 for v in trainer.params.values())


def test_lstm_classifier_bf16_step_tracks_the_pallas_kernels(monkeypatch):
    """One Adam step of the classifier in bf16 with the LSTM at H = 128 and
    B = 8 (the Pallas kernels' tiling): the port's bf16 plain versions of
    kernels 7b and 8 (the CPU's autograd Function) against the JAX package's
    GradientMachine(pallas_rnn=True), its Pallas kernels run in interpret
    mode at itemsize 2, from the same parameters. The loss within rtol
    0.05 / atol 0.02 and every gradient within 5e-2 of its scale (the JAX
    package's bf16 bounds, tests/test_bf16.py); after the step the master
    parameters float32 and within two Adam steps (2 lr) of the JAX
    package's."""
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    from paddle_tpu.ops import pallas_lstm as pk

    calls = []
    orig = pk.lstm_layer_forward
    monkeypatch.setattr(pk, "lstm_layer_forward",
                        lambda *a, **k: (calls.append(1), orig(*a, **k))[1])
    widths = dict(dict_dim=50, emb_dim=8, hidden=128, classes=2)
    jtc = _bf16(jax_flagship_config(**widths))
    jm = JaxMachine(jtc.model_config, compute_dtype=BF16, pallas_rnn=True)
    jp = jm.init_params(seed=5)
    jloss, jg, _, _ = jm.grad_fn()(jp, jax_example_batch(50, B=8, T=8, seed=3), None)
    assert calls
    upd = JaxUpdater(jtc.opt_config, jtc.model_config)
    jnew, _ = upd(jp, jg, upd.init_state(jp), 8.0)
    tc = _bf16(flagship_config(**widths))
    trainer = Trainer(tc, device="cpu")
    trainer.params = params_from_numpy(_np(jp), "cpu")
    trainer.opt_state = trainer.updater.init_state(trainer.params)
    batch = example_batch(50, B=8, T=8, seed=3, device="cpu")
    loss, grads, _, _ = trainer.gm.grad_fn()(trainer.params, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=0.05, atol=0.02)
    assert sorted(grads) == sorted(jg)
    for n in jg:
        want = np.asarray(jg[n], np.float32)
        assert grads[n].dtype == torch.float32, n
        err = float(np.abs(grads[n].numpy() - want).max())
        assert err <= 5e-2 * float(np.abs(want).max()), (n, err, float(np.abs(want).max()))
    assert float(trainer.train_one_batch(batch)) == float(loss)
    lr = tc.opt_config.learning_rate
    for n in jnew:
        assert trainer.params[n].dtype == torch.float32, n
        np.testing.assert_allclose(trainer.params[n].numpy(), np.asarray(jnew[n]), rtol=0,
                                   atol=2 * lr, err_msg=n)


def _conv_bn_config(pkg, dtype):
    builder = __import__(f"{pkg}.config.builder", fromlist=["fresh_context"])
    h = __import__(f"{pkg}.trainer_config_helpers", fromlist=["x"])
    with builder.fresh_context() as ctx:
        h.settings(batch_size=8, learning_rate=0.01,
                   learning_method=h.MomentumOptimizer(0.9), dtype=dtype)
        img = h.data_layer(name="image", size=3 * 8 * 8)
        conv = h.img_conv_layer(input=img, filter_size=3, num_filters=8, num_channels=3,
                                stride=1, padding=1, name="conv")
        bn = h.batch_norm_layer(input=conv, name="bn")
        pool = h.img_pool_layer(input=bn, pool_size=2, stride=2, num_channels=8)
        out = h.fc_layer(input=pool, size=4, act=h.SoftmaxActivation(), name="out")
        label = h.data_layer(name="label", size=4)
        h.outputs(h.classification_cost(input=out, label=label))
        return ctx.finalize()


def test_conv_bn_bf16_steps_and_running_statistics_track_the_jax_package():
    """Four momentum steps of conv + batch norm in bf16 (tests/test_bf16.py
    :132-146): the losses within rtol 0.08 / atol 0.05, and the running
    statistics, float32 master parameters on both sides, within 0.05."""
    rng = np.random.RandomState(3)
    image = rng.randn(8, 3 * 8 * 8).astype(np.float32)
    label = rng.randint(0, 4, (8,)).astype(np.int32)
    jl, jparams, jp0 = _jax_curve(_conv_bn_config("paddle_tpu", "bfloat16"),
                                  {"image": jax_dense(image), "label": jax_ids(label)}, 4, seed=1)
    curve, trainer = _port_curve(_conv_bn_config("paddle_tpu_torch", "bfloat16"),
                                 {"image": make_dense(image, device="cpu"),
                                  "label": make_ids(label, device="cpu")}, 4, jp0)
    assert trainer.gm.compute_dtype == torch.bfloat16
    np.testing.assert_allclose(curve, jl, rtol=0.08, atol=0.05)
    bn = next(l for l in trainer.config.model_config.layers if l.type == "batch_norm")
    stats = [bn.inputs[1].input_parameter_name, bn.inputs[2].input_parameter_name]
    for n in trainer.params:
        assert trainer.params[n].dtype == torch.float32, n
    for n in stats:
        np.testing.assert_allclose(trainer.params[n].numpy(), np.asarray(jparams[n]),
                                   rtol=0.05, atol=0.05, err_msg=n)


def test_quick_start_lr_bf16_through_the_command_line(tmp_path):
    """quick_start's LR config with settings(dtype="bfloat16") through the
    port's ``paddle train``: its held-out cost within rtol 0.05 of the same
    run in float32 (tests/test_quick_start.py::test_lr_bf16_parity, at 4
    passes of the command-line band's 25 train and 5 test entries), and it
    learns."""
    from paddle_tpu_torch import cli
    from paddle_tpu_torch.observability import metrics as port_obs
    from paddle_tpu_torch.trainer import trainer as port_trainer
    from paddle_tpu_torch.utils.flags import FLAGS

    qs = os.path.join(REPO, "demo", "quick_start")
    costs = {}
    for dtype in ("float32", "bfloat16"):
        ws = tmp_path / dtype
        ws.mkdir()
        for name in ("common.py", "dataprovider_bow.py"):
            shutil.copy(os.path.join(qs, name), ws)
        conf = open(os.path.join(qs, "trainer_config.lr.py")).read()
        assert "settings(batch_size=" in conf
        (ws / "trainer_config.lr.py").write_text(
            conf.replace("settings(batch_size=", f'settings(dtype="{dtype}", batch_size=', 1))
        (ws / "train.list").write_text("".join(f"seed-train-{i}\n" for i in range(1, 26)))
        (ws / "test.list").write_text("".join(f"seed-test-{i}\n" for i in range(1, 6)))
        saved, tests = dict(vars(FLAGS)), []
        vars(FLAGS).update(vars(type(FLAGS)()))
        test = port_trainer.Trainer.test
        machines = []

        def spy(self, *a, **k):
            machines.append(self.gm.compute_dtype)
            tests.append(test(self, *a, **k))
            return tests[-1]

        old = os.getcwd()
        try:
            os.chdir(ws)
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(port_trainer.Trainer, "test", spy)
                assert cli.main(["train", "--config=trainer_config.lr.py", "--num_passes=4",
                                 "--save_dir=", "--use_tpu=false", "--log_period=0"]) == 0
        finally:
            os.chdir(old)
            vars(FLAGS).update(saved)
            port_obs.configure("")
        assert machines[-1] == (torch.bfloat16 if dtype == "bfloat16" else None)
        costs[dtype] = tests[-1]["cost"]
    assert costs["bfloat16"] < 0.4, costs
    np.testing.assert_allclose(costs["bfloat16"], costs["float32"], rtol=0.05)
