"""The port's training path against the JAX package, on the CPU.

The seqToseq NMT model (``nmt_config``), built by both packages' DSLs,
gets the same parameters (the JAX package's, carried over as numpy) and
the same batch (``nmt_batch``, the same numpy draws). The port runs every
kernel's plain version here; its loss and every parameter gradient must
match the JAX ``grad_fn`` both on the JAX scan path and on its Pallas
kernels in interpret mode, at rtol 2e-4 / atol 2e-5 (the bound
tests/test_fused_decoder.py holds the JAX kernel path to its scan with).
Spies prove which path each side took.
"""

import jax
import numpy as np
import pytest
import torch

import paddle_tpu.graph  # noqa: F401  (break the layers<->graph import cycle)
from paddle_tpu.flagship import nmt_batch as jax_nmt_batch
from paddle_tpu.flagship import nmt_config as jax_nmt_config
from paddle_tpu.graph import GradientMachine as JaxMachine
from paddle_tpu_torch.bridge import params_from_numpy
from paddle_tpu_torch.flagship import nmt_batch, nmt_config
from paddle_tpu_torch.graph import Argument, GradientMachine, make_seq
from paddle_tpu_torch.graph import fused_decoder as port_fd

torch.set_num_threads(1)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _assert_same(loss, grads, jloss, jgrads):
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5, atol=1e-6)
    assert sorted(grads) == sorted(jgrads)
    for name in sorted(jgrads):
        np.testing.assert_allclose(grads[name].numpy(), np.asarray(jgrads[name]),
                                   err_msg=name, **GRAD_TOL)


def _spy(monkeypatch, module, name):
    calls = []
    orig = getattr(module, name)

    def spy(*a, **k):
        out = orig(*a, **k)
        calls.append(out is not None)
        return out

    monkeypatch.setattr(module, name, spy)
    return calls


def _port_grads(dim, vocab, B, T, jparams):
    tc = nmt_config(vocab=vocab, dim=dim, batch_size=B)
    machine = GradientMachine(tc.model_config, device="cpu")
    loss, grads, _, _ = machine.grad_fn()(params_from_numpy(_np(jparams), "cpu"),
                                          nmt_batch(vocab=vocab, B=B, T=T, device="cpu"))
    return loss, grads


def test_nmt_gradients_match_the_jax_scan(monkeypatch):
    """The JAX package's default path (lax.scan, no kernels) at dim 16."""
    tc = jax_nmt_config(vocab=50, dim=16, batch_size=4)
    jm = JaxMachine(tc.model_config)
    jparams = jm.init_params(seed=11)
    jloss, jgrads, _, _ = jm.grad_fn()(jparams, jax_nmt_batch(vocab=50, B=4, T=5),
                                       jax.random.PRNGKey(0))
    fused = _spy(monkeypatch, port_fd, "run_fused_decoder")
    loss, grads = _port_grads(16, 50, 4, 5, jparams)
    assert fused == [True], "the port's fused decoder did not engage"
    _assert_same(loss, grads, jloss, jgrads)


def test_nmt_gradients_match_the_jax_kernels(monkeypatch):
    """The JAX package's Pallas path: the GRU kernel for both encoder
    directions and the fused attention-GRU decoder, in interpret mode.
    dim 128 and B 8, because pallas_lstm.shape_ok sends H % 128 != 0 or
    B % 8 != 0 to the scan."""
    from paddle_tpu.graph import fused_decoder as jax_fd
    from paddle_tpu.ops import pallas_gru

    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    tc = jax_nmt_config(vocab=50, dim=128, batch_size=8)
    jm = JaxMachine(tc.model_config, pallas_rnn=True, pallas_decoder=True)
    jparams = jm.init_params(seed=5)
    gru_calls = _spy(monkeypatch, pallas_gru, "gru_layer_forward")
    dec_calls = _spy(monkeypatch, jax_fd, "run_fused_decoder")
    jloss, jgrads, _, _ = jm.grad_fn()(jparams, jax_nmt_batch(vocab=50, B=8, T=5),
                                       jax.random.PRNGKey(0))
    assert gru_calls == [True, True], "the JAX GRU kernel did not run both encoders"
    assert dec_calls == [True], "the JAX fused decoder kernel did not engage"
    fused = _spy(monkeypatch, port_fd, "run_fused_decoder")
    loss, grads = _port_grads(128, 50, 8, 5, jparams)
    assert fused == [True]
    _assert_same(loss, grads, jloss, jgrads)


def test_eval_pass_takes_the_loop_and_matches():
    """A test pass of the same graph: the decoder group runs the port's
    time loop (the fused decoder is a training path), with the cost
    layer's outputs equal to the JAX forward's."""
    tc = jax_nmt_config(vocab=50, dim=16, batch_size=4)
    jm = JaxMachine(tc.model_config)
    jparams = jm.init_params(seed=2)
    jout, _ = jm.forward(jparams, jax_nmt_batch(vocab=50, B=4, T=5, seed=3), "test")
    m = GradientMachine(nmt_config(vocab=50, dim=16, batch_size=4).model_config, device="cpu")
    out, _ = m.forward(params_from_numpy(_np(jparams), "cpu"),
                       nmt_batch(vocab=50, B=4, T=5, seed=3, device="cpu"), "test")
    name = m.cost_layer_names()[0]
    np.testing.assert_allclose(out[name].value.numpy(), np.asarray(jout[name].value),
                               rtol=1e-5, atol=1e-6)
    assert not out[name].value.requires_grad


def _plain_group_config(tch, fresh_context):
    """A recurrent group that is not the attention decoder (the JAX
    package's own non-matching case, tests/test_fused_decoder.py)."""
    with fresh_context() as ctx:
        tch.settings(batch_size=4, learning_rate=1e-3)
        x = tch.data_layer(name="x", size=8)

        def step(inp):
            mem = tch.memory(name="m", size=8)
            return tch.fc_layer(input=[inp, mem], size=8, act=tch.TanhActivation(),
                                name="m", bias_attr=False)

        r = tch.recurrent_group(name="rg", step=step, input=[x])
        last = tch.last_seq(input=r)
        lbl = tch.data_layer(name="y", size=2)
        fc = tch.fc_layer(input=last, size=2, act=tch.SoftmaxActivation())
        tch.outputs(tch.classification_cost(name="cost", input=fc, label=lbl))
        return ctx.finalize()


def test_non_matching_group_takes_the_loop(monkeypatch):
    import paddle_tpu.trainer_config_helpers as jax_tch
    import paddle_tpu_torch.trainer_config_helpers as port_tch
    from paddle_tpu.config.builder import fresh_context as jax_fresh
    from paddle_tpu.graph import make_dense, make_seq as jax_seq
    from paddle_tpu_torch.config.builder import fresh_context as port_fresh

    jm = JaxMachine(_plain_group_config(jax_tch, jax_fresh).model_config)
    jparams = jm.init_params(seed=1)
    rng = np.random.RandomState(0)
    x = rng.randn(4, 6, 8).astype(np.float32)
    lens = np.array([6, 5, 3, 6], np.int32)
    onehot = np.zeros((4, 2), np.float32)
    onehot[np.arange(4), rng.randint(0, 2, 4)] = 1.0
    jloss, jgrads, _, _ = jm.grad_fn()(
        jparams, {"x": jax_seq(x, lens), "y": make_dense(onehot)}, jax.random.PRNGKey(0))

    fused = _spy(monkeypatch, port_fd, "run_fused_decoder")
    m = GradientMachine(_plain_group_config(port_tch, port_fresh).model_config, device="cpu")
    loss, grads, _, _ = m.grad_fn()(
        params_from_numpy(_np(jparams), "cpu"),
        {"x": make_seq(x, lens, device="cpu"), "y": Argument(value=torch.from_numpy(onehot))})
    assert fused == []
    _assert_same(loss, grads, jloss, jgrads)


def _clipped_config(tch, fresh_context):
    """A small classifier whose hidden layer clips its backward signal."""
    with fresh_context() as ctx:
        tch.settings(batch_size=4, learning_rate=1e-3)
        x = tch.data_layer(name="x", size=6)
        h = tch.fc_layer(input=x, size=5, act=tch.TanhActivation(),
                         layer_attr=tch.ExtraAttr(error_clipping_threshold=0.02))
        out = tch.fc_layer(input=h, size=3, act=tch.SoftmaxActivation())
        lbl = tch.data_layer(name="y", size=3)
        tch.outputs(tch.classification_cost(input=out, label=lbl))
        return ctx.finalize()


def test_error_clipping_matches_jax():
    """ExtraAttr(error_clipping_threshold): identity forward, the layer's
    output gradient clipped to [-t, t] in the backward."""
    import paddle_tpu.trainer_config_helpers as jax_tch
    import paddle_tpu_torch.trainer_config_helpers as port_tch
    from paddle_tpu.config.builder import fresh_context as jax_fresh
    from paddle_tpu.graph import make_dense, make_ids
    from paddle_tpu_torch.config.builder import fresh_context as port_fresh

    jm = JaxMachine(_clipped_config(jax_tch, jax_fresh).model_config)
    jparams = jm.init_params(seed=3)
    rng = np.random.RandomState(1)
    x = (rng.randn(4, 6) * 3).astype(np.float32)
    y = rng.randint(0, 3, 4).astype(np.int32)
    jloss, jgrads, _, _ = jm.grad_fn()(jparams, {"x": make_dense(x), "y": make_ids(y)}, None)
    m = GradientMachine(_clipped_config(port_tch, port_fresh).model_config, device="cpu")
    batch = {"x": Argument(value=torch.from_numpy(x)), "y": Argument(ids=torch.from_numpy(y))}
    loss, grads, _, _ = m.grad_fn()(params_from_numpy(_np(jparams), "cpu"), batch)
    _assert_same(loss, grads, jloss, jgrads)
    unclipped = GradientMachine(_clipped_config(port_tch, port_fresh).model_config, device="cpu")
    for layer in unclipped.model.layers:
        layer.error_clipping_threshold = 0.0
    _, free, _, _ = unclipped.grad_fn()(params_from_numpy(_np(jparams), "cpu"), batch)
    assert any(not torch.allclose(grads[n], free[n]) for n in grads), "nothing was clipped"


def test_three_adam_steps_follow_the_jax_loss_curve():
    """K = 3 train_one_batch steps of the port's Trainer against the JAX
    grad_fn + Updater loop on the same parameters and batch: the loss
    curve within 1e-5 relative."""
    from paddle_tpu.optimizer import Updater as JaxUpdater
    from paddle_tpu_torch.trainer import Trainer

    tc = jax_nmt_config(vocab=50, dim=16, batch_size=4)
    jm = JaxMachine(tc.model_config)
    jparams = jm.init_params(seed=4)
    upd = JaxUpdater(tc.opt_config, tc.model_config)
    state = upd.init_state(jparams)
    jbatch = jax_nmt_batch(vocab=50, B=4, T=5, seed=7)
    grad_fn = jm.grad_fn()
    trainer = Trainer(nmt_config(vocab=50, dim=16, batch_size=4), device="cpu")
    trainer.params = params_from_numpy(_np(jparams), "cpu")
    trainer.opt_state = trainer.updater.init_state(trainer.params)
    batch = nmt_batch(vocab=50, B=4, T=5, seed=7, device="cpu")
    jcurve, curve = [], []
    for _ in range(3):
        loss, grads, _, _ = grad_fn(jparams, jbatch, None)
        jparams, state = upd(jparams, grads, state, 4)
        jcurve.append(float(loss))
        curve.append(float(trainer.train_one_batch(batch)))
    np.testing.assert_allclose(curve, jcurve, rtol=1e-5)
    assert curve[-1] < curve[0]
    assert trainer.opt_state.step == 3
    for name in sorted(jparams):
        np.testing.assert_allclose(trainer.params[name].numpy(), np.asarray(jparams[name]),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def test_train_logs_avg_cost_and_saves_each_pass(tmp_path, caplog):
    """The pass loop over a provider of 4 batches (a stand-in for the
    config's, which test_torch_cli.py drives through files): a log line
    every 2 batches and one at each pass end, a save each pass."""
    from paddle_tpu_torch.trainer import Trainer
    from paddle_tpu_torch.utils.flags import _Flags

    trainer = Trainer(nmt_config(vocab=30, dim=8, batch_size=2),
                      _Flags(save_dir=str(tmp_path), log_period=2, dot_period=0), device="cpu")
    batches = [nmt_batch(vocab=30, B=2, T=4, seed=s, device="cpu") for s in range(4)]

    class Listed:
        def batches(self):
            return iter(batches)

    trainer._provider = lambda for_test, ordered=None: None if for_test else Listed()
    import logging

    logger = logging.getLogger("paddle_tpu")
    logger.addHandler(caplog.handler)
    try:
        trainer.train(2)
    finally:
        logger.removeHandler(caplog.handler)
    done = [r.getMessage() for r in caplog.records if " done: " in r.getMessage()]
    costs = [float(m.split("AvgCost=")[1].split()[0]) for m in done]
    assert len(costs) == 2 and all(np.isfinite(costs))
    assert sum("AvgCost" in r.getMessage() for r in caplog.records) == 2 * 2 + 2
    # and, with no --metrics_path, the save_dir doubles as the run dir of
    # the telemetry records, as in the JAX package
    assert sorted(p.name for p in tmp_path.iterdir()) == ["metrics.jsonl", "pass-00000",
                                                         "pass-00001"]
    assert trainer.opt_state.step == 8


# ---------------------------------------------------------------- dropout


def _dropout_out(drop_rate, pass_type, seed, shape=(400, 500), name="d"):
    from paddle_tpu_torch.layers.base import LayerContext, finalize_output
    from paddle_tpu_torch.proto import LayerConfig, ModelConfig

    cfg = LayerConfig(name=name, type="fc", size=shape[-1], drop_rate=drop_rate)
    ctx = LayerContext(params={}, model=ModelConfig(), pass_type=pass_type, seed=seed)
    return finalize_output(cfg, torch.ones(shape), ctx)


def test_dropout_keeps_one_minus_p_from_an_explicit_generator():
    """Dropout draws from the layer's own generator, seeded from the
    pass's seed and the layer's name (LayerContext.layer_generator)."""
    p = 0.3
    out = _dropout_out(p, "train", 7)
    kept = out != 0
    # 200,000 Bernoulli(0.7) draws: the kept share is within 0.005 of 0.7
    # (more than 7 standard deviations)
    assert abs(float(kept.float().mean()) - (1 - p)) < 5e-3
    np.testing.assert_allclose(out[kept].numpy(), 1.0 / (1 - p), rtol=1e-6)
    # inverted dropout keeps the expectation
    assert abs(float(out.mean()) - 1.0) < 1e-2
    same = _dropout_out(p, "train", 7)
    assert torch.equal(same, out)
    other = _dropout_out(p, "train", 8)
    assert not torch.equal(other, out)
    # another layer of the same pass draws other bits
    assert not torch.equal(_dropout_out(p, "train", 7, name="e"), out)
    # no dropout outside training
    assert torch.equal(_dropout_out(p, "test", None), torch.ones(400, 500))
    with pytest.raises(ValueError, match="no seed"):
        _dropout_out(p, "train", None)


# --------------------------------------------------------------- bf16 compute


def test_nmt_bf16_step_matches_the_jax_kernels(monkeypatch):
    """The whole NMT step in bf16 mixed precision at dim 16: the port on the
    CPU (its bf16 plain versions, as autograd Functions) against the JAX
    GradientMachine(compute_dtype=bf16, pallas_rnn=True, pallas_decoder=True)
    with the Pallas kernels in interpret mode. The loss within rtol 5e-3 /
    atol 1e-3 and each gradient, over its max |.|, within atol 0.05: the
    JAX package's own bound for its bf16 decoder kernel against its scan
    (tests/test_fused_decoder.py::test_machine_parity_seqtoseq_bf16). The
    master gradients are float32 on both sides."""
    import jax.numpy as jnp

    from paddle_tpu.graph import fused_decoder as jax_fd

    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    tc = jax_nmt_config(vocab=50, dim=16, batch_size=4, dtype="bfloat16")
    jm = JaxMachine(tc.model_config, compute_dtype=jnp.bfloat16, pallas_rnn=True,
                    pallas_decoder=True)
    jparams = jm.init_params(seed=11)
    dec_calls = _spy(monkeypatch, jax_fd, "run_fused_decoder")
    jloss, jgrads, _, _ = jm.grad_fn()(jparams, jax_nmt_batch(vocab=50, B=4, T=5),
                                       jax.random.PRNGKey(0))
    assert dec_calls == [True], "the JAX fused decoder kernel did not engage"
    fused = _spy(monkeypatch, port_fd, "run_fused_decoder")
    machine = GradientMachine(nmt_config(vocab=50, dim=16, batch_size=4,
                                         dtype="bfloat16").model_config,
                              device="cpu", compute_dtype="bfloat16")
    loss, grads, outs, _ = machine.grad_fn()(params_from_numpy(_np(jparams), "cpu"),
                                             nmt_batch(vocab=50, B=4, T=5, device="cpu"))
    assert fused == [True]
    assert outs["__embedding_0__"].value.dtype == torch.bfloat16
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), float(jloss), rtol=5e-3, atol=1e-3)
    assert sorted(grads) == sorted(jgrads)
    for name in sorted(jgrads):
        assert grads[name].dtype == torch.float32, name
        b = np.asarray(jgrads[name], np.float32)
        scale = max(1e-3, float(np.abs(b).max()))
        np.testing.assert_allclose(grads[name].numpy() / scale, b / scale, rtol=0.0,
                                   atol=0.05, err_msg=name)
