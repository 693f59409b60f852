"""The port's LSTM text classifier against the JAX package, on the CPU.

``flagship_config`` (embedding, ``simple_lstm``, max pooling over time, a
softmax fc and ``classification_cost``), built by both packages' DSLs,
gets the same parameters (the JAX package's ``init_params``, carried over
with ``bridge``) and the same batches (``example_batch``, the same numpy
draws). The port runs the LSTM kernels' plain version here; its loss and
every parameter gradient must match the JAX ``grad_fn`` on the JAX scan
path and on its Pallas kernels in interpret mode, at rtol 5e-4 / atol 5e-5
(tests/test_pallas_lstm.py's bound between those two JAX paths). Spies
prove which path each side took.
"""

import numpy as np
import torch

import paddle_tpu.graph  # noqa: F401  (break the layers<->graph import cycle)
from paddle_tpu.flagship import example_batch as jax_example_batch
from paddle_tpu.flagship import flagship_config as jax_flagship_config
from paddle_tpu.graph import GradientMachine as JaxMachine
from paddle_tpu_torch.bridge import params_from_numpy
from paddle_tpu_torch.flagship import example_batch, flagship_config
from paddle_tpu_torch.graph import Argument, GradientMachine
from paddle_tpu_torch.layers import recurrent as port_recurrent
from paddle_tpu_torch.trainer import Trainer
from paddle_tpu_torch.utils.flags import _Flags

torch.set_num_threads(1)
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)
SMALL = dict(dict_dim=50, emb_dim=8, hidden=16, classes=2)


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _spy(monkeypatch, module, name):
    calls = []
    orig = getattr(module, name)

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(module, name, spy)
    return calls


def _port_grads(widths, jparams, B, T, seed=0):
    m = GradientMachine(flagship_config(**widths).model_config, device="cpu")
    batch = example_batch(widths["dict_dim"], B=B, T=T, seed=seed, device="cpu")
    loss, grads, _, _ = m.grad_fn()(params_from_numpy(_np(jparams), "cpu"), batch)
    return loss, grads


def _assert_same(loss, grads, jloss, jgrads):
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5, atol=1e-6)
    assert sorted(grads) == sorted(jgrads)
    for name in sorted(jgrads):
        np.testing.assert_allclose(grads[name].numpy(), np.asarray(jgrads[name]),
                                   err_msg=name, **GRAD_TOL)


def test_the_full_width_config_matches_the_jax_package():
    """The shape bench.py trains: the same layers and parameters, 4.14 M of them."""
    widths = dict(dict_dim=10000, emb_dim=256, hidden=512, classes=2)
    ours, theirs = flagship_config(**widths).model_config, jax_flagship_config(**widths).model_config
    assert [(l.name, l.type, l.size) for l in ours.layers] == \
        [(l.name, l.type, l.size) for l in theirs.layers]
    assert [(p.name, list(p.dims)) for p in ours.parameters] == \
        [(p.name, list(p.dims)) for p in theirs.parameters]
    n = sum(int(np.prod(p.dims)) for p in ours.parameters)
    assert n == 10000 * 256 + 256 * 2048 + 512 * 2048 + 7 * 512 + 512 * 2 + 2 == 4137474
    assert [e.type for e in ours.evaluators] == ["classification_error"]


def test_gradients_match_the_jax_scan(monkeypatch):
    """The JAX package's default path (lax.scan, no kernels)."""
    jm = JaxMachine(jax_flagship_config(**SMALL).model_config)
    jparams = jm.init_params(seed=3)
    jloss, jgrads, _, _ = jm.grad_fn()(jparams, jax_example_batch(50, B=4, T=6), None)
    calls = _spy(monkeypatch, port_recurrent, "fused_lstm")
    loss, grads = _port_grads(SMALL, jparams, B=4, T=6)
    assert calls == [1]
    _assert_same(loss, grads, jloss, jgrads)


def test_gradients_match_the_jax_kernels(monkeypatch):
    """The JAX package's Pallas LSTM kernels in interpret mode, at hidden
    128 and B 16 (``pallas_lstm.shape_ok`` sends H % 128 != 0 or B % 8 != 0
    to the scan), as tests/test_pallas_lstm.py runs them."""
    from paddle_tpu.ops import pallas_lstm

    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    widths = dict(dict_dim=200, emb_dim=32, hidden=128, classes=2)
    jm = JaxMachine(jax_flagship_config(**widths).model_config, pallas_rnn=True)
    jparams = jm.init_params(seed=3)
    jcalls = _spy(monkeypatch, pallas_lstm, "lstm_layer_forward")
    jloss, jgrads, _, _ = jm.grad_fn()(jparams, jax_example_batch(200, B=16, T=12), None)
    assert jcalls, "the JAX LSTM kernel did not engage"
    calls = _spy(monkeypatch, port_recurrent, "fused_lstm")
    loss, grads = _port_grads(widths, jparams, B=16, T=12)
    assert calls == [1]
    _assert_same(loss, grads, jloss, jgrads)


def test_three_adam_steps_follow_the_jax_loss_curve():
    from paddle_tpu.optimizer import Updater as JaxUpdater

    tc = jax_flagship_config(**SMALL)
    jm = JaxMachine(tc.model_config)
    jparams = jm.init_params(seed=4)
    upd = JaxUpdater(tc.opt_config, tc.model_config)
    state = upd.init_state(jparams)
    jbatch = jax_example_batch(50, B=4, T=6, seed=7)
    grad_fn = jm.grad_fn()
    trainer = Trainer(flagship_config(**SMALL), device="cpu")
    trainer.params = params_from_numpy(_np(jparams), "cpu")
    trainer.opt_state = trainer.updater.init_state(trainer.params)
    batch = example_batch(50, B=4, T=6, seed=7, device="cpu")
    jcurve, curve = [], []
    for _ in range(3):
        loss, grads, _, _ = grad_fn(jparams, jbatch, None)
        jparams, state = upd(jparams, grads, state, 4)
        jcurve.append(float(loss))
        curve.append(float(trainer.train_one_batch(batch)))
    np.testing.assert_allclose(curve, jcurve, rtol=1e-5)
    assert curve[-1] < curve[0]
    for name in sorted(jparams):
        np.testing.assert_allclose(trainer.params[name].numpy(), np.asarray(jparams[name]),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def test_test_pass_matches_the_jax_evaluators():
    """``Trainer.test`` against the JAX forward's outputs fed to the JAX
    ``EvaluatorChain``, over three batches: the mean per-sample cost and
    classification_error."""
    from paddle_tpu.trainer.evaluators import EvaluatorChain as JaxChain

    tc = jax_flagship_config(**SMALL)
    jm = JaxMachine(tc.model_config)
    jparams = jm.init_params(seed=5)
    chain = JaxChain(tc.model_config)
    chain.start()
    total, n = 0.0, 0
    for seed in range(3):
        outputs, _ = jm.forward(jparams, jax_example_batch(50, B=8, T=6, seed=seed), "test")
        total += float(jm.total_cost(outputs)) * 8
        n += 8
        chain.eval_batch(outputs)
    want = {"cost": total / n, **chain.results()}

    trainer = Trainer(flagship_config(**SMALL), device="cpu")
    trainer.params = params_from_numpy(_np(jparams), "cpu")
    got = trainer.test_batches([example_batch(50, B=8, T=6, seed=s, device="cpu") for s in range(3)])
    assert sorted(got) == sorted(want) == ["__cost_0__.classification_error.classification_error",
                                           "cost"]
    np.testing.assert_allclose(got["cost"], want["cost"], rtol=1e-5)
    key = "__cost_0__.classification_error.classification_error"
    assert got[key] == want[key]


def test_the_test_pass_runs_without_gradients(monkeypatch):
    """A test pass runs the forward under no_grad: the LSTM sees no input
    that requires a gradient, which on the card selects the light kernel."""
    seen = []
    orig = port_recurrent.fused_lstm

    def spy(x4, mask, w, peep, **kw):
        seen.append(torch.is_grad_enabled() and (x4.requires_grad or w.requires_grad))
        return orig(x4, mask, w, peep, **kw)

    monkeypatch.setattr(port_recurrent, "fused_lstm", spy)
    trainer = Trainer(flagship_config(**SMALL), device="cpu")
    trainer.test_batches([example_batch(50, B=4, T=6, seed=s, device="cpu") for s in range(2)])
    assert seen == [False, False]
    trainer.train_one_batch(example_batch(50, B=4, T=6, device="cpu"))
    assert seen == [False, False, True]


def _max_cfg():
    from paddle_tpu_torch.proto import LayerConfig

    return LayerConfig(name="pool", type="max", size=3)


def test_max_pooling_ties_and_empty_sequence_match_jax():
    """The max layer: an empty sequence gives 0 and no gradient; tied
    maxima split the gradient evenly, as jnp.max does."""
    from paddle_tpu.graph.argument import Argument as JaxArgument
    from paddle_tpu.layers.sequence import _pool
    from paddle_tpu.proto import LayerConfig as JaxLayerConfig
    from paddle_tpu_torch.layers.base import LayerContext
    from paddle_tpu_torch.layers.sequence import max_layer
    from paddle_tpu_torch.proto import ModelConfig
    import jax
    import jax.numpy as jnp

    x = np.array([[[1.0, 2.0, 5.0], [3.0, 2.0, 5.0], [3.0, -1.0, 0.0], [9.0, 9.0, 9.0]],
                  [[-4.0, -2.0, -7.0], [-4.0, -3.0, -7.0], [0.0, 0.0, 0.0], [0.0, 0.0, 0.0]],
                  [[8.0, 8.0, 8.0], [8.0, 8.0, 8.0], [8.0, 8.0, 8.0], [8.0, 8.0, 8.0]]],
                 np.float32)
    lens = np.array([3, 2, 0], np.int32)              # padding holds larger values
    cot = np.random.RandomState(0).randn(3, 3).astype(np.float32)

    def jloss(v):
        out = _pool(JaxLayerConfig(name="pool", type="max", size=3),
                    JaxArgument(value=v, seq_lengths=jnp.asarray(lens)), "max").value
        return jnp.sum(out * cot), out

    (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    ctx = LayerContext(params={}, model=ModelConfig(), pass_type="train")
    out = max_layer(_max_cfg(), [Argument(value=xt, seq_lengths=torch.from_numpy(lens))], ctx).value
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(out.detach().numpy()[2], 0.0)   # the empty sequence
    assert not xt.grad.numpy()[2].any() and not xt.grad.numpy()[:, 3].any()
    # row 0, column 0: 3.0 at steps 1 and 2 ties, each gets half
    np.testing.assert_allclose(xt.grad.numpy()[0, 1:3, 0], cot[0, 0] / 2, rtol=1e-6)


def test_max_pooling_refuses_what_is_not_ported():
    """Once refused, a nested input now pools: output_max_index gives each
    feature's step of its maximum over the valid steps, and max over a
    nested input at both trans_type levels (ties, an empty sub-sequence)
    gives the JAX layer's values and gradients."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.graph.argument import Argument as JaxArgument
    from paddle_tpu.layers.sequence import max_layer as jax_max_layer
    from paddle_tpu.proto import LayerConfig as JaxLayerConfig
    from paddle_tpu_torch.layers.base import LayerContext
    from paddle_tpu_torch.layers.sequence import max_layer
    from paddle_tpu_torch.proto import ModelConfig

    ctx = LayerContext(params={}, model=ModelConfig())
    x = torch.tensor([[[0., 5.], [2., 1.], [1., 9.]], [[3., 0.], [7., 8.], [9., 9.]]])
    a = Argument(value=x, seq_lengths=torch.tensor([3, 1], dtype=torch.int32))
    cfg = _max_cfg()
    cfg.output_max_index = True
    assert max_layer(cfg, [a], ctx).ids.tolist() == [[1, 2], [0, 0]]
    xn = np.random.RandomState(4).randint(-2, 3, (2, 3, 4, 3)).astype(np.float32)
    n_subs, sub_lens = np.array([3, 2], np.int32), np.array([[4, 2, 1], [3, 0, 0]], np.int32)
    cot = np.random.RandomState(5).randn(2, 3, 3).astype(np.float32)
    for level in ("seq", "non-seq"):
        jcfg = JaxLayerConfig(name="pool", type="max", size=3, trans_type=level)
        c = cot if level == "seq" else cot[:, 0]

        def jloss(v):
            out = jax_max_layer(jcfg, [JaxArgument(value=v, seq_lengths=jnp.asarray(n_subs),
                                                   sub_seq_lengths=jnp.asarray(sub_lens))],
                                None).value
            return jnp.sum(out * c), out

        (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(xn))
        xt = torch.from_numpy(xn).requires_grad_()
        pcfg = _max_cfg()
        pcfg.trans_type = level
        out = max_layer(pcfg, [Argument(value=xt, seq_lengths=torch.from_numpy(n_subs),
                                        sub_seq_lengths=torch.from_numpy(sub_lens))], ctx)
        (out.value * torch.from_numpy(c)).sum().backward()
        np.testing.assert_array_equal(out.value.detach().numpy(), np.asarray(jout))
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad), rtol=1e-6, atol=1e-7)
        assert (out.seq_lengths is not None) == (level == "seq")


def test_checkpoint_round_trip(tmp_path):
    """pass-00000 saved after two steps and restored into a fresh Trainer:
    parameters and Adam slots equal, and the same test results."""
    trainer = Trainer(flagship_config(**SMALL), _Flags(save_dir=str(tmp_path)), device="cpu")
    batch = example_batch(50, B=4, T=6, seed=1, device="cpu")
    for _ in range(2):
        trainer.train_one_batch(batch)
    path = trainer.save(0)
    assert path.endswith("pass-00000")
    fresh = Trainer(flagship_config(**SMALL), _Flags(seed=2), device="cpu")
    fresh.restore(path)
    assert fresh.opt_state.step == trainer.opt_state.step == 2
    for name, p in trainer.params.items():
        assert torch.equal(fresh.params[name], p), name
        for slot, v in trainer.opt_state.slots[name].items():
            assert torch.equal(fresh.opt_state.slots[name][slot], v), (name, slot)
    assert fresh.test_batches([batch]) == trainer.test_batches([batch])
