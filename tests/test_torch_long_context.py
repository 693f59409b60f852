"""The port's long-context causal LM and its multi-head attention layer
against the JAX package, on the CPU.

``long_context_config`` is held to the JAX package's parse of
``demo/long_context/trainer_config.py`` with the same config args. The LM
(the demo's defaults: dim 64, 4 heads, 2 blocks, vocab 500, T = 256) gets
the JAX package's parameters (``init_params``, carried over with
``bridge``) and the same ragged planted-bigram batch; its loss must match
the JAX ``GradientMachine`` to 1e-5 relative and every gradient to 1e-4 of
max(1, max |JAX|) (sums over B * T = 768 positions in another order). On
the CPU the layer takes ``full_attention``'s plain path, the JAX package's
XLA branch; the card's route, the flash function, is checked here too
through its plain versions, which differ from the plain path only at
padded query rows, which the layer masks.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.graph  # noqa: F401  (break the layers<->graph import cycle)
from paddle_tpu.config.config_parser import parse_config_at
from paddle_tpu.graph import GradientMachine as JaxMachine
from paddle_tpu.graph.argument import make_ids as jax_make_ids
from paddle_tpu.graph.argument import make_seq as jax_make_seq
from paddle_tpu_torch.bridge import params_from_numpy
from paddle_tpu_torch.flagship import lm_batch, long_context_config
from paddle_tpu_torch.graph import GradientMachine, make_ids, make_seq
from paddle_tpu_torch.layers import attention as port_attention
from paddle_tpu_torch.ops.flash_attention import flash_attention
from paddle_tpu_torch.parallel import sequence_parallel as sp
from paddle_tpu_torch.trainer import Trainer

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(REPO, "demo", "long_context", "trainer_config.py")
T = 256
LENGTHS = np.array([T, T - 77, 1], np.int32)
ERR_KEY = "__cost_0__.classification_error.classification_error"


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _jax_config(**args):
    return parse_config_at(DEMO, ",".join(f"{k}={v}" for k, v in args.items()))


def _batches(seed, B=3, lengths=LENGTHS):
    """One ragged lm_batch for both packages: the same ids, lengths cut."""
    full = lm_batch(500, B=B, T=T, seed=seed, device="cpu")
    words, nxt = (full[n].ids.numpy() for n in ("words", "next_words"))
    jax_batch = {"words": jax_make_seq(None, lengths, ids=words),
                 "next_words": jax_make_seq(None, lengths, ids=nxt)}
    batch = {"words": make_seq(None, lengths, ids=words, device="cpu"),
             "next_words": make_seq(None, lengths, ids=nxt, device="cpu")}
    return jax_batch, batch


def _close_to_scale(got, want, tol, what):
    want = np.asarray(want)
    err = float(np.abs(got.detach().numpy() - want).max()) / max(1.0, float(np.abs(want).max()))
    assert err <= tol, (what, err)


def _assert_same(loss, grads, jloss, jgrads):
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert sorted(grads) == sorted(jgrads)
    for name in sorted(jgrads):
        _close_to_scale(grads[name], jgrads[name], 1e-4, name)


@pytest.mark.parametrize("args", [
    {}, dict(vocab=500, seq_len=2048, dim=512, heads=8, blocks=2, batch_size=8),
    dict(dim=16, heads=2, blocks=1, dtype="bfloat16")])
def test_config_matches_the_demo(args):
    """The demo's defaults and the chip's shape: the same layers, parameter
    names and dims, evaluators and optimizer settings."""
    ours, theirs = long_context_config(**args), _jax_config(**args)
    for field in ("layers", "parameters", "evaluators", "input_layer_names",
                  "output_layer_names"):
        assert repr(getattr(ours.model_config, field)) == \
            repr(getattr(theirs.model_config, field)), field
    assert repr(ours.opt_config) == repr(theirs.opt_config)
    if "seq_len" in args:
        params = ours.model_config.parameters
        assert len(params) == 15
        assert sum(int(np.prod(p.dims)) for p in params) == 6809076


def test_lm_batch_is_the_planted_bigram_language():
    a = lm_batch(500, B=4, T=64, seed=3, device="cpu")
    b = lm_batch(500, B=4, T=64, seed=3, device="cpu")
    c = lm_batch(500, B=4, T=64, seed=4, device="cpu")
    for name in ("words", "next_words"):
        assert torch.equal(a[name].ids, b[name].ids)
        assert a[name].ids.dtype == torch.int32 and a[name].ids.shape == (4, 64)
        assert a[name].seq_lengths.tolist() == [64] * 4
    assert not torch.equal(a["words"].ids, c["words"].ids)
    w, n = a["words"].ids.long(), a["next_words"].ids.long()
    assert torch.equal(w[:, 1:], n[:, :-1])              # next_words is words shifted
    assert (((n - (w * 7) % 500) % 500) < 8).all()        # in the planted 8-token window
    assert int(w.min()) >= 0 and int(n.max()) < 500


@pytest.mark.parametrize("route", ["plain", "flash"])
def test_loss_and_gradients_match_the_jax_machine(monkeypatch, route):
    """Ragged lengths [256, 179, 1]. ``plain``: the CPU's own route through
    ``full_attention``; ``flash``: the card's route, the flash function
    (its plain versions here) in place of ``full_attention``."""
    jtc = _jax_config()
    jm = JaxMachine(jtc.model_config)
    jparams = jm.init_params(seed=3)
    jbatch, batch = _batches(seed=1)
    jloss, jgrads, _, _ = jm.grad_fn()(jparams, jbatch, None)
    calls = []
    if route == "flash":
        def full_attention(q, k, v, lengths=None, causal=False):
            calls.append(q.shape)
            return flash_attention(q, k, v, lengths=lengths, causal=causal)
        monkeypatch.setattr(port_attention, "full_attention", full_attention)
    else:
        monkeypatch.setattr(sp, "flash_attention", lambda *a, **kw: calls.append(1))
    m = GradientMachine(long_context_config().model_config, device="cpu")
    loss, grads, _, _ = m.grad_fn()(params_from_numpy(_np(jparams), "cpu"), batch)
    assert calls == ([(3, T, 4, 16)] * 2 if route == "flash" else [])
    _assert_same(loss, grads, jloss, jgrads)


def test_three_adam_steps_follow_the_jax_loss_curve():
    """The loss after each of 3 Adam steps, to 1e-5 relative. Parameters are
    not compared elementwise: where a gradient is rounding noise (~1e-8, as
    for lm_head columns of tokens the batch never predicts) Adam's m/sqrt(v)
    still moves the element by about lr, in a direction set by the noise."""
    from paddle_tpu.optimizer import Updater as JaxUpdater

    jtc = _jax_config()
    jm = JaxMachine(jtc.model_config)
    jparams = jm.init_params(seed=4)
    upd = JaxUpdater(jtc.opt_config, jtc.model_config)
    state = upd.init_state(jparams)
    jbatch, batch = _batches(seed=7)
    grad_fn = jm.grad_fn()
    trainer = Trainer(long_context_config(), device="cpu")
    trainer.params = params_from_numpy(_np(jparams), "cpu")
    trainer.opt_state = trainer.updater.init_state(trainer.params)
    jcurve, curve = [], []
    for _ in range(3):
        loss, grads, _, _ = grad_fn(jparams, jbatch, None)
        jparams, state = upd(jparams, grads, state, 3)
        jcurve.append(float(loss))
        curve.append(float(trainer.train_one_batch(batch)))
    np.testing.assert_allclose(curve, jcurve, rtol=1e-5)
    assert curve[-1] < curve[0]


def test_test_pass_matches_the_jax_evaluators(monkeypatch):
    """``Trainer.test`` over two ragged batches against the JAX forward's
    outputs fed to the JAX ``EvaluatorChain``: the mean per-sample cost and
    classification_error; the forward runs without gradients."""
    from paddle_tpu.trainer.evaluators import EvaluatorChain as JaxChain

    jtc = _jax_config()
    jm = JaxMachine(jtc.model_config)
    jparams = jm.init_params(seed=5)
    chain = JaxChain(jtc.model_config)
    chain.start()
    total = 0.0
    pairs = [_batches(seed=s) for s in (11, 12)]
    for jbatch, _ in pairs:
        outputs, _ = jm.forward(jparams, jbatch, "test")
        total += float(jm.total_cost(outputs)) * 3
        chain.eval_batch(outputs)
    want = {"cost": total / 6, **chain.results()}

    grad_mode = []
    orig = port_attention.full_attention

    def spy(q, *a, **kw):
        grad_mode.append(torch.is_grad_enabled() and q.requires_grad)
        return orig(q, *a, **kw)

    monkeypatch.setattr(port_attention, "full_attention", spy)
    trainer = Trainer(long_context_config(), device="cpu")
    trainer.params = params_from_numpy(_np(jparams), "cpu")
    got = trainer.test_batches([batch for _, batch in pairs])
    assert grad_mode == [False] * 4
    assert sorted(got) == sorted(want) == [ERR_KEY, "cost"]
    np.testing.assert_allclose(got["cost"], want["cost"], rtol=1e-5)
    assert got[ERR_KEY] == want[ERR_KEY]


def _attention_net(helpers, causal):
    """tests/test_attention_layer.py's net in either package's DSL."""
    h = helpers
    with h["fresh_context"]() as ctx:
        h["settings"](batch_size=8, learning_rate=1e-2)
        words = h["data_layer"](name="words", size=50)
        e = h["embedding_layer"](input=words, size=16)
        att = h["multi_head_attention_layer"](input=e, num_heads=4, causal=causal, name="att")
        pool = h["pooling_layer"](input=att, pooling_type=h["MaxPooling"]())
        out = h["fc_layer"](input=pool, size=2, act=h["SoftmaxActivation"](), name="out")
        label = h["data_layer"](name="label", size=2)
        h["outputs"](h["classification_cost"](input=out, label=label))
        return ctx.finalize()


def _helpers(pkg):
    import importlib

    tch = importlib.import_module(f"{pkg}.trainer_config_helpers")
    names = ("settings", "data_layer", "embedding_layer", "multi_head_attention_layer",
             "pooling_layer", "MaxPooling", "fc_layer", "SoftmaxActivation", "outputs",
             "classification_cost")
    h = {n: getattr(tch, n) for n in names}
    h["fresh_context"] = importlib.import_module(f"{pkg}.config.builder").fresh_context
    return h


@pytest.mark.parametrize("causal", [False, True])
def test_attention_layer_matches_the_jax_layer(causal):
    """The layer's output (padded positions zero) and every gradient, with
    the ragged batch of tests/test_attention_layer.py (B 8, T 16)."""
    jcfg = _attention_net(_helpers("paddle_tpu"), causal)
    cfg = _attention_net(_helpers("paddle_tpu_torch"), causal)
    assert repr(cfg.model_config.layers) == repr(jcfg.model_config.layers)
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 50, (8, 16)).astype(np.int32)
    lengths = rng.randint(8, 17, (8,)).astype(np.int32)
    labels = rng.randint(0, 2, (8,)).astype(np.int32)
    jbatch = {"words": jax_make_seq(None, lengths, ids=ids), "label": jax_make_ids(labels)}
    batch = {"words": make_seq(None, lengths, ids=ids, device="cpu"),
             "label": make_ids(labels, device="cpu")}
    jm = JaxMachine(jcfg.model_config)
    jparams = jm.init_params(seed=3)
    jloss, jgrads, jouts, _ = jm.grad_fn()(jparams, jbatch, None)
    m = GradientMachine(cfg.model_config, device="cpu")
    loss, grads, outs, _ = m.grad_fn()(params_from_numpy(_np(jparams), "cpu"), batch)
    att = outs["att"].value.detach().numpy()
    np.testing.assert_allclose(att, np.asarray(jouts["att"].value), atol=2e-5, rtol=0)
    pad = np.arange(16)[None, :] >= lengths[:, None]
    assert not att[pad].any()
    _assert_same(loss, grads, jloss, jgrads)
    assert float(jnp.abs(jgrads["_att.wqkv"]).max()) > 0


def test_bf16_adam_steps_follow_the_jax_bf16_loss_curve():
    """``dtype="bfloat16"`` at a tiny width (one block, dim 16, 2 heads,
    T = 32): 3 Adam steps of the port (bf16 activations, float32 master
    state; on the CPU the attention takes the repaired eager path) against
    the JAX package's bf16 machine from the same parameters, within the
    JAX package's bf16 bound (rtol 0.05 / atol 0.02, tests/test_bf16.py)."""
    import jax

    from paddle_tpu.optimizer import Updater as JaxUpdater

    widths = dict(dim=16, heads=2, blocks=1, dtype="bfloat16")
    jtc = _jax_config(**widths)
    assert jtc.opt_config.dtype == "bfloat16"
    jm = JaxMachine(jtc.model_config, compute_dtype=jnp.bfloat16)
    jparams = jm.init_params(seed=6)
    upd = JaxUpdater(jtc.opt_config, jtc.model_config)
    state = upd.init_state(jparams)
    full = lm_batch(500, B=4, T=32, seed=8, device="cpu")
    words, nxt = (full[n].ids.numpy() for n in ("words", "next_words"))
    lens = np.full(4, 32, np.int32)
    jbatch = {"words": jax_make_seq(None, lens, ids=words),
              "next_words": jax_make_seq(None, lens, ids=nxt)}
    trainer = Trainer(long_context_config(**widths), device="cpu")
    assert trainer.gm.compute_dtype == torch.bfloat16
    trainer.params = params_from_numpy(_np(jparams), "cpu")
    trainer.opt_state = trainer.updater.init_state(trainer.params)
    grad_fn = jax.jit(jm.grad_fn())
    jcurve, curve = [], []
    for _ in range(3):
        loss, grads, _, _ = grad_fn(jparams, jbatch, None)
        jparams, state = upd(jparams, grads, state, 4.0)
        jcurve.append(float(loss))
        curve.append(float(trainer.train_one_batch(full)))
    np.testing.assert_allclose(curve, jcurve, rtol=0.05, atol=0.02)
    assert curve[-1] < curve[0]
    assert all(p.dtype == torch.float32 for p in trainer.params.values())
