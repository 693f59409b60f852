"""OptimizationConfig.remat in the port against the JAX package, on the CPU.

``remat="full"`` runs the loss under ``torch.utils.checkpoint`` (the JAX
package's ``jax.checkpoint``): the backward recomputes the forward. The
recompute must give the same forward, so the gradients equal those of
``remat="none"`` (1e-6 of scale: the same operations on the same values),
with dropout on too, since each layer's dropout seeds a generator of its
own from the step's seed and draws its mask again. Against the JAX
package's ``grad_fn(remat="full")`` on its Pallas kernels in interpret
mode (tests/test_pallas_lstm.py::test_remat_composes_with_kernel), the
port is held to its float32 parity bound with the JAX package
(tests/test_torch_lstm_classifier.py: loss rtol 1e-5 / atol 1e-6,
gradients rtol 5e-4 / atol 5e-5), with dropout off: torch cannot draw
jax's bits. Any other mode raises in both packages, and in the port's
Trainer.
"""

import jax
import numpy as np
import pytest
import torch

import paddle_tpu.graph  # noqa: F401  (break the layers<->graph import cycle)
from paddle_tpu.flagship import example_batch as jax_example_batch
from paddle_tpu.flagship import flagship_config as jax_flagship_config
from paddle_tpu.graph import GradientMachine as JaxMachine
from paddle_tpu_torch.bridge import params_from_numpy
from paddle_tpu_torch.flagship import example_batch, flagship_config
from paddle_tpu_torch.graph import GradientMachine
from paddle_tpu_torch.ops import fused_lstm as fl
from paddle_tpu_torch.optimizer.sparse import RowSparseGrad
from paddle_tpu_torch.trainer import Trainer
from test_torch_bf16 import _sparse_config

torch.set_num_threads(1)
SMALL = dict(dict_dim=50, emb_dim=8, hidden=16, classes=2)
SAME = 1e-6                     # of scale: one forward recomputed, not another one


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _dense(g):
    return g.to_dense() if isinstance(g, RowSparseGrad) else g


def _assert_equal_steps(a, b):
    """(loss, grads) of two grad functions on the same step agree to SAME."""
    (la, ga), (lb, gb) = a, b
    np.testing.assert_allclose(float(la), float(lb), rtol=SAME)
    assert sorted(ga) == sorted(gb)
    for n in ga:
        x, y = _dense(ga[n]), _dense(gb[n])
        scale = max(float(y.abs().max()), 1e-30)
        assert float((x - y).abs().max()) <= SAME * scale, (n, float((x - y).abs().max()), scale)


def test_unknown_remat_modes_raise_in_both_packages():
    """grad_fn refuses a misspelt mode in both packages, with the same
    words, and so does the port's Trainer, which reads the config's."""
    with pytest.raises(ValueError, match="unsupported remat mode 'bogus'"):
        JaxMachine(jax_flagship_config(**SMALL).model_config).grad_fn(remat="bogus")
    gm = GradientMachine(flagship_config(**SMALL).model_config, device="cpu")
    with pytest.raises(ValueError, match="unsupported remat mode 'bogus'"):
        gm.grad_fn(remat="bogus")
    for mode in ("", "none", "full"):
        gm.grad_fn(remat=mode)
    tc = flagship_config(**SMALL)
    tc.opt_config.remat = "bogus"
    with pytest.raises(ValueError, match="unsupported remat mode 'bogus'"):
        Trainer(tc, device="cpu")


def test_full_remat_recomputes_the_same_forward_with_dropout(monkeypatch):
    """The small classifier with dropout on the LSTM's input projection
    (lstm_transform, the layer simple_lstm puts before it): remat="full"
    runs the LSTM twice a step (the forward and its recompute), and its
    loss and gradients equal remat="none"'s; the mask is drawn (another
    seed gives another loss)."""
    tc = flagship_config(**SMALL)
    next(l for l in tc.model_config.layers if l.name.startswith("lstm_transform")).drop_rate = 0.3
    gm = GradientMachine(tc.model_config, device="cpu")
    params = gm.init_params(seed=2)
    batch = example_batch(50, B=6, T=9, seed=4, device="cpu")
    runs = []
    orig = fl.lstm_forward_reference
    monkeypatch.setattr(fl, "lstm_forward_reference",
                        lambda *a, **k: (runs.append(1), orig(*a, **k))[1])
    steps = {}
    for mode in ("none", "full"):
        runs.clear()
        loss, grads, _, _ = gm.grad_fn(remat=mode)(params, batch, 7)
        steps[mode] = (loss, grads, len(runs))
    assert steps["none"][2] == 1 and steps["full"][2] == 2
    _assert_equal_steps(steps["full"][:2], steps["none"][:2])
    other = gm.grad_fn(remat="full")(params, batch, 8)[0]
    assert float(other) != float(steps["full"][0])


def test_full_remat_tracks_the_jax_package(monkeypatch):
    """Dropout off: the port's remat="full" step against the JAX package's
    grad_fn(remat="full") on its Pallas LSTM in interpret mode (as
    tests/test_pallas_lstm.py runs it, H = 128 and B = 8 for its tiling),
    from the same parameters, at the float32 parity bound; and the port's
    Trainer takes the config's mode (the LSTM twice a step)."""
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    from paddle_tpu.ops import pallas_lstm as pk

    calls = []
    orig = pk.lstm_layer_forward
    monkeypatch.setattr(pk, "lstm_layer_forward",
                        lambda *a, **k: (calls.append(1), orig(*a, **k))[1])
    widths = dict(dict_dim=50, emb_dim=8, hidden=128, classes=2)
    jm = JaxMachine(jax_flagship_config(**widths).model_config, pallas_rnn=True)
    jp = jm.init_params(seed=3)
    jloss, jg, _, _ = jm.grad_fn(remat="full")(jp, jax_example_batch(50, B=8, T=6, seed=1), None)
    assert calls
    tc = flagship_config(**widths)
    tc.opt_config.remat = "full"
    trainer = Trainer(tc, device="cpu")
    params = params_from_numpy(_np(jp), "cpu")
    batch = example_batch(50, B=8, T=6, seed=1, device="cpu")
    loss, grads, _, _ = trainer._grad_fn(params, batch, None)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5, atol=1e-6)
    assert sorted(grads) == sorted(jg)
    for n in jg:
        np.testing.assert_allclose(grads[n].numpy(), np.asarray(jg[n]), rtol=5e-4, atol=5e-5,
                                   err_msg=n)
    runs = []
    orig_ref = fl.lstm_forward_reference
    monkeypatch.setattr(fl, "lstm_forward_reference",
                        lambda *a, **k: (runs.append(1), orig_ref(*a, **k))[1])
    trainer.params = params
    trainer.opt_state = trainer.updater.init_state(params)
    assert np.isfinite(float(trainer.train_one_batch(batch)))
    assert len(runs) == 2


def test_full_remat_on_the_sparse_path():
    """A sparse_update table (its prefetched rows are leaves): remat="full"
    gives the row-sparse gradient of remat="none", and its loss within the
    bf16 bound of the JAX package's remat="full" sparse step
    (test_torch_bf16.py::test_sparse_table_gradients_stay_float32)."""
    jtc = _sparse_config("paddle_tpu")
    jm = JaxMachine(jtc.model_config, compute_dtype=jax.numpy.bfloat16)
    jp = jm.init_params(seed=1)
    jloss = jm.grad_fn(remat="full")(jp, jax_example_batch(dict_dim=100, B=4, T=8),
                                     jax.random.PRNGKey(0))[0]
    tc = _sparse_config("paddle_tpu_torch")
    gm = GradientMachine(tc.model_config, device="cpu", compute_dtype=tc.opt_config.dtype)
    params = params_from_numpy(_np(jp), "cpu")
    batch = example_batch(dict_dim=100, B=4, T=8, device="cpu")
    full = gm.grad_fn(remat="full")(params, batch)
    none = gm.grad_fn(remat="none")(params, batch)
    assert isinstance(full[1]["emb"], RowSparseGrad)
    _assert_equal_steps(full[:2], none[:2])
    np.testing.assert_allclose(float(full[0]), float(jloss), rtol=5e-3, atol=1e-3)
