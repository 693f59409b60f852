"""The port's model-FLOP count, per-layer numerics and StatSet, on the CPU.

- Each kernel's FLOP formula (``ops/kernel_flops.py``), which its wrapper
  records on the card, equals what ``FlopCounterMode`` counts on the
  kernel's plain version, forward and backward (the attention decoder's
  backward also runs three PyTorch products in its wrapper, which the
  counter sees on both devices): a step counts the same on the card and on
  the CPU.
- ``train_step_flops`` of a seqToseq step and of an LSTM-classifier step
  equal the JAX package's ``train_step_flops`` of the same step, within
  1e-3 relative, once two stated differences are added: the first step of
  a recurrence has a constant zero carry, whose gradient autograd does not
  run (the JAX scan transposes it: ``4·B·H²`` a GRU, ``8·B·H²`` an LSTM),
  and the decoder's attention context is a product here (``2·B·Te·E`` a
  step, three times with the backward), a multiply and a sum in the JAX
  scan.
- ``step_health``, ``derive``, ``layer_groups`` and ``blame_nonfinite``
  equal the JAX package's on the same parameters, within 1e-5 relative.
- The card peaks, ``stat_timer`` and ``wait_for``.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import paddle_tpu.graph  # noqa: F401  (break the layers<->graph import cycle)
from paddle_tpu.flagship import example_batch as jax_example_batch
from paddle_tpu.flagship import flagship_config as jax_flagship_config
from paddle_tpu.flagship import nmt_batch as jax_nmt_batch
from paddle_tpu.flagship import nmt_config as jax_nmt_config
from paddle_tpu.graph import GradientMachine as JaxMachine
from paddle_tpu.observability import numerics as jax_num
from paddle_tpu.ops.kernel_flops import train_step_flops as jax_train_step_flops
from paddle_tpu_torch.bridge import params_from_numpy
from paddle_tpu_torch.flagship import example_batch, flagship_config, nmt_batch, nmt_config
from paddle_tpu_torch.graph import GradientMachine
from paddle_tpu_torch.observability import numerics as num
from paddle_tpu_torch.ops import flash_attention as fl_attn
from paddle_tpu_torch.ops import fused_attention_gru as fa
from paddle_tpu_torch.ops import fused_conv1x1_bn as fc
from paddle_tpu_torch.ops import fused_gru as fg
from paddle_tpu_torch.ops import fused_lstm as fl
from paddle_tpu_torch.ops import kernel_flops as kf

torch.set_num_threads(1)


def _count(fn):
    with FlopCounterMode(display=False) as counter:
        out = fn()
    return float(counter.get_total_flops()), out


def _leaf(*shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (0.3 * torch.randn(*shape, generator=g)).requires_grad_()


def _mask(T, B):
    lengths = torch.tensor([T, max(T - 2, 1), 1, T][:B])
    return (torch.arange(T)[:, None] < lengths[None, :]).float()


def _fwd_bwd(run, inputs):
    """FLOPs of the forward, then of the backward of every input."""
    fwd, out = _count(run)
    bwd, _ = _count(lambda: torch.autograd.grad(out.sum(), inputs))
    return fwd, bwd


def _gru(reverse):
    T, B, H = 5, 4, 8
    x3, w = _leaf(T, B, 3 * H), _leaf(H, 3 * H, seed=1)
    fwd, bwd = _fwd_bwd(lambda: fg.fused_gru(x3, _mask(T, B), w, reverse=reverse), [x3, w])
    return fwd, kf.gru_fwd_flops(T, B, H), bwd, kf.gru_bwd_flops(T, B, H)


def _lstm():
    T, B, H = 5, 4, 8
    x4, w, peep = _leaf(T, B, 4 * H), _leaf(H, 4 * H, seed=1), _leaf(3, H, seed=2)
    fwd, bwd = _fwd_bwd(lambda: fl.fused_lstm(x4, _mask(T, B), w, peep), [x4, w, peep])
    return fwd, kf.lstm_fwd_flops(T, B, H), bwd, kf.lstm_bwd_flops(T, B, H)


def _attention_gru(h0_grad):
    Td, Te, B, D, E = 4, 5, 4, 8, 6
    ep, ev = _leaf(Te, B, D), _leaf(Te, B, E, seed=1)
    em = _mask(Te, B)[..., None]
    xw, dmask = _leaf(Td, B, 3 * D, seed=2), _mask(Td, B)[..., None]
    h0 = _leaf(B, D, seed=3) if h0_grad else torch.zeros(B, D)
    wa, ba, v = _leaf(D, D, seed=4), _leaf(1, D, seed=5), _leaf(1, D, seed=6)
    wctx, wg = _leaf(E, 3 * D, seed=7), _leaf(D, 3 * D, seed=8)
    inputs = [ep, ev, xw, wa, ba, v, wctx, wg] + ([h0] if h0_grad else [])
    fwd, bwd = _fwd_bwd(lambda: fa.fused_attention_gru(ep, ev, em, xw, dmask, h0, wa, ba, v,
                                                      wctx, wg), inputs)
    # the wrapper's own products after kernel 6: dWctx, dWg and d_enc
    wrapper = 2.0 * Td * B * (E * 3 * D + D * 3 * D + Te * E)
    return (fwd, kf.attention_gru_fwd_flops(Td, B, Te, D, E), bwd,
            kf.attention_gru_bwd_flops(Td, B, Te, D, E, h0_grad) + wrapper)


def _flash(causal):
    B, T, H, D = 2, 6, 2, 8
    q, k, v = (_leaf(B, T, H, D, seed=s) for s in range(3))
    lengths = torch.tensor([T, 4], dtype=torch.int32)
    fwd, bwd = _fwd_bwd(lambda: fl_attn.flash_attention(q, k, v, lengths, causal), [q, k, v])
    return (fwd, kf.flash_fwd_flops(B, T, H, D), bwd,
            kf.flash_dq_flops(B, T, H, D) + kf.flash_dkv_flops(B, T, H, D))


def _conv1x1():
    M, K, N = 12, 8, 6
    x, w = _leaf(M, K), _leaf(N, K, seed=1)
    fwd, _ = _count(lambda: fc.conv1x1_stats(x, w))
    # its backward is PyTorch's products in the wrapper on both devices
    return fwd, kf.conv1x1_flops(M, K, N), 0.0, 0.0


@pytest.mark.parametrize("case", [
    lambda: _gru(False), lambda: _gru(True), _lstm, lambda: _attention_gru(True),
    lambda: _attention_gru(False), lambda: _flash(False), lambda: _flash(True), _conv1x1,
], ids=["gru", "gru-reversed", "lstm", "attention_gru", "attention_gru-constant-h0", "flash",
        "flash-causal", "conv1x1"])
def test_each_kernel_records_what_the_counter_counts_on_its_plain_version(case):
    fwd, fwd_formula, bwd, bwd_formula = case()
    assert fwd == fwd_formula > 0
    assert bwd == bwd_formula


# --------------------------------------------------- train_step_flops


def _jax_count(jm, jparams, jbatch):
    grad_fn = jm.grad_fn()
    return jax_train_step_flops(lambda p, b: grad_fn(p, b, None), jparams, jbatch)


def _port_count(model_config, jparams, batch):
    m = GradientMachine(model_config, device="cpu")
    params = params_from_numpy({k: np.asarray(v) for k, v in jparams.items()}, "cpu")
    return kf.train_step_flops(m.grad_fn(), params, batch)


def test_a_seqtoseq_step_counts_the_jax_packages_flops():
    dim, vocab, B, T = 16, 50, 4, 5
    jm = JaxMachine(jax_nmt_config(vocab=vocab, dim=dim, batch_size=B).model_config)
    jparams = jm.init_params(seed=1)
    want = _jax_count(jm, jparams, jax_nmt_batch(vocab=vocab, B=B, T=T))
    got = _port_count(nmt_config(vocab=vocab, dim=dim, batch_size=B).model_config, jparams,
                      nmt_batch(vocab=vocab, B=B, T=T, device="cpu"))
    E = 2 * dim          # the bidirectional encoder's width
    stated = 3 * 2.0 * B * T * E * T - 2 * 4.0 * B * dim * dim
    assert abs(got - (want + stated)) <= 1e-3 * want, (got, want, stated)
    assert abs(got - want) / want < 0.05


def test_an_lstm_classifier_step_counts_the_jax_packages_flops():
    dict_dim, emb, hidden, B, T = 50, 8, 8, 4, 6
    jm = JaxMachine(jax_flagship_config(dict_dim=dict_dim, emb_dim=emb,
                                        hidden=hidden).model_config)
    jparams = jm.init_params(seed=1)
    want = _jax_count(jm, jparams, jax_example_batch(dict_dim, B=B, T=T))
    got = _port_count(flagship_config(dict_dim=dict_dim, emb_dim=emb, hidden=hidden).model_config,
                      jparams, example_batch(dict_dim, B=B, T=T, device="cpu"))
    stated = -8.0 * B * hidden * hidden
    assert abs(got - (want + stated)) <= 1e-3 * want, (got, want, stated)


def test_peaks_name_the_cards_and_guess_no_other():
    assert kf.peak_tflops("NVIDIA H100 80GB HBM3") == 989.0
    assert kf.peak_gbps("NVIDIA H100 80GB HBM3") == 3350.0
    assert kf.peak_hbm_gb("NVIDIA H100 80GB HBM3") == 80.0
    assert kf.peak_tflops("NVIDIA A100-SXM4-80GB") is None and kf.peak_tflops("") is None
    from paddle_tpu_torch.observability import costs

    # the copied roofline classifier resolves its peaks through the port
    assert costs.classify(1e6, "NVIDIA H100 80GB HBM3") == "compute-bound"
    assert costs.classify(1e6, "cpu") == "unknown"


# --------------------------------------------------- numerics


@pytest.fixture(scope="module")
def nmt():
    dim, vocab = 8, 30
    jm = JaxMachine(jax_nmt_config(vocab=vocab, dim=dim, batch_size=4).model_config)
    jparams = {k: np.asarray(v) for k, v in jm.init_params(seed=1).items()}
    return jm, nmt_config(vocab=vocab, dim=dim, batch_size=4).model_config, jparams


def test_step_health_and_derive_equal_the_jax_packages(nmt):
    jm, model, p = nmt
    rng = np.random.RandomState(3)
    new = {k: v + 0.01 * rng.randn(*v.shape).astype(np.float32) for k, v in p.items()}
    grads = {k: rng.randn(*v.shape).astype(np.float32) for k, v in p.items()}
    poisoned = sorted(grads)[2]
    grads[poisoned].reshape(-1)[:3] = [np.nan, np.inf, -np.inf]
    groups = num.layer_groups(model, list(p))
    assert groups == jax_num.layer_groups(jm.model, list(p))
    jhealth = jax_num.step_health({k: jnp.asarray(v) for k, v in p.items()},
                                  {k: jnp.asarray(v) for k, v in new.items()},
                                  {k: jnp.asarray(v) for k, v in grads.items()}, groups)
    table = num.step_health(*(params_from_numpy(t, "cpu") for t in (p, new, grads)),
                            groups).numpy()
    assert table.shape == (len(groups), 4)
    for row, layer in zip(table, groups):
        np.testing.assert_allclose(row, np.asarray(jhealth[layer]), rtol=1e-5, err_msg=layer)
    layers, nf_layers, norm = num.derive(table, list(groups))
    jlayers, jnf, jnorm = jax_num.derive({k: np.asarray(v) for k, v in jhealth.items()})
    assert nf_layers == jnf and len(nf_layers) == 1
    assert math.isclose(norm, jnorm, rel_tol=1e-5)
    for layer, fields in jlayers.items():
        for key, want in fields.items():
            got = layers[layer][key]
            assert (math.isnan(got) and math.isnan(want)) or math.isclose(
                got, want, rel_tol=1e-5), (layer, key, got, want)
    # a stacked table (a fused launch's) reports its last row
    stacked = np.stack([np.zeros_like(table), table])
    assert num.derive(stacked, list(groups))[1] == nf_layers


@pytest.mark.parametrize("where", ["params", "forward"])
def test_blame_names_the_jax_packages_layer(nmt, where):
    jm, model, p = nmt
    batch = nmt_batch(vocab=30, B=4, T=5, device="cpu")
    jbatch = jax_nmt_batch(vocab=30, B=4, T=5)
    p = dict(p)
    if where == "params":
        name = sorted(n for n in p if n.endswith(".w0"))[-1]
        p[name] = p[name].copy()
        p[name].reshape(-1)[0] = np.nan
    else:
        # finite weights whose products overflow: the first non-finite value
        # is born in a layer's forward
        name = "_source_language_embedding"
        p[name] = np.full_like(p[name], 3e38)
    jblame = jax_num.blame_nonfinite(jm, jm.model, {k: jnp.asarray(v) for k, v in p.items()},
                                     jbatch)
    blame = num.blame_nonfinite(GradientMachine(model, device="cpu"), model,
                                params_from_numpy(p, "cpu"), batch)
    assert jblame is not None and blame["layer"] == jblame["layer"]
    assert blame["phase"] == jblame["phase"] == where
    assert blame["nonfinite"] == jblame["nonfinite"]


# --------------------------------------------------- StatSet


def test_stat_timer_sums_scopes_and_waits_on_one_tensor():
    from paddle_tpu_torch.utils.stats import StatSet, global_stats, stat_timer, wait_for

    global_stats.reset()
    x = torch.ones(3)
    for _ in range(3):
        with stat_timer("train_step", block_on=x):
            x = x * 2
    with stat_timer("test"):
        pass
    assert global_stats.get("train_step").count == 3
    assert global_stats.get("test").count == 1
    text = global_stats.summary()
    assert text.startswith("=== StatSet global ===") and "train_step" in text
    wait_for(x)                 # a CPU tensor is ready: nothing to wait for
    assert StatSet("empty").summary() == "=== StatSet empty: empty ==="
    global_stats.reset()
