"""The port's GRU kernel reference against the JAX package's Pallas kernel.

``paddle_tpu.ops.pallas_gru.gru_layer_forward(..., interpret=True)`` (the
TPU kernel run by the Pallas interpreter on the CPU) and
``paddle_tpu_torch.ops.fused_gru.gru_forward_reference`` (the plain
version the CUDA kernel is held against on the card) get the same seeded
numpy inputs. Tolerance atol = rtol = 2e-5, the JAX GRU tests' own bound
for float32 sums taken in another order.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.graph  # noqa: F401  (break the layers<->graph import cycle)
from paddle_tpu.ops import pallas_gru as pg
from paddle_tpu_torch.ops import fused_gru as tg

torch.set_num_threads(1)
TOL = dict(rtol=2e-5, atol=2e-5)


def _inputs(seed, T=5, B=4, H=16, with_bias=True):
    rng = np.random.RandomState(seed)
    x = (rng.randn(T, B, 3 * H) * 0.5).astype(np.float32)
    w = (rng.randn(H, 3 * H) / np.sqrt(H)).astype(np.float32)
    bias = (rng.randn(3 * H) * 0.1).astype(np.float32) if with_bias else None
    lengths = rng.randint(1, T + 1, B)
    lengths[-1] = 0                                   # an empty sequence
    lengths[0] = T                                    # a full one
    mask = (np.arange(T)[:, None] < lengths[None, :]).astype(np.float32)
    return x, w, bias, mask


def _port(x, w, bias, mask, reversed_):
    x3 = torch.from_numpy(x if bias is None else x + bias)
    return tg.gru_forward_reference(x3, torch.from_numpy(mask), torch.from_numpy(w),
                                    reverse=reversed_).numpy()


@pytest.mark.parametrize("reversed_", [False, True])
@pytest.mark.parametrize("with_bias", [True, False])
def test_reference_matches_pallas_kernel(reversed_, with_bias):
    x, w, bias, mask = _inputs(0, with_bias=with_bias)
    cfg = types.SimpleNamespace(size=16, reversed=reversed_,
                                active_type="tanh", active_gate_type="sigmoid")
    ref = pg.gru_layer_forward(cfg, jnp.asarray(x), jnp.asarray(mask), jnp.asarray(w),
                               None if bias is None else jnp.asarray(bias),
                               interpret=True)
    np.testing.assert_allclose(_port(x, w, bias, mask, reversed_), np.asarray(ref), **TOL)


@pytest.mark.parametrize("reversed_", [False, True])
def test_reversed_stays_at_h0_until_the_sequence_starts(reversed_):
    """Padded steps emit 0 and pass the carry through: the empty row is all
    zeros, and a reversed short row matches the same row run alone."""
    x, w, bias, mask = _inputs(1, T=6)
    ys = _port(x, w, bias, mask, reversed_)
    assert not ys[:, -1].any()
    n = int(mask[:, 1].sum())
    alone = _port(x[:n, 1:2], w, bias, mask[:n, 1:2], reversed_)
    np.testing.assert_allclose(ys[:n, 1:2], alone, **TOL)
    assert not ys[n:, 1].any()


def test_fused_gru_takes_the_plain_version_on_the_cpu():
    x, w, bias, mask = _inputs(2)
    x3 = torch.from_numpy(x + bias)
    got = tg.fused_gru(x3, torch.from_numpy(mask), torch.from_numpy(w), reverse=True)
    np.testing.assert_array_equal(got.numpy(), _port(x, w, bias, mask, True))
    assert tg.GRU_FWD.launches == 0


def test_gated_recurrent_layer_matches_jax_scan():
    """The port's layer (bias fold + time-major view + fused_gru) against
    the JAX package's unfused scan layer, through both DSL-built graphs."""
    from paddle_tpu.graph import GradientMachine as JaxMachine
    from paddle_tpu.graph import make_seq as jax_seq
    from paddle_tpu.trainer_config_helpers import (data_layer, embedding_layer,
                                                   outputs, simple_gru)
    from paddle_tpu.config.builder import fresh_context
    from paddle_tpu_torch.bridge import params_from_numpy
    from paddle_tpu_torch.graph import GradientMachine, make_seq

    with fresh_context() as ctx:
        words = data_layer(name="w", size=30)
        emb = embedding_layer(input=words, size=8)
        outputs(simple_gru(input=emb, size=16, reverse=True))
        tc = ctx.finalize()
    rng = np.random.RandomState(3)
    ids = rng.randint(0, 30, (3, 5)).astype(np.int32)
    lens = np.array([5, 2, 0], np.int32)
    jm = JaxMachine(tc.model_config)
    jp = jm.init_params(seed=1)
    out_name = jm.network.output_layer_names[0]
    ref = jm.forward(jp, {"w": jax_seq(None, lens, ids=ids)})[0][out_name].value
    tm = GradientMachine(tc.model_config, device="cpu")
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    got = tm.forward(tp, {"w": make_seq(None, lens, ids=ids, device="cpu")})[0][out_name].value
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
