"""The port's attention-GRU reference against the JAX package's Pallas kernel.

``fused_attention_gru(..., interpret=True)`` and ``attention_gru_step`` of
``paddle_tpu.ops.pallas_attention_gru`` against the plain versions in
``paddle_tpu_torch.ops.fused_attention_gru`` (what the CUDA kernel is held
against on the card), on the same seeded numpy inputs. Tolerance 1e-5
(atol and rtol), the bound the JAX package's own step-vs-kernel test uses.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import pallas_attention_gru as jag
from paddle_tpu_torch.ops import fused_attention_gru as tag

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
ACTS = ("tanh", "sigmoid")


def _inputs(seed, Td, Te=5, B=3, D=8, E=16):
    rng = np.random.RandomState(seed)
    r = lambda *s: (rng.randn(*s) * 0.3).astype(np.float32)
    lens = np.array([Te, 2, 0][:B], np.int32)         # full, ragged, all-masked
    em = (np.arange(Te)[:, None] < lens[None, :]).astype(np.float32)[:, :, None]
    dmask = (rng.rand(Td, B, 1) > 0.3).astype(np.float32)
    return [r(Te, B, D), r(Te, B, E), em, r(Td, B, 3 * D), dmask, r(B, D),
            r(D, D), r(1, D), r(1, D), r(E, 3 * D), r(D, 3 * D)]


@pytest.mark.parametrize("Td", [1, 4])
def test_reference_matches_pallas_kernel(Td):
    args = _inputs(Td, Td)
    ref = jag.fused_attention_gru(*[jnp.asarray(a) for a in args], ACTS, True)
    got = tag.attention_gru_reference(*[torch.from_numpy(a) for a in args])
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # the all-masked row attends to nothing: its context is 0, not NaN
    np.testing.assert_allclose(got.numpy(), tag.fused_attention_gru(
        *[torch.from_numpy(a) for a in args]).numpy(), rtol=0, atol=0)


def test_step_matches_jax_step():
    ep, ev, em, xw, _, h0, wa, ba, v, wctx, wg = _inputs(7, 1)
    ref = jag.attention_gru_step(*[jnp.asarray(a) for a in
                                   (h0, ep, ev, em, xw[0], wa, ba, v, wctx, wg)])
    got = tag.attention_gru_step(*[torch.from_numpy(a) for a in
                                   (h0, ep, ev, em, xw[0], wa, ba, v, wctx, wg)])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_strided_encoder_views_give_the_same_step():
    """The fused serve step passes batch-major slot buffers as transposed
    [Te, B, *] views; the result must not depend on the layout."""
    ep, ev, em, xw, _, h0, wa, ba, v, wctx, wg = [torch.from_numpy(a) for a in _inputs(8, 1)]
    base = tag.attention_gru_step(h0, ep, ev, em, xw[0], wa, ba, v, wctx, wg)
    ep_v = ep.transpose(0, 1).contiguous().transpose(0, 1)
    ev_v = ev.transpose(0, 1).contiguous().transpose(0, 1)
    got = tag.attention_gru_step(h0, ep_v, ev_v, em, xw[0], wa, ba, v, wctx, wg)
    np.testing.assert_allclose(got.numpy(), base.numpy(), **TOL)
    assert tag.ATTENTION_GRU_FWD.launches == 0
