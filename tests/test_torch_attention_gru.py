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


# ------------------------------------------------------------ training path


@pytest.mark.parametrize("Td", [1, 4])
def test_training_residuals_match_pallas_kernel(Td):
    """h_prev, (u, r, c), alpha and ctx as the training kernel saves them,
    against ``_run_fwd(..., residuals=True)``."""
    args = _inputs(Td + 10, Td)
    ref = jag._run_fwd(*[jnp.asarray(a) for a in args], ACTS, True, residuals=True)
    got = tag.attention_gru_reference(*[torch.from_numpy(a) for a in args], residuals=True)
    for name, a, b in zip(("ys", "hprev", "acts", "alpha", "ctx"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **TOL)


@pytest.mark.parametrize("Td", [1, 4])
def test_gradients_match_pallas_backward(Td):
    """All nine gradients from autograd through the plain version against
    jax.grad through the Pallas custom-VJP (``_bwd_kernel`` in interpret
    mode); tolerance 1e-4, the JAX package's own kernel-vs-reference bound
    (tests/test_fused_decoder.py)."""
    import jax

    args = _inputs(Td + 20, Td)
    cot = np.random.RandomState(Td).randn(Td, 3, 8).astype(np.float32)
    diff = (0, 1, 3, 5, 6, 7, 8, 9, 10)              # not the masks
    jg = jax.grad(lambda *a: jnp.sum(jag.fused_attention_gru(*a, ACTS, True) * cot),
                  diff)(*[jnp.asarray(a) for a in args])
    leaves = [torch.from_numpy(a).requires_grad_(i in diff) for i, a in enumerate(args)]
    (tag.fused_attention_gru(*leaves) * torch.from_numpy(cot)).sum().backward()
    names = ("dep", "dev", "dxw", "dh0", "dwa", "dba", "dv", "dwctx", "dwg")
    for name, i, b in zip(names, diff, jg):
        np.testing.assert_allclose(leaves[i].grad.numpy(), np.asarray(b),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
