"""The attention-GRU decoder route decides by what kernels 5 and 6 take.

``fused_attention_gru.supported(B, Te, D, E, num_sms)`` states the shapes
of the persistent training kernels: a grid of at most one block per SM
(so the card holds it at once) and each block's shared memory within the
227 KB it may use. ``run_fused_decoder`` asks it before any launch, as the
JAX package asks ``pallas_attention_gru.supported``; a refused shape runs
the recurrent group's loop, counted in ``fused_attention_gru.EAGER_ROUTES``.
Here, on the CPU: ``supported`` at its edges (with ``num_sms=132``, the
H100's), and the seqToseq decoder group with the gate refusing and
accepting: which op ran, the count, and the loss (1e-5 relative) and every
gradient (1e-4 of max(1, max |JAX|)) against the JAX package.
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
from paddle_tpu_torch.graph import GradientMachine
from paddle_tpu_torch.ops import fused_attention_gru as fa

torch.set_num_threads(1)
H100_SMS = 132
DEMO = dict(D=512, E=1024)          # demo/seqToseq: dim 512, a bidirectional encoder


@pytest.mark.parametrize("B", [1, 64])
@pytest.mark.parametrize("Te", [1, 32, 256])
def test_supported_holds_at_the_demo_widths(B, Te):
    assert fa.supported(B, Te, DEMO["D"], DEMO["E"], num_sms=H100_SMS)


def test_the_main_path_plan():
    """Td = Te = 32, B = 64: 128 blocks of 4 hidden units (one per SM),
    94,336 and 129,152 bytes of shared memory, d_enc_proj in shared memory
    at Te = 32 and in place in its output at Te = 256."""
    plan = fa.grid_plan(64, 32, DEMO["D"], DEMO["E"], H100_SMS)
    assert plan == dict(blocks=128, unit_groups_per_block=1, e_groups_per_block=1, parts=2,
                        fwd_smem_bytes=94336, bwd_smem_bytes=129152, bwd_dep_in_smem=1)
    wide = fa.grid_plan(64, 256, DEMO["D"], DEMO["E"], H100_SMS)
    assert wide["bwd_dep_in_smem"] == 0 and wide["bwd_smem_bytes"] <= fa.SMEM_LIMIT
    assert fa.grid_barriers(32) == (127, 128)


@pytest.mark.parametrize("dims", [(0, 32, 512, 1024), (64, 0, 512, 1024),
                                  (64, 32, 0, 1024), (64, 32, 512, 0)])
def test_supported_refuses_an_empty_dimension(dims):
    assert not fa.supported(*dims, num_sms=H100_SMS)


def test_supported_refuses_what_a_block_cannot_hold():
    # the forward's wctx slice alone: 4 units x 3 gates x E floats
    assert fa.supported(64, 32, 512, 3072, num_sms=H100_SMS)
    assert not fa.supported(64, 32, 512, 4096, num_sms=H100_SMS)
    assert fa.grid_plan(64, 32, 512, 4096, H100_SMS)["fwd_smem_bytes"] > fa.SMEM_LIMIT
    # the per-row state grows with B
    assert not fa.supported(2048, 32, DEMO["D"], DEMO["E"], num_sms=H100_SMS)
    # fewer SMs: more unit groups a block, so more weights a block
    assert not fa.supported(64, 32, DEMO["D"], DEMO["E"], num_sms=16)
    assert fa.supported(64, 32, DEMO["D"], DEMO["E"], num_sms=64)


def _spy(monkeypatch, module, name):
    calls = []
    orig = getattr(module, name)

    def spy(*a, **k):
        out = orig(*a, **k)
        calls.append(out is not None)
        return out

    monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("refuse", [True, False])
def test_the_decoder_group_routes_by_supported(monkeypatch, refuse):
    """At dim 16, B 4, T 5: a refused shape takes the loop (no kernel op,
    one eager route), an accepted one the fused op; both match the JAX
    package's loss and gradients."""
    tc = jax_nmt_config(vocab=50, dim=16, batch_size=4)
    jm = JaxMachine(tc.model_config)
    jparams = jm.init_params(seed=11)
    jloss, jgrads, _, _ = jm.grad_fn()(jparams, jax_nmt_batch(vocab=50, B=4, T=5),
                                       jax.random.PRNGKey(0))

    asked = []
    accepts = fa.supported

    def gate(*a, **k):
        asked.append(a)
        return False if refuse else accepts(*a, **k)

    monkeypatch.setattr(fa, "supported", gate)
    launched = _spy(monkeypatch, fa, "fused_attention_gru")
    before = fa.EAGER_ROUTES
    machine = GradientMachine(nmt_config(vocab=50, dim=16, batch_size=4).model_config,
                              device="cpu")
    loss, grads, _, _ = machine.grad_fn()(
        params_from_numpy({k: np.asarray(v) for k, v in jparams.items()}, "cpu"),
        nmt_batch(vocab=50, B=4, T=5, device="cpu"))

    assert asked == [(4, 5, 16, 32)]                 # B, Te, D, E
    assert launched == ([] if refuse else [True])
    assert fa.EAGER_ROUTES == before + (1 if refuse else 0)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5, atol=0)
    assert sorted(grads) == sorted(jgrads)
    for name in sorted(jgrads):
        want = np.asarray(jgrads[name])
        tol = 1e-4 * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(grads[name].numpy(), want, rtol=0, atol=tol, err_msg=name)
