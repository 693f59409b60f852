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


@pytest.mark.parametrize("B", [1, 64, 256])
@pytest.mark.parametrize("Te", [1, 32, 256])
def test_the_serve_step_kernel_fits_at_the_demo_widths(B, Te):
    """Kernel 4 is kernel 5's grid without the residuals: one block per SM
    (128 at D = 512), the forward's shared memory a block, within the limit
    for every B <= 256 and Te <= 256; supported() holds."""
    plan = fa.grid_plan(B, Te, DEMO["D"], DEMO["E"], H100_SMS)
    assert plan["blocks"] == 128 and plan["fwd_smem_bytes"] <= fa.SMEM_LIMIT
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


@pytest.mark.parametrize("refuse", [True, False])
def test_the_serve_step_routes_by_supported(monkeypatch, refuse):
    """attention_gru_step asks supported(B, Te, D, E) before any launch: a
    refused shape runs the plain step, counted in EAGER_ROUTES; either way
    it matches the JAX package's step (1e-5)."""
    import jax.numpy as jnp

    from paddle_tpu.ops import pallas_attention_gru as jag

    Te, B, D, E = 7, 3, 16, 24
    rng = np.random.RandomState(5)
    arrs = [rng.randn(B, D), rng.randn(Te, B, D), rng.randn(Te, B, E),
            (np.arange(Te)[:, None] < np.array([Te, 3, 1])[None, :])[:, :, None],
            rng.randn(B, 3 * D), rng.randn(D, D) / 4, rng.randn(1, D) * 0.1,
            rng.randn(1, D) * 0.1, rng.randn(E, 3 * D) / 5, rng.randn(D, 3 * D) / 4]
    arrs = [np.asarray(a, np.float32) * (0.3 if i in (0, 1, 2, 4) else 1.0)
            for i, a in enumerate(arrs)]
    want = jag.attention_gru_step(*[jnp.asarray(a) for a in arrs])
    asked = []
    accepts = fa.supported
    monkeypatch.setattr(fa, "supported",
                        lambda *a, **k: asked.append(a[:4]) or (not refuse and accepts(*a, **k)))
    before = fa.EAGER_ROUTES
    got = fa.attention_gru_step(*[torch.from_numpy(a) for a in arrs])
    assert asked == [(B, Te, D, E)]
    assert fa.EAGER_ROUTES == before + (1 if refuse else 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_the_fused_serve_engine_counts_its_eager_steps(monkeypatch):
    """The fused-step engine with the gate refusing: every decode
    micro-step runs the plain step and counts one eager route, and the
    greedy streams equal the JAX package's fused engine's."""
    from paddle_tpu.flagship import nmt_gen_config as jax_gen_config
    from paddle_tpu.serving.engine import Engine as JaxEngine
    from paddle_tpu.serving.jax_backend import JaxDecodeBackend
    from paddle_tpu_torch.flagship import nmt_gen_config
    from paddle_tpu_torch.serving.frontend import build_engine

    kw = dict(vocab=50, dim=16, beam_size=1, max_length=8, batch_size=2)
    jm = JaxMachine(jax_gen_config(**kw).model_config)
    jp = jm.init_params(seed=1)
    tm = GradientMachine(nmt_gen_config(**kw).model_config, device="cpu")
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    rng = np.random.RandomState(7)
    prompts = [rng.randint(2, 50, size=rng.randint(1, 5)).tolist() for _ in range(6)]

    def run(engine):
        futs = [engine.submit(p, rid=f"g{i}") for i, p in enumerate(prompts)]
        out = [f.result(timeout=120.0) for f in futs]
        assert engine.drain(timeout=60.0)
        assert all(r.outcome == "ok" and r.tokens for r in out)
        return [r.tokens for r in out]

    want = run(JaxEngine(JaxDecodeBackend(jm, jp, slots=3, prompt_tokens=4,
                                          fused_step=True)).start())
    monkeypatch.setattr(fa, "supported", lambda *a, **k: False)
    ours = build_engine(tm, tp, slots=3, prompt_tokens=4, fused_step=True)
    backend = ours._backend
    backend.decode_microsteps = 0
    before = fa.EAGER_ROUTES
    assert run(ours.start()) == want
    assert backend.decode_microsteps > 0
    assert fa.EAGER_ROUTES - before == backend.decode_microsteps
