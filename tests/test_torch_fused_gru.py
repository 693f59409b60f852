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
from torch_bf16_checks import assert_within_one_ulp, assert_within_scale, bf16, f32
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


# ------------------------------------------------------------ training path


@pytest.mark.parametrize("reversed_", [False, True])
def test_training_residuals_match_pallas_kernel(reversed_):
    """The residuals the training kernel saves (u, r, c and h_prev, at each
    step's own time index) against ``_run_fwd(..., residuals=True)``; the
    JAX package flips a reversed sequence outside the kernel."""
    x, w, bias, mask = _inputs(4)
    x3 = x + bias
    flip = (lambda a: a[::-1]) if reversed_ else (lambda a: a)
    ys, acts, hprev = pg._run_fwd(jnp.asarray(flip(x3).copy()),
                                  jnp.asarray(flip(mask).copy())[:, :, None],
                                  jnp.asarray(w), tg.KERNEL_ACTS, True, residuals=True)
    got = tg.gru_forward_reference(torch.from_numpy(x3), torch.from_numpy(mask),
                                   torch.from_numpy(w), reverse=reversed_, residuals=True)
    for name, a, b in zip(("ys", "acts", "hprev"), got, (ys, acts, hprev)):
        np.testing.assert_allclose(a.numpy(), flip(np.asarray(b)), err_msg=name, **TOL)


@pytest.mark.parametrize("reversed_", [False, True])
def test_gradients_match_pallas_backward(reversed_):
    """dx3 and dW from autograd through the plain version against jax.grad
    through the Pallas custom-VJP (``_bwd_kernel`` in interpret mode), with
    an empty row and ragged lengths."""
    import jax

    x, w, bias, mask = _inputs(5)
    cot = np.random.RandomState(6).randn(*x.shape[:2], w.shape[0]).astype(np.float32)
    cfg = types.SimpleNamespace(size=16, reversed=reversed_,
                                active_type="tanh", active_gate_type="sigmoid")

    def jloss(x3, w_):
        ys = pg.gru_layer_forward(cfg, x3, jnp.asarray(mask), w_, None, interpret=True)
        return jnp.sum(ys * cot)

    jdx, jdw = jax.grad(jloss, (0, 1))(jnp.asarray(x + bias), jnp.asarray(w))
    x3 = torch.from_numpy(x + bias).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    ys = tg.fused_gru(x3, torch.from_numpy(mask), wt, reverse=reversed_)
    (ys * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(x3.grad.numpy(), np.asarray(jdx), **TOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jdw), **TOL)
    assert not x3.grad.numpy()[:, -1].any()          # the empty row gets nothing


# ------------------------------------------------ the other activations

# (act_in, act_gate) pairs beyond the default (tanh, sigmoid): every one of
# the four activations in each slot
OTHER_ACTS = [("relu", "sigmoid"), ("linear", "tanh"), ("tanh", "relu")]


@pytest.mark.parametrize("acts", OTHER_ACTS)
@pytest.mark.parametrize("reversed_", [False, True])
def test_other_activations_match_pallas_kernel(acts, reversed_):
    """ys and the training residuals of the plain version against the Pallas
    forward in interpret mode, with activations other than the defaults."""
    x, w, bias, mask = _inputs(7)
    act_in, act_gate = acts
    cfg = types.SimpleNamespace(size=16, reversed=reversed_,
                                active_type=act_in, active_gate_type=act_gate)
    ref = pg.gru_layer_forward(cfg, jnp.asarray(x), jnp.asarray(mask), jnp.asarray(w),
                               jnp.asarray(bias), interpret=True)
    x3 = x + bias
    got = tg.gru_forward_reference(torch.from_numpy(x3), torch.from_numpy(mask),
                                   torch.from_numpy(w), reverse=reversed_, acts=acts,
                                   residuals=True)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref), **TOL)
    flip = (lambda a: a[::-1]) if reversed_ else (lambda a: a)
    want = pg._run_fwd(jnp.asarray(flip(x3).copy()), jnp.asarray(flip(mask).copy())[:, :, None],
                       jnp.asarray(w), acts, True, residuals=True)
    for name, a, b in zip(("ys", "acts", "hprev"), got, want):
        np.testing.assert_allclose(a.numpy(), flip(np.asarray(b)), err_msg=name, **TOL)


@pytest.mark.parametrize("acts", OTHER_ACTS)
def test_other_activations_gradients_match_pallas_backward(acts):
    """dx3 and dW from autograd through the plain version against jax.grad
    through the Pallas custom VJP (``_bwd_kernel`` in interpret mode)."""
    import jax

    x, w, bias, mask = _inputs(8)
    cot = np.random.RandomState(9).randn(*x.shape[:2], w.shape[0]).astype(np.float32)
    cfg = types.SimpleNamespace(size=16, reversed=False,
                                active_type=acts[0], active_gate_type=acts[1])

    def jloss(x3, w_):
        ys = pg.gru_layer_forward(cfg, x3, jnp.asarray(mask), w_, None, interpret=True)
        return jnp.sum(ys * cot)

    jdx, jdw = jax.grad(jloss, (0, 1))(jnp.asarray(x + bias), jnp.asarray(w))
    x3 = torch.from_numpy(x + bias).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    ys = tg.fused_gru(x3, torch.from_numpy(mask), wt, acts=acts)
    (ys * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(x3.grad.numpy(), np.asarray(jdx), **TOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jdw), **TOL)


def test_the_wrapper_takes_the_four_activations_in_each_slot():
    """What the kernels take, and the codes the wrapper passes them."""
    for a in tg.ACT_CODES:
        for b in tg.ACT_CODES:
            assert tg._act_codes((a, b)) == (tg.ACT_CODES[a], tg.ACT_CODES[b])
    with pytest.raises(ValueError, match="activations"):
        tg._act_codes(("softmax", "sigmoid"))
    with pytest.raises(ValueError, match="activations"):
        tg._act_codes(("tanh", "sigmoid", "sigmoid"))
    with pytest.raises(ValueError, match="H <="):
        tg._check_operands(torch.zeros(1, 1, 3 * (tg.MAX_H + 1)), torch.ones(1, 1),
                           torch.zeros(1), tg.KERNEL_ACTS)      # refused before w is read


# ------------------------------------------------ the light path's launch


@pytest.mark.parametrize("residuals", [False, True])
def test_forward_launch_asks_the_gate_before_the_plan_and_the_launch(monkeypatch, residuals):
    """Kernels 1 and 2 go through one wrapper path: _launch_fwd asks
    supported() first, then takes fwd_plan, then launches with one argument
    for each of the entry point's C parameters. Where the gate refuses it
    raises before the plan and launches nothing. Shown without a card: the
    gate, the plan and the launch are recorded in order."""
    order = []
    gate, plan = tg.supported, tg.fwd_plan
    monkeypatch.setattr(tg, "supported", lambda *a, **k: order.append("supported") or gate(*a, **k))
    monkeypatch.setattr(tg, "fwd_plan", lambda *a: order.append("fwd_plan") or plan(*a))
    kernel = tg.GRU_FWD_TRAIN if residuals else tg.GRU_FWD
    launched = []
    monkeypatch.setattr(kernel, "launch", lambda dev, *args: order.append("launch")
                        or launched.append(args))
    x, w, bias, mask = _inputs(10, T=3, B=2, H=8)
    args = (torch.from_numpy(x + bias), torch.from_numpy(mask), torch.from_numpy(w), True,
            tg.KERNEL_ACTS, residuals)
    out = tg._launch_fwd(*args)
    assert order == ["supported", "fwd_plan", "launch"]
    (got,) = launched
    assert len(got) + 1 == len(kernel.argtypes)              # the stream comes last
    assert got[-2:] == (tg.card_sms(torch.device("cpu")), 1)  # num_sms, w_smem
    assert got.count(None) == 1        # w's columns in shared memory: no wslices, all else given
    shapes = [(3, 2, 8)] + ([(3, 2, 24), (3, 2, 8)] if residuals else [])
    assert [tuple(o.shape) for o in (out if residuals else [out])] == shapes

    order.clear()
    monkeypatch.setattr(tg, "supported", lambda *a, **k: order.append("supported") or False)
    with pytest.raises(ValueError, match="do not take"):
        tg._launch_fwd(*args)
    assert order == ["supported"] and len(launched) == 1


# ------------------------------------------------------------ bf16 operands

@pytest.mark.parametrize("T", [1, 2])
def test_bf16_plain_versions_match_pallas_at_one_step(T):
    """At T = 1 the bf16 plain forward and backward round where the Pallas
    kernels do in bf16 (h and r*h before the products, dcand and dg before
    the products with w transposed, dW rounded once), so every output,
    residual and gradient is within one bf16 ulp of the interpreted kernel.
    The carry starts at 0, so T = 2 is the first step whose products and
    dW see a rounded h: it holds to the same bound."""
    x, w, _, mask = _inputs(21, T=T, B=4)
    mask[:, -1] = 1.0
    (jx, tx), (jw, tw) = bf16(x), bf16(w)
    jys, jacts, jhp = pg._run_fwd(jx, jnp.asarray(mask)[:, :, None], jw, tg.KERNEL_ACTS, True,
                                  residuals=True)
    got = tg.gru_forward_reference(tx, torch.from_numpy(mask), tw, residuals=True)
    for name, a, b in zip(("ys", "acts", "hprev"), got, (jys, jacts, jhp)):
        assert a.dtype == torch.bfloat16, name
        assert_within_one_ulp(a, b, name)
    dy = np.random.RandomState(22).randn(T, 4, 16).astype(np.float32)
    jdy, tdy = bf16(dy)
    jdx, jdw = pg._run_bwd(jdy, jacts, jhp, jnp.asarray(mask)[:, :, None], jw, tg.KERNEL_ACTS,
                           True)
    to_t = lambda a: torch.from_numpy(f32(a)).to(torch.bfloat16)
    dx, dw = tg.gru_backward_reference(tdy, to_t(jacts), to_t(jhp), torch.from_numpy(mask), tw)
    assert dx.dtype == dw.dtype == torch.bfloat16
    assert_within_one_ulp(dx, jdx, "dx3")
    assert_within_one_ulp(dw, jdw, "dw")


@pytest.mark.parametrize("reversed_", [False, True])
def test_bf16_sequence_matches_pallas_within_scale(reversed_):
    """Over a sequence: ys, the residuals and both gradients (the CPU's
    bf16 autograd Function: the plain forward and backward) within 1e-2 of
    scale of the Pallas function in interpret mode in bf16."""
    import jax

    x, w, bias, mask = _inputs(23, T=6, B=4)
    x3 = x + bias
    (jx, tx), (jw, tw) = bf16(x3), bf16(w)
    flip = (lambda a: a[::-1]) if reversed_ else (lambda a: a)
    ref = pg._run_fwd(jnp.asarray(flip(f32(jx)).copy()).astype(jnp.bfloat16),
                      jnp.asarray(flip(mask).copy())[:, :, None], jw, tg.KERNEL_ACTS, True,
                      residuals=True)
    got = tg.gru_forward_reference(tx, torch.from_numpy(mask), tw, reverse=reversed_,
                                   residuals=True)
    for name, a, b in zip(("ys", "acts", "hprev"), got, ref):
        assert_within_scale(a, flip(f32(b)), name)
    cot = np.random.RandomState(24).randn(6, 4, 16).astype(np.float32)
    cfg = types.SimpleNamespace(size=16, reversed=reversed_,
                                active_type="tanh", active_gate_type="sigmoid")

    def jloss(x3_, w_):
        ys = pg.gru_layer_forward(cfg, x3_, jnp.asarray(mask), w_, None, interpret=True)
        return jnp.sum(ys.astype(jnp.float32) * cot)

    jdx, jdw = jax.grad(jloss, (0, 1))(jx, jw)
    xl, wl = tx.clone().requires_grad_(), tw.clone().requires_grad_()
    ys = tg.fused_gru(xl, torch.from_numpy(mask), wl, reverse=reversed_)
    assert ys.dtype == torch.bfloat16
    (ys.float() * torch.from_numpy(cot)).sum().backward()
    assert xl.grad.dtype == wl.grad.dtype == torch.bfloat16
    assert_within_scale(xl.grad, jdx, "dx3")
    assert_within_scale(wl.grad, jdw, "dw")


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_the_kernels_refuse_other_operand_types(dtype):
    """Kernels 1-3 have a float32 and a bf16 instance: operands of another
    type are refused before any launch, whatever supported() says of the
    shape (it decides no operand type)."""
    x, w, _, mask = _inputs(5, with_bias=False)
    x3, tw, tm = torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(mask)
    for od in tg.OPERAND_DTYPES:
        tg._check_operands(x3.to(od), tm, tw.to(od), tg.KERNEL_ACTS)
    with pytest.raises(ValueError, match="float32 or bf16"):
        tg._check_operands(x3.to(dtype), tm, tw.to(dtype), tg.KERNEL_ACTS)
