"""The port's LSTM kernel reference against the JAX package's Pallas kernels.

``paddle_tpu.ops.pallas_lstm`` run by the Pallas interpreter on the CPU
(``_run_fwd(..., interpret=True)`` for the forward and its residuals,
``fused_lstm(..., interpret=True)``'s custom VJP for the backward kernel)
and ``paddle_tpu_torch.ops.fused_lstm.lstm_forward_reference`` (the plain
version the CUDA kernels are held against on the card) get the same
seeded numpy inputs. Tolerances: atol = rtol = 2e-5 forward, the JAX
recurrent tests' own bound for float32 sums taken in another order;
rtol 5e-4 / atol 5e-5 for the gradients, tests/test_pallas_lstm.py's bound
for the machine-level gradients (dW sums over every step and row).

The bf16 cases hold the bf16 plain versions (the kernels' bf16 contract) to
the same Pallas functions run at ``itemsize=2`` on bf16 operands: one step's
rounding points within one bf16 ulp, a sequence and its VJP within 1e-2 of
scale (``torch_bf16_checks``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.graph  # noqa: F401  (break the layers<->graph import cycle)
from paddle_tpu.ops import pallas_lstm as pk
from paddle_tpu_torch.ops import fused_lstm as tl
from torch_bf16_checks import assert_within_one_ulp, assert_within_scale, bf16, f32

torch.set_num_threads(1)
TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)
ACTS = [("tanh", "sigmoid", "tanh"), ("tanh", "sigmoid", "sigmoid"),
        ("relu", "sigmoid", "tanh"), ("linear", "linear", "linear")]


def _inputs(seed, T=5, B=4, H=16, with_bias=True):
    """x4 with the gate biases folded in, w, peep (zeros without a bias) and
    a [T, B] mask with ragged lengths, one empty row and one full row."""
    rng = np.random.RandomState(seed)
    x4 = (rng.randn(T, B, 4 * H) * 0.5).astype(np.float32)
    w = (rng.randn(H, 4 * H) / np.sqrt(H)).astype(np.float32)
    if with_bias:
        bias = (rng.randn(7 * H) * 0.1).astype(np.float32)
        x4 = x4 + bias[:4 * H]
        peep = bias[4 * H:].reshape(3, H).copy()
    else:
        peep = np.zeros((3, H), np.float32)
    lengths = rng.randint(1, T + 1, B)
    lengths[-1] = 0                                   # an empty sequence
    lengths[0] = T                                    # a full one
    mask = (np.arange(T)[:, None] < lengths[None, :]).astype(np.float32)
    return x4, w, peep, mask


def _flip(reversed_):
    """The JAX package flips a reversed sequence outside the kernel."""
    return (lambda a: a[::-1].copy()) if reversed_ else (lambda a: a)


@pytest.mark.parametrize("acts", ACTS)
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("reversed_", [False, True])
def test_forward_and_residuals_match_pallas_kernel(reversed_, with_bias, acts):
    """ys and the residuals the training kernel saves (a, i, f, o; h_prev;
    c_prev, each at its step's own time index) against
    ``_run_fwd(..., residuals=True)`` in interpret mode."""
    x4, w, peep, mask = _inputs(0, with_bias=with_bias)
    flip = _flip(reversed_)
    want = pk._run_fwd(jnp.asarray(flip(x4)), jnp.asarray(flip(mask))[:, :, None],
                       jnp.asarray(w), jnp.asarray(peep), acts, True, residuals=True)
    got = tl.lstm_forward_reference(torch.from_numpy(x4), torch.from_numpy(mask),
                                    torch.from_numpy(w), torch.from_numpy(peep),
                                    reverse=reversed_, acts=acts, residuals=True)
    for name, a, b in zip(("ys", "acts", "hprev", "cprev"), got, want):
        np.testing.assert_allclose(a.numpy(), flip(np.asarray(b)), err_msg=name, **TOL)
    ys = got[0].numpy()
    assert not ys[:, -1].any()                        # the empty row emits zeros
    light = tl.lstm_forward_reference(torch.from_numpy(x4), torch.from_numpy(mask),
                                      torch.from_numpy(w), torch.from_numpy(peep),
                                      reverse=reversed_, acts=acts)
    np.testing.assert_array_equal(light.numpy(), ys)


@pytest.mark.parametrize("reversed_", [False, True])
def test_reversed_row_stays_at_zero_until_it_starts(reversed_):
    """A short row matches the same row run alone, in either direction."""
    x4, w, peep, mask = _inputs(1, T=6)
    args = lambda x, m: (torch.from_numpy(x), torch.from_numpy(m), torch.from_numpy(w),
                         torch.from_numpy(peep))
    ys = tl.lstm_forward_reference(*args(x4, mask), reverse=reversed_).numpy()
    n = int(mask[:, 1].sum())
    alone = tl.lstm_forward_reference(*args(x4[:n, 1:2].copy(), mask[:n, 1:2].copy()),
                                      reverse=reversed_).numpy()
    np.testing.assert_allclose(ys[:n, 1:2], alone, **TOL)
    assert not ys[n:, 1].any()


@pytest.mark.parametrize("acts", [("tanh", "sigmoid", "sigmoid"), ("relu", "sigmoid", "tanh"),
                                  ("linear", "linear", "linear")])
@pytest.mark.parametrize("reversed_", [False, True])
def test_gradients_match_pallas_backward(reversed_, acts):
    """dx4, dW and dpeep from autograd through the plain version against
    ``jax.vjp`` of the Pallas custom VJP (``_bwd_kernel`` in interpret
    mode), with ragged lengths and an empty row."""
    x4, w, peep, mask = _inputs(2)
    cot = np.random.RandomState(3).randn(x4.shape[0], x4.shape[1], w.shape[0]).astype(np.float32)
    jmask = jnp.asarray(mask)

    def jys(x, w_, p):
        if reversed_:
            return jnp.flip(pk.fused_lstm(jnp.flip(x, 0), jnp.flip(jmask, 0), w_, p, acts, True), 0)
        return pk.fused_lstm(x, jmask, w_, p, acts, True)

    _, vjp = jax.vjp(jys, jnp.asarray(x4), jnp.asarray(w), jnp.asarray(peep))
    want = vjp(jnp.asarray(cot))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x4, w, peep)]
    ys = tl.fused_lstm(leaves[0], torch.from_numpy(mask), leaves[1], leaves[2],
                       reverse=reversed_, acts=acts)
    (ys * torch.from_numpy(cot)).sum().backward()
    for name, leaf, b in zip(("dx4", "dw", "dpeep"), leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(b), err_msg=name, **GRAD_TOL)
    assert not leaves[0].grad.numpy()[:, -1].any()   # the empty row gets nothing


def test_fused_lstm_takes_the_plain_version_on_the_cpu():
    x4, w, peep, mask = _inputs(4)
    before = [k.launches for k in tl.KERNELS]
    got = tl.fused_lstm(torch.from_numpy(x4), torch.from_numpy(mask), torch.from_numpy(w),
                        torch.from_numpy(peep), reverse=True)
    want = tl.lstm_forward_reference(torch.from_numpy(x4), torch.from_numpy(mask),
                                     torch.from_numpy(w), torch.from_numpy(peep), reverse=True)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert [k.launches for k in tl.KERNELS] == before


def test_empty_sequence_axis():
    """T = 0: no steps, empty outputs of the right shapes."""
    x4 = torch.zeros(0, 3, 8)
    ys, acts, hprev, cprev = tl.lstm_forward_reference(
        x4, torch.zeros(0, 3), torch.zeros(2, 8), torch.zeros(3, 2), residuals=True)
    assert ys.shape == (0, 3, 2) and acts.shape == (0, 3, 8)
    assert hprev.shape == cprev.shape == (0, 3, 2)


def test_the_wrapper_refuses_unknown_activations():
    with pytest.raises(ValueError, match="activations"):
        tl._act_codes(("tanh", "softmax", "tanh"))
    with pytest.raises(ValueError, match="activations"):
        tl._act_codes(("tanh", "sigmoid"))
    assert tl._act_codes(("relu", "sigmoid", "linear")) == (2, 1, 3)


@pytest.mark.parametrize("reversed_", [False, True])
def test_backward_reference_is_autograd_in_float32(reversed_):
    """In float32 the plain kernel 8 (no rounding) gives the gradients of
    autograd through the plain forward."""
    x4, w, peep, mask = _inputs(6)
    acts = ("tanh", "sigmoid", "tanh")
    tx, tw, tp, tm = map(torch.from_numpy, (x4, w, peep, mask))
    dy = torch.from_numpy(np.random.RandomState(7).randn(5, 4, 16).astype(np.float32))
    leaves = [a.clone().requires_grad_() for a in (tx, tw, tp)]
    ys = tl.lstm_loop(leaves[0], tm, leaves[1], leaves[2], reversed_, acts)
    want = torch.autograd.grad(ys, leaves, dy)
    _, saved, hprev, cprev = tl.lstm_forward_reference(tx, tm, tw, tp, reversed_, acts,
                                                       residuals=True)
    got = tl.lstm_backward_reference(dy, saved, hprev, cprev, tm, tw, tp, reversed_, acts)
    for name, a, b in zip(("dx4", "dw", "dpeep"), got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=name, **TOL)


# ------------------------------------------------------------ bf16 operands

BF16_ACTS = ("tanh", "sigmoid", "tanh")         # the classifier's lstmemory


@pytest.mark.parametrize("reversed_", [False, True])
def test_bf16_plain_versions_match_pallas_at_two_steps(reversed_):
    """At T = 2 (the first step whose product and dW see a rounded h) the
    bf16 plain forward, its residuals (c_prev in float32) and the plain
    backward's dx4, dW and dpeep from the same residuals are each within
    one bf16 ulp of ``_run_fwd`` / ``_run_bwd`` in interpret mode on bf16
    operands."""
    x4, w, peep, mask = _inputs(21, T=2)
    flip = _flip(reversed_)
    (jw, tw), (jp, tp) = bf16(w), bf16(peep)
    jm = jnp.asarray(flip(mask))[:, :, None]
    want = pk._run_fwd(bf16(flip(x4))[0], jm, jw, jp, BF16_ACTS, True, residuals=True)
    got = tl.lstm_forward_reference(bf16(x4)[1], torch.from_numpy(mask), tw, tp,
                                    reverse=reversed_, acts=BF16_ACTS, residuals=True)
    dtypes = (torch.bfloat16, torch.bfloat16, torch.bfloat16, torch.float32)
    for name, a, b, dt in zip(("ys", "acts", "hprev", "cprev"), got, want, dtypes):
        assert a.dtype == dt, name
        assert_within_one_ulp(a, flip(f32(b)), name)
    dy = np.random.RandomState(22).randn(2, 4, 16).astype(np.float32)
    jdx, jdw, jdp = pk._run_bwd(bf16(flip(dy))[0], tuple(want[1:]), jm, jw, jp, BF16_ACTS, True)
    to_t = lambda a, dt: torch.from_numpy(flip(f32(a))).to(dt)
    dx, dw, dp = tl.lstm_backward_reference(
        bf16(dy)[1], to_t(want[1], torch.bfloat16), to_t(want[2], torch.bfloat16),
        to_t(want[3], torch.float32), torch.from_numpy(mask), tw, tp, reversed_, BF16_ACTS)
    assert dx.dtype == dw.dtype == dp.dtype == torch.bfloat16
    assert_within_one_ulp(dx, flip(f32(jdx)), "dx4")
    assert_within_one_ulp(dw, jdw, "dw")
    assert_within_one_ulp(dp, jdp, "dpeep")


@pytest.mark.parametrize("reversed_", [False, True])
def test_bf16_sequence_matches_pallas_within_scale(reversed_):
    """At T = 8, B = 4, H = 16 a bf16 sequence through the CPU's autograd
    Function (the plain forward and backward, the mask in bf16 as the layer
    passes it) against ``pallas_lstm.fused_lstm(..., interpret=True)`` and
    its VJP on the same bf16 operands: ys, dx4, dW and dpeep in bf16,
    within 1e-2 of scale."""
    x4, w, peep, mask = _inputs(23, T=8)
    (jx, tx), (jw, tw), (jp, tp) = bf16(x4), bf16(w), bf16(peep)
    jmask = jnp.asarray(mask)
    cot = np.random.RandomState(24).randn(8, 4, 16).astype(np.float32)

    def jys(x, w_, p):
        if reversed_:
            return jnp.flip(pk.fused_lstm(jnp.flip(x, 0), jnp.flip(jmask, 0), w_, p, BF16_ACTS,
                                          True), 0)
        return pk.fused_lstm(x, jmask, w_, p, BF16_ACTS, True)

    jy, vjp = jax.vjp(jys, jx, jw, jp)
    want = vjp(bf16(cot)[0])
    leaves = [a.clone().requires_grad_() for a in (tx, tw, tp)]
    ys = tl.fused_lstm(leaves[0], torch.from_numpy(mask).to(torch.bfloat16), leaves[1],
                       leaves[2], reverse=reversed_, acts=BF16_ACTS)
    assert ys.dtype == torch.bfloat16
    assert_within_scale(ys, jy, "ys")
    (ys.float() * torch.from_numpy(cot)).sum().backward()
    for name, leaf, b in zip(("dx4", "dw", "dpeep"), leaves, want):
        assert leaf.grad.dtype == torch.bfloat16, name
        assert_within_scale(leaf.grad, b, name)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_the_kernels_refuse_other_operand_types(dtype):
    """Kernels 7a, 7b and 8 have a float32 and a bf16 instance: operands of
    another type, or of two types, are refused before any launch."""
    x4, w, peep, mask = _inputs(5)
    tx, tw, tp, tm = map(torch.from_numpy, (x4, w, peep, mask))
    for od in tl.OPERAND_DTYPES:
        tl._check_operands(tx.to(od), tm, tw.to(od), tp.to(od), tl.DEFAULT_ACTS)
    with pytest.raises(ValueError, match="float32 or bf16"):
        tl._check_operands(tx.to(dtype), tm, tw.to(dtype), tp.to(dtype), tl.DEFAULT_ACTS)
    _, saved, hprev, cprev = tl.lstm_forward_reference(tx, tm, tw, tp, residuals=True)
    with pytest.raises(ValueError, match="float32 or bf16"):
        tl._launch_bwd(torch.zeros(5, 4, 16, dtype=dtype), saved.to(dtype), hprev.to(dtype),
                       cprev, tm, tw.to(dtype), tp.to(dtype), False, tl.DEFAULT_ACTS)
    with pytest.raises(ValueError, match="w is torch.float32"):
        tl._check_operands(tx.bfloat16(), tm, tw, tp.bfloat16(), tl.DEFAULT_ACTS)


# ------------------------------------------- kernel 8's bf16 body for Hopper

SM90_CANCEL_FLOOR = 2.0 ** -11     # as tests/test_torch_flash_attention.py's


def _ulps(got, want, floor=SM90_CANCEL_FLOOR):
    """The largest |got - want| in bf16 spacings of the larger magnitude,
    taken at no less than ``floor`` of the scale
    (torch_bf16_checks.assert_within_one_ulp holds it to 1)."""
    got, want = f32(got), f32(want)
    big = np.maximum(np.maximum(np.abs(got), np.abs(want)), floor * np.abs(want).max())
    ulp = np.exp2(np.floor(np.log2(np.maximum(big, np.finfo(np.float32).tiny))) - 7)
    return float((np.abs(got - want) / ulp).max())


@pytest.mark.parametrize("reversed_", [False, True])
def test_sm90_two_piece_dw_matches_pallas(reversed_):
    """The Hopper body's arithmetic (``lstm_bwd_bf16_sm90``): dW summed from
    the gate gradients as two bf16 pieces, hi = bf16(g) (dx4 itself) and
    lo = bf16(g - hi), each product of bf16 operands summed in float32
    (``lstm_backward_reference(dw_pieces=2)``), against ``_run_bwd`` in
    interpret mode on bf16 operands at T = 8, B = 4, H = 64: dx4, dW and
    dpeep within one bf16 ulp, dW's taken at no less than SM90_CANCEL_FLOOR
    of its scale (a dW element that cancels far below its terms differs by
    several of its own ulps between two float32 summation orders: 6 in the
    reversed case, the plain float32 sums against Pallas'). The one-piece
    form (dW from hi alone) lies 187+ spacings off at the same floor."""
    T, B, H = 8, 4, 64
    x4, w, peep, mask = _inputs(31, T=T, B=B, H=H)
    flip = _flip(reversed_)
    (jw, tw), (jp, tp) = bf16(w), bf16(peep)
    jm = jnp.asarray(flip(mask))[:, :, None]
    res = pk._run_fwd(bf16(flip(x4))[0], jm, jw, jp, BF16_ACTS, True, residuals=True)
    dy = np.random.RandomState(32).randn(T, B, H).astype(np.float32)
    jdx, jdw, jdp = pk._run_bwd(bf16(flip(dy))[0], tuple(res[1:]), jm, jw, jp, BF16_ACTS, True)
    to_t = lambda a, dt: torch.from_numpy(flip(f32(a))).to(dt)
    args = (bf16(dy)[1], to_t(res[1], torch.bfloat16), to_t(res[2], torch.bfloat16),
            to_t(res[3], torch.float32), torch.from_numpy(mask), tw, tp, reversed_, BF16_ACTS)
    dx, dw, dp = tl.lstm_backward_reference(*args, dw_pieces=2)
    assert_within_one_ulp(dx, flip(f32(jdx)), "dx4")
    assert_within_one_ulp(dw, jdw, "dw", floor=SM90_CANCEL_FLOOR)
    assert_within_one_ulp(dp, jdp, "dpeep")
    two = _ulps(dw, jdw)
    one = _ulps(tl.lstm_backward_reference(*args, dw_pieces=1)[1], jdw)
    assert two <= 1.0 < one, (two, one)


def test_sm90_plan_mirrors_the_kernel_at_132_and_114_sms():
    """``sm90_plan`` (csrc/lstm_bwd_sm90.cu make_plan): at the classifier's
    B = 256, H = 512 blocks of 32 units, 16 a row group, 8 row groups of 32
    rows on 132 SMs (7 of 37 on 114); H = 1024 takes blocks of 16 units (32
    would hold 256 KB of w); H = 256 16 groups of 16 rows. H not a multiple
    of 64, and a batch whose rows' state overflows a block, have no plan:
    the persistent body keeps them."""
    plan = lambda B, H, sms: {k: v for k, v in tl.sm90_plan(B, H, sms).items()
                              if k in ("units_per_block", "blocks_per_group", "row_groups",
                                       "rows_per_group")}
    at = lambda U, G, P, R: dict(units_per_block=U, blocks_per_group=G, row_groups=P,
                                 rows_per_group=R)
    assert plan(256, 512, 132) == at(32, 16, 8, 32)
    assert plan(256, 512, 114) == at(32, 16, 7, 37)
    assert plan(256, 1024, 132) == at(16, 64, 2, 128)
    assert plan(256, 1024, 114) == at(16, 64, 1, 256)
    assert plan(256, 256, 132) == at(32, 8, 16, 16)
    assert plan(5, 64, 132) == at(32, 2, 5, 1)
    for sms in (132, 114):
        assert tl.sm90_plan(256, 512, sms)["smem_bytes"] <= tl.SMEM_LIMIT
        assert tl.sm90_plan(256, 520, sms) is None and tl.sm90_plan(256, 48, sms) is None
        assert tl.sm90_plan(0, 512, sms) is None
        assert tl.sm90_plan(8192, 1024, sms) is None


def test_sm90_route_takes_the_classifier_and_leaves_the_rest(monkeypatch):
    """``_launch_bwd`` picks the body by ``sm90_takes`` before any launch
    (the launch recorded in place of a build): bf16 at H = 64 and 128 takes
    ``lstm_bwd_bf16_sm90``; H = 48 and a w whose base is one element off 16
    bytes take ``lstm_bwd_bf16``; float32 takes ``lstm_bwd``. The bodies
    launched by name: ``_launch_bwd_persistent`` takes ``lstm_bwd_bf16``
    at any shape, an explicit row-group count included, and
    ``_launch_bwd_sm90`` on a shape it cannot take raises."""
    picked = []
    for kern in tl.KERNELS:
        monkeypatch.setattr(kern, "launch", lambda device, *a, _k=kern: picked.append(_k.symbol))

    def route(H, dtype=torch.bfloat16, w_off=0, launch=tl._launch_bwd, **kw):
        T, B = 3, 5
        x4, w, peep, mask = _inputs(33, T=T, B=B, H=H)
        tm = torch.from_numpy(mask)
        _, saved, hprev, cprev = tl.lstm_forward_reference(
            torch.from_numpy(x4), tm, torch.from_numpy(w), torch.from_numpy(peep),
            residuals=True)
        flat = torch.zeros(H * 4 * H + w_off, dtype=dtype)[w_off:]
        tw = flat.view(H, 4 * H)
        picked.clear()
        launch(torch.zeros(T, B, H, dtype=dtype), saved.to(dtype), hprev.to(dtype), cprev, tm,
               tw, torch.from_numpy(peep).to(dtype), False, BF16_ACTS, **kw)
        return tuple(picked)

    assert route(64) == ("lstm_bwd_bf16_sm90",)
    assert route(128) == ("lstm_bwd_bf16_sm90",)
    assert route(128, launch=tl._launch_bwd_sm90) == ("lstm_bwd_bf16_sm90",)
    assert route(48) == ("lstm_bwd_bf16",)
    assert route(64, w_off=1) == ("lstm_bwd_bf16",)
    assert route(64, launch=tl._launch_bwd_persistent, row_groups=1) == ("lstm_bwd_bf16",)
    assert route(64, launch=tl._launch_bwd_persistent) == ("lstm_bwd_bf16",)
    assert route(64, dtype=torch.float32) == ("lstm_bwd",)
    with pytest.raises(ValueError, match="lstm_bwd_bf16_sm90 takes"):
        route(48, launch=tl._launch_bwd_sm90)
    with pytest.raises(ValueError, match="lstm_bwd_bf16_sm90 takes"):
        route(64, dtype=torch.float32, launch=tl._launch_bwd_sm90)
