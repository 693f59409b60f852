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
from torch_bf16_checks import assert_within_one_ulp, assert_within_scale, f32
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


# ------------------------------------------------------------ bf16 operands

def _bf16_args(args):
    """The same float32 inputs rounded to bf16 on both sides (the decoder
    casts every operand, the masks and h0 included, to the operand dtype)."""
    return ([jnp.asarray(a).astype(jnp.bfloat16) for a in args],
            [torch.from_numpy(a).to(torch.bfloat16) for a in args])


def test_bf16_plain_versions_match_pallas_at_one_step():
    """At Td = 1 (from a nonzero h0) the bf16 plain forward and backward
    round where the Pallas kernels do in bf16 (h, ctx and r*h before their
    products; d_din, dcand, dg and d_m before theirs; d_ctx unrounded in the
    attention's backward), so every output, residual and gradient is within
    one bf16 ulp of the interpreted kernels."""
    args = _inputs(31, 1)
    args[4][:] = 1.0
    jargs, targs = _bf16_args(args)
    ref = jag._run_fwd(*jargs, ACTS, True, residuals=True)
    got = tag.attention_gru_reference(*targs, residuals=True)
    for name, a, b in zip(("ys", "hprev", "acts", "alpha", "ctx"), got, ref):
        assert a.dtype == torch.bfloat16, name
        assert_within_one_ulp(a, b, name)
    dy = (np.random.RandomState(32).randn(1, 3, 8)).astype(np.float32)
    jdy, tdy = jnp.asarray(dy).astype(jnp.bfloat16), torch.from_numpy(dy).to(torch.bfloat16)
    ep, ev, em, _, dmask, _, wa, ba, v, wctx, wg = jargs
    jout = jag._run_bwd(jdy, ep, ev, em, dmask, *ref[1:4], wa, ba, v, wctx, wg, ACTS, True)
    to_t = lambda a: torch.from_numpy(f32(a)).to(torch.bfloat16)
    tep, tev, _, _, tdm, _, twa, tba, tv, twctx, twg = targs
    tout = tag.attention_gru_backward_reference(tdy, tep, tev, tdm, *[to_t(a) for a in ref[1:4]],
                                                twa, tba, tv, twctx, twg)
    for name, a, b in zip(("dxw", "dctx", "dh0", "dep", "dwa", "dba", "dv"), tout, jout):
        assert a.dtype == (torch.bfloat16 if name in ("dxw", "dctx", "dh0") else torch.float32)
        assert_within_one_ulp(a, b, name)


def test_bf16_sequence_matches_pallas_within_scale():
    """Over Td = 4: ys, the residuals and all nine gradients (the CPU's bf16
    autograd Function: the plain forward and backward and the stream
    products) within 1e-2 of scale of the Pallas function in interpret
    mode in bf16."""
    import jax

    args = _inputs(33, 4)
    jargs, targs = _bf16_args(args)
    ref = jag._run_fwd(*jargs, ACTS, True, residuals=True)
    got = tag.attention_gru_reference(*targs, residuals=True)
    for name, a, b in zip(("ys", "hprev", "acts", "alpha", "ctx"), got, ref):
        assert_within_scale(a, b, name)
    cot = np.random.RandomState(34).randn(4, 3, 8).astype(np.float32)
    diff = (0, 1, 3, 5, 6, 7, 8, 9, 10)
    jg = jax.grad(lambda *a: jnp.sum(jag.fused_attention_gru(*a, ACTS, True)
                                     .astype(jnp.float32) * cot), diff)(*jargs)
    leaves = [a.clone().requires_grad_(i in diff) for i, a in enumerate(targs)]
    ys = tag.fused_attention_gru(*leaves)
    assert ys.dtype == torch.bfloat16
    (ys.float() * torch.from_numpy(cot)).sum().backward()
    names = ("dep", "dev", "dxw", "dh0", "dwa", "dba", "dv", "dwctx", "dwg")
    for name, i, b in zip(names, diff, jg):
        assert leaves[i].grad.dtype == torch.bfloat16, name
        assert_within_scale(leaves[i].grad, b, name)


@pytest.mark.parametrize("residuals", [True, False])
def test_the_kernels_take_bf16_where_a_path_launches_them(residuals):
    """Kernels 5 and 6 (training) take float32 and bf16 operands; kernel 4
    (the serve step, which stays float32) takes float32 alone. float16 is
    refused by both before any launch."""
    args = [torch.from_numpy(a) for a in _inputs(9, 2)]
    cast = lambda dt: [a.to(dt) for a in args]
    tag._check_operands(*cast(torch.float32), ACTS, residuals=residuals)
    refused = [torch.float16] + ([] if residuals else [torch.bfloat16])
    if residuals:
        tag._check_operands(*cast(torch.bfloat16), ACTS, residuals=True)
    for dt in refused:
        with pytest.raises(ValueError, match="do not take"):
            tag._check_operands(*cast(dt), ACTS, residuals=residuals)


# ------------------------------------------- kernel 6's bf16 body for Hopper

SM90_CANCEL_FLOOR = 2.0 ** -11     # as tests/test_torch_flash_attention.py's


def _ulps(got, want, floor=SM90_CANCEL_FLOOR):
    """The largest |got - want| in bf16 spacings of the larger magnitude,
    taken at no less than ``floor`` of the scale
    (torch_bf16_checks.assert_within_one_ulp holds it to 1)."""
    got, want = f32(got), f32(want)
    big = np.maximum(np.maximum(np.abs(got), np.abs(want)), floor * np.abs(want).max())
    ulp = np.exp2(np.floor(np.log2(np.maximum(big, np.finfo(np.float32).tiny))) - 7)
    return float((np.abs(got - want) / ulp).max())

@pytest.mark.parametrize("Td", [1, 4])
def test_sm90_product_order_matches_pallas(Td):
    """The Hopper body's arithmetic (``attention_gru_bwd_bf16_sm90``): every
    per-step product of bf16 operands summed in float32 with its
    contraction cut among eight warps and their sums added in order, DH's
    as one product over [dg | d_m], dWa from d_m's two bf16 pieces
    (``attention_gru_backward_reference(slices=8, dwa_pieces=2)``), against ``_run_bwd`` in interpret mode on bf16 operands
    at D = 256 (a width the body takes), E = 512: at Td = 1 every output
    within one bf16 ulp taken at no less than SM90_CANCEL_FLOOR of its
    scale (dWa's sums over D = 256 cancel to 6e-7, where two float32 orders
    differ by more than its own ulp), over Td = 4 within 1e-2 of scale;
    dWa from one piece of d_m (the control) lies past one spacing (186 and
    140 of them)."""
    args = _inputs(35, Td, Te=5, B=3, D=256, E=512)
    if Td == 1:
        args[4][:] = 1.0
    jargs, targs = _bf16_args(args)
    ref = jag._run_fwd(*jargs, ACTS, True, residuals=True)
    dy = (np.random.RandomState(36).randn(Td, 3, 256)).astype(np.float32)
    jdy, tdy = jnp.asarray(dy).astype(jnp.bfloat16), torch.from_numpy(dy).to(torch.bfloat16)
    ep, ev, em, _, dmask, _, wa, ba, v, wctx, wg = jargs
    jout = jag._run_bwd(jdy, ep, ev, em, dmask, *ref[1:4], wa, ba, v, wctx, wg, ACTS, True)
    to_t = lambda a: torch.from_numpy(f32(a)).to(torch.bfloat16)
    tep, tev, _, _, tdm, _, twa, tba, tv, twctx, twg = targs
    res = [to_t(a) for a in ref[1:4]]
    tout = tag.attention_gru_backward_reference(tdy, tep, tev, tdm, *res, twa, tba, tv, twctx,
                                                twg, slices=tag.SM90_WARPS, dwa_pieces=2)
    for name, a, b in zip(("dxw", "dctx", "dh0", "dep", "dwa", "dba", "dv"), tout, jout):
        if Td == 1:
            assert_within_one_ulp(a, b, name, floor=SM90_CANCEL_FLOOR)
        else:
            assert_within_scale(a, b, name)
    # dWa from d_m's two pieces against the one-piece control, in bf16
    # spacings of the Pallas kernel's float32 dWa
    one = tag.attention_gru_backward_reference(tdy, tep, tev, tdm, *res, twa, tba, tv, twctx,
                                               twg, slices=tag.SM90_WARPS, dwa_pieces=1)[4]
    two, one = _ulps(tout[4], jout[4]), _ulps(one, jout[4])
    assert two <= 1.0 < one, (two, one)


def test_sm90_plan_mirrors_the_kernel_at_132_and_114_sms():
    """``sm90_plan`` (csrc/attention_gru_bwd_sm90.cu make_plan): at the NMT
    decoder's B = 64, Te = 32, D = 512, E = 1024 four row groups of 32
    blocks (16 units, 32 rows of wctx, 16 rows each) on 132 SMs, one group
    of 64 blocks of 8 units on 114 (128 blocks do not fit); Te = 128 (its
    d_enc_proj sums past a block's shared memory), D no multiple of 256 and
    an E that leaves a block other than 8, 16 or 32 rows of wctx have no
    plan: the persistent body keeps them."""
    pick = lambda *a: {k: tag.sm90_plan(*a)[k] for k in
                       ("row_groups", "blocks_per_group", "units_per_block",
                        "wctx_rows_per_block", "rows_per_group")}
    assert pick(64, 32, 512, 1024, 132) == dict(row_groups=4, blocks_per_group=32,
                                                units_per_block=16, wctx_rows_per_block=32,
                                                rows_per_group=16)
    assert pick(64, 32, 512, 1024, 114) == dict(row_groups=1, blocks_per_group=64,
                                                units_per_block=8, wctx_rows_per_block=16,
                                                rows_per_group=64)
    assert pick(19, 9, 256, 1024, 132)["row_groups"] == 2
    for sms in (132, 114):
        assert tag.sm90_plan(64, 32, 512, 1024, sms)["smem_bytes"] <= tag.SMEM_LIMIT
        assert tag.sm90_plan(64, 128, 512, 1024, sms) is None
        assert tag.sm90_plan(64, 32, 384, 768, sms) is None
        assert tag.sm90_plan(3, 16, 512, 256, sms) is None
        assert tag.supported(64, 128, 512, 1024, sms)         # the persistent body takes it


def test_sm90_route_takes_the_nmt_width_and_leaves_the_rest(monkeypatch):
    """``_launch_bwd`` picks the body by ``sm90_takes`` before any launch
    (the launch recorded in place of a build): bf16 at D = 256 takes
    ``attention_gru_bwd_bf16_sm90``; D = 8, a wg whose base is one element
    off 16 bytes take ``attention_gru_bwd_bf16``; float32 takes
    ``attention_gru_bwd``. The bodies launched by name:
    ``_launch_bwd_persistent`` takes ``attention_gru_bwd_bf16`` at D = 256
    too, and ``_launch_bwd_sm90`` on a shape it cannot take raises."""
    picked = []
    for kern in tag.KERNELS:
        monkeypatch.setattr(kern, "launch", lambda device, *a, _k=kern: picked.append(_k.symbol))

    def route(D, E, dtype=torch.bfloat16, wg_off=0, launch=tag._launch_bwd):
        args = [torch.from_numpy(a).to(dtype) for a in _inputs(37, 2, Te=4, B=3, D=D, E=E)]
        ys, hprev, saved, alpha, ctxs = tag.attention_gru_reference(*args, residuals=True)
        ep, ev, _, _, dmask, _, wa, ba, v, wctx, wg = args
        wg = torch.cat([torch.zeros(wg_off, dtype=dtype), wg.flatten()])[wg_off:].view(wg.shape)
        m = torch.zeros(2, 3, D)
        picked.clear()
        launch(torch.zeros(2, 3, D, dtype=dtype), ep, ev, dmask, hprev, saved, alpha, m, wa, v,
               wctx, wg)
        return tuple(picked)

    assert route(256, 512) == ("attention_gru_bwd_bf16_sm90",)
    assert route(8, 16) == ("attention_gru_bwd_bf16",)
    assert route(256, 512, wg_off=1) == ("attention_gru_bwd_bf16",)
    assert route(256, 512, launch=tag._launch_bwd_sm90) == ("attention_gru_bwd_bf16_sm90",)
    assert route(256, 512, launch=tag._launch_bwd_persistent) == ("attention_gru_bwd_bf16",)
    assert route(256, 512, dtype=torch.float32) == ("attention_gru_bwd",)
    with pytest.raises(ValueError, match="attention_gru_bwd_bf16_sm90 takes"):
        route(8, 16, launch=tag._launch_bwd_sm90)
