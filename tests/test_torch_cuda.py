"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with nvcc (they build csrc/ at first use)
and skip without one. The repository's conftest imports JAX, so on a
machine with the card and no JAX run them without it:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Kernels 1-8 (GRU, attention GRU, LSTM; inference, training and backward;
the GRU and LSTM kernels with each of their four activations in each
slot), kernel 9 (the 1x1 conv with batch-norm statistics) and kernels 10-12
(flash attention, its dQ and its dK/dV), and the layers' routes: the
kernels for the configs their ``supported()`` accepts, the eager
computation (``EAGER_ROUTES``) for the others. Tolerance 1e-4
absolute in float32 with TF32 off (sums over K terms taken in another
order than the plain version's matmuls); gradients 1e-4 times max(1,
max |plain gradient|), since a weight gradient sums over every (step, row)
pair as well. Kernel 9's y is held to 1e-4 of max(1, max |y|) (sums of
up to 2048 products), its s and q to 1e-5 of Σ|y| and Σy² per channel.
The flash kernels' out and gradients are held to 1e-4 of max(1, max
|plain|), lse to 1e-4 absolute on rows that see a key.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu
TOL = 1e-4
GRU_ACTS = ("tanh", "sigmoid", "relu", "linear")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from paddle_tpu_torch.device import resolve_device

    return resolve_device(None)


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)


@pytest.mark.parametrize("T,B,H", [(7, 5, 40), (1, 1, 8), (3, 2, 600), (32, 64, 512),
                                   (32, 8, 512), (32, 1, 512), (2, 2, 2100), (2, 2700, 512)])
@pytest.mark.parametrize("reverse", [False, True])
def test_gru_kernel_matches_plain_version(dev, T, B, H, reverse):
    """Kernel 1 (the persistent forward without residuals) against its plain
    version, with ragged lengths and one all-masked row: at H = 600, 150
    unit groups over 132 SMs (two a block); the serve's prefill shape at
    B = 64, 8 and 1; at H = 2100 (four unit groups a block) and at B = 2700
    a block's columns of w do not fit beside the rows' state and stay in
    device memory. Two launches give the same bits, and ys equal kernel 2's
    bit for bit (one body, one order of sums)."""
    from paddle_tpu_torch.ops import fused_gru as fg

    rng = np.random.RandomState(T * 100 + H + B)
    # batch-major storage read through a time-major view, as the layer does
    x3 = _t(rng.randn(B, T, 3 * H) * 0.5, dev).transpose(0, 1)
    w = _t(rng.randn(H, 3 * H) / np.sqrt(H), dev)
    lens = rng.randint(1, T + 1, B)
    if B > 1:
        lens[-1] = 0                                  # an all-masked row
    mask = _t(np.arange(T)[:, None] < lens[None, :], dev)
    plan = fg.fwd_plan(B, H, fg.card_sms(dev))
    assert plan["w_in_smem"] == (H < 2100 and B < 2700)
    before = (fg.GRU_FWD.launches, fg.GRU_FWD_TRAIN.launches)
    got = fg.fused_gru(x3, mask, w, reverse=reverse)
    again = fg.fused_gru(x3, mask, w, reverse=reverse)
    assert (fg.GRU_FWD.launches, fg.GRU_FWD_TRAIN.launches) == (before[0] + 2, before[1])
    ys2, _, _ = fg._launch_fwd(x3, mask, w, reverse, fg.KERNEL_ACTS, residuals=True)
    ref = fg.gru_forward_reference(x3, mask, w, reverse=reverse)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert float((got - ref).abs().max()) <= TOL
    assert torch.equal(got, again) and torch.equal(got, ys2)
    if B > 1:
        assert not got[:, -1].any()


@pytest.mark.parametrize("Td,Te,B,D,E", [(3, 37, 4, 24, 40), (1, 1, 1, 8, 8), (2, 5, 3, 520, 1040)])
def test_attention_kernel_matches_plain_version(dev, Td, Te, B, D, E):
    from paddle_tpu_torch.ops.fused_attention_gru import (
        ATTENTION_GRU_FWD, attention_gru_reference, attention_gru_step, fused_attention_gru)

    rng = np.random.RandomState(Te * 10 + D)
    r = lambda *s: _t(rng.randn(*s) * 0.3, dev)
    lens = rng.randint(1, Te + 1, B)
    lens[-1] = 0                                      # an all-masked row
    em = _t((np.arange(Te)[:, None] < lens[None, :])[:, :, None], dev)
    ep = r(B, Te, D).transpose(0, 1)                  # strided, as the serve step passes it
    ev = r(B, Te, E).transpose(0, 1)
    args = (ep, ev, em, r(Td, B, 3 * D), _t(rng.rand(Td, B, 1) > 0.3, dev), r(B, D),
            r(D, D), r(1, D), r(1, D), r(E, 3 * D), r(D, 3 * D))
    before = ATTENTION_GRU_FWD.launches
    got = fused_attention_gru(*args)
    ref = attention_gru_reference(*args)
    step = attention_gru_step(args[5], ep, ev, em, args[3][0], *args[6:])
    torch.cuda.synchronize()
    assert ATTENTION_GRU_FWD.launches == before + 2
    assert torch.isfinite(got).all()
    assert float((got - ref).abs().max()) <= TOL
    assert float((step - ref[0]).abs().max()) <= TOL


def test_gru_kernel_raises_on_a_refused_shape(dev):
    """A batch whose rows' state no block can hold (fused_gru.supported
    refuses it): the light forward raises on the card and launches
    nothing; there is no other route inside the wrapper."""
    from paddle_tpu_torch.ops import fused_gru as fg

    T, B, H = 1, 4096, 1024
    assert not fg.supported(fg.KERNEL_ACTS, H, B, fg.card_sms(dev))
    x3 = torch.zeros(T, B, 3 * H, device=dev)
    mask = torch.ones(T, B, device=dev)
    w = torch.zeros(H, 3 * H, device=dev)
    before = [k.launches for k in fg.KERNELS]
    with torch.no_grad(), pytest.raises(ValueError, match="do not take"):
        fg.fused_gru(x3, mask, w)
    assert [k.launches for k in fg.KERNELS] == before


def _grad_tol(ref):
    return TOL * max(1.0, float(ref.abs().max()))


@pytest.mark.parametrize("T,B,H", [(7, 5, 40), (1, 2, 8), (3, 2, 600), (2, 2, 2100),
                                   (5, 1, 512), (5, 3, 512), (32, 64, 512), (5, 100, 512)])
@pytest.mark.parametrize("reverse", [False, True])
def test_gru_training_kernels_match_plain_version(dev, T, B, H, reverse):
    """Kernel 2 (the persistent training forward) and kernel 3 fed from its
    residuals. At H = 2100 a block's columns of w (kernel 2) and rows of w
    and of dW (kernel 3) do not fit in its shared memory (four unit groups
    a block): both keep them in device memory. B = 3 and 100 are not
    multiples of the 64-row tile; two launches of kernel 2 give the same
    bits; autograd launches kernels 2 and 3 once each and kernel 1 not."""
    from paddle_tpu_torch.ops import fused_gru as fg

    rng = np.random.RandomState(T * 1000 + H + reverse)
    x3 = _t(rng.randn(B, T, 3 * H) * 0.5, dev).transpose(0, 1)
    w = _t(rng.randn(H, 3 * H) / np.sqrt(H), dev)
    lens = rng.randint(1, T + 1, B)
    lens[-1] = 0                                      # a fully masked row
    mask = _t(np.arange(T)[:, None] < lens[None, :], dev)
    dy = _t(rng.randn(T, B, H), dev)

    got = fg._launch_fwd(x3, mask, w, reverse, fg.KERNEL_ACTS, residuals=True)
    again = fg._launch_fwd(x3, mask, w, reverse, fg.KERNEL_ACTS, residuals=True)
    ref = fg.gru_forward_reference(x3, mask, w, reverse, residuals=True)
    torch.cuda.synchronize()
    for name, a, b in zip(("ys", "acts", "hprev"), got, ref):
        assert torch.isfinite(a).all(), name
        assert float((a - b).abs().max()) <= TOL, name
    assert all(torch.equal(a, b) for a, b in zip(got, again))

    before = [k.launches for k in fg.KERNELS]
    leaves = [x3.detach().requires_grad_(), w.detach().requires_grad_()]
    (fg.fused_gru(leaves[0], mask, leaves[1], reverse=reverse) * dy).sum().backward()
    assert [k.launches for k in fg.KERNELS] == [before[0], before[1] + 1, before[2] + 1,
                                                *before[3:]]
    plain = [x3.detach().requires_grad_(), w.detach().requires_grad_()]
    (fg.gru_forward_reference(plain[0], mask, plain[1], reverse) * dy).sum().backward()
    torch.cuda.synchronize()
    for name, a, b in zip(("dx3", "dw"), leaves, plain):
        assert torch.isfinite(a.grad).all(), name
        assert float((a.grad - b.grad).abs().max()) <= _grad_tol(b.grad), name


def _decode_inputs(dev, Td, Te, B, D, E, seed):
    """Kernel 4's operands: ep and ev as transposed views of batch-major
    [B, Te, *] buffers (as the serve step passes its slot state), ragged
    encoder lengths with the last row all masked (B > 1), ragged dmask,
    weights at 1/sqrt(fan_in)."""
    rng = np.random.RandomState(seed)
    r = lambda *s: _t(rng.randn(*s) * 0.3, dev)
    w = lambda *s: _t(rng.randn(*s) / np.sqrt(s[0]), dev)
    lens = rng.randint(1, Te + 1, B)
    if B > 1:
        lens[-1] = 0                                  # an all-masked row
    em = _t((np.arange(Te)[:, None] < lens[None, :])[:, :, None], dev)
    return [r(B, Te, D).transpose(0, 1), r(B, Te, E).transpose(0, 1), em, r(Td, B, 3 * D),
            _t(rng.rand(Td, B, 1) > 0.3, dev), r(B, D), w(D, D), r(1, D), r(1, D),
            w(E, 3 * D), w(D, 3 * D)]


@pytest.mark.parametrize("Td", [1, 8, 32])
@pytest.mark.parametrize("B", [1, 3, 64, 100])
@pytest.mark.parametrize("Te", [1, 32, 128])
def test_attention_decode_kernel_matches_plain_version(dev, Td, B, Te):
    """Kernel 4 (the persistent grid without residuals) at the serve
    path's widths, D = 512 and E = 1024: ys within 1e-4 of the plain
    version, an all-masked row included; two launches give the same bits."""
    from paddle_tpu_torch.ops import fused_attention_gru as fa

    D, E = 512, 1024
    args = _decode_inputs(dev, Td, Te, B, D, E, seed=Td * 1000 + B * 10 + Te)
    before = fa.ATTENTION_GRU_FWD.launches
    got = fa.fused_attention_gru(*args)
    again = fa.fused_attention_gru(*args)
    ref = fa.attention_gru_reference(*args)
    torch.cuda.synchronize()
    assert fa.ATTENTION_GRU_FWD.launches == before + 2
    assert torch.isfinite(got).all()
    assert float((got - ref).abs().max()) <= TOL
    assert torch.equal(got, again)


def test_attention_serve_step_matches_the_plain_step(dev):
    """attention_gru_step at B = 64 (the serve path's slots): one launch of
    kernel 4, no eager route, within 1e-4 of the plain step."""
    from paddle_tpu_torch.ops import fused_attention_gru as fa

    Te, B, D, E = 32, 64, 512, 1024
    ep, ev, em, xw, _, h0, wa, ba, v, wctx, wg = _decode_inputs(dev, 1, Te, B, D, E, seed=9)
    before = (fa.ATTENTION_GRU_FWD.launches, fa.EAGER_ROUTES)
    got = fa.attention_gru_step(h0, ep, ev, em, xw[0], wa, ba, v, wctx, wg)
    ref = fa._step(h0, ep, ev, em, xw[0], wa, ba, v, wctx, wg, fa.KERNEL_ACTS)
    torch.cuda.synchronize()
    assert (fa.ATTENTION_GRU_FWD.launches, fa.EAGER_ROUTES) == (before[0] + 1, before[1])
    assert float((got - ref).abs().max()) <= TOL


def test_attention_serve_step_takes_the_plain_step_where_refused(dev):
    """A shape supported() refuses (B = 4096 rows of state) runs the plain
    step on the card, counted as an eager route: no launch that raises."""
    from paddle_tpu_torch.ops import fused_attention_gru as fa

    Te, B, D, E = 2, 4096, 8, 8
    assert not fa.supported(B, Te, D, E)
    ep, ev, em, xw, _, h0, wa, ba, v, wctx, wg = _decode_inputs(dev, 1, Te, B, D, E, seed=3)
    before = (fa.ATTENTION_GRU_FWD.launches, fa.EAGER_ROUTES)
    got = fa.attention_gru_step(h0, ep, ev, em, xw[0], wa, ba, v, wctx, wg)
    ref = fa._step(h0, ep, ev, em, xw[0], wa, ba, v, wctx, wg, fa.KERNEL_ACTS)
    assert (fa.ATTENTION_GRU_FWD.launches, fa.EAGER_ROUTES) == (before[0], before[1] + 1)
    assert torch.equal(got, ref)
    with pytest.raises(ValueError, match="do not take"):
        fa.fused_attention_gru(ep, ev, em, xw, _t(np.ones((1, B, 1)), dev), h0, wa, ba, v,
                               wctx, wg)


def _gru_bwd_case(dev, T, B, H, reverse, acts, seed, scale=0.5, wscale=1.0):
    """Kernel 3 against autograd of the plain version: dx3 and dW within
    1e-4 of max(1, max |plain|), with one length-0 row and padded steps;
    two launches of the kernel give the same bits."""
    from paddle_tpu_torch.ops import fused_gru as fg

    rng = np.random.RandomState(seed)
    x3 = _t(rng.randn(B, T, 3 * H) * scale, dev).transpose(0, 1)
    w = _t(rng.randn(H, 3 * H) * wscale / np.sqrt(H), dev)
    lens = rng.randint(1, T + 1, B)
    lens[0] = T                                       # a full row
    if B > 1:
        lens[-1] = 0                                  # a length-0 row
    mask = _t(np.arange(T)[:, None] < lens[None, :], dev)
    dy = _t(rng.randn(T, B, H), dev)
    _, saved, hprev = fg._launch_fwd(x3, mask, w, reverse, acts, residuals=True)
    before = fg.GRU_BWD.launches
    got = fg._launch_bwd(dy, saved, hprev, mask, w, reverse, acts)
    again = fg._launch_bwd(dy, saved, hprev, mask, w, reverse, acts)
    assert fg.GRU_BWD.launches == before + 2
    plain = [x3.detach().requires_grad_(), w.detach().requires_grad_()]
    ys = fg.gru_forward_reference(plain[0], mask, plain[1], reverse, acts)
    want = torch.autograd.grad(ys, plain, dy)
    torch.cuda.synchronize()
    for name, a, b in zip(("dx3", "dw"), got, want):
        assert torch.isfinite(a).all(), name
        assert float((a - b).abs().max()) <= _grad_tol(b), name
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    if B > 1:
        assert not got[0][:, -1].any()                # the length-0 row


@pytest.mark.parametrize("T", [1, 5, 32])
@pytest.mark.parametrize("B", [1, 3, 64, 100])
@pytest.mark.parametrize("H", [37, 512, 1024])
@pytest.mark.parametrize("reverse", [False, True])
def test_gru_backward_kernel_matches_autograd(dev, T, B, H, reverse):
    """Kernel 3 (the persistent grid, dW in the launch): H = 37 is not a
    multiple of the 4-unit group, B = 3 and 100 not of the 64-row tile, and
    at H = 1024 each block owns two unit groups."""
    from paddle_tpu_torch.ops import fused_gru as fg

    _gru_bwd_case(dev, T, B, H, reverse, fg.KERNEL_ACTS, seed=T * 100000 + B * 1000 + H)


@pytest.mark.parametrize("act_in", GRU_ACTS)
@pytest.mark.parametrize("act_gate", GRU_ACTS)
def test_gru_backward_kernel_takes_every_activation_at_full_width(dev, act_in, act_gate):
    """Kernel 3 at H = 512, T = 8, B = 64 with each activation pair (inputs
    and weights at a fifth of the default scale, as
    test_gru_kernels_take_every_activation explains)."""
    _gru_bwd_case(dev, 8, 64, 512, True, (act_in, act_gate),
                  seed=GRU_ACTS.index(act_in) * 4 + GRU_ACTS.index(act_gate),
                  scale=0.1, wscale=0.2)


def test_gru_backward_phase_clocks_leave_the_result_alone(dev):
    """Kernel 3 asked for its phase clocks: the same bits, and block 0's
    clock rising through every step's phases."""
    from paddle_tpu_torch.ops import fused_gru as fg

    T, B, H = 5, 64, 512
    rng = np.random.RandomState(11)
    x3 = _t(rng.randn(T, B, 3 * H) * 0.5, dev)
    w = _t(rng.randn(H, 3 * H) / np.sqrt(H), dev)
    mask = _t(np.ones((T, B)), dev)
    dy = _t(rng.randn(T, B, H), dev)
    _, saved, hprev = fg._launch_fwd(x3, mask, w, False, fg.KERNEL_ACTS, residuals=True)
    plain = fg._launch_bwd(dy, saved, hprev, mask, w, False, fg.KERNEL_ACTS)
    clocks = torch.zeros((T, 4), dtype=torch.int64, device=dev)
    clocked = fg._launch_bwd(dy, saved, hprev, mask, w, False, fg.KERNEL_ACTS, phase_ns=clocks)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(plain, clocked))
    flat = clocks.flatten()
    assert bool((flat[1:] >= flat[:-1]).all()) and int(flat[0]) > 0


def test_gru_backward_kernel_with_dw_rows_in_device_memory(dev):
    """H = 1024, B = 512: the rows' state leaves no room for dW's rows in
    shared memory, which the block then accumulates in device memory."""
    from paddle_tpu_torch.ops import fused_gru as fg

    plan = fg.grid_plan(512, 1024, fg.card_sms(dev))
    assert plan["w_in_smem"] and not plan["dw_in_smem"]
    _gru_bwd_case(dev, 3, 512, 1024, False, fg.KERNEL_ACTS, seed=7)


# The first design's cases keep their weights at 0.3 a draw. The others
# draw them at the initializer's 1/sqrt(fan_in): at 0.3 the 32-step
# recurrence at D = 512 is chaotic, and the plain version in float32 and in
# float64 end 2.0 apart on the same inputs.
_FIRST_DESIGN_CASES = {(3, 37, 4, 24, 40), (1, 1, 2, 8, 8), (2, 24, 3, 520, 1040)}


@pytest.mark.parametrize("Td,Te,B,D,E", [
    (3, 37, 4, 24, 40), (1, 1, 2, 8, 8), (2, 24, 3, 520, 1040),
    (32, 32, 64, 512, 1024),                        # the main path's shape
    (4, 128, 64, 512, 1024), (2, 256, 64, 512, 1024),   # refused by the first design
    (3, 9, 1, 40, 72), (3, 9, 3, 40, 72), (3, 9, 100, 40, 72),   # B; D, E not multiples of a slice
    (2, 5, 3, 600, 64),                             # two unit groups a block
    (2, 5, 3, 8, 72)])                              # several e-groups a block
def test_attention_training_kernels_match_plain_version(dev, Td, Te, B, D, E):
    """Kernels 5 and 6 (persistent grids). The last batch row's encoder
    positions are all masked and dmask is ragged; at Te = 256 the backward
    keeps d_enc_proj in its output, not in shared memory. Two launches of
    each give the same bits."""
    from paddle_tpu_torch.ops import fused_attention_gru as fa

    rng = np.random.RandomState(Td * 100 + D)
    r = lambda *s: _t(rng.randn(*s) * 0.3, dev)
    lens = rng.randint(1, Te + 1, B)
    lens[-1] = 0                                      # an all-masked row
    em = _t((np.arange(Te)[:, None] < lens[None, :])[:, :, None], dev)
    ep = r(B, Te, D).transpose(0, 1)                  # strided, as the decoder passes it
    ev = r(B, Te, E).transpose(0, 1)
    dmask = _t(rng.rand(Td, B, 1) > 0.3, dev)
    if (Td, Te, B, D, E) in _FIRST_DESIGN_CASES:
        w = r
    else:
        w = lambda *s: _t(rng.randn(*s) / np.sqrt(s[0]), dev)
    args = [ep, ev, em, r(Td, B, 3 * D), dmask, r(B, D),
            w(D, D), r(1, D), r(1, D), w(E, 3 * D), w(D, 3 * D)]
    dy = _t(rng.randn(Td, B, D), dev)

    got = fa._launch_fwd(*args, fa.KERNEL_ACTS, residuals=True)
    again = fa._launch_fwd(*args, fa.KERNEL_ACTS, residuals=True)
    ref = fa.attention_gru_reference(*args, residuals=True)
    torch.cuda.synchronize()
    for name, a, b in zip(("ys", "hprev", "acts", "alpha", "ctx"), got, ref):
        assert torch.isfinite(a).all(), name
        assert float((a - b).abs().max()) <= TOL, name
    m = got[5]                                        # saved for the backward
    assert float((m - (got[1] @ args[6] + args[7])).abs().max()) <= TOL
    assert all(torch.equal(a, b) for a, b in zip(got, again))

    diff = (0, 1, 3, 5, 6, 7, 8, 9, 10)               # not the masks
    names = ("dep", "dev", "dxw", "dh0", "dwa", "dba", "dv", "dwctx", "dwg")

    def grads(fn):
        leaves = [a.detach().requires_grad_(i in diff) for i, a in enumerate(args)]
        (fn(*leaves) * dy).sum().backward()
        return [leaves[i].grad for i in diff]

    before = (fa.ATTENTION_GRU_FWD_TRAIN.launches, fa.ATTENTION_GRU_BWD.launches)
    gk = grads(fa.fused_attention_gru)
    assert (fa.ATTENTION_GRU_FWD_TRAIN.launches, fa.ATTENTION_GRU_BWD.launches) == \
        (before[0] + 1, before[1] + 1)
    gk2 = grads(fa.fused_attention_gru)
    gr = grads(fa.attention_gru_reference)
    torch.cuda.synchronize()
    for name, a, b in zip(names, gk, gr):
        assert torch.isfinite(a).all(), name
        assert float((a - b).abs().max()) <= _grad_tol(b), name
    assert all(torch.equal(a, b) for a, b in zip(gk, gk2))


def test_attention_training_kernels_raise_on_a_refused_shape(dev):
    """A shape supported() refuses (here the per-row state of B = 4096 rows
    passes a block's shared memory) raises from the wrappers: there is no
    fallback."""
    from paddle_tpu_torch.ops import fused_attention_gru as fa

    Td, Te, B, D, E = 1, 2, 4096, 8, 8
    assert not fa.supported(B, Te, D, E)
    rng = np.random.RandomState(0)
    r = lambda *s: _t(rng.randn(*s) * 0.3, dev)
    args = [r(Te, B, D), r(Te, B, E), _t(np.ones((Te, B, 1)), dev), r(Td, B, 3 * D),
            _t(np.ones((Td, B, 1)), dev), r(B, D), r(D, D), r(1, D), r(1, D),
            r(E, 3 * D), r(D, 3 * D)]
    before = fa.ATTENTION_GRU_FWD_TRAIN.launches
    with pytest.raises(ValueError, match="do not take"):
        fa._launch_fwd(*args, fa.KERNEL_ACTS, residuals=True)
    leaves = [a.requires_grad_(i in (0, 3)) for i, a in enumerate(args)]
    with pytest.raises(ValueError, match="do not take"):
        fa.fused_attention_gru(*leaves)
    assert fa.ATTENTION_GRU_FWD_TRAIN.launches == before


def test_nmt_step_with_long_sources_takes_the_kernels(dev):
    """One Adam step of the seqToseq model at the demo's widths (dim 512,
    B = 64) on 128-token sources: the first design's backward could not
    hold Te = 128; the route takes kernels 5 and 6 and no loop."""
    from paddle_tpu_torch.flagship import nmt_batch, nmt_config
    from paddle_tpu_torch.ops import fused_attention_gru as fa
    from paddle_tpu_torch.trainer import Trainer

    trainer = Trainer(nmt_config(vocab=1000, dim=512, batch_size=64))
    batch = nmt_batch(vocab=1000, B=64, T=128, seed=1, device=dev)
    assert batch["source_language_word"].ids.shape[1] == 128
    before = (fa.ATTENTION_GRU_FWD_TRAIN.launches, fa.ATTENTION_GRU_BWD.launches,
              fa.EAGER_ROUTES)
    loss = float(trainer.train_one_batch(batch))
    torch.cuda.synchronize()
    assert np.isfinite(loss)
    assert (fa.ATTENTION_GRU_FWD_TRAIN.launches, fa.ATTENTION_GRU_BWD.launches,
            fa.EAGER_ROUTES) == (before[0] + 1, before[1] + 1, before[2])


LSTM_ACTS = [("tanh", "sigmoid", "sigmoid"), ("relu", "sigmoid", "tanh"),
             ("linear", "sigmoid", "linear")]
# kernel 8's grid at every width and batch: T = 1 and 3, B not a multiple
# of 64 or of the row groups (H = 37: ten unit groups, the last short)
_LSTM_GRID_CASES = [(1 if B == 1 else 3, B, H) for B in (1, 3, 40, 100, 256)
                    for H in (8, 37, 130, 512, 600, 1024)]


@pytest.mark.parametrize("acts", LSTM_ACTS)
@pytest.mark.parametrize("T,B,H", [(7, 5, 40), (1, 1, 8), (3, 2, 600), (4, 40, 130)]
                         + _LSTM_GRID_CASES)
@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_kernels_match_plain_version(dev, T, B, H, reverse, acts):
    """Kernels 7a, 7b and 8. All three run as many row groups as
    fused_lstm.grid_plan chooses (B of them at B <= 3, six groups of no
    rows at B = 40, H = 37), the forwards with 4 or 8 units a block (their
    last unit group short at H = 37, 130 and 600, and 7b then carrying h
    in its scratch: H % 4 != 0 at H = 37), kernel 8 with bundles of 4 or 8
    units and at H = 1024 dW's rows in device memory; the last row is all
    masked."""
    from paddle_tpu_torch.ops import fused_lstm as fl

    rng = np.random.RandomState(T * 1000 + H + reverse)
    # batch-major storage read through a time-major view, as the layer does
    x4 = _t(rng.randn(B, T, 4 * H) * 0.5, dev).transpose(0, 1)
    w = _t(rng.randn(H, 4 * H) / np.sqrt(H), dev)
    peep = _t(rng.randn(3, H) * 0.1, dev)
    lens = rng.randint(1, T + 1, B)
    lens[-1] = 0
    mask = _t(np.arange(T)[:, None] < lens[None, :], dev)
    dy = _t(rng.randn(T, B, H), dev)

    before = fl.LSTM_FWD.launches
    ys = fl.fused_lstm(x4, mask, w, peep, reverse=reverse, acts=acts)
    assert fl.LSTM_FWD.launches == before + 1
    got = fl._launch_fwd(x4, mask, w, peep, reverse, acts, residuals=True)
    ref = fl.lstm_forward_reference(x4, mask, w, peep, reverse, acts, residuals=True)
    torch.cuda.synchronize()
    assert float((ys - ref[0]).abs().max()) <= TOL
    for name, a, b in zip(("ys", "acts", "hprev", "cprev"), got, ref):
        assert torch.isfinite(a).all(), name
        assert float((a - b).abs().max()) <= TOL, name

    def grads(fn):
        leaves = [a.detach().requires_grad_() for a in (x4, w, peep)]
        (fn(leaves[0], mask, leaves[1], leaves[2], reverse=reverse, acts=acts) * dy).sum().backward()
        return [a.grad for a in leaves]

    before = (fl.LSTM_FWD_TRAIN.launches, fl.LSTM_BWD.launches)
    gk = grads(fl.fused_lstm)
    assert (fl.LSTM_FWD_TRAIN.launches, fl.LSTM_BWD.launches) == (before[0] + 1, before[1] + 1)
    gr = grads(fl.lstm_forward_reference)
    torch.cuda.synchronize()
    for name, a, b in zip(("dx4", "dw", "dpeep"), gk, gr):
        assert torch.isfinite(a).all(), name
        assert float((a - b).abs().max()) <= _grad_tol(b), name
    assert not gk[0][:, -1].any()                     # the masked row gets nothing


def _lstm_fwd_inputs(dev, T, B, H, seed):
    """Kernels 7a and 7b's operands as the layer passes them (x4 a
    time-major view of batch-major storage), ragged lengths with one full
    row and one of length 0, weights at 1/sqrt(H); and the plain version's
    ys, acts, hprev and cprev, forward and reversed."""
    from paddle_tpu_torch.ops import fused_lstm as fl

    rng = np.random.RandomState(seed)
    x4 = _t(rng.randn(B, T, 4 * H) * 0.5, dev).transpose(0, 1)
    w = _t(rng.randn(H, 4 * H) / np.sqrt(H), dev)
    peep = _t(rng.randn(3, H) * 0.1, dev)
    lens = rng.randint(1, T + 1, B) if T else np.zeros(B, np.int64)
    lens[0] = T
    if B > 1:
        lens[-1] = 0
    mask = _t(np.arange(T)[:, None] < lens[None, :], dev)
    refs = {rev: fl.lstm_forward_reference(x4, mask, w, peep, rev, residuals=True)
            for rev in (False, True)}
    return x4, w, peep, mask, refs


def _assert_fwd(got, ref, names=("ys", "acts", "hprev", "cprev")):
    torch.cuda.synchronize()
    for name, a, b in zip(names, got, ref):
        assert a.shape == b.shape and torch.isfinite(a).all(), name
        assert a.numel() == 0 or float((a - b).abs().max()) <= TOL, name


def test_lstm_forwards_are_deterministic_at_the_classifier_shape(dev):
    """T = 64, B = 256, H = 512 (four row groups of 32 blocks, 16 units and
    64 rows a block, w's columns in shared memory): two launches of 7a and
    of 7b give the same bits, within 1e-4 of the plain version, forward and
    reversed; 7a equals 7b's ys (one body)."""
    from paddle_tpu_torch.ops import fused_lstm as fl

    T, B, H = 64, 256, 512
    plan = fl.fwd_plan(B, H, fl.card_sms(dev))
    assert (plan["row_groups"], plan["units_per_block"], plan["w_in_smem"]) == (4, 16, 1)
    x4, w, peep, mask, refs = _lstm_fwd_inputs(dev, T, B, H, seed=31)
    for reverse in (False, True):
        for residuals in (False, True):
            one = fl._launch_fwd(x4, mask, w, peep, reverse, fl.DEFAULT_ACTS, residuals)
            two = fl._launch_fwd(x4, mask, w, peep, reverse, fl.DEFAULT_ACTS, residuals)
            one, two = (one, two) if residuals else ((one,), (two,))
            _assert_fwd(one, refs[reverse])
            assert all(torch.equal(a, b) for a, b in zip(one, two)), (reverse, residuals)
        light = fl._launch_fwd(x4, mask, w, peep, reverse, fl.DEFAULT_ACTS, False)
        assert torch.equal(light, one[0])


def test_lstm_forwards_take_every_row_groups_that_fits(dev):
    """T = 4, B = 6, H = 20 (five unit groups): every P from 1 to the SM
    count (most row groups then hold no row, some blocks several unit
    groups), 7a and 7b against the plain version, forward and reversed."""
    from paddle_tpu_torch.ops import fused_lstm as fl

    T, B, H = 4, 6, 20
    x4, w, peep, mask, refs = _lstm_fwd_inputs(dev, T, B, H, seed=37)
    sms = fl.card_sms(dev)
    for P in range(1, sms + 1):
        assert fl.fwd_plan(B, H, sms, P)["smem_bytes"] <= fl.SMEM_LIMIT
        reverse = bool(P % 2)
        _assert_fwd(fl._launch_fwd(x4, mask, w, peep, reverse, fl.DEFAULT_ACTS, True,
                                   row_groups=P), refs[reverse])
        _assert_fwd((fl._launch_fwd(x4, mask, w, peep, reverse, fl.DEFAULT_ACTS, False,
                                    row_groups=P),), refs[reverse])


def test_lstm_forwards_with_w_columns_in_device_memory(dev):
    """H = 1024, B = 1536 (the gate's edge at 132 SMs): the rows' state
    leaves no room for a block's columns of w in shared memory, which it
    then keeps in device memory; 7a and 7b against the plain version."""
    from paddle_tpu_torch.ops import fused_lstm as fl

    T, B, H = 2, 1536, 1024
    assert fl.supported(fl.DEFAULT_ACTS, H, B, fl.card_sms(dev))
    assert not fl.fwd_plan(B, H, fl.card_sms(dev))["w_in_smem"]
    x4, w, peep, mask, refs = _lstm_fwd_inputs(dev, T, B, H, seed=43)
    for reverse in (False, True):
        _assert_fwd(fl._launch_fwd(x4, mask, w, peep, reverse, fl.DEFAULT_ACTS, True),
                    refs[reverse])
        _assert_fwd((fl._launch_fwd(x4, mask, w, peep, reverse, fl.DEFAULT_ACTS, False),),
                    refs[reverse])


@pytest.mark.parametrize("acts", LSTM_ACTS)
@pytest.mark.parametrize("T", [0, 1])
@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_forwards_of_zero_and_one_steps(dev, T, reverse, acts):
    """T = 0 (no step: an empty result, a launch counted) and T = 1 (no
    carry read, 7b's hprev all 0), with each activation triple, at B = 5,
    H = 37 (7b's carry in its scratch) and B = 3, H = 64 (in hprev)."""
    from paddle_tpu_torch.ops import fused_lstm as fl

    for B, H in ((5, 37), (3, 64)):
        rng = np.random.RandomState(T * 100 + H)
        # dense strides also where T = 0 (numpy's empty arrays have others)
        x4 = torch.empty((T, B, 4 * H), device=dev).copy_(_t(rng.randn(T, B, 4 * H) * 0.5, dev))
        w = _t(rng.randn(H, 4 * H) / np.sqrt(H), dev)
        peep = _t(rng.randn(3, H) * 0.1, dev)
        mask = torch.ones((T, B), device=dev)
        ref = fl.lstm_forward_reference(x4, mask, w, peep, reverse, acts, residuals=True)
        before = (fl.LSTM_FWD.launches, fl.LSTM_FWD_TRAIN.launches)
        got = fl._launch_fwd(x4, mask, w, peep, reverse, acts, True)
        light = fl._launch_fwd(x4, mask, w, peep, reverse, acts, False)
        assert (fl.LSTM_FWD.launches, fl.LSTM_FWD_TRAIN.launches) == (before[0] + 1, before[1] + 1)
        _assert_fwd(got, ref)
        _assert_fwd((light,), ref)
        assert not got[2].any()                      # hprev: the first carry is 0


def test_lstm_forward_phase_clocks_leave_the_result_alone(dev):
    """Kernel 7b asked for its phase clocks: the same bits, and block 0's
    clock rising through every step's product and cells."""
    from paddle_tpu_torch.ops import fused_lstm as fl

    T = 5
    x4, w, peep, mask, _ = _lstm_fwd_inputs(dev, T, 64, 512, seed=47)
    plain = fl._launch_fwd(x4, mask, w, peep, False, fl.DEFAULT_ACTS, True)
    clocks = torch.zeros((T, 3), dtype=torch.int64, device=dev)
    clocked = fl._launch_fwd(x4, mask, w, peep, False, fl.DEFAULT_ACTS, True, phase_ns=clocks)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(plain, clocked))
    flat = clocks.flatten()
    assert bool((flat[1:] >= flat[:-1]).all()) and int(flat[0]) > 0


def _lstm_bwd_inputs(dev, T, B, H, seed, acts=None):
    """Kernel 8's operands from kernel 7b's residuals: ragged lengths with
    one full row and one of length 0, weights at 1/sqrt(H)."""
    from paddle_tpu_torch.ops import fused_lstm as fl

    acts = acts or fl.DEFAULT_ACTS
    rng = np.random.RandomState(seed)
    x4 = _t(rng.randn(B, T, 4 * H) * 0.5, dev).transpose(0, 1)
    w = _t(rng.randn(H, 4 * H) / np.sqrt(H), dev)
    peep = _t(rng.randn(3, H) * 0.1, dev)
    lens = rng.randint(1, T + 1, B)
    lens[0] = T
    if B > 1:
        lens[-1] = 0
    mask = _t(np.arange(T)[:, None] < lens[None, :], dev)
    dy = _t(rng.randn(T, B, H), dev)
    _, saved, hprev, cprev = fl._launch_fwd(x4, mask, w, peep, False, acts, True)
    return x4, w, peep, mask, dy, (dy, saved, hprev, cprev, mask, w, peep, False, acts)


def _lstm_bwd_against_autograd(dev, x4, w, peep, mask, dy, got, acts=None):
    from paddle_tpu_torch.ops import fused_lstm as fl

    plain = [a.detach().requires_grad_() for a in (x4, w, peep)]
    ys = fl.lstm_forward_reference(plain[0], mask, plain[1], plain[2], False,
                                   acts or fl.DEFAULT_ACTS)
    want = torch.autograd.grad(ys, plain, dy)
    torch.cuda.synchronize()
    for name, a, b in zip(("dx4", "dw", "dpeep"), got, want):
        assert torch.isfinite(a).all(), name
        assert float((a - b).abs().max()) <= _grad_tol(b), name


def test_lstm_backward_is_deterministic_at_the_classifier_shape(dev):
    """T = 64, B = 256, H = 512 (two row groups of 64 blocks, 8 units a
    block): two launches of kernel 8 give the same bits, within 1e-4 of
    scale of autograd through the plain version."""
    from paddle_tpu_torch.ops import fused_lstm as fl

    T, B, H = 64, 256, 512
    assert fl.grid_plan(B, H, fl.card_sms(dev))["row_groups"] == 2
    x4, w, peep, mask, dy, args = _lstm_bwd_inputs(dev, T, B, H, seed=17)
    one = fl._launch_bwd(*args)
    two = fl._launch_bwd(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(one, two))
    _lstm_bwd_against_autograd(dev, x4, w, peep, mask, dy, one)


@pytest.mark.parametrize("row_groups", [1, 3, 7])
def test_lstm_backward_takes_any_row_groups(dev, row_groups):
    """Kernel 8 with its row groups set by hand (7 leaves the last group
    short) agrees with autograd; the runtime-code instance agrees with the
    default activations' template."""
    from paddle_tpu_torch.ops import fused_lstm as fl

    x4, w, peep, mask, dy, args = _lstm_bwd_inputs(dev, 5, 40, 96, seed=row_groups)
    got = fl._launch_bwd_persistent(*args, row_groups=row_groups)
    _lstm_bwd_against_autograd(dev, x4, w, peep, mask, dy, got)
    generic = fl._launch_bwd_persistent(*args, row_groups=row_groups, runtime_acts=True)
    torch.cuda.synchronize()
    for a, b in zip(got, generic):
        assert float((a - b).abs().max()) <= _grad_tol(b)


def test_lstm_backward_with_w_and_dw_rows_in_device_memory(dev):
    """H = 1024, B = 1024: the rows' state leaves no room for w's or dW's
    rows in shared memory, which the block then keeps in device memory."""
    from paddle_tpu_torch.ops import fused_lstm as fl

    plan = fl.grid_plan(1024, 1024, fl.card_sms(dev))
    assert not plan["w_in_smem"] and not plan["dw_in_smem"]
    x4, w, peep, mask, dy, args = _lstm_bwd_inputs(dev, 2, 1024, 1024, seed=23)
    got = fl._launch_bwd(*args)
    _lstm_bwd_against_autograd(dev, x4, w, peep, mask, dy, got)


def test_lstm_backward_of_an_empty_sequence_is_zero(dev):
    """T = 0: kernel 8 still launches and writes dW = 0 and dpeep = 0."""
    from paddle_tpu_torch.ops import fused_lstm as fl

    H, B = 40, 3
    w = torch.randn(H, 4 * H, device=dev)
    peep = torch.randn(3, H, device=dev)
    empty = torch.zeros(0, B, H, device=dev)
    before = fl.LSTM_BWD.launches
    dx4, dw, dpeep = fl._launch_bwd(empty, torch.zeros(0, B, 4 * H, device=dev), empty, empty,
                                    torch.zeros(0, B, device=dev), w, peep, False,
                                    fl.DEFAULT_ACTS)
    torch.cuda.synchronize()
    assert fl.LSTM_BWD.launches == before + 1
    assert dx4.shape == (0, B, 4 * H) and not dw.any() and not dpeep.any()


def test_lstm_backward_phase_clocks_leave_the_result_alone(dev):
    """Kernel 8 asked for its phase clocks: the same bits, and block 0's
    clock rising through every step's phases."""
    from paddle_tpu_torch.ops import fused_lstm as fl

    T = 5
    _, _, _, _, _, args = _lstm_bwd_inputs(dev, T, 64, 512, seed=29)
    plain = fl._launch_bwd(*args)
    clocks = torch.zeros((T, 3), dtype=torch.int64, device=dev)
    clocked = fl._launch_bwd(*args, phase_ns=clocks)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(plain, clocked))
    flat = clocks.flatten()
    assert bool((flat[1:] >= flat[:-1]).all()) and int(flat[0]) > 0


def test_lstm_kernels_are_deterministic(dev):
    """No atomics: two backward runs give bit-equal gradients."""
    from paddle_tpu_torch.ops import fused_lstm as fl

    rng = np.random.RandomState(5)
    T, B, H = 6, 40, 96
    x4 = _t(rng.randn(T, B, 4 * H) * 0.5, dev)
    w = _t(rng.randn(H, 4 * H) / np.sqrt(H), dev)
    peep = _t(rng.randn(3, H) * 0.1, dev)
    mask = _t(np.arange(T)[:, None] < rng.randint(1, T + 1, B)[None, :], dev)
    dy = _t(rng.randn(T, B, H), dev)
    _, saved, hprev, cprev = fl._launch_fwd(x4, mask, w, peep, False, fl.DEFAULT_ACTS, True)
    one = fl._launch_bwd(dy, saved, hprev, cprev, mask, w, peep, False, fl.DEFAULT_ACTS)
    two = fl._launch_bwd(dy, saved, hprev, cprev, mask, w, peep, False, fl.DEFAULT_ACTS)
    for a, b in zip(one, two):
        assert torch.equal(a, b)


def test_inference_keeps_the_light_kernels(dev):
    """Without a gradient to take, the layers launch kernels 1, 4 and 7a."""
    from paddle_tpu_torch.ops import fused_gru as fg
    from paddle_tpu_torch.ops import fused_lstm as fl

    x3 = torch.zeros(2, 3, 12, device=dev, requires_grad=True)
    mask = torch.ones(2, 3, device=dev)
    w = torch.zeros(4, 12, device=dev)
    before = (fg.GRU_FWD.launches, fg.GRU_FWD_TRAIN.launches)
    with torch.no_grad():
        fg.fused_gru(x3, mask, w)
    assert (fg.GRU_FWD.launches, fg.GRU_FWD_TRAIN.launches) == (before[0] + 1, before[1])

    x4 = torch.zeros(2, 3, 16, device=dev, requires_grad=True)
    w4 = torch.zeros(4, 16, device=dev, requires_grad=True)
    peep = torch.zeros(3, 4, device=dev)
    before = [k.launches for k in fl.KERNELS]
    with torch.no_grad():
        fl.fused_lstm(x4, mask, w4, peep)
    assert [k.launches for k in fl.KERNELS] == [before[0] + 1, *before[1:]]


def test_lstm_test_pass_launches_only_the_light_kernel(dev):
    """Trainer.test on the card: one lstm_fwd per batch, no training kernel."""
    from paddle_tpu_torch.flagship import example_batch, flagship_config
    from paddle_tpu_torch.ops import fused_lstm as fl
    from paddle_tpu_torch.trainer import Trainer

    trainer = Trainer(flagship_config(dict_dim=50, emb_dim=8, hidden=16))
    before = [k.launches for k in fl.KERNELS]
    out = trainer.test_batches([example_batch(50, B=4, T=6, seed=s, device=dev) for s in range(3)])
    assert np.isfinite(out["cost"])
    assert [k.launches for k in fl.KERNELS] == [before[0] + 3, *before[1:]]


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    from paddle_tpu_torch.ops.fused_gru import fused_gru

    x3 = torch.zeros(2, 3, 12, device=dev)
    mask = torch.ones(2, 3, device=dev)
    w = torch.zeros(4, 12, device=dev)
    with pytest.raises(ValueError, match="float32"):
        fused_gru(x3.double(), mask, w)
    with pytest.raises(ValueError, match="is on"):
        fused_gru(x3, mask, w.cpu())
    with pytest.raises(ValueError, match="activations"):
        fused_gru(x3, mask, w, acts=("softmax", "sigmoid"))
    with pytest.raises(ValueError, match="float32"):             # the training path too
        fused_gru(x3.double().requires_grad_(), mask, w.double())


def test_lstm_wrapper_raises_on_what_the_kernels_do_not_take(dev):
    from paddle_tpu_torch.ops.fused_lstm import fused_lstm

    x4 = torch.zeros(2, 3, 16, device=dev)
    mask = torch.ones(2, 3, device=dev)
    w = torch.zeros(4, 16, device=dev)
    peep = torch.zeros(3, 4, device=dev)
    with pytest.raises(ValueError, match="float32"):
        fused_lstm(x4.double(), mask, w, peep)
    with pytest.raises(ValueError, match="is on"):
        fused_lstm(x4, mask, w, peep.cpu())
    with pytest.raises(ValueError, match="activations"):
        fused_lstm(x4, mask, w, peep, acts=("tanh", "softmax", "tanh"))
    with pytest.raises(ValueError, match="last dimension"):
        fused_lstm(torch.zeros(2, 16, 3, device=dev).transpose(1, 2), mask, w, peep)
    with pytest.raises(ValueError, match="H <= 1024"):
        fused_lstm(torch.zeros(1, 1, 4100, device=dev), torch.ones(1, 1, device=dev),
                   torch.zeros(1025, 4100, device=dev), torch.zeros(3, 1025, device=dev))
    with pytest.raises(ValueError, match="float32"):             # the training path too
        fused_lstm(x4.double().requires_grad_(), mask, w.double(), peep.double())


def _conv_inputs(M, K, N, dev, seed=0):
    rng = np.random.RandomState(seed + M + K + N)
    x = _t(rng.randn(M, K), dev)
    w = _t(rng.randn(N, K) / np.sqrt(K), dev)
    b = _t(rng.randn(N) * 0.1, dev)
    return x, w, b


@pytest.mark.parametrize("M,K,N", [(1, 1, 1), (37, 5, 3), (1000, 64, 64), (3136, 2048, 512),
                                   (513, 130, 200)])
@pytest.mark.parametrize("bias", [False, True])
def test_conv1x1_stats_kernel_matches_plain_version(dev, M, K, N, bias):
    from paddle_tpu_torch.ops import fused_conv1x1_bn as fc

    x, w, b = _conv_inputs(M, K, N, dev)
    b = b if bias else None
    before = fc.CONV1X1_STATS.launches
    y, s, q = fc.conv1x1_stats(x, w, b)
    assert fc.CONV1X1_STATS.launches == before + 1
    yr, sr, qr = fc.conv1x1_stats_reference(x, w, b)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all()
    assert float((y - yr).abs().max()) <= TOL * max(1.0, float(yr.abs().max()))
    assert ((s - sr).abs() <= 1e-5 * yr.abs().sum(0) + 1e-30).all()
    assert ((q - qr).abs() <= 1e-5 * qr + 1e-30).all()
    # the backward: random cotangents on y, s and q, against autograd
    # through the plain version
    rng = np.random.RandomState(M)
    cts = [_t(rng.randn(*t.shape), dev) for t in (y, s, q)]
    leaves = [t.detach().requires_grad_() for t in (x, w, b) if t is not None]
    kg = torch.autograd.grad(fc.conv1x1_stats(*leaves, *([] if bias else [None])), leaves, cts)
    plain = [t.detach().requires_grad_() for t in leaves]
    pg = torch.autograd.grad(fc.conv1x1_stats_reference(*plain, *([] if bias else [None])),
                             plain, cts)
    torch.cuda.synchronize()
    for a, r in zip(kg, pg):
        assert float((a - r).abs().max()) <= _grad_tol(r)


@pytest.mark.parametrize("M,K,N", [(1000, 64, 64), (777, 256, 130)])
def test_conv1x1_stats_kernel_takes_an_unaligned_x(dev, M, K, N):
    """x one float past a 16-byte boundary: the kernel's producer fills its
    stages with 4-byte copies in place of TMA, and the results match."""
    from paddle_tpu_torch.ops import fused_conv1x1_bn as fc

    x, w, b = _conv_inputs(M, K, N, dev, seed=3)
    buf = torch.empty(M * K + 1, device=dev)
    xu = buf[1:].view(M, K)
    xu.copy_(x)
    assert xu.data_ptr() % 16 != 0
    y, s, q = fc.conv1x1_stats(xu, w, b)
    yr, sr, qr = fc.conv1x1_stats_reference(x, w, b)
    torch.cuda.synchronize()
    assert float((y - yr).abs().max()) <= TOL * max(1.0, float(yr.abs().max()))
    assert ((s - sr).abs() <= 1e-5 * yr.abs().sum(0) + 1e-30).all()
    assert ((q - qr).abs() <= 1e-5 * qr + 1e-30).all()
    for a, r in zip((y, s, q), fc.conv1x1_stats(x, w, b)):
        assert torch.equal(a, r)


# The nine (M, K, N) of ResNet-50's 1x1 stride-1 convs at 224² and batch 64
# (chip_smoke.conv_shapes), the main path's shapes of kernel 9.
RESNET_CONV_SHAPES = [(4096, 512, 2048), (4096, 2048, 512), (14400, 256, 1024),
                      (14400, 1024, 256), (53824, 128, 512), (53824, 512, 128),
                      (207936, 64, 64), (207936, 64, 256), (207936, 256, 64)]


@pytest.mark.parametrize("M,K,N", RESNET_CONV_SHAPES)
def test_conv1x1_stats_kernel_at_resnet_shapes(dev, M, K, N):
    """Kernel 9 at the ResNet-50 train step's shapes, with and without a
    bias, against its plain version; two launches give equal bits."""
    from paddle_tpu_torch.ops import fused_conv1x1_bn as fc

    x, w, b = _conv_inputs(M, K, N, dev, seed=5)
    for bias in (None, b):
        y, s, q = fc.conv1x1_stats(x, w, bias)
        yr, sr, qr = fc.conv1x1_stats_reference(x, w, bias)
        torch.cuda.synchronize()
        assert torch.isfinite(y).all()
        assert float((y - yr).abs().max()) <= TOL * max(1.0, float(yr.abs().max()))
        assert ((s - sr).abs() <= 1e-5 * yr.abs().sum(0) + 1e-30).all()
        assert ((q - qr).abs() <= 1e-5 * qr + 1e-30).all()
        del yr, sr, qr
        for a, r in zip((y, s, q), fc.conv1x1_stats(x, w, bias)):
            assert torch.equal(a, r)


def test_conv1x1_stats_kernel_is_deterministic(dev):
    """No atomics: two launches give bit-equal y, s and q."""
    from paddle_tpu_torch.ops import fused_conv1x1_bn as fc

    x, w, b = _conv_inputs(20000, 256, 64, dev, seed=1)
    one, two = fc.conv1x1_stats(x, w, b), fc.conv1x1_stats(x, w, b)
    for a, r in zip(one, two):
        assert torch.equal(a, r)


def test_conv1x1_stats_wrapper_raises_on_what_the_kernel_does_not_take(dev):
    from paddle_tpu_torch.ops.fused_conv1x1_bn import conv1x1_stats

    x, w, b = _conv_inputs(64, 8, 16, dev)
    with pytest.raises(ValueError, match="contiguous"):
        conv1x1_stats(x.t().contiguous().t(), w, b)
    with pytest.raises(ValueError, match="float32"):
        conv1x1_stats(x.double(), w, b)
    with pytest.raises(ValueError, match="is on"):
        conv1x1_stats(x, w.cpu(), b)
    with pytest.raises(ValueError, match="shape"):
        conv1x1_stats(x, w[:, :4].contiguous(), b)


def test_conv1x1_stats_kernel_takes_m_past_65535_row_tiles(dev):
    """M = 8,388,481 rows, one past PR 4's grid of 65535 row tiles of 128
    (the old MAX_M): the persistent blocks walk every tile; y, s and q
    against the plain version. On the card the wrapper raises for a shape
    fused_conv1x1_bn.supported refuses (N past 65535 column tiles)."""
    from paddle_tpu_torch.ops import fused_conv1x1_bn as fc

    M, K, N = 8388481, 8, 16
    assert fc.supported(M, K, N)
    x, w, b = _conv_inputs(M, K, N, dev, seed=7)
    y, s, q = fc.conv1x1_stats(x, w, b)
    yr, sr, qr = fc.conv1x1_stats_reference(x, w, b)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all()
    assert float((y - yr).abs().max()) <= TOL * max(1.0, float(yr.abs().max()))
    assert ((s - sr).abs() <= 1e-5 * yr.abs().sum(0) + 1e-30).all()
    assert ((q - qr).abs() <= 1e-5 * qr + 1e-30).all()
    del x, y, yr
    assert not fc.supported(1, 1, fc.MAX_N + 1)
    with pytest.raises(ValueError, match="does not take"):
        fc.conv1x1_stats(torch.ones(1, 1, device=dev), torch.ones(fc.MAX_N + 1, 1, device=dev))


def test_resnet_step_launches_kernel9_for_every_1x1_stride1_conv(dev):
    """A training step of a small ResNet in "pallas" mode launches kernel 9
    once per 1x1 stride-1 conv; its test pass launches none."""
    from paddle_tpu_torch.flagship import make_image_batch, resnet_config
    from paddle_tpu_torch.ops import fused_conv1x1_bn as fc
    from paddle_tpu_torch.trainer import Trainer

    tc = resnet_config(50, 32, 16)
    tc.opt_config.conv_stats_mode = "pallas"
    trainer = Trainer(tc)
    batch = make_image_batch(4, 32, 16, seed=1, device=dev)
    before = fc.CONV1X1_STATS.launches
    loss = trainer.train_one_batch(batch)
    assert fc.CONV1X1_STATS.launches == before + 30 and torch.isfinite(loss)
    out = trainer.test_batches([batch])
    assert fc.CONV1X1_STATS.launches == before + 30 and np.isfinite(out["cost"])


FLASH_CASES = [(2, 100, 3, 16, True), (2, 100, 3, 16, False), (1, 1, 1, 8, True),
               (3, 257, 2, 64, True), (3, 257, 2, 64, False), (2, 75, 2, 24, True),
               (2, 130, 2, 128, True), (1, 70, 1, 256, False), (1, 70, 1, 256, True)]


def _flash_inputs(dev, B, T, H, D, seed):
    """q, k, v as strided views of one [B, T, 3, H, D] tensor (as the layer
    passes them), dout, and lengths with a 0 and a 1 where B allows."""
    rng = np.random.RandomState(seed)
    qkv = _t(rng.randn(B, T, 3, H, D), dev)
    lens = rng.randint(1, T + 1, B)
    if B > 1:
        lens[-1] = 0
    if B > 2:
        lens[1] = 1
    lengths = torch.from_numpy(lens.astype(np.int32)).to(dev)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], _t(rng.randn(B, T, H, D), dev), lengths


@pytest.mark.parametrize("B,T,H,D,causal", FLASH_CASES)
def test_flash_kernels_match_plain_versions(dev, B, T, H, D, causal):
    """Kernels 10, 11 and 12 against their plain versions on the same
    inputs; the light forward (no lse) gives the same bits as the training
    one. T = 1, 75, 100, 257 leave a ragged last tile; D = 24 is no power
    of two; D = 128 and 256 take the smaller row tiles and shared memory
    above 48 KB."""
    from paddle_tpu_torch.ops import flash_attention as fa

    q, k, v, do, lengths = _flash_inputs(dev, B, T, H, D, seed=T * 10 + D + causal)
    out, lse = fa._launch_fwd(q, k, v, lengths, causal, True)
    light, none = fa._launch_fwd(q, k, v, lengths, causal, False)
    ref_out, ref_lse = fa.flash_forward_reference(q, k, v, lengths, causal)
    torch.cuda.synchronize()
    assert none is None and torch.equal(light, out)
    assert torch.isfinite(out).all()
    assert float((out - ref_out).abs().max()) <= _grad_tol(ref_out)
    seen = lengths > 0
    assert float((lse - ref_lse)[seen].abs().max()) <= TOL
    assert (lse[~seen] == -1e30).all() and not out[~seen].any()

    delta = torch.sum(do * ref_out, dim=-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, ref_lse, delta, lengths, causal)
    dq = fa._launch_dq(*args)
    dk, dv = fa._launch_dkv(*args)
    want = (fa.flash_dq_reference(*args),) + fa.flash_dkv_reference(*args)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert torch.isfinite(a).all(), name
        assert float((a - b).abs().max()) <= _grad_tol(b), name


def test_flash_attention_autograd_launches_each_kernel_once(dev):
    """Through autograd: one launch of each of kernels 10, 11 and 12, and
    the gradients of the plain forward's autograd within tolerance."""
    from paddle_tpu_torch.ops import flash_attention as fa

    q, k, v, do, lengths = _flash_inputs(dev, 3, 200, 2, 32, seed=7)
    before = [kern.launches for kern in fa.KERNELS]

    def grads(fn):
        leaves = [a.detach().requires_grad_() for a in (q, k, v)]
        (fn(*leaves, lengths, True) * do).sum().backward()
        return [a.grad for a in leaves]

    got = grads(lambda q_, k_, v_, l_, c_: fa.flash_attention(q_, k_, v_, lengths=l_, causal=c_))
    # one launch of each float32 instance, none of the bf16 ones
    assert [kern.launches for kern in fa.KERNELS] == [b + 1 for b in before[:3]] + before[3:]
    want = grads(lambda *a: fa.flash_forward_reference(*a)[0])
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert float((a - b).abs().max()) <= _grad_tol(b), name


def test_flash_backward_is_deterministic(dev):
    """No atomics: two launches of kernels 11 and 12 give equal bits."""
    from paddle_tpu_torch.ops import flash_attention as fa

    q, k, v, do, lengths = _flash_inputs(dev, 2, 300, 2, 64, seed=9)
    out, lse = fa._launch_fwd(q, k, v, lengths, True, True)
    delta = torch.sum(do * out, dim=-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta, lengths, True)
    assert torch.equal(fa._launch_dq(*args), fa._launch_dq(*args))
    for a, b in zip(fa._launch_dkv(*args), fa._launch_dkv(*args)):
        assert torch.equal(a, b)


def test_full_attention_dispatches_to_the_flash_kernels(dev):
    """Self-attention shapes on the card launch kernel 10; offsets or
    Tq != Tk take the plain path and launch nothing."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.parallel import full_attention

    q, k, v, _, lengths = _flash_inputs(dev, 2, 64, 2, 16, seed=3)
    before = fa.FLASH_ATTN_FWD.launches
    with torch.no_grad():
        out = full_attention(q, k, v, lengths=lengths, causal=True)
        assert fa.FLASH_ATTN_FWD.launches == before + 1
        full_attention(q, k, v, lengths=lengths, causal=True, q_offset=8)
        full_attention(q[:, :32], k, v, lengths=lengths, causal=True)
    assert fa.FLASH_ATTN_FWD.launches == before + 1
    plain = full_attention(q.cpu(), k.cpu(), v.cpu(), lengths=lengths.cpu(), causal=True)
    live = lengths.cpu() > 0
    assert float((out.cpu() - plain)[live].abs().max()) <= TOL


def test_flash_wrapper_raises_on_what_the_kernels_do_not_take(dev):
    from paddle_tpu_torch.ops import flash_attention as fa

    q = torch.zeros(2, 8, 2, 300, device=dev)
    with pytest.raises(ValueError, match="D <= 256"):
        fa.flash_attention(q, q, q)
    q = torch.zeros(2, 8, 2, 16, device=dev, dtype=torch.float64)
    with pytest.raises(ValueError, match="float32"):
        fa.flash_attention(q, q, q)
    t = torch.zeros(2, 8, 16, 2, device=dev).transpose(2, 3)
    with pytest.raises(ValueError, match="last dimension"):
        fa.flash_attention(t, t, t)


@pytest.mark.parametrize("act_in", GRU_ACTS)
@pytest.mark.parametrize("act_gate", GRU_ACTS)
def test_gru_kernels_take_every_activation(dev, act_in, act_gate):
    """Kernels 1, 2 and 3 against their plain versions with each of the four
    activations in each slot: ys of the light forward, the residuals of the
    training forward, and dx3, dW (reversed, ragged, one empty row), all
    within 1e-4 of max(1, max |plain|). Inputs at a fifth of the other
    tests' scale: a relu or linear update gate can exceed 1, and
    h' = u h + (1 - u) c then grows step by step."""
    from paddle_tpu_torch.ops import fused_gru as fg

    acts = (act_in, act_gate)
    T, B, H = 6, 5, 40
    rng = np.random.RandomState(GRU_ACTS.index(act_in) * 4 + GRU_ACTS.index(act_gate))
    x3 = _t(rng.randn(B, T, 3 * H) * 0.1, dev).transpose(0, 1)
    w = _t(rng.randn(H, 3 * H) * 0.2 / np.sqrt(H), dev)
    lens = rng.randint(1, T + 1, B)
    lens[-1] = 0
    mask = _t(np.arange(T)[:, None] < lens[None, :], dev)
    dy = _t(rng.randn(T, B, H), dev)
    before = [k.launches for k in fg.KERNELS]
    light = fg.fused_gru(x3, mask, w, reverse=True, acts=acts)
    got = fg._launch_fwd(x3, mask, w, True, acts, residuals=True)
    ref = fg.gru_forward_reference(x3, mask, w, True, acts=acts, residuals=True)
    torch.cuda.synchronize()
    assert float((light - ref[0]).abs().max()) <= _grad_tol(ref[0])
    for name, a, b in zip(("ys", "acts", "hprev"), got, ref):
        assert float((a - b).abs().max()) <= _grad_tol(b), name

    leaves = [x3.detach().requires_grad_(), w.detach().requires_grad_()]
    (fg.fused_gru(leaves[0], mask, leaves[1], reverse=True, acts=acts) * dy).sum().backward()
    assert [k.launches for k in fg.KERNELS] == [before[0] + 1, before[1] + 2, before[2] + 1,
                                                *before[3:]]
    plain = [x3.detach().requires_grad_(), w.detach().requires_grad_()]
    (fg.gru_forward_reference(plain[0], mask, plain[1], True, acts=acts) * dy).sum().backward()
    torch.cuda.synchronize()
    for name, a, b in zip(("dx3", "dw"), leaves, plain):
        assert torch.isfinite(a.grad).all(), name
        assert float((a.grad - b.grad).abs().max()) <= _grad_tol(b.grad), name


def _route_net(kind, size, act):
    """words -> embedding -> fc -> grumemory/lstmemory -> max pool ->
    softmax fc: tests/test_torch_layer_routes.py's classifier."""
    from paddle_tpu_torch import trainer_config_helpers as tch
    from paddle_tpu_torch.config.builder import fresh_context

    acts = {"relu": tch.ReluActivation, "softmax": tch.SoftmaxActivation,
            "tanh": tch.TanhActivation}
    with fresh_context() as ctx:
        tch.settings(batch_size=3, learning_rate=1e-2)
        words = tch.data_layer(name="words", size=20)
        emb = tch.embedding_layer(input=words, size=8)
        proj = tch.fc_layer(input=emb, size=(3 if kind == "gru" else 4) * size,
                            act=tch.LinearActivation(), bias_attr=False)
        rnn = (tch.grumemory if kind == "gru" else tch.lstmemory)(
            input=proj, act=acts[act](), name="rnn")
        pool = tch.pooling_layer(input=rnn, pooling_type=tch.MaxPooling())
        out = tch.fc_layer(input=pool, size=2, act=tch.SoftmaxActivation())
        label = tch.data_layer(name="label", size=2)
        tch.outputs(tch.classification_cost(input=out, label=label))
        return ctx.finalize()


@pytest.mark.parametrize("kind,size,act,eager", [
    ("gru", 8, "softmax", True), ("gru", 8, "relu", False),
    ("lstm", 1032, "tanh", True), ("lstm", 8, "relu", False)])
def test_recurrent_layer_routes_on_the_card(dev, kind, size, act, eager):
    """On the card a config supported() accepts launches the training pair;
    one it refuses launches nothing, counts one eager route, and gives the
    CPU's loss and gradients."""
    from paddle_tpu_torch.graph import GradientMachine, make_ids, make_seq
    from paddle_tpu_torch.ops import fused_gru as fg
    from paddle_tpu_torch.ops import fused_lstm as fl

    mod = fg if kind == "gru" else fl
    cfg = _route_net(kind, size, act).model_config
    rng = np.random.RandomState(4)
    T = 3 if size > 1000 else 5
    ids = rng.randint(0, 20, (3, T)).astype(np.int32)
    lengths = np.array([T, T - 2, 1], np.int32)
    labels = rng.randint(0, 2, (3,)).astype(np.int32)

    def run(device):
        m = GradientMachine(cfg, device=device)
        params = m.init_params(seed=5) if device != "cpu" else None
        return m, params, {"words": make_seq(None, lengths, ids=ids, device=device),
                           "label": make_ids(labels, device=device)}

    m, params, batch = run(dev)
    before = ([k.launches for k in mod.KERNELS], mod.EAGER_ROUTES)
    loss, grads, _, _ = m.grad_fn()(params, batch)
    torch.cuda.synchronize()
    launches = [k.launches - b for k, b in zip(mod.KERNELS, before[0])]
    # the float32 instances (light, training, backward), then the bf16 ones
    # (and, for the LSTM, kernel 8's bf16 body for Hopper)
    n = len(mod.KERNELS)
    assert (launches, mod.EAGER_ROUTES - before[1]) == (([0] * n, 1) if eager
                                                        else ([0, 1, 1] + [0] * (n - 3), 0))
    cpu, _, cpu_batch = run("cpu")
    cpu_loss, cpu_grads, _, _ = cpu.grad_fn()({k: p.cpu() for k, p in params.items()}, cpu_batch)
    assert abs(float(loss) - float(cpu_loss)) <= TOL * max(1.0, abs(float(cpu_loss)))
    for name, g in cpu_grads.items():
        assert float((grads[name].cpu() - g).abs().max()) <= _grad_tol(g), name


def test_full_attention_routes_on_the_card(dev):
    """Head dim 264 takes the eager path on the card (no flash launch, one
    eager route) and matches the CPU; head dim 64 launches kernel 10."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.parallel import full_attention

    for D, eager in ((264, True), (64, False)):
        q, k, v, _, lengths = _flash_inputs(dev, 3, 40, 2, D, seed=D)
        before = ([kern.launches for kern in fa.KERNELS], fa.EAGER_ROUTES)
        with torch.no_grad():
            out = full_attention(q, k, v, lengths=lengths, causal=True)
        launched = [kern.launches - b for kern, b in zip(fa.KERNELS, before[0])]
        n = len(fa.KERNELS)
        assert (launched, fa.EAGER_ROUTES - before[1]) == (([0] * n, 1) if eager
                                                           else ([1] + [0] * (n - 1), 0))
        plain = full_attention(q.cpu(), k.cpu(), v.cpu(), lengths=lengths.cpu(), causal=True)
        live = lengths.cpu() > 0
        assert float((out.cpu() - plain)[live].abs().max()) <= TOL


@pytest.mark.parametrize("D", [1, 16, 40, 64, 128, 256])
@pytest.mark.parametrize("T", [1, 63, 65, 1000])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_backward_kernels_across_shapes(dev, D, T, causal):
    """Kernels 11 and 12 against their plain versions at every head-dim
    tile (D = 1 and 40 take the 4-byte copies and a zero-padded k-step;
    D = 256 splits the accumulator features across warps), ragged last
    tiles, lengths with a 0 and a 1, q, k, v as strided views of one qkv
    tensor; two launches give equal bits."""
    from paddle_tpu_torch.ops import flash_attention as fa

    B, H = (3, 2) if T < 1000 else (3, 1)
    q, k, v, do, lengths = _flash_inputs(dev, B, T, H, D, seed=D * 7 + T + causal)
    out, lse = fa._launch_fwd(q, k, v, lengths, causal, True)
    delta = torch.sum(do * out, dim=-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta, lengths, causal)
    dq, (dk, dv) = fa._launch_dq(*args), fa._launch_dkv(*args)
    dq2, (dk2, dv2) = fa._launch_dq(*args), fa._launch_dkv(*args)
    want = (fa.flash_dq_reference(*args),) + fa.flash_dkv_reference(*args)
    torch.cuda.synchronize()
    assert torch.equal(dq, dq2) and torch.equal(dk, dk2) and torch.equal(dv, dv2)
    for name, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert torch.isfinite(a).all(), name
        assert float((a - b).abs().max()) <= _grad_tol(b), name


@pytest.mark.parametrize("D", [1, 16, 40, 64, 128, 256])
@pytest.mark.parametrize("T", [1, 63, 65, 1000])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_forward_kernel_across_shapes(dev, D, T, causal):
    """Kernel 10 against its plain version at every head-dim tile (D = 1
    and 40 take the 4-byte copies and a zero-padded k-step; D = 128 and 256
    keep the split query tile in shared memory, D = 256 splits the output
    features across warps), ragged last tiles, lengths with a 0 and a 1,
    q, k, v as strided views of one qkv tensor; the light launch (no lse)
    and a second launch give equal bits."""
    from paddle_tpu_torch.ops import flash_attention as fa

    B, H = (3, 2) if T < 1000 else (3, 1)
    q, k, v, _, lengths = _flash_inputs(dev, B, T, H, D, seed=D * 5 + T + causal)
    out, lse = fa._launch_fwd(q, k, v, lengths, causal, True)
    out2, lse2 = fa._launch_fwd(q, k, v, lengths, causal, True)
    light, _ = fa._launch_fwd(q, k, v, lengths, causal, False)
    ref_out, ref_lse = fa.flash_forward_reference(q, k, v, lengths, causal)
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and torch.equal(lse, lse2) and torch.equal(light, out)
    assert torch.isfinite(out).all()
    assert float((out - ref_out).abs().max()) <= _grad_tol(ref_out)
    seen = lengths > 0
    assert float((lse - ref_lse)[seen].abs().max()) <= TOL
    assert (lse[~seen] == -1e30).all() and not out[~seen].any()


# ------------------------------------------------------------ beam search

BEAM_W = dict(vocab=300, dim=64, beam_size=3, max_length=12, batch_size=8)


def _beam_machines(dev, spread=False):
    """The generation model on the card and on the CPU with the same
    parameters: init_params', or (``spread``) nmt_gen_spread_params' of
    them, whose log-probabilities spread as a trained model's."""
    from paddle_tpu_torch import api
    from paddle_tpu_torch.flagship import nmt_gen_config, nmt_gen_spread_params

    tc = nmt_gen_config(**BEAM_W)
    card = api.GradientMachine(tc.model_config, device=dev)
    if spread:
        card.params = nmt_gen_spread_params(card.params, tc.model_config)
    cpu = api.GradientMachine(tc.model_config, device="cpu",
                              params={n: p.cpu() for n, p in card.params.items()})
    return tc, card, cpu


def test_beam_search_on_the_card_matches_the_cpu(dev):
    """Beam 3 at a small width on the card (kernel 1 for the encoder, twice
    a forward; no other kernel, no eager route) against the CPU's plain
    versions, at parameters whose log-probabilities spread: every beam's
    ids equal and its score within 1e-4 relative, or a near tie at the
    first step where the two devices' beams differ (beam_parity)."""
    from paddle_tpu_torch.flagship import nmt_gen_batch
    from paddle_tpu_torch.ops import fused_attention_gru as fa
    from paddle_tpu_torch.ops import fused_gru as fg
    from paddle_tpu_torch.tools.beam_parity import beam_parity

    _, card, cpu = _beam_machines(dev, spread=True)
    feeds = [nmt_gen_batch(vocab=BEAM_W["vocab"], B=8, T=10, seed=3, device=d)
             for d in (dev, "cpu")]
    before = (fg.GRU_FWD.launches, fg.GRU_FWD_TRAIN.launches, fa.ATTENTION_GRU_FWD.launches,
              fg.EAGER_ROUTES, fa.EAGER_ROUTES)
    results = card.asSequenceGenerator().generate(feeds[0])
    after = (fg.GRU_FWD.launches, fg.GRU_FWD_TRAIN.launches, fa.ATTENTION_GRU_FWD.launches,
             fg.EAGER_ROUTES, fa.EAGER_ROUTES)
    assert after == (before[0] + 2,) + before[1:]
    assert all(len(sample) == 3 for sample in results)
    differ, ties, worst = beam_parity(card, cpu, *feeds, BEAM_W["max_length"], 1e-4)
    assert len(ties) == len(differ) and worst <= 1e-4


def test_beam_search_exact_ties_on_the_card(dev, tmp_path):
    """Four vocabulary columns with zero weights and bias give bit-equal
    probabilities on the card too: the beams are the lower indices first,
    as on the CPU (tests/test_torch_generation.py holds the CPU to the JAX
    package)."""
    import textwrap

    from paddle_tpu_torch import api
    from paddle_tpu_torch.config import parse_config
    from paddle_tpu_torch.graph import make_dense

    path = tmp_path / "tie.py"
    path.write_text(textwrap.dedent("""
        from paddle.trainer_config_helpers import *
        settings(batch_size=4, learning_rate=1e-3)
        boot = data_layer(name="boot", size=4)
        def gen_step(b, cur_emb):
            h = mixed_layer(size=4, name="h", bias_attr=False,
                            input=[full_matrix_projection(cur_emb, param_attr=ParamAttr(name="wx"))])
            comb = addto_layer(input=[h, b], act=TanhActivation(), bias_attr=False)
            return fc_layer(input=comb, size=6, act=SoftmaxActivation(), name="scores")
        gen = beam_search(step=gen_step,
                          input=[StaticInput(boot),
                                 GeneratedInput(size=6, embedding_name="Tg", embedding_size=4)],
                          bos_id=0, eos_id=5, beam_size=3, max_length=4, name="generator")
        """))
    tc = parse_config(str(path))
    card = api.GradientMachine(tc.model_config, device=dev, seed=5)
    w, bias = card.params["_scores.w0"], card.params["_scores.wbias"]
    w.mul_(0.25)[:, 1:5] = 0.0
    bias.fill_(-3.0).view(-1)[1:5] = 0.0
    bias.view(-1)[5] = -6.0
    cpu = api.GradientMachine(tc.model_config, device="cpu",
                              params={n: p.cpu() for n, p in card.params.items()})
    boot = np.random.RandomState(3).randn(3, 4).astype(np.float32)
    out = [m._core.forward(m.params, {"boot": make_dense(boot, device=m.device)}, "gen")[0]
           ["generator@beams"] for m in (card, cpu)]
    ids, scores = out[0].ids.cpu().numpy(), out[0].value.cpu().numpy()
    np.testing.assert_array_equal(ids, out[1].ids.numpy())
    np.testing.assert_array_equal(ids[:, :, -1], np.tile([1, 2, 3], (3, 1)))
    assert (scores[:, 0] == scores[:, 1]).all() and (scores[:, 1] == scores[:, 2]).all()


def test_trainer_generate_on_the_card_writes_its_result_file(dev, tmp_path):
    """Trainer.generate on the card: one index line and the kept beams per
    sample, the beams the card's SequenceGenerator returns for the same
    parameters and batch."""
    from paddle_tpu_torch.flagship import nmt_gen_batch
    from paddle_tpu_torch.trainer import Trainer
    from paddle_tpu_torch.trainer.trainer import read_result_file

    tc, card, _ = _beam_machines(dev)
    trainer = Trainer(tc)
    assert trainer.device.type == "cuda"
    trainer.params = card.params
    feed = nmt_gen_batch(vocab=BEAM_W["vocab"], B=5, T=10, seed=4, device=dev)
    path = str(tmp_path / "gen_result.txt")
    batches = trainer.generate_batches([feed], result_file=path)
    blocks = read_result_file(path)
    want = card.asSequenceGenerator().generate(feed)
    assert [idx for idx, _ in blocks] == [str(b) for b in range(5)]
    for (_, beams), sample in zip(blocks, want):
        assert [ids for _, ids in beams] == [e["ids"] for e in sample]
        np.testing.assert_allclose([s for s, _ in beams], [e["score"] for e in sample],
                                   rtol=0, atol=1e-5)
    assert batches[0][1].shape == (5, 3, BEAM_W["max_length"])


def test_seqToseq_demo_trains_through_the_command_line_on_the_card(dev, tmp_path):
    """The seqToseq demo (synthetic mode, width 32) trains pass 1 through
    the port's command line on the card and on the CPU, both from the
    pass-00000 that the JAX package's command line wrote
    (tests/data/seqToseq_w32: `paddle train --config=train.conf
    --num_passes=1 --use_tpu=false` in demo/seqToseq, train.list ``seed1``,
    test.list ``seed2``): the pass's test costs within 1e-3 relative, and
    on the card the training kernels launched with no eager route."""
    import os
    import shutil

    from paddle_tpu_torch import cli
    from paddle_tpu_torch.ops import fused_attention_gru as fa
    from paddle_tpu_torch.ops import fused_gru as fg
    from paddle_tpu_torch.trainer import Trainer
    from paddle_tpu_torch.utils.flags import FLAGS, _Flags

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for name in ("dataprovider.py", "seqToseq_net.py", "train.conf"):
        shutil.copy(os.path.join(repo, "demo", "seqToseq", name), tmp_path)
    (tmp_path / "train.list").write_text("seed1\n")
    (tmp_path / "test.list").write_text("seed2\n")
    start = os.path.join(repo, "tests", "data", "seqToseq_w32", "pass-00000")
    results, test = {}, Trainer.test
    cwd, saved = os.getcwd(), dict(vars(FLAGS))
    os.chdir(tmp_path)
    try:
        for use_tpu in ("true", "false"):
            def spy(self, *a, **k):
                results[use_tpu] = test(self, *a, **k)
                return results[use_tpu]

            Trainer.test = spy
            vars(FLAGS).update(vars(_Flags()))
            kernels = fg.KERNELS + fa.KERNELS
            for k in kernels:
                k.launches = 0
            fg.EAGER_ROUTES = fa.EAGER_ROUTES = 0
            assert cli.main(["train", "--config=train.conf", "--num_passes=2", "--start_pass=1",
                             f"--init_model_path={start}", f"--save_dir=out_{use_tpu}",
                             f"--use_tpu={use_tpu}", "--log_period=0", "--dot_period=0"]) == 0
            launches = {k.symbol: k.launches for k in kernels}
            if use_tpu == "true":
                assert fg.EAGER_ROUTES == fa.EAGER_ROUTES == 0
                # 300 samples in 19 batches of 16; the test pass 19 more, its
                # decoder on the group's loop as in the JAX package, whose
                # decoder template matches in training only
                # (paddle_tpu/graph/fused_decoder.py:54)
                assert launches["gru_fwd_train"] == launches["gru_bwd"] == 2 * 19, launches
                assert launches["attention_gru_fwd_train"] == 19, launches
                assert launches["gru_fwd"] == 2 * 19 and launches["attention_gru_fwd"] == 0
            else:
                assert not any(launches.values()), launches
    finally:
        Trainer.test = test
        vars(FLAGS).update(saved)
        os.chdir(cwd)
    card, cpu = results["true"], results["false"]
    assert np.isfinite(card["cost"])
    assert abs(card["cost"] - cpu["cost"]) <= 1e-3 * abs(cpu["cost"]), (card, cpu)


# ------------------------------------------------------------ bf16 operands
# The bf16 instances of kernels 1-3 and 5-12 against their bf16 plain
# versions (the same rounding points): within 1e-2 of the plain result's
# largest magnitude, about one bf16 ulp there (2^-8), since a sum taken in
# another order may round the other way and the step after carries it.

BF16_TOL = 1e-2


def _bf(a, dev):
    return _t(a, dev).to(torch.bfloat16)


def _scale_err(got, want):
    return float((got.float() - want.float()).abs().max()) / max(
        1e-30, float(want.float().abs().max()))


@pytest.mark.parametrize("T,B,H", [(7, 5, 40), (1, 1, 8), (3, 2, 600), (32, 64, 512),
                                   (2, 2700, 512)])
@pytest.mark.parametrize("reverse", [False, True])
def test_gru_bf16_kernels_match_plain_versions(dev, T, B, H, reverse):
    """Kernels 1, 2 and 3 in bf16: ys, the residuals, dx3 and dW within
    1e-2 of scale of gru_forward_reference / gru_backward_reference in bf16
    (at H = 600 two unit groups a block, at B = 2700 w's columns in device
    memory); every output bf16; two launches bit-equal; kernel 1's ys equal
    kernel 2's."""
    from paddle_tpu_torch.ops import fused_gru as fg

    rng = np.random.RandomState(T * 7 + H + B)
    x3 = _bf(rng.randn(B, T, 3 * H) * 0.5, dev).transpose(0, 1)
    w = _bf(rng.randn(H, 3 * H) / np.sqrt(H), dev)
    lens = rng.randint(1, T + 1, B)
    lens[-1] = 0
    mask = _t(np.arange(T)[:, None] < lens[None, :], dev)
    dy = _bf(rng.randn(T, B, H), dev)
    light = fg.fused_gru(x3, mask, w, reverse=reverse)
    got = fg._launch_fwd(x3, mask, w, reverse, fg.KERNEL_ACTS, residuals=True)
    again = fg._launch_fwd(x3, mask, w, reverse, fg.KERNEL_ACTS, residuals=True)
    ref = fg.gru_forward_reference(x3, mask, w, reverse, residuals=True)
    bwd = fg._launch_bwd(dy, got[1], got[2], mask, w, reverse, fg.KERNEL_ACTS)
    bwd2 = fg._launch_bwd(dy, got[1], got[2], mask, w, reverse, fg.KERNEL_ACTS)
    pb = fg.gru_backward_reference(dy, got[1], got[2], mask, w, reverse)
    torch.cuda.synchronize()
    assert all(a.dtype == torch.bfloat16 for a in (light, *got, *bwd))
    assert torch.equal(light, got[0])
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(torch.equal(a, b) for a, b in zip(bwd, bwd2))
    for name, a, b in zip(("ys", "acts", "hprev", "dx3", "dw"), (*got, *bwd), (*ref, *pb)):
        assert torch.isfinite(a.float()).all(), name
        assert _scale_err(a, b) <= BF16_TOL, (name, _scale_err(a, b))


@pytest.mark.parametrize("Td,Te,B,D,E", [(4, 8, 8, 128, 256), (3, 5, 3, 40, 24),
                                         (32, 32, 64, 512, 1024), (8, 128, 64, 512, 1024)])
def test_attention_bf16_kernels_match_plain_versions(dev, Td, Te, B, D, E):
    """Kernels 5 and 6 in bf16: ys, the residuals and the backward's seven
    outputs within 1e-2 of scale of attention_gru_reference /
    attention_gru_backward_reference in bf16; the forward's m (float32)
    against round(hprev) . wa + ba; two launches bit-equal."""
    from paddle_tpu_torch.ops import fused_attention_gru as fa

    rng = np.random.RandomState(Td + Te + D)
    r = lambda *s: rng.randn(*s) * 0.3
    lens = rng.randint(1, Te + 1, B)
    lens[0] = 0
    em = (np.arange(Te)[:, None] < lens[None, :])[:, :, None]
    dm = (np.arange(Td)[:, None] < rng.randint(1, Td + 1, B)[None, :])[:, :, None]
    args = [_bf(r(B, Te, D), dev).transpose(0, 1), _bf(r(B, Te, E), dev).transpose(0, 1),
            _bf(em, dev), _bf(r(Td, B, 3 * D), dev), _bf(dm, dev), _bf(r(B, D), dev),
            _bf(rng.randn(D, D) / np.sqrt(D), dev), _bf(r(1, D), dev), _bf(r(1, D), dev),
            _bf(rng.randn(E, 3 * D) / np.sqrt(E), dev), _bf(rng.randn(D, 3 * D) / np.sqrt(D), dev)]
    dy = _bf(rng.randn(Td, B, D), dev)
    got = fa._launch_fwd(*args, fa.KERNEL_ACTS, residuals=True)
    again = fa._launch_fwd(*args, fa.KERNEL_ACTS, residuals=True)
    ref = fa.attention_gru_reference(*args, residuals=True)
    ep, ev, _, _, dmask, _, wa, ba, v, wctx, wg = args
    ys, hprev, saved, alpha, ctxs, m = got
    kb = fa._launch_bwd(dy, ep, ev, dmask, hprev, saved, alpha, m, wa, v, wctx, wg)
    kb2 = fa._launch_bwd(dy, ep, ev, dmask, hprev, saved, alpha, m, wa, v, wctx, wg)
    pb = fa.attention_gru_backward_reference(dy, ep, ev, dmask, hprev, saved, alpha, wa, ba, v,
                                             wctx, wg)
    torch.cuda.synchronize()
    assert all(a.dtype == torch.bfloat16 for a in got[:5]) and m.dtype == torch.float32
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(torch.equal(a, b) for a, b in zip(kb, kb2))
    m_ref = hprev.float() @ wa.float() + ba.float()
    assert _scale_err(m, m_ref) <= 1e-5
    for name, a, b in zip(("ys", "hprev", "acts", "alpha", "ctx", "dxw", "dctx", "dh0", "dep",
                           "dwa", "dba", "dv"), (*got[:5], *kb), (*ref, *pb)):
        assert torch.isfinite(a.float()).all(), name
        assert _scale_err(a, b) <= BF16_TOL, (name, _scale_err(a, b))


def test_nmt_bf16_step_takes_the_bf16_kernels(dev):
    """One Adam step of the seqToseq model in bf16 at dim 128, B = 8: the
    bf16 instances launch (2, 2, 1, 1 of kernels 2, 3, 5 and 6), the float32
    ones and the eager routes not at all; the master parameters stay
    float32; the loss within 1e-2 of the same step's on the CPU."""
    from paddle_tpu_torch.flagship import nmt_batch, nmt_config
    from paddle_tpu_torch.ops import fused_attention_gru as fa
    from paddle_tpu_torch.ops import fused_gru as fg
    from paddle_tpu_torch.trainer import Trainer

    ks = (fg.GRU_FWD_TRAIN_BF16, fg.GRU_BWD_BF16, fa.ATTENTION_GRU_FWD_TRAIN_BF16,
          fa.ATTENTION_GRU_BWD_BF16, fg.GRU_FWD_TRAIN, fg.GRU_BWD,
          fa.ATTENTION_GRU_FWD_TRAIN, fa.ATTENTION_GRU_BWD)
    tc = nmt_config(vocab=300, dim=128, batch_size=8, dtype="bfloat16")
    trainer = Trainer(tc)
    cpu = Trainer(tc, device="cpu")
    cpu.params = {k: v.cpu() for k, v in trainer.params.items()}
    cpu.opt_state = cpu.updater.init_state(cpu.params)
    before = [k.launches for k in ks] + [fg.EAGER_ROUTES, fa.EAGER_ROUTES]
    loss = float(trainer.train_one_batch(nmt_batch(vocab=300, B=8, T=12, seed=2, device=dev)))
    torch.cuda.synchronize()
    after = [k.launches for k in ks] + [fg.EAGER_ROUTES, fa.EAGER_ROUTES]
    assert [a - b for a, b in zip(after, before)] == [2, 2, 1, 1, 0, 0, 0, 0, 0, 0]
    assert all(v.dtype == torch.float32 for v in trainer.params.values())
    want = float(cpu.train_one_batch(nmt_batch(vocab=300, B=8, T=12, seed=2, device="cpu")))
    assert abs(loss - want) <= 1e-2 * abs(want), (loss, want)


@pytest.mark.parametrize("T,B,H", [(64, 256, 512), (7, 5, 36), (3, 2, 600)])
@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_bf16_kernels_match_plain_versions(dev, T, B, H, reverse):
    """Kernels 7a, 7b and 8 in bf16 at the classifier's shape (T = 64,
    B = 256, H = 512, its activations) and two others (H = 36: the carry
    through a bf16 scratch whose rows are padded to 16 bytes; H = 600: two
    unit groups a block): ys, the residuals, dx4, dW and dpeep within 1e-2
    of scale of lstm_forward_reference / lstm_backward_reference in bf16;
    every output bf16 but cprev (float32); two launches bit-equal; kernel
    7a's ys equal kernel 7b's."""
    from paddle_tpu_torch.ops import fused_lstm as fl

    rng = np.random.RandomState(T + B + H)
    x4 = _bf(rng.randn(B, T, 4 * H) * 0.5, dev).transpose(0, 1)
    w = _bf(rng.randn(H, 4 * H) / np.sqrt(H), dev)
    peep = _bf(rng.randn(3, H) * 0.1, dev)
    lens = rng.randint(1, T + 1, B)
    lens[-1] = 0
    mask = _t(np.arange(T)[:, None] < lens[None, :], dev)
    dy = _bf(rng.randn(T, B, H), dev)
    acts = ("tanh", "sigmoid", "tanh")
    light = fl.fused_lstm(x4, mask, w, peep, reverse, acts)
    got = fl._launch_fwd(x4, mask, w, peep, reverse, acts, residuals=True)
    again = fl._launch_fwd(x4, mask, w, peep, reverse, acts, residuals=True)
    ref = fl.lstm_forward_reference(x4, mask, w, peep, reverse, acts, residuals=True)
    bwd = fl._launch_bwd(dy, *got[1:], mask, w, peep, reverse, acts)
    bwd2 = fl._launch_bwd(dy, *got[1:], mask, w, peep, reverse, acts)
    pb = fl.lstm_backward_reference(dy, *got[1:], mask, w, peep, reverse, acts)
    torch.cuda.synchronize()
    assert all(a.dtype == torch.bfloat16 for a in (light, *got[:3], *bwd))
    assert got[3].dtype == torch.float32
    assert torch.equal(light, got[0])
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(torch.equal(a, b) for a, b in zip(bwd, bwd2))
    for name, a, b in zip(("ys", "acts", "hprev", "cprev", "dx4", "dw", "dpeep"), (*got, *bwd),
                          (*ref, *pb)):
        assert torch.isfinite(a.float()).all(), name
        assert _scale_err(a, b) <= BF16_TOL, (name, _scale_err(a, b))


def test_lstm_classifier_bf16_step_takes_the_bf16_kernels(dev):
    """One Adam step of the LSTM classifier in bf16 at hidden 32, B = 4:
    one launch each of kernels 7b and 8's bf16 instances, none of the
    float32 ones and no eager route; the master parameters stay float32;
    the loss within 1e-2 of the same step's on the CPU."""
    from paddle_tpu_torch.flagship import example_batch, flagship_config
    from paddle_tpu_torch.ops import fused_lstm as fl
    from paddle_tpu_torch.trainer import Trainer

    ks = (fl.LSTM_FWD_TRAIN_BF16, fl.LSTM_BWD_BF16, fl.LSTM_FWD_TRAIN, fl.LSTM_BWD)
    tc = flagship_config(dict_dim=100, emb_dim=16, hidden=32)
    tc.opt_config.dtype = "bfloat16"
    trainer = Trainer(tc)
    cpu = Trainer(tc, device="cpu")
    cpu.params = {k: v.cpu() for k, v in trainer.params.items()}
    cpu.opt_state = cpu.updater.init_state(cpu.params)
    before = [k.launches for k in ks] + [fl.EAGER_ROUTES]
    loss = float(trainer.train_one_batch(example_batch(100, B=4, T=6, seed=2, device=dev)))
    torch.cuda.synchronize()
    after = [k.launches for k in ks] + [fl.EAGER_ROUTES]
    assert [a - b for a, b in zip(after, before)] == [1, 1, 0, 0, 0]
    assert all(v.dtype == torch.float32 for v in trainer.params.values())
    want = float(cpu.train_one_batch(example_batch(100, B=4, T=6, seed=2, device="cpu")))
    assert abs(loss - want) <= 1e-2 * abs(want), (loss, want)


def test_full_remat_launches_the_training_forward_twice(dev):
    """remat="full" on the card: the backward's recompute launches kernel 7b
    again (two a step, one kernel 8), and the step's loss equals
    remat="none"'s from the same parameters."""
    from paddle_tpu_torch.flagship import example_batch, flagship_config
    from paddle_tpu_torch.ops import fused_lstm as fl
    from paddle_tpu_torch.trainer import Trainer

    losses = {}
    for mode in ("none", "full"):
        tc = flagship_config(dict_dim=100, emb_dim=16, hidden=32)
        tc.opt_config.remat = mode
        trainer = Trainer(tc)
        before = (fl.LSTM_FWD_TRAIN.launches, fl.LSTM_BWD.launches)
        losses[mode] = float(trainer.train_one_batch(
            example_batch(100, B=4, T=6, seed=2, device=dev)))
        torch.cuda.synchronize()
        got = (fl.LSTM_FWD_TRAIN.launches - before[0], fl.LSTM_BWD.launches - before[1])
        assert got == ((2, 1) if mode == "full" else (1, 1)), (mode, got)
    assert abs(losses["full"] - losses["none"]) <= 1e-6 * abs(losses["none"]), losses


# ResNet-50's 1x1 convs at B = 64 (stage 2's M = 207,936 with K or N = 64;
# stage 5 at K = 2048), and shapes TMA cannot read (K % 8 != 0, unaligned)
@pytest.mark.parametrize("M,K,N", [(207936, 64, 256), (12544, 1024, 256), (3136, 2048, 512),
                                   (1000, 64, 64), (37, 5, 3), (513, 130, 200),
                                   (1000, 72, 100), (130, 4104, 136)])
@pytest.mark.parametrize("bias", [False, True])
def test_conv1x1_stats_bf16_kernel_matches_plain_version(dev, M, K, N, bias):
    """Kernel 9's bf16 instance against its bf16 plain version: y bf16
    within 1e-2 of scale, s and q float32 within 1e-3 of Σ|y| and Σy²
    (the kernel's y may round to a neighbour of the plain y's); two
    launches bit-equal; the float32 instance not launched."""
    from paddle_tpu_torch.ops import fused_conv1x1_bn as fc

    x, w, b = (a.to(torch.bfloat16) for a in _conv_inputs(M, K, N, dev))
    b = b if bias else None
    before = (fc.CONV1X1_STATS_BF16.launches, fc.CONV1X1_STATS.launches)
    y, s, q = fc.conv1x1_stats(x, w, b)
    again = fc.conv1x1_stats(x, w, b)
    assert (fc.CONV1X1_STATS_BF16.launches, fc.CONV1X1_STATS.launches) == (
        before[0] + 2, before[1])
    yr, sr, qr = fc.conv1x1_stats_reference(x, w, b)
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16 and s.dtype == q.dtype == torch.float32
    assert torch.isfinite(y.float()).all() and _scale_err(y, yr) <= BF16_TOL
    yf = yr.float()
    assert ((s - sr).abs() <= 1e-3 * yf.abs().sum(0) + 1e-30).all()
    assert ((q - qr).abs() <= 1e-3 * (yf * yf).sum(0) + 1e-30).all()
    assert all(torch.equal(a, r) for a, r in zip((y, s, q), again))


@pytest.mark.parametrize("M,K,N", RESNET_CONV_SHAPES)
def test_conv1x1_stats_bf16_kernel_at_resnet_shapes(dev, M, K, N):
    """Kernel 9's bf16 body at the nine shapes of the ResNet-50 train step,
    with and without a bias, against its bf16 plain version (y within 1e-2
    of scale, s and q within 1e-3 of Σ|y| and Σy²); two launches give equal
    bits."""
    from paddle_tpu_torch.ops import fused_conv1x1_bn as fc

    x, w, b = (a.to(torch.bfloat16) for a in _conv_inputs(M, K, N, dev, seed=5))
    for bias in (None, b):
        y, s, q = fc.conv1x1_stats(x, w, bias)
        yr, sr, qr = fc.conv1x1_stats_reference(x, w, bias)
        torch.cuda.synchronize()
        assert torch.isfinite(y.float()).all() and _scale_err(y, yr) <= BF16_TOL
        yf = yr.float()
        assert ((s - sr).abs() <= 1e-3 * yf.abs().sum(0) + 1e-30).all()
        assert ((q - qr).abs() <= 1e-3 * (yf * yf).sum(0) + 1e-30).all()
        del yr, sr, qr, yf
        assert all(torch.equal(a, r) for a, r in zip((y, s, q), fc.conv1x1_stats(x, w, bias)))


def test_conv1x1_stats_bf16_kernel_takes_m_past_65535_row_tiles(dev):
    """M = 8,388,481 bf16 rows, one past 65535 row tiles of 128: the
    persistent blocks walk every tile, and y, s and q match the bf16 plain
    version; two launches give equal bits."""
    from paddle_tpu_torch.ops import fused_conv1x1_bn as fc

    M, K, N = 8388481, 8, 16
    x, w, b = (a.to(torch.bfloat16) for a in _conv_inputs(M, K, N, dev, seed=7))
    y, s, q = fc.conv1x1_stats(x, w, b)
    yr, sr, qr = fc.conv1x1_stats_reference(x, w, b)
    torch.cuda.synchronize()
    assert torch.isfinite(y.float()).all() and _scale_err(y, yr) <= BF16_TOL
    yf = yr.float()
    assert ((s - sr).abs() <= 1e-3 * yf.abs().sum(0) + 1e-30).all()
    assert ((q - qr).abs() <= 1e-3 * (yf * yf).sum(0) + 1e-30).all()
    del yr, yf
    assert all(torch.equal(a, r) for a, r in zip((y, s, q), fc.conv1x1_stats(x, w, b)))


def test_conv1x1_stats_bf16_kernel_takes_unaligned_operands(dev):
    """x and w one bf16 past a 16-byte boundary: warp 0 fills the stages
    in place of TMA, and the results equal the aligned launch's."""
    from paddle_tpu_torch.ops import fused_conv1x1_bn as fc

    x, w, b = (a.to(torch.bfloat16) for a in _conv_inputs(1000, 64, 64, dev))
    xu = torch.empty(x.numel() + 1, device=dev, dtype=torch.bfloat16)[1:].view_as(x)
    wu = torch.empty(w.numel() + 1, device=dev, dtype=torch.bfloat16)[1:].view_as(w)
    xu.copy_(x)
    wu.copy_(w)
    got, want = fc.conv1x1_stats(xu, wu, b), fc.conv1x1_stats(x, w, b)
    torch.cuda.synchronize()
    assert all(torch.equal(a, r) for a, r in zip(got, want))


@pytest.mark.parametrize("B,T,H,D,causal", [(8, 2048, 8, 64, True), (3, 257, 2, 64, False),
                                            (2, 130, 2, 128, True), (2, 75, 2, 24, True),
                                            (1, 70, 1, 256, True), (2, 100, 3, 16, False)])
def test_flash_bf16_kernels_match_plain_versions(dev, B, T, H, D, causal):
    """Kernels 10, 11 and 12's bf16 bodies, as the route picks them, against
    their bf16 plain versions, the LM's shape first: out, dq, dk and dv bf16
    within 1e-2 of scale, lse float32 within 1e-4; the light forward equal
    to the training one; dq, dk and dv bit-equal over two launches, as in
    float32. D = 64 and 128 take the Hopper bodies of 10 and 12, the others
    the float32 body's bf16 instances: D = 24 loads value by value (no
    16-byte rows of bf16); D = 16 and 256 take their one-pass Q . K^T, D = 24
    the two-pass."""
    from paddle_tpu_torch.ops import flash_attention as fa

    q, k, v, do, lengths = (a.to(torch.bfloat16) if a.is_floating_point() else a
                            for a in _flash_inputs(dev, B, T, H, D, seed=T + D + causal))
    sm90 = fa.sm90_takes(q, k, v, do)
    assert sm90 == (D in (64, 128))
    before = [kern.launches for kern in fa.KERNELS]
    out, lse = fa._launch_fwd(q, k, v, lengths, causal, True)
    light, _ = fa._launch_fwd(q, k, v, lengths, causal, False)
    ref_out, ref_lse = fa.flash_forward_reference(q, k, v, lengths, causal)
    delta = torch.sum(do.float() * ref_out.float(), dim=-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, ref_lse, delta, lengths, causal)
    dq, (dk, dv) = fa._launch_dq(*args), fa._launch_dkv(*args)
    dq2, (dk2, dv2) = fa._launch_dq(*args), fa._launch_dkv(*args)
    want = (fa.flash_dq_reference(*args),) + fa.flash_dkv_reference(*args)
    torch.cuda.synchronize()
    launched = [kern.launches - b for kern, b in zip(fa.KERNELS, before)]
    old, new = (0, 2) if sm90 else (2, 0)
    assert launched == [0, 0, 0, old, old, old, new, new, new], launched
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert torch.equal(light, out) and _scale_err(out, ref_out) <= BF16_TOL
    seen = lengths > 0
    assert float((lse - ref_lse)[seen].abs().max()) <= TOL
    assert (lse[~seen] == -1e30).all() and not out[~seen].float().any()
    assert torch.equal(dq, dq2) and torch.equal(dk, dk2) and torch.equal(dv, dv2)
    for name, a, r in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert a.dtype == torch.bfloat16 and torch.isfinite(a.float()).all(), name
        assert _scale_err(a, r) <= BF16_TOL, name


# The Hopper bodies' out, dk and dv against their plain versions: within
# SM90_ULPS bf16 spacings of the larger magnitude, the spacing taken at no
# less than SM90_CANCEL_FLOOR of max |plain| (test_torch_flash_attention.py's
# floor). p and ds enter the products as two bf16 pieces: out and dv lie
# within one spacing, dq (each key tile's partial summed apart and added
# with rounded float32 adds) within two (one but where ds = p (dp - delta)
# cancels over the tensor core's truncating score sums:
# test_torch_flash_attention.py), dk (summed over up to T queries in the
# wgmma accumulator, which truncates) several where it cancels. Rounded
# once to bf16 (one piece), the plain versions lie tens of spacings off in
# out, dq and dk, a few in dv (chip_smoke.py's SM90_ULPS).
SM90_CANCEL_FLOOR = 2.0 ** -11
SM90_ULPS = {"out": 1.0, "dq": 2.0, "dk": 16.0, "dv": 1.0}


def _bf16_ulps(got, want):
    got, want = got.float(), want.float()
    big = torch.maximum(got.abs(), want.abs()).clamp(min=SM90_CANCEL_FLOOR * float(
        want.abs().max()))
    ulp = torch.exp2(torch.floor(torch.log2(big.clamp(min=2.0 ** -126))) - 7)
    return float(((got - want).abs() / ulp).max())


def _one_piece_references(q, k, v, do, lse, delta, lengths, causal):
    """Kernels 10, 12 and 11's plain versions with p and ds rounded once to
    bf16 before their products -> (out, dk, dv, dq): the control of the two
    pieces."""
    from paddle_tpu_torch.ops import flash_attention as fa

    piece = lambda x: x.to(torch.bfloat16).float()
    T, D = q.shape[1], q.shape[3]
    msk = fa._visible(lengths, T, T, causal)
    qw, kw, vw, dw = fa._widened(q, k, v, do)
    s = torch.einsum("bqhd,bkhd->bhqk", qw * (1.0 / np.sqrt(D)), kw)
    s = torch.where(msk, s, torch.full_like(s, -1e30))
    p = torch.where(msk, torch.exp(s - torch.amax(s, dim=-1, keepdim=True)), torch.zeros_like(s))
    l_safe = torch.clamp(torch.sum(p, dim=-1), min=1e-20)
    out = torch.einsum("bhqk,bkhd->bqhd", piece(p), vw) / l_safe.transpose(1, 2)[..., None]
    p, ds = fa._scores_backward(q, k, v, do, lse, delta, lengths, causal)
    return (out.to(q.dtype), torch.einsum("bhqk,bqhd->bkhd", piece(ds), qw).to(k.dtype),
            torch.einsum("bhqk,bqhd->bkhd", piece(p), dw).to(v.dtype),
            torch.einsum("bhqk,bkhd->bqhd", piece(ds), kw).to(q.dtype))


@pytest.mark.parametrize("D,T,causal", [(64, 2048, True), (64, 1000, False),
                                         (128, 1000, True), (128, 2048, False),
                                         (64, 257, False), (128, 257, True)])
def test_flash_sm90_bodies_match_plain_versions(dev, D, T, causal):
    """The bf16 bodies for Hopper (flash_attn_fwd_bf16_sm90,
    flash_attn_dq_bf16_sm90, flash_attn_dkv_bf16_sm90: bf16 wgmma over TMA
    tiles) against their bf16 plain versions on strided views of one fused
    [B, T, 3, H, D] qkv, with lengths that hold a 0 and a 1; T = 1000 and
    257 leave a ragged last tile. out, dq, dk and dv within SM90_ULPS bf16
    spacings (at no less than SM90_CANCEL_FLOOR of the scale), where the
    one-piece control is not; lse within 1e-4 where a key is seen and -1e30
    elsewhere, the light forward equal to the training one, dq, dk and dv
    bit-equal over two launches; no other body launches."""
    from paddle_tpu_torch.ops import flash_attention as fa

    q, k, v, do, lengths = _flash_inputs(dev, 3, T, 2, D, seed=D + T + causal)
    qkv = torch.stack([q, k, v], dim=2).to(torch.bfloat16)          # [B, T, 3, H, D]
    q, k, v, do = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], do.to(torch.bfloat16)
    assert q.stride(1) == 3 * 2 * D and fa.sm90_takes(q, k, v, do)
    before = [kern.launches for kern in fa.KERNELS]
    out, lse = fa._launch_fwd(q, k, v, lengths, causal, True)
    light, _ = fa._launch_fwd(q, k, v, lengths, causal, False)
    ref_out, ref_lse = fa.flash_forward_reference(q, k, v, lengths, causal)
    delta = torch.sum(do.float() * ref_out.float(), dim=-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, ref_lse, delta, lengths, causal)
    dk, dv = fa._launch_dkv(*args)
    dk2, dv2 = fa._launch_dkv(*args)
    dq, dq2 = fa._launch_dq(*args), fa._launch_dq(*args)
    want_dk, want_dv = fa.flash_dkv_reference(*args)
    want_dq = fa.flash_dq_reference(*args)
    torch.cuda.synchronize()
    launched = {kern.symbol: kern.launches - b for kern, b in zip(fa.KERNELS, before)}
    assert launched == {kern.symbol: 2 if kern in (fa.FLASH_ATTN_FWD_BF16_SM90,
                                                    fa.FLASH_ATTN_DQ_BF16_SM90,
                                                    fa.FLASH_ATTN_DKV_BF16_SM90) else 0
                        for kern in fa.KERNELS}, launched
    assert torch.equal(light, out) and _scale_err(out, ref_out) <= BF16_TOL
    seen = lengths > 0
    assert float((lse - ref_lse)[seen].abs().max()) <= TOL
    assert (lse[~seen] == -1e30).all() and not out[~seen].float().any()
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2) and torch.equal(dq, dq2)
    control = _one_piece_references(*args)
    for name, a, r, c in (("out", out, ref_out, control[0]), ("dq", dq, want_dq, control[3]),
                          ("dk", dk, want_dk, control[1]), ("dv", dv, want_dv, control[2])):
        assert a.dtype == torch.bfloat16 and torch.isfinite(a.float()).all(), name
        assert _bf16_ulps(a, r) <= SM90_ULPS[name] < _bf16_ulps(c, r), (
            name, _bf16_ulps(a, r), _bf16_ulps(c, r))


@pytest.mark.parametrize("D", [64, 40])
def test_flash_bf16_autograd_routes_by_head_dim(dev, D):
    """One autograd step of bf16 flash attention on the LM's views (B = 2, T
    = 2048, 8 heads, causal): at D = 64 one launch each of the Hopper
    forward, dQ and dK/dV, and never the float32 body's bf16 instances; at
    D = 40, which the Hopper bodies do not
    take, one launch each of the float32 body's three bf16 instances. The
    gradients within 1e-2 of scale of the plain versions' autograd."""
    from paddle_tpu_torch.ops import flash_attention as fa

    B, T, H = 2, 2048, 8
    rng = np.random.RandomState(D)
    qkv = _t(rng.randn(B, T, 3, H, D), dev).to(torch.bfloat16).requires_grad_()
    cot = _t(rng.randn(B, T, H, D), dev).to(torch.bfloat16)
    lengths = torch.full((B,), T, dtype=torch.int32, device=dev)
    before = [kern.launches for kern in fa.KERNELS]
    out = fa.flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], lengths=lengths,
                             causal=True)
    (grad,) = torch.autograd.grad(out, qkv, cot)
    torch.cuda.synchronize()
    launched = {kern.symbol: kern.launches - b for kern, b in zip(fa.KERNELS, before)}
    names = (("flash_attn_fwd_bf16_sm90", "flash_attn_dq_bf16_sm90", "flash_attn_dkv_bf16_sm90")
             if D == 64 else ("flash_attn_fwd_bf16", "flash_attn_dq_bf16", "flash_attn_dkv_bf16"))
    assert launched == {kern.symbol: int(kern.symbol in names) for kern in fa.KERNELS}, launched
    leaf = qkv.detach().requires_grad_()
    plain = fa.flash_forward_reference(leaf[:, :, 0], leaf[:, :, 1], leaf[:, :, 2], lengths,
                                       True)[0]
    (want,) = torch.autograd.grad(plain, leaf, cot)
    for i, name in enumerate(("dq", "dk", "dv")):
        assert _scale_err(grad[:, :, i], want[:, :, i]) <= BF16_TOL, name


def test_flash_bf16_wrapper_refuses_mixed_dtypes(dev):
    """q, k, v (and dout) share one dtype on the card: no widening."""
    from paddle_tpu_torch.ops import flash_attention as fa

    q = torch.zeros(2, 8, 2, 16, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="k is torch.float32"):
        fa.flash_attention(q, q.float(), q)


def test_bf16_resnet_and_lm_steps_take_the_bf16_kernels(dev):
    """One bf16 step of ResNet-50 at 32² ("pallas") and of the long-context
    LM (dim 64, T = 64) on the card: only the bf16 instances of kernels 9
    and 10-12 launch (30, and 2 of each), no eager route, the master
    parameters float32, the loss within 1e-2 of the same step's on the CPU
    (the bf16 plain versions)."""
    from paddle_tpu_torch.flagship import (lm_batch, long_context_config, make_image_batch,
                                           resnet_config)
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_conv1x1_bn as fc
    from paddle_tpu_torch.trainer import Trainer

    resnet = resnet_config(layer_num=50, img_size=32, classes=16)
    resnet.opt_config.dtype = "bfloat16"
    resnet.opt_config.conv_stats_mode = "pallas"
    cases = [(resnet, lambda d: make_image_batch(2, 32, 16, seed=1, device=d),
              {fc.CONV1X1_STATS_BF16: 30}),
             (long_context_config(dtype="bfloat16"),
              lambda d: lm_batch(500, B=2, T=64, seed=1, device=d),
              {fa.FLASH_ATTN_FWD_BF16: 2, fa.FLASH_ATTN_DQ_BF16: 2, fa.FLASH_ATTN_DKV_BF16: 2})]
    kernels = list(fc.KERNELS) + list(fa.KERNELS)
    for tc, batch, want in cases:
        trainer = Trainer(tc)
        assert trainer.gm.compute_dtype == torch.bfloat16
        cpu = Trainer(tc, device="cpu")
        cpu.params = {k: v.cpu() for k, v in trainer.params.items()}
        cpu.opt_state = cpu.updater.init_state(cpu.params)
        before = [k.launches for k in kernels] + [fc.EAGER_ROUTES, fa.EAGER_ROUTES]
        loss = float(trainer.train_one_batch(batch(dev)))
        torch.cuda.synchronize()
        after = [k.launches for k in kernels] + [fc.EAGER_ROUTES, fa.EAGER_ROUTES]
        assert [a - b for a, b in zip(after, before)] == \
            [want.get(k, 0) for k in kernels] + [0, 0]
        assert all(v.dtype == torch.float32 for v in trainer.params.values())
        ref = float(cpu.train_one_batch(batch("cpu")))
        assert abs(loss - ref) <= 1e-2 * abs(ref), (loss, ref)


# The Hopper bodies of kernels 8 and 6 sum dW (dWa) from the gate gradients
# (d_m) as two bf16 pieces, held to 2 bf16 spacings (taken at no less than
# SM90_CANCEL_FLOOR of the scale) of the plain version walked through the
# kernel's own recurrence (``dx4_forced`` / ``dxw_forced``: over many steps
# two float32 summation orders round some bf16 gradient the other way, and
# the recurrences carry it on); the one-piece control (from the rounded
# values alone) lies past that over a whole sequence.
RECURRENT_SM90_ULPS = 2.0


def _lstm_bf16_bwd_case(dev, T, B, H, seed, reverse=False):
    """Kernel 8's bf16 operands from kernel 7b's bf16 residuals at the
    classifier's activations: ragged lengths, one full row and one of
    length 0."""
    from paddle_tpu_torch.ops import fused_lstm as fl

    rng = np.random.RandomState(seed)
    acts = ("tanh", "sigmoid", "tanh")
    x4 = (_bf(rng.randn(B, T, 4 * H) * 0.5, dev).transpose(0, 1) if T else
          torch.zeros((0, B, 4 * H), dtype=torch.bfloat16, device=dev))
    w = _bf(rng.randn(H, 4 * H) / np.sqrt(H), dev)
    peep = _bf(rng.randn(3, H) * 0.1, dev)
    lens = rng.randint(1, T + 1, B) if T else np.zeros(B, np.int64)
    lens[0] = T
    if B > 1:
        lens[-1] = 0
    mask = (_t(np.arange(T)[:, None] < lens[None, :], dev) if T else
            torch.zeros((0, B), device=dev))
    dy = _bf(rng.randn(T, B, H), dev) if T else torch.zeros((0, B, H), dtype=torch.bfloat16,
                                                            device=dev)
    _, saved, hprev, cprev = fl._launch_fwd(x4, mask, w, peep, reverse, acts, True)
    return (dy, saved, hprev, cprev, mask, w, peep, reverse, acts)


@pytest.mark.parametrize("T,B,H,reverse", [(64, 256, 512, False), (64, 256, 512, True),
                                           (9, 37, 256, True), (5, 19, 1024, False),
                                           (1, 16, 512, False), (0, 8, 64, False),
                                           (3, 300, 128, True)])
def test_lstm_bwd_sm90_matches_plain_version(dev, T, B, H, reverse):
    """lstm_bwd_bf16_sm90 (the route's choice at these shapes) against the
    bf16 plain version: dx4, dW and dpeep within 1e-2 of scale, dW within
    RECURRENT_SM90_ULPS spacings of the plain version through the kernel's
    own dx4, where over 8 steps or more the one-piece control is not; two
    launches bit-equal; T = 0 gives zeros (T = 1's dW is 0: h_prev is). B = 37 and 19 are no multiple of
    16, H = 1024 takes blocks of 16 units, B = 300 at H = 128 groups of 10
    rows."""
    from paddle_tpu_torch.ops import fused_lstm as fl

    args = _lstm_bf16_bwd_case(dev, T, B, H, seed=T + B + H, reverse=reverse)
    assert fl.sm90_takes(B, H, fl.card_sms(dev), args[5], args[2])
    before = (fl.LSTM_BWD_BF16_SM90.launches, fl.LSTM_BWD_BF16.launches)
    got = fl._launch_bwd(*args)
    again = fl._launch_bwd(*args)
    torch.cuda.synchronize()
    assert (fl.LSTM_BWD_BF16_SM90.launches - before[0],
            fl.LSTM_BWD_BF16.launches - before[1]) == (2, 0)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(a.dtype == torch.bfloat16 for a in got)
    if T == 0:
        assert got[0].shape == (0, B, 4 * H) and not got[1].any() and not got[2].any()
        return
    plain = fl.lstm_backward_reference(*args)
    for name, a, b in zip(("dx4", "dw", "dpeep"), got, plain):
        assert torch.isfinite(a.float()).all(), name
        assert _scale_err(a, b) <= BF16_TOL, (name, _scale_err(a, b))
    own = fl.lstm_backward_reference(*args, dx4_forced=got[0])[1]
    one = fl.lstm_backward_reference(*args, dw_pieces=1, dx4_forced=got[0])[1]
    two_ulps, one_ulps = _bf16_ulps(got[1], own), _bf16_ulps(one, own)
    assert two_ulps <= RECURRENT_SM90_ULPS, (two_ulps, one_ulps)
    if T >= 8:
        assert one_ulps > RECURRENT_SM90_ULPS, (two_ulps, one_ulps)


def test_lstm_bwd_sm90_phase_clocks_leave_the_result_alone(dev):
    """The Hopper body asked for its phase clocks: the same bits, and block
    0's clock rising through every step's phases."""
    from paddle_tpu_torch.ops import fused_lstm as fl

    T = 6
    args = _lstm_bf16_bwd_case(dev, T, 64, 512, seed=41)
    plain = fl._launch_bwd_sm90(*args)
    clocks = torch.zeros((T, 3), dtype=torch.int64, device=dev)
    clocked = fl._launch_bwd_sm90(*args, phase_ns=clocks)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(plain, clocked))
    flat = clocks.flatten()
    assert bool((flat[1:] >= flat[:-1]).all()) and int(flat[0]) > 0


@pytest.mark.parametrize("T,B,H", [(4, 6, 600), (3, 5, 36), (2, 1400, 1024)])
def test_lstm_bwd_bf16_keeps_the_persistent_body_where_sm90_refuses(dev, T, B, H):
    """Where sm90_takes refuses (H no multiple of 64; at H = 1024 a batch
    whose rows' state overflows a block: B = 1400 on 132 SMs) the persistent body runs, held to the
    bf16 plain version within 1e-2 of scale; and on the classifier's shape
    the persistent body launched by name (_launch_bwd_persistent) gives a
    result within the same bound of the Hopper body's."""
    from paddle_tpu_torch.ops import fused_lstm as fl

    sms = fl.card_sms(dev)
    assert not fl.sm90_takes(B, H, sms) and fl.supported(("tanh", "sigmoid", "tanh"), H, B, sms)
    args = _lstm_bf16_bwd_case(dev, T, B, H, seed=T * B + H)
    before = (fl.LSTM_BWD_BF16_SM90.launches, fl.LSTM_BWD_BF16.launches)
    got = fl._launch_bwd(*args)
    torch.cuda.synchronize()
    assert (fl.LSTM_BWD_BF16_SM90.launches - before[0],
            fl.LSTM_BWD_BF16.launches - before[1]) == (0, 1)
    for name, a, b in zip(("dx4", "dw", "dpeep"), got, fl.lstm_backward_reference(*args)):
        assert _scale_err(a, b) <= BF16_TOL, (name, _scale_err(a, b))
    cls = _lstm_bf16_bwd_case(dev, 8, 256, 512, seed=43)
    new, old = fl._launch_bwd(*cls), fl._launch_bwd_persistent(*cls)
    for name, a, b in zip(("dx4", "dw", "dpeep"), new, old):
        assert _scale_err(a, b) <= BF16_TOL, (name, _scale_err(a, b))


def _agru_bf16_bwd_case(dev, Td, Te, B, D, E, seed):
    """Kernel 6's bf16 operands from kernel 5's bf16 residuals: ragged
    encoder and decoder lengths, a row with no encoder position."""
    from paddle_tpu_torch.ops import fused_attention_gru as fa

    rng = np.random.RandomState(seed)
    r = lambda *s: rng.randn(*s) * 0.3
    lens = rng.randint(1, Te + 1, B)
    lens[0] = 0
    em = (np.arange(Te)[:, None] < lens[None, :])[:, :, None]
    dm = (np.arange(Td)[:, None] < rng.randint(0, Td + 1, B)[None, :])[:, :, None]
    args = [_bf(r(B, Te, D), dev).transpose(0, 1), _bf(r(B, Te, E), dev).transpose(0, 1),
            _bf(em, dev), _bf(r(Td, B, 3 * D), dev), _bf(dm, dev), _bf(r(B, D), dev),
            _bf(rng.randn(D, D) / np.sqrt(D), dev), _bf(r(1, D), dev), _bf(r(1, D), dev),
            _bf(rng.randn(E, 3 * D) / np.sqrt(E), dev), _bf(rng.randn(D, 3 * D) / np.sqrt(D), dev)]
    dy = _bf(rng.randn(Td, B, D), dev)
    ys, hprev, saved, alpha, ctxs, m = fa._launch_fwd(*args, fa.KERNEL_ACTS, residuals=True)
    ep, ev, _, _, dmask, _, wa, ba, v, wctx, wg = args
    return (dy, ep, ev, dmask, hprev, saved, alpha, m, wa, v, wctx, wg), ba


@pytest.mark.parametrize("Td,Te,B,D,E", [(32, 32, 64, 512, 1024), (1, 32, 64, 512, 1024),
                                         (5, 7, 37, 256, 512), (3, 9, 19, 256, 1024),
                                         (4, 16, 3, 512, 512)])
def test_attention_gru_bwd_sm90_matches_plain_version(dev, Td, Te, B, D, E):
    """attention_gru_bwd_bf16_sm90 (the route's choice at these shapes)
    against the bf16 plain version: dxw, dctx, dh0, d_enc_proj, dWa, dba and
    dv within 1e-2 of scale, dWa (rounded to bf16) within RECURRENT_SM90_ULPS
    spacings of the plain version through the kernel's own dxw, where at
    the NMT shape the one-piece control is not; two launches bit-equal. B = 37 and 19 are no multiple of 16; B = 3 has
    one row a group; D = 256 at E = 1024 takes two row groups of blocks of 8
    units; rows with no decoder step and no encoder position."""
    from paddle_tpu_torch.ops import fused_attention_gru as fa

    args, ba = _agru_bf16_bwd_case(dev, Td, Te, B, D, E, seed=Td + Te + B + D)
    ev, wa, wctx, wg = args[2], args[8], args[10], args[11]
    assert fa.sm90_takes(B, Te, D, E, fa.card_sms(dev), wa, wctx, wg, ev)
    before = (fa.ATTENTION_GRU_BWD_BF16_SM90.launches, fa.ATTENTION_GRU_BWD_BF16.launches)
    got = fa._launch_bwd(*args)
    again = fa._launch_bwd(*args)
    torch.cuda.synchronize()
    assert (fa.ATTENTION_GRU_BWD_BF16_SM90.launches - before[0],
            fa.ATTENTION_GRU_BWD_BF16.launches - before[1]) == (2, 0)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    dy, ep, ev, dmask, hprev, saved, alpha, m, wa, v, wctx, wg = args
    plain = fa.attention_gru_backward_reference(dy, ep, ev, dmask, hprev, saved, alpha, wa, ba,
                                                v, wctx, wg)
    for name, a, b in zip(("dxw", "dctx", "dh0", "dep", "dwa", "dba", "dv"), got, plain):
        assert torch.isfinite(a.float()).all(), name
        assert _scale_err(a, b) <= BF16_TOL, (name, _scale_err(a, b))
    ref = lambda n: fa.attention_gru_backward_reference(
        dy, ep, ev, dmask, hprev, saved, alpha, wa, ba, v, wctx, wg, dwa_pieces=n,
        dxw_forced=got[0])[4]
    ulps = lambda a, b: _bf16_ulps(a.to(torch.bfloat16), b.to(torch.bfloat16))
    own = ref(0)
    two_ulps, one_ulps = ulps(got[4], own), ulps(ref(1), own)
    assert two_ulps <= RECURRENT_SM90_ULPS, (two_ulps, one_ulps)
    if Td == 32:
        assert one_ulps > RECURRENT_SM90_ULPS, (two_ulps, one_ulps)


def test_attention_gru_bwd_phase_clocks_leave_the_result_alone(dev):
    """Kernel 6's three bodies asked for their phase clocks ([Td, 5], the end
    of each phase): the same bits, and block 0's clock rising through every
    step's phases."""
    from paddle_tpu_torch.ops import fused_attention_gru as fa

    Td = 4
    args, _ = _agru_bf16_bwd_case(dev, Td, 8, 16, 256, 512, seed=51)
    f32 = tuple(a.float() if a.dtype == torch.bfloat16 else a for a in args)
    for case, launch in ((f32, fa._launch_bwd), (args, fa._launch_bwd_persistent),
                         (args, fa._launch_bwd_sm90)):
        plain = launch(*case)
        clocks = torch.zeros((Td, 5), dtype=torch.int64, device=dev)
        clocked = launch(*case, phase_ns=clocks)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(plain, clocked)), launch.__name__
        flat = clocks.flatten()
        assert bool((flat[1:] >= flat[:-1]).all()) and int(flat[0]) > 0, launch.__name__


@pytest.mark.parametrize("Td,Te,B,D,E", [(8, 128, 64, 512, 1024), (3, 5, 3, 40, 24),
                                         (4, 8, 8, 384, 768)])
def test_attention_gru_bwd_bf16_keeps_the_persistent_body_where_sm90_refuses(
        dev, Td, Te, B, D, E):
    """Where sm90_takes refuses (Te = 128's d_enc_proj sums past a block's
    shared memory; D no multiple of 256) the persistent body runs, held to the bf16
    plain version within 1e-2 of scale; at the NMT shape the persistent
    body launched by name (_launch_bwd_persistent) gives a result within the
    same bound of the Hopper body's."""
    from paddle_tpu_torch.ops import fused_attention_gru as fa

    assert not fa.sm90_takes(B, Te, D, E, fa.card_sms(dev))
    args, ba = _agru_bf16_bwd_case(dev, Td, Te, B, D, E, seed=Td * Te + D)
    before = (fa.ATTENTION_GRU_BWD_BF16_SM90.launches, fa.ATTENTION_GRU_BWD_BF16.launches)
    got = fa._launch_bwd(*args)
    torch.cuda.synchronize()
    assert (fa.ATTENTION_GRU_BWD_BF16_SM90.launches - before[0],
            fa.ATTENTION_GRU_BWD_BF16.launches - before[1]) == (0, 1)
    dy, ep, ev, dmask, hprev, saved, alpha, m, wa, v, wctx, wg = args
    plain = fa.attention_gru_backward_reference(dy, ep, ev, dmask, hprev, saved, alpha, wa, ba,
                                                v, wctx, wg)
    for name, a, b in zip(("dxw", "dctx", "dh0", "dep", "dwa", "dba", "dv"), got, plain):
        assert _scale_err(a, b) <= BF16_TOL, (name, _scale_err(a, b))
    nmt, _ = _agru_bf16_bwd_case(dev, 6, 32, 64, 512, 1024, seed=53)
    new, old = fa._launch_bwd(*nmt), fa._launch_bwd_persistent(*nmt)
    for name, a, b in zip(("dxw", "dctx", "dh0", "dep", "dwa", "dba", "dv"), new, old):
        assert _scale_err(a, b) <= BF16_TOL, (name, _scale_err(a, b))
