"""Kernel 9's plain version and its backward against the JAX package, on the CPU.

``conv1x1_stats_reference`` (y = x·wᵀ + b with the column sums s and q of
y and y²) is held against the JAX package's Pallas kernel
``pallas_conv1x1_bn.conv1x1_stats`` run in interpret mode, in float32 at
the shapes tests/test_conv_stats.py runs it: y within 1e-5 of its scale
max(1, max |y|), s and q within 1e-5 of theirs (Σ|y| and Σy² per channel).
Both are sums over up to 1024 (y) and 2048 (s, q) terms in another order,
whose float32 rounding reaches ~1e-5 of the largest |y| at K = 1024.
Shapes the TPU gate refuses (N = 64, ragged M) are held against numpy in
float64. The backward (``_Conv1x1Stats``, the JAX ``_bwd`` in
torch.matmul) is held against ``jax.vjp`` of the interpreted kernel at
rtol 1e-4 and an absolute 1e-5 of each gradient's scale (dw sums 512 rows
of x·g, so an entry near 0 carries the rounding of terms ~10^4 times
larger), and against autograd through the plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import pallas_conv1x1_bn as pcb
from paddle_tpu_torch.ops import fused_conv1x1_bn as fc
from torch_bf16_checks import assert_within_one_ulp, bf16, f32

torch.set_num_threads(1)


def _inputs(M, K, N, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(M, K).astype(np.float32)
    w = (rng.randn(K, N) * 0.1).astype(np.float32)      # the JAX function's [K, N]
    b = (rng.randn(N) * 0.1).astype(np.float32)
    return x, w, b


def _port(x, w, b):
    """The port's operands: w as the conv parameter is stored, [N, K]."""
    return (torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(w.T)),
            None if b is None else torch.from_numpy(b))


def _scale(a):
    return max(1.0, float(np.abs(a).max()))


def _assert_stats(y, s, q, y_ref, s_ref, q_ref):
    y_ref = np.asarray(y_ref, np.float64)
    np.testing.assert_allclose(y, y_ref, rtol=0, atol=1e-5 * _scale(y_ref))
    np.testing.assert_array_less(np.abs(s - np.asarray(s_ref)), 1e-5 * np.abs(y_ref).sum(0) + 1e-30)
    np.testing.assert_array_less(np.abs(q - np.asarray(q_ref)), 1e-5 * (y_ref ** 2).sum(0) + 1e-30)


@pytest.mark.parametrize("M,K,N", [(512, 64, 256), (1024, 256, 128), (2048, 1024, 512),
                                   (896, 128, 128)])
def test_plain_version_matches_the_interpreted_kernel(M, K, N):
    x, w, b = _inputs(M, K, N, seed=M + N)
    assert pcb.supported(M, K, N, 4)
    jy, js, jq = pcb.conv1x1_stats(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), True)
    y, s, q = fc.conv1x1_stats_reference(*_port(x, w, b))
    _assert_stats(y.numpy(), s.numpy(), q.numpy(), np.asarray(jy), np.asarray(js),
                  np.asarray(jq))


@pytest.mark.parametrize("M,K,N", [(1000, 64, 64), (37, 5, 3), (203, 24, 64)])
@pytest.mark.parametrize("bias", [False, True])
def test_plain_version_matches_numpy_where_the_tpu_gate_refuses(M, K, N, bias):
    x, w, b = _inputs(M, K, N, seed=M)
    assert not pcb.supported(M, K, N, 4)
    b = b if bias else None
    y64 = x.astype(np.float64) @ w.astype(np.float64)
    if bias:
        y64 = y64 + b
    y, s, q = fc.conv1x1_stats_reference(*_port(x, w, b))
    _assert_stats(y.numpy(), s.numpy(), q.numpy(), y64, y64.sum(0), (y64 ** 2).sum(0))


def test_backward_matches_jax_vjp_of_the_interpreted_kernel():
    M, K, N = 512, 64, 256
    x, w, b = _inputs(M, K, N, seed=0)
    rng = np.random.RandomState(1)
    dy = rng.randn(M, N).astype(np.float32)
    ds = rng.randn(N).astype(np.float32)
    dq = (rng.randn(N) * 0.1).astype(np.float32)
    _, vjp = jax.vjp(lambda x, w, b: pcb.conv1x1_stats(x, w, b, True),
                     jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    jdx, jdw, jdb = vjp((jnp.asarray(dy), jnp.asarray(ds), jnp.asarray(dq)))

    leaves = [t.requires_grad_() for t in _port(x, w, b)]
    outs = fc.conv1x1_stats(*leaves)
    dx, dw, db = torch.autograd.grad(outs, leaves, [torch.from_numpy(a) for a in (dy, ds, dq)])
    for got, want in ((dx, jdx), (dw, np.asarray(jdw).T), (db, jdb)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5 * _scale(want))


@pytest.mark.parametrize("bias", [False, True])
def test_backward_matches_autograd_through_the_plain_version(bias):
    M, K, N = 203, 24, 64
    x, w, b = _inputs(M, K, N, seed=2)
    b = b if bias else None
    rng = np.random.RandomState(3)
    cts = [torch.from_numpy(rng.randn(*s).astype(np.float32)) for s in ((M, N), (N,), (N,))]
    leaves = [t.requires_grad_() for t in _port(x, w, b) if t is not None]
    got = torch.autograd.grad(fc.conv1x1_stats(*leaves, *([] if bias else [None])), leaves, cts)
    plain = [t.detach().clone().requires_grad_() for t in leaves]
    want = torch.autograd.grad(fc.conv1x1_stats_reference(*plain, *([] if bias else [None])),
                               plain, cts)
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-5, atol=1e-5)


def test_the_autograd_path_is_the_kernels_backward(monkeypatch):
    """Under autograd the CPU path goes through ``_Conv1x1Stats`` (the
    backward the card uses), without it through the plain version."""
    seen = []
    orig = fc._Conv1x1Stats.apply
    monkeypatch.setattr(fc._Conv1x1Stats, "apply", lambda *a: seen.append(1) or orig(*a))
    x, w, _ = _port(*_inputs(16, 8, 4, seed=4))
    fc.conv1x1_stats(x, w)
    assert seen == []
    fc.conv1x1_stats(x, w.requires_grad_())
    assert seen == [1]
    with torch.no_grad():
        fc.conv1x1_stats(x, w)
    assert seen == [1]


# (M, K, N, taken): kernel 9's limits (fused_conv1x1_bn.supported), each at
# its edge and one past it, and ResNet-50's largest 1x1 conv at B = 64
_EDGES = [
    (1, 1, 1, True),
    (207936, 64, 256, True),                        # ResNet-50 stage 2, 57² at B = 64
    (8388480 + 1, 1, 1, True),                      # past PR 4's 65535 row tiles
    (fc.MAX_M, 1, 1, True), (fc.MAX_M + 1, 1, 1, False),   # M + 127 within an int
    (fc.MAX_M, 4096, 1, True), (fc.MAX_M, 4097, 1, False),  # a block's stage count
    (1, 1, fc.MAX_N, True), (1, 1, fc.MAX_N + 1, False),     # 65535 column tiles
    (1, 32768, fc.MAX_N, True), (1, 32769, fc.MAX_N, False),  # w's halves' stride < 2^40
    (1, fc.MAX_K, 1, True), (1, fc.MAX_K + 1, 1, False),     # Kp within an int
    (0, 64, 64, False), (64, 0, 64, False), (64, 64, 0, False),
]


@pytest.mark.parametrize("M,K,N,taken", _EDGES)
def test_supported_at_its_edges(M, K, N, taken):
    """What kernel 9 takes on the card: M up to the int range (2^31 - 128,
    so that the row tile count M + 127 fits), ceil(M / 128) * ceil(K / 32)
    stages a block within an int, N up to 65535 column tiles of 128, and
    the stride of w's TF32 halves ([2][N][Kp] floats) below 2^40 bytes."""
    assert fc.MAX_M == 2 ** 31 - 128 and fc.MAX_N == 8388480
    assert fc.supported(M, K, N) is taken


def test_plain_version_takes_m_past_the_old_limit(monkeypatch):
    """On the CPU the wrapper runs the plain version at any M: 8,388,481
    rows (one past PR 4's 65535 tiles of 128) at K = N = 1, against numpy
    in float64, and asks no gate (here refusing everything)."""
    monkeypatch.setattr(fc, "supported", lambda *a: False)
    M = 8388481
    rng = np.random.RandomState(5)
    x = rng.randn(M, 1).astype(np.float32)
    w, b = np.float32([[0.5]]), np.float32([0.25])
    y, s, q = fc.conv1x1_stats(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    y64 = x.astype(np.float64) * 0.5 + 0.25
    assert y.shape == (M, 1) and torch.equal(y, torch.from_numpy(x * w[0, 0] + b[0]))
    assert abs(float(s[0]) - y64.sum()) <= 1e-5 * np.abs(y64).sum()
    assert abs(float(q[0]) - (y64 ** 2).sum()) <= 1e-5 * (y64 ** 2).sum()


def test_the_wrapper_refuses_an_empty_dimension_on_every_device():
    x, w, b = _port(*_inputs(4, 3, 2, seed=6))
    with pytest.raises(ValueError, match="M, K, N >= 1"):
        fc.conv1x1_stats(x[:0], w, b)


# bf16: one ulp of y, dx and dw taken at no less than this fraction of their
# scale (a float32 sum that cancels far below its terms differs between two
# summation orders by several of its own bf16 ulps)
CANCEL_FLOOR = 2.0 ** -12


def _bf16_inputs(M, K, N, seed):
    x, w, b = (bf16(a) for a in _inputs(M, K, N, seed))
    return x, w, b


def test_bf16_plain_version_matches_the_interpreted_kernel():
    """At bf16 x, w and b the plain version and ``_run`` in interpret mode
    both accumulate the product in float32, add b widened and round y
    once: y within one bf16 ulp; s and q, float32 sums of the rounded y,
    within the float32 test's 1e-5 of Σ|y| and Σy² plus what the elements
    of y that rounded to a neighbour add to the column's sum."""
    M, K, N = 512, 128, 256
    (jx, x), (jw, w), (jb, b) = _bf16_inputs(M, K, N, seed=7)
    assert pcb.supported(M, K, N, 2)
    jy, js, jq = pcb._run(jx, jw, jb, True)
    y, s, q = fc.conv1x1_stats_reference(x, w.t().contiguous(), b)
    assert y.dtype == torch.bfloat16 and s.dtype == q.dtype == torch.float32
    assert_within_one_ulp(y, jy, "y", floor=CANCEL_FLOOR)
    yr, yp = f32(jy).astype(np.float64), f32(y).astype(np.float64)
    np.testing.assert_array_less(np.abs(s.numpy() - np.asarray(js)),
                                 1e-5 * np.abs(yr).sum(0) + np.abs(yp - yr).sum(0))
    np.testing.assert_array_less(np.abs(q.numpy() - np.asarray(jq)),
                                 1e-5 * (yr ** 2).sum(0) + np.abs(yp ** 2 - yr ** 2).sum(0))


def test_bf16_backward_matches_jax_vjp_of_the_interpreted_kernel():
    """The backward at bf16 operands against ``jax.vjp`` of the interpreted
    kernel: g = g32 rounded to bf16, dx and dw accumulated in float32 and
    rounded once (one bf16 ulp); db = Σ g32 unrounded, then rounded to b's
    bf16, at the float32 test's bound."""
    M, K, N = 512, 64, 256
    (jx, x), (jw, w), (jb, b) = _bf16_inputs(M, K, N, seed=8)
    rng = np.random.RandomState(9)
    jdy, dy = bf16(rng.randn(M, N).astype(np.float32))
    ds = rng.randn(N).astype(np.float32)
    dq = (rng.randn(N) * 0.1).astype(np.float32)
    _, vjp = jax.vjp(lambda x_, w_, b_: pcb.conv1x1_stats(x_, w_, b_, True), jx, jw, jb)
    jdx, jdw, jdb = vjp((jdy, jnp.asarray(ds), jnp.asarray(dq)))
    leaves = [x.requires_grad_(), w.t().contiguous().requires_grad_(), b.requires_grad_()]
    dx, dw, db = torch.autograd.grad(fc.conv1x1_stats(*leaves), leaves,
                                     [dy, torch.from_numpy(ds), torch.from_numpy(dq)])
    assert dx.dtype == dw.dtype == db.dtype == torch.bfloat16
    assert_within_one_ulp(dx, jdx, "dx", floor=CANCEL_FLOOR)
    assert_within_one_ulp(dw, f32(jdw).T, "dw", floor=CANCEL_FLOOR)
    want = f32(jdb)
    np.testing.assert_allclose(f32(db), want, rtol=1e-4, atol=1e-5 * _scale(want))


# the card's bound on the bf16 body's s and q (chip_smoke.py's
# CONV_STATS_BF16_TOL): of Σ|y| and Σy² per channel, where an element of y
# may round to a neighbour of the other's
CONV_STATS_BF16_TOL = 1e-3


def _truncated_f32(v):
    """float64 values rounded toward zero to float32: the tensor core's add
    into its float32 accumulator."""
    r = v.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(v)
    r[over] = np.nextafter(r[over], np.float32(0.0))
    return r


def test_bf16_one_accumulator_over_k_matches_the_interpreted_kernel():
    """The bf16 body's arithmetic (csrc/conv1x1_bn.cu, conv1x1_bf16_tile)
    emulated at K = 2048: one float32 accumulator over the whole K loop, to
    which each 16-feature step's exact bf16 products are added rounding
    toward zero, with no per-stage sum apart; then y = bf16(acc + b) and s,
    q summed from the rounded y. Against ``_run`` in interpret mode at
    bf16: y within one bf16 ulp (at no less than 2^-12 of its scale), s and
    q within CONV_STATS_BF16_TOL of Σ|y| and Σy²."""
    M, K, N = 256, 2048, 128
    (jx, x), (jw, w), (jb, b) = _bf16_inputs(M, K, N, seed=11)
    assert pcb.supported(M, K, N, 2)
    jy, js, jq = pcb._run(jx, jw, jb, True)
    xf, wf = f32(x).astype(np.float64), f32(w).astype(np.float64)     # w [K, N]
    acc = np.zeros((M, N), np.float32)
    for k0 in range(0, K, 16):
        acc = _truncated_f32(acc.astype(np.float64) + xf[:, k0:k0 + 16] @ wf[k0:k0 + 16])
    y = torch.from_numpy(acc + f32(b)).to(torch.bfloat16)
    assert_within_one_ulp(y, jy, "y", floor=CANCEL_FLOOR)
    yr = f32(jy).astype(np.float64)
    yf = f32(y).astype(np.float64)
    assert (np.abs(yf.sum(0) - np.asarray(js)) <= CONV_STATS_BF16_TOL * np.abs(yr).sum(0)).all()
    assert (np.abs((yf * yf).sum(0) - np.asarray(jq)) <= CONV_STATS_BF16_TOL * (yr ** 2).sum(0)).all()


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_the_wrapper_refuses_other_operand_types(dtype):
    """Only float32 and bf16, one type for x, w and b, on every device."""
    x, w, b = _port(*_inputs(16, 8, 4, seed=10))
    with pytest.raises(ValueError, match="float32 or bf16"):
        fc.conv1x1_stats(x.to(dtype), w.to(dtype), b.to(dtype))
    with pytest.raises(ValueError, match="w is torch.float32"):
        fc.conv1x1_stats(x.to(torch.bfloat16), w, b)
