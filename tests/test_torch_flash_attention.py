"""The port's flash-attention plain versions and ``full_attention`` against
the JAX package, on the CPU.

``paddle_tpu.ops.pallas_attention`` run by the Pallas interpreter
(``_run_fwd`` / ``_run_bwd(..., interpret=True)`` for kernels 10, 11 and
12, ``flash_attention(..., interpret=True)``'s custom VJP for the whole
function) and ``paddle_tpu_torch.ops.flash_attention``'s plain versions
(what the CUDA kernels are held against on the card) get the same seeded
numpy inputs, with lengths [T, T - 77, 0] so that a row sees no key.
Tolerances: out 2e-5 absolute (tests/test_pallas_attention.py's flash-vs-XLA
bound); lse to float32 rounding on rows that see a key and exactly -1e30 on
the row that sees none; gradients 1e-4 of max(1, max |JAX|) (sums over 256
keys or queries in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import pallas_attention as pa
from paddle_tpu.parallel.sequence_parallel import full_attention as jax_full_attention
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.parallel import sequence_parallel as sp
from torch_bf16_checks import assert_within_one_ulp, assert_within_scale, bf16, f32

torch.set_num_threads(1)
B, T, H, D = 3, 256, 2, 32
LENGTHS = np.array([T, T - 77, 0], np.int32)
OUT_ATOL = 2e-5
GRAD_TOL = 1e-4


def _inputs(seed, n=4, shape=(B, T, H, D)):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(n)]


def _bhtd(a):
    return jnp.asarray(np.ascontiguousarray(np.transpose(a, (0, 2, 1, 3))))


def _t(a):
    return torch.from_numpy(np.array(a))


def _close_to_scale(got, want, what):
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max()) / max(1.0, float(np.abs(want).max()))
    assert err <= GRAD_TOL, (what, err)


@pytest.mark.parametrize("causal", [False, True])
def test_forward_reference_matches_the_pallas_kernel(causal):
    """Kernel 10's plain version against ``_run_fwd`` in interpret mode:
    out, and lse with -1e30 where no key is visible."""
    q, k, v, _ = _inputs(0)
    want_out, want_lse = pa._run_fwd(_bhtd(q), _bhtd(k), _bhtd(v), jnp.asarray(LENGTHS),
                                     causal, pa.BLOCK_Q, pa.BLOCK_K, True)
    out, lse = fa.flash_forward_reference(_t(q), _t(k), _t(v), _t(LENGTHS), causal)
    assert out.shape == (B, T, H, D) and lse.shape == (B, H, T)
    np.testing.assert_allclose(out.numpy(), np.transpose(np.asarray(want_out), (0, 2, 1, 3)),
                               atol=OUT_ATOL, rtol=0)
    want_lse = np.asarray(want_lse)
    np.testing.assert_allclose(lse.numpy()[:2], want_lse[:2], rtol=1e-6, atol=1e-6)
    assert (lse.numpy()[2] == np.float32(-1e30)).all() and (want_lse[2] == np.float32(-1e30)).all()
    assert not out.numpy()[2].any()                  # the row that sees no key


@pytest.mark.parametrize("causal", [False, True])
def test_backward_references_match_the_pallas_kernels(causal):
    """Kernels 11 and 12's plain versions against ``_run_bwd`` in interpret
    mode, both given the Pallas forward's out and lse."""
    q, k, v, do = _inputs(1)
    jq, jk, jv, jdo = (_bhtd(a) for a in (q, k, v, do))
    jlen = jnp.asarray(LENGTHS)
    out, lse = pa._run_fwd(jq, jk, jv, jlen, causal, pa.BLOCK_Q, pa.BLOCK_K, True)
    want = pa._run_bwd(jq, jk, jv, jdo, out, lse, jlen, causal, pa.BLOCK_Q, pa.BLOCK_K, True)
    out_t = _t(np.transpose(np.asarray(out), (0, 2, 1, 3)))
    delta = torch.sum(_t(do) * out_t, dim=-1).transpose(1, 2).contiguous()
    args = (_t(q), _t(k), _t(v), _t(do), _t(np.asarray(lse)), delta, _t(LENGTHS), causal)
    dq = fa.flash_dq_reference(*args)
    dk, dv = fa.flash_dkv_reference(*args)
    for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        _close_to_scale(got.numpy(), np.transpose(np.asarray(w), (0, 2, 1, 3)), name)
    # keys past the length and the row of length 0 get nothing
    assert not dk.numpy()[1, T - 77:].any() and not dv.numpy()[2].any()


@pytest.mark.parametrize("causal", [False, True])
def test_autograd_matches_jax_grad_of_the_pallas_custom_vjp(causal):
    """The port's ``flash_attention`` (the plain versions on the CPU, through
    its ``torch.autograd.Function``) against ``jax.grad`` of
    ``flash_attention(..., interpret=True)``, on strided views of one fused
    [B, T, 3, H, D] tensor as the multi-head layer passes them."""
    q, k, v, cot = _inputs(2)
    jlen = jnp.asarray(LENGTHS)

    def jloss(q_, k_, v_):
        o = pa.flash_attention(q_, k_, v_, lengths=jlen, causal=causal, interpret=True)
        return jnp.sum(o * jnp.asarray(cot)), o

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qkv = torch.from_numpy(np.stack([q, k, v], axis=2)).requires_grad_()
    before = [kern.launches for kern in fa.KERNELS]
    out = fa.flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                             lengths=_t(LENGTHS), causal=causal)
    (out * _t(cot)).sum().backward()
    assert [kern.launches for kern in fa.KERNELS] == before   # the CPU launches nothing
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=OUT_ATOL, rtol=0)
    for i, name in enumerate(("dq", "dk", "dv")):
        _close_to_scale(qkv.grad[:, :, i].numpy(), jgrads[i], name)


def test_without_gradients_the_forward_alone_runs():
    """Under no_grad (the test pass) the same output, with no lse kept; the
    default lengths are full."""
    q, k, v, _ = _inputs(3)
    with torch.no_grad():
        out = fa.flash_attention(_t(q), _t(k), _t(v), causal=True)
    full = torch.full((B,), T, dtype=torch.int32)
    want, _ = fa.flash_forward_reference(_t(q), _t(k), _t(v), full, True)
    np.testing.assert_array_equal(out.numpy(), want.numpy())
    ref = jax_full_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=OUT_ATOL, rtol=0)


def _full_case(Tq, Tk, q_offset, kv_offset, causal, dtype="float32"):
    name = f"{Tq}-{Tk}-{q_offset}-{kv_offset}-{causal}"
    return pytest.param(Tq, Tk, q_offset, kv_offset, causal, dtype,
                        id=name if dtype == "float32" else f"{name}-{dtype}")


@pytest.mark.parametrize("Tq,Tk,q_offset,kv_offset,causal,dtype", [
    _full_case(256, 256, 0, 0, False), _full_case(256, 256, 0, 0, True),
    _full_case(64, 256, 192, 0, True), _full_case(128, 96, 0, 32, True),
    _full_case(100, 150, 50, 0, False), _full_case(96, 96, 64, 64, True),
    _full_case(128, 128, 0, 0, True, "bfloat16")])
def test_full_attention_matches_the_jax_package(monkeypatch, Tq, Tk, q_offset, kv_offset,
                                                causal, dtype):
    """The plain path (the JAX XLA branch) with offsets, Tq != Tk and ragged
    lengths, forward and gradients; on the CPU it never reaches the flash
    function. In bf16 (inputs x 3, so that the softmax is peaked) both keep
    the scores, the softmax and the PV product in float32 and round out
    once: out within one bf16 ulp, gradients within 1e-2 of scale."""
    rng = np.random.RandomState(Tq + Tk + q_offset)
    q = rng.randn(B, Tq, H, D).astype(np.float32)
    k, v = (rng.randn(B, Tk, H, D).astype(np.float32) for _ in range(2))
    cot = rng.randn(B, Tq, H, D).astype(np.float32)
    if dtype == "bfloat16":
        jq, q = bf16(3 * q)
        jk, k = bf16(3 * k)
        jv, v = bf16(3 * v)
        _, cot_t = bf16(cot)
        jcot = jnp.asarray(f32(cot_t))
    else:
        jq, jk, jv, jcot = (jnp.asarray(a) for a in (q, k, v, cot))
        q, k, v = (_t(a) for a in (q, k, v))
        cot_t = _t(cot)
    lens = np.array([Tk + kv_offset, kv_offset + Tk // 2, 0], np.int32)
    jlen = jnp.asarray(lens)

    def jloss(q_, k_, v_):
        o = jax_full_attention(q_, k_, v_, lengths=jlen, causal=causal,
                               q_offset=q_offset, kv_offset=kv_offset)
        return jnp.sum(o.astype(jnp.float32) * jcot), o

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(jq, jk, jv)
    leaves = [a.clone().requires_grad_() for a in (q, k, v)]
    calls = []
    monkeypatch.setattr(sp, "flash_attention", lambda *a, **kw: calls.append(1))
    out = sp.full_attention(*leaves, lengths=_t(lens), causal=causal,
                            q_offset=q_offset, kv_offset=kv_offset)
    assert calls == []
    (out.float() * cot_t.float()).sum().backward()
    if dtype == "bfloat16":
        assert out.dtype == torch.bfloat16 and jout.dtype == jnp.bfloat16
        assert_within_one_ulp(out, jout, "out")
        for leaf, g, name in zip(leaves, jgrads, ("dq", "dk", "dv")):
            assert leaf.grad.dtype == torch.bfloat16
            assert_within_scale(leaf.grad, g, name)
        return
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=OUT_ATOL, rtol=0)
    for leaf, g, name in zip(leaves, jgrads, ("dq", "dk", "dv")):
        _close_to_scale(leaf.grad.numpy(), g, name)


def test_flash_and_plain_paths_differ_only_where_no_key_is_visible():
    """At full-size rows the flash function and the plain path agree; at a
    row that sees no key flash gives zeros and the plain path the uniform
    softmax over -1e30 (the layer masks such rows)."""
    q, k, v, _ = _inputs(4)
    lens = _t(LENGTHS)
    flash = fa.flash_attention(_t(q), _t(k), _t(v), lengths=lens, causal=True)
    plain = sp.full_attention(_t(q), _t(k), _t(v), lengths=lens, causal=True)
    np.testing.assert_allclose(flash[:2].numpy(), plain[:2].numpy(), atol=OUT_ATOL, rtol=0)
    assert not flash[2].numpy().any()
    np.testing.assert_allclose(plain[2].numpy(), np.broadcast_to(v[2].mean(0), (T, H, D)),
                               atol=1e-5)


def test_the_wrapper_refuses_what_the_kernels_do_not_take():
    """The operand checks the card's path runs before a launch."""
    q = torch.zeros(2, 5, 3, 8)
    lens = torch.full((2,), 5, dtype=torch.int32)
    assert fa._check_operands(q, q, q, lens) == (2, 5, 3, 8)
    strided = torch.zeros(2, 5, 3, 3, 8)[:, :, 1]      # a qkv view
    assert fa._check_operands(strided, strided, strided, lens) == (2, 5, 3, 8)
    with pytest.raises(ValueError, match="float32"):
        fa._check_operands(q.double(), q, q, lens)
    with pytest.raises(ValueError, match="shape"):
        fa._check_operands(q, torch.zeros(2, 6, 3, 8), q, lens)
    with pytest.raises(ValueError, match="last dimension"):
        t = torch.zeros(2, 5, 8, 3).transpose(2, 3)
        fa._check_operands(t, t, t, lens)
    with pytest.raises(ValueError, match="lengths"):
        fa._check_operands(q, q, q, lens.long())
    with pytest.raises(ValueError, match="lengths"):
        fa._check_operands(q, q, q, lens[:1])
    with pytest.raises(ValueError, match="D <= 256"):
        wide = torch.zeros(1, 2, 1, 257)
        fa._check_operands(wide, wide, wide, torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError, match=r"\[B, T, H, D\]"):
        fa._check_operands(q[0], q[0], q[0], lens)


# one bf16 ulp taken at no less than this fraction of the scale: an element
# that float32 cancels to ~1e-6 of a scale of ~4 differs between two sum
# orders by ~5e-8, several of its own bf16 ulps (one of 49,152 in the
# forward; 32 of dq's in the causal backward, the first query rows)
CANCEL_FLOOR = 2.0 ** -12


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_references_match_the_pallas_kernels(causal):
    """At bf16 q, k, v (and dout), kernels 10, 11 and 12's plain versions
    against ``_run_fwd`` and ``_run_bwd`` in interpret mode: both widen the
    operands, keep the softmax, p, ds and every sum in float32 and round
    out, dq, dk and dv once, so each lies within one bf16 ulp (taken at no
    less than 2^-12 of the scale, where float32 sums cancel); lse is
    float32 and held at the float32 test's bound."""
    q, k, v, do = _inputs(5)
    jq, tq = bf16(q)
    jk, tk = bf16(k)
    jv, tv = bf16(v)
    jdo, tdo = bf16(do)
    bhtd = lambda a: jnp.transpose(a, (0, 2, 1, 3))
    btdh = lambda a: np.transpose(f32(a), (0, 2, 1, 3))
    jlen = jnp.asarray(LENGTHS)
    out, lse = pa._run_fwd(bhtd(jq), bhtd(jk), bhtd(jv), jlen, causal, pa.BLOCK_Q,
                           pa.BLOCK_K, True)
    assert out.dtype == jnp.bfloat16 and lse.dtype == jnp.float32
    got_out, got_lse = fa.flash_forward_reference(tq, tk, tv, _t(LENGTHS), causal)
    assert got_out.dtype == torch.bfloat16 and got_lse.dtype == torch.float32
    assert_within_one_ulp(got_out, btdh(out), "out", floor=CANCEL_FLOOR)
    np.testing.assert_allclose(got_lse.numpy()[:2], np.asarray(lse)[:2], rtol=1e-6, atol=1e-6)
    assert (got_lse.numpy()[2] == np.float32(-1e30)).all()

    want = pa._run_bwd(bhtd(jq), bhtd(jk), bhtd(jv), bhtd(jdo), out, lse, jlen, causal,
                       pa.BLOCK_Q, pa.BLOCK_K, True)
    out_t = torch.from_numpy(btdh(out)).to(torch.bfloat16)
    delta = torch.sum(tdo.float() * out_t.float(), dim=-1).transpose(1, 2).contiguous()
    args = (tq, tk, tv, tdo, _t(np.asarray(lse)), delta, _t(LENGTHS), causal)
    got = (fa.flash_dq_reference(*args),) + fa.flash_dkv_reference(*args)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16, name
        assert_within_one_ulp(g, btdh(w), name, floor=CANCEL_FLOOR)


# The arithmetic of the bf16 bodies for Hopper (csrc/flash_attn_fwd.cu and
# csrc/flash_attn_bwd.cu, flash_attn_*_bf16_sm90), emulated in plain torch:
# bf16 q, k, v and dout; scores as float32 sums of exact bf16 products; p
# and ds in two bf16 pieces, hi = bf16(x) and lo = bf16(x - hi), each
# multiplied exactly and summed in float32. The forward runs the kernel's
# online softmax over tiles of 128 keys in base 2 (the row max of the raw
# scores, then p = 2^(s scale log2(e) - m)), and adds each tile's two
# partial sums to o after scaling o by alpha; dQ sums each tile of 64 keys
# apart and adds it to dq.
SM90_SHAPE = (2, 256, 2, 64)
SM90_LENGTHS = np.array([256, 131], np.int32)
LOG2E = np.float32(1.4426950408889634)
# one bf16 ulp taken at no less than this fraction of the scale for the
# Hopper bodies: where dk, dv or out cancel to far below their terms, the
# lo piece's rounding (2^-17 of each p or ds) adds up to ~2^-20 of the
# scale, past one ulp at 2^-12 (CANCEL_FLOOR) for 1 element of 65,536 in
# some seeds; one ulp at 2^-11 is 2^-19. One piece (p rounded to bf16)
# puts ~10% of the outputs past this bound.
SM90_CANCEL_FLOOR = 2.0 ** -11


def _sm90_mask(lengths, T, causal):
    return fa._visible(lengths, T, T, causal)            # [B, 1, Tq, Tk]


def _pieces(x, n):
    """x as n bf16 pieces (hi = bf16(x), lo = bf16(x - hi)), lo 0 for n = 1."""
    hi = x.to(torch.bfloat16).float()
    return hi, ((x - hi).to(torch.bfloat16).float() if n == 2 else torch.zeros_like(x))


def _sm90_forward(q, k, v, lengths, causal, block=128, pieces=2):
    B, T, H, D = q.shape
    scale_log2 = torch.tensor(1.0 / np.sqrt(D), dtype=torch.float32) * torch.tensor(LOG2E)
    qf, kf, vf = (a.float().transpose(1, 2) for a in (q, k, v))     # [B, H, T, D]
    msk = _sm90_mask(lengths, T, causal)
    o = torch.zeros(B, H, T, D)
    m = torch.full((B, H, T), -1e30)
    l = torch.zeros(B, H, T)
    for k0 in range(0, T, block):
        vis = msk[..., k0:k0 + block]
        s = torch.where(vis, qf @ kf[:, :, k0:k0 + block].transpose(-1, -2),
                        torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(-1) * scale_log2)
        alpha = torch.exp2(m - m_new)
        p = torch.where(vis, torch.exp2(s * scale_log2 - m_new[..., None]), torch.tensor(0.0))
        l = l * alpha + p.sum(-1)
        hi, lo = _pieces(p, pieces)
        vt = vf[:, :, k0:k0 + block]
        o = o * alpha[..., None] + (lo @ vt + hi @ vt)
        m = m_new
    l_safe = torch.clamp(l, min=1e-20)
    out = (o * (1.0 / l_safe)[..., None]).transpose(1, 2).to(torch.bfloat16)
    lse = torch.where(l > 0, m * np.float32(np.log(2.0)) + torch.log(l_safe),
                      torch.tensor(-1e30))
    return out, lse


def _sm90_dkv(q, k, v, dout, lse, delta, lengths, causal, pieces=2):
    B, T, H, D = q.shape
    scale = torch.tensor(1.0 / np.sqrt(D), dtype=torch.float32)
    qf, kf, vf, df = (a.float().transpose(1, 2) for a in (q, k, v, dout))
    vis = _sm90_mask(lengths, T, causal).transpose(-1, -2)          # [B, 1, Tk, Tq]
    st = kf @ qf.transpose(-1, -2)                                   # (q . k)^T
    pt = torch.where(vis, torch.exp2(st * (scale * torch.tensor(LOG2E))
                                     - (lse * torch.tensor(LOG2E))[:, :, None, :]),
                     torch.tensor(0.0))
    dpt = vf @ df.transpose(-1, -2)                                  # (dout . v)^T
    dst = pt * (dpt - delta[:, :, None, :]) * scale
    phi, plo = _pieces(pt, pieces)
    dhi, dlo = _pieces(dst, pieces)
    dv = plo @ df + phi @ df
    dk = dlo @ qf + dhi @ qf
    return dk.transpose(1, 2).to(torch.bfloat16), dv.transpose(1, 2).to(torch.bfloat16)


def _truncated_scores(a, b):
    """a . b^T over [..., T, D] operands as the tensor core sums it: each
    k-step's 16 exact products added to the float32 accumulator rounding
    toward zero."""
    acc = torch.zeros(a.shape[:-1] + (b.shape[-2],), dtype=torch.float64)
    for d0 in range(0, a.shape[-1], 16):
        v = acc + a[..., d0:d0 + 16].double() @ b[..., d0:d0 + 16].double().transpose(-1, -2)
        r = v.float().double()
        acc = torch.where(r.abs() > v.abs(), torch.nextafter(r.float(), torch.tensor(0.0)).double(),
                          r)
    return acc.float()


def _sm90_dq(q, k, v, dout, lse, delta, lengths, causal, block=64, pieces=2, truncated=False):
    B, T, H, D = q.shape
    scale = torch.tensor(1.0 / np.sqrt(D), dtype=torch.float32)
    qf, kf, vf, df = (a.float().transpose(1, 2) for a in (q, k, v, dout))
    vis = _sm90_mask(lengths, T, causal)                             # [B, 1, Tq, Tk]
    dot = _truncated_scores if truncated else (lambda a, b: a @ b.transpose(-1, -2))
    p = torch.where(vis, torch.exp2(dot(qf, kf) * (scale * torch.tensor(LOG2E))
                                    - (lse * torch.tensor(LOG2E))[..., None]),
                    torch.tensor(0.0))
    ds = p * (dot(df, vf) - delta[..., None]) * scale
    dq = torch.zeros(B, H, T, D)
    for k0 in range(0, T, block):                  # a tile's partial, added with a rounded add
        hi, lo = _pieces(ds[..., k0:k0 + block], pieces)
        kt = kf[:, :, k0:k0 + block]
        dq = dq + (lo @ kt + hi @ kt)
    return dq.transpose(1, 2).to(torch.bfloat16)


@pytest.mark.parametrize("causal", [False, True])
def test_sm90_rounding_design_matches_the_pallas_kernels(causal):
    """The Hopper bodies' arithmetic (p and ds in two bf16 pieces, products
    of bf16 operands summed in float32, dq's key tiles summed apart)
    against ``_run_fwd`` and ``_run_bwd`` in interpret mode at bf16, on
    ragged lengths: out, dq, dk and dv within one bf16 ulp (taken at no
    less than SM90_CANCEL_FLOOR of the scale), lse to float32 rounding. Two
    pieces keep ~16 bits of p and ds; one piece alone (p and ds rounded to
    bf16) fails the same bound."""
    Bs, Ts, Hs, Ds = SM90_SHAPE
    rng = np.random.RandomState(11)
    q, k, v, do = (rng.randn(Bs, Ts, Hs, Ds).astype(np.float32) for _ in range(4))
    jq, tq = bf16(q)
    jk, tk = bf16(k)
    jv, tv = bf16(v)
    jdo, tdo = bf16(do)
    bhtd = lambda a: jnp.transpose(a, (0, 2, 1, 3))
    btdh = lambda a: np.transpose(f32(a), (0, 2, 1, 3))
    jlen = jnp.asarray(SM90_LENGTHS)
    out, lse = pa._run_fwd(bhtd(jq), bhtd(jk), bhtd(jv), jlen, causal, pa.BLOCK_Q,
                           pa.BLOCK_K, True)
    got_out, got_lse = _sm90_forward(tq, tk, tv, _t(SM90_LENGTHS), causal)
    assert_within_one_ulp(got_out, btdh(out), "out", floor=SM90_CANCEL_FLOOR)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse), rtol=1e-6, atol=1e-5)

    want = pa._run_bwd(bhtd(jq), bhtd(jk), bhtd(jv), bhtd(jdo), out, lse, jlen, causal,
                       pa.BLOCK_Q, pa.BLOCK_K, True)
    out_t = torch.from_numpy(btdh(out)).to(torch.bfloat16)
    delta = torch.sum(tdo.float() * out_t.float(), dim=-1).transpose(1, 2).contiguous()
    args = (tq, tk, tv, tdo, _t(np.asarray(lse)), delta, _t(SM90_LENGTHS), causal)
    dk, dv = _sm90_dkv(*args)
    dq = _sm90_dq(*args)
    for name, g, w in (("dq", dq, want[0]), ("dk", dk, want[1]), ("dv", dv, want[2])):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16, name
        assert_within_one_ulp(g, btdh(w), name, floor=SM90_CANCEL_FLOOR)
    one_out, _ = _sm90_forward(tq, tk, tv, _t(SM90_LENGTHS), causal, pieces=1)
    one_dk, one_dv = _sm90_dkv(*args, pieces=1)
    one_dq = _sm90_dq(*args, pieces=1)
    for name, g, w in (("out", one_out, out), ("dq", one_dq, want[0]), ("dk", one_dk, want[1]),
                       ("dv", one_dv, want[2])):
        with pytest.raises(AssertionError):
            assert_within_one_ulp(g, btdh(w), name, floor=SM90_CANCEL_FLOOR)


def test_sm90_route_takes_the_lm_views_and_leaves_the_rest(monkeypatch):
    """The route of the bf16 forward, dQ and dK/dV (``flash_attention.sm90_takes``,
    decided from the dtype, D, strides and base addresses alone): the
    layer's strided views of a fused [B, T, 3, H, D] qkv at D = 64 and 128
    take the Hopper bodies; D = 40, a view whose base is one element off,
    float32, and a [B, H, T, D] tensor seen as [B, T, H, D] (strides not
    nested outwards) take the float32 body's bf16 instances. ``_launch_dq``
    and ``_launch_dkv`` pick their kernel by it (the launch recorded in
    place of a build); dQ also where lse and delta are not 16-byte aligned,
    which only dK/dV's TMA reads of them need."""
    for D_ in (64, 128):
        qkv = torch.zeros(2, 100, 3, 4, D_, dtype=torch.bfloat16)
        views = (qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
        dout = torch.zeros(2, 100, 4, D_, dtype=torch.bfloat16)
        assert fa.sm90_takes(*views) and fa.sm90_takes(*views, dout)
        assert not fa.sm90_takes(*(t.float() for t in views))
    narrow = torch.zeros(2, 100, 3, 4, 40, dtype=torch.bfloat16)
    assert not fa.sm90_takes(narrow[:, :, 0], narrow[:, :, 1], narrow[:, :, 2])
    flat = torch.zeros(2 * 100 * 4 * 64 + 1, dtype=torch.bfloat16)
    shifted = flat[1:].view(2, 100, 4, 64)
    assert shifted.data_ptr() % 16 == 2
    assert not fa.sm90_takes(shifted) and fa.sm90_takes(flat[:-1].view(2, 100, 4, 64))
    heads_first = torch.zeros(2, 4, 100, 64, dtype=torch.bfloat16).transpose(1, 2)
    assert not fa.sm90_takes(heads_first)
    ok = torch.zeros(2, 100, 4, 64, dtype=torch.bfloat16)
    assert not fa.sm90_takes(ok, heads_first)              # one operand refused: all refused

    picked = []
    for kern in fa.KERNELS:
        monkeypatch.setattr(kern, "launch", lambda device, *a, _k=kern: picked.append(_k.symbol))

    def route(qkv, dout, stats_offset=0):
        B_, T_, _, H_, _ = qkv.shape
        stats = torch.zeros(2 * B_ * H_ * T_ + stats_offset)[stats_offset:]
        lse, delta = stats[:B_ * H_ * T_].view(B_, H_, T_), stats[B_ * H_ * T_:].view(B_, H_, T_)
        args = (qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], dout, lse, delta,
                torch.full((B_,), T_, dtype=torch.int32), True)
        picked.clear()
        fa._launch_dq(*args)
        fa._launch_dkv(*args)
        return tuple(picked)

    for D_ in (64, 128):
        qkv = torch.zeros(2, 100, 3, 4, D_, dtype=torch.bfloat16)
        dout = torch.zeros(2, 100, 4, D_, dtype=torch.bfloat16)
        assert route(qkv, dout) == ("flash_attn_dq_bf16_sm90", "flash_attn_dkv_bf16_sm90")
        assert route(qkv, dout, stats_offset=1) == ("flash_attn_dq_bf16_sm90",
                                                    "flash_attn_dkv_bf16")
        assert route(qkv.float(), dout.float()) == ("flash_attn_dq", "flash_attn_dkv")
        flat = torch.zeros(2 * 100 * 4 * D_ + 1, dtype=torch.bfloat16)
        assert route(qkv, flat[1:].view(2, 100, 4, D_)) == ("flash_attn_dq_bf16",
                                                            "flash_attn_dkv_bf16")
    assert route(narrow, torch.zeros(2, 100, 4, 40, dtype=torch.bfloat16)) == (
        "flash_attn_dq_bf16", "flash_attn_dkv_bf16")


def test_sm90_dq_past_one_spacing_only_by_the_truncating_score_sums():
    """Why the card holds the dQ body to 2 bf16 spacings, not 1
    (chip_smoke.py's SM90_ULPS): at the GPU test's non-causal T = 1000 case
    (tests/test_torch_cuda.py::test_flash_sm90_bodies_match_plain_versions,
    B = 3, H = 2, D = 64, lengths with a 1 and a 0) the emulated body with
    round-to-nearest score sums lies within one spacing of the plain
    version, and with the tensor core's truncating sums of q . k^T and
    dout . v^T (ds = p (dp - delta) cancels, so dp's truncation shows) past
    one and within two; one piece of ds lies far outside both."""
    B_, T_, H_, D_ = 3, 1000, 2, 64
    rng = np.random.RandomState(D_ + T_)
    qkv = torch.from_numpy(rng.randn(B_, T_, 3, H_, D_).astype(np.float32)).to(torch.bfloat16)
    lens = rng.randint(1, T_ + 1, B_)
    lens[-1], lens[1] = 0, 1
    lengths = torch.from_numpy(lens.astype(np.int32))
    do = torch.from_numpy(rng.randn(B_, T_, H_, D_).astype(np.float32)).to(torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    ref, lse = fa.flash_forward_reference(q, k, v, lengths, False)
    delta = torch.sum(do.float() * ref.float(), dim=-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta, lengths, False)
    want = fa.flash_dq_reference(*args)

    def spacings(got):
        got, w = got.float(), want.float()
        big = torch.maximum(got.abs(), w.abs()).clamp(min=SM90_CANCEL_FLOOR * float(w.abs().max()))
        return float(((got - w).abs() / torch.exp2(torch.floor(torch.log2(big)) - 7)).max())

    assert spacings(_sm90_dq(*args)) <= 1.0
    assert 1.0 < spacings(_sm90_dq(*args, truncated=True)) <= 2.0
    assert spacings(_sm90_dq(*args, pieces=1)) > 2.0
