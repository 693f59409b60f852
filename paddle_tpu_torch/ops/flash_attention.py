"""Length-masked, optionally causal flash attention: CUDA kernels 10, 11 and
12 and their plain versions.

Port of ``paddle_tpu/ops/pallas_attention.py``: the forward with its
log-sum-exp (``_fwd_kernel`` -> ``csrc/flash_attn_fwd.cu::flash_attn_fwd``)
and the FlashAttention-2 backward in two kernels (``_dq_kernel`` ->
``csrc/flash_attn_bwd.cu::flash_attn_dq``, ``_dkv_kernel`` ->
``flash_attn_dkv``). Semantics are exactly the Pallas kernels': scale
1/sqrt(D) (on q in the forward, on q.k in the backward, as there); a key is
visible to a query when it lies before the row's length and, with
``causal``, not after the query; a query that sees no key gets out = 0 and
lse = -1e30; the backward recomputes p = exp(s - lse) where visible (0
elsewhere) and ds = p (dp - delta) scale with delta = sum(dout * out).

Layout: q, k, v, out and their gradients are [B, T, H, D] (the
``sequence_parallel`` layout; the kernels read any batch, time and head
strides, so the multi-head layer's views of its fused qkv projection cost
no copy); lse and delta are [B, H, T], as the Pallas kernels hold them.

Operand types (``OPERAND_DTYPES``): q, k, v and dout float32 or bf16, all
of one type, each with its own instance of the three kernels. The bf16
contract is the Pallas kernels': every operand widened to float32 (q
scaled there), the online softmax, p, ds, lse, delta and every sum in
float32, and out, dq, dk and dv rounded once to their operand's type; lse
and delta stay float32 in both.

Two bodies of each bf16 kernel. :func:`sm90_takes` decides before the
launch, from the dtype, D, the strides and the base addresses:

- ``flash_attn_fwd_bf16_sm90``, ``flash_attn_dq_bf16_sm90`` and
  ``flash_attn_dkv_bf16_sm90`` take D = 64
  and 128 with every operand as TMA reads it (base 16-byte aligned, batch,
  time and head strides multiples of 8 values, nested outwards): the LM's
  views of its fused qkv. bf16 ``wgmma`` over TMA tiles, two warpgroups
  and one thread issuing the loads; p and ds enter their products as two bf16
  pieces (hi = bf16(x), lo = bf16(x - hi), ~16 bits), so the products run
  at the bf16 tensor-core rate (1.5 passes a product); out and dv stay
  within a bf16 ulp of the float32 contract, dq (its key tiles summed apart
  and added with rounded float32 adds) within one or two, dk within a few
  where it cancels over a long sum of queries. What bounds them on an
  H100 and what the design does about it: the notes of
  ``csrc/flash_attn_fwd.cu`` and ``csrc/flash_attn_bwd.cu``.
- ``flash_attn_fwd_bf16``, ``flash_attn_dq_bf16`` and ``flash_attn_dkv_bf16``
  (the float32 body's bf16 instances: tiles widened to float32,
  ``mma.sync`` TF32) take every other shape: D other than 64 and 128, an
  unaligned base, a stride TMA cannot read.

A failed build or launch of either body raises: nothing falls back to the
other body or to the plain version.

:func:`flash_attention` launches the kernels for a CUDA tensor and raises on
anything they do not take: the forward with lse and the two backward
kernels (a ``torch.autograd.Function``) when grad mode is on and an input
requires a gradient, the forward alone otherwise. For a CPU tensor the same
function runs the plain versions, which materialise [B, H, T, T].
:func:`supported` states the shapes the kernels take;
``parallel/sequence_parallel.full_attention`` runs its eager path for any
other (counted in ``EAGER_ROUTES``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from paddle_tpu_torch.ops import kernel_flops
from paddle_tpu_torch.ops._build import I32, I64, PTR, CudaKernel, check, ptr
from paddle_tpu_torch.ops.fused_gru import OPERAND_DTYPES, _last_dim_contiguous

Tensor = torch.Tensor

_NEG = -1e30
MAX_D = 256                          # the kernels' register and shared-memory tiles
MAX_GRID = 65535                     # heads and batch rows are grid dimensions
# full_attention calls that ran the eager path (not a self-attention shape
# the kernels take, or not on the card)
EAGER_ROUTES = 0

_QKV = [PTR, I64, I64, I64] * 3      # q, k, v with their batch, time and head strides
_STRIDED = [PTR, I64, I64, I64]
_SHAPE = [I32, I32, I32, I32, I32]   # B, T, H, D, causal
FLASH_ATTN_FWD = CudaKernel(
    "flash_attn_fwd.cu", "flash_attn_fwd",
    _QKV + [PTR] + _STRIDED + [PTR] + _SHAPE)             # lengths; out; lse (or null)
FLASH_ATTN_DQ = CudaKernel(
    "flash_attn_bwd.cu", "flash_attn_dq",
    _QKV + _STRIDED + [PTR, PTR, PTR] + _STRIDED + _SHAPE)   # dout; lse, delta, lengths; dq
FLASH_ATTN_DKV = CudaKernel(
    "flash_attn_bwd.cu", "flash_attn_dkv",
    _QKV + _STRIDED + [PTR, PTR, PTR] + _STRIDED * 2 + _SHAPE)   # ...; dk, dv
FLASH_ATTN_FWD_BF16 = CudaKernel("flash_attn_fwd.cu", "flash_attn_fwd_bf16",
                                 FLASH_ATTN_FWD.argtypes[:-1])
FLASH_ATTN_DQ_BF16 = CudaKernel("flash_attn_bwd.cu", "flash_attn_dq_bf16",
                                FLASH_ATTN_DQ.argtypes[:-1])
FLASH_ATTN_DKV_BF16 = CudaKernel("flash_attn_bwd.cu", "flash_attn_dkv_bf16",
                                 FLASH_ATTN_DKV.argtypes[:-1])
# the bf16 bodies for Hopper (bf16 wgmma over TMA tiles), where sm90_takes
FLASH_ATTN_FWD_BF16_SM90 = CudaKernel("flash_attn_fwd.cu", "flash_attn_fwd_bf16_sm90",
                                      FLASH_ATTN_FWD.argtypes[:-1])
FLASH_ATTN_DKV_BF16_SM90 = CudaKernel("flash_attn_bwd.cu", "flash_attn_dkv_bf16_sm90",
                                      FLASH_ATTN_DKV.argtypes[:-1])
FLASH_ATTN_DQ_BF16_SM90 = CudaKernel("flash_attn_bwd.cu", "flash_attn_dq_bf16_sm90",
                                     FLASH_ATTN_DQ.argtypes[:-1])
KERNELS = (FLASH_ATTN_FWD, FLASH_ATTN_DQ, FLASH_ATTN_DKV,
           FLASH_ATTN_FWD_BF16, FLASH_ATTN_DQ_BF16, FLASH_ATTN_DKV_BF16,
           FLASH_ATTN_FWD_BF16_SM90, FLASH_ATTN_DKV_BF16_SM90, FLASH_ATTN_DQ_BF16_SM90)
SM90_D = (64, 128)                   # the head dims of the Hopper bodies
# each kernel by operand dtype
_FWD = {torch.float32: FLASH_ATTN_FWD, torch.bfloat16: FLASH_ATTN_FWD_BF16}
_DQ = {torch.float32: FLASH_ATTN_DQ, torch.bfloat16: FLASH_ATTN_DQ_BF16}
_DKV = {torch.float32: FLASH_ATTN_DKV, torch.bfloat16: FLASH_ATTN_DKV_BF16}


def _visible(lengths: Tensor, Tq: int, Tk: int, causal: bool) -> Tensor:
    """[B, 1, Tq, Tk] mask: key < length and, with ``causal``, key <= query."""
    kv = torch.arange(Tk, device=lengths.device)
    m = kv[None, None, None, :] < lengths.long()[:, None, None, None]
    if causal:
        q = torch.arange(Tq, device=lengths.device)
        m = m & (kv[None, :] <= q[:, None])[None, None]
    return m


def _widened(*ts: Tensor):
    """The operands in at least float32, as the Pallas kernels widen them."""
    acc = torch.promote_types(ts[0].dtype, torch.float32)
    return [t.to(acc) for t in ts]


def flash_forward_reference(q: Tensor, k: Tensor, v: Tensor, lengths: Tensor,
                            causal: bool) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of kernel 10: q, k, v [B, T, H, D], lengths [B]
    -> (out [B, T, H, D] in q's dtype, lse [B, H, T] in at least float32).
    The Pallas kernel's online softmax over one tile of every key, on the
    widened operands, out rounded once."""
    T, D = q.shape[1], q.shape[3]
    scale = 1.0 / math.sqrt(D)
    msk = _visible(lengths, T, T, causal)
    od = q.dtype
    q, k, v = _widened(q, k, v)
    s = torch.einsum("bqhd,bkhd->bhqk", q * scale, k)
    s = torch.where(msk, s, torch.full_like(s, _NEG))
    m = torch.amax(s, dim=-1)
    p = torch.where(msk, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = torch.sum(p, dim=-1)
    l_safe = torch.clamp(l, min=1e-20)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v) / l_safe.transpose(1, 2)[..., None]
    lse = torch.where(l > 0, m + torch.log(l_safe), torch.full_like(m, _NEG))
    return out.to(od), lse


def _scores_backward(q, k, v, dout, lse, delta, lengths, causal):
    """p and ds [B, H, T, T] of the Pallas backward kernels (q, k, v and
    dout widened)."""
    q, k, v, dout = _widened(q, k, v, dout)
    T, D = q.shape[1], q.shape[3]
    scale = 1.0 / math.sqrt(D)
    msk = _visible(lengths, T, T, causal)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    p = torch.where(msk, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    dp = torch.einsum("bqhd,bkhd->bhqk", dout, v)
    return p, p * (dp - delta[..., None]) * scale


def flash_dq_reference(q: Tensor, k: Tensor, v: Tensor, dout: Tensor, lse: Tensor,
                       delta: Tensor, lengths: Tensor, causal: bool) -> Tensor:
    """Plain PyTorch version of kernel 11: dq [B, T, H, D] = sum_k ds k, in
    q's dtype."""
    _, ds = _scores_backward(q, k, v, dout, lse, delta, lengths, causal)
    return torch.einsum("bhqk,bkhd->bqhd", ds, _widened(k)[0]).to(q.dtype)


def flash_dkv_reference(q: Tensor, k: Tensor, v: Tensor, dout: Tensor, lse: Tensor,
                        delta: Tensor, lengths: Tensor, causal: bool) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of kernel 12: dk = sum_q ds q, dv = sum_q p dout,
    in k's and v's dtype."""
    p, ds = _scores_backward(q, k, v, dout, lse, delta, lengths, causal)
    qw, dw = _widened(q, dout)
    return (torch.einsum("bhqk,bqhd->bkhd", ds, qw).to(k.dtype),
            torch.einsum("bhqk,bqhd->bkhd", p, dw).to(v.dtype))


def supported(B: int, T: int, H: int, D: int) -> bool:
    """Whether kernels 10-12 take self-attention over [B, T, H, D]."""
    return 1 <= D <= MAX_D and T >= 1 and 1 <= H <= MAX_GRID and 1 <= B <= MAX_GRID


def _check_operands(q: Tensor, k: Tensor, v: Tensor, lengths: Tensor) -> Tuple[int, int, int, int]:
    if q.dim() != 4:
        raise ValueError(f"flash attention takes q, k, v [B, T, H, D], got {tuple(q.shape)}")
    B, T, H, D = q.shape
    dev = q.device
    if q.dtype not in OPERAND_DTYPES:
        raise ValueError(f"the flash kernels take float32 or bf16 q, k, v; got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        check(t, name, (B, T, H, D), dev, contiguous=False, dtype=q.dtype)
    if lengths.shape != (B,) or lengths.device != dev or lengths.dtype != torch.int32:
        raise ValueError(f"lengths must be int32 [{B}] on {dev}, got {lengths.dtype} "
                         f"{tuple(lengths.shape)} on {lengths.device}")
    if not supported(B, T, H, D):
        raise ValueError(f"the flash kernels take 1 <= D <= {MAX_D}, T >= 1 and "
                         f"1 <= B, H <= {MAX_GRID}; got B={B}, T={T}, H={H}, D={D}")
    return B, T, H, D


def _strided(t: Tensor):
    return [ptr(t), t.stride(0), t.stride(1), t.stride(2)]


def sm90_takes(*operands: Tensor) -> bool:
    """Whether the bf16 bodies for Hopper take these [B, T, H, D] operands
    (q, k, v, and dout for dQ and dK/dV): bf16, D = 64 or 128, and each as TMA
    reads it through a tensor map of dims (D, H, T, B): its base 16-byte
    aligned, its head, time and batch strides positive multiples of 8
    values, each at least the extent of the dims inside it (sh >= D,
    st >= H sh, sb >= T st: the nested layout a tensor map describes; the
    layer's views of its fused qkv and every contiguous tensor are such),
    and B H T < 2^31 (TMA's 32-bit coordinates over the [B, H, T] rows).
    Reads the dtypes, shapes, strides and base addresses, nothing a launch
    returns."""
    for t in operands:
        if t.dtype != torch.bfloat16 or t.dim() != 4 or t.shape[3] not in SM90_D:
            return False
        B, T, H, D = t.shape
        if B * H * T >= 2 ** 31:
            return False
        sb, st, sh = t.stride(0), t.stride(1), t.stride(2)
        if t.data_ptr() % 16 or any(x <= 0 or x % 8 for x in (sb, st, sh)):
            return False
        if sh < D or st < H * sh or sb < T * st:
            return False
    return True


def _launch_fwd(q, k, v, lengths, causal, with_lse):
    """Kernel 10 -> (out, lse or None): the dtype's body, and for bf16
    operands that :func:`sm90_takes` the Hopper body."""
    B, T, H, D = _check_operands(q, k, v, lengths)
    kernel = FLASH_ATTN_FWD_BF16_SM90 if sm90_takes(q, k, v) else _FWD[q.dtype]
    out = torch.empty((B, T, H, D), device=q.device, dtype=q.dtype)
    lse = torch.empty((B, H, T), device=q.device) if with_lse else None
    kernel_flops.record(kernel_flops.flash_fwd_flops(B, T, H, D))
    kernel.launch(q.device, *_strided(q), *_strided(k), *_strided(v), ptr(lengths),
                  *_strided(out), None if lse is None else ptr(lse),
                  B, T, H, D, int(bool(causal)))
    return out, lse


def _check_backward(q, k, v, dout, lse, delta, lengths):
    B, T, H, D = _check_operands(q, k, v, lengths)
    check(dout, "dout", (B, T, H, D), q.device, contiguous=False, dtype=q.dtype)
    check(lse, "lse", (B, H, T), q.device)
    check(delta, "delta", (B, H, T), q.device)
    return [*_strided(q), *_strided(k), *_strided(v), *_strided(dout),
            ptr(lse), ptr(delta), ptr(lengths)], (B, T, H, D)


def _launch_dq(q, k, v, dout, lse, delta, lengths, causal):
    """Kernel 11 -> dq: the dtype's body, and the Hopper body where
    :func:`sm90_takes` q, k, v and dout (it reads lse and delta with plain
    loads, at any alignment)."""
    args, (B, T, H, D) = _check_backward(q, k, v, dout, lse, delta, lengths)
    kernel = FLASH_ATTN_DQ_BF16_SM90 if sm90_takes(q, k, v, dout) else _DQ[q.dtype]
    dq = torch.empty((B, T, H, D), device=q.device, dtype=q.dtype)
    kernel_flops.record(kernel_flops.flash_dq_flops(B, T, H, D))
    kernel.launch(q.device, *args, *_strided(dq), B, T, H, D, int(bool(causal)))
    return dq


def _launch_dkv(q, k, v, dout, lse, delta, lengths, causal):
    """Kernel 12 -> (dk, dv): the dtype's body, and the Hopper body where
    :func:`sm90_takes` q, k, v and dout and TMA can read lse and delta
    (their bases 16-byte aligned)."""
    args, (B, T, H, D) = _check_backward(q, k, v, dout, lse, delta, lengths)
    tma = sm90_takes(q, k, v, dout) and lse.data_ptr() % 16 == 0 == delta.data_ptr() % 16
    kernel = FLASH_ATTN_DKV_BF16_SM90 if tma else _DKV[q.dtype]
    dk, dv = (torch.empty((B, T, H, D), device=q.device, dtype=q.dtype) for _ in range(2))
    kernel_flops.record(kernel_flops.flash_dkv_flops(B, T, H, D))
    kernel.launch(q.device, *args, *_strided(dk), *_strided(dv), B, T, H, D, int(bool(causal)))
    return dk, dv


def _forward(q, k, v, lengths, causal, with_lse):
    if q.device.type == "cpu":
        out, lse = flash_forward_reference(q, k, v, lengths, causal)
        return out, (lse if with_lse else None)
    return _launch_fwd(q, k, v, lengths, causal, with_lse)


class _FlashAttention(torch.autograd.Function):
    """Kernel 10 with lse saved, then kernels 11 and 12 (the plain versions
    on the CPU); delta = sum(dout * out) over the widened dout and out in
    plain torch between them, as the JAX package computes it outside its
    kernels."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, causal):
        out, lse = _forward(q, k, v, lengths, causal, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse, lengths)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, lengths = ctx.saved_tensors
        dout = _last_dim_contiguous(dout)
        dw, ow = _widened(dout, out)
        delta = torch.sum(dw * ow, dim=-1).transpose(1, 2).contiguous()      # [B, H, T]
        if q.device.type == "cpu":
            dq = flash_dq_reference(q, k, v, dout, lse, delta, lengths, ctx.causal)
            dk, dv = flash_dkv_reference(q, k, v, dout, lse, delta, lengths, ctx.causal)
        else:
            dq = _launch_dq(q, k, v, dout, lse, delta, lengths, ctx.causal)
            dk, dv = _launch_dkv(q, k, v, dout, lse, delta, lengths, ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q: Tensor, k: Tensor, v: Tensor, lengths: Optional[Tensor] = None,
                    causal: bool = False) -> Tensor:
    """Attention over [B, T, H, D] q, k, v (float32 or bf16, one dtype; any
    batch, time and head strides, the last dimension contiguous) with keys
    masked at or past ``lengths`` [B] (full length when None) and, with
    ``causal``, past the query -> out [B, T, H, D] in q's dtype
    (contiguous). Outputs at padded query rows attend to the row's valid
    keys; a row of length 0 gives zeros."""
    B, T = q.shape[0], q.shape[1]
    if lengths is None:
        lengths = torch.full((B,), T, dtype=torch.int32, device=q.device)
    elif lengths.dtype != torch.int32:
        lengths = lengths.to(torch.int32)
    causal = bool(causal)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        if q.device.type != "cpu":
            _check_operands(q, k, v, lengths)
        return _FlashAttention.apply(q, k, v, lengths, causal)
    return _forward(q, k, v, lengths, causal, with_lse=False)[0]
