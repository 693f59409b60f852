"""The fused attention-GRU decoder loop: CUDA kernel 2 and its plain version.

Port of the forward of ``paddle_tpu/ops/pallas_attention_gru.py``
(``fused_attention_gru``, inference kernel ``_fwd_kernel_light``) and of its
one-step form ``attention_gru_step``, which is the serve decode step. Per
decoder step:

    m     = h @ wa + ba
    s     = sum_D tanh(ep + m) * v            [Te, B], -1e30 where em = 0
    alpha = masked softmax of s over Te       (0 at padding; an all-masked row gives 0)
    ctx   = sum_Te alpha * ev                 [B, E]
    din   = ctx @ wctx + xw_t                 (word projection and biases ride xw)
    h'    = GRU(h, din) with wg [D, 3D]

The output stream is the raw h'; the carry is h' where dmask = 1 and h
where dmask = 0. :func:`fused_attention_gru` launches
``csrc/attention_gru_fwd.cu`` for CUDA tensors and raises on anything that
kernel does not take; for CPU tensors it runs
:func:`attention_gru_reference`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from paddle_tpu_torch.ops._build import I32, I64, PTR, CudaKernel, check, ptr
from paddle_tpu_torch.ops.fused_gru import KERNEL_ACTS, gru_cell

Tensor = torch.Tensor

ATTENTION_GRU_FWD = CudaKernel(
    "attention_gru_fwd.cu", "attention_gru_fwd",
    [PTR, I64, I64,            # ep, its time and batch strides
     PTR, I64, I64,            # ev
     PTR, I64, I64,            # em
     PTR, PTR, PTR,            # xw, dmask, h0
     PTR, PTR, PTR,            # wa, ba, v
     PTR, PTR, PTR,            # wctx, wg, ys
     I32, I32, I32, I32, I32],  # Td, B, Te, D, E
)


def _step(h, ep, ev, em, xw_t, wa, ba, v, wctx, wg, acts):
    """One decoder step of the plain version; h [B, D] -> h' [B, D]."""
    D = h.shape[-1]
    m = h @ wa + ba.reshape(1, D)                               # [B, D]
    s = torch.sum(torch.tanh(ep + m[None]) * v.reshape(1, 1, D), dim=-1)
    valid = em[:, :, 0] > 0                                     # [Te, B]
    s = torch.where(valid, s, torch.full_like(s, -1e30))
    e = torch.exp(s - torch.max(s, dim=0, keepdim=True).values)
    alpha = e / torch.sum(e, dim=0, keepdim=True)
    alpha = torch.where(valid, alpha, torch.zeros_like(alpha))
    ctx = torch.sum(alpha[:, :, None] * ev, dim=0)              # [B, E]
    din = ctx @ wctx + xw_t                                     # [B, 3D]
    return gru_cell(din, h, wg, acts)


def attention_gru_reference(ep, ev, em, xw, dmask, h0, wa, ba, v, wctx, wg,
                            acts: Tuple[str, str] = KERNEL_ACTS) -> Tensor:
    """Plain PyTorch version of the kernel (shapes as :func:`fused_attention_gru`)."""
    h = h0
    ys = []
    for t in range(xw.shape[0]):
        h_new = _step(h, ep, ev, em, xw[t], wa, ba, v, wctx, wg, acts)
        ys.append(h_new)
        dm = dmask[t]
        h = dm * h_new + (1.0 - dm) * h
    return torch.stack(ys)


def fused_attention_gru(ep, ev, em, xw, dmask, h0, wa, ba, v, wctx, wg,
                        acts: Tuple[str, str] = KERNEL_ACTS) -> Tensor:
    """Raw per-step GRU outputs [Td, B, D] of the decoder loop.

    ep [Te, B, D] encoder projection; ev [Te, B, E] encoder states;
    em [Te, B, 1] encoder validity (these three may be any time/batch
    strides, such as transposed views of batch-major buffers); xw
    [Td, B, 3D] word-side inputs with every bias folded in; dmask
    [Td, B, 1]; h0 [B, D]; wa [D, D]; ba [1, D]; v [1, D]; wctx [E, 3D];
    wg [D, 3D]."""
    if ep.device.type == "cpu":
        return attention_gru_reference(ep, ev, em, xw, dmask, h0, wa, ba, v,
                                       wctx, wg, acts)
    Te, B, D = ep.shape
    E = ev.shape[2]
    Td = xw.shape[0]
    dev = ep.device
    if tuple(acts) != KERNEL_ACTS:
        raise ValueError(
            f"attention_gru_fwd takes activations {KERNEL_ACTS}, got {tuple(acts)}")
    check(ep, "ep", (Te, B, D), dev, contiguous=False)
    check(ev, "ev", (Te, B, E), dev, contiguous=False)
    check(em, "em", (Te, B, 1), dev, contiguous=False)
    check(xw, "xw", (Td, B, 3 * D), dev)
    check(dmask, "dmask", (Td, B, 1), dev)
    check(h0, "h0", (B, D), dev)
    check(wa, "wa", (D, D), dev)
    check(ba, "ba", (1, D), dev)
    check(v, "v", (1, D), dev)
    check(wctx, "wctx", (E, 3 * D), dev)
    check(wg, "wg", (D, 3 * D), dev)
    ys = torch.empty((Td, B, D), device=dev)
    ATTENTION_GRU_FWD.launch(
        dev,
        ptr(ep), ep.stride(0), ep.stride(1),
        ptr(ev), ev.stride(0), ev.stride(1),
        ptr(em), em.stride(0), em.stride(1),
        ptr(xw), ptr(dmask), ptr(h0),
        ptr(wa), ptr(ba), ptr(v),
        ptr(wctx), ptr(wg), ptr(ys),
        Td, B, Te, D, E,
    )
    return ys


def attention_gru_step(h_prev, ep, ev, em, xw_t, wa, ba, v, wctx, wg,
                       acts: Tuple[str, str] = KERNEL_ACTS) -> Tensor:
    """ONE decoder step, the JAX package's signature: h_prev [B, D],
    xw_t [B, 3D], the rest as :func:`fused_attention_gru`; returns h' [B, D].
    On the card this is one launch of the kernel with Td = 1."""
    if ep.device.type == "cpu":
        return _step(h_prev, ep, ev, em, xw_t, wa, ba, v, wctx, wg, acts)
    dmask = torch.ones((1, h_prev.shape[0], 1), device=h_prev.device)
    return fused_attention_gru(ep, ev, em, xw_t[None], dmask, h_prev, wa, ba, v,
                               wctx, wg, acts)[0]
