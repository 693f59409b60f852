"""Model matmul FLOPs of a train step, and the cards' published peaks.

The port's counterpart of ``paddle_tpu/ops/kernel_flops.py``. A step's
FLOPs are its matrix products (``[M, K] x [K, N]`` is ``2·M·K·N``; a
convolution ``2 · output elements · kernel taps · input channels``):
elementwise and transcendental work is not counted, the MLPerf convention
the JAX package's MFU uses. :func:`train_step_flops` runs the step once
under ``torch.utils.flop_counter.FlopCounterMode``, which counts PyTorch's
own products as they run, and adds what the hand-written kernels
:func:`record` inside :func:`capture`: a CUDA kernel launched through
``ctypes`` is invisible to the counter.

Each kernel wrapper records on the card only (``ops/fused_gru.py``,
``fused_attention_gru.py``, ``fused_lstm.py``, ``flash_attention.py``,
``fused_conv1x1_bn.py``). On the CPU the wrapper runs the kernel's plain
version, whose products the counter sees, so it records nothing there.
The formulas below count the products that the plain version and its
autograd backward run (``tests/test_torch_numerics_flops.py`` holds each
formula to the counter on the plain version), so a step counts the same
on both devices. Two consequences, against the JAX package's count of its
CPU scan path (``train_step_flops`` there walks the step's jaxpr):

- a recurrence's first step has a constant zero carry, for which autograd
  runs no carry gradient: the GRU backward counts ``4·B·H²`` fewer than
  ``T`` full steps and the LSTM backward ``8·B·H²`` fewer; the JAX scan
  transposes its carry at every step;
- the attention decoder's context ``Σ_te alpha · enc`` is a product here
  (``2·B·Te·E`` a step, three times with the backward); the JAX scan
  computes it as a multiply and a sum, which its walker does not count
  (its Pallas kernel's ``_flops`` does count it).

The peaks are those of the cards the port runs on, keyed by the name
``torch.cuda.get_device_name()`` returns. A card not in the table gets no
MFU: omitted, never guessed.
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, Optional

# ---------------------------------------------------------------- formulas


def gru_fwd_flops(T: int, B: int, H: int) -> float:
    """Kernels 1 and 2: per step the gates ``[B, H] x [H, 2H]`` and the
    candidate ``[B, H] x [H, H]``."""
    return 6.0 * T * B * H * H


def gru_bwd_flops(T: int, B: int, H: int) -> float:
    """Kernel 3: per step the carry and weight gradients of both products
    (``12·B·H²``), less the carry gradient of the first step's gate
    product, whose carry is the constant zero."""
    return 12.0 * T * B * H * H - (4.0 * B * H * H if T else 0.0)


def lstm_fwd_flops(T: int, B: int, H: int) -> float:
    """Kernels 7a and 7b: per step ``[B, H] x [H, 4H]``."""
    return 8.0 * T * B * H * H


def lstm_bwd_flops(T: int, B: int, H: int) -> float:
    """Kernel 8: per step ``dgates·Wᵀ`` and ``hᵀ·dgates`` (``16·B·H²``),
    less the first step's carry gradient."""
    return 16.0 * T * B * H * H - (8.0 * B * H * H if T else 0.0)


def attention_gru_fwd_flops(Td: int, B: int, Te: int, D: int, E: int) -> float:
    """Kernels 4 and 5, per decoder step: the attention transform
    ``h·Wa`` (``2·B·D²``), the scores ``tanh(.)·v`` (``2·B·Te·D``), the
    context (``2·B·Te·E``), its projection ``ctx·Wctx`` (``6·B·E·D``) and
    the GRU's two products (``6·B·D²``)."""
    return float(Td) * (2.0 * B * D * D + 2.0 * B * Te * D + 2.0 * B * Te * E
                        + 6.0 * B * E * D + 6.0 * B * D * D)


def attention_gru_bwd_flops(Td: int, B: int, Te: int, D: int, E: int,
                            h0_grad: bool = True) -> float:
    """Kernel 6, per decoder step: the carry gradient and dWa of the
    attention transform, the scores' two gradients, the context's weight
    gradient (``dalpha``), ``dctx = dxw·Wctxᵀ``, and the GRU's carry
    gradients. ``dWctx``, ``dWg`` and ``d_enc`` run as PyTorch products in
    the wrapper, where the counter sees them. Without a gradient for h0 the
    first step has no carry gradient of ``h·Wa`` and of the gate product."""
    per_step = (4.0 * B * D * D + 4.0 * B * Te * D + 2.0 * B * Te * E
                + 6.0 * B * E * D + 6.0 * B * D * D)
    first = 0.0 if h0_grad or not Td else 6.0 * B * D * D
    return float(Td) * per_step - first


def flash_fwd_flops(B: int, T: int, H: int, D: int) -> float:
    """Kernel 10: ``q·kᵀ`` and ``p·v`` over every query and key."""
    return 4.0 * B * H * T * T * D


def flash_dq_flops(B: int, T: int, H: int, D: int) -> float:
    """Kernel 11: the scores again, ``dout·vᵀ`` and ``ds·k``."""
    return 6.0 * B * H * T * T * D


def flash_dkv_flops(B: int, T: int, H: int, D: int) -> float:
    """Kernel 12: the scores again, ``dout·vᵀ``, ``dsᵀ·q`` and ``pᵀ·dout``."""
    return 8.0 * B * H * T * T * D


def conv1x1_flops(M: int, K: int, N: int) -> float:
    """Kernel 9: ``x·wᵀ``, ``[M, K] x [K, N]``."""
    return 2.0 * M * K * N


# ------------------------------------------------------------ the records

_LOG: Optional[List[float]] = None


def record(flops: float) -> None:
    """Called by a kernel wrapper where it launches its kernel on the card.
    No-op outside :func:`capture`. Under ``remat="full"`` the backward's
    recompute launches a kernel's training forward again, and that launch
    records too: the count is what the card ran, not the model's FLOPs."""
    if _LOG is not None:
        _LOG.append(float(flops))


@contextlib.contextmanager
def capture():
    """Collect the FLOPs the kernels launched in the body record. Yields
    the (mutable) list; re-entrant (the inner capture wins, restoring the
    outer log on exit)."""
    global _LOG
    prev = _LOG
    _LOG = log = []
    try:
        yield log
    finally:
        _LOG = prev


def warm_up() -> None:
    """Pay the counter's one-time setup now: its first use in a process
    imports ``torch._dynamo``, seconds of host time that a timed window (a
    step under ``--step_hang_timeout``) should not hold."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False):
        torch.ones(2, 2) @ torch.ones(2, 2)


def train_step_flops(fn: Callable, *args, **kwargs) -> float:
    """Model matmul FLOPs of one call of ``fn(*args)``, which RUNS the call:
    the products PyTorch dispatched plus those the kernels recorded."""
    from torch.utils.flop_counter import FlopCounterMode

    with capture() as log, FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops()) + sum(log)


# ------------------------------------------------------------ card peaks

# torch.cuda.get_device_name() -> (published dense bf16 TFLOP/s, HBM GB/s,
# HBM GB), from NVIDIA's data sheets at each part's full power limit:
# H100 SXM5 (700 W), H100 PCIe (350 W), H100 NVL (400 W)
_PEAKS = {
    "NVIDIA H100 80GB HBM3": (989.0, 3350.0, 80.0),
    "NVIDIA H100 PCIe": (756.0, 2000.0, 80.0),
    "NVIDIA H100 NVL": (835.0, 3900.0, 94.0),
}


def _peak_of(device_kind: str, i: int):
    entry = _PEAKS.get(device_kind or "")
    return None if entry is None else entry[i]


def peak_tflops(device_kind: str):
    """Peak dense bf16 TFLOP/s of one card; None when the card is unknown
    (MFU is omitted, never guessed)."""
    return _peak_of(device_kind, 0)


def peak_gbps(device_kind: str):
    """Peak HBM GB/s of one card; None when unknown."""
    return _peak_of(device_kind, 1)


def peak_hbm_gb(device_kind: str):
    """HBM capacity in GB of one card; None when unknown."""
    return _peak_of(device_kind, 2)
