"""Where the port runs: the card by default, the CPU only on request."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the CUDA card; ``"cpu"`` must be asked for.

    Raises ``RuntimeError`` when a CUDA device is wanted and none is
    present, so a missing card never turns into a silent CPU run."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise RuntimeError(f"unsupported device {dev}: expected cuda or cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    # The model computes in float32 and is held to the JAX reference in
    # float32. TF32 rounds matmul inputs to a 10-bit mantissa (about three
    # decimal digits), which would swamp the 1e-4 kernel tolerance and
    # flip greedy argmax near-ties, so both TF32 switches stay off.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # A bf16 model's products accumulate in float32, as the JAX package's
    # bf16 dots (preferred_element_type=float32) and the kernels do; the
    # default lets cuBLAS reduce split-K partial sums in bf16.
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def compute_dtype(dtype: Optional[object], what: str = "compute dtype") -> Optional[torch.dtype]:
    """The model compute dtype a caller names: ``None`` for float32 (every
    tensor in the master dtype), ``torch.bfloat16`` for bf16 mixed
    precision. Anything else raises ``NotImplementedError``. (The serve
    slot state may be stored in bfloat16 whatever this is:
    ``graph/decode_step.py::plan_slot_dtype``.)"""
    if dtype in (None, torch.float32, "float32", "fp32", "f32", ""):
        return None
    if dtype in (torch.bfloat16, "bfloat16", "bf16"):
        return torch.bfloat16
    raise NotImplementedError(
        f"{what} {dtype!r} is not ported: paddle_tpu_torch computes in float32 or "
        "in bf16 mixed precision")
