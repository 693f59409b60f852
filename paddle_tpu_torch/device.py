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
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def float32_only(dtype: Optional[object], what: str) -> None:
    """Refuse a model compute dtype other than float32 for now. (The serve
    slot state may be stored in bfloat16: its steps still compute in
    float32, ``graph/decode_step.py::plan_slot_dtype``.)"""
    if dtype in (None, torch.float32, "float32", "fp32", "f32", ""):
        return
    raise NotImplementedError(
        f"{what} {dtype!r} is not ported yet: paddle_tpu_torch computes in "
        "float32 only (bf16 compute is ROADMAP Queue 1 item 7)")
