"""The in-process serving API of the port: :func:`build_engine`.

The stdin/socket front door (``paddle serve``), the request journal, the
circuit breaker, hot reload from disk and the fleet are later slices.
"""

from __future__ import annotations

from typing import Optional


def build_engine(machine, params, *, slots: int = 8, prompt_tokens: int = 32,
                 queue_cap: int = 0, request_timeout_s: float = 60.0,
                 decode_block=1, max_length: Optional[int] = None,
                 pipeline: bool = True, fused_step: bool = False,
                 spec_tokens="0", slot_dtype: str = "f32"):
    """Wire a :class:`TorchDecodeBackend` + :class:`Engine` for a machine
    built from a generation config. The caller starts it.

    ``decode_block`` takes the ladder spelling ("1,2,4" or an int);
    ``pipeline`` selects the overlapped dispatch/collect loop;
    ``fused_step`` the fused attention-GRU decode step (on the card, one
    kernel launch per micro-step)."""
    from paddle_tpu_torch.serving.engine import Engine
    from paddle_tpu_torch.serving.torch_backend import TorchDecodeBackend

    backend = TorchDecodeBackend(
        machine, params, slots=slots, prompt_tokens=prompt_tokens,
        max_length=max_length, decode_block=decode_block, pipeline=pipeline,
        fused_step=fused_step, spec_tokens=spec_tokens, slot_dtype=slot_dtype,
    )
    return Engine(backend, queue_cap=queue_cap,
                  request_timeout_s=request_timeout_s, pipeline=pipeline)
