"""paddle_tpu_torch.serving — the continuous-batching generation engine.

- ``engine.py``, ``backend.py``, ``draft.py`` — the framework-free
  scheduler and backend seam, copied from the JAX package;
- ``torch_backend.py`` — slot state on the card, eager decode launches;
- ``frontend.py`` — ``build_engine``, the in-process serving API.
"""

from paddle_tpu_torch.serving.backend import (
    FakeBackend,
    StepOut,
    parse_decode_blocks,
    parse_slot_dtype,
    parse_spec_tokens,
)
from paddle_tpu_torch.serving.engine import (
    Engine,
    EngineRequest,
    ResultFuture,
    ServeResult,
)

__all__ = [
    "Engine",
    "EngineRequest",
    "FakeBackend",
    "ResultFuture",
    "ServeResult",
    "StepOut",
    "parse_decode_blocks",
    "parse_slot_dtype",
    "parse_spec_tokens",
]
