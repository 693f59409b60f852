"""paddle_tpu_torch.serving — the continuous-batching generation engine.

- ``engine.py``, ``backend.py``, ``draft.py`` — the framework-free
  scheduler, backend seam and n-gram draft table, copied from the JAX
  package;
- ``torch_backend.py`` — slot state on the card, eager decode launches,
  the speculative verify launch and bf16 slot storage;
- ``frontend.py`` — ``paddle serve`` (stdin JSONL or ``--listen``) and
  ``build_engine``, the in-process serving API;
- ``resilience.py``, ``transport.py``, ``fleet.py`` — the hangwatch,
  circuit breaker, request journal, health file and hot reload; the
  socket framing; ``paddle serve-fleet`` (copied from the JAX package).
"""

from paddle_tpu_torch.serving.backend import (
    FakeBackend,
    StepOut,
    parse_decode_blocks,
    parse_slot_dtype,
    parse_spec_tokens,
)
from paddle_tpu_torch.serving.draft import DraftTable
from paddle_tpu_torch.serving.engine import (
    Engine,
    EngineRequest,
    ResultFuture,
    ServeResult,
    drive_rung,
    pick_block,
    pick_spec_k,
)
from paddle_tpu_torch.serving.fleet import (
    FleetRouter,
    drive_fleet_rung,
    replica_score,
)
from paddle_tpu_torch.serving.resilience import (
    SERVE_HANG_REPORT,
    CircuitBreaker,
    RequestJournal,
    ServeHangWatch,
    StatusWriter,
    WeightReloader,
    read_status,
)

__all__ = [
    "Engine", "EngineRequest", "ResultFuture", "ServeResult",
    "FakeBackend", "StepOut", "drive_rung", "pick_block",
    "pick_spec_k", "DraftTable", "parse_spec_tokens", "parse_slot_dtype",
    "parse_decode_blocks", "CircuitBreaker", "RequestJournal",
    "ServeHangWatch", "StatusWriter", "SERVE_HANG_REPORT",
    "FleetRouter", "drive_fleet_rung", "replica_score",
    "WeightReloader", "read_status",
]
