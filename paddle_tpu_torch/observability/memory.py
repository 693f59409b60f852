"""Device-memory exhaustion: what the copied engine asks of this module.

The engine imports :class:`SyntheticOomError` (the ``serve.oom`` fault
site's stand-in) and :func:`is_oom_error` (its OOM shutdown gate) lazily.
The memory accounting of the JAX package's module waits for a later slice.
"""

from __future__ import annotations

import torch


class SyntheticOomError(RuntimeError):
    """Deterministic stand-in for a device OOM: the message carries the
    canonical RESOURCE_EXHAUSTED marker so :func:`is_oom_error` classifies
    it like the real thing."""

    def __init__(self, info: str = ""):
        detail = f" ({info})" if info else ""
        super().__init__(
            "RESOURCE_EXHAUSTED: out of memory "
            f"[synthetic — injected at trainer.oom{detail}]")


def is_oom_error(e: BaseException) -> bool:
    """True only for device-memory exhaustion: ``torch.OutOfMemoryError``
    or an error whose message says so. Deliberately narrow: a shape bug
    must crash loudly, not masquerade as an OOM."""
    if isinstance(e, torch.OutOfMemoryError):
        return True
    msg = f"{type(e).__name__}: {e}".lower()
    return any(s in msg for s in ("resource_exhausted", "resource exhausted",
                                  "out of memory", "failed to allocate"))
