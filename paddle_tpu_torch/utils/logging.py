"""Framework logger.

Role of the reference's mini-glog (/root/reference/paddle/utils/Logging.h):
leveled logging plus CHECK-style assertion helpers that attach the current
layer stack (see paddle_tpu_torch.utils.error) to failures.
"""

from __future__ import annotations

import logging
import os
import sys

logger = logging.getLogger("paddle_tpu")

if not logger.handlers:
    _handler = logging.StreamHandler(sys.stderr)
    _handler.setFormatter(
        logging.Formatter("[%(asctime)s %(levelname).1s paddle_tpu] %(message)s", "%H:%M:%S")
    )
    logger.addHandler(_handler)
    logger.setLevel(os.environ.get("PADDLE_TPU_LOG_LEVEL", "INFO").upper())
    logger.propagate = False


def check(cond: bool, msg: str = "") -> None:
    """CHECK(cond) — raise with the layer stack attached on failure."""
    if not cond:
        from paddle_tpu_torch.utils.error import current_layer_stack

        stack = current_layer_stack()
        suffix = f" [layer stack: {' -> '.join(stack)}]" if stack else ""
        raise AssertionError(f"check failed: {msg}{suffix}")
