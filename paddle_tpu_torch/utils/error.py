"""Layer-stack error context.

Analog of the reference's ``CustomStackTrace``
(/root/reference/paddle/utils/CustomStackTrace.h:55): while compiling or
executing a layer graph we push the layer name so failures report *which
layer* broke, not just a jax traceback.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, List

_tls = threading.local()


def current_layer_stack() -> List[str]:
    return list(getattr(_tls, "stack", []))


@contextlib.contextmanager
def layer_scope(name: str) -> Iterator[None]:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    stack.append(name)
    try:
        yield
    except Exception as e:
        if not getattr(e, "_pt_layer_stack_noted", False):
            e._pt_layer_stack_noted = True
            e.args = (
                (f"{e.args[0] if e.args else ''} [layer stack: {' -> '.join(stack)}]",)
                + tuple(e.args[1:])
            )
        raise
    finally:
        stack.pop()
