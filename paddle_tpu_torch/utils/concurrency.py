"""The concurrency seam — every thread, lock, and clock the framework
uses, acquired through ONE module.

Production behavior is identical to the stdlib: ``cc.Thread`` is
``threading.Thread``, ``cc.monotonic`` is ``time.monotonic``, and so
on — this module adds one attribute lookup per construction, nothing
per operation. What the seam buys is *substitutability*: the dynamic
race analyzer (``paddle race``, ``paddle_tpu/analysis/dynamic/``)
installs a virtualized provider whose primitives report every
acquire/release/wait/notify to a deterministic scheduler, so the REAL
daemon-thread code (async checkpoint writers, hangwatch, heartbeat,
the feeder pool) can be run under explored interleavings and replayed
from a seed.

Rules for framework code:

- construct primitives via this module (``cc.Lock()``, ``cc.Thread``,
  ``cc.Event()``, ``cc.Queue()``, ``cc.Timer``), and read time via
  ``cc.monotonic()`` / ``cc.sleep()`` where a blocked thread or timer
  is involved;
- primitives constructed before ``install()`` (module-import-time
  globals) stay real — the analyzer serializes execution, so a real,
  uncontended lock inside virtualized code is benign;
- never cache ``cc.Thread`` etc. into a local/module alias at import
  time (that would freeze the provider choice); call through the
  module.

jax-free and stdlib-only: the resilience and analysis layers import
this while the accelerator runtime may be the thing being debugged.
"""

from __future__ import annotations

import queue as _queue
import threading as _threading
import time as _time

__all__ = [
    "Thread", "Timer", "Lock", "RLock", "Condition", "Event", "Queue",
    "monotonic", "perf_counter", "sleep", "current_thread", "main_thread",
    "get_ident", "enumerate_threads", "install", "uninstall", "provider",
    "Empty", "Full",
]

# re-exported so `except cc.Empty` works against both real and virtual
# queues (the virtual Queue raises the REAL queue module's exceptions)
Empty = _queue.Empty
Full = _queue.Full


class _RealProvider:
    """The stdlib, behind the seam's call signatures."""

    Thread = _threading.Thread
    Timer = _threading.Timer
    Lock = staticmethod(_threading.Lock)
    RLock = staticmethod(_threading.RLock)
    Condition = _threading.Condition
    Event = _threading.Event
    Queue = _queue.Queue
    monotonic = staticmethod(_time.monotonic)
    perf_counter = staticmethod(_time.perf_counter)
    sleep = staticmethod(_time.sleep)
    current_thread = staticmethod(_threading.current_thread)
    main_thread = staticmethod(_threading.main_thread)
    get_ident = staticmethod(_threading.get_ident)
    enumerate_threads = staticmethod(_threading.enumerate)


_REAL = _RealProvider()
_provider = _REAL


def install(p) -> None:
    """Swap the provider (the race analyzer's virtualized primitives).
    Affects only primitives constructed AFTER this call; process-global,
    so callers own the install/uninstall bracket (the analyzer brackets
    every schedule)."""
    global _provider
    _provider = p


def uninstall() -> None:
    global _provider
    _provider = _REAL


def provider():
    return _provider


# ------------------------------------------------------------ constructors
#
# Plain functions (not aliases): the provider is resolved at CALL time,
# so an installed shim governs primitives made anywhere downstream.


def Thread(*args, **kwargs):
    return _provider.Thread(*args, **kwargs)


def Timer(*args, **kwargs):
    return _provider.Timer(*args, **kwargs)


def Lock():
    return _provider.Lock()


def RLock():
    return _provider.RLock()


def Condition(lock=None):
    return _provider.Condition(lock)


def Event():
    return _provider.Event()


def Queue(maxsize: int = 0):
    return _provider.Queue(maxsize)


# ------------------------------------------------------------------ clocks


def monotonic() -> float:
    return _provider.monotonic()


def perf_counter() -> float:
    return _provider.perf_counter()


def sleep(seconds: float) -> None:
    _provider.sleep(seconds)


# --------------------------------------------------------------- thread ids


def current_thread():
    return _provider.current_thread()


def main_thread():
    return _provider.main_thread()


def get_ident():
    return _provider.get_ident()


def enumerate_threads():
    return _provider.enumerate_threads()
