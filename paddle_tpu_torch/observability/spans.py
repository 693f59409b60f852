"""Span layer — ``stat_timer`` scopes as Chrome trace-event JSON.

``utils/stats.py::stat_timer`` already aggregates named scopes into the
global StatSet and annotates the jax profiler trace. This module is the
third consumer: when a collector is configured (``--trace_events_path``),
every scope additionally records a complete ("ph": "X") trace event, and
the collector exports ``{"traceEvents": [...]}`` that chrome://tracing /
Perfetto load directly. Nesting falls out of the format: events on the
same pid/tid nest by time containment, so ``train_step`` spans appear
inside their ``trainer/pass`` span and next to ``data/prefetch_wait``.

This intentionally does NOT replace the jax profiler (``--profile_dir``
captures device-side xplanes; stat_timer's TraceAnnotation names these
same scopes there) — it is the host-side, dependency-free view: a span
file is a few KB of JSON you can open anywhere, not a protobuf needing
tensorboard.

jax-free, thread-safe, and bounded: past ``max_events`` new spans are
dropped (counted), so a long run cannot OOM its own telemetry.
"""

from __future__ import annotations

import atexit
import contextlib
import json
import os
import threading
from paddle_tpu_torch.utils import concurrency as cc
import time
from typing import Iterator, List, Optional

from paddle_tpu_torch.utils.logging import logger


class SpanCollector:
    def __init__(self, path: str, host: int = 0, max_events: int = 200_000):
        self.path = path
        self.host = int(host)
        self.max_events = int(max_events)
        self.dropped = 0
        self._events: List[dict] = []
        self._lock = cc.Lock()
        self._t0 = time.perf_counter()

    def now(self) -> float:
        """Span clock (seconds since collector start)."""
        return time.perf_counter() - self._t0

    def record(self, name: str, start_s: float, dur_s: float) -> None:
        """One complete span; ``start_s`` is a ``now()`` reading."""
        ev = {
            "name": name,
            "ph": "X",
            "ts": round(start_s * 1e6, 3),   # trace-event time unit: us
            "dur": round(dur_s * 1e6, 3),
            "pid": self.host,
            "tid": cc.get_ident() % 2**31,
        }
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
                return
            self._events.append(ev)

    def instant(self, name: str, **args) -> None:
        """Instant event ("ph": "i") — nonfinite hits, fault firings."""
        ev = {
            "name": name,
            "ph": "i",
            "s": "t",
            "ts": round(self.now() * 1e6, 3),
            "pid": self.host,
            "tid": cc.get_ident() % 2**31,
        }
        if args:
            ev["args"] = args
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
                return
            self._events.append(ev)

    def export(self) -> Optional[str]:
        """Write the full trace-event JSON document (idempotent: each
        export rewrites the complete file, so a mid-run export is always
        a loadable trace). Returns the path, or None on failure."""
        with self._lock:
            events = list(self._events)
            dropped = self.dropped
        doc = {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "source": "paddle_tpu stat_timer spans",
                "host": self.host,
                "dropped_events": dropped,
            },
        }
        try:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            with open(self.path, "w") as f:
                json.dump(doc, f)
        except OSError as e:
            logger.warning("span export to %s failed: %s", self.path, e)
            return None
        return self.path


_collector: Optional[SpanCollector] = None
_atexit_installed = False


def _resolve_path(path: str, host: int) -> str:
    """Multi-host: every process writes its own file next to host 0's."""
    if host > 0:
        root, ext = os.path.splitext(path)
        return f"{root}.host{host}{ext or '.json'}"
    return path


def configure(path: str, host: int = 0) -> Optional[SpanCollector]:
    """Install (or with an empty path, clear) the global collector.
    Re-configuring with the same resolved file keeps the live collector
    (a fresh one would later export over — and erase — its spans)."""
    global _collector, _atexit_installed
    if not path:
        if _collector is not None:
            _collector.export()
        _collector = None
        return None
    path = _resolve_path(path, host)
    if _collector is not None and _collector.path == path:
        return _collector
    if _collector is not None:
        _collector.export()
    _collector = SpanCollector(path, host=host)
    if not _atexit_installed:
        atexit.register(_atexit_export)
        _atexit_installed = True
    return _collector


def configure_from_flags(flags, host: int = 0) -> Optional[SpanCollector]:
    return configure(getattr(flags, "trace_events_path", "") or "", host=host)


def _atexit_export() -> None:
    if _collector is not None:
        _collector.export()


def enabled() -> bool:
    return _collector is not None


def record(name: str, start_s: float, dur_s: float) -> None:
    if _collector is not None:
        _collector.record(name, start_s, dur_s)


def record_perf(name: str, t0_perf: float, dur_s: float) -> None:
    """Record a span whose start was taken with ``time.perf_counter()``
    (stat_timer's clock) — converted onto the collector clock here, so
    the caller needs no collector handle on its hot path."""
    c = _collector
    if c is not None:
        c.record(name, t0_perf - c._t0, dur_s)


def instant(name: str, **args) -> None:
    if _collector is not None:
        _collector.instant(name, **args)


def export() -> Optional[str]:
    return _collector.export() if _collector is not None else None


@contextlib.contextmanager
def span(name: str) -> Iterator[None]:
    """Span-only scope for sites where a StatSet entry would be noise
    (or jax may not be imported); stat_timer uses record() directly."""
    c = _collector
    if c is None:
        yield
        return
    t0 = c.now()
    try:
        yield
    finally:
        c.record(name, t0, c.now() - t0)
