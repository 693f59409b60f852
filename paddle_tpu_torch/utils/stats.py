"""Scoped timers aggregated into a global stat set.

Port of ``paddle_tpu/utils/stats.py`` (the reference's ``REGISTER_TIMER`` /
``StatSet``, paddle/utils/Stat.h:70,127,244): named scopes accumulate
wall time and call counts, dumped by the trainer after each pass. Work on
the card is asynchronous, so a timer around a step measures its enqueue
unless it is given ``block_on``: a tensor whose producing work the timer
waits for (an event on its stream, never a whole-device synchronize).
Scopes also open a ``torch.profiler.record_function`` range, so they name
their spans in a profiler trace, and record into the span layer
(``observability/spans.py``) when ``--trace_events_path`` configured it.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator

from paddle_tpu_torch.utils import concurrency as cc


@dataclass
class Stat:
    name: str
    total_s: float = 0.0
    count: int = 0
    max_s: float = 0.0
    _lock: object = field(default_factory=cc.Lock, repr=False)

    def add(self, dt: float) -> None:
        with self._lock:
            self.total_s += dt
            self.count += 1
            if dt > self.max_s:
                self.max_s = dt

    @property
    def avg_s(self) -> float:
        return self.total_s / self.count if self.count else 0.0


class StatSet:
    def __init__(self, name: str = "global"):
        self.name = name
        self._stats: Dict[str, Stat] = {}
        self._lock = cc.Lock()

    def get(self, name: str) -> Stat:
        with self._lock:
            st = self._stats.get(name)
            if st is None:
                st = self._stats[name] = Stat(name)
            return st

    def reset(self) -> None:
        with self._lock:
            self._stats.clear()

    def summary(self) -> str:
        with self._lock:
            stats = sorted(self._stats.values(), key=lambda s: -s.total_s)
        if not stats:
            return f"=== StatSet {self.name}: empty ==="
        lines = [f"=== StatSet {self.name} ==="]
        for s in stats:
            lines.append(
                f"  {s.name:<40s} total={s.total_s * 1e3:10.2f}ms "
                f"avg={s.avg_s * 1e3:8.3f}ms max={s.max_s * 1e3:8.3f}ms n={s.count}"
            )
        return "\n".join(lines)


global_stats = StatSet()


def wait_for(tensor) -> None:
    """Block the host until the work that produces ``tensor`` is done:
    an event recorded on the current stream of its card, then waited on.
    A CPU tensor is ready already."""
    import torch

    if isinstance(tensor, torch.Tensor) and tensor.is_cuda:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(tensor.device))
        event.synchronize()


@contextlib.contextmanager
def stat_timer(name: str, block_on=None) -> Iterator[None]:
    """Time a scope into ``global_stats``, a profiler range and the span
    layer. ``block_on``: a tensor whose work is waited for before the clock
    stops (:func:`wait_for`), so its device time is included."""
    import torch

    from paddle_tpu_torch.observability import spans

    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
    if block_on is not None:
        wait_for(block_on)
    dt = time.perf_counter() - t0
    global_stats.get(name).add(dt)
    spans.record_perf(name, t0, dt)
