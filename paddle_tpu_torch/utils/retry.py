"""Shared retry policy: exponential backoff + jitter + deadline.

One policy object serves every transient-failure site — checkpoint I/O
against a shared filesystem and data-provider iteration both retry
through here — so backoff behavior is configured once (``--io_retry_*``
flags) instead of re-invented ad hoc per call site. The L-BFGS
line-search ``backoff`` in ``optimizer/batch_methods.py`` is a numerical
step-shrink factor, not an I/O retry, and deliberately does not use
this.

Two usage shapes::

    policy.call(write_file)              # function-shaped work

    state = policy.begin("read samples") # loop/generator-shaped work
    while True:
        try:
            ...; break
        except policy.retry_on as e:
            state.retry(e)               # sleeps, or re-raises e when
                                         # attempts/deadline exhausted
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Tuple, Type

from paddle_tpu_torch.utils.logging import logger


@dataclass
class RetryPolicy:
    """Exponential backoff: delay = base_delay * multiplier**(attempt-1),
    capped at max_delay, each sleep jittered by ±jitter·delay. A retry is
    abandoned (the error re-raised) after max_attempts total attempts or
    once deadline seconds have elapsed since the first attempt."""

    max_attempts: int = 4
    base_delay: float = 0.25
    max_delay: float = 30.0
    multiplier: float = 2.0
    jitter: float = 0.25
    deadline: float = 0.0  # seconds since first attempt; 0 = none
    retry_on: Tuple[Type[BaseException], ...] = (OSError,)
    name: str = ""
    # injectable for tests (fake clock / no real sleeping)
    sleep: Callable[[float], None] = field(default=time.sleep, repr=False)
    seed: Optional[int] = None  # None = nondeterministic jitter

    def delay_for(self, attempt: int, rng: random.Random) -> float:
        """Sleep before attempt ``attempt+1`` (attempt counts from 1)."""
        d = min(self.base_delay * self.multiplier ** (attempt - 1), self.max_delay)
        if self.jitter > 0:
            d *= 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
        return max(d, 0.0)

    def begin(self, name: str = "") -> "_RetryState":
        return _RetryState(self, name or self.name)

    def call(self, fn: Callable[..., Any], *args, name: str = "", **kwargs) -> Any:
        state = self.begin(name or self.name or getattr(fn, "__name__", "call"))
        while True:
            try:
                return fn(*args, **kwargs)
            except self.retry_on as e:
                state.retry(e)

    @classmethod
    def from_flags(cls, flags, **overrides) -> "RetryPolicy":
        """The process-wide I/O policy (``--io_retry_*``)."""
        kw = dict(
            max_attempts=max(1, int(getattr(flags, "io_retry_attempts", 4))),
            base_delay=float(getattr(flags, "io_retry_base_delay", 0.25)),
            deadline=float(getattr(flags, "io_retry_deadline", 120.0)),
        )
        kw.update(overrides)
        return cls(**kw)


class _RetryState:
    """Attempt bookkeeping for loop-shaped work (see module docstring)."""

    def __init__(self, policy: RetryPolicy, name: str):
        self.policy = policy
        self.name = name or "retry"
        self.attempt = 0  # completed (failed) attempts
        self.started = time.monotonic()
        self._rng = random.Random(policy.seed)

    def retry(self, exc: BaseException) -> None:
        """Record a failed attempt. Sleeps and returns when another
        attempt is allowed; re-raises ``exc`` when exhausted."""
        # telemetry: every failed attempt and every give-up is counted
        # (registry snapshot rides the pass_end record; `paddle metrics`
        # surfaces the per-pass delta)
        from paddle_tpu_torch.observability import metrics as obs

        obs.registry().counter("retry.attempts").inc()
        self.attempt += 1
        p = self.policy
        elapsed = time.monotonic() - self.started
        if self.attempt >= p.max_attempts:
            logger.warning(
                "%s: attempt %d/%d failed (%s) — giving up",
                self.name, self.attempt, p.max_attempts, exc,
            )
            obs.registry().counter("retry.exhausted").inc()
            raise exc
        if p.deadline and elapsed >= p.deadline:
            logger.warning(
                "%s: retry deadline (%.1fs) exhausted after attempt %d (%s) "
                "— giving up", self.name, p.deadline, self.attempt, exc,
            )
            obs.registry().counter("retry.exhausted").inc()
            raise exc
        d = p.delay_for(self.attempt, self._rng)
        if p.deadline:
            d = min(d, max(p.deadline - elapsed, 0.0))
        obs.registry().counter("retry.backoff_s").inc(d)
        logger.warning(
            "%s: attempt %d/%d failed (%s) — retrying in %.2gs",
            self.name, self.attempt, p.max_attempts, exc, d,
        )
        if d > 0:
            p.sleep(d)
