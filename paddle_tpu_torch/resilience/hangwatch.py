"""In-process step-progress watchdog (``--step_hang_timeout``).

Hangs — not clean crashes — dominate lost pod-hours at scale (MegaScale,
Jiang et al. 2024): one wedged host leaves every other host blocked
inside a collective, and a fail-fast stack like ours (PR 1-3) only
reacts to processes that *exit*. A hung trainer previously burned its
whole external timeout with zero forensics.

:class:`HangWatch` closes the in-process half of that gap. The trainer
pings it at every launch/step boundary; a daemon monitor thread tracks
the age of the last ping. When the age exceeds ``--step_hang_timeout``
the monitor

1. dumps every Python thread's stack — structured (per-thread frame
   lists, for ``hang_report.json``) *and* via ``faulthandler`` to
   stderr (the raw form that survives even a wedged allocator),
2. attaches the telemetry tail (last metrics.jsonl records) and the
   last ``barrier_skew`` record, so a multi-host hang carries
   straggler attribution,
3. writes ``hang_report.json`` into the run dir, and
4. exits with the distinct code :data:`EXIT_HANG` (19), so supervisors
   and launchers see a *diagnosed* hang instead of a timeout mystery.

The monitor also publishes the live ``trainer.progress_age_s`` gauge
into the metrics registry and keeps a max-since-last-read the trainer
folds into each ``pass_end`` record (``progress_age_max_s``), which
`paddle metrics` surfaces per pass.

jax-free and stdlib-light: the supervisor imports this module for the
report filename and exit code, and it must stay importable when the
accelerator runtime is what wedged the child.

Chaos drills: the ``trainer.stall`` fault site
(``--fault_spec='trainer.stall=sleep:600@N'``) blocks the step loop at
the Nth launch — deterministic, so tests prove detection, forensics,
and the supervised restart end to end.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import traceback
from typing import Any, Callable, Dict, Optional, Tuple

from paddle_tpu_torch.resilience import EXIT_HANG  # re-export for callers
from paddle_tpu_torch.utils import concurrency as cc
from paddle_tpu_torch.utils.logging import logger

HANG_REPORT = "hang_report.json"

# hard deadline on the forensics themselves: every write in _trigger
# (report file, metrics flush) can block in uninterruptible I/O when the
# SHARED FS is what wedged — the exact failure class the watchdog
# exists for — so a backstop timer guarantees the exit regardless
FORENSICS_DEADLINE_S = 30.0

__all__ = ["EXIT_HANG", "HANG_REPORT", "HangWatch", "run_dir_of",
           "thread_stacks"]


def run_dir_of(metrics_path: str) -> str:
    """The run DIRECTORY for a ``--metrics_path`` value — which the
    metrics layer allows to be either a run dir or an explicit
    ``*.jsonl`` stream file. The hang report (and the supervisor
    looking for it) must agree on the directory either way; treating a
    ``.jsonl`` path as a directory would make ``os.makedirs`` fail and
    silently drop the forensics."""
    if metrics_path.endswith(".jsonl"):
        return os.path.dirname(metrics_path) or "."
    return metrics_path


def thread_stacks() -> Dict[str, Any]:
    """Every live Python thread's current stack, structured for JSON:
    ``{thread name: {"daemon": bool, "frames": ["file:line fn | src"]}}``.
    Never raises — forensics must not be able to mask the hang."""
    names = {t.ident: t for t in threading.enumerate()}
    out: Dict[str, Any] = {}
    try:
        frames = sys._current_frames()
    except Exception:  # pragma: no cover - CPython always provides it
        return out
    for ident, frame in frames.items():
        t = names.get(ident)
        label = f"{t.name} (tid={ident})" if t is not None else f"tid={ident}"
        rows = []
        for fs in traceback.extract_stack(frame):
            rows.append(f"{fs.filename}:{fs.lineno} {fs.name} | "
                        f"{(fs.line or '').strip()}")
        out[label] = {
            "daemon": bool(t.daemon) if t is not None else None,
            "frames": rows,
        }
    return out


class HangWatch:
    """Step-progress monitor. ``ping()`` from the driven thread at every
    launch boundary; the monitor thread fires once the ping age exceeds
    ``timeout_s``.

    Injectable seams (``clock``, ``exit_fn``, ``poll_s``) exist for
    fake-clock unit tests; production uses monotonic time and
    ``os._exit`` (a wedged main thread cannot run atexit handlers — the
    telemetry layer flushes explicitly before exit, exactly like an
    ``exit``-action fault).

    Subclass seams (the serving watch,
    ``paddle_tpu/serving/resilience.py``): ``REPORT_NAME``/``REASON``
    name the forensics file and its ``reason`` field;
    :meth:`_pre_exit` runs after the report + telemetry flush and
    before the exit — the hook where a server answers what it still
    can (the backstop timer does NOT wait for it, so a wedged hook can
    only delay the exit up to its own bounded waits, never past
    :data:`FORENSICS_DEADLINE_S`)."""

    REPORT_NAME = HANG_REPORT
    REASON = "step_hang"

    def __init__(
        self,
        timeout_s: float,
        report_dir: str = "",
        *,
        clock: Optional[Callable[[], float]] = None,
        exit_fn: Callable[[int], None] = os._exit,
        poll_s: Optional[float] = None,
    ):
        assert timeout_s > 0, timeout_s
        self.timeout_s = float(timeout_s)
        self.report_dir = report_dir or "."
        # resolved at construction through the concurrency seam: under
        # `paddle race` the watch runs on the explorer's virtual clock
        self.clock = clock if clock is not None else cc.monotonic
        self.exit_fn = exit_fn
        self.poll_s = float(poll_s) if poll_s else min(self.timeout_s / 4.0, 5.0)
        self._lock = cc.Lock()
        self._last = self.clock()
        self._where: Tuple[Optional[int], Optional[int]] = (None, None)
        self._max_age = 0.0
        self._stop = cc.Event()
        self._thread = None
        self._fired = False

    # ------------------------------------------------------------ driven side

    def ping(self, pass_id: Optional[int] = None,
             step: Optional[int] = None) -> None:
        """Record progress. Called at every launch/step boundary (and at
        coarser boundaries — pass end, save, test) by the step loop."""
        with self._lock:
            now = self.clock()
            # fold the age this ping just ended into the max BEFORE
            # resetting: a near-miss stall shorter than the monitor's
            # poll period would otherwise never reach
            # progress_age_max_s — the exact signal operators tune
            # --step_hang_timeout against
            age = now - self._last
            if age > self._max_age:
                self._max_age = age
            self._last = now
            self._where = (pass_id, step)

    def take_max_age(self) -> float:
        """Max observed progress age since the last call (seconds), then
        reset — the trainer folds this into each ``pass_end`` record."""
        with self._lock:
            v, self._max_age = self._max_age, 0.0
        return v

    # ----------------------------------------------------------- monitor side

    def start(self) -> "HangWatch":
        if self._thread is None:
            # fresh epoch, not a ping: construction-to-start time (model
            # init, checkpoint restore) is not step progress and must
            # not seed either the hang age or the per-pass max
            with self._lock:
                self._last = self.clock()
                self._max_age = 0.0
            self._stop.clear()
            self._thread = cc.Thread(
                target=self._run, name="hangwatch", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=max(self.poll_s * 2, 1.0))

    def __enter__(self) -> "HangWatch":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            self.check()

    def check(self) -> float:
        """One monitor tick: update the gauge/max, fire on a stall.
        Public so fake-clock tests drive it without the thread; returns
        the observed age."""
        with self._lock:
            age = self.clock() - self._last
            if age > self._max_age:
                self._max_age = age
            where = self._where
            # claim the firing under the lock: check() is driven by the
            # monitor thread in production AND directly by fake-clock
            # tests — an unlocked test-and-set could file two reports
            fire = age > self.timeout_s and not self._fired
            if fire:
                self._fired = True  # one report even if exit_fn returns (tests)
        from paddle_tpu_torch.observability import metrics as obs

        obs.registry().gauge("trainer.progress_age_s").set(age)
        if fire:
            self._trigger(age, where)
        return age

    # ------------------------------------------------------------- the report

    def _trigger(self, age: float, where) -> None:
        pass_id, step = where
        logger.error(
            "hangwatch: no step progress for %.1fs (> timeout=%g) "
            "— last progress at pass=%s step=%s; dumping thread stacks and "
            "writing %s, then exiting %d",
            age, self.timeout_s, pass_id, step,
            os.path.join(self.report_dir, self.REPORT_NAME), EXIT_HANG,
        )
        try:
            import faulthandler

            # the stderr dump goes FIRST: it cannot touch the (possibly
            # wedged) shared fs, so the stacks survive even when nothing
            # below completes
            faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
        except Exception:
            pass
        # every write below may block in uninterruptible I/O on the very
        # filesystem whose death caused the hang — OSError would never
        # fire. The backstop guarantees exit 19 within
        # FORENSICS_DEADLINE_S no matter what the forensics do.
        backstop = cc.Timer(
            FORENSICS_DEADLINE_S, self.exit_fn, args=(EXIT_HANG,)
        )
        backstop.daemon = True
        backstop.start()
        report = self.build_report(age, where)
        path = self.write_report(report)
        from paddle_tpu_torch.observability import metrics as obs

        obs.registry().counter("hangs.detected").inc()
        obs.emit("hang", pass_id=pass_id, step=step, age_s=round(age, 3),
                 timeout_s=self.timeout_s, report=path)
        obs.flush()  # os._exit skips atexit — same discipline as exit faults
        try:
            # subclass hook: the serving watch resolves every in-flight
            # request with outcome=error here, so clients hear "the
            # server hung" instead of waiting out their own timeouts.
            # Best-effort — the hang must exit regardless.
            self._pre_exit()
        except Exception:
            pass
        backstop.cancel()  # forensics completed: exit on the normal path
        self.exit_fn(EXIT_HANG)

    def _pre_exit(self) -> None:
        """Hook between forensics and exit (see class docstring)."""

    def build_report(self, age: float, where) -> Dict[str, Any]:
        pass_id, step = where
        report: Dict[str, Any] = {
            "reason": self.REASON,
            "age_s": round(age, 3),
            "timeout_s": self.timeout_s,
            "last_progress": {"pass": pass_id, "step": step},
            "pid": os.getpid(),
            "written_at": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
            "threads": thread_stacks(),
        }
        # telemetry tail + last barrier_skew: the same post-mortem
        # evidence the supervisor's crash report carries (one shared
        # helper, so the skew-selection rule cannot drift), gathered
        # here because only THIS process knows it is about to die
        try:
            from paddle_tpu_torch.observability.metrics import tail_with_last_skew

            tails, skew = tail_with_last_skew(self.report_dir, n=25)
            report["metrics_tail"] = tails
            report["barrier_skew"] = skew
        except Exception as e:  # forensics best-effort, never masks the hang
            report["metrics_tail_error"] = str(e)
        return report

    def write_report(self, report: Dict[str, Any]) -> str:
        path = os.path.join(self.report_dir, self.REPORT_NAME)
        try:
            os.makedirs(self.report_dir, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(report, f, indent=2, default=str)
            os.replace(tmp, path)  # readers never see a torn report
        except OSError as e:
            logger.error("hangwatch: could not write %s: %s", path, e)
        return path
