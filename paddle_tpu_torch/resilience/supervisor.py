"""Run supervision — crash-loop-aware auto-restart (`paddle supervise`).

PR 1 made a single trainer process survive bad disks and hung providers;
this module supplies the layer above it: *noticing a dead run and
bringing it back*. `paddle supervise <train flags>` runs `paddle train`
as a child process and

- restarts it on nonzero exit with exponential backoff
  (``utils/retry.py`` is the single backoff implementation), injecting
  ``--init_model_path=auto`` so every restart resumes from the newest
  manifest-verified checkpoint;
- bounds restarts by ``--restart_budget`` — a run that cannot stay up is
  an operator problem, not something to retry forever;
- detects crash loops: ``--crash_loop_threshold`` consecutive deaths
  with NO checkpoint progress between them (same restorable pass every
  launch) classifies the failure as deterministic poison — restarting
  would replay it — so the supervisor stops and writes a JSON crash
  report (exit code, restore history, child-log tail, the last N
  structured metrics records per host from the child's metrics.jsonl
  telemetry, and the last barrier-skew record for slowest-host
  attribution — log-line grepping only as the telemetry-less fallback);
- forwards SIGTERM to the child, so a preempted supervised run still
  checkpoints at the next launch boundary (``--save_on_preempt``) and is
  NOT restarted — the preemption is the scheduler's decision;
- exit-code discipline: a child that exits ``EXIT_PREEMPTED`` (18 — it
  was SIGTERMed directly, checkpointed, and left cleanly) is restarted
  for FREE (no budget, no crash-loop accounting); a child that exits
  ``EXIT_HANG`` (19 — hangwatch killed a wedged step loop) counts as a
  real failure and its ``hang_report.json`` (thread stacks, telemetry
  tail) is embedded in the crash report.

The supervisor deliberately never initializes jax: probing the save_dir
for checkpoint progress uses the manifest layer only, so a child killed
by the accelerator runtime itself can still be supervised. Child stdout/
stderr land in ``<supervise_dir>/attempt-NNN.log`` (default
``<save_dir>/supervise``).

Chaos drills: ``--fault_spec='trainer.crash=exit:9@N'`` (forwarded to
the child like every other train flag) kills the child at the Nth
trained launch — deterministic, so tests/test_supervision.py proves both
the recovery path and the crash-loop stop.
"""

from __future__ import annotations

import json
import os
import random
import shlex
import signal
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional

from paddle_tpu_torch.resilience import (
    EXIT_CRASH_LOOP,
    EXIT_HANG,
    EXIT_OOM,
    EXIT_PREEMPTED,
)
from paddle_tpu_torch.utils.logging import logger
from paddle_tpu_torch.utils.retry import RetryPolicy

CRASH_REPORT = "crash_report.json"
LOG_TAIL_BYTES = 8192
METRICS_TAIL_RECORDS = 25  # last N metrics records per host in the report
# preemption restarts are budget-free, but not INFINITE: a child that is
# SIGTERMed moments after every launch (broken node agent, cgroup
# killer) would otherwise loop forever. 100 consecutive preemptions
# with zero completed runs is a storm, not scheduling.
FREE_RESTART_LIMIT = 100


def probe_restorable(save_dir: str) -> Optional[str]:
    """Newest pass dir under ``save_dir`` that passes manifest
    verification, or None. jax-free twin of
    ``checkpoint.find_restorable_checkpoint`` — the supervisor uses it
    only to detect PROGRESS between child deaths; the authoritative
    restore is the child's own ``--init_model_path=auto``."""
    if not save_dir or not os.path.isdir(save_dir):
        return None
    from paddle_tpu_torch.resilience.manifest import verify_dir

    cands = []
    for name in os.listdir(save_dir):
        base = name[: -len(".old")] if name.endswith(".old") else name
        if not (base.startswith("pass-") and base[5:].isdigit()):
            continue
        cands.append((int(base[5:]), not name.endswith(".old"), name))
    # newest pass wins; for the same pass id a completed dir beats the
    # torn-commit ``.old`` leftover
    for _pid, _plain, name in sorted(cands, reverse=True):
        path = os.path.join(save_dir, name)
        if not os.path.exists(os.path.join(path, "meta.json")):
            continue  # still being written, or not a checkpoint at all
        if verify_dir(path) == []:
            return path
    return None


class Supervisor:
    """Launch/restart driver around one `paddle train` child.

    ``child_cmd`` overrides the spawned command (tests drive the restart
    machinery with tiny stub children); ``probe`` overrides the
    checkpoint-progress probe; ``sleep`` makes backoff testable."""

    def __init__(
        self,
        train_args: List[str],
        flags,
        child_cmd: Optional[List[str]] = None,
        probe: Optional[Callable[[], Optional[str]]] = None,
        sleep: Callable[[float], None] = time.sleep,
    ):
        self.train_args = list(train_args)
        self.flags = flags
        self._child_cmd_override = child_cmd
        # which child this supervises: `paddle train` (default) or
        # `paddle serve` (--supervise_job=serve). The exit-code
        # discipline is identical (17/18/19/20, preemption free); the
        # deltas are restart args (a serve child keeps its own — the
        # request journal, not a checkpoint, is its resume state) and
        # the crash-loop progress probe (journal answered-count instead
        # of restorable passes).
        self.job = getattr(flags, "supervise_job", "train") or "train"
        self.save_dir = getattr(flags, "save_dir", "") or ""
        # where the child's telemetry lands (observability/metrics.py
        # resolves the same way: --metrics_path wins, save_dir doubles
        # as the run dir) — the crash report reads its tail from here
        self.metrics_dir = (
            getattr(flags, "metrics_path", "") or self.save_dir
        )
        self.dir = getattr(flags, "supervise_dir", "") or (
            os.path.join(self.save_dir, "supervise")
            if self.save_dir else "supervise"
        )
        self.budget = max(0, int(getattr(flags, "restart_budget", 5)))
        self.loop_threshold = max(
            1, int(getattr(flags, "crash_loop_threshold", 3))
        )
        self.backoff = RetryPolicy(
            max_attempts=self.budget + 1,
            base_delay=float(getattr(flags, "restart_base_delay", 1.0)),
            max_delay=60.0,
            name="supervise-restart",
            sleep=sleep,
        )
        if probe is not None:
            self._probe = probe
        elif self.job == "serve":
            journal = getattr(flags, "serve_journal_path", "") or ""
            self._probe = lambda: self._probe_serve(journal)
        else:
            self._probe = lambda: probe_restorable(self.save_dir)
        # wall-clock birth of this supervise invocation: the staleness
        # gate for hang_report.json (see _hang_report)
        self._t0_wall = time.time()
        self._rng = random.Random()
        self._proc: Optional[subprocess.Popen] = None
        self._terminating = False
        self.attempts: List[Dict] = []

    # ------------------------------------------------------------ child

    @staticmethod
    def _probe_serve(journal_path: str):
        """Serve-child progress = the request journal's answered count
        (jax-free, like the manifest probe): consecutive deaths with an
        identical fingerprint served nothing between them — the crash
        loop a restart would only replay."""
        from paddle_tpu_torch.serving.resilience import journal_progress

        return journal_progress(journal_path)

    def child_cmd(self, restart: bool) -> List[str]:
        if self._child_cmd_override is not None:
            return list(self._child_cmd_override)
        from paddle_tpu_torch.utils.flags import strip_flag

        # --dry_run is the supervisor's own; the trainer would ignore it,
        # but forwarding it makes the printed plan misleading to copy.
        # --supervise_job likewise: the child would warn on it
        args = [
            a for a in self.train_args
            if a != "--dry_run" and not a.startswith("--dry_run=")
        ]
        args = strip_flag(args, "supervise_job")
        if restart and self.job != "serve":
            # every restart resumes from the newest verified checkpoint;
            # the user's own --init_model_path only applies to the first
            # launch (an explicit pretrained init must not clobber the
            # progress the run made before dying). A serve child keeps
            # its args untouched — its resume state is the request
            # journal (--serve_journal_path), re-offered by the child
            # itself at startup.
            args = strip_flag(args, "init_model_path")
            args.append("--init_model_path=auto")
        return [sys.executable, "-m", "paddle_tpu_torch.cli", self.job, *args]

    def describe(self) -> str:
        q = lambda cmd: " ".join(shlex.quote(c) for c in cmd)
        return "\n".join([
            "supervise plan:",
            f"  child:      {q(self.child_cmd(restart=False))}",
            f"  on restart: {q(self.child_cmd(restart=True))}",
            f"  restart_budget={self.budget} "
            f"crash_loop_threshold={self.loop_threshold}",
            f"  backoff: base={self.backoff.base_delay:g}s "
            f"x{self.backoff.multiplier:g} (cap {self.backoff.max_delay:g}s, "
            f"jitter +/-{self.backoff.jitter:g})",
            f"  logs: {os.path.join(self.dir, 'attempt-NNN.log')}",
            f"  crash report: {os.path.join(self.dir, CRASH_REPORT)}",
        ])

    # -------------------------------------------------------------- run

    def run(self) -> int:
        if getattr(self.flags, "dry_run", False):
            print(self.describe())
            return 0
        os.makedirs(self.dir, exist_ok=True)
        restarts = 0
        restarts_free = 0  # preemption restarts: never charged to budget
        same_state_deaths = 0
        prev_restored: object = self  # sentinel: no failed attempt yet
        prev_handler = self._install_sigterm()
        try:
            while True:
                restored = self._probe()
                rc, log_path = self._run_once(
                    restart=(restarts + restarts_free) > 0,
                    restored=restored,
                )
                if rc == 0:
                    logger.info(
                        "supervise: child finished cleanly after %d "
                        "restart(s)", restarts,
                    )
                    return 0
                if self._terminating:
                    logger.info(
                        "supervise: SIGTERM forwarded — child exited rc=%d, "
                        "not restarting (resume later with the same "
                        "command; --init_model_path=auto picks up the "
                        "preemption checkpoint)", rc,
                    )
                    return rc
                if rc == EXIT_PREEMPTED:
                    # the CHILD was preempted directly (its own SIGTERM,
                    # not one we forwarded): it checkpointed and exited
                    # cleanly. Preemption is the scheduler's decision,
                    # not the run's failure — restart for free: no
                    # restart budget consumed, no crash-loop accounting
                    # (a preempted attempt that made no checkpoint
                    # progress is NOT evidence of poison).
                    restarts_free += 1
                    if restarts_free > FREE_RESTART_LIMIT:
                        self._crash_report(
                            "preemption_storm", log_path,
                            f"{restarts_free} consecutive preemption "
                            "exits with no completed run — something is "
                            "killing every child, not scheduling them",
                        )
                        return EXIT_PREEMPTED
                    # escalating delay (capped at the policy max): a
                    # rapid preemption storm must not hot-loop launches
                    delay = self.backoff.delay_for(
                        min(restarts_free, 8), self._rng
                    )
                    logger.info(
                        "supervise: child preempted (rc=%d) — restarting "
                        "without consuming budget (free restart #%d) in "
                        "%.2gs", rc, restarts_free, delay,
                    )
                    if delay > 0:
                        self.backoff.sleep(delay)
                    if self._terminating:
                        logger.info(
                            "supervise: SIGTERM during preemption restart "
                            "— not relaunching"
                        )
                        return rc
                    continue
                # crash-loop detection: consecutive deaths launched from
                # the SAME restorable state made zero progress — a
                # deterministic failure a restart would only replay
                same_state_deaths = (
                    same_state_deaths + 1 if restored == prev_restored else 1
                )
                prev_restored = restored
                if same_state_deaths >= self.loop_threshold:
                    self._crash_report(
                        "crash_loop", log_path,
                        f"{same_state_deaths} consecutive deaths with no "
                        f"checkpoint progress (restored_from={restored!r})",
                    )
                    return EXIT_CRASH_LOOP
                if restarts >= self.budget:
                    self._crash_report(
                        "restart_budget_exhausted", log_path,
                        f"child still failing after {restarts} restart(s)",
                    )
                    return rc
                restarts += 1
                delay = self.backoff.delay_for(restarts, self._rng)
                logger.warning(
                    "supervise: child died rc=%d%s (restored_from=%s) — "
                    "restart %d/%d in %.2gs",
                    rc,
                    " (hang detected — see hang_report.json)"
                    if rc == EXIT_HANG else "",
                    restored, restarts, self.budget, delay,
                )
                if delay > 0:
                    self.backoff.sleep(delay)
                if self._terminating:
                    # SIGTERM landed between children (during the backoff
                    # sleep): there was no child to forward it to — honor
                    # it HERE instead of launching a fresh trainer the
                    # scheduler is about to hard-kill
                    logger.info(
                        "supervise: SIGTERM during restart backoff — "
                        "not relaunching"
                    )
                    return rc
        finally:
            self._restore_sigterm(prev_handler)

    def _run_once(self, restart: bool, restored: Optional[str]):
        log_path = os.path.join(
            self.dir, f"attempt-{len(self.attempts):03d}.log"
        )
        cmd = self.child_cmd(restart=restart)
        t0 = time.monotonic()
        with open(log_path, "ab") as lf:
            self._proc = subprocess.Popen(
                cmd, stdout=lf, stderr=subprocess.STDOUT
            )
            try:
                rc = self._proc.wait()
            finally:
                self._proc = None
        self.attempts.append({
            "cmd": cmd,
            "exit_code": rc,
            "restored_from": restored,
            "duration_s": round(time.monotonic() - t0, 3),
            "log": log_path,
        })
        return rc, log_path

    # ---------------------------------------------------------- signals

    def _install_sigterm(self):
        """Forward SIGTERM (preemption notice) to the child so its own
        --save_on_preempt handler checkpoints; a forwarded SIGTERM also
        stops the restart loop. No-op off the main thread (library/test
        embedding), same degradation as the trainer's guard."""
        from paddle_tpu_torch.utils import concurrency as cc

        if cc.current_thread() is not cc.main_thread():
            return None

        def fwd(signum, frame):
            self._terminating = True
            proc = self._proc
            if proc is not None and proc.poll() is None:
                try:
                    proc.send_signal(signal.SIGTERM)
                except OSError:
                    pass

        prev = signal.getsignal(signal.SIGTERM)
        signal.signal(signal.SIGTERM, fwd)
        return (prev,)

    def _restore_sigterm(self, token) -> None:
        if token is None:
            return
        prev = token[0]
        signal.signal(
            signal.SIGTERM, prev if prev is not None else signal.SIG_DFL
        )

    # ----------------------------------------------------- crash report

    @staticmethod
    def _log_tail(log_path: str) -> str:
        try:
            with open(log_path, "rb") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(max(0, size - LOG_TAIL_BYTES))
                return f.read().decode("utf-8", "replace")
        except OSError:
            return ""

    def _metrics_tail(self):
        """Last N structured telemetry records per host from the child's
        metrics.jsonl streams (observability/metrics.py) — the primary
        post-mortem evidence, replacing log-grepping. Returns ({host:
        [records]}, last barrier_skew record or None)."""
        if not self.metrics_dir:
            return {}, None
        from paddle_tpu_torch.observability.metrics import tail_with_last_skew

        return tail_with_last_skew(self.metrics_dir, n=METRICS_TAIL_RECORDS)

    def _forensics_report(self, filename: str):
        """A child-written forensics JSON (hang_report.json /
        oom_report.json) from the run dir, freshness-gated to THIS
        supervise invocation: a report older than _t0_wall is a
        leftover from a previous incident in the same save_dir and
        embedding it would present another process's evidence as this
        run's. The child stamps written_at on the same host (same
        clock); the file mtime is only the parse-failure fallback —
        an NFS-server-assigned mtime can skew by seconds."""
        if not self.metrics_dir:
            return None
        from paddle_tpu_torch.resilience.hangwatch import run_dir_of

        path = os.path.join(run_dir_of(self.metrics_dir), filename)
        try:
            with open(path) as f:
                report = json.load(f)
        except (OSError, ValueError):
            return None
        written = None
        try:
            written = time.mktime(time.strptime(
                str(report.get("written_at", ""))[:19], "%Y-%m-%dT%H:%M:%S"
            ))
        except ValueError:
            try:
                written = os.path.getmtime(path)
            except OSError:
                pass
        if written is not None and written < self._t0_wall - 1.0:
            logger.warning(
                "supervise: %s predates this supervise run — stale "
                "forensics from an earlier incident, not embedding", path,
            )
            return None
        return report

    def _hang_report(self):
        """The child's hang forensics, when any attempt died of a
        detected hang (EXIT_HANG): hangwatch writes hang_report.json
        into the same run dir the metrics tail comes from — a serve
        child's hangwatch writes serve_hang_report.json (thread stacks
        PLUS the in-flight cohort snapshot) instead. Parsed and
        embedded so one crash_report.json carries the whole story."""
        from paddle_tpu_torch.resilience.hangwatch import HANG_REPORT

        report = self._forensics_report(HANG_REPORT)
        if report is None:
            from paddle_tpu_torch.serving.resilience import SERVE_HANG_REPORT

            report = self._forensics_report(SERVE_HANG_REPORT)
        return report

    def _oom_report(self):
        """The child's OOM pre-mortem (oom_report.json — per-group
        static footprint, last live memory snapshot), when any attempt
        died of device-memory exhaustion (EXIT_OOM). Same run dir, same
        freshness gate as the hang forensics."""
        from paddle_tpu_torch.observability.memory import OOM_REPORT

        return self._forensics_report(OOM_REPORT)

    def _crash_report(self, reason: str, log_path: str, detail: str) -> str:
        tail = self._log_tail(log_path)
        # slowest-host attribution for multi-host deaths: primary source
        # is the structured barrier_skew metrics record; a telemetry-less
        # child (no save_dir/--metrics_path) falls back to grepping the
        # BarrierStat log line the trainer still prints at pass end
        metrics_tail, skew_rec = self._metrics_tail()
        skew = skew_rec if skew_rec is not None else next(
            (l for l in reversed(tail.splitlines()) if "BarrierStat:" in l),
            None,
        )
        report = {
            "reason": reason,
            "detail": detail,
            "restart_budget": self.budget,
            "crash_loop_threshold": self.loop_threshold,
            "train_args": self.train_args,
            "attempts": self.attempts,
            "log_tail": tail,
            "metrics_tail": metrics_tail,
            "step_time_skew": skew,
            "written_at": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
        }
        # a hung attempt left in-process forensics — attach them
        if any(a.get("exit_code") == EXIT_HANG for a in self.attempts):
            report["hang_report"] = self._hang_report()
        # same for an OOM'd attempt's pre-mortem (exit 20: the child
        # classified its own death and ranked the launch groups by
        # static footprint before dying)
        if any(a.get("exit_code") == EXIT_OOM for a in self.attempts):
            report["oom_report"] = self._oom_report()
        path = os.path.join(self.dir, CRASH_REPORT)
        with open(path, "w") as f:
            json.dump(report, f, indent=2)
        logger.error(
            "supervise: %s (%s) — giving up; crash report: %s\n"
            "--- last child output ---\n%s",
            reason, detail, path,
            "\n".join(tail.splitlines()[-15:]),
        )
        return path
