"""Fault-tolerance layer.

The reference PaddlePaddle v0 is fail-fast only — its recovery story is
"restart from the last pass directory and hope the files are intact"
(SURVEY §5). At pod scale preemptions, transient shared-filesystem
errors, and hung data providers are routine, so this package supplies
the missing half: *surviving* the failure, not just noticing it.

Pieces (see doc/resilience.md for the failure model):

- ``manifest``  — per-file CRC32/size manifests (``MANIFEST.json``) that
  make a checkpoint directory self-verifying; used by the atomic
  write-rename protocol in ``trainer/checkpoint.py`` and the offline
  ``paddle check-checkpoint`` subcommand.
- ``faultinject`` — deterministic, seeded, site-named fault injection
  (``checkpoint.write``, ``checkpoint.rename``, ``provider.yield``,
  ``provider.stall``, ``trainer.crash``, ``trainer.nonfinite``) so chaos
  tests exercise mid-write crashes, torn renames, flaky providers,
  stalls, mid-run process deaths, and diverging losses reproducibly.
- ``supervisor`` — `paddle supervise`: run `paddle train` as a child
  process, restart it with backoff and ``--init_model_path=auto`` on
  nonzero exit, detect crash loops (repeated death at the same restored
  checkpoint), and emit a JSON crash report when recovery is hopeless.
- ``hangwatch`` — in-process step-progress watchdog: the trainer pings
  it at every launch boundary; a stall longer than
  ``--step_hang_timeout`` dumps all thread stacks + the telemetry tail
  into ``hang_report.json`` and exits ``EXIT_HANG`` so supervisors see
  a *diagnosed* death instead of a silent external timeout.
- ``heartbeat`` — cluster-level liveness: each host renews a heartbeat
  file under the shared run dir; ``cluster_launch`` polls staleness so
  a wedged-but-alive rank is named and torn down instead of burning
  every other host inside a blocked collective.
- errors below — typed failures the trainer and tools can act on.

Exit-code discipline (supervisors and launchers dispatch on these —
all distinct from each other and from ordinary crash codes):

- ``EXIT_CRASH_LOOP`` (17) — the supervisor classified the failure as
  deterministic poison and stopped restarting.
- ``EXIT_PREEMPTED`` (18) — the trainer was SIGTERM-preempted, saved at
  a launch boundary, and exited cleanly; supervisors/launchers restart
  WITHOUT consuming restart budget (preemption is the scheduler's
  decision, not the run's failure).
- ``EXIT_HANG`` (19) — hangwatch detected a stalled step loop, wrote
  ``hang_report.json``, and killed the process; counts as a real
  failure (budget consumed), with forensics attached.
- ``EXIT_OOM`` (20) — a launch died of device-memory exhaustion
  (RESOURCE_EXHAUSTED); the trainer wrote ``oom_report.json``
  (per-launch-group static footprint ranked, last live memory
  snapshot, telemetry tail — observability/memory.py) before exiting.
  Budget-consuming like a hang: an OOM is deterministic poison (the
  same model at the same batch size OOMs again), so an OOM loop must
  never restart for free.

The shared backoff machinery lives in ``paddle_tpu_torch.utils.retry``
(checkpoint I/O and data-provider iteration both use it). The
L-BFGS/OWL-QN line-search "backoff" in ``optimizer/batch_methods.py`` is
a *numerical* step-shrink factor, not an I/O retry, and intentionally
stays separate.
"""

from __future__ import annotations

# canonical process exit codes (see module docstring). EXIT_CRASH_LOOP
# predates this table and is re-exported by resilience.supervisor for
# existing importers; the values must stay distinct forever — wrappers
# dispatch on them.
EXIT_CRASH_LOOP = 17
EXIT_PREEMPTED = 18
EXIT_HANG = 19
EXIT_OOM = 20


class CheckpointError(RuntimeError):
    """A checkpoint operation failed. Base of the corruption case below;
    raised directly by the async checkpoint pipeline
    (``trainer/async_ckpt.py``) when a background write failed — the
    error surfaces on the NEXT save or drain so an async failure can
    never be silently lost."""


class CheckpointCorruptError(CheckpointError):
    """A checkpoint directory failed manifest/completeness verification
    and no fallback pass directory could be restored either."""

    def __init__(self, message: str, problems=None):
        super().__init__(message)
        self.problems = list(problems or [])


class DataStallError(RuntimeError):
    """The data-pipeline watchdog saw no provider progress within the
    configured stall timeout (``--data_stall_timeout``)."""


class BadSampleError(RuntimeError):
    """More malformed samples than ``--max_bad_samples`` allows."""


class NonFiniteLossError(FloatingPointError):
    """A training loss (or whole-data cost) came back NaN/Inf and the
    configured ``--nonfinite_policy`` could not (or may not) recover:
    ``abort`` raises immediately, ``skip``/``rollback`` raise once the
    ``--max_nonfinite_steps`` budget is exhausted or no restorable
    checkpoint exists to roll back to.

    Subclasses ``FloatingPointError`` so pre-existing fail-fast callers
    keep working; supervisors and tests should catch THIS type to
    classify divergence separately from an ordinary crash."""

    def __init__(self, message: str, value=None, pass_id=None, batch_id=None):
        super().__init__(message)
        self.value = value
        self.pass_id = pass_id
        self.batch_id = batch_id


__all__ = [
    "EXIT_CRASH_LOOP",
    "EXIT_PREEMPTED",
    "EXIT_HANG",
    "EXIT_OOM",
    "CheckpointError",
    "CheckpointCorruptError",
    "DataStallError",
    "BadSampleError",
    "NonFiniteLossError",
]
