"""Deterministic, site-named fault injection.

Production failure modes — a crash between checkpoint write and rename,
a torn shard, a provider that throws EIO once, a prefetch worker that
hangs — are impossible to reproduce on demand without help. This module
plants named injection points at the few places those failures occur and
fires them from a declarative spec, so chaos tests (and operators
rehearsing recovery) get the exact same failure every run.

Spec grammar (``--fault_spec`` / ``PADDLE_TPU_FAULTS``)::

    spec    := entry (';' entry)*
    entry   := site '=' action [':' arg] ['@' trigger]
    action  := raise | oserror | exit | sleep
    trigger := N      fire on the Nth hit of the site only (1-based)
             | N+     fire on every hit >= N
             | pP     fire with probability P per hit (seeded, so the
                      decision sequence is a pure function of
                      (seed, site) — reruns fail identically)

Actions: ``raise`` raises FaultInjected (simulated crash the test can
observe in-process); ``oserror`` raises OSError(EIO) (a *retryable*
transient, exercises RetryPolicy); ``exit[:code]`` calls os._exit
(a real mid-write kill — no atexit, no finally blocks, default code 3);
``sleep[:secs]`` blocks the calling thread (stalls, default 3600).

Examples::

    checkpoint.rename=exit@1          # die between write and rename
    provider.yield=oserror@3          # 3rd sample read throws EIO once
    provider.stall=sleep:120@5        # prefetch worker hangs at item 5
    checkpoint.write=oserror@p0.2     # 20% of file writes flake

Instrumented sites: see ``SITE_DOCS`` below — `paddle faults` prints
the same table, so chaos specs are written from documentation instead
of read out of source.

Inactive cost is one global ``is None`` check per site hit.
"""

from __future__ import annotations

import os
import random
import re
import time
import zlib
from typing import Dict, List, Optional

ENV_SPEC = "PADDLE_TPU_FAULTS"
ENV_SEED = "PADDLE_TPU_FAULT_SEED"

# every instrumented site, with the one-line description `paddle faults`
# prints — chaos specs should be written from this table, not guessed
# from source. Keys double as the KNOWN_SITES membership set.
SITE_DOCS = {
    "checkpoint.write":
        "before each checkpoint file write (oserror = flaky disk; "
        "exit = die mid-write)",
    "checkpoint.rename":
        "between checkpoint write and the tmp->final commit rename "
        "(exit = torn commit)",
    "provider.yield":
        "before each sample leaves a data provider (oserror = "
        "retryable read flake)",
    "provider.stall":
        "inside the prefetch worker loop (sleep = hung data pipeline, "
        "trips the --data_stall_timeout watchdog)",
    "trainer.crash":
        "before each trained launch (exit = mid-run process death for "
        "`paddle supervise` drills)",
    "trainer.stall":
        "before each trained launch (sleep = wedged step loop, trips "
        "the --step_hang_timeout hangwatch -> hang_report.json + "
        "exit 19)",
    "trainer.nonfinite":
        "at the per-batch loss check (raise = that batch's loss "
        "becomes NaN, the deterministic divergence for "
        "--nonfinite_policy drills)",
    "trainer.oom":
        "before each trained launch (raise = a synthetic "
        "RESOURCE_EXHAUSTED at the launch boundary -> oom_report.json "
        "+ exit 20, the OOM pre-mortem drill)",
    "trainer.nonfinite_layer":
        "before each trained launch (raise:LAYER = poison the named "
        "layer's parameters with NaN, as a nonfinite gradient applied "
        "by the optimizer would — the next loss goes NaN and the "
        "per-layer blame re-run must name LAYER)",
    "serve.crash":
        "at each serve collect boundary (exit = mid-serve process "
        "death for `paddle supervise --supervise_job=serve` drills — "
        "the request journal re-offers the queue on restart)",
    "serve.stall":
        "at each serve collect boundary (sleep = wedged serve_decode "
        "launch, trips the --serve_hang_timeout hangwatch -> "
        "serve_hang_report.json + in-flight answered outcome=error + "
        "exit 19)",
    "serve.oom":
        "at each serve collect boundary (raise = synthetic "
        "RESOURCE_EXHAUSTED in the serve loop -> everything answered "
        "outcome=error, oom_report.json + exit 20, budget-consuming "
        "under supervision)",
    "serve.launch_fault":
        "at each serve collect boundary (raise = one decode launch "
        "faults: the in-flight cohort resolves outcome=error and "
        "consecutive faults trip the --serve_breaker_threshold "
        "circuit breaker)",
    "fleet.replica_crash":
        "at each serve-fleet router supervision poll (raise:K = "
        "hard-kill replica index K — the journal re-offer/failover "
        "drill: its unanswered requests replay onto survivors)",
    "fleet.status_stale":
        "at each serve-fleet health probe (raise = that replica's "
        "status reads as stale — the router must route around it, "
        "never crash, and only kill it past the persistence bound)",
    "fleet.reload_torn":
        "in the weight-reload watcher between the durability probe "
        "and the checkpoint load (raise = the checkpoint became "
        "durable mid-swap — abort the attempt, keep serving old "
        "weights, retry next poll)",
    "sparse.gather_fault":
        "before each launch that prefetches sparse-table rows "
        "(raise = the touched-row gather fails — the batch aborts "
        "loudly instead of training on stale rows)",
    "sparse.row_corrupt":
        "after a durable row-shard write, before the pass commits "
        "(raise = flip a byte inside this host's row-shard file — "
        "the CRC manifest verify must catch the poisoned row and "
        "quarantine/fall back, never load it)",
    "sparse.shard_lost":
        "at the row-shard write boundary, before this host's shard "
        "bytes or partial index land (raise = this host's row "
        "shards vanish — check-checkpoint must name the exact "
        "missing row interval, not zero-init it)",
    "net.drop":
        "before each socket frame write (raise = connection reset "
        "mid-stream — the transport must reconnect with backoff and "
        "the hello handshake must re-offer undelivered requests)",
    "net.stall":
        "inside each socket read loop iteration (sleep = wedged read: "
        "heartbeat pongs stop, the replica's health goes stale and "
        "the router routes around it, then kills past the bound)",
    "net.torn_frame":
        "before each socket frame write (raise = a strict prefix of "
        "the frame is sent, then the connection closes — the reader "
        "must discard the partial frame, never crash the router)",
    "net.dup":
        "after each socket frame write (raise = the frame is sent "
        "twice — duplicate delivery the id-dedupe on both ends must "
        "absorb, like a hedge loser)",
}

KNOWN_SITES = tuple(SITE_DOCS)


class FaultInjected(RuntimeError):
    """Raised by the ``raise`` action at an injection site. ``arg``
    carries the rule's ``:arg`` payload, so sites can parameterize the
    failure (e.g. ``trainer.nonfinite_layer=raise:output`` names which
    layer to poison)."""

    def __init__(self, site: str, hit: int, info: str = "",
                 arg: Optional[str] = None):
        detail = f" ({info})" if info else ""
        super().__init__(f"injected fault at {site!r} hit #{hit}{detail}")
        self.site = site
        self.hit = hit
        self.arg = arg


_ENTRY_RE = re.compile(
    r"^(?P<site>[\w.]+)=(?P<action>raise|oserror|exit|sleep)"
    r"(?::(?P<arg>[^@]+))?(?:@(?P<trigger>.+))?$"
)


class _Rule:
    def __init__(self, site: str, action: str, arg: Optional[str], trigger: Optional[str]):
        self.site = site
        self.action = action
        self.arg = arg
        # trigger: ("nth", n) | ("from", n) | ("prob", p) | ("always",)
        if trigger is None:
            self.trigger = ("always",)
        elif trigger.startswith("p"):
            p = float(trigger[1:])
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"probability {p} out of [0, 1]")
            self.trigger = ("prob", p)
        elif trigger.endswith("+"):
            self.trigger = ("from", int(trigger[:-1]))
        else:
            self.trigger = ("nth", int(trigger))

    def should_fire(self, hit: int, rng: random.Random) -> bool:
        kind = self.trigger[0]
        if kind == "always":
            return True
        if kind == "nth":
            return hit == self.trigger[1]
        if kind == "from":
            return hit >= self.trigger[1]
        # "prob": one seeded draw per hit — deterministic in (seed, site)
        return rng.random() < self.trigger[1]

    def fire(self, site: str, hit: int, info: str) -> None:
        if self.action == "raise":
            raise FaultInjected(site, hit, info, arg=self.arg)
        if self.action == "oserror":
            import errno

            raise OSError(
                errno.EIO, f"injected transient I/O error at {site!r} hit #{hit}"
            )
        if self.action == "exit":
            code = int(self.arg) if self.arg else 3
            # os._exit: no atexit, no finally — the honest simulation of
            # a preemption landing mid-write
            os._exit(code)  # lint: disable=PTL006 -- FaultInjector.fire flushes the fault record before dispatching any action (evidence-before-action)
        if self.action == "sleep":
            time.sleep(float(self.arg) if self.arg else 3600.0)


class FaultInjector:
    """Parsed plan + per-site hit counters + seeded per-site rngs."""

    def __init__(self, spec: str, seed: int = 0):
        self.spec = spec
        self.seed = seed
        self.rules: Dict[str, List[_Rule]] = {}
        self._hits: Dict[str, int] = {}
        self._rngs: Dict[str, random.Random] = {}
        for raw in spec.replace(",", ";").split(";"):
            raw = raw.strip()
            if not raw:
                continue
            m = _ENTRY_RE.match(raw)
            if m is None:
                raise ValueError(
                    f"bad fault spec entry {raw!r} "
                    "(want site=action[:arg][@trigger])"
                )
            rule = _Rule(m["site"], m["action"], m["arg"], m["trigger"])
            if rule.site not in KNOWN_SITES:
                # a typo'd site would otherwise parse fine and never fire,
                # making a chaos drill "pass" without testing anything.
                # Warn, don't raise: tests and future call sites may plant
                # their own fault points.
                import logging

                logging.getLogger("paddle_tpu").warning(
                    "fault spec names unknown site %r (known: %s) — it will "
                    "only fire if something calls fault_point(%r)",
                    rule.site, ", ".join(KNOWN_SITES), rule.site,
                )
            self.rules.setdefault(rule.site, []).append(rule)

    def _rng(self, site: str) -> random.Random:
        rng = self._rngs.get(site)
        if rng is None:
            rng = self._rngs[site] = random.Random(
                (self.seed * 1000003) ^ zlib.crc32(site.encode())
            )
        return rng

    def fire(self, site: str, info: str = "") -> None:
        rules = self.rules.get(site)
        if not rules:
            return
        hit = self._hits.get(site, 0) + 1
        self._hits[site] = hit
        rng = self._rng(site)
        for rule in rules:
            if rule.should_fire(hit, rng):
                # count (and record) the firing BEFORE the action runs —
                # exit/raise must not lose the telemetry of their own
                # firing. Lazy import: this module stays stdlib-only
                # when injection is inactive.
                from paddle_tpu_torch.observability import metrics as obs

                obs.registry().counter("faults.fired").inc()
                obs.emit("fault", site=site, hit=hit,
                         action=rule.action, info=info)
                obs.flush()  # an exit-action fault never reaches atexit
                rule.fire(site, hit, info)

    def hits(self, site: str) -> int:
        return self._hits.get(site, 0)


_injector: Optional[FaultInjector] = None
_env_checked = False


def configure(spec: str, seed: int = 0) -> Optional[FaultInjector]:
    """Install (or with an empty spec, clear) the process-global plan."""
    global _injector, _env_checked
    _env_checked = True  # explicit configuration wins over the env var
    _injector = FaultInjector(spec, seed) if spec else None
    return _injector


def _maybe_configure_from_env() -> None:
    global _env_checked
    _env_checked = True
    spec = os.environ.get(ENV_SPEC, "")
    if spec:
        configure(spec, int(os.environ.get(ENV_SEED, "0") or 0))


def fault_point(site: str, info: str = "") -> None:
    """The hook planted at instrumented sites. No-op unless a plan
    names this site."""
    if not _env_checked:
        _maybe_configure_from_env()
    if _injector is not None:
        _injector.fire(site, info)


def is_active() -> bool:
    if not _env_checked:
        _maybe_configure_from_env()
    return _injector is not None


def current() -> Optional[FaultInjector]:
    if not _env_checked:
        _maybe_configure_from_env()
    return _injector
