"""``paddle serve-fleet`` — the multi-replica serving router.

One engine process per accelerator was PR 14's hard-to-kill unit; this
module is the tier above it (ROADMAP item 1's data-parallel serving
fan-out): a jax-free router process that supervises N ``paddle serve``
replica children, admits requests over the SAME stdin-JSONL front-end
contract as a single server, and routes each request to the least-
loaded live replica. The client cannot tell a fleet from one server —
results come back as JSONL lines in submission order, SIGTERM drains,
stdin EOF is a batch, and ``run_end`` closes the router's telemetry
stream last.

Supervision reuses the training stack's discipline rather than
reinventing it (``resilience/supervisor.py``):

- exit-code classes: ``EXIT_PREEMPTED`` (18) restarts budget-free up
  to ``FREE_RESTART_LIMIT``; everything else — including the serving
  deaths ``EXIT_CRASH_LOOP``/``EXIT_HANG``/``EXIT_OOM`` (17/19/20) —
  consumes the shared restart budget with exponential backoff;
- liveness via each replica's ``--status_path`` health JSON (the
  ``resilience/heartbeat.py`` idiom): a missing, torn, doc-level
  ``stale``, or not-renewed status file makes the replica UNHEALTHY
  (never crashes the router); persistently stale past
  ``--heartbeat_stale_after``-style bounds it is killed and treated as
  a death;
- failover via the PR-14 request journal: each replica journals its
  accepted requests (``--serve_journal_path``); on a death the router
  re-offers that replica's accepted-but-unanswered entries
  (:func:`RequestJournal.pending` semantics via the shared read-only
  parser) to the survivors. Semantics stay **at-least-once, dedupe by
  id**: a restarted replica replays its own journal, so the same id
  can be answered by two processes — the router emits the FIRST answer
  and counts the duplicate (``fleet.duplicate_answers``), so the
  client hears exactly once.

Routing is health-scored least-loaded: the router's own outstanding
count per replica plus the health JSON's queue depth and slot
occupancy; replicas whose breaker is open, which are draining, or
whose status is stale are skipped. A replica with no health document
yet (still warming up) is routable on its outstanding count alone —
child stdin buffers until its engine is ready, exactly like piping
requests to a cold single server.

The scheduling loop (:meth:`FleetRouter.run`) is a registered hot loop
(PTL002) and runs strictly through the ``utils/concurrency`` seam, so
``paddle race`` explores its interleavings against the submit/deliver
threads (tests/race_specs/spec_serve_fleet.py). Chaos sites
``fleet.replica_crash`` and ``fleet.status_stale`` fire inside the
supervision poll (doc/resilience.md).

Replica handles are duck-typed so the race spec and unit tests drive
the REAL router over in-process fakes; :class:`ProcReplica` is the
subprocess implementation ``main`` uses. The handle protocol::

    name                 str, stable replica id ("replica-0")
    start()              spawn (or revive) the child
    alive()              child process currently running
    poll_exit()          -> Optional[int] exit code once dead
    send(doc)            -> bool, forward one request JSON line
    health(now)          -> dict health doc; {"stale": True, ...} when
                            unknown/unreadable/wedged
    pending_requests()   -> journaled accepted-but-unanswered docs
    begin_drain()        SIGTERM-equivalent graceful drain
    kill()               hard kill
    join(timeout)        -> bool, wait for exit

Results flow back through a ``deliver(name, doc)`` callback the router
owns — :class:`ProcReplica` calls it from its stdout reader thread.
"""

from __future__ import annotations

import collections
import json
import os
import signal
import subprocess
import sys
from typing import Any, Callable, Dict, List, Optional

from paddle_tpu_torch.resilience import (
    EXIT_PREEMPTED,
    faultinject,
)
from paddle_tpu_torch.resilience.supervisor import FREE_RESTART_LIMIT
from paddle_tpu_torch.serving.resilience import _read_journal, read_status
from paddle_tpu_torch.utils import concurrency as cc
from paddle_tpu_torch.utils.logging import logger

#: seconds without a status-file change (StatusWriter renews ~1/s)
#: before a replica's health is considered stale; persistent staleness
#: past the same bound AFTER the startup grace is treated as a death
STALE_AFTER_S = 5.0

#: a freshly (re)started replica gets this long to import jax, warm its
#: compiles and write its first status snapshot before staleness can
#: kill it — requests routed meanwhile buffer in its stdin pipe
STARTUP_GRACE_S = 300.0

#: how often the supervision poll re-reads replica health files
HEALTH_PERIOD_S = 0.25

#: exponential-backoff cap between restarts of the same replica
RESTART_DELAY_CAP_S = 60.0

#: per-replica child fault env (chaos drills): the router strips
#: PADDLE_TPU_FAULTS from every child's environment — a fleet-level
#: spec must not fire identically in N children — and re-injects
#: PADDLE_TPU_FLEET_CHILD_FAULTS_<i> (with the shared fault seed) into
#: child i only, so "kill exactly one replica" is expressible
CHILD_FAULTS_ENV = "PADDLE_TPU_FLEET_CHILD_FAULTS_"


def replica_score(outstanding: int, health: Optional[Dict[str, Any]]) -> float:
    """Least-loaded routing score — shared by the router and the
    in-process bench fleet (:func:`drive_fleet_rung`): the caller's own
    unanswered count plus the replica's self-reported queue depth and
    slot occupancy. A stale (or absent) health doc contributes nothing:
    the outstanding count is then the only honest signal."""
    score = float(outstanding)
    if health and not health.get("stale"):
        try:
            score += float(health.get("queue_depth") or 0)
            score += float(health.get("occupancy") or 0)
        except (TypeError, ValueError):
            pass
    return score


class ProcReplica:
    """One supervised ``paddle serve`` child process.

    Owns the child's argv (status/journal/metrics paths are per-replica
    under the fleet status dir), its stdin pipe (requests in), and a
    daemon reader thread that parses result JSONL lines off its stdout
    into the router's ``deliver`` callback. Stderr is inherited — the
    child's banners and diagnostics interleave with the router's, all
    off the result stream."""

    def __init__(self, name: str, argv: List[str], *, status_path: str,
                 journal_path: str, deliver: Callable[[str, Dict], None],
                 env: Optional[Dict[str, str]] = None):
        self.name = name
        self.argv = list(argv)
        self.status_path = status_path
        self.journal_path = journal_path
        self._deliver = deliver
        self._env = env
        self._lock = cc.Lock()
        self._proc: Optional[subprocess.Popen] = None
        # (mtime_ns, size) signature of the status file and the
        # monotonic instant it last CHANGED — staleness is judged from
        # change age, never from file timestamps (PTL001: the router is
        # a hot path; wall-clock mtimes also skew across filesystems)
        self._sig: Optional[tuple] = None
        self._sig_at = cc.monotonic()

    # ------------------------------------------------------- lifecycle

    def start(self) -> None:
        # a stale status file from a previous incarnation must not make
        # the fresh child look live (or wedged) before it writes one
        try:
            os.remove(self.status_path)
        except OSError:
            pass
        proc = subprocess.Popen(
            self.argv, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            text=True, bufsize=1, env=self._env,
        )
        with self._lock:
            self._proc = proc
            self._sig = None
            self._sig_at = cc.monotonic()
        reader = cc.Thread(target=self._read_stdout, args=(proc,),
                           name=f"fleet-{self.name}-out", daemon=True)
        reader.start()

    def _read_stdout(self, proc: subprocess.Popen) -> None:
        # one reader per incarnation: it dies with its process's stdout
        # EOF, so a restart never leaves two readers on one callback
        try:
            for line in proc.stdout:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                try:
                    doc = json.loads(line)
                except ValueError:
                    continue  # never let child noise kill the router
                if isinstance(doc, dict) and "id" in doc:
                    self._deliver(self.name, doc)
        except (OSError, ValueError):
            pass

    def alive(self) -> bool:
        with self._lock:
            proc = self._proc
        return proc is not None and proc.poll() is None

    def poll_exit(self) -> Optional[int]:
        with self._lock:
            proc = self._proc
        return None if proc is None else proc.poll()

    def send(self, doc: Dict[str, Any]) -> bool:
        with self._lock:
            proc = self._proc
        if proc is None or proc.poll() is not None:
            return False
        try:
            proc.stdin.write(json.dumps(doc) + "\n")
            proc.stdin.flush()
        except (OSError, ValueError):
            return False  # a dying child's broken pipe = routing miss,
            # caught here; the death itself is reaped by the next poll
        return True

    # --------------------------------------------------------- health

    def health(self, now: float) -> Dict[str, Any]:
        """The replica's status document, or ``{"stale": True, ...}``
        when it is missing, torn, self-declared stale (the engine's
        bounded-lock timeout) or not renewed for :data:`STALE_AFTER_S`.
        Never raises — an unreadable probe is a health verdict, not a
        router crash."""
        try:
            st = os.stat(self.status_path)
            sig = (st.st_mtime_ns, st.st_size)
        except OSError:
            sig = None
        with self._lock:
            if sig != self._sig:
                self._sig = sig
                self._sig_at = now
            age = now - self._sig_at
        doc = read_status(self.status_path) if sig is not None else None
        if doc is None:
            return {"stale": True, "age_s": age,
                    "detail": "status file missing or torn"}
        if doc.get("stale"):
            doc.setdefault("age_s", age)
            return doc
        if age > STALE_AFTER_S:
            return {"stale": True, "age_s": age,
                    "detail": f"status not renewed for {age:.1f}s"}
        return doc

    def pending_requests(self) -> List[Dict[str, Any]]:
        """Accepted-but-unanswered journal entries, acceptance order —
        what failover re-offers to the survivors."""
        accepted, done = _read_journal(self.journal_path)
        return [dict(doc) for rid, doc in accepted.items()
                if rid not in done]

    # ------------------------------------------------------- shutdown

    def begin_drain(self) -> None:
        with self._lock:
            proc = self._proc
        if proc is not None and proc.poll() is None:
            try:
                proc.terminate()
            except OSError:
                pass

    def kill(self) -> None:
        with self._lock:
            proc = self._proc
        if proc is not None and proc.poll() is None:
            try:
                proc.kill()
            except OSError:
                pass

    def join(self, timeout: float) -> bool:
        with self._lock:
            proc = self._proc
        if proc is None:
            return True
        try:
            proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            return False
        return True


class FleetRouter:
    """Route requests across replica handles; supervise their lives.

    Thread contract: ``submit``/``deliver``/``note_eof``/
    ``request_drain`` are the cross-thread entry points (stdin reader,
    per-replica stdout readers, signal path); :meth:`run` is the ONE
    scheduling/supervision loop and the only emitter — results print
    in submission order exactly once, whatever the interleaving
    (tests/race_specs/spec_serve_fleet.py)."""

    def __init__(self, replicas: List[Any], *,
                 emit: Callable[[Dict[str, Any]], None],
                 poll_s: float = 0.02,
                 stale_after_s: float = STALE_AFTER_S,
                 startup_grace_s: float = STARTUP_GRACE_S,
                 health_period_s: float = HEALTH_PERIOD_S,
                 restart_budget: int = 5,
                 restart_base_delay: float = 1.0,
                 hedge_after: float = 0.0,
                 clock: Optional[Callable[[], float]] = None):
        self._emit = emit
        self.poll_s = float(poll_s)
        self.stale_after_s = float(stale_after_s)
        self.startup_grace_s = float(startup_grace_s)
        self.health_period_s = float(health_period_s)
        self.restart_budget = max(0, int(restart_budget))
        self.restart_base_delay = float(restart_base_delay)
        # hedged retries (doc/serving.md "Cross-host fleet"): a request
        # outstanding past max(hedge_after, streaming p99 of answer
        # latency) is re-sent to the next-healthiest replica; first
        # answer wins, the loser is absorbed by the dedupe. 0 disables.
        self.hedge_after = float(hedge_after)
        self._clock = clock or cc.monotonic
        self._lock = cc.Lock()
        self._wake = cc.Condition(self._lock)
        now = self._clock()
        # request state — all under self._lock
        self._order: List[str] = []            # submission order
        self._docs: Dict[str, Dict] = {}       # rid -> request doc
        self._results: Dict[str, Dict] = {}    # rid -> result doc
        self._emit_idx = 0
        self._unsent: collections.deque = collections.deque()
        self._owner: Dict[str, str] = {}       # rid -> replica name
        # distributed tracing (doc/observability.md "Distributed
        # tracing") — all under self._lock: per-rid wait-start / route
        # instant / routing-attempt counter, driving the
        # router.{enqueue,wait,reoffer,answer} spans and the per-hop
        # ids stamped on forwarded request lines
        self._t_wait0: Dict[str, float] = {}
        self._t_route: Dict[str, float] = {}
        self._attempt: Dict[str, int] = {}
        self._outstanding: Dict[str, set] = {r.name: set() for r in replicas}
        # replica supervision state
        self._rep: Dict[str, Dict[str, Any]] = {
            r.name: {
                "handle": r,
                "up": False,        # process believed running
                "down": False,      # permanently out (budget exhausted)
                "stopping": False,  # drain-initiated, exit expected
                "restarts": 0,
                "free_restarts": 0,
                "next_restart_at": None,   # monotonic due time, or None
                "started_at": now,
                "stale_since": None,
                "health": None,
                "health_at": 0.0,
            }
            for r in replicas
        }
        self._eof = False
        self._draining = False
        self._drain_req = cc.Event()
        self._failed = False
        self._done_running = False  # run() exited: late submits self-emit
        # hedging state — all under self._lock: rid -> hedge-target
        # replica (at most one live hedge per request) and the
        # streaming answer-latency quantile the adaptive delay tracks
        self._hedged: Dict[str, str] = {}
        self._lat_p99 = 0.0
        self._lat_scale = 0.0
        # counters mirrored into telemetry + `paddle serve-status`
        self.routed = 0
        self.reoffers = 0
        self.duplicate_answers = 0
        self.deaths = 0
        self.hedges = 0
        self.hedge_wins = 0

    # ---------------------------------------------------- client side

    def start(self) -> "FleetRouter":
        for st in self._rep.values():
            st["handle"].start()
            with self._lock:
                st["up"] = True
                st["started_at"] = self._clock()
        return self

    def submit(self, doc: Dict[str, Any]) -> bool:
        """Admit one request. False = duplicate id (the fleet front
        door dedupes, mirroring the journal-backed single server)."""
        rid = str(doc.get("id"))
        with self._lock:
            if rid in self._docs:
                return False
            # the router is the trace origin: stamp (or echo verbatim)
            # the opaque join key BEFORE the doc is stored, so routing,
            # failover re-offers and the replicas' journals all carry
            # the same trace_id (doc/observability.md)
            doc["trace_id"] = str(doc.get("trace_id") or rid)
            self._docs[rid] = doc
            self._order.append(rid)
            if self._draining or self._done_running:
                # drain semantics fleet-wide: in-flight finish, NEW
                # arrivals reject — same answer a draining engine gives
                self._results[rid] = {"id": rid, "outcome": "rejected",
                                      "tokens": []}
                if self._done_running:
                    # the run loop (the one ordered emitter) already
                    # exited — a late arrival off the stdin reader must
                    # still hear its rejection; emitting here is safe
                    # because the loop can never emit again and the
                    # lock serializes order
                    self._emit_ready_locked()
            else:
                now = self._clock()
                self._t_wait0[rid] = now
                self._span("router.enqueue", now, 0.0,
                           trace=doc["trace_id"], rid=rid)
                self._unsent.append(rid)
            self._wake.notify_all()
        return True

    def deliver(self, name: str, doc: Dict[str, Any]) -> None:
        """One replica answered. First answer wins; replays of the same
        id (at-least-once journal semantics) are counted, not emitted."""
        rid = str(doc.get("id"))
        with self._lock:
            out = self._outstanding.get(name)
            if out is not None:
                out.discard(rid)
            if rid not in self._docs:
                return  # not ours (child noise) — never crash the router
            if rid in self._results:
                self.duplicate_answers += 1
                return
            t_route = self._t_route.get(rid)
            if t_route is not None:
                # feed the adaptive hedge delay with the winning
                # answer's route->answer latency
                self._note_latency_locked(self._clock() - t_route)
            if self._hedged.get(rid) == name:
                self.hedge_wins += 1
            self._hedged.pop(rid, None)
            self._results[rid] = doc
            self._span("router.answer", self._clock(), 0.0,
                       trace=str(self._docs[rid].get("trace_id") or rid),
                       rid=rid, replica=name)
            self._t_wait0.pop(rid, None)
            self._t_route.pop(rid, None)
            self._wake.notify_all()

    def note_eof(self) -> None:
        with self._lock:
            self._eof = True
            self._wake.notify_all()

    def request_drain(self) -> None:
        """Signal-safe drain request: just set the event — the run loop
        executes the drain (taking locks from a signal handler that
        interrupted the loop mid-critical-section would deadlock)."""
        self._drain_req.set()

    def status(self) -> Dict[str, Any]:
        """Router-level counters + per-replica supervision view (the
        fleet analog of Engine.status())."""
        with self._lock:
            return {
                "replicas": {
                    name: {
                        "up": st["up"], "down": st["down"],
                        "stopping": st["stopping"],
                        "restarts": st["restarts"],
                        "outstanding": len(self._outstanding.get(name, ())),
                    }
                    for name, st in self._rep.items()
                },
                "draining": self._draining,
                "queue_depth": len(self._unsent),
                "submitted": len(self._order),
                "emitted": self._emit_idx,
                "routed": self.routed,
                "reoffers": self.reoffers,
                "duplicate_answers": self.duplicate_answers,
                "deaths": self.deaths,
                "hedges": self.hedges,
                "hedge_wins": self.hedge_wins,
            }

    def _span(self, name: str, t0_mono: float, dur_s: float,
              **fields: Any) -> None:
        """One router-side ``kind=span`` hop record (doc/observability.
        md "Distributed tracing"). ``t0_mono`` is a ``self._clock``
        reading, mapped into the router stream's ``t``-offset timebase;
        a no-op when telemetry is off, so library/race harness use
        emits nothing."""
        from paddle_tpu_torch.observability import metrics as obsm

        if not obsm.enabled():
            return
        obsm.emit("span", name=name, t0=obsm.rel_time(t0_mono),
                  dur_s=round(max(float(dur_s), 0.0), 6), **fields)

    # ------------------------------------------------------ scheduling

    def run(self) -> int:
        """The router loop (PTL002 hot loop): supervise, route, emit —
        until the batch (EOF) or drain completes. Returns the process
        exit code (1 = the fleet failed its requests: every replica
        permanently down with work unanswered)."""
        while True:
            self._route_once()
            with self._lock:
                if self._finished_locked():
                    # flag flips in the SAME critical section as the
                    # exit decision: a concurrent submit either lands
                    # before (the loop still emits it) or after (it
                    # self-emits) — never in a gap
                    self._done_running = True
                    break
                self._wake.wait(timeout=self.poll_s)
        with self._lock:
            return 1 if self._failed else 0

    def _route_once(self) -> None:
        now = self._clock()
        if self._drain_req.is_set():
            self._begin_drain()
        self._chaos_poll()
        self._reap(now)
        self._refresh_health(now)
        self._due_restarts(now)
        self._route_pending(now)
        self._hedge_pending(now)
        with self._lock:
            self._fail_if_abandoned_locked()
            self._emit_ready_locked()

    def _chaos_poll(self) -> None:
        # chaos: hard-kill replica K mid-fleet (raise:K) — the journal
        # re-offer / failover drill (doc/resilience.md)
        try:
            faultinject.fault_point("fleet.replica_crash")
        except faultinject.FaultInjected as e:
            names = sorted(self._rep)
            try:
                idx = int(e.arg or 0)
            except ValueError:
                idx = 0
            name = names[idx % len(names)]
            logger.warning("fleet chaos: hard-killing %s (%s)", name, e)
            self._rep[name]["handle"].kill()

    def _reap(self, now: float) -> None:
        for name, st in self._rep.items():
            with self._lock:
                up = st["up"]
            if not up:
                continue
            rc = st["handle"].poll_exit()
            if rc is not None:
                self._on_death(name, rc, now)

    def _refresh_health(self, now: float) -> None:
        for name, st in self._rep.items():
            with self._lock:
                if not st["up"] or now - st["health_at"] < self.health_period_s:
                    continue
            try:
                # chaos: this replica's status probe reads as stale —
                # the router must route around it, and kill it only
                # past the persistence bound
                faultinject.fault_point("fleet.status_stale", info=name)
                h = st["handle"].health(now)
            except faultinject.FaultInjected as e:
                h = {"stale": True, "detail": f"injected: {e}"}
            except Exception as e:  # a broken probe is a health verdict
                h = {"stale": True, "detail": f"probe failed: {e}"}
            kill = False
            with self._lock:
                st["health"] = h
                st["health_at"] = now
                if not h.get("stale"):
                    st["stale_since"] = None
                elif now - st["started_at"] > self.startup_grace_s:
                    if st["stale_since"] is None:
                        st["stale_since"] = now
                    elif now - st["stale_since"] > self.stale_after_s:
                        kill = True
            if kill:
                logger.warning(
                    "fleet: %s health stale beyond %.1fs (%s) — killing "
                    "and treating as a death", name, self.stale_after_s,
                    h.get("detail", ""))
                st["handle"].kill()
                if st["handle"].join(timeout=5.0):
                    self._on_death(name, st["handle"].poll_exit() or 1, now)

    def _on_death(self, name: str, rc: int, now: float) -> None:
        st = self._rep[name]
        handle = st["handle"]
        with self._lock:
            st["up"] = False
            st["stale_since"] = None
            st["health"] = None
            stopping = st["stopping"] or self._draining
            self.deaths += 1
        # the journal is the durable truth of what the dead replica
        # still owed; the router's outstanding set covers requests the
        # child may not have journaled yet (accepted at the router,
        # lost in its stdin pipe)
        try:
            journal_pending = handle.pending_requests()
        except Exception:
            journal_pending = []
        with self._lock:
            owed = {str(d.get("id")) for d in journal_pending}
            owed |= self._outstanding.get(name, set())
            orphans = [rid for rid in self._order
                       if rid in owed and rid not in self._results]
            self._outstanding[name] = set()
            if stopping:
                # drain path: the child answered what it could before
                # exiting; whatever is left gets an honest error — the
                # survivors are draining too, a re-offer would only be
                # rejected later
                for rid in orphans:
                    self._results[rid] = {
                        "id": rid, "outcome": "error", "tokens": [],
                        "error": f"replica {name} exited {rc} during drain",
                    }
                st["next_restart_at"] = None
                self._wake.notify_all()
                return
            for rid in reversed(orphans):
                self._owner.pop(rid, None)
                if self._hedged.get(rid) == name:
                    # the hedge target died: the request may hedge again
                    self._hedged.pop(rid, None)
                self._unsent.appendleft(rid)
            for rid in orphans:
                # routed-but-lost: [route → death detected] — failover's
                # DISTINCT share in the tail-latency attribution table
                t_route = self._t_route.pop(rid, now)
                self._span(
                    "router.reoffer", t_route, now - t_route,
                    trace=str(self._docs[rid].get("trace_id") or rid),
                    rid=rid, replica=name,
                    attempt=self._attempt.get(rid, 1))
                # the next router.wait measures from the re-offer, not
                # the original front-door enqueue (no double-count)
                self._t_wait0[rid] = now
            self.reoffers += len(orphans)
            # exit-code discipline (resilience/supervisor.py): 18 =
            # preemption, budget-free up to the storm limit; everything
            # else (17/19/20 and plain crashes) consumes the budget
            if rc == EXIT_PREEMPTED and st["free_restarts"] < FREE_RESTART_LIMIT:
                st["free_restarts"] += 1
                delay = 0.0
            elif st["restarts"] < self.restart_budget:
                st["restarts"] += 1
                delay = min(
                    self.restart_base_delay * (2 ** (st["restarts"] - 1)),
                    RESTART_DELAY_CAP_S,
                )
            else:
                st["down"] = True
                st["next_restart_at"] = None
                logger.error(
                    "fleet: %s exit %d — restart budget (%d) exhausted, "
                    "replica permanently down", name, rc,
                    self.restart_budget)
                self._wake.notify_all()
                return
            st["next_restart_at"] = now + delay
            self._wake.notify_all()
        logger.warning(
            "fleet: %s exit %d — re-offering %d unanswered request(s) to "
            "survivors, restart in %.1fs", name, rc, len(orphans), delay)

    def _due_restarts(self, now: float) -> None:
        for name, st in self._rep.items():
            with self._lock:
                due = (not st["up"] and not st["down"] and not st["stopping"]
                       and not self._draining
                       and st["next_restart_at"] is not None
                       and now >= st["next_restart_at"])
                if due:
                    st["next_restart_at"] = None
            if due:
                st["handle"].start()
                with self._lock:
                    st["up"] = True
                    st["started_at"] = self._clock()
                    st["health"] = None
                    st["stale_since"] = None
                logger.info("fleet: %s restarted (budgeted %d/%d, free %d) "
                            "— rejoining rotation", name, st["restarts"],
                            self.restart_budget, st["free_restarts"])

    def _candidates(self) -> List[tuple]:
        """(score, name, handle) for every routable replica — caller
        holds the lock."""
        out = []
        for name, st in sorted(self._rep.items()):
            if not st["up"] or st["down"] or st["stopping"]:
                continue
            h = st["health"]
            if h is not None and not h.get("stale"):
                if h.get("draining") or h.get("breaker") == "open":
                    continue
            elif h is not None and h.get("stale"):
                # stale health: routable only during the startup grace
                # (no snapshot exists yet); a formerly-healthy replica
                # gone stale is suspect — route around it
                if st["stale_since"] is not None:
                    continue
            out.append((replica_score(len(self._outstanding[name]), h),
                        name, st["handle"]))
        return sorted(out, key=lambda t: (t[0], t[1]))

    def _route_pending(self, now: float) -> None:
        while True:
            with self._lock:
                if not self._unsent:
                    return
                rid = self._unsent[0]
                if rid in self._results:      # answered while queued
                    self._unsent.popleft()    # (re-offer raced a replay)
                    continue
                cands = self._candidates()
                if not cands:
                    return  # nobody routable — requests wait; a restart
                    # or health recovery re-enters here next poll
                _score, name, handle = cands[0]
                self._unsent.popleft()
                doc = self._docs[rid]
                attempt = self._attempt.get(rid, 0) + 1
                self._attempt[rid] = attempt
                trace = str(doc.get("trace_id") or rid)
                # per-hop ids ride the forwarded line (opaque to the
                # replica, echoed onto its journal): the parent is the
                # front-door enqueue, one child hop per routing attempt
                doc["trace_id"] = trace
                doc["span_id"] = f"{trace}:send:{attempt}"
                doc["parent_id"] = f"{trace}:enqueue"
            # the pipe write runs OUTSIDE the lock: a full pipe to a
            # busy child must not block submit/deliver
            if handle.send(doc):
                with self._lock:
                    self._owner[rid] = name
                    self._outstanding[name].add(rid)
                    self.routed += 1
                    t_route = self._clock()
                    t0 = self._t_wait0.get(rid, t_route)
                    self._t_route[rid] = t_route
                    self._span("router.wait", t0, t_route - t0,
                               trace=trace, rid=rid, replica=name,
                               attempt=attempt)
            else:
                # send failed: the child is dying — requeue and let the
                # reaper classify the death (its journal never saw this
                # request, so the requeue IS its re-offer)
                with self._lock:
                    self._unsent.appendleft(rid)
                return

    def _note_latency_locked(self, lat: float) -> None:
        """Streaming p99 of route->answer latency (stochastic quantile
        estimate — no sample buffer): each observation nudges the
        estimate up by 0.99 steps or down by 0.01 steps, with the step
        scaled to the latency magnitude EMA. Caller holds the lock."""
        lat = max(float(lat), 0.0)
        self._lat_scale += (lat - self._lat_scale) * 0.05
        step = max(self._lat_scale, 1e-4) * 0.05
        if lat > self._lat_p99:
            self._lat_p99 += step * 0.99
        else:
            self._lat_p99 = max(self._lat_p99 - step * 0.01, 0.0)

    def _hedge_pending(self, now: float) -> None:
        """Hedged retries: a request outstanding on its owner past the
        adaptive hedge delay is re-sent (once) to the next-healthiest
        replica. First answer wins in :meth:`deliver`; the loser lands
        in ``duplicate_answers``. The hedge send rides the SAME doc, so
        a wire-stamped ``deadline_unix`` carries the shrunken budget."""
        if self.hedge_after <= 0:
            return
        sends = []
        with self._lock:
            if self._draining:
                return
            delay = max(self.hedge_after, self._lat_p99)
            for rid, t_route in list(self._t_route.items()):
                if now - t_route < delay:
                    continue
                if rid in self._results or rid in self._hedged:
                    continue
                owner = self._owner.get(rid)
                cands = [c for c in self._candidates() if c[1] != owner]
                if not cands:
                    continue
                _score, name, handle = cands[0]
                doc = self._docs[rid]
                attempt = self._attempt.get(rid, 1) + 1
                self._attempt[rid] = attempt
                trace = str(doc.get("trace_id") or rid)
                doc["span_id"] = f"{trace}:send:{attempt}"
                self._hedged[rid] = name
                sends.append((rid, name, handle, doc, t_route, trace,
                              attempt))
        # sends run OUTSIDE the lock, like _route_pending's
        for rid, name, handle, doc, t_route, trace, attempt in sends:
            if handle.send(doc):
                with self._lock:
                    self._outstanding[name].add(rid)
                    self.hedges += 1
                    # [route -> hedge fired]: the tail the hedge is
                    # trying to cut, attributed as its own bucket in
                    # the trace tail table (doc/observability.md)
                    self._span("net.hedge", t_route, now - t_route,
                               trace=trace, rid=rid, replica=name,
                               attempt=attempt)
            else:
                with self._lock:
                    if self._hedged.get(rid) == name:
                        del self._hedged[rid]

    def _fail_if_abandoned_locked(self) -> None:
        if self._draining or self._failed:
            return
        if any(not st["down"] for st in self._rep.values()):
            return
        # every replica permanently down: no capacity will ever return.
        # Answer everything unanswered honestly instead of hanging the
        # client forever.
        unanswered = [rid for rid in self._order if rid not in self._results]
        if not unanswered:
            return
        self._failed = True
        for rid in unanswered:
            self._results[rid] = {
                "id": rid, "outcome": "error", "tokens": [],
                "error": "fleet failed: every replica is permanently down",
            }
        self._unsent.clear()
        logger.error("fleet: all replicas permanently down — answering %d "
                     "request(s) outcome=error", len(unanswered))

    def _emit_ready_locked(self) -> None:
        while self._emit_idx < len(self._order):
            res = self._results.get(self._order[self._emit_idx])
            if res is None:
                break
            self._emit_idx += 1
            self._emit(res)

    # --------------------------------------------------------- drain

    def _begin_drain(self) -> None:
        with self._lock:
            if self._draining:
                return
            self._draining = True
            # structural rejection for everything not yet routed — the
            # same answer a draining engine's queue gets
            while self._unsent:
                rid = self._unsent.popleft()
                if rid not in self._results:
                    self._results[rid] = {"id": rid, "outcome": "rejected",
                                          "tokens": []}
            for st in self._rep.values():
                if st["up"]:
                    st["stopping"] = True
                st["next_restart_at"] = None
            self._wake.notify_all()
        logger.info("fleet: draining — in-flight work completes, queued "
                    "and new requests reject")
        for st in self._rep.values():
            if st["stopping"]:
                st["handle"].begin_drain()

    def _finished_locked(self) -> bool:
        if self._emit_idx < len(self._order):
            return False
        if self._draining:
            # every answer emitted; done once every child exited
            return all(not st["up"] for st in self._rep.values())
        # plain EOF is a batch: everything submitted must be answered
        # (failover and restarts run for as long as that takes)
        return self._eof and not self._unsent

    def shutdown(self, timeout: float = 30.0) -> None:
        """Post-run cleanup: drain and reap any children still up (the
        EOF-batch path gets here with all requests answered)."""
        for st in self._rep.values():
            if st["handle"].alive():
                st["handle"].begin_drain()
        deadline = self._clock() + timeout
        for st in self._rep.values():
            left = max(deadline - self._clock(), 0.1)
            if not st["handle"].join(timeout=left):
                st["handle"].kill()
                st["handle"].join(timeout=5.0)
            with self._lock:
                st["up"] = False


# ------------------------------------------------- in-process fleet

def drive_fleet_rung(engines, requests, *, rate_rps: float, rung: int = 0,
                     result_timeout_s: float = 300.0,
                     clients=None) -> Dict[str, Any]:
    """Open-loop driver for one offered-load rung across N in-process
    engines (``bench.py serve --replicas=N``): each arrival routes to
    the least-loaded replica under the SAME :func:`replica_score`
    policy the subprocess router uses, so the bench measures the real
    routing discipline. Emits each engine's per-replica window (its
    RequestLog carries ``replica=i``), then a MERGED ``serve_window``
    stamped ``replicas=N`` — the record `paddle compare` joins the
    scaling curve on. The merge is conservative: counts/goodput sum,
    p99s take the worst replica, p50s/means average weighted by
    completions.

    ``clients`` (optional) is a parallel list of
    :class:`~paddle_tpu_torch.serving.transport.SocketEngineClient` — the
    bench's ``transport=tcp`` mode: scoring still reads each engine's
    in-process status, but the submit and the answer take the real
    framed-socket path, so serialization + syscall cost lands in the
    measured ``router_share`` and the merged window is stamped
    ``transport=tcp`` instead of ``pipe``."""
    for e in engines:
        e.begin_window()
    t0 = cc.monotonic()
    futures = []
    outstanding = [0] * len(engines)
    router_s = 0.0
    for req in requests:
        delay = req.t_enqueue - (cc.monotonic() - t0)
        if delay > 0:
            cc.sleep(delay)
        r0 = cc.perf_counter()
        scores = []
        for i, e in enumerate(engines):
            # status() is bounded-lock: a busy scheduler yields a stale
            # doc, and the outstanding count carries the decision
            scores.append((replica_score(outstanding[i], e.status()), i))
        i = min(scores)[1]
        if clients is not None:
            # the framed-socket hop is part of the routing cost being
            # measured — keep it inside the router_s stopwatch
            fut = clients[i].submit({"id": req.rid,
                                     "prompt": req.prompt or [],
                                     "max_new_tokens": req.max_new})
        else:
            fut = engines[i].submit(req.prompt or [],
                                    max_new_tokens=req.max_new,
                                    rid=req.rid)
        router_s += cc.perf_counter() - r0
        outstanding[i] += 1

        def _dec(i=i):
            outstanding[i] -= 1

        futures.append((fut, _dec))
    for fut, dec in futures:
        fut.result(timeout=result_timeout_s)
        dec()
    elapsed = cc.monotonic() - t0
    window_s = max(elapsed, requests[-1].t_enqueue if requests else 0.0)
    per = [e.window_roll(offered_rps=rate_rps, rung=rung, window_s=window_s)
           for e in engines]
    return merge_windows(per, rate_rps=rate_rps, rung=rung,
                         window_s=window_s, router_s=router_s,
                         transport="tcp" if clients is not None else "pipe")


def merge_windows(per: List[Dict[str, Any]], *, rate_rps: float, rung: int,
                  window_s: float, router_s: float = 0.0,
                  transport: str = "") -> Dict[str, Any]:
    """Fold N per-replica ``serve_window`` records into one fleet
    window (``replicas=N``). Sums for counts and token totals; for the
    latency histograms the merged p99 is the WORST replica's (tail
    honesty) and the p50/mean are completion-weighted averages — a
    cross-replica histogram merge without the samples is necessarily
    approximate, and this direction never understates the tail.
    ``transport`` (pipe|tcp) is stamped when known, so `paddle
    compare` can qualify and judge the A/B."""
    from paddle_tpu_torch.observability import metrics as obs

    n = len(per)
    rec: Dict[str, Any] = {
        "rung": int(rung), "engine": per[0].get("engine", "continuous"),
        "offered_rps": round(float(rate_rps), 6),
        "window_s": round(float(window_s), 6),
        "replicas": n,
    }
    if isinstance(per[0].get("pipeline"), str):
        rec["pipeline"] = per[0]["pipeline"]
    if transport:
        # pipe|tcp — `paddle compare` joins scaling curves on it so
        # transport overhead is measured, not assumed
        rec["transport"] = transport
    for key in ("arrived", "admitted", "completed", "rejected", "timeouts",
                "cancelled", "errors", "shed", "breaker_open", "launches",
                "gen_tokens"):
        rec[key] = sum(int(w.get(key) or 0) for w in per)
    rec["exec_s"] = round(sum(float(w.get("exec_s") or 0.0) for w in per), 6)
    rec["goodput_tok_s"] = round(rec["gen_tokens"] / max(window_s, 1e-9), 3)
    rec["completed_rps"] = round(rec["completed"] / max(window_s, 1e-9), 6)
    if router_s:
        rec["router_share"] = round(router_s / max(window_s, 1e-9), 4)
    weights = [max(int(w.get("completed") or 0), 0) for w in per]
    wsum = sum(weights) or 1

    def _merged_snap(key: str) -> Dict[str, float]:
        snaps = [w.get(key) or {} for w in per]
        count = sum(int(s.get("count") or 0) for s in snaps)
        if key in ("queue_depth", "occupancy"):
            # gauges are TIME-sampled, not per-completion: weighting by
            # completions silently drops a zero-completion replica from
            # the mean even though it held slots/queue all window, so
            # occupancy reads high under imbalance. Weight by each
            # snap's sample count instead (1 when unknown) — an idle
            # replica contributes its honest zero.
            wts = [max(int(s.get("count") or 0), 1) for s in snaps]
        else:
            wts = weights
        wts_sum = sum(wts) or 1
        return {
            "count": count,
            "mean": round(sum(float(s.get("mean") or 0.0) * wt
                              for s, wt in zip(snaps, wts)) / wts_sum, 6),
            "p50": round(sum(float(s.get("p50") or 0.0) * wt
                             for s, wt in zip(snaps, wts)) / wts_sum, 6),
            "p99": round(max((float(s.get("p99") or 0.0) for s in snaps),
                             default=0.0), 6),
            "max": round(max((float(s.get("max") or 0.0) for s in snaps),
                             default=0.0), 6),
        }

    for key in ("latency", "ttft", "queue_wait", "queue_depth", "occupancy"):
        rec[key] = _merged_snap(key)
    shares = [w.get("queue_wait_share") for w in per]
    if any(isinstance(s, (int, float)) for s in shares):
        rec["queue_wait_share"] = round(
            sum(float(s or 0.0) * wt for s, wt in zip(shares, weights))
            / wsum, 4)
    obs.emit("serve_window", **rec)
    return rec


# ------------------------------------------------------------ process

def _child_argv(rest: List[str], status_dir: str, i: int) -> List[str]:
    """Replica i's ``paddle serve`` argv: the router's args minus the
    fleet/router-owned flags, plus per-replica status/journal/metrics
    paths under the fleet status dir."""
    from paddle_tpu_torch.utils.flags import strip_flag

    args = list(rest)
    for name in ("fleet_replicas", "fleet_status_dir", "status_path",
                 "serve_journal_path", "metrics_path", "fault_spec",
                 "fault_seed"):
        args = strip_flag(args, name)
    args += [
        f"--status_path={os.path.join(status_dir, f'replica-{i}.json')}",
        f"--serve_journal_path="
        f"{os.path.join(status_dir, f'replica-{i}.journal.jsonl')}",
        f"--metrics_path={os.path.join(status_dir, f'replica-{i}')}",
    ]
    return [sys.executable, "-m", "paddle_tpu_torch.cli", "serve"] + args


def _child_env(i: int) -> Dict[str, str]:
    """Replica i's environment: the fleet-level fault plan must not
    fire identically in every child, so PADDLE_TPU_FAULTS is stripped
    and the per-replica CHILD_FAULTS env re-injects a child-scoped spec
    (chaos drills that kill exactly one replica)."""
    env = dict(os.environ)
    env.pop("PADDLE_TPU_FAULTS", None)
    child_spec = os.environ.get(f"{CHILD_FAULTS_ENV}{i}", "")
    if child_spec:
        env["PADDLE_TPU_FAULTS"] = child_spec
    return env


def main(rest: List[str]) -> int:
    """``paddle serve-fleet`` — jax-free, like the supervisor: the
    router process never imports jax; the replicas own the device."""
    from paddle_tpu_torch.observability import metrics as obsm
    from paddle_tpu_torch.serving.frontend import _parse_line
    from paddle_tpu_torch.utils.flags import FLAGS, flag_values

    # repeatable: --replica_addr h1:9000 --replica_addr h2:9000 (or one
    # comma list) — collected BEFORE FLAGS.parse keeps only the last
    addrs = flag_values(list(rest), "replica_addr")
    leftover = FLAGS.parse(list(rest))
    if leftover:
        print(f"warning: unrecognized flags {leftover}", file=sys.stderr)
    if not addrs and not FLAGS.config:
        print("error: --config is required", file=sys.stderr)
        return 2
    n = len(addrs) if addrs else max(1, FLAGS.fleet_replicas)
    status_dir = FLAGS.fleet_status_dir or os.path.join(
        FLAGS.save_dir or "output", "fleet_status")
    os.makedirs(status_dir, exist_ok=True)
    obsm.configure_from_flags(FLAGS)
    if FLAGS.fault_spec:
        # the fleet.* (and, socket mode, net.*) chaos sites fire in
        # THIS process; serve.* specs for pipe children ride the
        # per-replica CHILD_FAULTS env
        faultinject.configure(FLAGS.fault_spec, FLAGS.fault_seed)

    def emit(doc: Dict[str, Any]) -> None:
        print(json.dumps(doc), flush=True)

    if addrs:
        # cross-host fleet (doc/serving.md "Cross-host fleet"): each
        # address is a running `paddle serve --listen` replica; the
        # shared --io_retry_* policy drives reconnect backoff, and a
        # retry-budget-exhausted transport surfaces as a death (the
        # restart budget then governs fresh connection attempts)
        from paddle_tpu_torch.serving.transport import SocketReplica
        from paddle_tpu_torch.utils.retry import RetryPolicy

        replicas = [
            SocketReplica(
                f"replica-{i}", addr,
                deliver=lambda name, doc: router.deliver(name, doc),
                timeout_s=FLAGS.serve_request_timeout,
                policy=RetryPolicy.from_flags(
                    FLAGS, retry_on=(OSError,), name="net.connect"),
            )
            for i, addr in enumerate(addrs)
        ]
    else:
        replicas = [
            ProcReplica(
                f"replica-{i}", _child_argv(rest, status_dir, i),
                status_path=os.path.join(status_dir, f"replica-{i}.json"),
                journal_path=os.path.join(
                    status_dir, f"replica-{i}.journal.jsonl"),
                deliver=lambda name, doc: router.deliver(name, doc),
                env=_child_env(i),
            )
            for i in range(n)
        ]
    router = FleetRouter(
        replicas,
        emit=emit,
        restart_budget=FLAGS.restart_budget,
        restart_base_delay=FLAGS.restart_base_delay,
        hedge_after=FLAGS.hedge_after,
    )
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: router.request_drain())
    router.start()
    where = (f"replica addr(s) {', '.join(addrs)}" if addrs
             else f"status dir {status_dir}")
    print(f"# paddle serve-fleet: {n} replica(s), {where} "
          "— reading JSONL requests from stdin", file=sys.stderr)

    def _reader() -> None:
        ln = 0
        for line in sys.stdin:
            line = line.strip()
            if not line:
                continue
            doc, err, rid = _parse_line(line, ln)
            ln += 1
            if doc is None:
                emit({"id": rid, "outcome": "error", "tokens": [],
                      "error": err})
            elif not router.submit(doc):
                print(f"# paddle serve-fleet: duplicate request id "
                      f"{doc['id']!r} skipped", file=sys.stderr)
        router.note_eof()

    reader = cc.Thread(target=_reader, name="fleet-stdin", daemon=True)
    reader.start()

    rc = router.run()
    router.shutdown()
    if obsm.enabled():
        st = router.status()
        reg = obsm.registry()
        reg.counter("fleet.routed").inc(st["routed"])
        reg.counter("fleet.reoffers").inc(st["reoffers"])
        reg.counter("fleet.duplicate_answers").inc(st["duplicate_answers"])
        reg.counter("fleet.deaths").inc(st["deaths"])
        # net.reconnects is already live in the registry (the transport
        # counts each re-established connection as it happens)
        reg.counter("net.hedges").inc(st["hedges"])
        reg.counter("net.hedge_wins").inc(st["hedge_wins"])
        # run_end is the router stream's LAST record, mirroring the
        # single-process serve contract; it carries the fleet counters
        # snapshot (the trainer's pass_end idiom)
        obsm.emit("run_end", status="completed", counters=reg.snapshot())
        obsm.flush()
    print("# paddle serve-fleet: drained", file=sys.stderr)
    return rc
