"""Serving resilience — the engine-side half of the PR 1–11 hardening
stack, applied to the continuous-batching server (doc/resilience.md
"Serving resilience").

The training tier survives hangs (hangwatch → ``hang_report.json`` +
exit 19), OOMs (pre-mortem → exit 20), crashes (`paddle supervise`),
and overload-shaped data stalls. The serving tier — which iteration-
level scheduling deliberately runs at the device's limit — previously
survived exactly one failure (a single faulted decode launch). This
module supplies the rest, REUSING the existing mechanisms instead of
reinventing them:

- :class:`ServeHangWatch` — ``resilience/hangwatch.py`` subclassed for
  the serve loop: the engine pings it at every collect boundary; a
  wedged ``serve_decode`` launch dumps ``serve_hang_report.json``
  (thread stacks + metrics tail + the in-flight cohort snapshot),
  answers every in-flight request ``outcome=error`` (the
  ``_pre_exit`` hook), and exits ``EXIT_HANG`` (19) — so `paddle
  supervise` sees a *diagnosed* death and clients hear "the server
  hung" instead of waiting out their own timeouts.
- :class:`CircuitBreaker` — N consecutive launch faults open the
  breaker: submits are answered ``outcome=shed`` with a retry-after
  hint for a cooldown instead of burning fresh cohorts against a
  faulting device; a half-open probe cohort closes it again.
- :class:`RequestJournal` — the `paddle serve` front-end's durable
  request log: every accepted request is appended (flush + fsync)
  BEFORE it is submitted to the engine, and marked done after its
  result line is printed. A crash therefore loses a process, not a
  queue: the restarted server re-offers every accepted-but-unanswered
  request. Semantics are **at-least-once** — a crash between printing
  a result and journaling it re-answers that request on restart;
  consumers dedupe by request id (doc/resilience.md).
- :class:`StatusWriter` / :func:`status_main` — ``--status_path``:
  periodic atomic status JSON (queue depth, slot occupancy,
  last-collect age, shed/error totals, draining flag) — the health/
  readiness probe a load balancer needs — and the jax-free
  ``paddle serve-status`` renderer.
- :func:`journal_progress` — the supervisor's jax-free progress probe
  for serve children (the serving analog of ``probe_restorable``):
  answered-request count between deaths distinguishes a crash loop
  from a run that is working its queue down.
- :class:`WeightReloader` — hot weight reload (doc/serving.md "Serving
  fleet"): a daemon thread polls a checkpoint dir with the
  supervisor's durability probe (``probe_restorable`` — manifests
  gate, torn saves never load) and, when a NEWER durable checkpoint
  lands, loads it and stages it via ``Engine.request_reload`` for the
  next iteration boundary. Requests admitted before the swap finish on
  the old weights; nothing is dropped or stranded. The
  ``fleet.reload_torn`` chaos site fires between the durability probe
  and the load — the checkpoint-becomes-durable-mid-swap drill.

Everything here is jax-free and, like the engine, reads clocks only
through the ``utils/concurrency`` seam (PTL001: the one wall-clock
stamp in a hang report comes from the base class in ``resilience/``,
outside the hot path).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Callable, Dict, List, Optional

from paddle_tpu_torch.resilience import faultinject
from paddle_tpu_torch.resilience.hangwatch import HangWatch
from paddle_tpu_torch.utils import concurrency as cc
from paddle_tpu_torch.utils.logging import logger

SERVE_HANG_REPORT = "serve_hang_report.json"

__all__ = [
    "SERVE_HANG_REPORT", "ServeHangWatch", "CircuitBreaker",
    "RequestJournal", "StatusWriter", "WeightReloader", "read_status",
    "journal_progress", "status_main",
]


# ------------------------------------------------------------ hangwatch


class ServeHangWatch(HangWatch):
    """The serve loop's hangwatch: same monitor thread, same backstop
    timer, same exit 19 — the deltas are the report name (a serve hang
    and a train hang in one save_dir must not overwrite each other's
    forensics), the in-flight cohort snapshot in the report, and the
    ``_pre_exit`` answer pass.

    ``attach(engine)`` is called once by ``Engine.start()`` before the
    monitor starts; the engine pings at every collect boundary (and on
    idle polls — an idle server is alive, not hung)."""

    REPORT_NAME = SERVE_HANG_REPORT
    REASON = "serve_hang"

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._engine = None  # set by attach() before start()
        # frontend-registered best-effort hook: after the in-flight
        # cohort is failed, PRINT the resolved answers before the
        # process exits — resolving a future the exiting process never
        # flushes to stdout answers nobody. Runs inside the forensics
        # backstop window, so a wedged stdout still exits 19 in time.
        self.answer_flush: Optional[Callable[[], None]] = None

    def attach(self, engine) -> "ServeHangWatch":
        self._engine = engine
        return self

    def build_report(self, age: float, where) -> Dict[str, Any]:
        report = super().build_report(age, where)
        eng = self._engine
        if eng is not None:
            # captured BEFORE _pre_exit fails the cohort: the report
            # must show what was in flight when the launch wedged
            try:
                report["inflight"] = eng.hang_snapshot()
            except Exception as e:  # forensics never mask the hang
                report["inflight_error"] = str(e)
        return report

    def _pre_exit(self) -> None:
        eng = self._engine
        if eng is None:
            return
        n = eng.hang_fail_all(
            f"serve decode hang: no collect progress for >{self.timeout_s:g}s"
            f" (forensics: {self.REPORT_NAME})"
        )
        logger.error(
            "serve hangwatch: answered %d in-flight/queued request(s) "
            "with outcome=error before exit", n,
        )
        flush = self.answer_flush
        if flush is not None:
            try:  # best-effort: the hang must exit regardless
                flush()
            except Exception:
                pass


# ------------------------------------------------------ circuit breaker


class CircuitBreaker:
    """Launch-failure circuit breaker (closed → open → half-open).

    ``record_fault()`` after every failed launch; ``threshold``
    consecutive faults open the breaker for ``cooldown_s``: submits are
    shed fast (``allow_submit`` False) and no cohorts are launched
    (``allow_launch`` False) — a faulting device burns no more
    requests. Once the cooldown elapses the state reads ``half_open``:
    launches are allowed again, the first success closes the breaker,
    the first fault reopens it (a fresh cooldown). ``clock`` is
    injectable for tests and virtualized under `paddle race`.

    Thread-safety: all methods are called with the engine's lock held
    (submit() and the scheduler loop both serialize on it), so the
    breaker itself carries no lock — documented, and explored by
    tests/race_specs/spec_serve_engine.py."""

    def __init__(self, threshold: int, cooldown_s: float,
                 clock: Optional[Callable[[], float]] = None):
        assert threshold > 0, threshold
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock if clock is not None else cc.monotonic
        self._consecutive = 0
        self._open = False
        self._opened_at = 0.0
        self._probing = False  # half-open probe cohort in flight
        self.opened_total = 0  # lifetime opens (status / telemetry)

    @property
    def state(self) -> str:
        if not self._open:
            return "closed"
        if self._clock() - self._opened_at >= self.cooldown_s:
            return "half_open"
        return "open"

    def allow_launch(self) -> bool:
        """May the scheduler admit + launch a cohort right now? False
        while open-and-cooling; half-open lets ONE cohort probe through
        (its collect resolves the state either way) — the engine marks
        it with :meth:`note_probe`, and further boundaries wait out the
        verdict instead of burning fresh cohorts against a device the
        probe may be about to prove still bad (the pipelined loop runs
        boundaries faster than collects resolve)."""
        st = self.state
        return st != "open" and not (st == "half_open" and self._probing)

    def note_probe(self) -> None:
        """The engine launched a cohort while half-open: latch until
        its collect resolves the state (record_success/record_fault)."""
        if self.state == "half_open":
            self._probing = True

    def allow_submit(self) -> bool:
        """May a new request enter the queue? Open = shed fast; the
        half-open probe window accepts again (those requests wait out
        the probe in the queue like any others)."""
        return self.state != "open"

    def retry_after_s(self) -> float:
        """Cooldown remaining — the shed answer's retry-after hint."""
        if not self._open:
            return 0.0
        return max(self.cooldown_s - (self._clock() - self._opened_at), 0.0)

    def record_fault(self) -> bool:
        """One launch fault. Returns True exactly when this fault
        OPENED (or re-opened) the breaker — the window's
        ``breaker_open`` count."""
        self._consecutive += 1
        was_open = self._open and self.state != "half_open"
        self._probing = False
        if self._consecutive >= self.threshold or self._open:
            self._open = True
            self._opened_at = self._clock()
            if not was_open:
                self.opened_total += 1
                return True
        return False

    def record_success(self) -> None:
        self._consecutive = 0
        self._open = False
        self._probing = False


# -------------------------------------------------------------- journal


def _read_journal(path: str):
    """Parse a journal file read-only → (accepted, done) maps. Shared
    by :class:`RequestJournal` and the supervisor's jax-free
    :func:`journal_progress` probe (which must not open-for-append).
    Tolerates a missing file and a torn tail line (the crash the
    journal exists for tears mid-append)."""
    accepted: Dict[str, Dict[str, Any]] = {}
    done: Dict[str, str] = {}
    try:
        with open(path, encoding="utf-8") as f:
            lines = f.read().splitlines()
    except OSError:
        return accepted, done
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            doc = json.loads(line)
        except ValueError:
            continue  # torn tail (or garbage): skip, never raise
        if not isinstance(doc, dict) or "id" not in doc:
            continue
        rid = str(doc["id"])
        if doc.get("op") == "accept":
            accepted.setdefault(rid, doc)
        elif doc.get("op") == "done":
            done[rid] = str(doc.get("outcome", ""))
    return accepted, done


class RequestJournal:
    """Durable at-least-once request journal (``--serve_journal_path``).

    Append-only JSONL, one op per line::

        {"op": "accept", "id": ..., "prompt": [...], "max_new_tokens": N}
        {"op": "done",   "id": ..., "outcome": "ok"}

    The ``accept`` append is flushed AND fsynced before the request is
    submitted to the engine (crash-ordered before any accept effect),
    so a crash at any later point re-offers the request on restart.
    ``done`` is appended after the result line is printed — a crash in
    between re-answers that request (at-least-once; dedupe by id is
    the consumer's contract, doc/resilience.md "Serving resilience").
    The loader tolerates a torn tail line (the crash the journal
    exists for tears mid-append)."""

    def __init__(self, path: str):
        self.path = path
        self._lock = cc.Lock()
        self.accepted, self.done = _read_journal(path)
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "a", encoding="utf-8")
        # seal a torn tail (a crash mid-append leaves no trailing
        # newline): appending onto the fragment would corrupt the FIRST
        # record this incarnation writes — losing an accept on the next
        # restart, which is the one loss the journal must never allow
        try:
            size = os.path.getsize(path)
            if size:
                with open(path, "rb") as rf:
                    rf.seek(size - 1)
                    if rf.read(1) != b"\n":
                        self._f.write("\n")
                        self._f.flush()
        except OSError:
            pass

    def pending(self) -> List[Dict[str, Any]]:
        """Accepted-but-unanswered requests, in acceptance order —
        what a restarted server re-offers."""
        with self._lock:
            return [dict(doc) for rid, doc in self.accepted.items()
                    if rid not in self.done]

    def is_done(self, rid: str) -> bool:
        with self._lock:
            return str(rid) in self.done

    def is_accepted(self, rid: str) -> bool:
        with self._lock:
            return str(rid) in self.accepted

    def accept(self, doc: Dict[str, Any]) -> bool:
        """Journal one accepted request DURABLY (flush + fsync) before
        the caller submits it. False = this id was already accepted (a
        replayed stdin line after a restart) — the caller must not
        double-submit."""
        rid = str(doc.get("id"))
        with self._lock:
            if rid in self.accepted:
                return False
            rec = {"op": "accept", "id": rid,
                   "prompt": doc.get("prompt"),
                   "max_new_tokens": doc.get("max_new_tokens")}
            if doc.get("trace_id"):
                # a replayed backlog keeps its distributed-tracing join
                # key — the restarted incarnation's spans still stitch
                # into the same cross-process timeline
                rec["trace_id"] = str(doc["trace_id"])
            self.accepted[rid] = rec
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()
            os.fsync(self._f.fileno())
        return True

    def answer(self, rid: str, outcome: str) -> None:
        """Mark one request answered (its result line was printed)."""
        with self._lock:
            self.done[str(rid)] = str(outcome)
            self._f.write(json.dumps(
                {"op": "done", "id": str(rid), "outcome": str(outcome)}
            ) + "\n")
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            try:
                self._f.close()
            except OSError:
                pass


def journal_progress(journal_path: str) -> Optional[str]:
    """The supervisor's progress probe for serve children: a compact
    fingerprint of the journal's ANSWERED set. Two consecutive deaths
    with the SAME fingerprint made no serving progress — the crash-loop
    signal, exactly like ``probe_restorable``'s restored-pass equality
    for trainers. Deliberately blind to the accepted count: a child
    that keeps accepting traffic but answers nothing is the crash loop,
    and a growing accept count must not disguise it as progress. None
    when there is no journal (progress unknowable — every death then
    looks loop-like, which errs toward stopping)."""
    if not journal_path or not os.path.exists(journal_path):
        return None
    try:
        _accepted, done = _read_journal(journal_path)
    except Exception:
        return None
    return f"answered:{len(done)}"


# ------------------------------------------------------------- status


class StatusWriter:
    """``--status_path``: a daemon thread renews an atomic status JSON
    every ``interval_s`` — the liveness/readiness file a load balancer
    (or `paddle serve-status`) polls. The engine's ``status()`` is
    bounded-lock (a wedged scheduler yields a stale-but-honest
    snapshot), and the write is tmp→replace so readers never see a torn
    document. ``stop()`` writes one final snapshot with the draining
    flag set."""

    def __init__(self, path: str, engine, interval_s: float = 1.0):
        self.path = path
        self.interval_s = float(interval_s)
        self._engine = engine
        self._stop = cc.Event()
        self._thread = None

    def write_now(self) -> None:
        try:
            doc = self._engine.status()
        except Exception as e:  # the probe must never kill the server
            doc = {"error": str(e)}
        d = os.path.dirname(self.path)
        try:
            if d:
                os.makedirs(d, exist_ok=True)
            tmp = self.path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(doc, f, indent=2, default=str)
            os.replace(tmp, self.path)
        except OSError as e:
            logger.warning("serve status write failed (%s): %s",
                           self.path, e)

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.write_now()

    def start(self) -> "StatusWriter":
        if self._thread is None:
            self._stop.clear()
            t = cc.Thread(target=self._run, name="serve-status", daemon=True)
            self._thread = t
            t.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=max(self.interval_s * 2, 1.0))
        self.write_now()  # final snapshot carries the draining flag


def read_status(path: str) -> Optional[Dict[str, Any]]:
    """Tolerant ``--status_path`` reader: the document, or ``None`` on
    any missing/torn/non-object file. The fleet router and the fleet
    status view call this per poll — an unreadable probe is a health
    verdict over there, never an exception here."""
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    return doc if isinstance(doc, dict) else None


# ------------------------------------------------------------- reload


class WeightReloader:
    """Hot weight reload: watch a checkpoint dir, stage newer durable
    checkpoints into a live engine (doc/serving.md "Serving fleet").

    The durability probe is the supervisor's ``probe_restorable`` —
    only manifest-verified saves qualify, so a checkpoint still being
    written (or torn by a trainer crash) never loads. The baseline is
    whatever is newest at START: serving begins on the weights it was
    launched with, and only checkpoints landing AFTER that trigger a
    swap. ``loader(path)`` turns a checkpoint path into backend params
    (the front-end passes ``GradientMachine.loadParameters`` + a device
    re-shard); it runs on the watcher thread, off the scheduler — the
    engine only sees the O(1) ``request_reload`` staging.

    Failure posture: a probe or load error logs and keeps the current
    weights serving (a poison checkpoint is skipped permanently, not
    retried in a hot loop); the ``fleet.reload_torn`` chaos site aborts
    the attempt and retries next poll."""

    def __init__(self, watch_dir: str, engine, loader, *,
                 interval_s: float = 2.0, probe=None):
        if probe is None:
            from paddle_tpu_torch.resilience.supervisor import probe_restorable
            probe = probe_restorable
        self.watch_dir = watch_dir
        self.interval_s = float(interval_s)
        self._engine = engine
        self._loader = loader
        self._probe = probe
        self._lock = cc.Lock()
        self._stop = cc.Event()
        self._thread = None
        self.reloads = 0
        try:
            baseline = probe(watch_dir)
        except Exception:
            baseline = None
        self._last = baseline

    def check_once(self) -> bool:
        """One poll: True iff a new checkpoint was staged."""
        try:
            path = self._probe(self.watch_dir)
        except Exception as e:  # probe trouble = no news, not a crash
            logger.warning("weight reload probe failed (%s): %s",
                           self.watch_dir, e)
            return False
        with self._lock:
            if not path or path == self._last:
                return False
        try:
            # chaos: the checkpoint became durable mid-swap — abort this
            # attempt, retry next poll (doc/resilience.md)
            faultinject.fault_point("fleet.reload_torn", info=path)
            params = self._loader(path)
        except faultinject.FaultInjected as e:
            logger.warning("weight reload of %s aborted (%s) — retrying "
                           "next poll", path, e)
            return False
        except Exception as e:  # noqa: BLE001 — poison ckpt: skip, serve on
            logger.error("weight reload of %s failed (%s) — keeping "
                         "current weights, will not retry this one",
                         path, e)
            with self._lock:
                self._last = path
            return False
        self._engine.request_reload(params, tag=path)
        with self._lock:
            self._last = path
            self.reloads += 1
        logger.info("weight reload staged: %s (swap lands at the next "
                    "iteration boundary)", path)
        return True

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.check_once()

    def start(self) -> "WeightReloader":
        if self._thread is None:
            self._stop.clear()
            t = cc.Thread(target=self._run, name="serve-reload",
                          daemon=True)
            self._thread = t
            t.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=max(self.interval_s * 2, 1.0))


def _fleet_status(dirpath: str, as_json: bool) -> int:
    """``paddle serve-status <fleet_status_dir>`` — the aggregate view
    over every replica's status JSON in one directory (the layout
    ``paddle serve-fleet`` maintains). Missing or torn documents render
    as a STALE row, never an error — mid-rewrite snapshots are normal
    under load."""
    try:
        names = sorted(n for n in os.listdir(dirpath)
                       if n.endswith(".json") and not n.endswith(".tmp"))
    except OSError as e:
        print(f"error: cannot list {dirpath!r}: {e}", file=sys.stderr)
        return 1
    docs = {n[:-len(".json")]: read_status(os.path.join(dirpath, n))
            for n in names}
    if as_json:
        print(json.dumps(
            {name: (doc if doc is not None else {"stale": True})
             for name, doc in docs.items()}, indent=2))
        return 0
    if not docs:
        print(f"(no replica status files in {dirpath})")
        return 0
    header = ("replica", "state", "queue", "slots", "breaker",
              "collect age", "ok", "err")
    rows = [header]
    tot_queue = tot_ok = tot_err = tot_occ = tot_slots = up = 0
    for name, doc in docs.items():
        if doc is None or doc.get("stale") or doc.get("error"):
            detail = ("torn/missing" if doc is None
                      else doc.get("detail") or doc.get("error") or "stale")
            rows.append((name, f"STALE ({detail})", "-", "-", "-", "-",
                         "-", "-"))
            continue
        totals = doc.get("totals") or {}
        state = ("draining" if doc.get("draining")
                 else ("up" if doc.get("started") else "starting"))
        if state == "up":
            up += 1
        occ, slots = int(doc.get("occupancy") or 0), int(doc.get("slots") or 0)
        q = int(doc.get("queue_depth") or 0)
        ok, err = int(totals.get("ok") or 0), int(totals.get("error") or 0)
        rows.append((name, state, str(q), f"{occ}/{slots}",
                     str(doc.get("breaker", "disabled")),
                     f"{float(doc.get('last_collect_age_s') or 0.0):.3f}s",
                     str(ok), str(err)))
        tot_queue += q
        tot_ok += ok
        tot_err += err
        tot_occ += occ
        tot_slots += slots
    rows.append(("fleet", f"{up}/{len(docs)} up", str(tot_queue),
                 f"{tot_occ}/{tot_slots}", "-", "-", str(tot_ok),
                 str(tot_err)))
    widths = [max(len(r[i]) for r in rows) for i in range(len(header))]
    for i, r in enumerate(rows):
        print("  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip())
        if i == 0:
            print("  ".join("-" * w for w in widths))
    return 0


def status_main(argv=None) -> int:
    """``paddle serve-status <path>`` — render a ``--status_path``
    snapshot. jax-free: the probe side runs anywhere."""
    p = argparse.ArgumentParser(
        prog="paddle serve-status",
        description="render a `paddle serve --status_path` health "
                    "snapshot (doc/serving.md \"Serving resilience\")",
    )
    p.add_argument("path", help="a --status_path JSON file, or a fleet "
                                "status DIRECTORY (--fleet_status_dir) "
                                "for the aggregate per-replica view")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="print the raw document(s)")
    args = p.parse_args(argv)
    if os.path.isdir(args.path):
        return _fleet_status(args.path, args.as_json)
    try:
        with open(args.path, encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        print(f"error: cannot read status file {args.path!r}: {e}",
              file=sys.stderr)
        return 1
    if args.as_json:
        print(json.dumps(doc, indent=2))
        return 0
    if doc.get("error"):
        # StatusWriter's probe-failed document: the snapshot itself
        # could not be taken — surface it, don't render a blank table
        print(f"! status probe error: {doc['error']}")
        return 1
    if doc.get("stale"):
        # the engine's bounded-lock timeout: the scheduler was busy or
        # wedged when this snapshot was taken — say so LOUDLY; the
        # normal keys are absent and 'not started' would be a lie
        print("! STALE snapshot: "
              f"{doc.get('detail', 'engine lock unavailable')}")
        return 0
    totals = doc.get("totals") or {}
    rows = [
        ("serving", "draining" if doc.get("draining")
         else ("up" if doc.get("started") else "not started")),
        ("queue depth", doc.get("queue_depth")),
        ("slots", f"{doc.get('occupancy')}/{doc.get('slots')} occupied"),
        ("in-flight launches", doc.get("inflight")),
        ("last collect age", f"{doc.get('last_collect_age_s', 0.0):.3f}s"),
        ("loop age", f"{doc.get('loop_age_s', 0.0):.3f}s"),
        ("breaker", doc.get("breaker", "disabled")),
        ("brownout", "engaged" if doc.get("brownout") else "off"),
        ("shed policy", doc.get("shed_policy", "off")),
        ("pipeline", doc.get("pipeline")),
        ("completed", totals.get("ok", 0)),
        ("shed", totals.get("shed", 0)),
        ("errors", totals.get("error", 0)),
        ("rejected", totals.get("rejected", 0)),
        ("timeouts", totals.get("timeout", 0)),
        ("cancelled", totals.get("cancelled", 0)),
    ]
    width = max(len(k) for k, _v in rows)
    for k, v in rows:
        print(f"{k:<{width}}  {v}")
    return 0


if __name__ == "__main__":
    sys.exit(status_main())
