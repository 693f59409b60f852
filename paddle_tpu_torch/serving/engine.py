"""The continuous-batching scheduler — slot admission/eviction at every
iteration boundary, with the device/host pipeline kept full.

Run-to-completion batching (the PR-8 static driver, and every
``SequenceGenerator.generate`` call) holds a whole cohort until its
LONGEST sequence finishes: with mixed output lengths most slots spend
most steps finished-but-occupied. Orca (OSDI '22) showed iteration-level
scheduling — re-batching between decode steps — recovers that capacity.
This engine is that loop:

    while serving:
        evict   — finished (EOS / budget / max_length), cancelled, or
                  wall-deadline-expired slots free at the boundary
        admit   — queued requests (strict FIFO) prefill into free slots
        step    — ONE jitted launch advances every slot

The PR-12 loop ran those phases strictly serially: every decode launch
was followed by a blocking readback, and every admission blocked on the
prefill — so the device idled during host scheduling and the host idled
during every launch. The **pipelined** loop (default) splits the
backend step into ``dispatch()`` (enqueue launch N+1; the backend
starts ``copy_to_host_async`` on launch N's outputs before the first
collect — the PR-5 snapshot discipline) and ``collect()`` (gather N's
results), and schedules/evicts/admits on iteration N's results WHILE
the device runs N+1. Consequences, all deliberate:

- admissions decided from launch N's results prefill between launches
  N+1 and N+2 — a one-iteration admission lag (doc/serving.md
  "Pipelined decode");
- each in-flight launch carries a SNAPSHOT of its slot cohort; collect
  applies tokens to that snapshot (a slot evicted mid-flight is simply
  skipped — its device row self-terminates at its bounded budget);
- deadlines, TTFT, and exec attribution are all judged at collect
  boundaries — the only place results exist under overlap;
- a faulted in-flight launch surfaces at collect: it errors its cohort
  (and every other in-flight request), the device state resets, and the
  engine keeps serving — exactly the blocking loop's fault contract.

``pipeline=False`` keeps the PR-12 serial loop (the A/B baseline:
``PADDLE_TPU_BENCH_SERVE_PIPELINE=off``). Both loops share the
boundary/admission/apply code and the adaptive decode-block ladder
(:func:`pick_block`), so the pipeline is the ONLY delta in that A/B.

Everything here is jax-free and thread-safe strictly through the
``utils/concurrency`` seam (``cc``): the scheduler runs on one
``cc.Thread``; ``submit``/``cancel``/``drain`` are the only cross-
thread entry points and every shared field is guarded by ``self._lock``
— the ``paddle race`` spec (tests/race_specs/spec_serve_engine.py)
explores exactly these interleavings, pipelined and blocking. Device
work hides behind the backend seam (backend.py): ``FakeBackend`` for
tests, ``JaxDecodeBackend`` for TPUs.

Telemetry is the PR-8 contract unchanged — per-request ``kind=request``
records (REAL wall-clock TTFT: the first token's readback timestamp,
mid-sequence) and ``kind=serve_window`` rollups with
``engine="continuous"`` — plus the overlap plane: ``serve.
dispatch_depth`` (gauge), ``serve.overlap_s`` (counter), and a window
``host_share`` whose exec side is the UNION of dispatch→collect spans,
so overlap shows up as host_share going to ~0 instead of exec_s
double-counting past the wall clock.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from paddle_tpu_torch.observability import serving as slog
from paddle_tpu_torch.resilience import faultinject
from paddle_tpu_torch.utils import concurrency as cc
from paddle_tpu_torch.utils.logging import logger

ENGINE_NAME = "continuous"

# terminal request outcomes (race-spec invariant: every submitted
# request's future resolves exactly once with one of these). `shed` is
# the overload-defense answer (doc/resilience.md "Serving resilience"):
# a POLICY refusal — brownout pressure, open breaker, or an admission
# estimate proving the deadline unmeetable — delivered within one
# collect boundary, with a retry-after hint where one exists; distinct
# from `rejected` (structural: queue cap, draining, not started)
OUTCOMES = ("ok", "rejected", "timeout", "cancelled", "error", "shed")

# valid --serve_shed_policy values: "off" = the PR-13 behavior
# (overload resolves through queue caps and timeouts only); "deadline"
# adds deadline-aware admission shedding; "brownout" additionally caps
# output budgets and sheds new arrivals under sustained queue pressure
SHED_POLICIES = ("off", "deadline", "brownout")

# queue-pressure EMA (queue depth / slots) thresholds for entering and
# leaving brownout — hysteresis, so one bursty boundary can't flap the
# degraded mode on and off
BROWNOUT_ON = 1.0
BROWNOUT_OFF = 0.5

# engaged brownout caps every admission's token budget to this share of
# max_length (floor 1): shorter answers for everyone beats no answers
# for the tail — the "degrade, don't die" half of the shed policy
BROWNOUT_BUDGET_SHARE = 0.25

# the shed retry-after hint while the prefill/step EMAs are still
# unmeasured (a burst before the first collect boundary): a fixed
# conservative backoff, never the idle-poll interval
UNMEASURED_RETRY_S = 1.0

# a launch whose measured host-side cost exceeds this share of its
# device time is dispatch-dominated — the ladder steps up a rung
BLOCK_OVERHEAD_SHARE = 0.5

# EMA smoothing for the ladder's host/device time estimates
_EMA = 0.3

# --- self-speculative decode policy (doc/serving.md "Speculative
# decode"). Acceptance-rate EMAs pick the draft length (the spec
# ladder's rung) the way pick_block picks decode blocks; collapse falls
# back to plain decode with ZERO recompiles (the verify launch's traced
# K bound never changes signature).
SPEC_MIN_SAMPLES = 4    # verify collects before the EMA is trusted
SPEC_EMA_OFF = 0.2      # global EMA below this: plain decode (fallback)
SPEC_EMA_FULL = 0.75    # global EMA at/above this: the top spec rung
SPEC_REQ_OFF = 0.15     # per-request EMA below this: stop proposing
                        # for that slot (it rides launches plain)
SPEC_REPROBE = 64       # plain launches in fallback before the EMAs
                        # reset and the bottom rung probes again — a
                        # workload shift can re-earn its drafts


def pick_spec_k(ladder: Sequence[int], ema: float, samples: int) -> int:
    """The adaptive speculation policy: how many draft tokens to propose
    per slot for the next verify launch — 0 means plain decode. Mirrors
    :func:`pick_block`'s shape: unmeasured probes the bottom rung,
    a collapsed acceptance EMA turns speculation off, and in between the
    EMA interpolates across the pre-warmed ladder."""
    if not ladder:
        return 0
    if samples < SPEC_MIN_SAMPLES:
        return int(ladder[0])
    if ema < SPEC_EMA_OFF:
        return 0
    if ema >= SPEC_EMA_FULL or len(ladder) == 1:
        return int(ladder[-1])
    frac = (ema - SPEC_EMA_OFF) / (SPEC_EMA_FULL - SPEC_EMA_OFF)
    return int(ladder[min(int(frac * len(ladder)), len(ladder) - 1)])


def pick_block(ladder: Sequence[int], cap: int, pressed: bool,
               host_s: float, step_s: float) -> int:
    """The adaptive decode-block policy: how many greedy micro-steps the
    next launch should run (doc/serving.md "The decode-block ladder").

    ``ladder`` — the pre-warmed rungs, ascending; ``cap`` — the smallest
    remaining token budget among live slots (running past it buys only
    frozen micro-steps); ``pressed`` — queue/TTFT pressure: requests are
    waiting to be admitted, or a live slot has not yet delivered its
    first token (both only resolve at a collect boundary, so boundaries
    should come sooner); ``host_s`` — measured host+dispatch seconds per
    iteration (EMA); ``step_s`` — measured device seconds per micro-step
    (EMA).

    Under pressure: the SMALLEST rung whose device time still keeps the
    measured launch overhead under :data:`BLOCK_OVERHEAD_SHARE` — pay
    for boundaries only what they cost. No pressure: the largest rung
    the budget cap allows — boundaries buy nothing, overhead
    amortization is free. With no measurements yet (warmup), pressure
    picks the bottom rung and quiet picks the top."""
    if not ladder:
        return 1
    if len(ladder) == 1:
        return int(ladder[0])
    cands = [u for u in ladder if u <= max(int(cap), int(ladder[0]))]
    if not cands:
        cands = [int(ladder[0])]
    if not pressed:
        return int(cands[-1])
    if host_s > 0 and step_s > 0:
        for u in cands:
            if host_s <= BLOCK_OVERHEAD_SHARE * u * step_s:
                return int(u)
        return int(cands[-1])
    return int(cands[0])


@dataclasses.dataclass
class ServeResult:
    """What a resolved :class:`ResultFuture` carries.

    ``retry_after_s`` rides ``outcome=shed`` answers when the engine
    can estimate when capacity returns (breaker cooldown remaining,
    queue-drain ETA); None means "don't bother retrying" (a deadline
    the admission estimate proved unmeetable)."""

    rid: str
    outcome: str
    tokens: List[int]
    error: Optional[str] = None
    retry_after_s: Optional[float] = None


class ResultFuture:
    """A one-shot, condition-backed result future (``cc`` seam)."""

    def __init__(self) -> None:
        self._cv = cc.Condition()
        self._done = False
        self._result: Optional[ServeResult] = None

    def done(self) -> bool:
        return self._done

    def _resolve(self, result: ServeResult) -> bool:
        """Exactly-once; a second resolution is dropped and reported
        False (the race spec asserts it never happens)."""
        with self._cv:
            if self._done:
                return False
            self._result = result
            self._done = True
            self._cv.notify_all()
            return True

    def result(self, timeout: Optional[float] = None) -> ServeResult:
        deadline = None if timeout is None else cc.monotonic() + float(timeout)
        with self._cv:
            while not self._done:
                if deadline is None:
                    self._cv.wait(timeout=60.0)
                    continue
                remaining = deadline - cc.monotonic()
                if remaining <= 0:
                    raise TimeoutError("request result not ready")
                self._cv.wait(timeout=remaining)
        return self._result


@dataclasses.dataclass
class EngineRequest(slog.Request):
    """A :class:`~paddle_tpu_torch.observability.serving.Request` plus the
    engine-side lifecycle: future, wall deadline, accumulated tokens,
    the slot it occupies, cancellation and exactly-once bookkeeping."""

    future: Optional[ResultFuture] = None
    deadline: float = math.inf
    cancelled: bool = False
    queued: bool = False      # passed admission control (arrival counted)
    done: bool = False
    slot: int = -1
    budget: int = 0
    tokens: List[int] = dataclasses.field(default_factory=list)
    error: Optional[str] = None
    # absolute monotonic enqueue stamp for span emission: the inherited
    # t_enqueue is WINDOW-relative (re-anchored at every window_roll),
    # but a span's t0 must live in the stream timebase, which
    # obs.rel_time derives from absolute monotonic readings
    t_enqueue_abs: float = 0.0
    # --- self-speculation bookkeeping (collect-boundary only, under
    # the engine lock): per-request acceptance EMA and the per-slot
    # fallback latch — a request whose drafts keep missing stops
    # proposing (it still rides verify launches as a plain step)
    spec_ema: float = 0.0
    spec_samples: int = 0
    spec_off: bool = False


class Engine:
    """Slot-based continuous-batching decode engine.

    ``backend`` supplies capacity (``backend.slots``) and the device
    work; ``queue_cap`` rejects submits past the bound (0 = unbounded);
    ``request_timeout_s`` is the default wall-clock deadline from submit
    — expiry frees the queue entry OR the decode slot at the next
    iteration boundary with ``outcome=timeout``. ``pipeline`` selects
    the overlapped dispatch/collect loop (default) vs the PR-12 serial
    loop — identical request semantics, pinned by the golden
    pipelined==blocking test. ``clock`` is injectable for tests
    (defaults to the ``cc`` seam's monotonic, so ``paddle race``
    virtualizes it automatically)."""

    def __init__(self, backend, queue_cap: int = 0,
                 request_timeout_s: float = 60.0,
                 clock: Optional[Callable[[], float]] = None,
                 idle_poll_s: float = 0.02,
                 pipeline: bool = True,
                 shed_policy: str = "off",
                 breaker=None,
                 hangwatch=None,
                 on_oom: Optional[Callable[[BaseException], None]] = None,
                 replica: str = ""):
        if shed_policy not in SHED_POLICIES:
            raise ValueError(
                f"unknown shed policy {shed_policy!r}: expected one of "
                f"{SHED_POLICIES}"
            )
        self._backend = backend
        self.queue_cap = int(queue_cap)
        self.request_timeout_s = float(request_timeout_s)
        self.idle_poll_s = float(idle_poll_s)
        self.pipeline = bool(pipeline)
        # fleet identity: stamped on every request/serve_window record
        # this engine emits, so N in-process replicas (bench --replicas)
        # stay distinguishable in one telemetry stream
        self.replica = str(replica)
        self._clock = clock or cc.monotonic
        self._lock = cc.Lock()
        self._wake = cc.Condition(self._lock)
        self._queue: collections.deque = collections.deque()
        self._slots: List[Optional[EngineRequest]] = [None] * backend.slots
        # requests between queue-pop and slot placement (the prefill
        # launch runs outside the lock): cancel() must still find them
        self._admitting: List[EngineRequest] = []
        self._ladder = tuple(sorted(set(
            int(u) for u in (getattr(backend, "decode_blocks", None)
                             or (getattr(backend, "chunk", 1),))
        ))) or (1,)
        # --- self-speculative decode (doc/serving.md "Speculative
        # decode"): the backend advertises its pre-warmed draft-length
        # ladder; empty/absent = speculation off and every spec field
        # below stays inert. The draft table and its EMAs are touched
        # ONLY under self._lock (the race spec's draft-table phases).
        self._spec_ladder = tuple(
            int(k) for k in (getattr(backend, "spec_blocks", ()) or ()))
        self._draft = None
        if self._spec_ladder:
            from paddle_tpu_torch.serving.draft import DraftTable

            self._draft = DraftTable()
        self._spec_ema = 0.0
        self._spec_samples = 0
        self._spec_cooloff = 0
        self.slot_dtype = str(getattr(backend, "slot_dtype", "") or "")
        self._log = self._fresh_log()
        self._t0 = self._clock()
        self._thread = None
        self._started = False
        self._draining = False
        self._n_submitted = 0
        # distributed tracing (doc/observability.md "Distributed
        # tracing"): latched under the lock at the first traced submit;
        # until then the engine emits zero kind=span records, so
        # untraced single-process runs keep their telemetry unchanged
        self._tracing = False
        self._pid = os.getpid()
        self.warmup_s: Optional[float] = None
        # --- resilience plane (doc/resilience.md "Serving resilience")
        self.shed_policy = str(shed_policy)
        # the launch-failure CircuitBreaker (serving/resilience.py) —
        # consulted and mutated ONLY with self._lock held, so it needs
        # no lock of its own
        self._breaker = breaker
        self._hangwatch = hangwatch     # ServeHangWatch or None
        self._on_oom = on_oom           # `paddle serve`: pre-mortem + exit 20
        # measured EMAs the shed policy estimates from — mirrored from
        # the scheduler's loop-locals under the lock at every collect
        # boundary (pick_block keeps reading the hot locals): device
        # seconds per decode micro-step, host+dispatch seconds per
        # iteration, prefill seconds per admission cohort
        self._step_ema = 0.0
        self._host_ema = 0.0
        self._prefill_ema = 0.0
        # queue-pressure EMA (depth / slots) + brownout engagement
        self._pressure_ema = 0.0
        self._brownout = False
        # lifetime outcome totals + liveness timestamps for status()
        self._totals: Dict[str, int] = {o: 0 for o in OUTCOMES}
        self._last_collect = self._clock()   # last collect/step result
        self._last_loop = self._clock()      # last scheduler-loop beat
        # --- hot weight reload (doc/serving.md "Serving fleet"): a
        # pending (params, tag) pair set by request_reload() and
        # applied by the scheduler at the NEXT iteration boundary —
        # dispatched launches snapshot their arguments, so swapping
        # between boundaries never tears an in-flight decode
        self._pending_reload: Optional[Tuple[Any, str]] = None
        self._reloads = 0
        self._reload_tag = ""

    # ----------------------------------------------------------- client

    @property
    def slots(self) -> int:
        return self._backend.slots

    @property
    def max_length(self) -> int:
        return self._backend.max_length

    def _fresh_log(self) -> slog.RequestLog:
        return slog.RequestLog(engine=ENGINE_NAME,
                               pipeline="on" if self.pipeline else "off",
                               replica=self.replica,
                               spec=(",".join(str(k) for k in
                                              self._spec_ladder)
                                     if self._spec_ladder else
                                     ("off" if hasattr(self._backend,
                                                       "spec_blocks")
                                      else None)),
                               slot_dtype=self.slot_dtype or None)

    def seed_draft(self, seqs: Sequence[Sequence[int]]) -> int:
        """Warm the speculation draft table from committed token
        sequences — ``bench.py serve`` reuses the calibration's warmup
        launches' outputs here, so spec-on first-rung goodput isn't
        penalized by draft-table cold start (those launches already ran
        with ``backend.serving`` off and stay out of the rung
        telemetry). Returns how many sequences were folded in; a no-op
        (0) when speculation is off."""
        if self._draft is None:
            return 0
        n = 0
        with self._lock:
            for toks in seqs:
                toks = list(toks or ())
                if toks:
                    self._draft.observe(toks)
                    n += 1
        return n

    def start(self) -> "Engine":
        """Warm the backend (all compiles land BEFORE serving — the
        recompiles=0 acceptance; every ladder rung is exercised) and
        spawn the scheduler thread. ``warmup_s`` records the wall cost —
        with ``--compile_cache_dir`` a warm restart's figure drops to
        trace time (the time-to-first-token-ready satellite)."""
        with self._lock:
            if self._started:
                return self
            self._started = True
        t0 = cc.perf_counter()
        self._backend.warmup()
        self.warmup_s = cc.perf_counter() - t0
        from paddle_tpu_torch.observability import metrics as obs

        obs.registry().gauge("serve.warmup_s").set(round(self.warmup_s, 6))
        hw = self._hangwatch
        if hw is not None:
            # started AFTER warmup: compile time is startup, not a hang
            hw.attach(self)
            hw.start()
        th = cc.Thread(target=self._loop, name="serve-engine", daemon=True)
        with self._lock:
            self._thread = th
        th.start()
        return self

    def submit(self, prompt: Sequence[int],
               max_new_tokens: Optional[int] = None,
               rid: Optional[str] = None,
               timeout_s: Optional[float] = None,
               replay: bool = False,
               trace: str = "") -> ResultFuture:
        """Enqueue one request; returns its future. Rejected immediately
        (``outcome=rejected``) when draining, stopped, or past
        ``queue_cap`` — a rejection is an answer, never an exception.
        ``replay=True`` re-offers a durably journaled backlog after a
        restart: arrival control (``queue_cap``, brownout arrival shed)
        governs new arrivals, not the already-accepted queue.
        ``trace`` is the opaque distributed-tracing join key: when set,
        the request's record carries it as ``trace_id`` and the engine
        emits ``kind=span`` hop records for it."""
        fut = ResultFuture()
        with self._lock:
            now = self._now()
            if rid is None:
                rid = f"c{self._pid}-{self._n_submitted}"
            self._n_submitted += 1
            limit = timeout_s if timeout_s is not None else self.request_timeout_s
            req = EngineRequest(
                rid=rid, t_enqueue=now, prompt=list(prompt),
                prompt_tokens=len(prompt), max_new=max_new_tokens,
                future=fut, deadline=now + float(limit),
                trace=str(trace or ""), t_enqueue_abs=now + self._t0,
            )
            if req.trace:
                self._tracing = True
            if self._draining or not self._started or self._thread is None:
                self._finish_locked(req, "rejected", now)
            elif max_new_tokens is not None and int(max_new_tokens) <= 0:
                # 0 is a LEGAL budget, not an unset sentinel: the answer
                # is the empty generation, no slot needed (and no device
                # — an open breaker doesn't stop it either)
                req.queued = True
                req.t_admit = now
                self._log.enqueued(req)
                self._log.admit(req)
                self._finish_locked(req, "ok", now)
            elif self._breaker is not None and not self._breaker.allow_submit():
                # reject-fast while the launch-failure breaker cools:
                # queueing behind a faulting device only converts this
                # request into a slower error/timeout
                if req.trace:
                    self._span_locked("engine.breaker_reject",
                                      now + self._t0, 0.0,
                                      trace=req.trace, rid=req.rid)
                self._finish_locked(
                    req, "shed", now,
                    retry_after=self._breaker.retry_after_s(),
                )
            elif (not replay and self.queue_cap
                  and len(self._queue) >= self.queue_cap):
                self._finish_locked(req, "rejected", now)
            elif (not replay and self._brownout
                  and len(self._queue) >= max(self.slots, 1)):
                # engaged brownout sheds arrivals past one full slot
                # wave: the queue stays bounded by policy, and the
                # client gets a drain-ETA hint instead of a timeout
                self._finish_locked(
                    req, "shed", now, retry_after=self._drain_eta_locked(),
                )
            else:
                req.queued = True
                self._queue.append(req)
                self._log.enqueued(req)
                self._wake.notify_all()
        return fut

    def cancel(self, rid: str) -> bool:
        """Request cancellation; applied at the next iteration boundary
        (frees the queue entry or the slot, ``outcome=cancelled``).
        False when the id is unknown or already finished."""
        with self._lock:
            for req in self._queue:
                if req.rid == rid and not req.done:
                    req.cancelled = True
                    self._wake.notify_all()
                    return True
            for req in self._slots:
                if req is not None and req.rid == rid and not req.done:
                    req.cancelled = True
                    return True
            for req in self._admitting:
                if req.rid == rid and not req.done:
                    req.cancelled = True
                    return True
        return False

    def request_reload(self, params, tag: str = "") -> None:
        """Stage a hot weight swap: the scheduler applies ``params`` via
        ``backend.reload`` at the next iteration boundary, so requests
        admitted before the swap finish on the OLD weights (their
        dispatched launches already snapshotted them) and everything
        after decodes on the new ones — nothing is dropped, nothing is
        stranded. A second call before the boundary supersedes the
        first (only the newest checkpoint matters)."""
        with self._lock:
            self._pending_reload = (params, str(tag))
            self._wake.notify_all()

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Graceful shutdown: finish in-flight slots, reject the queue
        and every later submit, stop the loop. True when the scheduler
        thread exited within ``timeout``."""
        with self._lock:
            self._draining = True
            self._wake.notify_all()
            th = self._thread
        if th is None:
            return True
        th.join(timeout if timeout is not None else 600.0)
        return not th.is_alive()

    close = drain

    # -------------------------------------------------------- telemetry

    def begin_window(self) -> None:
        """Re-anchor the telemetry window (rung start). Caller must be
        quiescent — in-flight requests would straddle the anchor."""
        with self._lock:
            self._log = self._fresh_log()
            self._t0 = self._clock()

    def window_roll(self, offered_rps: float = 0.0, rung: int = 0,
                    window_s: Optional[float] = None) -> Dict[str, Any]:
        """Emit the current window's ``kind=serve_window`` rollup and
        start a fresh one; returns the record (sans envelope)."""
        with self._lock:
            now = self._now()
            log = self._log
            log.rung = int(rung)
            log.offered_rps = float(offered_rps)
            wall = max(now, 1e-9)
            host_share = max(1.0 - log.exec_s / wall, 0.0)
            rec = log.window_record(
                max(window_s if window_s is not None else now, 1e-9),
                host_share=host_share,
            )
            self._log = self._fresh_log()
            self._t0 = self._clock()
            return rec

    # -------------------------------------------------------- scheduler

    def _now(self) -> float:
        return self._clock() - self._t0

    def _span_locked(self, name: str, t0_abs: float, dur_s: float,
                     **fields: Any) -> None:
        """One ``kind=span`` hop record (doc/observability.md
        "Distributed tracing"). ``t0_abs`` is an absolute monotonic
        reading from ``self._clock`` — mapped into the stream timebase
        here, because request stamps like ``t_enqueue`` are
        window-relative and re-anchor at every roll. Caller holds
        ``self._lock`` (telemetry under the engine lock follows the
        ``_note_reload`` precedent); a no-op until the first traced
        submit, so untraced runs emit nothing."""
        if not self._tracing:
            return
        from paddle_tpu_torch.observability import metrics as obs

        obs.emit("span", name=name, t0=obs.rel_time(t0_abs),
                 dur_s=round(max(float(dur_s), 0.0), 6),
                 engine=ENGINE_NAME,
                 **({"replica": self.replica} if self.replica else {}),
                 **fields)

    def _finish_locked(self, req: EngineRequest, outcome: str,
                       now: float, error: Optional[str] = None,
                       retry_after: Optional[float] = None) -> None:
        """Resolve one request exactly once: telemetry record + future."""
        if req.done:
            return
        req.done = True
        req.error = error
        if outcome == "ok":
            req.t_finish = now
            req.gen_tokens = len(req.tokens)
            self._log.complete(req)
        elif outcome == "rejected":
            # a drain-path rejection already counted its arrival at
            # enqueue; a submit-time one never arrived in the window
            self._log.reject(req, arrived=req.queued)
        elif outcome == "timeout":
            self._log.timeout(req, now)
        elif outcome == "cancelled":
            self._log.cancel(req, now)
        elif outcome == "shed":
            if req.trace:
                # interference instant: the deadline/brownout/breaker
                # shed that ended this trace early shows up in its
                # timeline, not just in the aggregate counters
                self._span_locked("engine.shed", now + self._t0, 0.0,
                                  trace=req.trace, rid=req.rid)
            self._log.shed(req, now, arrived=req.queued,
                           retry_after_s=retry_after)
        else:
            self._log.error(req, error=error or "decode failed")
        self._totals[req.outcome] = self._totals.get(req.outcome, 0) + 1
        req.future._resolve(ServeResult(
            rid=req.rid, outcome=req.outcome,
            tokens=list(req.tokens), error=error,
            retry_after_s=retry_after,
        ))

    def _sweep_locked(self, now: float) -> None:
        """Iteration boundary policy: cancellations and wall deadlines,
        queue entries first (FIFO — the oldest expire first), then
        in-flight slots (the device row keeps decoding to its bounded
        budget and is simply overwritten by the next admission)."""
        for _ in range(len(self._queue)):
            req = self._queue.popleft()
            if req.cancelled:
                self._finish_locked(req, "cancelled", now)
            elif now > req.deadline:
                self._finish_locked(req, "timeout", now)
            else:
                self._queue.append(req)  # full rotation keeps FIFO order
        for b, req in enumerate(self._slots):
            if req is None:
                continue
            if req.cancelled:
                self._slots[b] = None
                self._finish_locked(req, "cancelled", now)
            elif now > req.deadline:
                self._slots[b] = None
                self._finish_locked(req, "timeout", now)

    def _fail_inflight_locked(self, now: float, error: str) -> None:
        for b, req in enumerate(self._slots):
            if req is not None:
                self._slots[b] = None
                self._finish_locked(req, "error", now, error=error)

    # ------------------------------------------------ resilience plane

    def _note_launch_fault_locked(self) -> None:
        """One failed launch toward the circuit breaker; counts the
        window's breaker_open when this fault tripped it."""
        if self._breaker is not None and self._breaker.record_fault():
            self._log.note_breaker_open()
            logger.error(
                "serve launch-failure breaker OPEN after %d consecutive "
                "fault(s): shedding submits for %.1fs, no cohorts "
                "launched until the half-open probe",
                self._breaker.threshold, self._breaker.cooldown_s,
            )

    def _chaos_boundary(self) -> None:
        """The serve-tier chaos sites, one hit per collect boundary —
        the serving twins of trainer.{crash,stall,oom} (`paddle faults`;
        doc/resilience.md "Serving resilience"). Raise-action faults
        deliberately fire INSIDE the loops' launch try-blocks, so they
        travel the same error/breaker/OOM paths a real device fault
        would."""
        faultinject.fault_point("serve.crash")
        faultinject.fault_point("serve.stall")
        try:
            faultinject.fault_point("serve.oom")
        except faultinject.FaultInjected as e:
            from paddle_tpu_torch.observability.memory import SyntheticOomError

            # the canonical RESOURCE_EXHAUSTED marker, so is_oom_error
            # (and the pre-mortem path) classify it like the real thing
            raise SyntheticOomError("serve decode launch") from e
        faultinject.fault_point("serve.launch_fault")

    def _oom_check(self, e: BaseException) -> bool:
        """RESOURCE_EXHAUSTED escaping a serve launch is deterministic
        poison — the same slots at the same signature OOM again, so
        "error the cohort and keep serving" would burn every future
        cohort. With an ``on_oom`` handler installed (`paddle serve`:
        trigger_oom_report → exit EXIT_OOM=20) the engine answers
        everything it holds with outcome=error, stops, and hands the
        error over; without one (library embeddings, unit tests) the
        generic fault path stands. True = OOM handled, loop must exit."""
        if self._on_oom is None:
            return False
        from paddle_tpu_torch.observability.memory import is_oom_error

        if not is_oom_error(e):
            return False
        err = f"oom: {type(e).__name__}: {e}"
        logger.error("serve launch OOM — answering %s and stopping: %s",
                     "everything queued/in-flight", err)
        with self._lock:
            now = self._now()
            self._fail_inflight_locked(now, err)
            for req in self._admitting:
                self._finish_locked(req, "error", now, error=err)
            self._admitting = []
            while self._queue:
                self._finish_locked(self._queue.popleft(), "error", now,
                                    error=err)
            self._draining = True
            self._wake.notify_all()
        handler = self._on_oom
        try:
            handler(e)  # `paddle serve`: oom_report.json + os._exit(20)
        except Exception as he:  # noqa: BLE001 — never mask the OOM
            logger.error("serve on_oom handler failed: %s", he)
        return True

    def _ping(self) -> None:
        """Scheduler-loop liveness beat for the hangwatch, called once
        per loop iteration (idle polls included — an idle server is
        alive, not hung). The status file's loop-age stamp rides in
        :meth:`_boundary`'s existing critical section instead of taking
        the engine lock here a second time per iteration."""
        hw = self._hangwatch
        if hw is not None:
            hw.ping()

    def _note_collect_locked(self) -> None:
        """Caller holds self._lock (the collect-boundary beat is
        written there, lexically under the lock, for PTL005)."""
        if self._breaker is not None:
            self._breaker.record_success()

    # hang_snapshot/hang_fail_all run on the HANGWATCH MONITOR thread
    # while the scheduler is wedged mid-collect: bounded lock acquires —
    # if the scheduler wedged while holding the lock, a degraded answer
    # beats joining the hang (the backstop timer caps everything anyway)

    def hang_snapshot(self) -> Dict[str, Any]:
        """The in-flight cohort snapshot for serve_hang_report.json."""
        if not self._lock.acquire(timeout=2.0):
            return {"lock": "unavailable — scheduler may hold it"}
        try:
            return {
                "queue_depth": len(self._queue),
                "queued": [r.rid for r in list(self._queue)[:32]],
                "slots": [
                    None if r is None else {
                        "rid": r.rid, "tokens": len(r.tokens),
                        "budget": r.budget,
                        "deadline_in_s": round(r.deadline - self._now(), 3),
                    }
                    for r in self._slots
                ],
                "admitting": [r.rid for r in self._admitting],
                "inflight_launches": getattr(self._backend, "inflight",
                                             None),
                "draining": self._draining,
                "breaker": (self._breaker.state
                            if self._breaker is not None else None),
                "brownout": self._brownout,
                "totals": dict(self._totals),
            }
        finally:
            self._lock.release()

    def hang_fail_all(self, error: str) -> int:
        """Answer what we can before the hang exit: every queued,
        admitting, and in-flight request resolves outcome=error (the
        client hears "the server hung" now instead of timing out
        later). Returns how many were answered. Also sets draining so
        any submit racing this exit resolves outcome=rejected
        immediately — the frontend's pre-exit answer flush must never
        find an unresolvable future."""
        if not self._lock.acquire(timeout=2.0):
            return 0
        try:
            now = self._now()
            self._draining = True
            n = 0
            while self._queue:
                self._finish_locked(self._queue.popleft(), "error", now,
                                    error=error)
                n += 1
            for req in self._admitting:
                if not req.done:
                    self._finish_locked(req, "error", now, error=error)
                    n += 1
            self._admitting = []
            for b, req in enumerate(self._slots):
                if req is not None:
                    self._slots[b] = None
                    if not req.done:
                        self._finish_locked(req, "error", now, error=error)
                        n += 1
            return n
        finally:
            self._lock.release()

    def status(self) -> Dict[str, Any]:
        """The ``--status_path`` health document (serving/resilience.
        StatusWriter): queue depth, slot occupancy, last-collect age,
        outcome totals, draining flag, breaker/brownout state. Bounded
        lock — a wedged scheduler yields a stale-but-honest snapshot."""
        now = self._clock()
        if not self._lock.acquire(timeout=0.5):
            return {"stale": True,
                    "detail": "engine lock unavailable (scheduler busy "
                              "or wedged — see the hangwatch)"}
        try:
            return {
                "started": self._started,
                "draining": self._draining,
                "queue_depth": len(self._queue),
                "slots": self.slots,
                "occupancy": sum(1 for r in self._slots if r is not None),
                "inflight": getattr(self._backend, "inflight", None),
                "last_collect_age_s": round(now - self._last_collect, 3),
                "loop_age_s": round(now - self._last_loop, 3),
                "breaker": (self._breaker.state
                            if self._breaker is not None else "disabled"),
                "breaker_opens": (self._breaker.opened_total
                                  if self._breaker is not None else 0),
                "brownout": self._brownout,
                "shed_policy": self.shed_policy,
                "pipeline": "on" if self.pipeline else "off",
                "warmup_s": self.warmup_s,
                "reloads": self._reloads,
                "reload_tag": self._reload_tag,
                "totals": dict(self._totals),
            }
        finally:
            self._lock.release()

    # --------------------------------------------- shared loop phases

    def _effective_budget_locked(self, req: EngineRequest) -> int:
        budget = max(1, min(
            self._backend.max_length if req.max_new is None else req.max_new,
            self._backend.max_length,
        ))
        if self._brownout:
            # degraded mode: everyone gets a shorter answer rather than
            # the tail getting none (doc/resilience.md)
            budget = min(budget, max(
                1, int(self._backend.max_length * BROWNOUT_BUDGET_SHARE)))
        return budget

    def _eta_s_locked(self, budget: int) -> Optional[float]:
        """Estimated seconds to serve a request admitted NOW: measured
        prefill + budget decode micro-steps. None while unmeasured
        (warmup) — the shed policy never guesses."""
        if self._step_ema <= 0.0:
            return None
        return self._prefill_ema + float(budget) * self._step_ema

    def _drain_eta_locked(self) -> float:
        """Rough queue-drain ETA for shed retry-after hints: how long
        the queued waves ahead take at the measured per-step rate.
        While unmeasured (a burst before the first collect boundary)
        the hint is a fixed conservative backoff — echoing the 20 ms
        idle poll would invite near-immediate retries into the same
        overloaded queue."""
        if self._step_ema <= 0.0:
            return UNMEASURED_RETRY_S
        waves = (len(self._queue) / max(self.slots, 1)) + 1.0
        per_wave = self._prefill_ema + self._step_ema * max(
            1, int(self._backend.max_length * BROWNOUT_BUDGET_SHARE))
        return max(waves * per_wave, self.idle_poll_s)

    def _boundary(self) -> Tuple[List[int], List[EngineRequest], List[int]]:
        """One iteration boundary under the lock: sweep cancellations
        and deadlines, reject the queue when draining, update the
        queue-pressure EMA (brownout engage/disengage), gate on the
        launch-failure breaker, then pick the FIFO admissions for the
        free slots — shedding, under a deadline-aware policy, any
        candidate whose remaining deadline the measured prefill+decode
        estimate already proves unmeetable (shed at admission, not
        after wasting a slot on a request that times out mid-decode)."""
        admit_slots: List[int] = []
        admit_reqs: List[EngineRequest] = []
        budgets: List[int] = []
        with self._lock:
            now = self._now()
            self._last_loop = self._clock()  # status loop-age beat
            if self._pending_reload is not None:
                params, tag = self._pending_reload
                self._pending_reload = None
                if self._swap_weights(params, tag):
                    self._reloads += 1
                    self._reload_tag = tag
                    self._note_reload(tag)
            self._sweep_locked(now)
            if self._draining:
                while self._queue:
                    self._finish_locked(self._queue.popleft(),
                                        "rejected", now)
            if self.shed_policy == "brownout":
                pressure = len(self._queue) / max(self.slots, 1)
                self._pressure_ema = (
                    (1 - _EMA) * self._pressure_ema + _EMA * pressure
                )
                if not self._brownout and self._pressure_ema >= BROWNOUT_ON:
                    self._brownout = True
                    self._set_brownout_gauge(1)
                    logger.warning(
                        "serve brownout ENGAGED (queue-pressure EMA %.2f "
                        ">= %g): output budgets capped to %d%% of "
                        "max_length, excess arrivals shed",
                        self._pressure_ema, BROWNOUT_ON,
                        int(BROWNOUT_BUDGET_SHARE * 100),
                    )
                elif self._brownout and self._pressure_ema <= BROWNOUT_OFF:
                    self._brownout = False
                    self._set_brownout_gauge(0)
                    logger.info(
                        "serve brownout released (queue-pressure EMA %.2f)",
                        self._pressure_ema,
                    )
            if self._breaker is not None and not self._breaker.allow_launch():
                # open breaker: no admissions, no launches — queued
                # requests wait out the cooldown (their deadlines still
                # sweep above); the half-open probe re-enters here
                self._admitting = []
                return [], [], []
            free = [b for b, r in enumerate(self._slots) if r is None]
            fi = 0
            while fi < len(free) and self._queue:
                req = self._queue.popleft()
                budget = self._effective_budget_locked(req)
                if self.shed_policy != "off":
                    eta = self._eta_s_locked(budget)
                    if eta is not None and now + eta > req.deadline:
                        # unmeetable deadline: answer now (no retry
                        # hint — more time won't fit this budget either)
                        self._finish_locked(req, "shed", now)
                        continue
                admit_slots.append(free[fi])
                admit_reqs.append(req)
                budgets.append(budget)
                fi += 1
            if admit_reqs and self._breaker is not None:
                # a half-open breaker lets exactly ONE cohort probe:
                # latch it so later boundaries wait out its collect
                # verdict instead of launching more (no-op when closed)
                self._breaker.note_probe()
            self._admitting = admit_reqs
        return admit_slots, admit_reqs, budgets

    def _set_brownout_gauge(self, v: int) -> None:
        from paddle_tpu_torch.observability import metrics as obs

        obs.registry().gauge("serve.brownout").set(v)

    def _swap_weights(self, params, tag: str) -> bool:
        """The iteration-boundary weight swap. The backend assignment
        is an O(1) reference swap (same shapes → no recompile; the
        NON-donated params argument means no dispatched launch can be
        torn by it). A failing swap keeps the old weights serving —
        reload is an upgrade, never an outage. Caller (the boundary,
        under the engine lock) bumps the reload bookkeeping on True."""
        try:
            self._backend.reload(params)
        except Exception as e:  # noqa: BLE001 — old weights keep serving
            logger.error("serve weight reload %r failed: %s — keeping "
                         "current weights", tag, e)
            return False
        return True

    def _note_reload(self, tag: str) -> None:
        from paddle_tpu_torch.observability import metrics as obs

        obs.registry().counter("serve.reloads").inc()
        obs.emit("reload", path=tag, engine=ENGINE_NAME,
                 **({"replica": self.replica} if self.replica else {}))
        # reload-boundary interference marker for traced timelines
        self._span_locked("engine.reload_boundary", self._clock(), 0.0,
                          tag=tag)
        logger.info("serve weights hot-reloaded at iteration boundary "
                    "(%s, reload #%d)", tag or "<untagged>", self._reloads)

    def _do_admit(self, admit_slots: List[int],
                  admit_reqs: List[EngineRequest],
                  budgets: List[int]) -> bool:
        """Prefill launch outside the lock (submit() must never block
        behind device work); place the cohort on success. In pipelined
        mode the backend dispatches without syncing, so the measured
        time is enqueue cost — the prefill's device time surfaces at
        the next collect boundary (doc/serving.md). False = the cohort
        (and everything in flight) was errored; caller resets. Budgets
        come from the boundary (brownout caps applied there)."""
        backend = self._backend
        t0 = self._clock()
        try:
            backend.admit(admit_slots, admit_reqs, budgets)
        except Exception as e:  # noqa: BLE001 — cohort gets the evidence
            err = f"{type(e).__name__}: {e}"
            logger.error("serve admit failed: %s", err)
            with self._lock:
                now = self._now()
                for req in admit_reqs:
                    self._finish_locked(req, "error", now, error=err)
                self._admitting = []
                self._fail_inflight_locked(now, err)
                self._note_launch_fault_locked()
            self._oom_check(e)
            return False
        dt = self._clock() - t0
        with self._lock:
            now = self._now()
            for b, req, budget in zip(admit_slots, admit_reqs, budgets):
                req.slot = b
                req.budget = budget
                req.t_admit = now
                self._slots[b] = req
                self._log.admit(req)
                if req.trace:
                    # request-perspective hops: time queued behind the
                    # cohort wave, then the (shared) prefill launch
                    self._span_locked(
                        "engine.queue_wait", req.t_enqueue_abs,
                        (now + self._t0) - req.t_enqueue_abs,
                        trace=req.trace, rid=req.rid)
                    self._span_locked("engine.prefill", t0, dt,
                                      trace=req.trace, rid=req.rid)
            self._admitting = []
            self._log.note_exec(dt)
            self._prefill_ema = (1 - _EMA) * self._prefill_ema + _EMA * dt
        return True

    def _loop(self) -> None:
        try:
            if self.pipeline:
                self._loop_pipelined()
            else:
                self._loop_blocking()
        finally:
            hw = self._hangwatch
            if hw is not None:
                hw.stop()  # a drained engine stops pinging — not a hang

    def _safe_reset(self) -> None:
        try:
            self._backend.reset()
        except Exception as e:  # noqa: BLE001
            logger.error("serve backend reset failed: %s", e)

    def _block_inputs_locked(self) -> Tuple[int, bool]:
        """(budget cap, pressure) for :func:`pick_block`, from the
        engine's view of the slots — under pipelining this lags the
        device by the in-flight launches, which only over-runs into
        frozen micro-steps (bounded, harmless)."""
        cap = 0
        pressed = bool(self._queue)
        for req in self._slots:
            if req is None:
                continue
            left = max(req.budget - len(req.tokens), 1)
            cap = left if cap == 0 else min(cap, left)
            if req.t_first_token < 0:
                pressed = True  # a slot still owes its first token
        return (cap or self._ladder[-1]), pressed

    # ------------------------------------------ self-speculation phases

    def _spec_k_locked(self) -> int:
        """The speculation rung for the NEXT launch (0 = plain decode),
        from the lock-guarded acceptance EMA. In the fallback regime
        this also runs the re-probe clock: after SPEC_REPROBE plain
        launches the EMAs reset so the bottom rung probes again."""
        if not self._spec_ladder:
            return 0
        k = pick_spec_k(self._spec_ladder, self._spec_ema,
                        self._spec_samples)
        if k <= 0:
            # the _locked suffix contract: every caller holds self._lock
            # (a non-reentrant cc.Lock — re-wrapping would deadlock)
            self._spec_cooloff += 1  # lint: disable=PTL005 -- caller holds self._lock (_locked contract; non-reentrant Lock)
            if self._spec_cooloff >= SPEC_REPROBE:
                self._spec_cooloff = 0  # lint: disable=PTL005 -- caller holds self._lock (_locked contract)
                self._spec_samples = 0  # lint: disable=PTL005 -- caller holds self._lock (_locked contract)
                self._spec_ema = 0.0  # lint: disable=PTL005 -- caller holds self._lock (_locked contract)
        return k

    def _gather_spec_locked(self, cohort, k: int):
        """The draft batch for one verify launch: up to ``k`` proposed
        tokens per live slot from the n-gram table, capped by the slot's
        remaining budget. Slots that opted out (per-request fallback),
        finished, or for which the chains run dry simply get no entry —
        they ride the launch as one plain greedy step. Returns None when
        NO slot proposes (caller dispatches a plain decode block
        instead; zero recompiles either way)."""
        if self._draft is None or k <= 0:
            return None
        drafts: Dict[int, List[int]] = {}
        for b, req in cohort:
            if req is None or req.done or req.spec_off:
                continue
            room = req.budget - len(req.tokens)
            kk = min(int(k), room)
            if kk <= 0:
                continue
            d = self._draft.propose(req.tokens, kk)
            if d:
                drafts[b] = d
        return drafts or None

    # ------------------------------------------------- the PR-12 loop

    def _loop_blocking(self) -> None:
        """The serial loop: boundary → admit (sync) → one blocking
        step() → apply. Kept verbatim as the pipeline A/B baseline
        (``pipeline=False`` / PADDLE_TPU_BENCH_SERVE_PIPELINE=off)."""
        backend = self._backend
        host_ema = self._host_ema
        step_ema = self._step_ema
        t_host0 = self._clock()
        while True:
            self._ping()
            admit_slots, admit_reqs, budgets = self._boundary()
            if admit_reqs and not self._do_admit(admit_slots, admit_reqs,
                                                 budgets):
                # an OOM admit additionally emptied the queue and set
                # draining inside _oom_check — the idle branch below
                # then exits the loop
                self._safe_reset()
                t_host0 = self._clock()
                continue
            with self._lock:
                occupancy = sum(1 for r in self._slots if r is not None)
                if occupancy == 0:
                    if self._draining and not self._queue:
                        break
                    if not self._queue or (
                        self._breaker is not None
                        and not self._breaker.allow_launch()
                    ):
                        # nothing admittable: empty queue, or the open
                        # breaker refused admissions at the boundary —
                        # poll instead of spinning the cooldown down
                        self._wake.wait(timeout=self.idle_poll_s)
                    # idle time is not host overhead: a stale anchor
                    # here would dump the whole idle stretch into
                    # host_ema and push pick_block to the top rung
                    # exactly when a fresh request wants a fast first
                    # boundary
                    t_host0 = self._clock()
                    continue
                cap, pressed = self._block_inputs_locked()
                spec = self._gather_spec_locked(
                    [(b, r) for b, r in enumerate(self._slots)
                     if r is not None],
                    self._spec_k_locked(),
                )
            if spec is not None:
                u = max(len(d) for d in spec.values())
            else:
                u = pick_block(self._ladder, cap, pressed, host_ema,
                               step_ema)
            t0 = self._clock()
            host_ema = (1 - _EMA) * host_ema + _EMA * (t0 - t_host0)
            try:
                self._chaos_boundary()
                out = (backend.step(draft=spec) if spec is not None
                       else backend.step(block=u))
            except Exception as e:  # noqa: BLE001 — engine survives a bad launch
                err = f"{type(e).__name__}: {e}"
                logger.error("serve decode launch failed: %s", err)
                with self._lock:
                    self._fail_inflight_locked(self._now(), err)
                    self._note_launch_fault_locked()
                self._safe_reset()
                if self._oom_check(e):
                    continue  # queue emptied + draining: exit via idle
                t_host0 = self._clock()
                continue
            dt = self._clock() - t0
            t_host0 = self._clock()
            step_ema = (1 - _EMA) * step_ema + _EMA * (dt / max(u, 1))
            with self._lock:
                # mirror the hot-loop EMAs for the shed policy + status
                self._host_ema = host_ema
                self._step_ema = step_ema
                self._last_collect = self._clock()
                self._note_collect_locked()
                traces = [r.trace for r in self._slots
                          if r is not None and r.trace]
                if traces:
                    self._span_locked("engine.decode_window", t0, dt,
                                      traces=traces, block=int(u))
                    rb = float(getattr(backend, "last_readback_s", 0.0)
                               or 0.0)
                    if rb > 0.0:
                        self._span_locked("engine.readback",
                                          t0 + dt - rb, rb,
                                          traces=traces)
                self._apply_step_locked(out, dt, occupancy, spec=spec)

    # ----------------------------------------------- the pipelined loop

    def _loop_pipelined(self) -> None:
        """Boundary and apply work overlap the in-flight launch: each
        iteration dispatches launch N+1 BEFORE collecting launch N, so
        the device never waits for host scheduling and the host never
        waits for a launch it has nothing to say about. ``inflight``
        holds (cohort snapshot, dispatch time) per launch — loop-local:
        the only cross-thread state stays the lock-guarded slots/queue."""
        backend = self._backend
        inflight: collections.deque = collections.deque()
        host_ema = self._host_ema
        step_ema = self._step_ema
        union_end = self._clock()   # union of dispatch->collect spans
        t_host0 = self._clock()
        while True:
            self._ping()
            admit_slots, admit_reqs, budgets = self._boundary()
            if admit_reqs and not self._do_admit(admit_slots, admit_reqs,
                                                 budgets):
                inflight = self._abort_inflight(inflight)
                # failure handling (logging, reset, device realloc) is
                # not host overhead — same stale-anchor rule as idle
                t_host0 = self._clock()
                continue
            # --- dispatch launch N+1 (device-ordered after the prefill)
            with self._lock:
                occupancy = sum(1 for r in self._slots if r is not None)
                cohort = [(b, r) for b, r in enumerate(self._slots)
                          if r is not None]
                cap, pressed = self._block_inputs_locked()
                # dispatch ahead only when it can pay: if every live
                # slot's remaining budget is already covered by
                # in-flight micro-steps, launch N+1 would run
                # all-frozen rows — pure waste (the short-budget
                # regime) — so collect first and let the boundary see
                # the finishes. EOS finishes stay unknowable ahead of
                # time; budgets are the bound we do know.
                pending_steps = sum(u for _c, u, _t, _lg, _sp in inflight)
                live_next = any(
                    r.budget - len(r.tokens) - pending_steps > 0
                    for _b, r in cohort
                )
                # self-speculation runs the launch pipeline at depth 1:
                # drafts must be proposed from fully-committed context
                # (a draft chained over an uncollected launch's unknown
                # tokens would miss by construction), so while a launch
                # is in flight the engine neither proposes nor
                # interleaves a plain launch — it collects first. The
                # in-flight launch still overlaps all host scheduling,
                # and each launch commits up to K+1 tokens instead of
                # the plain block's pipelined depth. With the EMA in
                # the fallback regime (k=0) the plain depth-2 pipeline
                # is back unchanged.
                spec = None
                spec_hold = False
                spec_k = self._spec_k_locked()
                if spec_k > 0:
                    if inflight:
                        spec_hold = True
                    else:
                        spec = self._gather_spec_locked(cohort, spec_k)
            dispatched = False
            if occupancy and not spec_hold and (live_next or not inflight):
                dispatched = True
                if spec is not None:
                    u = max(len(d) for d in spec.values())
                else:
                    u = pick_block(self._ladder, cap, pressed, host_ema,
                                   step_ema)
                t_disp = self._clock()
                host_ema = (1 - _EMA) * host_ema + _EMA * (t_disp - t_host0)
                try:
                    if spec is not None:
                        backend.dispatch(draft=spec)
                    else:
                        backend.dispatch(block=u)
                except Exception as e:  # noqa: BLE001
                    err = f"{type(e).__name__}: {e}"
                    logger.error("serve decode dispatch failed: %s", err)
                    with self._lock:
                        self._fail_inflight_locked(self._now(), err)
                        self._note_launch_fault_locked()
                    inflight = self._abort_inflight(inflight, err)
                    self._oom_check(e)
                    t_host0 = self._clock()
                    continue
                with self._lock:
                    # the launch belongs to the CURRENT telemetry
                    # window: a window_roll between this dispatch and
                    # its collect closes that window, and the stray
                    # launch must not leak its exec/overlap into the
                    # next one (begin_window's quiescence note)
                    inflight.append((cohort, u, t_disp, self._log, spec))
                    self._log.note_dispatch(len(inflight))
            # --- collect launch N while N+1 runs; collect immediately
            # when nothing was dispatched ahead (tail / draft cadence /
            # nothing worth dispatching)
            if inflight and (len(inflight) > 1 or not dispatched):
                cohort, u, t_disp, disp_log, spec_snap = inflight[0]
                t_wait = self._clock()
                try:
                    self._chaos_boundary()
                    out = backend.collect()
                except Exception as e:  # noqa: BLE001 — fault surfaces HERE
                    err = f"{type(e).__name__}: {e}"
                    logger.error("serve decode launch failed: %s", err)
                    with self._lock:
                        self._fail_inflight_locked(self._now(), err)
                        self._note_launch_fault_locked()
                    inflight = self._abort_inflight(inflight, err)
                    self._oom_check(e)
                    t_host0 = self._clock()
                    continue
                inflight.popleft()
                t_done = self._clock()
                # exec side of host_share: the UNION of dispatch->done
                # spans — overlapping spans must not double-count
                service = max(t_done - max(t_disp, union_end), 0.0)
                union_end = max(union_end, t_done)
                # the ladder's device estimate uses the DE-OVERLAPPED
                # span: the raw dispatch->done time of launch N+1 also
                # contains its wait behind launch N, which would read
                # as ~2x the true per-micro-step cost under steady
                # pipelining and skew pick_block a rung low
                step_ema = (1 - _EMA) * step_ema + _EMA * (service / max(u, 1))
                with self._lock:
                    # mirror the hot-loop EMAs for the shed policy +
                    # status, and beat the collect-liveness clock
                    self._host_ema = host_ema
                    self._step_ema = step_ema
                    self._last_collect = self._clock()
                    self._note_collect_locked()
                    traces = [r.trace for _b, r in cohort if r.trace]
                    if traces:
                        # decode-iteration window from the COHORT
                        # snapshot: the requests whose tokens this
                        # collect actually carries, even if their
                        # slots were since reassigned
                        self._span_locked("engine.decode_window",
                                          t_disp, t_done - t_disp,
                                          traces=traces, block=int(u))
                        rb = float(getattr(backend, "last_readback_s",
                                           0.0) or 0.0)
                        if rb > 0.0:
                            self._span_locked("engine.readback",
                                              t_done - rb, rb,
                                              traces=traces)
                    stale = disp_log is not self._log
                    if not stale:
                        self._log.note_overlap(max(t_wait - t_disp, 0.0))
                    self._log.note_dispatch(len(inflight))
                    # tokens/finishes always apply (requests legally
                    # span windows); the launch/overlap/exec accounting
                    # is skipped when the dispatching window has rolled
                    # closed — its record is already emitted
                    self._apply_step_locked(out, service, len(cohort),
                                            cohort=cohort,
                                            count_launch=not stale,
                                            spec=spec_snap)
                t_host0 = self._clock()
                continue
            # --- idle / exit
            with self._lock:
                if not inflight and not any(
                    r is not None for r in self._slots
                ):
                    if self._draining and not self._queue:
                        break
                    if not self._queue or (
                        self._breaker is not None
                        and not self._breaker.allow_launch()
                    ):
                        # empty queue, or the open breaker refused
                        # admissions — poll, don't spin the cooldown
                        self._wake.wait(timeout=self.idle_poll_s)
            # anchored AFTER any idle wait: idle seconds are not host
            # overhead and must not inflate the ladder's host_ema
            t_host0 = self._clock()

    def _abort_inflight(self, inflight: collections.deque,
                        error: str = "decode failed") -> collections.deque:
        """A faulted launch takes every in-flight cohort with it: their
        results are unrecoverable once the device state resets. Each
        snapshot request resolves exactly once (`done` guards repeats
        across overlapping snapshots and the slot sweep)."""
        with self._lock:
            now = self._now()
            for cohort, _u, _t, _lg, _sp in inflight:
                for _b, req in cohort:
                    self._finish_locked(req, "error", now, error=error)
            self._log.note_dispatch(0)
        self._safe_reset()
        return collections.deque()

    def _apply_step_locked(self, out, service_s: float, occupancy: int,
                           cohort=None, count_launch: bool = True,
                           spec=None) -> None:
        """Fold one launch's readback into the request lifecycles.
        ``cohort`` (pipelined) is the slot snapshot taken at dispatch:
        tokens belong to THOSE requests — a slot re-assigned between
        dispatch and collect must not leak a previous occupant's tokens
        to the new one (the snapshot discipline); evicted (done)
        requests just skip. ``spec`` is the launch's draft snapshot
        (slot -> proposed tokens, carried like the cohort snapshot):
        acceptance is judged HERE, against the committed tokens, and the
        draft table learns from them — the collect boundary is the only
        place the table is ever written (under this lock)."""
        now = self._now()
        tokens, live, finished = out.tokens, out.live, out.finished
        u = tokens.shape[0]
        rows = (cohort if cohort is not None
                else enumerate(self._slots))
        for b, req in rows:
            if req is None or req.done:
                continue
            emitted = [int(tokens[i, b]) for i in range(u) if bool(live[i, b])]
            d = spec.get(b) if spec else None
            if d:
                # accepted = the emitted prefix that matched the draft
                # (the verify launch emits accepted + the one corrected
                # token, so this is exact, not inferred from counts)
                acc = 0
                for t, want in zip(emitted, d):
                    if t != want:
                        break
                    acc += 1
                rate = acc / len(d)
                self._log.note_spec(len(d), acc)
                self._spec_samples += 1  # lint: disable=PTL005 -- caller holds self._lock (_locked contract; non-reentrant Lock)
                self._spec_cooloff = 0  # lint: disable=PTL005 -- caller holds self._lock (_locked contract)
                self._spec_ema = (rate if self._spec_samples == 1 else
                                  (1 - _EMA) * self._spec_ema + _EMA * rate)  # lint: disable=PTL005 -- caller holds self._lock (_locked contract)
                req.spec_samples += 1
                req.spec_ema = (rate if req.spec_samples == 1 else
                                (1 - _EMA) * req.spec_ema + _EMA * rate)
                if (req.spec_samples >= SPEC_MIN_SAMPLES
                        and req.spec_ema < SPEC_REQ_OFF):
                    # per-slot fallback: this request's drafts keep
                    # missing — stop proposing for it (zero recompiles:
                    # it rides verify launches as a plain step)
                    req.spec_off = True
            if emitted:
                if self._draft is not None:
                    # collect-boundary table update: context is the
                    # previously committed tail, so chains span launch
                    # boundaries without double-counting
                    self._draft.observe(
                        emitted, context=req.tokens[-self._draft.order:])
                if req.t_first_token < 0:
                    # REAL wall-clock TTFT: this readback is the moment
                    # the first token left the device — mid-sequence,
                    # not at finish (and, pipelined, at the COLLECT
                    # boundary: the earliest the host can know)
                    req.t_first_token = now
                req.tokens.extend(emitted)
            if bool(finished[b]) and self._slots[b] is req:
                self._slots[b] = None
                self._finish_locked(req, "ok", now)
        if count_launch:
            self._log.launch(len(self._queue), occupancy, service_s)


# ------------------------------------------------------------- driver


def drive_rung(engine: Engine, requests: Sequence[slog.Request], *,
               rate_rps: float, rung: int = 0,
               result_timeout_s: float = 300.0) -> Dict[str, Any]:
    """Open-loop wall-clock driver for one offered-load rung against a
    live engine — the continuous counterpart of the PR-8 virtual-clock
    ``run_rung``, fed the SAME :func:`~paddle_tpu_torch.observability.serving.
    schedule_requests` workload. Submits each request at its scheduled
    arrival offset (sleeping the gaps; a late submit stays late — open
    loop never hides coordinated omission), waits for every future, and
    rolls the window."""
    engine.begin_window()
    t0 = cc.monotonic()
    futures = []
    for req in requests:
        delay = req.t_enqueue - (cc.monotonic() - t0)
        if delay > 0:
            cc.sleep(delay)
        futures.append(engine.submit(
            req.prompt or [], max_new_tokens=req.max_new, rid=req.rid,
        ))
    for fut in futures:
        fut.result(timeout=result_timeout_s)
    elapsed = cc.monotonic() - t0
    window_s = max(elapsed, requests[-1].t_enqueue if requests else 0.0)
    return engine.window_roll(offered_rps=rate_rps, rung=rung,
                              window_s=window_s)
