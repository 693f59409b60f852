"""Request-level serving telemetry + the offered-load serve harness.

Training got end-to-end observability in PR 3 (metrics stream) and PR 7
(compile/roofline attribution); generation had none — ``bench_nmt_gen``
reports one aggregate tokens/s for a static batch, and the embedding
API's ``SequenceGenerator`` emits nothing. This module is the telemetry
contract the continuous-batching server (ROADMAP item 1) must keep,
built and exercised *before* that server exists so it lands on
instrumented rails:

- :class:`RequestLog` — per-request lifecycle records (``kind=request``:
  enqueue/admit/first-token/finish offsets → queue-wait, TTFT, decode
  time; prompt/generated token counts; beam size; batch cohort id and
  size; outcome ok/rejected/timeout/error) plus per-window rollups
  (``kind=serve_window``: offered load, goodput, admitted/completed/
  rejected counts, queue-depth and batch-occupancy histograms).
- :func:`run_rung` / :func:`run_sweep` — a deterministic **open-loop**
  offered-load driver: inter-arrival times are precomputed from a seed
  (:func:`arrival_offsets` — no wall-clock in the schedule), and the
  driver advances a VIRTUAL clock: admission/cohort decisions are pure
  functions of the schedule and the measured (or injected) per-launch
  service times, so the same seed plus the same service times yields
  the same cohort assignment bit-for-bit. Wall-clock is read only to
  *measure* service; at low offered load the virtual clock jumps to the
  next arrival instead of sleeping, so a sweep costs launch time, not
  idle time. Closed-loop benchmarks (fixed batch, back-to-back) can
  never see queueing; this is the p50/p99-vs-offered-load instrument
  VERDICT round 6 asked for.
- :func:`serve_doc` / :func:`main` — ``paddle serve-report <run_dir>``:
  a jax-free per-rung table (p50/p99 latency, TTFT, queue-wait share,
  batch occupancy, goodput) that joins the serving launch group's PR-7
  ``compile``/``roofline`` records, so each rung also says whether
  decode was dispatch-, compute-, memory-, or host-bound — and whether
  pad-to-signature held (recompiles after warmup must be 0).

jax-free by construction: the driver takes an injected ``launch_fn``
(bench.py supplies the jitted generator forward), and the analyzer must
run on a dev box against a run dir copied off a pod.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import itertools
import json
import os
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from paddle_tpu_torch.observability import metrics as obs
# one data-bound threshold for every analyzer (see analyze.py, already
# a module-level dependency — the analyzer entry points below reuse it)
from paddle_tpu_torch.observability.analyze import (
    DATA_BOUND_SHARE,
    analyze,
    load_run,
)

# the launch-group name the serving front registers with CompileRegistry
# — serve-report joins compile/roofline records on it
SERVE_GROUP = "serve_gen"

# every serving launch group serve-report joins: the PR-8 static
# engine's one-shot generation launch, the continuous engine's
# decode/prefill pair, and the PR-20 speculative verify launch
# (paddle_tpu/serving/jax_backend.py) — all held to the same
# recompiles=0-after-warmup contract
SERVE_GROUPS = (SERVE_GROUP, "serve_decode", "serve_prefill",
                "serve_verify")

# mean exec seconds per launch at or below which a rung is classified
# dispatch-bound: the launch is latency-floor sized (per-launch dispatch
# overhead ~1-3ms through the runtime — doc/performance.md "Fused
# launches"), so wider batching, not a kernel fix, is the lever
DISPATCH_FLOOR_S = 3e-3

# a rung saturates when it completes less than this share of arrivals,
# or its p99 latency exceeds KNEE_P99_FACTOR x the lightest rung's p99
KNEE_COMPLETION = 0.99
KNEE_P99_FACTOR = 5.0

_oneshot_cohorts = itertools.count()


# ------------------------------------------------------------- schedule


def arrival_offsets(n: int, rate_rps: float, seed: int) -> np.ndarray:
    """``n`` Poisson-process arrival offsets (seconds from rung start) at
    ``rate_rps`` offered load — exponential inter-arrivals, precomputed
    from ``seed``. The schedule never reads a clock: determinism tests
    pin that the same seed reproduces it exactly."""
    assert rate_rps > 0, rate_rps
    rng = np.random.RandomState(seed)
    return np.cumsum(rng.exponential(1.0 / rate_rps, size=int(n)))


# -------------------------------------------------------------- request


@dataclasses.dataclass
class Request:
    """One request's lifecycle. Offsets are VIRTUAL seconds from rung
    start for the PR-8 static driver (the envelope ``t`` stays the
    writer's monotonic offset); the continuous engine stamps real
    wall-clock offsets from its window start. ``t_first_token`` differs
    from ``t_finish`` only under per-step decode — single-shot launches
    materialize the whole output at once and leave it unset (-1 →
    first-token == finish in the emitted record). ``max_new`` is the
    client's output-token budget (None = the graph's max_length)."""

    rid: str
    t_enqueue: float
    prompt: Any = None
    prompt_tokens: int = 0
    t_admit: float = -1.0
    t_first_token: float = -1.0
    t_finish: float = -1.0
    gen_tokens: int = 0
    cohort: int = -1
    cohort_size: int = 0
    outcome: str = "pending"
    max_new: Optional[int] = None
    # distributed-tracing join key (doc/observability.md "Distributed
    # tracing"): opaque, echoed verbatim onto every emitted record as
    # `trace_id`. "" = untraced (single-process runs stay unchanged)
    trace: str = ""

    @property
    def queue_wait_s(self) -> Optional[float]:
        return None if self.t_admit < 0 else self.t_admit - self.t_enqueue

    @property
    def e2e_s(self) -> Optional[float]:
        return None if self.t_finish < 0 else self.t_finish - self.t_enqueue


class RequestLog:
    """Emit ``kind=request`` records and accumulate one window's rollup.

    One instance per rung (or per fixed window within a rung, when the
    caller chooses to cut finer). Histograms are the streaming geometric
    kind from metrics.py — p50/p99 without storing samples."""

    def __init__(self, rung: int = 0, offered_rps: float = 0.0,
                 beam_size: Optional[int] = None, engine: str = "static",
                 pipeline: Optional[str] = None, replica: str = "",
                 spec: Optional[str] = None,
                 slot_dtype: Optional[str] = None):
        self.rung = int(rung)
        self.offered_rps = float(offered_rps)
        self.beam_size = beam_size
        # which serving engine produced this window: "static" (the PR-8
        # run-to-completion micro-batch driver / single-shot generate)
        # or "continuous" (paddle_tpu/serving slot-based decode) —
        # stamped on every request and serve_window record so `paddle
        # compare` never joins rungs across engines by accident
        self.engine = str(engine)
        # "on" | "off": whether the continuous engine ran the pipelined
        # dispatch/collect loop — part of the compare join key ((engine,
        # pipeline, offered load)) so a one-dir pipelined-vs-blocking
        # A/B keeps both ladders apart. None (the static driver) leaves
        # the field off the records
        self.pipeline = None if pipeline is None else str(pipeline)
        # fleet identity ("" outside a fleet): which replica's engine
        # produced this window — keeps N replicas' records apart in one
        # stream; the MERGED fleet window instead carries `replicas=N`
        # (serving/fleet.py merge_windows)
        self.replica = str(replica)
        # self-speculative decode config stamps (PR 20): `spec` is the
        # draft-length ladder spelling ("4", "2,4") or "off" when the
        # continuous engine's backend takes drafts but the ladder is
        # empty; `slot_dtype` is the slot-state storage dtype
        # ("f32"/"bf16"). Both None outside the continuous engine —
        # the fields stay off static-driver records entirely. Part of
        # the compare rung join, like `pipeline`.
        self.spec = None if spec is None else str(spec)
        self.slot_dtype = None if slot_dtype is None else str(slot_dtype)
        # draft tokens proposed / accepted across the window's verify
        # launches — accept_rate on the window record, plus the
        # cumulative serve.spec_proposed / serve.spec_accepted counters
        self.spec_proposed = 0
        self.spec_accepted = 0
        # host seconds spent scheduling while a decode launch was in
        # flight (the pipelined loop's dispatch->collect-entry gaps)
        self.overlap_s = 0.0
        self.latency = obs.Histogram("latency_s")
        self.ttft = obs.Histogram("ttft_s")
        self.queue_wait = obs.Histogram("queue_wait_s")
        self.queue_depth = obs.Histogram("queue_depth")
        self.occupancy = obs.Histogram("batch_occupancy")
        self.arrived = 0
        self.admitted = 0
        self.completed = 0
        self.rejected = 0
        self.timeouts = 0
        self.cancels = 0
        self.errors = 0
        self.sheds = 0
        self.breaker_opens = 0
        self.launches = 0
        self.exec_s = 0.0
        self.gen_tokens = 0
        self._wait_ok_s = 0.0
        self._e2e_ok_s = 0.0

    # ------------------------------------------------------- lifecycle

    def _emit(self, req: Request, **extra) -> None:
        rec: Dict[str, Any] = {
            "id": req.rid,
            "rung": self.rung,
            "engine": self.engine,
            "outcome": req.outcome,
            **({"pipeline": self.pipeline} if self.pipeline is not None
               else {}),
            **({"replica": self.replica} if self.replica else {}),
            "t_enqueue": round(req.t_enqueue, 6),
            "prompt_tokens": int(req.prompt_tokens),
        }
        if req.trace:
            rec["trace_id"] = req.trace
        if self.beam_size is not None:
            rec["beam_size"] = int(self.beam_size)
        if req.cohort >= 0:
            rec["cohort"] = req.cohort
            rec["cohort_size"] = req.cohort_size
        if req.t_admit >= 0:
            rec["t_admit"] = round(req.t_admit, 6)
            rec["queue_wait_s"] = round(req.queue_wait_s, 6)
        if req.t_finish >= 0:
            # single-shot decode materializes the whole output with the
            # launch, so first-token == finish there (t_first_token
            # unset); the continuous engine stamps the REAL wall-clock
            # moment its first token left the device mid-sequence
            tft = req.t_first_token if req.t_first_token >= 0 else req.t_finish
            rec["t_first_token"] = round(tft, 6)
            rec["t_finish"] = round(req.t_finish, 6)
            rec["ttft_s"] = round(tft - req.t_enqueue, 6)
            rec["decode_s"] = round(req.t_finish - req.t_admit, 6)
            rec["e2e_s"] = round(req.e2e_s, 6)
            rec["gen_tokens"] = int(req.gen_tokens)
        rec.update(extra)
        obs.emit("request", **rec)

    def reject(self, req: Request, arrived: bool = False) -> None:
        """Admission refused. At submit time the request was never
        enqueued — count its arrival here; a drain-path rejection of an
        ALREADY-enqueued request passes ``arrived=True`` (its arrival
        was counted by :meth:`enqueued` — double-counting would inflate
        the window's completed/arrived ratios)."""
        req.outcome = "rejected"
        if not arrived:
            self.arrived += 1
        self.rejected += 1
        obs.registry().counter("serve.rejected").inc()
        self._emit(req)

    def timeout(self, req: Request, vnow: float) -> None:
        """Past the wall deadline: queued (never admitted) or — under
        the continuous engine — mid-decode, freeing the slot at the next
        iteration boundary."""
        req.outcome = "timeout"
        self.timeouts += 1
        obs.registry().counter("serve.timeouts").inc()
        self._emit(req, queue_wait_s=round(vnow - req.t_enqueue, 6))

    def cancel(self, req: Request, vnow: float) -> None:
        """Client cancellation, applied at an iteration boundary —
        frees the queue entry or the decode slot (continuous engine)."""
        req.outcome = "cancelled"
        self.cancels += 1
        obs.registry().counter("serve.cancelled").inc()
        self._emit(req, t_cancel=round(vnow, 6))

    def error(self, req: Request, service_s: Optional[float] = None,
              **extra) -> None:
        """Failed launch/forward. ``service_s`` (time spent before the
        failure) rides the record — how long the failing call took is
        exactly the evidence an error record exists for."""
        req.outcome = "error"
        self.errors += 1
        obs.registry().counter("serve.errors").inc()
        if service_s is not None:
            extra["service_s"] = round(float(service_s), 6)
        self._emit(req, **extra)

    def shed(self, req: Request, vnow: float, arrived: bool = False,
             retry_after_s: Optional[float] = None) -> None:
        """Overload shedding (doc/resilience.md "Serving resilience"):
        the server refused this request as a POLICY decision — brownout
        pressure, an open launch-failure breaker, or a deadline the
        admission estimate proves unmeetable — distinct from
        ``rejected`` (a hard structural bound: queue cap, draining).
        The answer lands within one collect boundary instead of the
        client waiting out its own timeout; ``retry_after_s`` hints
        when capacity is expected back. ``arrived`` mirrors
        :meth:`reject`'s double-count rule for already-enqueued sheds."""
        req.outcome = "shed"
        if not arrived:
            self.arrived += 1
        self.sheds += 1
        obs.registry().counter("serve.shed").inc()
        extra: Dict[str, Any] = {"t_shed": round(vnow, 6)}
        if retry_after_s is not None:
            extra["retry_after_s"] = round(float(retry_after_s), 3)
        self._emit(req, **extra)

    def note_breaker_open(self) -> None:
        """The launch-failure circuit breaker opened (consecutive
        collect faults hit its threshold) during this window."""
        self.breaker_opens += 1
        obs.registry().counter("serve.breaker_opened").inc()

    def enqueued(self, req: Request) -> None:
        self.arrived += 1
        obs.registry().counter("serve.enqueued").inc()

    def admit(self, req: Request) -> None:
        """The request joined a launch cohort — only now is it admitted
        (a queued request that times out first never was)."""
        self.admitted += 1
        obs.registry().counter("serve.admitted").inc()

    def launch(self, depth_after: int, occupancy: int, service_s: float) -> None:
        """One micro-batch launch: queue depth left behind, cohort size,
        measured service seconds."""
        self.launches += 1
        self.exec_s += float(service_s)
        self.queue_depth.observe(float(depth_after))
        self.occupancy.observe(float(occupancy))
        r = obs.registry()
        r.gauge("serve.queue_depth").set(depth_after)
        r.histogram("serve.batch_occupancy").observe(float(occupancy))

    def note_exec(self, service_s: float) -> None:
        """Device seconds outside :meth:`launch` (the continuous
        engine's prefill writes) — keeps ``host_share`` honest."""
        self.exec_s += float(service_s)

    def note_overlap(self, seconds: float) -> None:
        """Host seconds that ran concurrently with an in-flight launch
        (pipelined loop: dispatch to collect-entry). Rides the window
        record and the cumulative ``serve.overlap_s`` counter — the
        direct measure of what the dispatch/collect split bought."""
        s = max(float(seconds), 0.0)
        self.overlap_s += s
        obs.registry().counter("serve.overlap_s").inc(s)

    def note_spec(self, proposed: int, accepted: int) -> None:
        """One verify launch's draft outcome: ``proposed`` draft tokens
        offered across all live slots, ``accepted`` the sum of common-
        prefix matches the launch committed. Rides the window record
        as ``accept_rate`` and the cumulative ``serve.spec_proposed`` /
        ``serve.spec_accepted`` counters."""
        p = max(int(proposed), 0)
        a = max(int(accepted), 0)
        self.spec_proposed += p
        self.spec_accepted += a
        obs.registry().counter("serve.spec_proposed").inc(p)
        obs.registry().counter("serve.spec_accepted").inc(a)

    def note_dispatch(self, depth: int) -> None:
        """Launches dispatched but not yet collected (``serve.
        dispatch_depth`` gauge): 0 = the serial loop's steady state,
        >=1 = the device has queued work while the host schedules."""
        obs.registry().gauge("serve.dispatch_depth").set(int(depth))

    def complete(self, req: Request, **extra) -> None:
        req.outcome = "ok"
        self.completed += 1
        self.gen_tokens += int(req.gen_tokens)
        self.latency.observe(req.e2e_s)
        tft = req.t_first_token if req.t_first_token >= 0 else req.t_finish
        self.ttft.observe(tft - req.t_enqueue)
        self.queue_wait.observe(req.queue_wait_s)
        self._wait_ok_s += req.queue_wait_s
        self._e2e_ok_s += req.e2e_s
        obs.registry().counter("serve.completed").inc()
        self._emit(req, **extra)

    # ---------------------------------------------------------- window

    def window_record(self, window_s: float,
                      host_share: Optional[float] = None) -> Dict[str, Any]:
        """Emit the ``kind=serve_window`` rollup and return it (sans
        envelope) — the same dict the bench headline and serve-report
        render, so text and telemetry cannot drift."""
        window_s = max(float(window_s), 1e-9)
        rec: Dict[str, Any] = {
            "rung": self.rung,
            "engine": self.engine,
            "offered_rps": round(self.offered_rps, 6),
            "window_s": round(window_s, 6),
            "arrived": self.arrived,
            "admitted": self.admitted,
            "completed": self.completed,
            "rejected": self.rejected,
            "timeouts": self.timeouts,
            "cancelled": self.cancels,
            "errors": self.errors,
            "shed": self.sheds,
            "breaker_open": self.breaker_opens,
            "launches": self.launches,
            "exec_s": round(self.exec_s, 6),
            "gen_tokens": self.gen_tokens,
            "goodput_tok_s": round(self.gen_tokens / window_s, 3),
            "completed_rps": round(self.completed / window_s, 6),
            "latency": self.latency.snapshot(),
            "ttft": self.ttft.snapshot(),
            "queue_wait": self.queue_wait.snapshot(),
            "queue_depth": self.queue_depth.snapshot(),
            "occupancy": self.occupancy.snapshot(),
        }
        if self.beam_size is not None:
            rec["beam_size"] = int(self.beam_size)
        if self.pipeline is not None:
            rec["pipeline"] = self.pipeline
        if self.replica:
            rec["replica"] = self.replica
        if self.spec is not None:
            rec["spec"] = self.spec
        if self.slot_dtype is not None:
            rec["slot_dtype"] = self.slot_dtype
        if self.spec_proposed > 0:
            rec["spec_proposed"] = self.spec_proposed
            rec["spec_accepted"] = self.spec_accepted
            rec["accept_rate"] = round(
                self.spec_accepted / self.spec_proposed, 4)
        if self.overlap_s > 0:
            rec["overlap_s"] = round(self.overlap_s, 6)
        if self._e2e_ok_s > 0:
            rec["queue_wait_share"] = round(self._wait_ok_s / self._e2e_ok_s, 4)
        if host_share is not None:
            rec["host_share"] = round(host_share, 4)
        obs.emit("serve_window", **rec)
        return rec


def log_oneshot(prompt_tokens: Sequence[int], gen_tokens: Sequence[int],
                service_s: float, beam_size: Optional[int] = None,
                outcome: str = "ok", n: Optional[int] = None,
                cold_start: bool = False) -> None:
    """Request records for one single-shot generate() call (the embedding
    API's ``SequenceGenerator``): the whole call is one cohort, every
    sample one request with zero queue wait. ``n`` overrides the sample
    count when ``prompt_tokens`` is incomplete (a dense-only feed on the
    error path — the evidence must still land). ``cold_start=True``
    marks records whose call paid the jit trace+compile — the user DID
    wait that long, but aggregations must be able to split compile cost
    from steady-state decode latency. No-op when telemetry is off —
    call sites never guard."""
    if not obs.enabled():
        return
    cohort = next(_oneshot_cohorts)
    log = RequestLog(rung=-1, beam_size=beam_size)
    n = len(prompt_tokens) if n is None else max(int(n), 1)
    # pid-scoped ids: a relaunched process restarts the cohort counter,
    # and its requests are NEW ones — they must not collide with a
    # previous incarnation's ids in the same stream (the analyzer
    # dedupes request records by (host, id))
    pid = os.getpid()
    for i in range(n):
        req = Request(
            rid=f"gen{pid}-{cohort}-{i}", t_enqueue=0.0,
            prompt_tokens=(int(prompt_tokens[i])
                           if i < len(prompt_tokens) else 0),
            t_admit=0.0, cohort=cohort, cohort_size=n,
        )
        log.enqueued(req)
        log.admit(req)
        extra = {"cold_start": True} if cold_start else {}
        if outcome == "ok":
            req.t_finish = float(service_s)
            req.gen_tokens = int(gen_tokens[i]) if i < len(gen_tokens) else 0
            log.complete(req, **extra)
        else:
            log.error(req, service_s=service_s, **extra)


# --------------------------------------------------------------- driver


def schedule_requests(
    rate_rps: float,
    n_requests: int,
    seed: int,
    rung: int = 0,
    prompt_fn: Optional[Callable[[np.random.RandomState, int], Sequence[int]]] = None,
    budget_fn: Optional[Callable[[np.random.RandomState, int], int]] = None,
) -> List[Request]:
    """The ONE workload builder both serving engines consume: arrival
    offsets, prompts and per-request output budgets are all drawn from
    the rung's seeded rngs in a fixed order, so the static driver and
    the continuous engine (bench.py serve --engine=...) face the SAME
    requests bit-for-bit — the A/B's whole validity. ``budget_fn(rng,
    i)`` caps request ``i``'s generated tokens (``max_new``); None
    leaves the graph's max_length in charge."""
    arrivals = arrival_offsets(n_requests, rate_rps, seed)
    rng = np.random.RandomState(seed + 0x5EED)
    requests: List[Request] = []
    for i in range(n_requests):
        prompt = list(prompt_fn(rng, i)) if prompt_fn is not None else None
        max_new = int(budget_fn(rng, i)) if budget_fn is not None else None
        requests.append(Request(
            rid=f"r{rung}-{i}", t_enqueue=float(arrivals[i]),
            prompt=prompt, prompt_tokens=len(prompt) if prompt else 0,
            max_new=max_new,
        ))
    return requests


def run_rung(
    launch_fn: Callable[[List[Request]], Tuple[Sequence[int], Optional[float]]],
    *,
    rate_rps: float,
    n_requests: int,
    seed: int,
    rung: int = 0,
    max_batch: int = 8,
    timeout_s: float = 60.0,
    queue_cap: int = 0,
    beam_size: Optional[int] = None,
    prompt_fn: Optional[Callable[[np.random.RandomState, int], Sequence[int]]] = None,
    budget_fn: Optional[Callable[[np.random.RandomState, int], int]] = None,
    engine: str = "static",
) -> Tuple[Dict[str, Any], List[Request]]:
    """One offered-load rung: open-loop arrivals at ``rate_rps``, a
    dynamic micro-batch aggregator admitting up to ``max_batch`` queued
    requests per launch (FIFO), virtual-clock accounting.

    ``launch_fn(cohort)`` serves a cohort (padding to its fixed
    signature is the callee's job) and returns ``(gen_token_counts,
    service_s)`` — ``service_s=None`` means "time me" (the real bench
    path); an injected value makes the whole rung deterministic (tests).
    ``prompt_fn(rng, i)`` materializes request ``i``'s prompt ids from
    the rung's seeded rng, so request content is part of the schedule.
    ``queue_cap`` rejects arrivals past the bound (0 = unbounded);
    ``timeout_s`` drops queued requests never admitted in time. Both
    policies are evaluated at launch boundaries in virtual time, so the
    admitted-cohort assignment is a pure function of (seed, service
    times). ``budget_fn`` assigns per-request output budgets
    (mixed-length workloads): run-to-completion launches still PAY the
    graph's full max_length — that honesty is the continuous engine's
    A/B case — so the budget only caps the tokens counted as delivered
    (launch_fn's job, reading ``req.max_new``)."""
    requests = schedule_requests(rate_rps, n_requests, seed, rung=rung,
                                 prompt_fn=prompt_fn, budget_fn=budget_fn)
    arrivals = [r.t_enqueue for r in requests]
    log = RequestLog(rung=rung, offered_rps=rate_rps, beam_size=beam_size,
                     engine=engine)
    # deque: a saturated unbounded queue reaches tens of thousands of
    # entries, and list.pop(0) purges would go quadratic — host time
    # that would then be charged to host_share
    queue: collections.deque = collections.deque()
    i_next = 0
    vnow = 0.0
    cohort_id = 0
    wall_t0 = time.perf_counter()

    while i_next < n_requests or queue:
        if not queue:
            # idle server: jump the virtual clock to the next arrival —
            # no sleeping, low offered loads cost nothing to sweep
            vnow = max(vnow, requests[i_next].t_enqueue)
        while i_next < n_requests and requests[i_next].t_enqueue <= vnow:
            req = requests[i_next]
            i_next += 1
            # entries that expired BEFORE this arrival left the queue
            # first in the modeled server — purge them before judging
            # the cap, or a dead entry could cause a spurious rejection
            while queue and req.t_enqueue - queue[0].t_enqueue > timeout_s:
                log.timeout(queue.popleft(), req.t_enqueue)
            if queue_cap and len(queue) >= queue_cap:
                log.reject(req)
            else:
                queue.append(req)
                log.enqueued(req)
        # drop queued requests past their admission deadline (FIFO, so
        # the oldest are at the front)
        while queue and vnow - queue[0].t_enqueue > timeout_s:
            log.timeout(queue.popleft(), vnow)
        if not queue:
            continue
        cohort = [queue.popleft() for _ in range(min(max_batch, len(queue)))]
        t_admit = vnow
        for req in cohort:
            log.admit(req)
        wall_launch = time.perf_counter()
        try:
            gen_counts, service_s = launch_fn(cohort)
        except Exception:
            # a failed launch must not take its cohort's evidence with
            # it: terminal error records (with the time the failing
            # launch burned) and the partial window land before the
            # re-raise
            failed_s = time.perf_counter() - wall_launch
            for j, req in enumerate(cohort):
                req.t_admit = t_admit
                req.cohort = cohort_id
                req.cohort_size = len(cohort)
                log.error(req, service_s=failed_s)
            wall_s = time.perf_counter() - wall_t0
            log.window_record(
                max(vnow, 1e-9),
                host_share=(max(1.0 - log.exec_s / wall_s, 0.0)
                            if wall_s > 0 else None),
            )
            raise
        if service_s is None:
            service_s = time.perf_counter() - wall_launch
        vnow += float(service_s)
        log.launch(len(queue), len(cohort), service_s)
        for j, req in enumerate(cohort):
            req.t_admit = t_admit
            req.t_finish = vnow
            req.cohort = cohort_id
            req.cohort_size = len(cohort)
            req.gen_tokens = int(gen_counts[j]) if j < len(gen_counts) else 0
            log.complete(req)
        cohort_id += 1

    wall_s = time.perf_counter() - wall_t0
    # host share: wall time the serve loop spent OUTSIDE launches
    # (padding, bookkeeping, record emission) — measured for real, the
    # serve analog of the trainer's data-wait share
    host_share = max(1.0 - log.exec_s / wall_s, 0.0) if wall_s > 0 else None
    window_s = max(vnow, float(arrivals[-1]) if n_requests else 0.0)
    summary = log.window_record(window_s, host_share=host_share)
    return summary, requests


def run_sweep(
    launch_fn, rates: Sequence[float], *, n_requests: int, seed: int, **kw
) -> Dict[str, Any]:
    """Sweep offered-load rungs (one :func:`run_rung` each, seeded
    ``seed + rung`` so schedules differ but reproduce) and locate the
    saturation knee."""
    rungs = []
    for i, rate in enumerate(rates):
        summary, _ = run_rung(
            launch_fn, rate_rps=float(rate), n_requests=n_requests,
            seed=seed + i, rung=i, **kw,
        )
        rungs.append(summary)
    return {"rungs": rungs, "knee_rps": saturation_knee(rungs)}


def saturation_knee(rungs: List[Dict[str, Any]]) -> Optional[float]:
    """Highest offered load the server still *keeps up with*: completes
    ≥ 99% of arrivals AND p99 latency stays within 5x the lightest
    rung's p99 (queueing, not service, is what explodes past the knee).
    CONTIGUOUS from the lightest rung — the scan stops at the first
    saturated rung, so a later rung that happens to pass (sampling
    luck) can never overstate capacity above a demonstrated failure.
    None when even the lightest rung saturates."""
    if not rungs:
        return None
    ordered = sorted(rungs, key=lambda r: r.get("offered_rps", 0.0))
    base_p99 = (ordered[0].get("latency") or {}).get("p99") or 0.0
    knee = None
    for r in ordered:
        arrived = r.get("arrived", 0)
        done_share = r.get("completed", 0) / arrived if arrived else 0.0
        p99 = (r.get("latency") or {}).get("p99") or 0.0
        if done_share < KNEE_COMPLETION or (
            base_p99 > 0 and p99 > KNEE_P99_FACTOR * base_p99
        ):
            break
        knee = r.get("offered_rps")
    return knee


# ------------------------------------------------------- serve-report


def classify_rung(window: Dict[str, Any],
                  roof_row: Optional[Dict[str, Any]]) -> str:
    """What bounded decode this rung: ``host-bound`` (the serve loop
    spent most wall time outside launches), ``dispatch-bound`` (launches
    are latency-floor sized — batch wider), else the roofline bucket
    (compute-/memory-bound from XLA intensity vs the chip's ridge
    point; ``unknown`` is never guessed)."""
    if (window.get("host_share") or 0.0) > DATA_BOUND_SHARE:
        return "host-bound"
    launches = window.get("launches", 0)
    if launches and window.get("exec_s", 0.0) / launches <= DISPATCH_FLOOR_S:
        return "dispatch-bound"
    if roof_row is not None:
        from paddle_tpu_torch.observability.costs import classify

        return classify(roof_row.get("intensity"),
                        roof_row.get("device_kind", ""))
    return "unknown"


def _last_epoch(streams: Dict[int, List[Dict[str, Any]]]) -> Dict[int, List[Dict[str, Any]]]:
    """Each host's records from its LAST ``run_start`` on — the epoch
    the analyzer's serve reset keeps. The compile/roofline joins must
    use the same cut, or a previous sweep's recompile (or stale-sig
    roofline row) would haunt every clean rerun in a reused dir."""
    out: Dict[int, List[Dict[str, Any]]] = {}
    for host, recs in streams.items():
        start = 0
        for i, rec in enumerate(recs):
            if rec.get("kind") == "run_start":
                start = i
        out[host] = recs[start:]
    return out


def serve_doc(streams: Dict[int, List[Dict[str, Any]]]) -> Dict[str, Any]:
    """The serve-report analysis document: deduped serve windows (the
    analyzer's latest-wins policy), the serve launch group's compile and
    roofline joins (last epoch only), and a per-rung bound
    classification."""
    from paddle_tpu_torch.observability.costs import roofline_rows

    doc = analyze(streams)
    windows = doc.get("serve_windows") or []
    epoch = _last_epoch(streams)
    serve_compiles = [
        rec
        for host in sorted(epoch)
        for rec in epoch[host]
        if rec.get("kind") == "compile" and rec.get("group") in SERVE_GROUPS
    ]
    # the decode-side group drives the bound classification: serve_gen
    # for static runs, serve_decode for engine runs (prefill rides as a
    # second compile line but isn't the steady-state launch)
    rows = roofline_rows(epoch)
    roof = next(
        (r for g in (SERVE_GROUP, "serve_decode") for r in rows
         if r.get("group") == g),
        None,
    )
    rungs = []
    for w in sorted(windows, key=lambda w: w.get("rung", 0)):
        rungs.append(dict(w, bound=classify_rung(w, roof)))
    recompiles = max(
        (int(c.get("recompiles", 0)) for c in serve_compiles), default=0
    )
    return {
        "rungs": rungs,
        "knee_rps": saturation_knee(windows),
        "engines": sorted({w.get("engine", "static") for w in windows}),
        "pipelines": sorted({w["pipeline"] for w in windows
                             if isinstance(w.get("pipeline"), str)}),
        "groups": sorted({c.get("group") for c in serve_compiles}),
        "requests": (doc.get("serve") or {}).get("requests", 0),
        "compiles": len(serve_compiles),
        "recompiles": recompiles,
        "roofline": roof,
        "run_ended": doc.get("run_ended", False),
        "invalid_records": doc.get("invalid_records", 0),
    }


def _q(snap: Optional[Dict[str, Any]], key: str) -> Optional[float]:
    v = (snap or {}).get(key)
    return float(v) if isinstance(v, (int, float)) else None


def format_report(doc: Dict[str, Any]) -> str:
    lines = [
        f"{'rung':>4} {'offered r/s':>11} {'reqs':>5} {'ok':>5} {'rej':>4} "
        f"{'shed':>4} {'t/o':>4} {'err':>4} {'p50 ms':>8} {'p99 ms':>8} "
        f"{'ttft p50':>8} {'ttft p99':>8} {'q-wait':>6} {'occ':>5} "
        f"{'accept':>6} {'goodput tok/s':>13} {'bound':>14}"
    ]
    for r in doc["rungs"]:
        p50 = _q(r.get("latency"), "p50")
        p99 = _q(r.get("latency"), "p99")
        t50 = _q(r.get("ttft"), "p50")
        t99 = _q(r.get("ttft"), "p99")
        occ = _q(r.get("occupancy"), "mean")
        acc = r.get("accept_rate")
        acc_s = f"{float(acc) * 100:>5.1f}%" if acc is not None else f"{'-':>6}"
        lines.append(
            f"{r.get('rung', 0):>4} {r.get('offered_rps', 0.0):>11.2f} "
            f"{r.get('arrived', 0):>5} {r.get('completed', 0):>5} "
            f"{r.get('rejected', 0):>4} {r.get('shed', 0):>4} "
            f"{r.get('timeouts', 0):>4} {r.get('errors', 0):>4} "
            f"{(p50 or 0.0) * 1e3:>8.2f} {(p99 or 0.0) * 1e3:>8.2f} "
            f"{(t50 or 0.0) * 1e3:>8.2f} {(t99 or 0.0) * 1e3:>8.2f} "
            f"{(r.get('queue_wait_share') or 0.0) * 100:>5.1f}% "
            f"{occ or 0.0:>5.2f} {acc_s} "
            f"{r.get('goodput_tok_s', 0.0):>13.1f} "
            f"{r.get('bound', 'unknown'):>14}"
        )
    lines.append("")
    knee = doc.get("knee_rps")
    lines.append(
        "saturation knee: "
        + (f"{knee:.2f} req/s (highest offered load completing "
           f"≥{KNEE_COMPLETION:.0%} of arrivals within "
           f"{KNEE_P99_FACTOR:g}x the lightest rung's p99)"
           if knee is not None else
           "none — every rung saturated (offered loads all exceed capacity)")
    )
    opens = sum(int(r.get("breaker_open", 0) or 0) for r in doc["rungs"])
    if opens:
        lines.append(
            f"! launch-failure breaker opened {opens} time(s) — cohorts "
            "were shed fast during the cooldown(s) (doc/resilience.md "
            "\"Serving resilience\")"
        )
    groups = ", ".join(doc.get("groups") or [SERVE_GROUP])
    engines = doc.get("engines") or []
    if engines and engines != ["static"]:
        lines.append(f"engine: {', '.join(engines)}")
    pipelines = doc.get("pipelines") or []
    if pipelines:
        lines.append(f"pipelined decode: {', '.join(pipelines)}")
    proposed = sum(int(r.get("spec_proposed", 0) or 0) for r in doc["rungs"])
    if proposed:
        accepted = sum(int(r.get("spec_accepted", 0) or 0)
                       for r in doc["rungs"])
        specs = sorted({str(r["spec"]) for r in doc["rungs"]
                        if r.get("spec") not in (None, "off")})
        lines.append(
            f"speculative decode: ladder {', '.join(specs) or '?'} — "
            f"{accepted}/{proposed} draft tokens accepted "
            f"({accepted / proposed:.1%})"
        )
    dtypes = sorted({str(r["slot_dtype"]) for r in doc["rungs"]
                     if isinstance(r.get("slot_dtype"), str)})
    if dtypes and dtypes != ["f32"]:
        lines.append(f"slot state dtype: {', '.join(dtypes)}")
    lines.append(
        f"{groups or SERVE_GROUP}: {doc['compiles']} compile(s), "
        f"recompiles after warmup: {doc['recompiles']}"
        + ("" if doc["recompiles"] == 0 else
           "  ! signature instability — pad-to-signature is broken, every "
           "recompile stalls serving")
    )
    roof = doc.get("roofline")
    if roof:
        parts = [f"{roof.get('launches', 0)} launch(es)",
                 f"exec {roof.get('exec_s', 0.0):.3f}s"]
        if roof.get("intensity") is not None:
            parts.append(f"intensity {roof['intensity']:.2f} FLOP/B")
        lines.append(f"{roof.get('group', SERVE_GROUP)} roofline: "
                     + ", ".join(parts))
    if doc.get("invalid_records"):
        lines.append(f"! {doc['invalid_records']} record(s) failed schema "
                     "validation")
    if not doc.get("run_ended"):
        lines.append("! stream ends without run_end — the serve run crashed "
                     "or is still going")
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="paddle serve-report",
        description="per-offered-load serving report from a run's "
                    "request/serve_window telemetry (doc/observability.md "
                    "\"Serving telemetry\")",
    )
    p.add_argument("run_dir", help="run dir (or one metrics*.jsonl file)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="emit the analysis as JSON")
    args = p.parse_args(argv)

    files = obs.metrics_files(args.run_dir)
    if not files:
        print(f"no metrics*.jsonl under {args.run_dir!r} "
              "(was this dir produced by `bench.py serve`?)", file=sys.stderr)
        return 1
    doc = serve_doc(load_run(args.run_dir))
    if not doc["rungs"]:
        print("no serve_window records in this run's telemetry (not a "
              "serve run? `paddle metrics` reads training runs)",
              file=sys.stderr)
        return 1
    if args.as_json:
        print(json.dumps(doc, indent=2, default=str))
    else:
        print(f"# serve-report: {', '.join(files)}")
        print(format_report(doc))
    return 0


if __name__ == "__main__":
    sys.exit(main())
