"""Metrics registry + per-host append-only ``metrics.jsonl`` writer.

Three metric kinds (the prometheus trinity, host-side only):

- :class:`Counter` — monotonically increasing float/int.
- :class:`Gauge` — last-write-wins value.
- :class:`Histogram` — streaming quantiles (p50/p99) WITHOUT storing
  samples: geometric buckets (relative width ``growth - 1``), so memory
  is O(distinct magnitudes) and a quantile is a cumulative walk with
  linear interpolation inside the winning bucket. Quantile error is
  bounded by the bucket width (~5% relative by default) — see
  tests/test_stats.py which pins it against ``np.percentile``.

The writer appends schema-versioned JSON records to a run-dir scoped
``metrics.jsonl`` (one file per host). Records carry ``step``, ``pass``,
``host`` and a ``t`` wall-time OFFSET (monotonic seconds since the
writer was configured — hot paths never read the wall clock; the
``run_start`` record anchors the offset to civil time once). Records are
buffered and flushed on pass boundaries and atexit/SIGTERM-driven
flush calls, so a hard crash loses at most one window.

Everything here is importable without jax (the supervisor and the
``paddle metrics`` analyzer run when the accelerator runtime is down).
"""

from __future__ import annotations

import atexit
import json
import math
import os
import socket
import threading
from paddle_tpu_torch.utils import concurrency as cc
import time
from typing import Any, Dict, Iterator, List, Optional

from paddle_tpu_torch.utils.logging import logger

SCHEMA_VERSION = 1

# metrics.jsonl for host 0 (the single-host name the tooling documents),
# metrics.host<K>.jsonl for the rest; the analyzer merges metrics*.jsonl
FILE_FMT_HOST0 = "metrics.jsonl"
FILE_FMT = "metrics.host%d.jsonl"

# record kinds that force a flush when emitted: each marks a window
# boundary after which losing the buffer would lose a whole window
# (request/serve_window: a serving run killed mid-rung must leave every
# finished request's latency on disk — the whole point of the records.
# The per-record append this buys costs ~tens of µs and is charged,
# honestly, to the serve loop's host_share; telemetry-off pays nothing).
# Historical note: a "crash" kind rode here for five PRs without any
# emitter — the supervisor writes crash_report.json, not a record —
# and was removed when `paddle lint` (PTL007) flagged the drift.
# `memory` rides here (pass boundaries only) and `oom` MUST (the
# process dies right after — same evidence-before-death rule as fault/
# hang); `numerics` deliberately does NOT: at --numerics_log_period=1
# it is a per-batch kind like train_window, and a forced flush per
# record would put file I/O back on the hot step loop. Its crash
# durability is handled at the events that matter — the nonfinite
# handler emits the health table alongside its (soon-flushed) evidence,
# and ordinary aborts reach the atexit flush.
FLUSH_KINDS = frozenset(
    {"run_start", "run_end", "pass_end", "checkpoint",
     "barrier_skew", "restart", "compile", "roofline",
     "request", "serve_window", "memory", "oom", "reload", "sparse",
     "span"}
)

# required keys of every record; kind-specific fields ride alongside
REQUIRED_KEYS = ("v", "kind", "host", "t")

# Kind-specific required fields, one entry per documented record kind
# (doc/observability.md "Record kinds") — `paddle lint` rule PTL007
# keeps this registry, the doc table, and the emit call sites in sync:
# an emitted kind missing here (or documented here but emitted nowhere)
# is a lint finding. An empty tuple means "envelope only"; non-empty
# tuples are the fields without which the record is unanalyzable, and
# validate_record enforces them. `bench` is emitted by bench.py;
# `lint_finding`/`lint_summary` by `paddle lint --json` — both outside
# this package's writer, same schema.
KIND_REQUIRED = {
    "run_start": ("wall_time",),
    "run_end": ("status",),
    "train_window": (),
    "pass_end": (),
    "test": (),
    "checkpoint": ("op",),
    "nonfinite": ("value", "policy"),
    "fault": ("site", "action"),
    "barrier_skew": ("skew_s",),
    "preempt": (),
    "hang": ("age_s",),
    "bench": ("metric", "value"),
    "restart": ("restore_s",),
    "compile": ("group", "sig"),
    "roofline": ("group", "sig"),
    # request/serve_window (observability/serving.py + serving/engine.py):
    # `engine` ("static" | "continuous") keys the compare join — two
    # engines' rungs must never be mistaken for one ladder; request
    # records carry it too (optional pre-PR-12 streams still validate)
    "request": ("id", "outcome"),
    "serve_window": ("rung", "offered_rps", "engine"),
    # hot weight reload (serving/engine.py _apply_reload_locked): one
    # record per boundary swap — `path` names the checkpoint that went
    # live; rare and load-bearing (the train→serve loop's visible
    # seam), so it rides FLUSH_KINDS
    "reload": ("path",),
    # memory plane (observability/memory.py): host_rss_bytes is the one
    # field every backend can supply — hbm_* fields are present exactly
    # when the allocator reports stats (None on the CPU backend)
    "memory": ("host_rss_bytes",),
    # numerics plane (observability/numerics.py): the per-layer health
    # table is the record's whole point
    "numerics": ("layers",),
    # OOM pre-mortem: flushed before the death, like fault/hang
    "oom": ("error", "report"),
    "lint_finding": ("rule", "path", "line"),
    "lint_summary": ("findings", "counts"),
    "race_finding": ("detector", "spec"),
    "race_summary": ("findings", "counts"),
    # sparse-table plane (paddle_tpu/sparse/, doc/sparse.md): one
    # record per pass — touched/unique rows, gather/scatter bytes,
    # reshard events; pass boundaries only, so it rides FLUSH_KINDS
    "sparse": ("rows_touched",),
    # distributed tracing (observability/tracing.py, doc/observability.md
    # "Distributed tracing"): one record per hop — `name` is the hop
    # (router.wait, engine.prefill, ...), `t0` the hop's start as a
    # stream-timebase offset, `dur_s` its duration (0.0 = instant);
    # `trace`/`traces` join hops to requests, `span_id`/`parent_id`
    # order them across processes
    "span": ("name", "t0", "dur_s"),
}


# --------------------------------------------------------------- metrics


class Counter:
    """Monotonic accumulator (thread-safe)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = cc.Lock()

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Last-write-wins value (thread-safe by assignment atomicity)."""

    __slots__ = ("name", "_value")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0

    def set(self, v: float) -> None:
        self._value = float(v)

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Streaming histogram with geometric buckets.

    ``observe(v)`` increments the bucket ``ceil(log_g(v / min_value))``;
    ``quantile(q)`` walks the cumulative counts and interpolates
    linearly inside the winning bucket, so p50/p99 come back with
    relative error bounded by ``growth - 1`` without ever storing
    samples. Values below ``min_value`` (including 0 and negatives)
    land in an underflow bucket reported as ``min_value``.
    """

    def __init__(self, name: str, growth: float = 1.05, min_value: float = 1e-6):
        assert growth > 1.0, growth
        self.name = name
        self.growth = growth
        self.min_value = min_value
        self._log_g = math.log(growth)
        self._buckets: Dict[int, int] = {}
        self._count = 0
        self._sum = 0.0
        self._max = -math.inf
        self._min = math.inf
        self._lock = cc.Lock()

    def _index(self, v: float) -> int:
        if v <= self.min_value:
            return 0
        return max(int(math.ceil(math.log(v / self.min_value) / self._log_g)), 0)

    def _upper(self, idx: int) -> float:
        return self.min_value * self.growth ** idx

    def observe(self, v: float) -> None:
        v = float(v)
        idx = self._index(v)
        with self._lock:
            self._buckets[idx] = self._buckets.get(idx, 0) + 1
            self._count += 1
            self._sum += v
            if v > self._max:
                self._max = v
            if v < self._min:
                self._min = v

    @property
    def count(self) -> int:
        return self._count

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else 0.0

    def quantile(self, q: float) -> float:
        """Value at quantile ``q`` in [0, 1] (0 with no observations)."""
        assert 0.0 <= q <= 1.0, q
        with self._lock:
            if not self._count:
                return 0.0
            target = q * (self._count - 1) + 1  # rank in [1, count]
            seen = 0
            for idx in sorted(self._buckets):
                n = self._buckets[idx]
                if seen + n >= target:
                    # interpolate within the bucket's geometric span
                    lo = self._upper(idx - 1) if idx > 0 else self.min_value
                    hi = self._upper(idx)
                    frac = (target - seen) / n
                    v = lo + (hi - lo) * frac
                    # never report outside the observed range (the top
                    # bucket's upper bound can overshoot the true max)
                    return min(max(v, self._min), self._max)
                seen += n
            return self._max

    def snapshot(self) -> Dict[str, float]:
        return {
            "count": self._count,
            "mean": self.mean,
            "p50": self.quantile(0.5),
            "p99": self.quantile(0.99),
            "max": self._max if self._count else 0.0,
        }


class MetricsRegistry:
    """Named metrics, one flat namespace per process."""

    def __init__(self):
        self._metrics: Dict[str, Any] = {}
        self._lock = cc.Lock()

    def _get(self, name: str, cls, *args):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, *args)
            assert isinstance(m, cls), (
                f"metric {name!r} already registered as {type(m).__name__}"
            )
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, growth: float = 1.05,
                  min_value: float = 1e-6) -> Histogram:
        return self._get(name, Histogram, growth, min_value)

    def snapshot(self) -> Dict[str, Any]:
        """Flat {name: value | histogram-summary dict} of everything."""
        with self._lock:
            items = list(self._metrics.items())
        out: Dict[str, Any] = {}
        for name, m in items:
            out[name] = m.snapshot() if isinstance(m, Histogram) else m.value
        return out

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()


# ---------------------------------------------------------------- writer


class MetricsWriter:
    """Buffered append-only JSONL writer, one per host.

    ``path`` may be a directory (the run dir — the conventional shape)
    or an explicit ``*.jsonl`` file. Buffered records flush when the
    buffer fills, when a window-boundary kind (FLUSH_KINDS) is emitted,
    and at interpreter exit — a hard kill loses at most one window.
    """

    def __init__(self, path: str, host: int = 0, buffer_limit: int = 512):
        self.path = _resolve_path(path, host)
        self.dir = os.path.dirname(self.path) or "."
        self.host = int(host)
        self.buffer_limit = int(buffer_limit)
        self._buf: List[str] = []
        self._lock = cc.Lock()
        self._closed = False
        self._t0_mono = time.monotonic()
        os.makedirs(self.dir, exist_ok=True)
        # anchor: the ONLY wall-clock read; every later record carries a
        # monotonic offset from this instant
        self.emit(
            "run_start",
            wall_time=time.time(),  # lint: disable=PTL001 -- run_start anchor: the one read that maps t-offsets to civil time
            wall_time_iso=time.strftime("%Y-%m-%dT%H:%M:%S%z"),
            hostname=socket.gethostname(),
            pid=os.getpid(),
        )

    def emit(self, kind: str, *, pass_id: Optional[int] = None,
             step: Optional[int] = None, **fields) -> None:
        if self._closed:
            return
        rec: Dict[str, Any] = {
            "v": SCHEMA_VERSION,
            "kind": kind,
            "host": self.host,
            "t": round(time.monotonic() - self._t0_mono, 6),
        }
        if pass_id is not None:
            rec["pass"] = int(pass_id)
        if step is not None:
            rec["step"] = int(step)
        rec.update(fields)
        line = json.dumps(_sanitize(rec), default=_json_default)
        with self._lock:
            self._buf.append(line)
            full = len(self._buf) >= self.buffer_limit
        if full or kind in FLUSH_KINDS:
            self.flush()

    def flush(self) -> None:
        with self._lock:
            if not self._buf:
                return
            buf, self._buf = self._buf, []
        try:
            os.makedirs(self.dir, exist_ok=True)  # run dir may have rotated
            with open(self.path, "a") as f:
                f.write("\n".join(buf) + "\n")
        except OSError as e:
            # telemetry must never take down the run it observes
            logger.warning("metrics flush to %s failed: %s", self.path, e)

    def close(self) -> None:
        """Flush and stop accepting records. Does NOT emit ``run_end`` —
        that record means "the run finished on purpose" and is the
        trainer's to write; a reconfigure mid-process must not forge it."""
        if self._closed:
            return
        self.flush()
        self._closed = True


def _resolve_path(path: str, host: int) -> str:
    """The per-host stream file for a run dir (or explicit ``*.jsonl``)."""
    if path.endswith(".jsonl"):
        d, fname = os.path.split(path)
        if host > 0:
            fname = f"{fname[:-len('.jsonl')]}.host{host}.jsonl"
        return os.path.join(d or ".", fname)
    return os.path.join(path, FILE_FMT_HOST0 if host == 0 else FILE_FMT % host)


def _sanitize(o):
    """Keep the stream strict JSON: non-finite floats (a NaN loss is a
    legitimate record value!) become their string names — ``json.dumps``
    would otherwise emit bare ``NaN`` tokens most parsers reject."""
    if isinstance(o, float) and not math.isfinite(o):
        return str(o)  # "nan" / "inf" / "-inf"
    if isinstance(o, dict):
        return {k: _sanitize(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return [_sanitize(v) for v in o]
    return o


def _json_default(o):
    """Last-resort coercion: numpy scalars/arrays and friends."""
    if hasattr(o, "item"):
        return o.item()
    if hasattr(o, "tolist"):
        return o.tolist()
    return str(o)


# ------------------------------------------------------ process globals

_registry = MetricsRegistry()
_writer: Optional[MetricsWriter] = None
_atexit_installed = False


def registry() -> MetricsRegistry:
    return _registry


def enabled() -> bool:
    return _writer is not None


def configure(path: str, host: int = 0) -> Optional[MetricsWriter]:
    """Install (or with an empty path, clear) the process-global writer.

    Re-configuring with the same resolved file reuses the open writer
    (no duplicate ``run_start``); a different path closes the old one.
    """
    global _writer, _atexit_installed
    if not path:
        if _writer is not None:
            _writer.close()
        _writer = None
        return None
    resolved = _resolve_path(path, host)
    if _writer is not None:
        if os.path.abspath(_writer.path) == os.path.abspath(resolved):
            return _writer
        _writer.close()
    _writer = MetricsWriter(path, host=host)
    if not _atexit_installed:
        atexit.register(_atexit_flush)
        _atexit_installed = True
    return _writer


def configure_from_flags(flags, host: int = 0) -> Optional[MetricsWriter]:
    """Resolve the run's metrics dir: ``--metrics_path`` wins, else the
    save_dir doubles as the run dir (a supervised run always has one, so
    crash reports can read the tail), else telemetry is off."""
    path = getattr(flags, "metrics_path", "") or getattr(flags, "save_dir", "")
    return configure(path, host=host)


def _atexit_flush() -> None:
    if _writer is not None:
        _writer.flush()


def emit(kind: str, **fields) -> None:
    """Emit one record through the global writer; no-op when telemetry
    is off — call sites never need to guard."""
    if _writer is not None:
        _writer.emit(kind, **fields)


def flush() -> None:
    if _writer is not None:
        _writer.flush()


def rel_time(mono: float) -> float:
    """Map an absolute ``time.monotonic()`` reading into the global
    writer's ``t``-offset timebase (seconds since its ``run_start``).
    Span emitters measure hop boundaries with their own monotonic reads
    and convert here, so a span's ``t0`` shares the timebase every other
    record's envelope ``t`` uses — the property the trace reconstructor's
    run_start wall-clock alignment depends on. Returns the reading
    unchanged when telemetry is off (the record it would anchor is a
    no-op anyway)."""
    if _writer is None:
        return float(mono)
    return round(float(mono) - _writer._t0_mono, 6)


# ---------------------------------------------------------------- reading


def metrics_files(run_dir: str) -> List[str]:
    """Every per-host metrics stream under ``run_dir`` (host order).
    A ``*.jsonl`` file path is returned as-is."""
    if os.path.isfile(run_dir):
        return [run_dir]
    if not os.path.isdir(run_dir):
        return []
    out = [
        os.path.join(run_dir, f)
        for f in os.listdir(run_dir)
        if f.startswith("metrics") and f.endswith(".jsonl")
    ]
    return sorted(out)


def fleet_stream_dirs(run_dir: str) -> List[str]:
    """Every telemetry stream dir of a FLEET run rooted at ``run_dir``:
    the dir itself (the router's stream, when it has one) plus each
    replica's per-child metrics dir — ``replica-<i>/`` children of the
    run dir or of a nested ``fleet_status/`` (the layouts
    ``serve-fleet``'s ``_child_argv`` produces for ``--fleet_status_dir``
    inside or beside ``--metrics_path``). A plain single-process run dir
    comes back as ``[run_dir]`` unchanged, so fleet-aware readers can
    call this unconditionally."""
    if not os.path.isdir(run_dir):
        return [run_dir]
    dirs = [run_dir]
    roots = [run_dir, os.path.join(run_dir, "fleet_status")]
    for root in roots:
        if not os.path.isdir(root):
            continue
        for name in sorted(os.listdir(root)):
            sub = os.path.join(root, name)
            if (name.startswith("replica-") and os.path.isdir(sub)
                    and metrics_files(sub)):
                dirs.append(sub)
    return dirs


def parse_record_lines(text: str) -> Iterator[Dict[str, Any]]:
    """The ONE torn-line tolerance policy, shared by every reader
    (file reader, `--follow` live tail, bench-artifact parsing): blank
    lines and unparseable/non-dict lines are skipped — a crash can
    truncate the final line mid-write and that must never fail the
    stream."""
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue  # torn tail line from a crash — expected
        if isinstance(rec, dict):
            yield rec


def read_records(path: str) -> Iterator[Dict[str, Any]]:
    """Tolerant record reader: skips blank and torn lines (a crash can
    truncate the final line mid-write) instead of failing the stream.
    Streams line-by-line — a multi-day run's metrics.jsonl is never
    held in memory whole."""
    try:
        f = open(path)
    except OSError as e:
        logger.warning("cannot read metrics stream %s: %s", path, e)
        return
    with f:
        for line in f:
            yield from parse_record_lines(line)


def read_tail(run_dir: str, n: int = 20) -> Dict[int, List[Dict[str, Any]]]:
    """Last ``n`` records per host — what the supervisor embeds in
    ``crash_report.json`` instead of a grepped log tail."""
    out: Dict[int, List[Dict[str, Any]]] = {}
    for path in metrics_files(run_dir):
        for rec in read_records(path):
            host = int(rec.get("host", 0))
            bucket = out.setdefault(host, [])
            bucket.append(rec)
            if len(bucket) > n:
                del bucket[0]
    return out


def tail_with_last_skew(run_dir: str, n: int = 20):
    """(``{host-str: [last n records]}``, newest ``barrier_skew`` record
    or None) — the shared post-mortem evidence shape embedded by BOTH
    the supervisor's ``crash_report.json`` and hangwatch's
    ``hang_report.json``, extracted here so the skew-selection rule
    cannot drift between them.

    Newest skew: LAST in stream order per host (the ``t`` offset resets
    to ~0 in every restarted child appending to the same stream, so it
    cannot order records across attempts), then the highest pass across
    hosts — all hosts emit the same allgathered table, so any host's
    newest is authoritative."""
    tails = read_tail(run_dir, n=n)
    skew: Optional[Dict[str, Any]] = None
    for recs in tails.values():
        last = next(
            (r for r in reversed(recs) if r.get("kind") == "barrier_skew"),
            None,
        )
        if last is not None and (
            skew is None or last.get("pass", -1) >= skew.get("pass", -1)
        ):
            skew = last
    return {str(h): r for h, r in tails.items()}, skew


def validate_record(rec: Dict[str, Any]) -> List[str]:
    """Problems with one record against the documented schema
    (doc/observability.md); empty list = valid."""
    problems = []
    for k in REQUIRED_KEYS:
        if k not in rec:
            problems.append(f"missing required key {k!r}")
    if rec.get("v") not in (SCHEMA_VERSION,):
        problems.append(f"unknown schema version {rec.get('v')!r}")
    if not isinstance(rec.get("kind"), str):
        problems.append("kind must be a string")
    if "t" in rec and not isinstance(rec["t"], (int, float)):
        problems.append("t must be a number (seconds since run_start)")
    for k in ("pass", "step", "host", "rung"):
        if k in rec and not isinstance(rec[k], int):
            problems.append(f"{k} must be an integer")
    for k in KIND_REQUIRED.get(rec.get("kind"), ()):
        if k not in rec:
            problems.append(f"{rec['kind']} record missing required key {k!r}")
    return problems
