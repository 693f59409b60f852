"""Cluster-level heartbeat liveness (``--heartbeat_interval``).

`cluster_launch` can only see hosts whose processes *exit*. A rank
wedged inside a collective (or an ssh tunnel that died without killing
the remote) is alive by every process-level test while the rest of the
pod burns inside blocked collectives. The heartbeat layer adds the
missing signal: each host's trainer renews a small JSON file under a
shared directory (``--heartbeat_dir``, defaulting to
``<save_dir>/heartbeats``), and any observer — `cluster_launch` today —
compares file timestamps against ``--heartbeat_stale_after`` to *name*
the wedged rank and tear the job down deliberately.

Design constraints:

- **Atomic renewal** (write tmp + ``os.replace``): a reader never sees
  a torn heartbeat, and a crashed writer leaves the last complete beat
  as evidence of *when* it stopped.
- **Wall-clock timestamps in the payload**, not file mtimes: the files
  live on a shared filesystem whose server sets mtimes; payload time is
  written by the host being judged (pods run NTP; the staleness
  thresholds are tens of seconds, far above sync error).
- **Injectable clock** end to end, so staleness logic is unit-testable
  without sleeping.
- jax-free: the launcher imports this while the accelerator runtime may
  be the thing that is wedged.
"""

from __future__ import annotations

import json
import os
import socket
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from paddle_tpu_torch.utils import concurrency as cc

HEARTBEAT_FMT = "host-%d.json"
# the monitor's default when --heartbeat_stale_after is unset: a beat
# must be missable a couple of times (GC pause, fs hiccup) before a
# host is declared wedged
DEFAULT_STALE_MULTIPLE = 3.0


def resolve_dir(heartbeat_dir: str, save_dir: str) -> str:
    """The one shared resolution rule: an explicit ``--heartbeat_dir``
    wins; otherwise the save_dir (the run's shared directory) hosts a
    ``heartbeats/`` child. Empty when neither is configured — writers
    and monitors both disable themselves then."""
    if heartbeat_dir:
        return heartbeat_dir
    if save_dir:
        return os.path.join(save_dir, "heartbeats")
    return ""


def heartbeat_path(dir_: str, host: int) -> str:
    return os.path.join(dir_, HEARTBEAT_FMT % int(host))


def write_beat(dir_: str, host: int, *, seq: int = 0,
               clock: Callable[[], float] = time.time,
               extra: Optional[Dict[str, Any]] = None) -> str:
    """Write one atomic heartbeat; returns the path."""
    os.makedirs(dir_, exist_ok=True)
    path = heartbeat_path(dir_, host)
    payload = {
        "host": int(host),
        "pid": os.getpid(),
        "hostname": socket.gethostname(),
        "t": clock(),
        "seq": int(seq),
    }
    if extra:
        payload.update(extra)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)
    return path


def read_beats(dir_: str) -> Dict[int, Dict[str, Any]]:
    """{host: payload} for every readable heartbeat under ``dir_``.
    Unparseable or foreign files are skipped — staleness logic treats a
    missing beat the same as a never-started host."""
    out: Dict[int, Dict[str, Any]] = {}
    if not dir_ or not os.path.isdir(dir_):
        return out
    for name in os.listdir(dir_):
        if not (name.startswith("host-") and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(dir_, name)) as f:
                payload = json.load(f)
            host = int(payload["host"])
        except (OSError, ValueError, KeyError, TypeError):
            continue
        out[host] = payload
    return out


def stale_hosts(
    dir_: str,
    num_hosts: int,
    stale_after_s: float,
    *,
    now: Optional[float] = None,
    since: Optional[float] = None,
    beats: Optional[Dict[int, Dict[str, Any]]] = None,
) -> List[Tuple[int, float]]:
    """Ranks whose heartbeat age exceeds ``stale_after_s``, with the age.

    ``since`` is the observation epoch (typically the launch time): a
    host that never wrote a beat is aged from ``since`` — so a trainer
    wedged *before its first beat* is still caught — while before
    ``since + stale_after_s`` nothing can be flagged (startup grace).
    ``now`` defaults to wall time; tests pass a fake clock value.
    ``beats`` lets a caller that already paid for ``read_beats`` (the
    launcher reads once per scan for its emptiness check) skip a second
    listdir+parse round-trip against the shared mount.
    """
    now = time.time() if now is None else now
    if beats is None:
        beats = read_beats(dir_)
    out: List[Tuple[int, float]] = []
    for host in range(num_hosts):
        beat = beats.get(host)
        t = None
        if beat is not None and isinstance(beat.get("t"), (int, float)):
            t = float(beat["t"])
        if since is not None:
            t = since if t is None else max(t, since)
        if t is None:
            continue  # no beat and no epoch: nothing to judge against
        age = now - t
        if age > stale_after_s:
            out.append((host, age))
    return out


class HeartbeatWriter:
    """Daemon thread renewing this host's beat every ``interval_s``.

    The final beat on ``stop()`` carries ``"stopped": True`` so a
    monitor can distinguish "exited cleanly between beats" from "went
    silent" when doing post-mortems."""

    def __init__(self, dir_: str, host: int, interval_s: float, *,
                 clock: Callable[[], float] = time.time):
        assert interval_s > 0, interval_s
        self.dir = dir_
        self.host = int(host)
        self.interval_s = float(interval_s)
        self.clock = clock
        self._seq = 0
        # beat() runs on BOTH the daemon renewal thread and the caller
        # (start's synchronous first beat, stop's final one) — the seq
        # increment must not tear between them, and monitors rely on
        # seq to be strictly increasing per host
        self._seq_lock = cc.Lock()
        self._stop = cc.Event()
        self._thread = None

    def beat(self, **extra) -> None:
        from paddle_tpu_torch.utils.logging import logger

        # the lock serializes the WHOLE beat, not just the increment:
        # stop()'s final beat can overlap a daemon-thread beat stuck in
        # slow-fs I/O past the join timeout, and both share the same
        # pid-keyed tmp file — an unserialized pair can tear the write
        # or publish seq N over seq N+1, breaking the strictly-
        # increasing contract monitors rely on. BOUNDED acquire: when
        # the holder is wedged in dead-fs I/O, the caller (stop() at
        # shutdown) must not inherit the wedge — skipping the beat and
        # letting the monitor see staleness is the honest outcome, same
        # rationale as the OSError swallow below
        if not self._seq_lock.acquire(timeout=max(self.interval_s, 1.0)):
            logger.warning(
                "heartbeat: beat skipped for host %d — a concurrent beat "
                "holds the lock (wedged shared-fs write?)", self.host,
            )
            return
        try:
            self._seq += 1  # lint: disable=PTL005 -- _seq_lock IS held: acquired with a timeout above (bounded acquire has no with-form), released in the finally
            try:
                write_beat(self.dir, self.host, seq=self._seq,
                           clock=self.clock,
                           extra={"interval_s": self.interval_s, **extra})
            except OSError as e:
                # liveness reporting must never kill the run it reports
                # on; the monitor sees a stale beat and names this host,
                # which is the honest outcome if the shared fs is gone
                logger.warning("heartbeat write failed for host %d: %s",
                               self.host, e)
        finally:
            self._seq_lock.release()

    def start(self) -> "HeartbeatWriter":
        if self._thread is None:
            self.beat()  # first beat synchronously: monitors see us asap
            self._stop.clear()
            self._thread = cc.Thread(
                target=self._run, name="heartbeat", daemon=True
            )
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.beat()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=max(self.interval_s, 1.0))
        self.beat(stopped=True)

    def __enter__(self) -> "HeartbeatWriter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
