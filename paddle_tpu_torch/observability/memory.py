"""Device-memory exhaustion: the OOM pre-mortem's writer side.

The copied engine imports :class:`SyntheticOomError` (the ``serve.oom``
fault site's stand-in) and :func:`is_oom_error` (its OOM shutdown gate)
lazily. ``paddle serve`` calls :func:`trigger_oom_report` when a launch
dies of device-memory exhaustion: it writes ``oom_report.json`` (the
error, the allocator's stats, the telemetry tail) into the run dir, with
a backstop timer that guarantees the distinct exit code (``EXIT_OOM``,
20) even if the report write itself wedges. The reader (``paddle
memory``) and the live per-pass records wait for a later slice.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from paddle_tpu_torch.observability import metrics as obs
from paddle_tpu_torch.resilience import EXIT_OOM
from paddle_tpu_torch.utils import concurrency as cc
from paddle_tpu_torch.utils.logging import logger

OOM_REPORT = "oom_report.json"

# an OOM'd process may fail its own forensics (the report write can need
# memory; the run dir can live on the fs that is part of the problem), so
# a backstop timer guarantees the distinct exit code regardless
FORENSICS_DEADLINE_S = 30.0


class SyntheticOomError(RuntimeError):
    """Deterministic stand-in for a device OOM: the message carries the
    canonical RESOURCE_EXHAUSTED marker so :func:`is_oom_error` classifies
    it like the real thing."""

    def __init__(self, info: str = ""):
        detail = f" ({info})" if info else ""
        super().__init__(
            "RESOURCE_EXHAUSTED: out of memory "
            f"[synthetic — injected at trainer.oom{detail}]")


def is_oom_error(e: BaseException) -> bool:
    """True only for device-memory exhaustion: ``torch.OutOfMemoryError``
    or an error whose message says so. Deliberately narrow: a shape bug
    must crash loudly, not masquerade as an OOM."""
    if isinstance(e, torch.OutOfMemoryError):
        return True
    msg = f"{type(e).__name__}: {e}".lower()
    return any(s in msg for s in ("resource_exhausted", "resource exhausted",
                                  "out of memory", "failed to allocate"))


def device_memory_stats() -> Optional[Dict[str, int]]:
    """The caching allocator's stats summed over the visible cards:
    ``{bytes_in_use, peak_bytes_in_use, bytes_limit, devices}``, or None
    on a machine without a card (the CPU run)."""
    if not torch.cuda.is_available():
        return None
    in_use = peak = limit = seen = 0
    for i in range(torch.cuda.device_count()):
        try:
            s = torch.cuda.memory_stats(i)
            total = torch.cuda.get_device_properties(i).total_memory
        except Exception:  # noqa: BLE001 — forensics never raise
            continue
        seen += 1
        in_use += int(s.get("allocated_bytes.all.current", 0) or 0)
        peak += int(s.get("allocated_bytes.all.peak", 0) or 0)
        limit += int(total)
    if not seen:
        return None
    return {"bytes_in_use": in_use, "peak_bytes_in_use": peak,
            "bytes_limit": limit, "devices": seen}


def host_rss_bytes() -> int:
    """Current resident set size of this process: /proc when available,
    else ru_maxrss (the peak)."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource

        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    except Exception:  # noqa: BLE001
        return 0


def build_oom_report(
    report_dir: str,
    error: BaseException,
    groups: Optional[List[Dict[str, Any]]] = None,
    live: Optional[Dict[str, Any]] = None,
    where: Optional[Dict[str, Any]] = None,
    device_kind: str = "",
) -> Dict[str, Any]:
    """The pre-mortem document: the error, the launch groups' static
    footprints where a caller has them (ranked), the allocator's stats
    (``live``; read now when the caller passes none) and the telemetry
    tail."""
    groups = sorted(groups or [], key=lambda g: -int(g.get("mem_total_bytes", 0) or 0))
    if live is None:
        live = {"host_rss_bytes": host_rss_bytes()}
        dev = device_memory_stats()
        if dev is not None:
            live.update(hbm_in_use_bytes=dev["bytes_in_use"],
                        hbm_peak_bytes=dev["peak_bytes_in_use"],
                        hbm_limit_bytes=dev["bytes_limit"], devices=dev["devices"])
    report: Dict[str, Any] = {
        "reason": "oom",
        "error": str(error)[:4000],
        "error_type": type(error).__name__,
        "where": where or {},
        "device_kind": device_kind,
        "groups": groups,
        "static_total_bytes": sum(int(g.get("mem_total_bytes", 0) or 0) for g in groups),
        "live": live,
        "pid": os.getpid(),
        "written_at": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
    }
    try:
        tails, skew = obs.tail_with_last_skew(report_dir, n=25)
        report["metrics_tail"] = tails
        report["barrier_skew"] = skew
    except Exception as e:  # noqa: BLE001 — best effort, never masks the OOM
        report["metrics_tail_error"] = str(e)
    return report


def write_oom_report(report_dir: str, report: Dict[str, Any]) -> str:
    path = os.path.join(report_dir or ".", OOM_REPORT)
    try:
        os.makedirs(report_dir or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(report, f, indent=2, default=str)
        os.replace(tmp, path)  # readers never see a torn report
    except OSError as e:
        logger.error("oom pre-mortem: could not write %s: %s", path, e)
    return path


def trigger_oom_report(
    report_dir: str,
    error: BaseException,
    groups: Optional[List[Dict[str, Any]]] = None,
    live: Optional[Dict[str, Any]] = None,
    where: Optional[Dict[str, Any]] = None,
    device_kind: str = "",
    exit_fn: Optional[Callable[[int], None]] = None,
) -> str:
    """Write the pre-mortem: announce, arm the backstop (``exit_fn``,
    ``os._exit`` in production, exits ``EXIT_OOM`` within
    ``FORENSICS_DEADLINE_S`` if the forensics wedge), write, flush the
    ``kind=oom`` record, disarm. The caller exits ``EXIT_OOM`` after."""
    path = os.path.join(report_dir or ".", OOM_REPORT)
    logger.error("device OOM (%s) — writing pre-mortem %s, then exiting %d: %s",
                 type(error).__name__, path, EXIT_OOM, str(error)[:500])
    backstop = None
    if exit_fn is not None:
        backstop = cc.Timer(FORENSICS_DEADLINE_S, exit_fn, args=(EXIT_OOM,))
        backstop.daemon = True
        backstop.start()
    report = build_oom_report(report_dir, error, groups=groups, live=live, where=where,
                              device_kind=device_kind)
    path = write_oom_report(report_dir, report)
    obs.registry().counter("ooms.detected").inc()
    obs.emit("oom", pass_id=(where or {}).get("pass"), step=(where or {}).get("step"),
             error=str(error)[:500], report=path,
             static_total_bytes=report["static_total_bytes"])
    obs.flush()  # the caller is about to die
    if backstop is not None:
        backstop.cancel()
    return path
