"""Cost attribution: XLA cost analysis → per-launch-group rooflines.

``paddle roofline <run_dir>`` answers the question step timing alone
cannot: *where do the FLOPs and bytes go, and what is each compiled
launch group bound by?* For every launch group the compile telemetry
(``observability/compile_log.py``) recorded, it combines

- FLOPs and bytes accessed per launch (``compiled.cost_analysis()``,
  captured at compile time into the ``kind=compile`` / ``kind=roofline``
  records; the analytic matmul count rides along as
  ``flops_analytic_per_launch`` — XLA counts scan bodies once, so for
  scanned models the analytic number is the honest FLOP basis), with
- measured execution seconds per group (the trainer's step windows,
  attributed launch-by-launch),

into achieved FLOP/s, arithmetic intensity (FLOP/byte), and a roofline
bucket: **compute-bound** (intensity ≥ the chip's ridge point,
peak FLOP/s ÷ peak HBM bytes/s), **memory-bound** (below it), or
**host-bound** (the pass spent most of its time waiting on the data
pipeline — no kernel fix will help). Chip peaks come from
``ops/kernel_flops.py``; unknown device kinds degrade the bucket to
``unknown`` rather than guessing.

jax-free: like ``paddle metrics``, it must run on a dev box against a
run dir copied off a pod.

Usage::

    paddle roofline <run_dir | metrics.jsonl> [--json]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional

from paddle_tpu_torch.observability import metrics as obs
# data-wait share of pass time above which a group's roofline position
# is moot — the step loop is starved, not the kernel. The SAME constant
# drives the analyzer's data-bound warning (one threshold, two tools,
# no drift); analyze only imports costs lazily, so no cycle.
from paddle_tpu_torch.observability.analyze import DATA_BOUND_SHARE as HOST_BOUND_SHARE


def cost_analysis_of(compiled) -> Optional[Dict[str, float]]:
    """FLOPs / bytes accessed of one compiled executable, or None.

    Graceful by contract: backends without cost analysis (or raising
    from it), list-shaped returns (older jax), and missing keys all
    collapse to None / absent keys — accounting must never be able to
    break training (same covenant as ``_count_model_flops``)."""
    try:
        ca = compiled.cost_analysis()
    except Exception:
        return None
    if isinstance(ca, (list, tuple)):
        ca = ca[0] if ca else None
    if not isinstance(ca, dict):
        return None
    out: Dict[str, float] = {}
    f = ca.get("flops")
    if isinstance(f, (int, float)) and f > 0:
        out["flops"] = float(f)
    b = ca.get("bytes accessed")
    if isinstance(b, (int, float)) and b > 0:
        out["bytes_accessed"] = float(b)
    return out or None


def classify(intensity: Optional[float], device_kind: str = "",
             data_wait_share: Optional[float] = None) -> str:
    """Roofline bucket of one launch group."""
    if data_wait_share is not None and data_wait_share > HOST_BOUND_SHARE:
        return "host-bound"
    if intensity is None:
        return "unknown"
    from paddle_tpu_torch.ops.kernel_flops import peak_gbps, peak_tflops

    peak_t = peak_tflops(device_kind or "")
    peak_b = peak_gbps(device_kind or "")
    if not peak_t or not peak_b:
        return "unknown"
    ridge = peak_t * 1e12 / (peak_b * 1e9)  # FLOP/byte at the ridge point
    return "compute-bound" if intensity >= ridge else "memory-bound"


def roofline_rows(streams: Dict[int, List[Dict[str, Any]]],
                  data_wait_share: Optional[float] = None) -> List[Dict[str, Any]]:
    """Per-launch-group roofline rows from merged metrics streams.

    ``roofline`` records are cumulative per (host, group, sig) — kept
    latest-wins in stream order (mirroring the analyzer's pass_end
    dedupe), then hosts are summed per (group, sig)."""
    latest: Dict[tuple, Dict[str, Any]] = {}
    for host in sorted(streams):
        for rec in streams[host]:
            if rec.get("kind") != "roofline":
                continue
            latest[(host, rec.get("group"), rec.get("sig"))] = rec
    merged: Dict[tuple, Dict[str, Any]] = {}
    for (_h, group, sig), rec in latest.items():
        row = merged.setdefault((group, sig), {
            "group": group, "sig": sig, "launches": 0, "batches": 0,
            "exec_s": 0.0,
        })
        row["launches"] += int(rec.get("launches", 0))
        row["batches"] += int(rec.get("batches", 0))
        row["exec_s"] += float(rec.get("exec_s", 0.0))
        for k in ("flops_per_launch", "flops_analytic_per_launch",
                  "bytes_per_launch", "device_kind"):
            if k in rec:
                row[k] = rec[k]
    rows = []
    for (group, _sig), row in sorted(merged.items()):
        # FLOP basis: analytic when present (exact for scans), XLA's
        # cost analysis otherwise; intensity is always XLA/XLA — one
        # consistent basis for the ratio
        basis = row.get("flops_analytic_per_launch") or row.get("flops_per_launch")
        if basis and row["exec_s"] > 0:
            row["achieved_flops_per_s"] = basis * row["launches"] / row["exec_s"]
        xf, xb = row.get("flops_per_launch"), row.get("bytes_per_launch")
        if xf and xb:
            row["intensity"] = xf / xb
        row["bucket"] = classify(
            row.get("intensity"), row.get("device_kind", ""),
            data_wait_share,
        )
        rows.append(row)
    return rows


def totals_of(compiles: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Totals of an already-collected ``kind=compile`` record list —
    the ONE aggregation `paddle metrics`, `roofline`, and `compare` all
    share (callers that walked the streams themselves pass their list
    instead of re-scanning)."""
    return {
        "count": len(compiles),
        "trace_s": round(sum(float(c.get("trace_s", 0.0)) for c in compiles), 6),
        "compile_s": round(sum(float(c.get("compile_s", 0.0)) for c in compiles), 6),
        "cache_hits": sum(1 for c in compiles if c.get("cache_hit") is True),
        "cache_misses": sum(1 for c in compiles if c.get("cache_hit") is False),
    }


def compile_totals(streams: Dict[int, List[Dict[str, Any]]]) -> Dict[str, Any]:
    """Aggregate of every ``kind=compile`` record in the run: total
    trace/compile seconds and the persistent-cache hit split — the
    number a warm-restart claim is checked against."""
    compiles = [
        rec
        for host in sorted(streams)
        for rec in streams[host]
        if rec.get("kind") == "compile"
    ]
    return {"compiles": compiles, "totals": totals_of(compiles)}


def _last_data_wait_share(doc: Dict[str, Any]) -> Optional[float]:
    """Steady-state data-wait share: the analyzer's number for the last
    pass that has one (the host-bound gate)."""
    for row in reversed(doc.get("passes", [])):
        if "data_wait_share" in row:
            return float(row["data_wait_share"])
    return None


def roofline_doc(streams: Dict[int, List[Dict[str, Any]]]) -> Dict[str, Any]:
    # ONE analyzer pass over the streams: data-wait share and compile
    # totals both come out of the same doc (re-walking a multi-day
    # multi-host record set per number is real parse cost)
    from paddle_tpu_torch.observability.analyze import analyze

    doc = analyze(streams)
    share = _last_data_wait_share(doc)
    return {
        "data_wait_share": share,
        "groups": roofline_rows(streams, data_wait_share=share),
        "compile_totals": doc.get("compile_totals") or totals_of([]),
    }


def _fmt(v, scale=1.0, fmt="{:.3g}", dash="-"):
    if v is None:
        return dash
    return fmt.format(v * scale)


def format_report(doc: Dict[str, Any]) -> str:
    lines = [
        f"{'group':<12} {'sig':<10} {'launches':>8} {'exec s':>9} "
        f"{'GFLOP/launch':>12} {'MB/launch':>10} {'GFLOP/s':>9} "
        f"{'FLOP/B':>7} {'bucket':>13}"
    ]
    for row in doc["groups"]:
        lines.append(
            f"{row['group']:<12} {row['sig']:<10} {row['launches']:>8} "
            f"{row['exec_s']:>9.3f} "
            f"{_fmt(row.get('flops_analytic_per_launch') or row.get('flops_per_launch'), 1e-9):>12} "
            f"{_fmt(row.get('bytes_per_launch'), 1e-6):>10} "
            f"{_fmt(row.get('achieved_flops_per_s'), 1e-9):>9} "
            f"{_fmt(row.get('intensity'), 1.0, '{:.2f}'):>7} "
            f"{row['bucket']:>13}"
        )
    t = doc["compile_totals"]
    lines.append("")
    lines.append(
        f"compiles: {t['count']} (trace {t['trace_s']:.3f}s + compile "
        f"{t['compile_s']:.3f}s, cache {t['cache_hits']} hit(s) / "
        f"{t['cache_misses']} miss(es))"
    )
    if doc.get("data_wait_share") is not None:
        lines.append(
            f"data-wait share (last pass): {doc['data_wait_share'] * 100:.1f}%"
        )
    if any(row["bucket"] == "unknown" for row in doc["groups"]):
        lines.append(
            "note: bucket 'unknown' = no cost analysis or no peak "
            "FLOP/bandwidth table for this device kind "
            "(ops/kernel_flops.py) — positions are never guessed"
        )
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="paddle roofline",
        description="per-launch-group roofline report from a run's "
                    "compile/cost telemetry",
    )
    p.add_argument("run_dir", help="run dir (or one metrics*.jsonl file)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="emit the analysis as JSON")
    args = p.parse_args(argv)

    from paddle_tpu_torch.observability.analyze import load_run

    files = obs.metrics_files(args.run_dir)
    if not files:
        print(f"no metrics*.jsonl under {args.run_dir!r} "
              "(was the run started with --metrics_path / --save_dir?)",
              file=sys.stderr)
        return 1
    doc = roofline_doc(load_run(args.run_dir))
    if not doc["groups"] and not doc["compile_totals"]["count"]:
        print("no compile/roofline records in this run's telemetry "
              "(pre-compile-telemetry run, or it never finished a pass)",
              file=sys.stderr)
        return 1
    if args.as_json:
        print(json.dumps(doc, indent=2, default=str))
    else:
        print(f"# roofline: {', '.join(files)}")
        print(format_report(doc))
    return 0


if __name__ == "__main__":
    sys.exit(main())
