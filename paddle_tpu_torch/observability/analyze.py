"""``paddle metrics <run_dir>`` — read the telemetry back.

Merges the per-host ``metrics*.jsonl`` streams of one run dir, prints a
per-pass aggregate table (step-time p50/p99, data-wait share, checkpoint
durations, nonfinite/retry/fault counters), flags stragglers across
hosts (reusing ``utils/barrier.summarize_host_stats`` — the BarrierStat
attribution, now fed from structured records instead of log lines) and
stalls, and emits the whole analysis as JSON with ``--json`` for
tooling. jax-free: it must run on a dev box against a run dir copied
off a pod.

Usage::

    paddle metrics <run_dir | metrics.jsonl> [--json] [--tail N] [--follow]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, Iterator, List, Optional

from paddle_tpu_torch.observability import metrics as obs

# data-wait share of pass time above which the run is data-bound — the
# analyzer's warning AND the roofline host-bound bucket (costs.py)
# classify against this ONE constant so the two tools cannot disagree
DATA_BOUND_SHARE = 0.5

# counters whose per-pass DELTA the table surfaces (snapshot keys from
# MetricsRegistry — cumulative in the records, differenced here)
_COUNTER_COLS = (
    ("data.prefetch_wait_s", "data_wait_s"),
    ("data.bad_samples", "bad_samples"),
    ("retry.attempts", "retries"),
    ("faults.fired", "faults"),
    ("nonfinite.events", "nonfinite"),
    # async checkpointing (doc/performance.md): the background write
    # time plus queued saves dropped by --ckpt_inflight_limit (what the
    # step loop actually waited — ckpt_blocked_s — is attributed from
    # the op="snapshot" checkpoint records instead: pass-end saves run
    # AFTER the pass_end counter snapshot, so a counter delta would
    # land each save's cost one pass late)
    ("ckpt.write_s", "ckpt_write_s"),
    ("ckpt.async_dropped", "ckpt_dropped"),
)


def load_run(run_dir: str) -> Dict[Any, List[Dict[str, Any]]]:
    """{stream key: [records in stream order]} for one run dir.

    A FLEET run dir (router stream + ``replica-*/`` child streams,
    discovered via :func:`metrics.fleet_stream_dirs`) merges every
    stream: keys become ``"<stream>/<host>"`` strings so one replica's
    ``run_start`` cannot supersede another replica's windows, and
    replica-less serve records are stamped with their stream's replica
    name for the merged per-rung tables. Single-stream dirs keep plain
    int host keys (and their exact analysis shape)."""
    dirs = obs.fleet_stream_dirs(run_dir)
    streams: Dict[Any, List[Dict[str, Any]]] = {}
    base = os.path.normpath(run_dir)
    for d in dirs:
        label = ("" if os.path.normpath(d) == base
                 else os.path.basename(os.path.normpath(d)))
        for path in obs.metrics_files(d):
            for rec in obs.read_records(path):
                host = int(rec.get("host", 0))
                if len(dirs) == 1:
                    key: Any = host
                else:
                    key = f"{label or 'router'}/{host}"
                    if (label and not rec.get("replica")
                            and rec.get("kind") in ("serve_window",
                                                    "request", "span")):
                        rec["replica"] = label
                streams.setdefault(key, []).append(rec)
    return streams


def _counter(rec: Dict[str, Any], name: str) -> float:
    v = (rec.get("counters") or {}).get(name, 0.0)
    if isinstance(v, dict):  # histogram snapshot: the count is the tally
        return float(v.get("count", 0.0))
    return float(v or 0.0)


def analyze(streams: Dict[int, List[Dict[str, Any]]]) -> Dict[str, Any]:
    """Aggregate merged streams into the analysis document.

    Re-run passes are first-class input: a supervised restart or a
    rollback re-run appends a SECOND ``pass_end`` for the same (host,
    pass) to the same stream, so records are deduplicated latest-wins
    (stream order) per host before aggregation — otherwise samples
    double-count and the hosts divisor inflates."""
    hosts = sorted(streams)
    checkpoints: List[Dict[str, Any]] = []
    invalid = 0
    # {host: {pass: latest pass_end record}} — latest-wins dedupe
    per_host_pass: Dict[int, Dict[int, Dict[str, Any]]] = {}
    last_skew: Optional[Dict[str, Any]] = None
    # per-host, last-state: a run_start UN-ends its host (a restarted/
    # rerun process appending to the same stream owes a fresh run_end —
    # the same rule `--follow`'s stop condition applies), and the run
    # counts as ended while any host's latest epoch completed
    ended_hosts: set = set()
    hangs: List[Dict[str, Any]] = []
    restarts: List[Dict[str, Any]] = []
    compiles: List[Dict[str, Any]] = []
    ooms: List[Dict[str, Any]] = []
    # memory plane: per-pass worst HBM peak / host RSS (the `hbm pk`
    # column) + the last live snapshot per host; numerics plane: layers
    # that EVER produced a nonfinite gradient, per pass and overall
    # (the `nf lyr` column and the compare surface)
    mem_by_pass: Dict[int, Dict[str, float]] = {}
    mem_last: Dict[int, Dict[str, Any]] = {}
    # sparse-table plane: latest-wins per (host, pass) like pass_end,
    # then hosts are summed per pass (each host touches its own rows)
    sparse_by: Dict[tuple, Dict[str, Any]] = {}
    numerics_count = 0
    nf_layers_by_pass: Dict[int, set] = {}
    nf_layers_all: set = set()
    # request records dedupe by (host, id) — the SAME latest-wins
    # discipline as the windows: a rerun appending to the default serve
    # run dir re-emits the same request ids, and counting every record
    # would report 2x requests next to a rung table summing to half
    serve_request_ids: set = set()
    # hosts whose CURRENT epoch has driver requests (rung >= 0): a serve
    # DRIVER run owes a run_end even when it died before its first
    # serve_window; oneshot records (rung -1, the embedding API) owe
    # nothing, and a superseded epoch's driver doesn't haunt the next
    serve_driver_hosts: set = set()
    # serve_window rollups, latest-wins per (host, engine, rung) like
    # pass_end — a restarted serve driver re-emits its rungs into the
    # same stream, while a stream carrying BOTH engines' sweeps (the
    # A/B in one dir) must keep both ladders, not clobber the first
    serve_windows_by: Dict[tuple, Dict[str, Any]] = {}

    for host in hosts:
        for rec in streams[host]:
            if obs.validate_record(rec):
                invalid += 1
                continue
            kind = rec.get("kind")
            if kind == "run_start":
                # a new sweep appended to a reused serve run dir (or a
                # relaunched driver) supersedes the host's earlier serve
                # telemetry WHOLESALE: rung-keyed latest-wins alone would
                # let a longer previous ladder leave ghost rungs behind
                for k in [k for k in serve_windows_by if k[0] == host]:
                    del serve_windows_by[k]
                serve_request_ids = {
                    k for k in serve_request_ids if k[0] != host
                }
                ended_hosts.discard(host)
                serve_driver_hosts.discard(host)
            elif kind == "run_end":
                ended_hosts.add(host)
            elif kind == "checkpoint":
                checkpoints.append(rec)
            elif kind == "barrier_skew":
                last_skew = rec
            elif kind == "hang":
                hangs.append(rec)
            elif kind == "restart":
                restarts.append(rec)
            elif kind == "compile":
                compiles.append(rec)
            elif kind == "oom":
                ooms.append(rec)
            elif kind == "memory":
                mem_last[host] = rec
                p = rec.get("pass")
                if isinstance(p, int):
                    row = mem_by_pass.setdefault(p, {})
                    for src in ("hbm_peak_bytes", "host_rss_bytes"):
                        if isinstance(rec.get(src), (int, float)):
                            row[src] = max(
                                float(row.get(src, 0.0)), float(rec[src])
                            )
            elif kind == "numerics":
                numerics_count += 1
                p = rec.get("pass")
                nf = set(rec.get("nonfinite_layers") or [])
                nf_layers_all |= nf
                if isinstance(p, int):
                    nf_layers_by_pass.setdefault(p, set()).update(nf)
            elif kind == "request":
                serve_request_ids.add((host, rec.get("id")))
                if rec.get("rung", -1) >= 0:
                    serve_driver_hosts.add(host)
            elif kind == "serve_window":
                # pipeline joins the key: a one-dir pipelined-vs-
                # blocking A/B re-runs the same (engine, rung) ladder
                # and must keep BOTH sweeps, like the both-engines case;
                # replica/replicas join it too — a fleet rung carries N
                # per-replica windows PLUS their merged (replicas=N)
                # rollup, all legitimately at the same (engine, rung)
                serve_windows_by[
                    (host, rec.get("engine", "static"),
                     str(rec.get("pipeline") or ""),
                     str(rec.get("replica") or ""),
                     int(rec.get("replicas") or 0), rec.get("rung"))
                ] = rec
            elif kind == "sparse":
                p = rec.get("pass")
                if isinstance(p, int):
                    sparse_by[(host, p)] = rec
            elif kind == "pass_end":
                p = int(rec.get("pass", -1))
                per_host_pass.setdefault(host, {})[p] = rec
    serve_windows = [
        serve_windows_by[k] for k in sorted(
            serve_windows_by,
            key=lambda k: (k[1] if k[1] is not None else -1, k[2],
                           k[4], k[3],
                           k[5] if isinstance(k[5], int) else -1, k[0]),
        )
    ]

    passes: Dict[int, Dict[str, Any]] = {}
    per_host_prev: Dict[int, Dict[str, float]] = {}
    # per-pass per-host (mean, p99) step times for straggler attribution
    host_steps: Dict[int, Dict[int, tuple]] = {}
    for host in hosts:
        prev_counters: Dict[str, float] = {}
        # (count, count·mean) of the pack_threads_busy histogram at the
        # previous pass_end — the snapshot is run-cumulative, so the
        # per-pass mean must come from the delta like the counter cols
        prev_pack = (0.0, 0.0)
        for p in sorted(per_host_pass.get(host, {})):
            rec = per_host_pass[host][p]
            row = passes.setdefault(p, {"pass": p, "samples": 0, "hosts": 0})
            row["hosts"] += 1
            row["samples"] += int(rec.get("samples", 0))
            if row["hosts"] == 1:
                # representative scalars come from the LOWEST host with
                # this pass (host 0 normally) — samples_per_sec/mfu
                # genuinely differ per host, and last-host-wins would
                # label the pass with an arbitrary host's number
                for src in ("AvgCost", "CurrentCost", "samples_per_sec",
                            "model_tflops_per_sec", "mfu"):
                    if src in rec:
                        row[src] = rec[src]
            # worst-across-hosts per pass: step-time quantiles and the
            # hangwatch's max progress age (a near-miss stall on ANY
            # host is the number an operator tuning --step_hang_timeout
            # needs)
            for k in ("step_time_p50_s", "step_time_p99_s",
                      "progress_age_max_s"):
                if k in rec:
                    row[k] = max(float(row.get(k, 0.0)), float(rec[k]))
            pass_time = float(rec.get("pass_time_s", 0.0))
            row["pass_time_s"] = max(
                float(row.get("pass_time_s", 0.0)), pass_time
            )
            cur = {name: _counter(rec, name) for name, _ in _COUNTER_COLS}
            for name, col in _COUNTER_COLS:
                d = cur[name] - prev_counters.get(name, 0.0)
                row[col] = row.get(col, 0.0) + max(d, 0.0)
            prev_counters = cur
            # packer-pool utilization: mean packers busy at each batch
            # handoff THIS pass (delta of the cumulative histogram) —
            # worst host wins, like the step quantiles
            pack = (rec.get("counters") or {}).get("data.pack_threads_busy")
            if isinstance(pack, dict) and pack.get("count"):
                cnt = float(pack["count"])
                tot = cnt * float(pack.get("mean", 0.0))
                d_cnt, d_tot = cnt - prev_pack[0], tot - prev_pack[1]
                prev_pack = (cnt, tot)
                if d_cnt > 0:
                    row["pack_busy_mean"] = max(
                        float(row.get("pack_busy_mean", 0.0)),
                        round(d_tot / d_cnt, 4),
                    )
            if row.get("pass_time_s", 0.0) > 0:
                share = row.get("data_wait_s", 0.0) / (
                    row["pass_time_s"] * max(row["hosts"], 1)
                )
                row["data_wait_share"] = round(min(share, 1.0), 4)
            if "step_time_mean_s" in rec:
                host_steps.setdefault(p, {})[host] = (
                    float(rec["step_time_mean_s"]),
                    float(rec.get("step_time_p99_s", rec["step_time_mean_s"])),
                )
        per_host_prev[host] = prev_counters

    # fold the memory/numerics planes into the pass rows (worst host,
    # like the step quantiles)
    for p, mrow in mem_by_pass.items():
        if p in passes:
            passes[p].update(mrow)
    for p, layer_set in nf_layers_by_pass.items():
        if p in passes:
            passes[p]["nf_layers"] = len(layer_set)
    # sparse plane: hosts summed per pass (rows_touched and rows/s are
    # per-host quantities; reshard events take the max — every host
    # reports the same restore-time count)
    for (_h, p), srec in sorted(sparse_by.items()):
        if p not in passes:
            continue
        row = passes[p]
        for k in ("rows_touched", "unique_rows", "gather_bytes",
                  "scatter_bytes", "sparse_rows_per_sec"):
            if isinstance(srec.get(k), (int, float)):
                row[k] = row.get(k, 0) + srec[k]
        if isinstance(srec.get("reshard_events"), int):
            row["reshard_events"] = max(
                int(row.get("reshard_events", 0)), srec["reshard_events"]
            )

    # straggler attribution: feed the gathered per-host step stats of the
    # LAST pass with full coverage through the BarrierStat formatter
    straggler = None
    if len(hosts) > 1 and host_steps:
        import numpy as np

        from paddle_tpu_torch.utils.barrier import summarize_host_stats

        for p in sorted(host_steps, reverse=True):
            per_host = host_steps[p]
            if len(per_host) == len(hosts):
                table = np.asarray(
                    [per_host.get(h, (float("nan"),) * 2) for h in hosts]
                )
                straggler = {"pass": p, "line": summarize_host_stats(table)}
                break

    # step-loop checkpoint-stall attribution, from the checkpoint
    # records themselves: op="snapshot" records exist exactly when
    # --async_checkpoint is on and their duration is what the step loop
    # actually waited (ckpt_blocked_s); op="save" blocks the step loop
    # only when async checkpointing is OFF (with it on, saves are the
    # background writer's time)
    async_ckpt = any(c.get("op") == "snapshot" for c in checkpoints)
    # latest-wins per (host, pass, op, step), mirroring the pass_end
    # dedupe: a supervised restart or rollback re-run re-saves the same
    # save point, and summing every attempt would charge one run's
    # pass_time_s with N runs' worth of blocked seconds. Mid-pass
    # periodic saves (--saving_period_by_batches) of one pass carry
    # distinct `step`s and stay individually counted
    latest_dur: Dict[tuple, float] = {}
    for c in checkpoints:
        if isinstance(c.get("pass"), int) and c.get("op") in ("save", "snapshot"):
            latest_dur[(c.get("host"), c["pass"], c["op"], c.get("step"))] = (
                float(c.get("duration_s", 0.0))
            )
    sync_save_s: Dict[int, float] = {}
    snap_s: Dict[int, float] = {}
    for (_h, p_ckpt, op, _s), dur in latest_dur.items():
        tgt = sync_save_s if op == "save" else snap_s
        tgt[p_ckpt] = tgt.get(p_ckpt, 0.0) + dur
    for p, blocked in snap_s.items():
        if p in passes:
            passes[p]["ckpt_blocked_s"] = round(blocked, 6)

    warnings: List[str] = []
    for p in sorted(passes):
        row = passes[p]
        if row.get("data_wait_share", 0.0) > DATA_BOUND_SHARE:
            warnings.append(
                f"pass {p}: data-bound — the step loop spent "
                f"{row['data_wait_share'] * 100:.0f}% of the pass waiting "
                "on the provider (grow pool_size / check input storage)"
            )
        pass_time = row.get("pass_time_s", 0.0)
        if not async_ckpt and pass_time > 0:
            blocked = sync_save_s.get(p, 0.0)
            if blocked / pass_time > 0.1:
                warnings.append(
                    f"pass {p}: checkpoint-bound — synchronous saves "
                    f"blocked the step loop {blocked / pass_time * 100:.0f}% "
                    "of the pass (consider --async_checkpoint)"
                )
        if async_ckpt and pass_time > 0:
            blocked = row.get("ckpt_blocked_s", 0.0)
            if blocked / pass_time > 0.1:
                warnings.append(
                    f"pass {p}: snapshot-heavy — async checkpointing still "
                    f"blocked the step loop {blocked / pass_time * 100:.0f}% "
                    "of the pass on device→host copies (save less often or "
                    "shrink the model state)"
                )
        if row.get("ckpt_dropped", 0) > 0:
            warnings.append(
                f"pass {p}: {int(row['ckpt_dropped'])} queued async "
                "checkpoint save(s) dropped (superseded; raise "
                "--ckpt_inflight_limit or save less often)"
            )
        for col, label in (("nonfinite", "non-finite loss event(s)"),
                           ("faults", "injected fault firing(s)"),
                           ("bad_samples", "malformed sample(s) skipped")):
            if row.get(col, 0) > 0:
                warnings.append(f"pass {p}: {int(row[col])} {label}")
    for h in hangs:
        warnings.append(
            f"hang detected on host {h.get('host', '?')} at pass "
            f"{h.get('pass', '?')} step {h.get('step', '?')}: no progress "
            f"for {h.get('age_s', '?')}s (exit 19; forensics in "
            f"{h.get('report', 'hang_report.json')})"
        )
    for o in ooms:
        warnings.append(
            f"OOM on host {o.get('host', '?')} at pass {o.get('pass', '?')} "
            f"step {o.get('step', '?')} (exit 20; pre-mortem in "
            f"{o.get('report', 'oom_report.json')} — "
            "`paddle memory <run_dir>` renders it)"
        )
    if nf_layers_all:
        warnings.append(
            "nonfinite gradients observed in layer(s): "
            + ", ".join(sorted(nf_layers_all))
        )
    if last_skew is not None and last_skew.get("line"):
        warnings.append(f"barrier skew: {last_skew['line']}")
    # oneshot request records (the embedding API's SequenceGenerator —
    # no driver, so no run_end is ever owed) must not trip the crash
    # heuristic; driver streams (passes, serve windows, or rung>=0
    # request records — a serve run killed before its first window) do
    run_ended = bool(ended_hosts)
    if (passes or serve_windows or serve_driver_hosts) and not run_ended:
        warnings.append(
            "stream ends without a run_end record — the run crashed, was "
            "killed, or is still going"
        )
    if invalid:
        warnings.append(f"{invalid} record(s) failed schema validation")

    # restart latency (ROADMAP item 5 groundwork): the measured numbers
    # heartbeat-grace and crash-loop windows should be tuned from — the
    # WORST observed restore and time-to-first-step across hosts/rounds
    restart_latency = None
    if restarts:
        restart_latency = {
            "rounds": len(restarts),
            "restore_s_max": max(
                float(r.get("restore_s", 0.0)) for r in restarts
            ),
            "time_to_first_step_s_max": max(
                float(r.get("time_to_first_step_s", 0.0)) for r in restarts
            ),
        }

    # compile-cost totals (doc/observability.md "Compile telemetry"):
    # every (re)compile is a record, so the totals are exact — the
    # numbers `paddle compare` diffs and a warm-restart claim is
    # checked against. One aggregation, shared with `paddle roofline`
    # (lazy import: costs imports this module inside a function too).
    compile_totals = None
    if compiles:
        from paddle_tpu_torch.observability.costs import totals_of

        compile_totals = totals_of(compiles)

    # serving telemetry (doc/observability.md "Serving telemetry"): the
    # per-pass table has nothing to say about a serve run — point at the
    # dedicated analyzer instead of printing an empty table silently
    serve = None
    if serve_request_ids or serve_windows:
        serve = {
            "requests": len(serve_request_ids),
            "windows": len(serve_windows),
            "rungs": len({w.get("rung") for w in serve_windows}),
        }
        # fleet runs only — single-stream serve JSON keeps its shape
        replicas = sorted({str(w.get("replica")) for w in serve_windows
                           if w.get("replica")})
        if replicas:
            serve["replicas"] = replicas

    # memory/numerics planes (doc/observability.md "Memory & numerics
    # telemetry") — None when the run predates them, so old-run JSON
    # output keeps its shape
    memory = {"last": mem_last} if mem_last else None
    numerics = (
        {"records": numerics_count,
         "nonfinite_layers": sorted(nf_layers_all)}
        if numerics_count else None
    )

    return {
        "hosts": hosts,
        "passes": [passes[p] for p in sorted(passes)],
        "checkpoints": checkpoints,
        "compiles": compiles,
        "compile_totals": compile_totals,
        "restarts": restarts,
        "restart_latency": restart_latency,
        "memory": memory,
        "numerics": numerics,
        "ooms": ooms,
        "serve": serve,
        "serve_windows": serve_windows,
        "counters": {h: per_host_prev.get(h, {}) for h in hosts},
        "straggler": straggler,
        "barrier_skew": last_skew,
        "hangs": hangs,
        "run_ended": run_ended,
        "invalid_records": invalid,
        "warnings": warnings,
    }


def _fmt_table(doc: Dict[str, Any]) -> str:
    # the age column (hangwatch's max progress age per pass, worst host)
    # only appears when some record carried it — telemetry from runs
    # without --step_hang_timeout keeps the old table shape
    with_age = any("progress_age_max_s" in r for r in doc["passes"])
    # async-checkpoint / packer-pool columns only appear when some record
    # carried them — telemetry from runs without the overlap knobs keeps
    # the old table shape
    with_ckpt = any(r.get("ckpt_blocked_s", 0.0) > 0 for r in doc["passes"])
    with_pack = any("pack_busy_mean" in r for r in doc["passes"])
    # memory/numerics columns: per-pass worst HBM peak (GB — absent on
    # backends without allocator stats, where records carry RSS only)
    # and the count of layers with nonfinite gradients that pass
    with_hbm = any("hbm_peak_bytes" in r for r in doc["passes"])
    with_nf_layers = any("nf_layers" in r for r in doc["passes"])
    # sparse rows/s column: only when some pass carried a kind=sparse
    # record (runs without sparse tables keep the old table shape)
    with_sparse = any("sparse_rows_per_sec" in r for r in doc["passes"])
    header = (
        f"{'pass':>5} {'samples':>9} {'AvgCost':>10} {'p50 ms':>8} "
        f"{'p99 ms':>8} {'data-wait':>9} {'nf':>4} {'retry':>5} {'fault':>5}"
    )
    if with_age:
        header += f" {'age s':>6}"
    if with_ckpt:
        header += f" {'ckpt blk s':>10}"
    if with_pack:
        header += f" {'pack busy':>9}"
    if with_hbm:
        header += f" {'hbm pk':>8}"
    if with_nf_layers:
        header += f" {'nf lyr':>6}"
    if with_sparse:
        header += f" {'rows/s':>9}"
    lines = [header]
    for row in doc["passes"]:
        line = (
            f"{row['pass']:>5} {row.get('samples', 0):>9} "
            f"{row.get('AvgCost', float('nan')):>10.5g} "
            f"{row.get('step_time_p50_s', 0.0) * 1e3:>8.2f} "
            f"{row.get('step_time_p99_s', 0.0) * 1e3:>8.2f} "
            f"{row.get('data_wait_share', 0.0) * 100:>8.1f}% "
            f"{int(row.get('nonfinite', 0)):>4} "
            f"{int(row.get('retries', 0)):>5} "
            f"{int(row.get('faults', 0)):>5}"
        )
        if with_age:
            line += f" {row.get('progress_age_max_s', 0.0):>6.2f}"
        if with_ckpt:
            line += f" {row.get('ckpt_blocked_s', 0.0):>10.4f}"
        if with_pack:
            line += f" {row.get('pack_busy_mean', 0.0):>9.2f}"
        if with_hbm:
            hbm = row.get("hbm_peak_bytes")
            line += f" {hbm / 1e9:>7.2f}G" if hbm is not None else f" {'-':>8}"
        if with_nf_layers:
            line += f" {int(row.get('nf_layers', 0)):>6}"
        if with_sparse:
            rps = row.get("sparse_rows_per_sec")
            line += (f" {rps:>9.3g}" if rps is not None else f" {'-':>9}")
        lines.append(line)
    if doc["checkpoints"]:
        lines.append("")
        lines.append(f"{'checkpoint':<10} {'pass':>5} {'secs':>8} {'MB':>9}")
        for c in doc["checkpoints"]:
            lines.append(
                f"{c.get('op', '?'):<10} {c.get('pass', -1):>5} "
                f"{c.get('duration_s', 0.0):>8.3f} "
                f"{c.get('bytes', 0) / 1e6:>9.2f}"
            )
    if doc.get("compiles"):
        # one row per launch-group (re)compile: where the trace/compile
        # seconds went and whether the persistent cache absorbed the
        # XLA half (`--compile_cache_dir`)
        lines.append("")
        lines.append(
            f"{'compile':<12} {'sig':<10} {'pass':>5} {'trace s':>8} "
            f"{'compile s':>9} {'cache':>6} {'GFLOP':>8}"
        )
        for c in doc["compiles"]:
            hit = c.get("cache_hit")
            flops = c.get("flops_analytic") or c.get("flops")
            lines.append(
                f"{c.get('group', '?'):<12} {c.get('sig', '?'):<10} "
                f"{c.get('pass', -1):>5} {c.get('trace_s', 0.0):>8.3f} "
                f"{c.get('compile_s', 0.0):>9.3f} "
                f"{'hit' if hit is True else 'miss' if hit is False else '-':>6} "
                f"{flops / 1e9 if flops else 0.0:>8.3g}"
            )
        t = doc.get("compile_totals") or {}
        if t:
            lines.append(
                f"compile totals: {t['count']} compilation(s), trace "
                f"{t['trace_s']:.3f}s + compile {t['compile_s']:.3f}s, "
                f"cache {t['cache_hits']} hit(s) / {t['cache_misses']} "
                "miss(es)"
            )
    if doc.get("restarts"):
        # one row per (re)start: restore cost vs full time-to-first-step
        # (restore + trace + compile + step 1) — the gap between them is
        # startup work a checkpoint cannot shrink. `resumed` separates
        # cold starts from checkpoint restores.
        lines.append("")
        lines.append(
            f"{'restart':<8} {'host':>4} {'pass':>5} {'restore s':>9} "
            f"{'ttfs s':>8} {'resumed':>7}"
        )
        for i, r in enumerate(doc["restarts"]):
            lines.append(
                f"{i:<8} {r.get('host', 0):>4} {r.get('pass', -1):>5} "
                f"{r.get('restore_s', 0.0):>9.3f} "
                f"{r.get('time_to_first_step_s', 0.0):>8.3f} "
                f"{'yes' if r.get('resumed') else 'no':>7}"
            )
        lat = doc.get("restart_latency") or {}
        if lat:
            lines.append(
                f"restart latency: worst restore "
                f"{lat['restore_s_max']:.3f}s, worst time-to-first-step "
                f"{lat['time_to_first_step_s_max']:.3f}s over "
                f"{lat['rounds']} round(s) — tune --heartbeat_startup_grace "
                "and crash-loop windows above the ttfs number"
            )
    if doc.get("memory"):
        lines.append("")
        last = doc["memory"]["last"]
        parts = []
        for h in sorted(last):
            rec = last[h]
            peak = rec.get("hbm_peak_bytes")
            parts.append(
                f"host {h}: "
                + (f"hbm peak {peak / 1e9:.2f} GB, " if peak is not None else "")
                + f"rss {rec.get('host_rss_bytes', 0) / 1e9:.2f} GB"
            )
        lines.append(
            "memory telemetry: " + "; ".join(parts)
            + " — `paddle memory <run_dir>` for the per-launch-group table"
        )
    if doc.get("numerics"):
        n = doc["numerics"]
        lines.append("")
        line = f"numerics telemetry: {n['records']} record(s)"
        if n["nonfinite_layers"]:
            line += (
                f", nonfinite gradients in: "
                + ", ".join(n["nonfinite_layers"])
            )
        lines.append(line)
    if doc.get("serve"):
        s = doc["serve"]
        lines.append("")
        line = (
            f"serve telemetry: {s['requests']} request record(s), "
            f"{s['windows']} window(s) over {s['rungs']} offered-load "
            "rung(s)"
        )
        if s["windows"]:
            # serve-report needs windows — don't point at a tool that
            # would exit 1 on an oneshot-only (embedding API) stream
            line += (" — `paddle serve-report <run_dir>` for the "
                     "latency/goodput table")
        lines.append(line)
        wins = doc.get("serve_windows") or []
        if any(w.get("replica") for w in wins):
            # fleet run: merged per-rung view with a replica column
            # (replica-stamped rows from the child streams, plus any
            # replicas=N merged rollups labelled "merged")
            lines.append(
                f"{'rung':>4} {'replica':<12} {'rps':>7} {'completed':>9} "
                f"{'p99 s':>8} {'goodput':>9}"
            )
            for w in wins:
                lat = w.get("latency") or {}
                name = str(w.get("replica") or
                           ("merged" if w.get("replicas") else "-"))
                lines.append(
                    f"{w.get('rung') or 0:>4} {name:<12} "
                    f"{float(w.get('offered_rps') or 0.0):>7.2f} "
                    f"{int(w.get('completed') or 0):>9} "
                    f"{float(lat.get('p99') or 0.0):>8.4f} "
                    f"{float(w.get('goodput_tok_s') or 0.0):>9.1f}"
                )
    if doc["straggler"] and doc["straggler"].get("line"):
        lines.append("")
        lines.append(doc["straggler"]["line"])
    if doc["warnings"]:
        lines.append("")
        for w in doc["warnings"]:
            lines.append(f"! {w}")
    return "\n".join(lines)


def follow(run_dir: str, poll_s: float = 0.5,
           max_polls: Optional[int] = None,
           poll_boundaries: bool = False,
           with_stream: bool = False) -> Iterator[Any]:
    """Live-tail every ``metrics*.jsonl`` stream of a run dir.

    Yields each newly appended record in file order, re-discovering
    per-host stream files as they appear (a late host joining mid-run,
    or a fleet replica's ``replica-*/`` stream dir materializing after
    the router's — :func:`metrics.fleet_stream_dirs` re-runs every
    poll). Torn-tail tolerant like :func:`metrics.read_records`: only
    complete (newline-terminated) lines are consumed — a partially
    flushed tail stays buffered in the file until its newline lands, so
    a record is never yielded twice or half-parsed. ``max_polls``
    bounds the scan loop for tests; the CLI polls until interrupted or
    ``run_end``. ``poll_boundaries=True`` additionally yields ``None``
    after each full scan over every stream — the only safe point to
    decide "all observed hosts are done" (mid-scan, later hosts' files
    are still unread). ``with_stream=True`` yields ``(stream_label,
    record)`` pairs instead — label ``""`` for the run dir's own
    streams, the subdir name for discovered replica streams — so the
    CLI can tell the router's ``run_end`` from a replica's."""
    offsets: Dict[str, int] = {}
    polls = 0
    base = os.path.normpath(run_dir)
    while True:
        for d in obs.fleet_stream_dirs(run_dir):
            label = ("" if os.path.normpath(d) == base
                     else os.path.basename(os.path.normpath(d)))
            for path in obs.metrics_files(d):
                pos = offsets.get(path, 0)
                try:
                    if os.path.getsize(path) < pos:
                        # file shrank: truncated/recreated (run dir
                        # reused) — restart this stream from the top
                        # instead of waiting forever past its EOF
                        pos = offsets[path] = 0
                    with open(path) as f:
                        f.seek(pos)
                        data = f.read()
                except OSError:
                    continue
                end = data.rfind("\n")
                if end < 0:
                    continue  # nothing complete yet (or a torn tail)
                offsets[path] = pos + end + 1
                # same torn-line tolerance policy as every reader
                for rec in obs.parse_record_lines(data[:end]):
                    yield (label, rec) if with_stream else rec
        polls += 1
        if poll_boundaries:
            yield None
        if max_polls is not None and polls >= max_polls:
            return
        time.sleep(poll_s)


def _follow_cli(run_dir: str) -> int:
    """``paddle metrics --follow``: print each new record as a JSON line
    (tail -f for the telemetry stream) until the run ends or ^C. A pod
    run has one stream per host, each with its own ``run_end`` — the
    tail stops only once every OBSERVED host has COMPLETED (hosts are
    tracked from the records themselves — stream-file counts can
    mismatch host ids when a run dir is reused across topologies): a
    ``status="preempted"`` run_end means the supervisor is about to
    relaunch into the same stream, and a later ``run_start`` from a
    host un-ends it. Hosts that crash without a run_end keep the tail
    alive (^C to stop) — silence is not completion.

    Fleet run dirs (any ``replica-*/`` stream discovered) change the
    stop rule: replicas come and go — a killed replica's stream never
    completes and a restarted one re-opens — so only the ROUTER's own
    ``run_end status="completed"`` (the run dir's root stream, which
    the router writes last, after every child is reaped) ends the
    tail."""
    seen: set = set()      # (stream_label, host) pairs
    ended: set = set()
    fleet = False
    try:
        for item in follow(run_dir, poll_boundaries=True,
                           with_stream=True):
            if item is None:
                # full scan over every stream done — the only safe
                # point to conclude: mid-scan, later hosts' files are
                # still unread and would look "never seen"
                if fleet:
                    if any(key[0] == "" for key in ended):
                        print("# router run_end — fleet run complete",
                              file=sys.stderr)
                        return 0
                elif seen and ended >= seen:
                    print("# run_end on every observed host — complete",
                          file=sys.stderr)
                    return 0
                continue
            label, rec = item
            print(json.dumps(rec, default=str), flush=True)
            key = (label, rec.get("host", 0))
            kind = rec.get("kind")
            seen.add(key)
            fleet = fleet or label.startswith("replica-")
            if kind == "run_end" and rec.get("status") == "completed":
                ended.add(key)
            elif kind == "run_start":
                ended.discard(key)
    except KeyboardInterrupt:
        return 0
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="paddle metrics",
        description="summarize a run's metrics.jsonl telemetry",
    )
    p.add_argument("run_dir", help="run dir (or one metrics*.jsonl file)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="emit the full analysis as JSON")
    p.add_argument("--tail", type=int, default=0, metavar="N",
                   help="also print the last N raw records per host")
    p.add_argument("--follow", action="store_true",
                   help="live-tail the stream: print each new record as "
                        "a JSON line until run_end or ^C (long runs can "
                        "be watched without re-parsing from zero)")
    args = p.parse_args(argv)

    if args.follow:
        # a not-yet-started run dir is fine: streams are discovered as
        # they appear
        if not os.path.isdir(args.run_dir) and not os.path.isfile(args.run_dir):
            print(f"{args.run_dir!r} does not exist (yet?) — waiting for "
                  "streams to appear", file=sys.stderr)
        return _follow_cli(args.run_dir)

    files = obs.metrics_files(args.run_dir)
    if not files:
        print(f"no metrics*.jsonl under {args.run_dir!r} "
              "(was the run started with --metrics_path / --save_dir?)",
              file=sys.stderr)
        return 1
    doc = analyze(load_run(args.run_dir))
    if args.as_json:
        print(json.dumps(doc, indent=2, default=str))
    else:
        print(f"# metrics: {', '.join(files)}")
        print(_fmt_table(doc))
        if args.tail:
            for host, recs in sorted(obs.read_tail(args.run_dir, args.tail).items()):
                print(f"\n-- host {host}: last {len(recs)} records --")
                for rec in recs:
                    print(json.dumps(rec, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
