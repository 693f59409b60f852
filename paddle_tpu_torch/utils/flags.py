"""Global process flags.

Analog of the reference's gflags layer (/root/reference/paddle/utils/
Flags.cpp:19-68 and CommandLineParser.h). One flat namespace consumed by the
CLI and the trainer; programs may also set them directly
(``FLAGS.use_tpu = True``). GPU-era flags that have no TPU meaning
(nics/rdma/ports_num...) are intentionally absent; their roles are served by
the mesh spec (see paddle_tpu_torch.parallel).
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass, field, fields
from typing import List, Optional


@dataclass
class _Flags:
    # device / mesh
    use_tpu: bool = True                 # reference: -use_gpu
    trainer_count: int = 0               # >1 = data=N mesh; 0/1 = single program
                                         # (reference: -trainer_count; use --mesh_shape
                                         # for multi-axis parallelism)
    mesh_shape: str = ""                 # e.g. "data=8" or "data=4,model=2"
    # jobs
    job: str = "train"                   # train | test | checkgrad
    config: str = ""                     # user config script
    config_args: str = ""                # k=v,k2=v2 passed to the config
    # training control
    num_passes: int = 100
    start_pass: int = 0
    test_period: int = 0                 # batches; 0 = test at pass end
    log_period: int = 100
    dot_period: int = 1
    saving_period: int = 1               # passes between checkpoints
    saving_period_by_batches: int = 0
    # preemption-aware checkpoint: SIGTERM during train() saves at the
    # next launch boundary and exits cleanly (TPU pods preempt with a
    # SIGTERM notice; resume via --init_model_path + --start_pass)
    save_on_preempt: bool = True
    save_dir: str = ""
    # a pass dir, or "auto": restore the newest checkpoint under
    # save_dir that passes manifest verification (fresh start when none)
    init_model_path: str = ""
    load_missing_parameter_strategy: str = "fail"   # fail | rand | zero
    show_parameter_stats_period: int = 0
    test_pass: int = -1
    test_wait: bool = False
    predict_output_dir: str = ""
    gen_result: str = ""                 # gen job output file (overrides config)
    # profiling (the reference's WITH_TIMER/BarrierStat analogs ride the
    # jax profiler: xplane traces with the stat_timer scope annotations)
    profile_dir: str = ""                # write a profiler trace here
    profile_start_batch: int = 5
    profile_num_batches: int = 10
    # observability (doc/observability.md): per-host structured telemetry.
    # metrics_path: run dir for the append-only metrics.jsonl stream
    # (empty = use --save_dir when set, else telemetry off);
    # trace_events_path: export stat_timer scopes as Chrome trace-event
    # JSON here (host-side spans; composes with --profile_dir's device
    # xplanes via the shared scope names)
    metrics_path: str = ""
    trace_events_path: str = ""
    # persistent XLA compilation cache (doc/observability.md "Compile
    # telemetry"): compiled launch groups are cached here across
    # processes, so elastic relaunches and repeat runs skip the XLA
    # backend compile of unchanged steps — compile records then show
    # cache_hit=true and the restart record a lower
    # time_to_first_step_s ("" disables; point every host of a pod at a
    # shared dir)
    compile_cache_dir: str = ""
    # resilience (doc/resilience.md)
    # fault injection: site=action[:arg][@trigger];... (see
    # paddle_tpu/resilience/faultinject.py; PADDLE_TPU_FAULTS env also works)
    fault_spec: str = ""
    fault_seed: int = 0
    # data-pipeline watchdog: no provider progress (not even one SAMPLE
    # pulled) for this many seconds raises DataStallError instead of
    # hanging (0 disables). Generous default: 30 min of true dead air is
    # indistinguishable from a hang
    data_stall_timeout: float = 1800.0
    # host-overlap knobs (doc/performance.md "Zero-stall host"):
    # async_checkpoint moves checkpoint serialize/fsync/rename off the
    # step loop onto a background writer — save() only pays the
    # device→host snapshot; ckpt_inflight_limit bounds queued background
    # saves (drop-oldest-pending beyond it). data_packer_threads packs
    # batches on an N-thread pool (the native C packers release the
    # GIL); prefetch_depth is the order-preserving packed-batch queue
    # depth between the packers and the step loop.
    async_checkpoint: bool = False
    ckpt_inflight_limit: int = 1
    # multi-process async saves: how long drain()'s pass-end commit
    # agreement (host KV rendezvous) waits for the slowest peer's
    # background shard write before declaring the pod torn
    ckpt_agree_timeout: float = 600.0
    data_packer_threads: int = 2
    prefetch_depth: int = 4
    # skip-and-log up to N malformed samples per provider, then fail
    # (0 = fail on the first one, the old behavior)
    max_bad_samples: int = 0
    # shared transient-I/O retry policy (checkpoint I/O, provider reads):
    # exponential backoff from io_retry_base_delay, capped attempts and
    # total elapsed seconds
    io_retry_attempts: int = 4
    io_retry_base_delay: float = 0.25
    io_retry_deadline: float = 120.0
    # divergence policy: what a non-finite (NaN/Inf) training loss does.
    # abort = raise NonFiniteLossError immediately (the reference's FP
    # trap); skip = discard the poisoned update and continue; rollback =
    # restore the newest verified checkpoint, scale the learning rate by
    # rollback_lr_scale, and fast-forward past the poison region. skip
    # and rollback disable step-buffer donation (~2x parameter memory)
    # and are bounded by max_nonfinite_steps total events per run.
    nonfinite_policy: str = "abort"      # abort | skip | rollback
    max_nonfinite_steps: int = 3
    rollback_lr_scale: float = 0.5
    # per-layer model-health telemetry (observability/numerics.py):
    # every N batches, read back the in-step health aux (grad norm /
    # param norm / update ratio / nonfinite count per layer — computed
    # inside the jitted step, so enabling it never recompiles) and emit
    # a kind=numerics record. 0 disables (no aux, no readback).
    numerics_log_period: int = 0
    # row-sharded sparse-parameter training (paddle_tpu/sparse/,
    # doc/sparse.md): sparse_row_budget caps how many embedding-table
    # rows one host may hold (0 = unlimited) — the trainer refuses to
    # start, and cluster_launch refuses a relaunch round, when the
    # host set cannot hold every sparse_update table within the
    # budget; sparse_total_rows declares the largest table's row count
    # to the (jax-free) cluster_launch supervisor so it can apply the
    # same refusal without importing the model config
    sparse_row_budget: int = 0
    sparse_total_rows: int = 0
    # hang defense (resilience/hangwatch.py): no step-loop progress for
    # this many seconds dumps all thread stacks + telemetry tail into
    # hang_report.json and exits EXIT_HANG=19 (0 disables). Set it
    # comfortably above the worst-case launch + in-pass save/test time.
    step_hang_timeout: float = 0.0
    # cluster liveness (resilience/heartbeat.py): each host renews a
    # heartbeat file under heartbeat_dir (default <save_dir>/heartbeats)
    # every heartbeat_interval seconds (0 disables); an observer
    # (cluster_launch) declares a host wedged after heartbeat_stale_after
    # seconds of silence (0 = 3x the interval)
    heartbeat_interval: float = 0.0
    heartbeat_stale_after: float = 0.0
    heartbeat_dir: str = ""
    # run supervision (`paddle supervise`, resilience/supervisor.py):
    # restart a dead `paddle train` child with exponential backoff and
    # --init_model_path=auto, at most restart_budget times; repeated
    # death at the same restored checkpoint for crash_loop_threshold
    # consecutive attempts is classified as poison (stop + JSON crash
    # report under supervise_dir, default <save_dir>/supervise)
    restart_budget: int = 5
    restart_base_delay: float = 1.0
    crash_loop_threshold: int = 3
    supervise_dir: str = ""
    # print the child command + restart policy without launching
    # (`paddle supervise --dry_run`)
    dry_run: bool = False
    # serving (`paddle serve`, paddle_tpu/serving/, doc/serving.md):
    # the continuous-batching engine holds serve_slots concurrent
    # decode sequences in donated device buffers; serve_queue_cap
    # rejects submits past the bound (0 = unbounded queue);
    # serve_request_timeout is each request's wall-clock deadline from
    # submission — expiry frees the queue entry or the decode slot at
    # the next iteration boundary (outcome=timeout);
    # serve_prompt_tokens is the fixed prompt padding width (ONE
    # prefill signature — longer prompts truncate); serve_decode_block
    # is the decode-block LADDER — decode micro-steps per launch, a
    # single int or a comma list like "1,2,4,8" the engine's adaptive
    # policy picks from per iteration (amortizes dispatch; admission/
    # eviction happen at block boundaries; one compiled signature
    # covers the whole ladder); serve_pipeline overlaps host scheduling
    # with the in-flight decode launch (dispatch/collect split — off =
    # the serial PR-12 loop, the A/B baseline); serve_fused_step swaps
    # the per-step graph walk for the extracted attention-GRU step math
    # (ops/pallas_attention_gru.attention_gru_step; template-matched,
    # token-parity-pinned, refuses non-matching models loudly)
    serve_slots: int = 8
    serve_queue_cap: int = 0
    serve_request_timeout: float = 60.0
    serve_prompt_tokens: int = 32
    serve_decode_block: str = "1"
    serve_pipeline: bool = True
    serve_fused_step: bool = False
    # speculative decode + slot-state precision (doc/serving.md
    # "Speculative decode" / "Reduced-precision slot state"):
    # serve_spec_tokens is the draft-length LADDER — max draft tokens
    # per verify launch, a single int or comma list like "2,4" the
    # engine's acceptance-EMA policy picks from ("0" disables; drafts
    # come from a host-side n-gram table fed by committed tokens, ONE
    # fused serve_verify signature covers the whole ladder, greedy
    # output is bit-identical to plain decode); serve_slot_dtype
    # stores GRU carries + captured statics in f32 or bf16 (compute
    # stays f32 — bf16 roughly halves per-slot HBM so --serve_slots
    # can double at fixed footprint, token parity within tolerance)
    serve_spec_tokens: str = "0"
    serve_slot_dtype: str = "f32"
    # serving resilience (doc/resilience.md "Serving resilience"):
    # serve_hang_timeout — no collect-boundary progress for this many
    # seconds dumps serve_hang_report.json (thread stacks + in-flight
    # cohort), answers in-flight requests outcome=error, exits 19
    # (0 disables); serve_shed_policy — off | deadline (shed queued
    # requests whose deadline the measured prefill+decode estimate
    # can't cover, at admission) | brownout (deadline + sustained
    # queue-pressure EMA caps output budgets and sheds new arrivals
    # with a retry-after hint); serve_breaker_threshold — N consecutive
    # launch faults open a reject-fast circuit breaker for
    # serve_breaker_cooldown seconds (0 disables);
    # serve_journal_path — durable JSONL request journal: accepted
    # requests are fsynced before submission and re-offered on restart
    # (at-least-once, dedupe by id); status_path — atomic health JSON
    # renewed every second (queue depth, occupancy, last-collect age,
    # shed/error totals, draining) for load-balancer probes and
    # `paddle serve-status`
    serve_hang_timeout: float = 0.0
    serve_shed_policy: str = "off"
    serve_breaker_threshold: int = 0
    serve_breaker_cooldown: float = 30.0
    serve_journal_path: str = ""
    status_path: str = ""
    # serving fleet (`paddle serve-fleet`, serving/fleet.py, doc/
    # serving.md "Serving fleet"): fleet_replicas `paddle serve`
    # children behind one stdin-JSONL router balancing on each
    # replica's health JSON; fleet_status_dir holds the per-replica
    # status/journal/metrics files (default <save_dir>/fleet_status) —
    # also what `paddle serve-status <dir>` aggregates;
    # serve_reload_watch — a checkpoint save_dir each replica watches:
    # when a NEWER durable (manifest-verified) checkpoint lands there,
    # weights hot-swap at the next iteration boundary without dropping
    # in-flight or queued requests ("" disables)
    fleet_replicas: int = 2
    fleet_status_dir: str = ""
    serve_reload_watch: str = ""
    # cross-host fleet (serving/transport.py, doc/serving.md "Cross-host
    # fleet"): listen — `paddle serve --listen HOST:PORT` accepts
    # length-prefixed JSON frames over TCP instead of stdin JSONL (same
    # journal/dedupe/drain contract; port 0 = ephemeral, the bound
    # address is printed on stderr); replica_addr — `paddle serve-fleet
    # --replica_addr HOST:PORT` (repeatable, or one comma list) routes
    # to remote listeners through SocketReplica instead of spawning
    # pipe children (reconnect/backoff via the --io_retry_* policy);
    # hedge_after — a request outstanding on one replica longer than
    # max(hedge_after, adaptive p99 of observed answer latency) seconds
    # is re-sent to the next-healthiest replica, first answer wins
    # (0 disables hedging; works for pipe and socket fleets alike)
    listen: str = ""
    replica_addr: str = ""
    hedge_after: float = 0.0
    # `paddle supervise` child job: train (default) or serve — a serve
    # child keeps its args on restart (no --init_model_path=auto
    # injection; the request journal is its resume state) and its
    # crash-loop probe reads journal progress instead of checkpoints
    supervise_job: str = "train"
    # rng
    seed: int = 1
    # distributed (multi-host jax)
    coordinator_address: str = ""
    num_processes: int = 1
    process_id: int = 0
    # misc
    use_double: bool = False                 # reference: WITH_DOUBLE build

    def parse(self, argv: Optional[List[str]] = None) -> List[str]:
        """Parse known flags from argv (``--flag=value`` style); returns leftovers."""
        p = argparse.ArgumentParser(add_help=False)
        for f in fields(self):
            if f.type == "bool" or isinstance(getattr(self, f.name), bool):
                p.add_argument(f"--{f.name}", type=_parse_bool, default=getattr(self, f.name))
            else:
                p.add_argument(f"--{f.name}", type=type(getattr(self, f.name)), default=getattr(self, f.name))
        ns, rest = p.parse_known_args(argv)
        for f in fields(self):
            setattr(self, f.name, getattr(ns, f.name))
        return rest


def _parse_bool(v: str) -> bool:
    return str(v).lower() in ("1", "true", "yes", "on")


def flag_value(argv: List[str], name: str, default: str = "") -> str:
    """Last occurrence of ``--name=value`` / ``--name value`` in an argv
    list, without a full parse. Used by wrappers (cluster_launch) that
    forward train flags verbatim but need to READ a few of them — e.g.
    the heartbeat settings — so there is exactly one source of truth:
    the flags the trainers themselves will run with."""
    out = default
    for i, a in enumerate(argv):
        if a == f"--{name}":
            if i + 1 < len(argv):
                out = argv[i + 1]
        elif a.startswith(f"--{name}="):
            out = a[len(name) + 3:]
    return out


def flag_values(argv: List[str], name: str) -> List[str]:
    """Every occurrence of ``--name=value`` / ``--name value`` in an argv
    list, in order, with comma lists split. The repeatable-flag
    companion to :func:`flag_value` — e.g. ``paddle serve-fleet
    --replica_addr h1:9000 --replica_addr h2:9000`` (or the equivalent
    ``--replica_addr h1:9000,h2:9000``) yields both addresses."""
    out: List[str] = []
    for i, a in enumerate(argv):
        v = None
        if a == f"--{name}":
            if i + 1 < len(argv):
                v = argv[i + 1]
        elif a.startswith(f"--{name}="):
            v = a[len(name) + 3:]
        if v is not None:
            out.extend(p for p in (s.strip() for s in v.split(",")) if p)
    return out


def strip_flag(argv: List[str], name: str) -> List[str]:
    """Remove every occurrence of ``--name=value`` / ``--name value``
    from an argv list. Shared by the restart paths (supervisor, cluster
    launcher) that replace a user's flag with their own — e.g. swapping
    ``--init_model_path`` for ``auto`` on relaunch."""
    out: List[str] = []
    skip_next = False
    for a in argv:
        if skip_next:
            skip_next = False
            continue
        if a == f"--{name}":
            skip_next = True  # the space-separated value form
            continue
        if a.startswith(f"--{name}="):
            continue
        out.append(a)
    return out


FLAGS = _Flags()
