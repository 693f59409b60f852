"""``paddle serve`` — the engine's process front-end.

stdin-JSONL in, JSONL out: each input line is a request
(``{"id": ..., "prompt": [token ids...], "max_new_tokens": N}`` — or a
bare JSON list as the prompt), each output line its result
(``{"id", "outcome", "tokens"}``) in SUBMISSION order. Plain stdin EOF
is a BATCH: every accepted request completes and gets its result line
before exit (``paddle serve < requests.jsonl`` answers the whole
file). SIGTERM (and SIGINT) trigger a graceful drain instead:
in-flight sequences finish, queued and later requests are rejected,
every pending result line is still printed. Either way, when
telemetry is on (``--metrics_path``/``--save_dir``) the stream closes
with ``run_end status=completed`` as its LAST record.

The in-process Python API is :func:`build_engine` + the returned
:class:`~paddle_tpu_torch.serving.engine.Engine`'s ``submit``/``result``
(also reachable as ``api.GradientMachine.asDecodeEngine``).

Port of the JAX package's front door with the same flags, JSONL lines,
exit codes and files on disk. ``--use_tpu=true`` (the default) serves on
the card and fails without one, ``--use_tpu=false`` on the CPU. The port
compiles nothing at serve time (its kernels are built once into
``build/``), so ``--compile_cache_dir`` names nothing to cache here.
"""

from __future__ import annotations

import json
import os
import signal
import sys
from typing import Any, Dict, List, Optional, Tuple

from paddle_tpu_torch.utils import concurrency as cc


def build_engine(machine, params, *, slots: int = 8,
                 prompt_tokens: int = 32, queue_cap: int = 0,
                 request_timeout_s: float = 60.0, decode_block=1,
                 max_length: Optional[int] = None,
                 pipeline: bool = True, fused_step: bool = False,
                 shed_policy: str = "off", breaker_threshold: int = 0,
                 breaker_cooldown_s: float = 30.0, hangwatch=None,
                 on_oom=None, spec_tokens="0", slot_dtype: str = "f32"):
    """Wire a :class:`TorchDecodeBackend` + :class:`Engine` for a core
    graph machine (the in-process serving API). Caller starts it.
    ``decode_block`` takes the ladder spelling ("1,2,4,8" or an int);
    ``pipeline`` selects the overlapped dispatch/collect loop;
    ``fused_step`` the fused attention-GRU step (on the card, one kernel
    launch per micro-step).
    The resilience plane (doc/resilience.md "Serving resilience"):
    ``shed_policy`` off|deadline|brownout, ``breaker_threshold``/
    ``breaker_cooldown_s`` the launch-failure circuit breaker (0
    disables), ``hangwatch`` a started-by-the-engine
    :class:`~paddle_tpu_torch.serving.resilience.ServeHangWatch`, ``on_oom``
    the RESOURCE_EXHAUSTED handler (`paddle serve` installs the
    pre-mortem + exit-20 one). ``spec_tokens`` is the speculative
    draft-length ladder ("0" = off) and ``slot_dtype`` the slot-state
    storage dtype (f32|bf16) — doc/serving.md "Speculative decode" /
    "Reduced-precision slot state"."""
    from paddle_tpu_torch.serving.engine import Engine
    from paddle_tpu_torch.serving.resilience import CircuitBreaker
    from paddle_tpu_torch.serving.torch_backend import TorchDecodeBackend

    backend = TorchDecodeBackend(
        machine, params, slots=slots, prompt_tokens=prompt_tokens,
        max_length=max_length, decode_block=decode_block,
        pipeline=pipeline, fused_step=fused_step,
        spec_tokens=spec_tokens, slot_dtype=slot_dtype,
    )
    breaker = (CircuitBreaker(breaker_threshold, breaker_cooldown_s)
               if breaker_threshold > 0 else None)
    return Engine(backend, queue_cap=queue_cap,
                  request_timeout_s=request_timeout_s, pipeline=pipeline,
                  shed_policy=shed_policy, breaker=breaker,
                  hangwatch=hangwatch, on_oom=on_oom)


def _parse_line(
    line: str, n: int
) -> Tuple[Optional[Dict[str, Any]], str, str]:
    """One stdin line → (request dict, "", id) or (None, error, id).
    The returned id is the client's own whenever one was parseable —
    an error answer under a synthetic id is uncorrelatable — falling
    back to a pid-salted auto id: the line counter restarts at 0 every
    incarnation, and a journaled ``req-0`` from a previous run must
    not make a FRESH id-less request look like a duplicate after a
    supervised restart."""
    rid = f"req-{os.getpid()}-{n}"
    try:
        doc = json.loads(line)
    except ValueError as e:
        return None, f"bad JSON: {e}", rid
    if isinstance(doc, list):
        doc = {"prompt": doc}
    if not isinstance(doc, dict):
        return None, "expected a JSON object or token list", rid
    if "id" in doc:
        rid = str(doc["id"])
    prompt = doc.get("prompt")
    if not isinstance(prompt, list) or not all(
        isinstance(t, int) for t in prompt
    ):
        return None, "prompt must be a list of token ids", rid
    doc["id"] = rid
    return doc, "", rid


def _span(name: str, t0_mono: float, dur_s: float, trace: str) -> None:
    """One replica-side ``kind=span`` hop record (doc/observability.md
    "Distributed tracing"). ``trace`` is the opaque ``trace_id`` the
    router stamped on the forwarded request — absent (direct stdin
    clients) means no span, so single-process runs keep their streams
    unchanged. ``t0_mono`` is a ``cc.monotonic`` reading, mapped into
    the stream's ``t``-offset timebase by ``rel_time``."""
    if not trace:
        return
    from paddle_tpu_torch.observability import metrics as obsm

    if not obsm.enabled():
        return
    obsm.emit("span", name=name, t0=obsm.rel_time(t0_mono),
              dur_s=round(max(float(dur_s), 0.0), 6), trace=trace)


def _serve_listen(engine, journal, status, reloader) -> int:
    """``paddle serve --listen HOST:PORT`` (doc/serving.md "Cross-host
    fleet"): the socket front door. Framed requests in, framed answers
    out in submission order, the same journal/dedupe/drain contract as
    the stdin path — a `paddle serve-fleet --replica_addr` router on
    another host is the expected client. Runs until SIGTERM/SIGINT or
    a ``drain`` control frame, then drains exactly like stdin EOF."""
    from paddle_tpu_torch.observability import metrics as obsm
    from paddle_tpu_torch.serving.transport import EngineSocketServer
    from paddle_tpu_torch.utils.flags import FLAGS

    drain = cc.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: drain.set())
    server = EngineSocketServer(engine, FLAGS.listen, journal=journal,
                                on_drain=drain.set)
    # a restarted replica re-offers its journal backlog FIRST; the
    # answers queue for whichever router connects (at-least-once)
    if journal is not None:
        replay = journal.pending()
        if replay:
            print(f"# paddle serve: re-offering {len(replay)} journaled "
                  "request(s) from a previous run", file=sys.stderr)
        for doc in replay:
            server.replay(doc)
    server.start()
    # the bound address line is the startup contract (--listen :0
    # binds an ephemeral port; launchers parse this line)
    print(f"# paddle serve: listening on {server.address}",
          file=sys.stderr, flush=True)
    while not drain.is_set():
        drain.wait(timeout=0.5)
    print("# paddle serve: drain requested", file=sys.stderr)
    if reloader is not None:
        reloader.stop()
    engine.drain(timeout=600.0)
    server.wait_idle(timeout=600.0)   # every accepted answer framed out
    server.close()
    if status is not None:
        status.stop()
    if journal is not None:
        journal.close()
    if obsm.enabled():
        engine.window_roll()
        obsm.emit("run_end", status="completed")
        obsm.flush()
    print("# paddle serve: drained", file=sys.stderr)
    return 0


def main(rest: List[str]) -> int:
    from paddle_tpu_torch.utils.flags import FLAGS

    leftover = FLAGS.parse(list(rest))
    if leftover:
        print(f"warning: unrecognized flags {leftover}", file=sys.stderr)
    if FLAGS.compile_cache_dir:
        # the kernels are built once into build/ and nothing compiles at
        # serve time: the flag is accepted and names nothing to cache
        print(f"# paddle serve: --compile_cache_dir={FLAGS.compile_cache_dir} "
              "names nothing to cache (the kernels are built once into "
              "build/; nothing compiles at serve time)", file=sys.stderr)
    if not FLAGS.config:
        print("error: --config is required", file=sys.stderr)
        return 2
    from paddle_tpu_torch.config import parse_config
    from paddle_tpu_torch.observability import metrics as obsm

    config = parse_config(FLAGS.config, FLAGS.config_args)
    obsm.configure_from_flags(FLAGS)
    if FLAGS.fault_spec:
        # serve.* chaos sites (doc/resilience.md "Serving resilience")
        from paddle_tpu_torch.resilience import faultinject

        faultinject.configure(FLAGS.fault_spec, FLAGS.fault_seed)

    import torch

    from paddle_tpu_torch import api
    from paddle_tpu_torch.resilience import EXIT_OOM
    from paddle_tpu_torch.resilience.hangwatch import run_dir_of
    from paddle_tpu_torch.serving.resilience import (
        RequestJournal,
        ServeHangWatch,
        StatusWriter,
        WeightReloader,
    )
    from paddle_tpu_torch.serving.torch_backend import UnsupportedModelError

    # --use_tpu=true (the default): the card, which raises without one
    am = api.GradientMachine(config.model_config, seed=FLAGS.seed,
                             device=None if FLAGS.use_tpu else "cpu")
    if FLAGS.init_model_path:
        am.loadParameters(FLAGS.init_model_path)
    else:
        print("# serving randomly initialized parameters "
              "(no --init_model_path)", file=sys.stderr)
    device_kind = (torch.cuda.get_device_name(am.device)
                   if am.device.type == "cuda" else "cpu")
    # forensics land next to the telemetry (or the cwd, telemetry-less):
    # serve_hang_report.json / oom_report.json — where `paddle
    # supervise` looks for them
    report_dir = run_dir_of(FLAGS.metrics_path or FLAGS.save_dir or ".")
    hangwatch = (ServeHangWatch(FLAGS.serve_hang_timeout, report_dir)
                 if FLAGS.serve_hang_timeout > 0 else None)

    def _on_oom(e: BaseException) -> None:
        # the engine already answered everything outcome=error; classify
        # the death for the supervisor: pre-mortem (allocator stats,
        # telemetry tail, 30s backstop) + the distinct exit code. An OOM
        # loop is deterministic poison — `paddle supervise` charges it
        # to the restart budget, never restarts it for free.
        from paddle_tpu_torch.observability.memory import trigger_oom_report

        trigger_oom_report(
            report_dir, e, groups=None, live=None, where=None,
            device_kind=device_kind, exit_fn=os._exit,
        )
        obsm.flush()
        os._exit(EXIT_OOM)

    try:
        engine = build_engine(
            am._core, am.params,
            slots=FLAGS.serve_slots,
            prompt_tokens=FLAGS.serve_prompt_tokens,
            queue_cap=FLAGS.serve_queue_cap,
            request_timeout_s=FLAGS.serve_request_timeout,
            decode_block=FLAGS.serve_decode_block,
            pipeline=FLAGS.serve_pipeline,
            fused_step=FLAGS.serve_fused_step,
            shed_policy=FLAGS.serve_shed_policy,
            breaker_threshold=FLAGS.serve_breaker_threshold,
            breaker_cooldown_s=FLAGS.serve_breaker_cooldown,
            hangwatch=hangwatch,
            on_oom=_on_oom,
            spec_tokens=FLAGS.serve_spec_tokens,
            slot_dtype=FLAGS.serve_slot_dtype,
        )
    except (UnsupportedModelError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    journal = (RequestJournal(FLAGS.serve_journal_path)
               if FLAGS.serve_journal_path else None)
    engine.start()
    status = None
    if FLAGS.status_path:
        status = StatusWriter(FLAGS.status_path, engine).start()
    reloader = None
    if FLAGS.serve_reload_watch:
        # hot weight reload (doc/serving.md "Serving fleet"): when a
        # NEWER durable checkpoint lands under the watch dir, load it
        # through the same loadParameters path the startup weights took
        # and stage it for the next iteration boundary — in-flight and
        # queued requests are untouched
        def _load_ckpt(path: str):
            am.loadParameters(path)
            return am.params

        reloader = WeightReloader(FLAGS.serve_reload_watch, engine,
                                  _load_ckpt).start()
        print(f"# paddle serve: watching {FLAGS.serve_reload_watch} for "
              "durable checkpoints (hot weight reload)", file=sys.stderr)
    if FLAGS.listen:
        # the socket front door replaces the stdin reader wholesale —
        # same engine, journal, status, and reload planes
        return _serve_listen(engine, journal, status, reloader)
    print(f"# paddle serve: {engine.slots} slot(s), max_length "
          f"{engine.max_length}, decode blocks {FLAGS.serve_decode_block}, "
          f"pipeline {'on' if FLAGS.serve_pipeline else 'off'}"
          f"{', fused step' if FLAGS.serve_fused_step else ''}"
          f"{', spec ' + FLAGS.serve_spec_tokens if FLAGS.serve_spec_tokens not in ('', '0') else ''}"
          f"{', slot dtype ' + FLAGS.serve_slot_dtype if FLAGS.serve_slot_dtype != 'f32' else ''} — "
          "reading JSONL requests from stdin", file=sys.stderr)

    drain = cc.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: drain.set())

    # (id, future, trace_id), submission order — the trace_id rides to
    # the result line so the router can re-correlate the echo
    pending: List[Tuple[str, Any, str]] = []
    plock = cc.Lock()
    # one printer at a time: the main loop, the reader's error lines and
    # the hang's answer flush (the hangwatch thread) all print results. A
    # line is one write, and a flush holds the lock from the pop to the
    # print, so lines never run together and keep submission order
    olock = cc.RLock()

    def _answer(doc: Dict[str, Any]) -> None:
        with olock:
            sys.stdout.write(json.dumps(doc) + "\n")
            sys.stdout.flush()
    eof = cc.Event()
    n_lines = [0]   # reader progress — the drain path waits for it to
    # go quiet before the final flush (lines the client already piped
    # may still sit in the reader's buffer when SIGTERM lands; their
    # results — completed or rejected — must still be printed)

    # a restarted server re-offers every accepted-but-unanswered journal
    # entry FIRST (acceptance order), before reading fresh stdin: a
    # crash loses a process, not a queue (at-least-once — a request
    # whose result line printed but whose done-mark didn't land is
    # answered again; consumers dedupe by id, doc/resilience.md)
    if journal is not None:
        replay = journal.pending()
        if replay:
            print(f"# paddle serve: re-offering {len(replay)} journaled "
                  "request(s) from a previous run", file=sys.stderr)
        for doc in replay:
            # replay=True: this backlog was durably accepted by a
            # previous incarnation — queue_cap governs NEW arrivals;
            # capping the re-offer would reject-and-done-mark the
            # tail, permanently truncating the very queue the journal
            # exists to preserve
            trace = str(doc.get("trace_id") or "")
            fut = engine.submit(
                doc.get("prompt") or [],
                max_new_tokens=doc.get("max_new_tokens"),
                rid=str(doc["id"]), replay=True, trace=trace)
            with plock:
                pending.append((str(doc["id"]), fut, trace))

    def _reader() -> None:
        n = 0
        for line in sys.stdin:
            line = line.strip()
            if line:
                doc, err, rid = _parse_line(line, n)
                n += 1
                if doc is None:
                    _answer({"id": rid, "outcome": "error", "tokens": [],
                             "error": err})
                else:
                    trace = str(doc.get("trace_id") or "")
                    accepted = True
                    if journal is not None:
                        jt0 = cc.monotonic()
                        accepted = journal.accept(doc)
                        # the durable append (flush + fsync) is a real
                        # hop on the request's critical path
                        _span("replica.journal", jt0,
                              cc.monotonic() - jt0, trace)
                    if not accepted:
                        # this id is already journaled: answered in a
                        # previous incarnation, or re-offered above — a
                        # replayed stdin after a supervised restart must
                        # not double-submit (dedupe by request id)
                        print(f"# paddle serve: duplicate request id "
                              f"{doc['id']!r} skipped (journal)",
                              file=sys.stderr)
                    else:
                        # the journal accept above was flushed+fsynced
                        # BEFORE this submit — crash-ordered ahead of
                        # any accept effect
                        _span("replica.accept", cc.monotonic(), 0.0,
                              trace)
                        fut = engine.submit(
                            doc["prompt"],
                            max_new_tokens=doc.get("max_new_tokens"),
                            rid=str(doc["id"]), trace=trace)
                        with plock:
                            pending.append((str(doc["id"]), fut, trace))
            with plock:
                n_lines[0] += 1
            if drain.is_set():
                break
        eof.set()

    reader = cc.Thread(target=_reader, name="serve-stdin", daemon=True)
    reader.start()

    def _flush_pending(block: bool) -> None:
        while True:
            with olock:
                with plock:
                    if not pending:
                        return
                    rid, fut, trace = pending[0]
                    if not block and not fut.done():
                        return
                    pending.pop(0)
                res = fut.result(timeout=600.0)
                out = {"id": rid, "outcome": res.outcome, "tokens": res.tokens}
                if trace:
                    # echoed verbatim — the propagation contract
                    out["trace_id"] = trace
                if res.error:
                    out["error"] = res.error
                if res.retry_after_s is not None:
                    # shed answers hint when capacity is expected back
                    out["retry_after_s"] = res.retry_after_s
                _answer(out)
                if journal is not None:
                    # done-mark AFTER the print: a crash in between re-
                    # answers this request on restart (at-least-once)
                    journal.answer(rid, res.outcome)

    if hangwatch is not None:
        # the hang exit (monitor thread) resolves every future
        # outcome=error and then os._exit(19)s — without this hook the
        # main-thread printer never wakes, the error lines never reach
        # stdout, and journal-less clients hear NOTHING. hang_fail_all
        # resolved (or draining-rejects) every future first, so the
        # blocking flush cannot wedge on an unresolved one; a wedged
        # stdout is capped by the hangwatch's forensics backstop.
        def _hang_answer_flush() -> None:
            _flush_pending(block=True)
            sys.stdout.flush()

        hangwatch.answer_flush = _hang_answer_flush

    while not (eof.is_set() or drain.is_set()):
        _flush_pending(block=False)
        eof.wait(timeout=0.05)
    # plain EOF is a BATCH, not an abort: the client piped its whole
    # request file (`paddle serve < requests.jsonl`) and every accepted
    # request owes a real answer — wait the pending futures out while
    # the engine works the queue down. A signal arriving mid-batch
    # falls through to the drain below (in-flight finish, queued
    # reject), so SIGTERM semantics are unchanged.
    while not drain.is_set():
        with plock:
            if not pending:
                break
            fut = pending[0][1]
        if fut.done():
            _flush_pending(block=False)
        elif engine._thread is None or not engine._thread.is_alive():
            # a dead scheduler can never resolve these futures: fall
            # through to the drain + bounded blocking flush, which
            # fails loudly instead of spinning here forever
            break
        else:
            drain.wait(timeout=0.05)
    # graceful drain: finish in-flight, reject queued + new, then print
    # every remaining result (rejections included — the client hears).
    # First give the reader a bounded window to submit lines the client
    # already piped: the whole serve cycle can fit inside one GIL switch
    # interval, so at SIGTERM the reader may not have run yet even
    # though its input buffer is full (post-drain submits come back
    # outcome=rejected, which is exactly the answer those lines get).
    deadline = cc.monotonic() + 3.0
    quiet_at = cc.monotonic()
    with plock:
        seen = n_lines[0]
    while cc.monotonic() < deadline and cc.monotonic() - quiet_at < 0.25:
        eof.wait(timeout=0.05)
        with plock:
            if n_lines[0] != seen:
                seen = n_lines[0]
                quiet_at = cc.monotonic()
        if eof.is_set():
            break
    if reloader is not None:
        reloader.stop()  # no swap may race the drain's final windows
    engine.drain(timeout=600.0)
    _flush_pending(block=True)
    if status is not None:
        status.stop()  # final snapshot carries draining=True
    if journal is not None:
        journal.close()
    if obsm.enabled():
        engine.window_roll()
        obsm.emit("run_end", status="completed")
        obsm.flush()
    print("# paddle serve: drained", file=sys.stderr)
    return 0
