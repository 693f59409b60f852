"""`paddle` command line of the port — train / test / gen / serve /
serve-fleet / serve-status / serve-report / supervise / metrics / faults /
dump_config / version.

Port of ``paddle_tpu/cli.py`` (the role of the reference's TrainerMain and
its `paddle` shell dispatcher, paddle/trainer/TrainerMain.cpp:35-110): the
same subcommands, flags (``utils/flags.py``), log lines, JSONL lines and
exit codes. Run it as ``python -m paddle_tpu_torch <cmd> --config=...``;
``--use_tpu=true`` (the default) runs on the card and fails without one,
``--use_tpu=false`` on the CPU. The JAX package's other subcommands are
not ported yet: each exits with code 2, naming the ROADMAP Queue 1 item
that ports it.
"""

from __future__ import annotations

import os
import sys

# subcommand -> the ROADMAP Queue 1 item that ports it
NOT_PORTED = {
    "checkgrad": 7, "merge_model": 7, "check-checkpoint": 7, "check_checkpoint": 7,
    "memory": 8, "roofline": 8, "compare": 8, "trace": 8, "lint": 8, "race": 8,
}


def main(argv=None) -> int:
    # die quietly when stdout is a closed pipe (`paddle dump_config | head`)
    import signal

    if hasattr(signal, "SIGPIPE"):
        signal.signal(signal.SIGPIPE, signal.SIG_DFL)
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help", "help"):
        print(__doc__)
        print("usage: python -m paddle_tpu_torch <train|supervise|test|gen|serve|serve-fleet|"
              "serve-status|serve-report|metrics|faults|dump_config|version> [--flags]")
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "version":
        return _version()
    if cmd in ("train", "test", "gen"):
        return _run_trainer_job(cmd, rest)
    if cmd == "supervise":
        return _supervise(rest)
    if cmd == "dump_config":
        _, config = _setup(rest)
        print(config.to_json(indent=2))
        return 0
    if cmd == "serve":
        # continuous-batching generation server: stdin JSONL (or
        # --listen), SIGTERM = graceful drain
        from paddle_tpu_torch.serving.frontend import main as serve_main

        return serve_main(rest)
    if cmd in ("serve-fleet", "serve_fleet"):
        # the router over --fleet_replicas `paddle serve` children; it
        # never touches the card, the replicas own it
        from paddle_tpu_torch.serving.fleet import main as fleet_main

        return fleet_main(rest)
    if cmd in ("serve-status", "serve_status"):
        # render a `paddle serve --status_path` health snapshot
        from paddle_tpu_torch.serving.resilience import status_main

        return status_main(rest)
    if cmd in ("serve-report", "serve_report"):
        # the per-offered-load serving report over a run's request and
        # serve_window records
        from paddle_tpu_torch.observability.serving import main as serve_report_main

        return serve_report_main(rest)
    if cmd == "metrics":
        # the telemetry analyzer over a run dir's records; it needs no card
        from paddle_tpu_torch.observability.analyze import main as metrics_main

        return metrics_main(rest)
    if cmd == "faults":
        return _faults()
    if cmd in NOT_PORTED:
        print(f"paddle {cmd} is not ported to paddle_tpu_torch yet "
              f"(ROADMAP Queue 1 item {NOT_PORTED[cmd]})", file=sys.stderr)
        return 2
    print(f"unknown command {cmd!r}", file=sys.stderr)
    return 2


def _version() -> int:
    import torch

    from paddle_tpu_torch.version import __version__

    print(f"paddle_tpu_torch {__version__} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    names = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
    print(f"devices: {names}" if names else "devices: no CUDA device")
    return 0


def _faults() -> int:
    """`paddle faults` — the fault-injection sites with their one-line
    descriptions, for writing `--fault_spec` chaos specs."""
    from paddle_tpu_torch.resilience.faultinject import SITE_DOCS

    print("fault-injection sites (--fault_spec='site=action[:arg][@trigger]"
          "[;...]', actions: raise | oserror | exit[:code] | sleep[:secs];"
          " see doc/resilience.md):")
    width = max(len(s) for s in SITE_DOCS)
    for site, desc in SITE_DOCS.items():
        print(f"  {site:<{width}}  {desc}")
    return 0


def _supervise(rest) -> int:
    """`paddle supervise <flags>` — run `paddle train` (or, with
    `--supervise_job=serve`, `paddle serve`) as a supervised child:
    restart with backoff on a nonzero exit (bounded by --restart_budget;
    train children resume via `--init_model_path=auto`, serve children
    re-offer their `--serve_journal_path` queue themselves), stop with a
    JSON crash report on a crash loop, forward SIGTERM. The supervisor
    never touches the card, so it parses the flags without `_setup` and
    forwards `rest` verbatim to the child."""
    from paddle_tpu_torch.utils.flags import FLAGS

    leftover = FLAGS.parse(list(rest))
    if leftover:
        print(f"warning: unrecognized flags {leftover}", file=sys.stderr)
    if FLAGS.supervise_job not in ("train", "serve"):
        print(f"error: --supervise_job={FLAGS.supervise_job!r} (expected "
              "train or serve)", file=sys.stderr)
        return 2
    from paddle_tpu_torch.resilience.supervisor import Supervisor

    return Supervisor(rest, FLAGS).run()


def _setup(rest):
    from paddle_tpu_torch.utils.flags import FLAGS

    leftover = FLAGS.parse(rest)
    if leftover:
        print(f"warning: unrecognized flags {leftover}", file=sys.stderr)
    if FLAGS.fault_spec:
        # chaos drills: deterministic fault injection at the named sites
        from paddle_tpu_torch.resilience import faultinject

        faultinject.configure(FLAGS.fault_spec, FLAGS.fault_seed)
    if FLAGS.coordinator_address:
        print("error: multi-process training is not ported to paddle_tpu_torch yet "
              "(ROADMAP Queue 1 item 8)", file=sys.stderr)
        raise SystemExit(2)
    from paddle_tpu_torch.config import parse_config

    if not FLAGS.config:
        print("error: --config is required", file=sys.stderr)
        raise SystemExit(2)
    if not os.path.exists(FLAGS.config):
        print(f"error: config file {FLAGS.config!r} not found", file=sys.stderr)
        raise SystemExit(2)
    config = parse_config(FLAGS.config, FLAGS.config_args)
    return FLAGS, config


def _run_trainer_job(cmd, rest) -> int:
    flags, config = _setup(rest)
    from paddle_tpu_torch.trainer import Trainer

    trainer = Trainer(config, flags)
    if cmd == "train":
        try:
            trainer.train()
        except Exception as e:
            from paddle_tpu_torch.observability.memory import OOM_REPORT, is_oom_error

            if is_oom_error(e):
                # the trainer wrote oom_report.json and flushed the oom
                # record; the distinct code tells a supervisor what died
                from paddle_tpu_torch.resilience import EXIT_OOM

                print(f"OOM: {e} (forensics: {OOM_REPORT} in the run dir)", file=sys.stderr)
                return EXIT_OOM
            raise
        if trainer.preempted:
            # supervisors and launchers restart a preempted run without
            # spending restart budget
            from paddle_tpu_torch.resilience import EXIT_PREEMPTED

            return EXIT_PREEMPTED
    elif cmd == "test":
        if flags.test_pass >= 0:
            _test_saved_passes(trainer, flags)
        else:
            trainer.test()
    else:
        trainer.generate()
    return 0


def _test_saved_passes(trainer, flags) -> None:
    """Evaluate saved checkpoints pass by pass (ref: Tester; --test_pass
    with --test_wait polls for passes still being written by a concurrent
    trainer)."""
    import time

    from paddle_tpu_torch.trainer import checkpoint as ckpt
    from paddle_tpu_torch.utils.logging import logger

    save_dir = flags.save_dir or trainer.config.save_dir
    pass_id = flags.test_pass
    while pass_id < flags.num_passes:
        path = os.path.join(save_dir, ckpt.PASS_FMT % pass_id)
        # a checkpoint is complete once meta.json exists (written last by
        # save_checkpoint): guards against racing a concurrent trainer
        if not os.path.exists(os.path.join(path, "meta.json")):
            newest = ckpt.latest_pass(save_dir)
            if newest is not None and newest > pass_id:
                # rotated away by rolling deletion: skip forward
                logger.warning("pass %d checkpoint rotated away; skipping to %d",
                               pass_id, newest)
                pass_id = newest
                continue
            if flags.test_wait:
                time.sleep(5)
                continue
            break
        # a read-side job: load_checkpoint only reads (it never quarantines)
        trainer.restore(path)
        trainer.test(pass_id=pass_id)
        pass_id += 1


if __name__ == "__main__":
    sys.exit(main())
