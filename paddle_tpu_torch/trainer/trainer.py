"""Trainer — the pass/batch training driver, on one device.

Port of ``paddle_tpu/trainer/trainer.py`` (the role of the reference's
Trainer/TrainerInternal, paddle/trainer/Trainer.cpp:266-477):
a train step is ``_step`` (gradients from the machine, then the optimizer
update, then the state updates), run eagerly; ``train()`` runs the pass
loop over the config's data provider (``train_one_pass``: the cost
window, the evaluators, the ``--log_period``, ``--dot_period``,
``--test_period``, ``--saving_period_by_batches`` and
``--show_parameter_stats_period`` boundaries; then a test pass and a save
every ``--saving_period`` passes); ``test()`` is the test pass over the
test provider (the averaged parameters, a forward without gradients, the
mean per-sample cost and the configured evaluators); ``generate()`` is
beam search over the generation config's provider, into the JAX package's
result file; ``predict()`` is the test job of a config without a cost.
Batches move to the card one ahead of the step, from pinned host memory.

The pass loop carries the JAX package's resilience and telemetry:

- launch groups: with ``batches_per_launch = k``, k consecutive batches
  of one shape signature are one launch group, their k steps enqueued back
  to back and their k losses read in one copy to the host; with
  ``num_batches_per_send_parameter = n``, gradients sum over n batches
  and one update applies them;
- ``--nonfinite_policy``: abort raises ``NonFiniteLossError``, skip
  discards the poisoned update, rollback restores the newest checkpoint,
  tempers the learning rate and fast-forwards past the poisoned batch;
  each names the first layer with a non-finite value
  (``observability/numerics.py``);
- SIGTERM saves at the next launch boundary and ends the run preempted
  (``EXIT_PREEMPTED`` from the command line), ``--step_hang_timeout``
  arms the hangwatch (``EXIT_HANG``), ``--heartbeat_interval`` renews a
  heartbeat file, a device OOM leaves ``oom_report.json``
  (``EXIT_OOM``), and the ``trainer.*`` fault sites drive each of them;
- telemetry: ``train_window``, ``pass_end`` (with model TFLOP/s and MFU),
  ``test``, ``restart``, ``nonfinite``, ``numerics`` and ``run_end``
  records (``--metrics_path``, else ``--save_dir``), the StatSet dump
  after each pass, and a ``torch.profiler`` window (``--profile_dir``).

Sparse training: the tables of the machine's prefetch plan get row-sparse
gradients, which the updater applies to the touched rows in place; the
launch's undo log (``_nf_snapshot``) hands their old rows back under skip
and rollback. Accumulation and fused launch groups take dense gradients
and the row scan, as the JAX package's do. ``--sparse_row_budget`` refuses
a table one host cannot hold before any step, each pass ends with a
``kind=sparse`` record of the rows it touched, counted from the host
batches, and pruning hooks mask their weights after init or restore.

The constructor reads the command line's flags (``utils/flags.py``), as
the JAX package's does: ``--use_tpu`` (the reference's ``-use_gpu``, "run
on the accelerator") puts it on the card, where it raises without one;
``--use_tpu=false`` on the CPU, with the kernels' plain versions. A
``device`` argument overrides the flag. Restores follow
``--init_model_path`` (a pass dir, or ``auto``: the newest checkpoint under
``--save_dir`` that verifies), ``--start_pass`` and
``--load_missing_parameter_strategy``.

The batch-list methods take batches the caller builds, as dicts of
:class:`~paddle_tpu_torch.graph.Argument` on the trainer's device
(:func:`paddle_tpu_torch.flagship.nmt_batch`,
:func:`~paddle_tpu_torch.flagship.example_batch`, ...):
``train_one_batch``, ``test_batches`` and ``generate_batches``.

    trainer = Trainer(nmt_config(vocab=30000, dim=512, batch_size=64))
    loss = trainer.train_one_batch(nmt_batch(B=64, T=32, seed=1, device=trainer.device))
    results = trainer.test_batches([nmt_batch(B=64, T=32, seed=2, device=trainer.device)])

Not ported yet, and refused where a flag or the config asks for them
(ROADMAP Queue 1): meshes, asynchronous checkpoints, float64 and the
whole-data batch methods.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import signal
import statistics
import sys
import time
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from paddle_tpu_torch.data.feeder import DataProvider, create_data_provider
from paddle_tpu_torch.device import DeviceLike
from paddle_tpu_torch.graph.argument import Argument
from paddle_tpu_torch.graph.machine import GradientMachine, compute_dtype_of
from paddle_tpu_torch.graph.recurrent_group import beams_of
from paddle_tpu_torch.layers.base import fold_seed
from paddle_tpu_torch.observability import memory as obs_mem
from paddle_tpu_torch.observability import metrics as obs
from paddle_tpu_torch.observability import numerics as obs_num
from paddle_tpu_torch.observability import spans as obs_spans
from paddle_tpu_torch.ops import kernel_flops
from paddle_tpu_torch.optimizer.updater import Updater
from paddle_tpu_torch.resilience import NonFiniteLossError, faultinject
from paddle_tpu_torch.sparse import rowshard as sparse_rows
from paddle_tpu_torch.sparse import runtime as sparse_rt
from paddle_tpu_torch.trainer import checkpoint as ckpt
from paddle_tpu_torch.trainer.evaluators import EvaluatorChain
from paddle_tpu_torch.utils import concurrency as cc
from paddle_tpu_torch.utils.flags import FLAGS
from paddle_tpu_torch.utils.logging import logger
from paddle_tpu_torch.utils.retry import RetryPolicy
from paddle_tpu_torch.utils.stats import global_stats, stat_timer, wait_for

Batch = Dict[str, Argument]


class TrainerStats:
    """Windowed cost averages (ref: TrainerInternal.h TrainerStats)."""

    def __init__(self):
        self.total_cost = 0.0
        self.total_samples = 0
        self.window_cost = 0.0
        self.window_samples = 0

    def add(self, cost_sum: float, n: int) -> None:
        self.total_cost += cost_sum
        self.total_samples += n
        self.window_cost += cost_sum
        self.window_samples += n

    def reset_window(self) -> None:
        self.window_cost = 0.0
        self.window_samples = 0

    def summary_dict(self) -> Dict[str, Any]:
        """The one source of the log line and of the records' fields."""
        return {
            "samples": self.total_samples,
            "AvgCost": self.total_cost / max(self.total_samples, 1),
            "CurrentCost": self.window_cost / max(self.window_samples, 1),
        }

    def summary(self) -> str:
        return " ".join(
            f"{k}={v:d}" if isinstance(v, int) else f"{k}={v:.6g}"
            for k, v in self.summary_dict().items()
        )


class PreemptionExit(Exception):
    """Raised inside the pass loop after a preemption-triggered save."""

    def __init__(self, pass_id: int, saved_path: str):
        super().__init__(f"preempted at pass {pass_id}")
        self.pass_id = pass_id
        self.saved_path = saved_path


class _RollbackRequest(Exception):
    """train_one_pass asks train() to restore the newest verified
    checkpoint (``--nonfinite_policy=rollback``)."""

    def __init__(self, pass_id: int, batch_id: int):
        super().__init__(f"rollback requested at pass {pass_id} batch {batch_id}")
        self.pass_id = pass_id
        self.batch_id = batch_id


# what the JAX package's pass loop does that the port's does not yet:
# (what asks for it, is it asked for?, ROADMAP Queue 1 item)
_UNPORTED = (
    ("--async_checkpoint", lambda f, c: f.async_checkpoint, 7),
    ("--use_double", lambda f, c: f.use_double, 7),
    ("algorithm=owlqn (whole-data batch methods)", lambda f, c: c.opt_config.algorithm == "owlqn", 7),
    ("--mesh_shape / --trainer_count > 1",
     lambda f, c: bool(f.mesh_shape or c.opt_config.mesh_shape) or f.trainer_count > 1, 8),
)


class Trainer:
    def __init__(self, config, flags=FLAGS, device: DeviceLike = None):
        for what, asked, item in _UNPORTED:
            if asked(flags, config):
                raise NotImplementedError(
                    f"{what} is not ported to paddle_tpu_torch yet (ROADMAP Queue 1 item {item})")
        # restart latency: the `restart` record's time_to_first_step_s runs
        # from here to the first completed launch
        self._t_construct = time.perf_counter()
        self.config = config
        self.flags = flags
        opt = config.opt_config
        if device is None and not flags.use_tpu:
            device = "cpu"
        # OptimizationConfig.dtype="bfloat16": bf16 activations and products,
        # float32 master weights and optimizer state
        self.gm = GradientMachine(config.model_config, device,
                                  compute_dtype=compute_dtype_of(opt),
                                  conv_s2d=opt.conv_s2d, conv_stats_mode=opt.conv_stats_mode)
        self.device = self.gm.device
        self.updater = Updater(opt, config.model_config,
                               init_model_path=flags.init_model_path or config.init_model_path)
        self.params = self.gm.init_params(flags.seed)
        self.opt_state = self.updater.init_state(self.params)
        # steps taken by train_one_batch, outside a pass: each is seeded
        # from its own count, as a pass's batches are from their ids
        self._loose_steps = 0
        self.start_pass = flags.start_pass or config.start_pass
        self.save_dir = flags.save_dir or config.save_dir
        # per-pass held-out results appended by train(): [(pass_id, {...})]
        self.test_history: List[Tuple[int, Dict[str, float]]] = []
        # OptimizationConfig.remat: "full" recomputes the forward in the
        # backward; an unknown mode raises here, as the JAX Trainer's does
        self._grad_fn = self.gm.grad_fn(remat=opt.remat)
        # sparse training: the tables whose gradients are row-sparse. Their
        # row sets vary per batch, so accumulation sums dense gradients and
        # a fused launch group takes them (as the JAX package's fixed-shape
        # scan does): the updater's row scan, not its indexed path
        self._sparse_plan = self.gm.sparse_prefetch_plan()
        self._dense_grad_fn = (self.gm.grad_fn(remat=opt.remat, sparse=False)
                               if self._sparse_plan else self._grad_fn)
        self._sparse_launch = True
        self._dots_pending = False
        # gradient accumulation: n forward/backwards per update (the
        # reference's num_batches_per_send_parameter). Under async_sgd the
        # field is local SGD's merge period, and one replica is plain sync
        # SGD (the JAX package reinterprets it the same way)
        self._accum_n = max(1, int(opt.num_batches_per_send_parameter))
        if opt.algorithm == "async_sgd":
            logger.warning("async_sgd with a single data-parallel replica is exactly sync SGD — "
                           "running the ordinary sync step")
            self._accum_n = 1
        self._acc: Optional[Dict[str, torch.Tensor]] = None
        self._acc_batches = 0
        self._acc_samples = 0
        # fused launch groups: k consecutive same-signature batches, each
        # keeping its own update, so numerics match the unfused loop
        self._fuse_k = max(1, int(opt.batches_per_launch))
        if self._fuse_k > 1 and self._accum_n > 1:
            raise ValueError(
                "batches_per_launch > 1 cannot combine with num_batches_per_send_parameter > 1 "
                "— fuse launches of accumulation micro-batches are not supported; pick one")
        # divergence policy: abort raises; skip hands back the pre-step
        # state; rollback restores the newest verified checkpoint. skip and
        # rollback are bounded by --max_nonfinite_steps
        self._nf_policy = str(flags.nonfinite_policy or "abort")
        if self._nf_policy not in ("abort", "skip", "rollback"):
            raise ValueError(f"--nonfinite_policy={self._nf_policy!r} "
                             "(want abort, skip, or rollback)")
        self._nf_budget = max(0, int(flags.max_nonfinite_steps))
        self._nf_count = 0
        self.rollbacks = 0
        # (pass_id, first clean batch): the rolled-back pass's re-run skips
        # the batches before it, the poison region
        self._ff_target: Optional[Tuple[int, int]] = None
        if self._nf_policy == "rollback" and not self.save_dir:
            logger.warning("--nonfinite_policy=rollback without --save_dir: there will be no "
                           "checkpoint to roll back to — the first non-finite loss raises "
                           "NonFiniteLossError")
        # per-layer health (--numerics_log_period): a [layers, 4] table
        # computed in each step on the device, read back only at the period
        # and at the pass's end
        self._numerics_period = max(0, int(flags.numerics_log_period or 0))
        self._numerics_groups: Optional[Dict[str, List[str]]] = None
        self._numerics_last: Optional[torch.Tensor] = None
        if self._numerics_period:
            if self._accum_n > 1:
                # the update happens outside the step: the table would
                # misattribute it, so it is left out rather than wrong
                logger.warning("--numerics_log_period is not supported under gradient "
                               "accumulation — numerics telemetry disabled for this run")
                self._numerics_period = 0
            else:
                self._numerics_groups = obs_num.layer_groups(config.model_config,
                                                             list(self.params))
                # the health table reads each update as new minus old
                # tensors: the sparse tables update functionally
                self.updater.sparse_in_place = False
        # the sparse tables' row counts, registered for the checkpoint's
        # meta; refused before any step when one host cannot hold a table
        # within --sparse_row_budget; their touched rows accounted per pass
        # for the kind=sparse record
        self._sparse_stats = None
        if self._sparse_plan:
            tables = {pn: int(self.params[pn].shape[0]) for pn, _ in self._sparse_plan
                      if pn in self.params}
            err = sparse_rows.row_budget_error(tables, 1, int(flags.sparse_row_budget or 0))
            if err:
                raise ValueError(err)
            sparse_rt.register_tables(tables)
            self._sparse_stats = sparse_rt.SparseStats({
                pn: int(np.prod(self.params[pn].shape[1:]) or 1) * self.params[pn].element_size()
                for pn in tables})
        # model FLOPs per batch signature (counted on the signature's first
        # step), summed over the pass with the steps' windows for MFU
        self._flops_cache: Dict[Any, Optional[float]] = {}
        self._flops_failed_logged = False
        self._pass_flops = 0.0
        self._pass_train_s = 0.0
        self._pass_flops_incomplete = False
        self._pass_counted = 0
        # set by the SIGTERM handler of _preemption_guard, read at launch
        # boundaries so that the save is consistent
        self._preempt_requested = False
        self.preempted = False
        self._last_launch: Optional[Tuple[int, int]] = None
        # the run dir of the records: --metrics_path, else the save_dir
        # (``obs.configure_from_flags``'s rule), made absolute now, so that
        # a later change of directory cannot move its flushes
        run_dir = flags.metrics_path or flags.save_dir
        obs.configure(os.path.abspath(run_dir) if run_dir else "", host=0)
        obs_spans.configure_from_flags(flags, host=0)
        # hang defense: the loop pings at every launch boundary; a stall
        # past --step_hang_timeout writes hang_report.json into the run
        # dir and exits EXIT_HANG
        self._hangwatch = None
        if float(flags.step_hang_timeout or 0) > 0:
            from paddle_tpu_torch.resilience.hangwatch import HangWatch, run_dir_of

            self._hangwatch = HangWatch(
                float(flags.step_hang_timeout),
                report_dir=run_dir_of(flags.metrics_path or self.save_dir or "."))
        self._heartbeat = None
        if float(flags.heartbeat_interval or 0) > 0:
            from paddle_tpu_torch.resilience import heartbeat as hb

            hb_dir = hb.resolve_dir(flags.heartbeat_dir, self.save_dir)
            if hb_dir:
                self._heartbeat = hb.HeartbeatWriter(hb_dir, 0, float(flags.heartbeat_interval))
                # the first beat before the restore: a monitor sees "alive and
                # initializing", not a silence it could take for a wedge
                self._heartbeat.beat(phase="init")
            else:
                logger.warning("--heartbeat_interval=%g but neither --heartbeat_dir nor "
                               "--save_dir is set — heartbeats disabled",
                               flags.heartbeat_interval)
        self._restore_s = 0.0
        self._restart_pending = True
        t_restore = time.perf_counter()
        self._maybe_restore()
        self._restore_s = time.perf_counter() - t_restore
        # StaticPruningHook::init: the masked weights start at zero
        self.params = self.updater.apply_init_hooks(self.params)

    # ------------------------------------------------------------ restore

    def _maybe_restore(self) -> None:
        self._restored_pass: Optional[int] = None
        init_path = self.flags.init_model_path or self.config.init_model_path
        missing = self.flags.load_missing_parameter_strategy
        if init_path == "auto":
            # the newest checkpoint under save_dir that verifies; a fresh
            # run (nothing restorable) starts clean
            init_path = ckpt.find_restorable_checkpoint(self.save_dir) if self.save_dir else None
            if init_path is None:
                logger.info("--init_model_path=auto: no restorable checkpoint under %r — "
                            "starting fresh", self.save_dir)
                return
            restored = self._restore(init_path, missing)
            if restored is not None and self.start_pass == 0:
                self.start_pass = restored + 1
                logger.info("--init_model_path=auto: resumed pass %d from %s (start_pass=%d)",
                            restored, init_path, self.start_pass)
            return
        if init_path:
            self._restore(init_path, missing)
        elif self.start_pass > 0:
            self._restore(os.path.join(self.save_dir, ckpt.PASS_FMT % (self.start_pass - 1)))

    def _restore(self, path: str, missing: str = "fail") -> Optional[int]:
        """Restore a pass dir; returns its pass id, recorded as the pass this
        run restored from when it lies in our save_dir (rolling deletion
        keeps it until a newer save lands)."""
        pass_id = self.restore(path, missing).get("pass_id")
        if not isinstance(pass_id, int):
            base = os.path.basename(os.path.normpath(path))
            if not ckpt._is_pass_dir_name(base):
                return None
            pass_id = int(base[5:])
        if self.save_dir and os.path.abspath(os.path.dirname(os.path.normpath(path))) \
                == os.path.abspath(self.save_dir):
            self._restored_pass = pass_id
        return pass_id

    def restore(self, path: str, missing: str = "fail") -> Dict:
        """Load parameters and optimizer state from a pass directory;
        returns its meta."""
        self.params, opt_state, meta = ckpt.load_checkpoint(
            path, self.opt_state, device=self.device, expected_params=self.params,
            missing=missing)
        if opt_state is not None:
            self.opt_state = opt_state
        hosts = meta.get("sparse_hosts")
        if self._sparse_stats is not None and isinstance(hosts, int) and hosts != 1:
            # written by another host set: its tables were resharded
            self._sparse_stats.note_reshard(hosts, 1)
            logger.info("sparse tables resharded across relaunch: %d -> 1 host(s)", hosts)
        return meta

    # ------------------------------------------------------------- steps

    @staticmethod
    def batch_size(batch: Batch) -> int:
        return next(iter(batch.values())).batch_size

    def _step(self, batch: Batch, seed: int):
        """One step: gradients, then the update (every n-th batch under
        accumulation), then the state updates. ``seed`` is the step's, from
        which the layers draw (dropout, sampling_id, nce). Returns the
        batch's loss (a device scalar) and the layer outputs. Enqueues
        device work only; nothing here waits for the card."""
        grad_fn = (self._grad_fn if self._sparse_launch and self._accum_n <= 1
                   else self._dense_grad_fn)
        loss, grads, outputs, state_updates = grad_fn(self.params, batch, seed)
        n = self.batch_size(batch)
        if self._accum_n > 1:
            # sample-weighted gradient sums, as new tensors: a skip's
            # snapshot keeps the old ones
            acc = self._acc
            self._acc = {k: g * n if acc is None else acc[k] + g * n for k, g in grads.items()}
            self._acc_batches += 1
            self._acc_samples += n
            # the state updates (batch norm's statistics) advance per batch
            self.params = {**self.params, **state_updates}
            if self._acc_batches >= self._accum_n:
                self._accum_flush()
            return loss, outputs
        old = self.params
        self.params, self.opt_state = self.updater(self.params, grads, self.opt_state, n)
        self.params.update(state_updates)
        if self._numerics_groups is not None:
            self._numerics_last = obs_num.step_health(old, self.params, grads,
                                                      self._numerics_groups)
        return loss, outputs

    def _accum_flush(self) -> None:
        """Apply the accumulated gradients as one update over their summed
        samples (a pass that ends mid-group flushes too)."""
        if not self._acc_batches or self._acc is None:
            return
        total = self._acc_samples
        mean = {k: a / total for k, a in self._acc.items()}
        self.params, self.opt_state = self.updater(self.params, mean, self.opt_state, total)
        self._acc, self._acc_batches, self._acc_samples = None, 0, 0

    def train_one_batch(self, batch: Batch) -> torch.Tensor:
        """One step on a batch on the trainer's device; returns its loss as
        a (device) scalar tensor."""
        self._loose_steps += 1
        return self._step(batch, fold_seed(self.flags.seed, -1, self._loose_steps))[0]

    def _counted_step(self, batch: Batch, seed: int):
        """:meth:`_step`, the first time a batch signature is seen under the
        FLOP counter (``ops/kernel_flops.py``): counting runs the real step,
        so nothing extra touches the parameters. Its FLOPs (None where the
        count failed) join the pass's sum."""
        if self._accum_n > 1:
            # the update is not in every step: no model FLOPs, as in JAX
            return self._step(batch, seed)
        key = self._shape_sig(batch)
        if key in self._flops_cache:
            f = self._flops_cache[key]
            out = self._step(batch, seed)
        else:
            from torch.utils.flop_counter import FlopCounterMode

            before = self.params
            try:
                with kernel_flops.capture() as log, FlopCounterMode(display=False) as counter:
                    out = self._step(batch, seed)
                f = float(counter.get_total_flops()) + sum(log)
                self._pass_counted += 1
            except Exception as e:  # noqa: BLE001 — accounting never breaks training
                if self.params is not before:
                    raise               # the step got as far as its update
                # the step again without the counter: a failure of the
                # step's own raises there
                if not self._flops_failed_logged:
                    self._flops_failed_logged = True
                    logger.warning("FLOPs accounting failed for batch signature %r (%s): the "
                                   "MFU fields are left out", key, e)
                f, out = None, self._step(batch, seed)
            self._flops_cache[key] = f
        if f is None:
            self._pass_flops_incomplete = True
        else:
            self._pass_flops += f
        return out

    @staticmethod
    def _shape_sig(batch: Batch):
        """A batch's shape signature: its fields' shapes and dtypes (read
        off the tensors, no device work)."""
        return tuple((name, tuple(None if f is None else (tuple(f.shape), str(f.dtype))
                                  for f in (getattr(arg, fl.name)
                                            for fl in dataclasses.fields(arg))))
                     for name, arg in batch.items())

    # ------------------------------------------------------------- data

    def _provider(self, for_test: bool, ordered: Optional[bool] = None) -> Optional[DataProvider]:
        dc = self.config.test_data_config if for_test else self.config.data_config
        if dc is None:
            return None
        return create_data_provider(
            dc,
            self.config.opt_config.batch_size,
            self.config.model_config.input_layer_names,
            seed=self.flags.seed,
            for_test=for_test if ordered is None else ordered,
            stall_timeout=self.flags.data_stall_timeout,
            max_bad_samples=self.flags.max_bad_samples,
            retry=RetryPolicy.from_flags(self.flags, name="data-provider"),
            packer_threads=self.flags.data_packer_threads,
            prefetch_depth=self.flags.prefetch_depth,
        )

    def _to_device(self, batch: Batch) -> Batch:
        """A host batch on the trainer's device: on the card each field goes
        through pinned memory and a copy that does not block the host."""
        if self.device.type != "cuda":
            return batch
        return {name: Argument(**{f.name: None if getattr(arg, f.name) is None else
                                  getattr(arg, f.name).pin_memory().to(self.device,
                                                                       non_blocking=True)
                                  for f in dataclasses.fields(arg)})
                for name, arg in batch.items()}

    def _device_pairs(self, host_batches: Iterable[Batch]) -> Iterator[Tuple[Batch, Batch]]:
        """(host batch, device batch) with a one-batch-ahead transfer: the
        next batch's copy is enqueued before the current batch is handed to
        the step (the device-side half of the reference's DoubleBuffer,
        DataProvider.h:245; the host half is the feeder's prefetch
        threads)."""
        it = iter(host_batches)
        first = next(it, None)
        if first is None:
            return
        cur = (first, self._to_device(first))
        for host in it:
            nxt = (host, self._to_device(host))
            yield cur
            cur = nxt
        yield cur

    def _device_batches(self, host_batches: Iterable[Batch]) -> Iterator[Batch]:
        for _host, dev in self._device_pairs(host_batches):
            yield dev

    def _host_outputs(self, outputs: Dict[str, Argument],
                      evaluators: EvaluatorChain) -> Dict[str, Argument]:
        """The layers the evaluators read, on the host (they read numpy)."""
        return {name: _on_host(outputs[name])
                for name in evaluators.needed_layers if name in outputs}

    def _launch_groups(self, pairs: Iterable[Tuple[Batch, Batch]]):
        """Group the (host, device) batch stream for fused launches: yields
        ("fused", [k pairs]) for runs of k consecutive batches of one shape
        signature, and ("single", pair) otherwise (a change of signature,
        the pass's remainder)."""
        if self._fuse_k <= 1:
            for pair in pairs:
                yield "single", pair
            return
        buf, sig = [], None
        for pair in pairs:
            s = self._shape_sig(pair[1])
            if buf and s != sig:
                for p in buf:
                    yield "single", p
                buf = []
            sig = s
            buf.append(pair)
            if len(buf) == self._fuse_k:
                yield "fused", buf
                buf, sig = [], None
        for p in buf:
            yield "single", p

    # ------------------------------------------------------------- train

    def _preemption_guard(self):
        """Context manager around train(): a SIGTERM handler that asks for
        a checkpoint and an exit at the next launch boundary. Installed only
        from the main thread (elsewhere, a library embedding or a test
        runner's worker, it is a no-op) and only with --save_on_preempt. A
        second SIGTERM takes the previous handler, so a stuck save can
        still be killed; the previous handler is put back on exit."""
        if not self.flags.save_on_preempt or cc.current_thread() is not cc.main_thread():
            return contextlib.nullcontext()

        @contextlib.contextmanager
        def guard():
            prev = signal.getsignal(signal.SIGTERM)
            # None: installed by non-Python code; fall through to the default
            fallback = prev if prev is not None else signal.SIG_DFL

            def on_sigterm(signum, frame):
                # flag only: logging from a signal handler can re-enter a
                # stream mid-write; the boundary check logs instead
                self._preempt_requested = True
                signal.signal(signal.SIGTERM, fallback)

            signal.signal(signal.SIGTERM, on_sigterm)
            try:
                yield
            finally:
                self._preempt_requested = False
                if signal.getsignal(signal.SIGTERM) is on_sigterm:
                    signal.signal(signal.SIGTERM, fallback)

        return guard()

    def train(self, num_passes: Optional[int] = None) -> None:
        """Passes ``start_pass`` .. ``num_passes - 1`` over the train
        provider, built once so that its shuffle carries over from pass to
        pass; after each, a test pass and a save every ``--saving_period``
        passes, and a final save of the last pass. A rollback rewinds the
        pass id to just after the restored checkpoint, and the re-run pass
        draws what it drew before (its steps' seeds are --seed, the pass
        and the batch)."""
        num_passes = num_passes or self.flags.num_passes
        train_provider = self._provider(for_test=False)
        if train_provider is None:
            raise ValueError("no train data configured (define_py_data_sources2 train_list)")
        saved_pass = -1
        # each pass's shuffle state at its start: a rolled-back pass runs
        # again over the same batches in the same order
        shuffle_at: Dict[int, Any] = {}
        if self._accum_n <= 1:
            # the FLOP counter's one-time setup, before the hangwatch starts;
            # a counter that fails here fails the first count too, which
            # logs it (_counted_step)
            try:
                kernel_flops.warm_up()
            except Exception:  # noqa: BLE001 — accounting never breaks training
                pass
        # the liveness plumbing covers the final save too: a save wedged
        # on a dead file system is a hang as well
        if self._hangwatch is not None:
            self._hangwatch.start()
        if self._heartbeat is not None:
            self._heartbeat.start()
        try:
            with self._preemption_guard():
                try:
                    pass_id = self.start_pass
                    while pass_id < num_passes:
                        if hasattr(train_provider, "shuffle_state"):
                            if pass_id in shuffle_at:
                                train_provider.set_shuffle_state(shuffle_at[pass_id])
                            shuffle_at[pass_id] = train_provider.shuffle_state()
                        try:
                            with stat_timer("onePass"):
                                self.train_one_pass(pass_id, train_provider)
                        except _RollbackRequest as rb:
                            pass_id = self._apply_rollback(rb)
                            continue
                        with stat_timer("test"):
                            pass_results = self.test(pass_id=pass_id)
                        if pass_results:
                            self.test_history.append((pass_id, pass_results))
                        if self.save_dir and (pass_id + 1) % max(self.flags.saving_period, 1) == 0:
                            self.save(pass_id)
                            saved_pass = pass_id
                        logger.info(global_stats.summary())
                        if self._hangwatch is not None:
                            self._hangwatch.ping(pass_id)
                        pass_id += 1
                except PreemptionExit as e:
                    if e.saved_path:
                        logger.info("preemption: checkpoint saved at %s — exiting the train "
                                    "loop cleanly (resume with --init_model_path on that pass "
                                    "dir and --start_pass=%d)", e.saved_path, e.pass_id)
                    else:
                        logger.info("preemption: exiting the train loop cleanly (no --save_dir "
                                    "configured, nothing was saved)")
                    # the command line maps this to EXIT_PREEMPTED (18)
                    self.preempted = True
                    obs.emit("run_end", status="preempted")
                    obs.flush()
                    return
            if self.save_dir and saved_pass != num_passes - 1 and num_passes > self.start_pass:
                self.save(num_passes - 1, final=True)
            obs.emit("run_end", status="completed")
            obs.flush()
            obs_spans.export()
        except Exception as e:
            # a device OOM leaves oom_report.json before it propagates; the
            # command line maps it to EXIT_OOM (20)
            if obs_mem.is_oom_error(e):
                self._oom_premortem(e)
            raise
        finally:
            if self._hangwatch is not None:
                self._hangwatch.stop()
            if self._heartbeat is not None:
                self._heartbeat.stop()

    def _mfu_fields(self) -> Dict[str, float]:
        """Model TFLOP/s of the finished pass over its summed step windows,
        and MFU against the card's published bf16 peak (the trainer runs
        on one card). Empty under accumulation and wherever a count failed;
        no MFU on a card the peak table does not know."""
        if self._pass_flops <= 0 or self._pass_train_s <= 0 or self._pass_flops_incomplete:
            return {}
        tfps = self._pass_flops / self._pass_train_s / 1e12
        fields = {"model_tflops_per_sec": tfps}
        if self.device.type == "cuda":
            peak = kernel_flops.peak_tflops(torch.cuda.get_device_name(self.device))
            if peak:
                fields["mfu"] = tfps / peak
        return fields

    @staticmethod
    def _mfu_note(fields: Dict[str, float]) -> str:
        """', model X TFLOP/s, MFU Y' rendered from ``_mfu_fields``."""
        if not fields:
            return ""
        note = f", model {fields['model_tflops_per_sec']:.3g} TFLOP/s"
        if "mfu" in fields:
            note += f", MFU {fields['mfu']:.3f}"
        return note

    def train_one_pass(self, pass_id: int, provider) -> None:
        """One pass over ``provider.batches()``, by launch groups."""
        stats = TrainerStats()
        evaluators = EvaluatorChain(self.config.model_config)
        evaluators.start()
        flags = self.flags
        self._pass_flops = 0.0
        self._pass_train_s = 0.0
        self._pass_flops_incomplete = False
        self._pass_counted = 0
        # launch windows with and without a counted step: what counting cost
        counted_s: List[float] = []
        uncounted_s: List[float] = []
        t0 = time.monotonic()
        pass_t0 = time.perf_counter()
        batch_id = 0
        step_times: List[float] = []
        launch_counts = {"single": 0, "fused": 0}
        profiler = None
        profiled = False
        # rollback fast-forward: the re-run of the pass that diverged
        # consumes, without training, the batches up to the poisoned one
        ff_until = 0
        if self._ff_target is not None:
            tgt_pass, tgt_batch = self._ff_target
            if pass_id == tgt_pass:
                ff_until = tgt_batch
                logger.info("Pass %d: fast-forwarding past the poison region (skipping "
                            "batches < %d)", pass_id, tgt_batch)
            if pass_id >= tgt_pass:
                self._ff_target = None
        for kind, group in self._launch_groups(self._device_pairs(provider.batches())):
            # the launch boundary: the hangwatch's ping, before the
            # fast-forward skip (replaying past a poison region is progress)
            if self._hangwatch is not None:
                self._hangwatch.ping(pass_id, batch_id)
            self._last_launch = (pass_id, batch_id)
            if ff_until and batch_id < ff_until:
                batch_id += len(group) if kind == "fused" else 1
                continue
            self._fault_sites(pass_id, batch_id)
            launch_counts[kind] += 1
            if (flags.profile_dir and pass_id == self.start_pass and profiler is None
                    and not profiled and batch_id >= flags.profile_start_batch):
                profiler = self._start_profiler()
            pairs = group if kind == "fused" else [group]
            kf = len(pairs)
            if self._sparse_stats is not None:
                # the touched rows, from the host batches' ids: no copy
                # off the card
                for host, _dev in pairs:
                    self._sparse_stats.note_batch(self._sparse_plan, host)
            self._sparse_launch = kind != "fused"
            counted_before = self._pass_counted
            snap = self._nf_snapshot()
            t_step = time.perf_counter()
            with stat_timer("train_step"):
                losses, kept, ns = [], [], []
                for i, (_host, batch) in enumerate(pairs):
                    n = self.batch_size(batch)
                    loss, outputs = self._counted_step(batch, fold_seed(flags.seed, pass_id,
                                                                        batch_id + i))
                    losses.append(loss)
                    ns.append(n)
                    kept.append({k: outputs[k] for k in evaluators.needed_layers
                                 if k in outputs})
                    del outputs
                    if kind == "fused":
                        # the device batch is freed after its step (its host
                        # batch stays for a blame re-run)
                        pairs[i] = (pairs[i][0], None)
                # the launch's one read of its losses: the non-finite gate
                losses_host = torch.stack(losses).cpu().numpy()
            step_dt = time.perf_counter() - t_step
            self._sparse_launch = True
            (counted_s if self._pass_counted > counted_before else uncounted_s).append(step_dt)
            if faultinject.is_active():
                losses_host = np.asarray([self._poisoned_loss(float(l), pass_id, batch_id + i)
                                          for i, l in enumerate(losses_host)])
            skipped = False
            if not np.isfinite(losses_host).all():
                # the gate, before any per-batch housekeeping: the
                # parameters hold every update of the launch
                bad = int(np.flatnonzero(~np.isfinite(losses_host))[0])
                batch = pairs[bad][1]
                if batch is None:
                    batch = self._to_device(pairs[bad][0])
                skipped = self._handle_nonfinite(
                    pass_id, batch_id + bad, float(losses_host[bad]), snap,
                    f"(launch of {kf}) " if kind == "fused" else "", batch=batch,
                    seed=fold_seed(flags.seed, pass_id, batch_id + bad))
                del batch
                if skipped and kind == "fused":
                    # skip: the launch is discarded whole, the pre-launch
                    # state is back in place
                    batch_id += kf
                    continue
            del snap
            self.updater.undo = None
            self._pass_train_s += step_dt
            if self._restart_pending:
                # the run's first completed launch: restore, build and the
                # first step are paid
                self._restart_pending = False
                obs.emit("restart", pass_id=pass_id, step=batch_id,
                         restore_s=round(self._restore_s, 6),
                         time_to_first_step_s=round(time.perf_counter() - self._t_construct, 6),
                         resumed=self._restored_pass is not None)
            batch_id_start = batch_id
            for i in range(kf):
                step_times.append(step_dt / kf)
                if skipped:
                    # a single launch skipped: its boundary still runs the
                    # housekeeping below, as the JAX loop's does
                    batch_id += 1
                    continue
                stats.add(float(losses_host[i]) * ns[i], ns[i])
                if evaluators:
                    evaluators.eval_batch(self._host_outputs(kept[i], evaluators))
                kept[i] = None
                batch_id += 1
                if flags.dot_period and batch_id % flags.dot_period == 0:
                    print(".", end="", flush=True, file=sys.stderr)
                    self._dots_pending = True
            del kept, losses

            # periodic housekeeping at launch boundaries: the parameters hold
            # every update of the launch, so a period crossed inside it
            # fires at its end
            def crossed(period):
                return period and batch_id // period > batch_id_start // period

            if crossed(flags.test_period):
                self._end_dot_line()
                with stat_timer("test"):
                    self.test(pass_id=pass_id)
            if crossed(flags.show_parameter_stats_period):
                self._end_dot_line()
                self.show_parameter_stats()
            if crossed(flags.log_period):
                self._end_dot_line()
                logger.info("Pass %d batch %d  %s  %s", pass_id, batch_id, stats.summary(),
                            evaluators.summary())
                obs.emit("train_window", pass_id=pass_id, step=batch_id, **stats.summary_dict())
                stats.reset_window()
            if crossed(self._numerics_period) and self._numerics_last is not None:
                self._emit_numerics(pass_id, batch_id)
            # a preemption saves through the periodic save's block: one save
            # even when both fire; the flag is read once
            preempted = self._preempt_requested
            if (crossed(flags.saving_period_by_batches) or preempted) and self.save_dir:
                # pending gradients first, or the checkpoint drops them
                self._accum_flush()
                self.save(pass_id, batch_id=batch_id)
            if preempted:
                self._end_dot_line()
                logger.info("SIGTERM received — checkpointed at the launch boundary"
                            if self.save_dir else "SIGTERM received — no save_dir, nothing saved")
                if profiler is not None:
                    self._stop_profiler(profiler, pass_id)
                saved_path = (os.path.join(self.save_dir, ckpt.PASS_FMT % pass_id)
                              if self.save_dir else "")
                obs.emit("preempt", pass_id=pass_id, step=batch_id, saved_path=saved_path)
                obs.flush()
                obs_spans.export()
                raise PreemptionExit(pass_id, saved_path)
            if profiler is not None and batch_id >= (flags.profile_start_batch
                                                     + flags.profile_num_batches):
                self._stop_profiler(profiler, pass_id)
                profiler, profiled = None, True
        # the remainder of an accumulation group: no sample's gradient is
        # dropped (the reference flushes on finishPass)
        self._accum_flush()
        if profiler is not None:
            self._stop_profiler(profiler, pass_id)
        self._end_dot_line()
        # every pass has a numerics record, also when the period exceeds it
        if self._numerics_last is not None:
            self._emit_numerics(pass_id, batch_id)
        dt = time.monotonic() - t0
        rate = stats.total_samples / max(dt, 1e-9)
        mfu_fields = self._mfu_fields()
        logger.info("Pass %d done: %s  %s  (%.1f samples/s%s)", pass_id, stats.summary(),
                    evaluators.summary(), rate, self._mfu_note(mfu_fields))
        record: Dict[str, Any] = dict(stats.summary_dict())
        record.update(evaluators.results())
        record.update(mfu_fields)
        record["samples_per_sec"] = rate
        record["pass_time_s"] = time.perf_counter() - pass_t0
        if step_times:
            record["step_time_mean_s"] = float(np.mean(step_times))
            record["step_time_p50_s"] = float(np.percentile(step_times, 50))
            record["step_time_p99_s"] = float(np.percentile(step_times, 99))
        record["launches_single"] = launch_counts["single"]
        record["launches_fused"] = launch_counts["fused"]
        # what the FLOP count cost: the counted launches' windows over the
        # median window of the others
        record["flops_counted_steps"] = self._pass_counted
        if counted_s and uncounted_s:
            record["flops_count_ms"] = 1e3 * (sum(counted_s)
                                              - len(counted_s) * statistics.median(uncounted_s))
        if self._hangwatch is not None:
            record["progress_age_max_s"] = round(self._hangwatch.take_max_age(), 3)
        if obs.enabled():
            record["counters"] = obs.registry().snapshot()
        obs.emit("pass_end", pass_id=pass_id, step=batch_id, **record)
        if self._sparse_stats is not None:
            obs.emit("sparse", pass_id=pass_id, step=batch_id,
                     **self._sparse_stats.pass_record(duration_s=dt))
        obs_spans.record_perf("trainer/pass", pass_t0, time.perf_counter() - pass_t0)

    def _fault_sites(self, pass_id: int, batch_id: int) -> None:
        """The chaos sites, one hit per trained launch: ``trainer.crash``
        (a mid-run death), ``trainer.stall`` (a wedged loop, for the
        hangwatch), ``trainer.oom`` (a synthetic device OOM) and
        ``trainer.nonfinite_layer=raise:LAYER`` (a NaN planted in the
        layer's parameters); with sparse tables, ``sparse.gather_fault``
        (the launch whose rows are about to be gathered fails loudly)."""
        info = f"pass={pass_id} batch={batch_id}"
        faultinject.fault_point("trainer.crash", info=info)
        faultinject.fault_point("trainer.stall", info=info)
        try:
            faultinject.fault_point("trainer.oom", info=info)
        except faultinject.FaultInjected as e:
            raise obs_mem.SyntheticOomError(info) from e
        try:
            faultinject.fault_point("trainer.nonfinite_layer", info=info)
        except faultinject.FaultInjected as e:
            self._poison_layer(e.arg, pass_id, batch_id)
        if self._sparse_stats is not None:
            faultinject.fault_point("sparse.gather_fault", info=info)

    def _start_profiler(self):
        """The profiler window: whole launches of the first pass, from
        --profile_start_batch for --profile_num_batches."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        logger.info("profiler trace started → %s", self.flags.profile_dir)
        return prof

    def _stop_profiler(self, prof, pass_id: int) -> None:
        """Close the window once the card has run its last launch, and write
        the Chrome trace under --profile_dir."""
        wait_for(next(iter(self.params.values())))
        prof.stop()
        os.makedirs(self.flags.profile_dir, exist_ok=True)
        path = os.path.join(self.flags.profile_dir, f"trace-pass{pass_id:05d}.json")
        prof.export_chrome_trace(path)
        logger.info("profiler trace written to %s", path)

    def _end_dot_line(self) -> None:
        """Terminate a run of progress dots before a log line."""
        if self._dots_pending:
            print("", flush=True, file=sys.stderr)
            self._dots_pending = False

    def show_parameter_stats(self) -> None:
        """Per-parameter value stats (ref: TrainerInternal::showParameterStats,
        TrainerInternal.cpp:184-213)."""
        for name in sorted(self.params):
            v = self.params[name].detach().cpu().numpy()
            logger.info("Param %-40s mean=%.5g absmax=%.5g std=%.5g shape=%s",
                        name, float(v.mean()), float(np.abs(v).max()), float(v.std()),
                        tuple(v.shape))

    # --------------------------------------------- divergence recovery

    def _nf_snapshot(self):
        """The pre-launch state: what skip hands back, and what every
        policy's blame re-runs. The updater is functional but for the sparse
        tables (it returns new tensors) and the step replaces
        ``self.params``' entries, never a tensor's values, so references are
        a true copy of the state, on the card. They keep the pre-launch
        tensors alive until the launch's loss gate, under abort too, so that
        its blame re-runs the exact poisoned step (the JAX package's abort
        donates those buffers and blames the updated parameters). The sparse
        tables and their slots are updated in place: the updater's ``undo``
        log keeps the old values of the rows the launch writes, O(N·D)."""
        self.updater.undo = [] if self._sparse_plan else None
        return (dict(self.params), self.opt_state, self._acc, self._acc_batches,
                self._acc_samples, self.updater.undo)

    def _poisoned_loss(self, loss_f: float, pass_id: int, batch_id: int) -> float:
        """The ``trainer.nonfinite`` site, one hit per batch: a firing
        ``raise`` turns this batch's loss into NaN."""
        try:
            faultinject.fault_point("trainer.nonfinite", info=f"pass={pass_id} batch={batch_id}")
        except faultinject.FaultInjected:
            logger.warning("injected non-finite loss at pass %d batch %d", pass_id, batch_id)
            return float("nan")
        return loss_f

    def _handle_nonfinite(self, pass_id, batch_id, value, snap, launch_note="", batch=None,
                          seed=None) -> bool:
        """Apply --nonfinite_policy to one non-finite loss: True when the
        poisoned launch was discarded (skip); raises NonFiniteLossError
        (abort, an exhausted budget) or _RollbackRequest (rollback). The
        poisoned ``batch`` is re-run layer by layer first, and the first
        layer with a non-finite value rides the ``nonfinite`` record and the
        error."""
        base = f"non-finite loss ({value}) at pass {pass_id} batch {batch_id} {launch_note}"
        # the sparse tables' rows back to their pre-launch values, before
        # the blame re-runs the step on the snapshot (under abort too)
        self.updater.undo_sparse(snap[5])
        self.updater.undo = None
        blame = None
        if batch is not None:
            blame = obs_num.blame_nonfinite(self.gm, self.config.model_config, snap[0], batch,
                                            seed)
        blame_fields: Dict[str, Any] = {}
        blame_note = ""
        if blame is not None:
            blame_fields = {"blame_layer": blame["layer"], "blame_phase": blame["phase"]}
            blame_note = (f" [first nonfinite at layer {blame['layer']!r}, {blame['phase']} "
                          f"phase, {blame['nonfinite']} value(s)]")
            logger.warning("nonfinite blame: first nonfinite value at layer %r (%s phase, %d "
                           "nonfinite value(s)%s)", blame["layer"], blame["phase"],
                           blame["nonfinite"],
                           f", param {blame['param']}" if blame.get("param") else "")
        if self._numerics_last is not None:
            # the poisoned launch's health table goes out with the event
            self._emit_numerics(pass_id, batch_id)
        obs.registry().counter("nonfinite.events").inc()
        obs.emit("nonfinite", pass_id=pass_id, step=batch_id, value=value,
                 policy=self._nf_policy, **blame_fields)
        if self._nf_policy == "abort":
            raise NonFiniteLossError(
                base + blame_note + "— aborting. Try a lower learning rate or gradient "
                "clipping to locate the cause (or --nonfinite_policy=skip/rollback to "
                "recover).", value=value, pass_id=pass_id, batch_id=batch_id)
        self._nf_count += 1
        if self._nf_count > self._nf_budget:
            raise NonFiniteLossError(
                base + blame_note + f"— non-finite budget exhausted (--max_nonfinite_steps="
                f"{self._nf_budget}, {self._nf_count - 1} poisoned event(s) already recovered)",
                value=value, pass_id=pass_id, batch_id=batch_id)
        (self.params, self.opt_state, self._acc, self._acc_batches, self._acc_samples) = snap[:5]
        if self._nf_policy == "skip":
            logger.warning("%s— update discarded (%d/%d non-finite budget used)", base,
                           self._nf_count, self._nf_budget)
            return True
        raise _RollbackRequest(pass_id, batch_id)

    def _emit_numerics(self, pass_id: int, batch_id: int) -> None:
        """Copy the newest health table to the host (the numerics plane's
        only read) and emit the ``numerics`` record."""
        health = self._numerics_last.cpu().numpy()
        layers, nf_layers, grad_norm = obs_num.derive(health, list(self._numerics_groups))
        obs.emit("numerics", pass_id=pass_id, step=batch_id, layers=layers,
                 nonfinite_layers=nf_layers, global_grad_norm=grad_norm)
        r = obs.registry()
        r.gauge("numerics.global_grad_norm").set(grad_norm if math.isfinite(grad_norm) else -1.0)
        if nf_layers:
            r.counter("numerics.nonfinite_layer_events").inc(len(nf_layers))

    def _poison_layer(self, layer: Optional[str], pass_id: int, batch_id: int) -> None:
        """``trainer.nonfinite_layer``: one NaN in each of the named layer's
        parameters, what a non-finite gradient applied by the optimizer
        leaves behind, written into new tensors."""
        groups = self._numerics_groups or obs_num.layer_groups(self.config.model_config,
                                                               list(self.params))
        pnames = groups.get(layer or "")
        if not pnames:
            logger.warning("trainer.nonfinite_layer: no parameters belong to layer %r (known: "
                           "%s) — nothing poisoned", layer, ", ".join(sorted(groups)))
            return
        self.params = dict(self.params)
        for pn in pnames:
            v = self.params[pn].clone()
            v.view(-1)[0] = float("nan")
            self.params[pn] = v
        logger.warning("injected NaN into layer %r parameter(s) %s at pass %d batch %d "
                       "(trainer.nonfinite_layer)", layer, pnames, pass_id, batch_id)

    def _oom_premortem(self, err: BaseException) -> None:
        """oom_report.json into the run dir before the OOM propagates: the
        error, the allocator's stats, where the run died and the telemetry
        tail (a backstop timer guarantees EXIT_OOM if the forensics wedge)."""
        from paddle_tpu_torch.resilience.hangwatch import run_dir_of

        report_dir = run_dir_of(self.flags.metrics_path or self.save_dir or ".")
        kind = torch.cuda.get_device_name(self.device) if self.device.type == "cuda" else "cpu"
        obs_mem.trigger_oom_report(
            report_dir, err,
            where=({"pass": self._last_launch[0], "step": self._last_launch[1]}
                   if self._last_launch is not None else None),
            device_kind=kind, exit_fn=os._exit)

    def _apply_rollback(self, rb: _RollbackRequest) -> int:
        """--nonfinite_policy=rollback: restore the newest verified
        checkpoint, temper the learning rate by --rollback_lr_scale and
        fast-forward past the poisoned batch. Returns the pass to resume."""
        path = ckpt.find_restorable_checkpoint(self.save_dir) if self.save_dir else None
        if path is None:
            raise NonFiniteLossError(
                f"non-finite loss at pass {rb.pass_id} batch {rb.batch_id} — "
                "--nonfinite_policy=rollback found no restorable checkpoint under --save_dir "
                "to roll back to", pass_id=rb.pass_id, batch_id=rb.batch_id)
        # the restore is recovery, not a hang
        if self._hangwatch is not None:
            self._hangwatch.ping(rb.pass_id, rb.batch_id)
        restored = self._restore(path)
        if self._hangwatch is not None:
            self._hangwatch.ping(rb.pass_id, rb.batch_id)
        scale = float(self.flags.rollback_lr_scale or 1.0)
        oc = self.config.opt_config
        old_lr = oc.learning_rate
        # the updater reads the config's rate at every update
        oc.learning_rate = old_lr * scale
        self._acc, self._acc_batches, self._acc_samples = None, 0, 0
        self.rollbacks += 1
        self._ff_target = (rb.pass_id, rb.batch_id + 1)
        resume = (restored + 1) if restored is not None else rb.pass_id
        logger.warning("rollback: non-finite loss at pass %d batch %d — restored %s, "
                       "learning_rate %g -> %g (x%g), resuming at pass %d (will fast-forward "
                       "past batch %d of pass %d)", rb.pass_id, rb.batch_id, path, old_lr,
                       oc.learning_rate, scale, resume, rb.batch_id, rb.pass_id)
        return resume

    # -------------------------------------------------------------- test

    def test(self, pass_id: int = -1) -> Dict[str, float]:
        """The test pass over the test provider ({} without one); a config
        without a cost runs :meth:`predict` instead."""
        provider = self._provider(for_test=True)
        if provider is None:
            return {}
        if not self.gm.cost_layer_names():
            return self.predict(provider)
        return self.test_batches(self._device_batches(provider.batches()), pass_id=pass_id)

    def test_batches(self, batches: Iterable[Batch], pass_id: int = -1) -> Dict[str, float]:
        """One test pass over ``batches`` with the averaged parameters: a
        forward without gradients per batch, the mean per-sample cost (a
        partial batch counts by its own rows), and the model's evaluators
        fed on the host. Returns ``{"cost": ..., "<evaluator>.<metric>":
        ...}`` as the JAX package's ``test()``."""
        params = self.updater.averaged_params(self.params, self.opt_state)
        stats = TrainerStats()
        evaluators = EvaluatorChain(self.config.model_config)
        evaluators.start()
        for batch in batches:
            n = self.batch_size(batch)
            outputs, _ = self.gm.forward(params, batch, pass_type="test")
            stats.add(float(self.gm.total_cost(outputs)) * n, n)
            if evaluators:
                evaluators.eval_batch(self._host_outputs(outputs, evaluators))
        results = {"cost": stats.total_cost / max(stats.total_samples, 1)}
        results.update(evaluators.results())
        logger.info("Test (pass %d): %s  %s", pass_id, stats.summary(), evaluators.summary())
        obs.emit("test", pass_id=pass_id, **results)
        return results

    def predict(self, provider) -> Dict[str, float]:
        """Cost-less test job: forward the net and dump output-layer values
        (ref: Tester's prediction path, --predict_output_dir): one text file
        per output layer, a line per sample, ids for id outputs and rows of
        values otherwise, the valid steps of a sequence only; without
        ``--predict_output_dir`` the lines are logged."""
        params = self.updater.averaged_params(self.params, self.opt_state)
        out_dir = self.flags.predict_output_dir
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
        names = self.gm.network.output_layer_names
        files = {}
        n_total = 0
        try:
            for batch in self._device_batches(provider.batches()):
                outputs, _ = self.gm.forward(params, batch, pass_type="test")
                n_total += self.batch_size(batch)
                for name in names:
                    arg = _on_host(outputs[name])
                    f = None
                    if out_dir:
                        f = files.get(name)
                        if f is None:
                            f = files[name] = open(
                                os.path.join(out_dir, f"predict_{name}.txt"), "w")
                    lengths = arg.seq_lengths.numpy() if arg.seq_lengths is not None else None
                    if arg.ids is not None:
                        data = arg.ids.numpy()
                        if data.ndim == 1:
                            data = data[:, None]
                    else:
                        data = arg.value.numpy()
                    for b in range(data.shape[0]):
                        row = data[b]
                        if lengths is not None and row.ndim >= 1 and row.shape[0] >= lengths[b]:
                            row = row[: lengths[b]]
                        line = " ".join(f"{v:.6g}" for v in np.ravel(row))
                        if f is not None:
                            f.write(line + "\n")
                        else:
                            logger.info("predict %s: %s", name, line)
        finally:
            for f in files.values():
                f.close()
        logger.info("Predict done: %d samples%s", n_total, f" → {out_dir}" if out_dir else "")
        return {"samples": float(n_total)}

    # --------------------------------------------------------------- gen

    def _generator_sub(self):
        gen_sub = next((s for s in self.config.model_config.sub_models
                        if s.generator is not None), None)
        if gen_sub is None:
            raise ValueError("config has no generator (use beam_search in the config)")
        return gen_sub

    def generate(self, result_file: Optional[str] = None):
        """The sequence-generation job (ref: RecurrentGradientMachine
        generateSequence and demo/seqToseq gen.conf) over the test data, or
        the train data in order, into ``result_file``, else ``--gen_result``,
        else the config's ``gen_result``. Returns what
        :meth:`generate_batches` returns."""
        gen = self._generator_sub().generator
        result_file = result_file or self.flags.gen_result or gen.result_file
        # generation consumes samples in order (result indices map to data
        # order), even when it falls back to the train data source
        provider = self._provider(for_test=True) or self._provider(for_test=False, ordered=True)
        if provider is None:
            raise ValueError("no data configured for generation")
        return self.generate_batches(self._device_batches(provider.batches()), result_file)

    def generate_batches(self, batches: Iterable[Batch], result_file: Optional[str] = None):
        """Beam search over ``batches`` with the averaged parameters, on the
        machine's device.

        Writes to ``result_file`` (default: the generator's
        ``result_file``), per sample, an index line (the sample's id from
        ``gen.id_input_layer`` when set, else its running index), then
        ``score\\ttok tok ...`` for each of the first
        ``num_results_per_sample`` beams, words from ``dict_file`` when it
        exists. Returns the (best_ids, beam_ids, beam_scores, beam_lens)
        numpy arrays of each batch."""
        gen_sub = self._generator_sub()
        gen = gen_sub.generator
        group = gen_sub.name
        result_file = result_file or gen.result_file
        words = None
        if gen.dict_file and os.path.exists(gen.dict_file):
            with open(gen.dict_file) as f:
                words = [line.rstrip("\n") for line in f]
        params = self.updater.averaged_params(self.params, self.opt_state)
        n_keep = max(int(gen.num_results_per_sample), 1)
        results = []
        sample_idx = 0
        out_f = open(result_file, "w") if result_file else None
        try:
            for batch in batches:
                id_arg = batch.get(gen.id_input_layer) if gen.id_input_layer else None
                sample_ids = (id_arg.ids.reshape(-1).cpu().numpy()
                              if id_arg is not None else None)
                outputs, _ = self.gm.forward(params, batch, pass_type="gen")
                results.append((outputs[group].ids.cpu().numpy(), *beams_of(outputs, group)))
                if out_f is None:
                    continue
                for b, beams in enumerate(beam_lists(outputs, group)):
                    tag = sample_ids[b] if sample_ids is not None else sample_idx
                    out_f.write(f"{tag}\n")
                    for score, toks in beams[:n_keep]:
                        text = " ".join(words[t] if words and t < len(words) else str(t)
                                        for t in toks)
                        out_f.write(f"{score:.6f}\t{text}\n")
                    sample_idx += 1
        finally:
            if out_f is not None:
                out_f.close()
                logger.info("generation results written to %s", result_file)
        return results

    # -------------------------------------------------------------- save

    def save(self, pass_id: int, batch_id: Optional[int] = None, final: bool = False) -> str:
        """Save ``pass-%05d`` under save_dir (the JAX package's single-host
        format, its config in meta.json); returns the path. Rolling
        deletion keeps 3 passes, and never the pass this run restored from
        until a newer save lands; the final save of a run rotates nothing."""
        if not self.save_dir:
            raise ValueError("Trainer.save needs save_dir")
        extra = {"config_json": self.config.to_json()}
        if batch_id is not None:
            extra["batch_id"] = batch_id
        if self._sparse_stats is not None:
            # which parameters are sparse tables and how many hosts wrote
            # them: a restore on another host set counts its reshard
            extra["sparse_tables"] = sparse_rt.registered_tables()
            extra["sparse_hosts"] = 1
        path = ckpt.save_checkpoint(self.save_dir, pass_id, self.params, self.opt_state,
                                    keep=0 if final else 3, extra_meta=extra,
                                    protect_pass=self._restored_pass)
        if self._restored_pass is not None and pass_id != self._restored_pass:
            self._restored_pass = None
        return path


def beam_lists(outputs: Dict[str, Argument], group: str) -> List[List[Tuple[float, List[int]]]]:
    """Each sample's beams from a generator group's ``@beams`` output, in
    the group's order, as [(score, [ids])]: what a block of the result
    file holds, and what :func:`read_result_file` reads back."""
    beam_ids, scores, lens = beams_of(outputs, group)
    return [[(float(scores[b, k]), beam_ids[b, k, : lens[b, k]].tolist())
             for k in range(beam_ids.shape[1])]
            for b in range(beam_ids.shape[0])]


def read_result_file(path: str):
    """A result file of :meth:`Trainer.generate` back as
    [(index line, [(score, [ids])])], in file order (a dict file's words
    do not parse back)."""
    blocks = []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if "\t" in line:
                score, text = line.split("\t")
                blocks[-1][1].append((float(score), [int(t) for t in text.split()]))
            else:
                blocks.append((line, []))
    return blocks


def _host_tensor(t: torch.Tensor) -> torch.Tensor:
    """On the host, a bf16 tensor (a bf16 model's activation) widened to
    float32, exactly: the evaluators read numpy, which has no bf16."""
    t = t.detach().cpu()
    return t.float() if t.dtype == torch.bfloat16 else t


def _on_host(a: Argument) -> Argument:
    return Argument(**{f.name: None if getattr(a, f.name) is None
                       else _host_tensor(getattr(a, f.name))
                       for f in dataclasses.fields(a)})
