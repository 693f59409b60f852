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
(ROADMAP Queue 1): preemption, hang and heartbeat guards, the non-finite
policies other than abort, gradient accumulation, fused launches, meshes,
whole-data batch methods, the profiler window and the telemetry records.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from paddle_tpu_torch.data.feeder import DataProvider, create_data_provider
from paddle_tpu_torch.device import DeviceLike
from paddle_tpu_torch.graph.argument import Argument
from paddle_tpu_torch.graph.machine import GradientMachine
from paddle_tpu_torch.graph.recurrent_group import beams_of
from paddle_tpu_torch.layers.base import fold_seed
from paddle_tpu_torch.optimizer.updater import Updater
from paddle_tpu_torch.resilience import NonFiniteLossError
from paddle_tpu_torch.trainer import checkpoint as ckpt
from paddle_tpu_torch.trainer.evaluators import EvaluatorChain
from paddle_tpu_torch.utils.flags import FLAGS
from paddle_tpu_torch.utils.logging import logger
from paddle_tpu_torch.utils.retry import RetryPolicy

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


# what the JAX package's pass loop does that the port's does not yet:
# (what asks for it, is it asked for?, ROADMAP Queue 1 item)
_UNPORTED = (
    ("--nonfinite_policy=skip|rollback", lambda f, c: f.nonfinite_policy != "abort", 9),
    ("--step_hang_timeout", lambda f, c: f.step_hang_timeout > 0, 9),
    ("--heartbeat_interval", lambda f, c: f.heartbeat_interval > 0, 9),
    ("--profile_dir", lambda f, c: bool(f.profile_dir), 9),
    ("--numerics_log_period", lambda f, c: f.numerics_log_period > 0, 9),
    ("num_batches_per_send_parameter > 1 (gradient accumulation)",
     lambda f, c: c.opt_config.num_batches_per_send_parameter > 1, 9),
    ("batches_per_launch > 1 (fused launches)", lambda f, c: c.opt_config.batches_per_launch > 1, 9),
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
        self.config = config
        self.flags = flags
        opt = config.opt_config
        if device is None and not flags.use_tpu:
            device = "cpu"
        self.gm = GradientMachine(config.model_config, device,
                                  conv_s2d=opt.conv_s2d, conv_stats_mode=opt.conv_stats_mode)
        self.device = self.gm.device
        self.updater = Updater(opt, config.model_config)
        self.params = self.gm.init_params(flags.seed)
        self.opt_state = self.updater.init_state(self.params)
        # dropout draws from a generator of the trainer's seed
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(flags.seed))
        # steps taken by train_one_batch, outside a pass: each is seeded
        # from its own count, as a pass's batches are from their ids
        self._loose_steps = 0
        self.start_pass = flags.start_pass or config.start_pass
        self.save_dir = flags.save_dir or config.save_dir
        # per-pass held-out results appended by train(): [(pass_id, {...})]
        self.test_history: List[Tuple[int, Dict[str, float]]] = []
        self._grad_fn = self.gm.grad_fn()
        self._dots_pending = False
        if opt.algorithm == "async_sgd":
            logger.warning("async_sgd with a single data-parallel replica is exactly sync SGD — "
                           "running the ordinary sync step")
        self._maybe_restore()

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
        return meta

    # ------------------------------------------------------------- steps

    @staticmethod
    def batch_size(batch: Batch) -> int:
        return next(iter(batch.values())).batch_size

    def _step(self, batch: Batch, seed: int):
        """One step: gradients, then the update, then the state updates.
        ``seed`` is the step's, for the layers that draw ids (sampling_id,
        nce). Returns the batch's loss (a device scalar) and the layer
        outputs."""
        loss, grads, outputs, state_updates = self._grad_fn(self.params, batch, self.generator,
                                                            seed)
        self.params, self.opt_state = self.updater(self.params, grads, self.opt_state,
                                                   self.batch_size(batch))
        self.params.update(state_updates)
        return loss, outputs

    def train_one_batch(self, batch: Batch) -> torch.Tensor:
        """One step on a batch on the trainer's device; returns its loss as
        a (device) scalar tensor."""
        self._loose_steps += 1
        return self._step(batch, fold_seed(self.flags.seed, -1, self._loose_steps))[0]

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

    def _device_batches(self, host_batches: Iterable[Batch]) -> Iterator[Batch]:
        """One-batch-ahead device transfer: the next batch's copy is enqueued
        before the current batch is handed to the step (the device-side
        half of the reference's DoubleBuffer, DataProvider.h:245; the host
        half is the feeder's prefetch threads)."""
        it = iter(host_batches)
        first = next(it, None)
        if first is None:
            return
        cur = self._to_device(first)
        for host in it:
            nxt = self._to_device(host)
            yield cur
            cur = nxt
        yield cur

    def _host_outputs(self, outputs: Dict[str, Argument],
                      evaluators: EvaluatorChain) -> Dict[str, Argument]:
        """The layers the evaluators read, on the host (they read numpy)."""
        return {name: _on_host(outputs[name])
                for name in evaluators.needed_layers if name in outputs}

    # ------------------------------------------------------------- train

    def train(self, num_passes: Optional[int] = None) -> None:
        """Passes ``start_pass`` .. ``num_passes - 1`` over the train
        provider, built once so that its shuffle carries over from pass to
        pass; after each, a test pass and a save every ``--saving_period``
        passes, and a final save of the last pass."""
        num_passes = num_passes or self.flags.num_passes
        train_provider = self._provider(for_test=False)
        if train_provider is None:
            raise ValueError("no train data configured (define_py_data_sources2 train_list)")
        saved_pass = -1
        for pass_id in range(self.start_pass, num_passes):
            self.train_one_pass(pass_id, train_provider)
            pass_results = self.test(pass_id=pass_id)
            if pass_results:
                self.test_history.append((pass_id, pass_results))
            if self.save_dir and (pass_id + 1) % max(self.flags.saving_period, 1) == 0:
                self.save(pass_id)
                saved_pass = pass_id
        if self.save_dir and saved_pass != num_passes - 1 and num_passes > self.start_pass:
            self.save(num_passes - 1, final=True)

    def train_one_pass(self, pass_id: int, provider) -> None:
        """One pass over ``provider.batches()``."""
        stats = TrainerStats()
        evaluators = EvaluatorChain(self.config.model_config)
        evaluators.start()
        flags = self.flags
        t0 = time.monotonic()
        batch_id = 0
        for batch in self._device_batches(provider.batches()):
            n = self.batch_size(batch)
            loss, outputs = self._step(batch, fold_seed(flags.seed, pass_id, batch_id))
            loss_f = float(loss)
            if not np.isfinite(loss_f):
                # the reference's FP trap (TrainerMain.cpp:96); the JAX
                # package's --nonfinite_policy=abort
                raise NonFiniteLossError(
                    f"non-finite loss ({loss_f}) at pass {pass_id} batch {batch_id} — aborting. "
                    "Try a lower learning rate or gradient clipping to locate the cause.",
                    value=loss_f, pass_id=pass_id, batch_id=batch_id)
            stats.add(loss_f * n, n)
            if evaluators:
                evaluators.eval_batch(self._host_outputs(outputs, evaluators))
            del outputs
            batch_id += 1
            if flags.dot_period and batch_id % flags.dot_period == 0:
                print(".", end="", flush=True, file=sys.stderr)
                self._dots_pending = True
            if flags.test_period and batch_id % flags.test_period == 0:
                self._end_dot_line()
                self.test(pass_id=pass_id)
            if flags.show_parameter_stats_period \
                    and batch_id % flags.show_parameter_stats_period == 0:
                self._end_dot_line()
                self.show_parameter_stats()
            if flags.log_period and batch_id % flags.log_period == 0:
                self._end_dot_line()
                logger.info("Pass %d batch %d  %s  %s", pass_id, batch_id, stats.summary(),
                            evaluators.summary())
                stats.reset_window()
            if flags.saving_period_by_batches and self.save_dir \
                    and batch_id % flags.saving_period_by_batches == 0:
                self.save(pass_id, batch_id=batch_id)
        self._end_dot_line()
        rate = stats.total_samples / max(time.monotonic() - t0, 1e-9)
        logger.info("Pass %d done: %s  %s  (%.1f samples/s)", pass_id, stats.summary(),
                    evaluators.summary(), rate)

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


def _on_host(a: Argument) -> Argument:
    return Argument(**{f.name: None if getattr(a, f.name) is None
                       else getattr(a, f.name).detach().cpu()
                       for f in dataclasses.fields(a)})
