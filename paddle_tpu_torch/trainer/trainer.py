"""Trainer — the single-batch train step and the pass loop, on one device.

Port of the core of ``paddle_tpu/trainer/trainer.py``: a train step is
``_one_batch_step`` (gradients from the machine, then the optimizer
update, then the state updates), run eagerly; a test pass is ``test()``
(the averaged parameters, a forward without gradients, the mean
per-sample cost and the configured evaluators); generation is
``generate()`` (beam search over a generation config's batches, into the
JAX package's result file). Batches come from the caller as dicts of :class:`~paddle_tpu_torch.graph.Argument` (for the
NMT model :func:`paddle_tpu_torch.flagship.nmt_batch`, for the LSTM text
classifier :func:`~paddle_tpu_torch.flagship.example_batch`, for ResNet
:func:`~paddle_tpu_torch.flagship.make_image_batch`); data
providers, the ``paddle train`` command line, meshes, asynchronous and
sharded checkpoints are later slices.

    trainer = Trainer(nmt_config(vocab=30000, dim=512, batch_size=64))
    loss = trainer.train_one_batch(nmt_batch(B=64, T=32, seed=1, device=trainer.device))
    results = trainer.test([nmt_batch(B=64, T=32, seed=2, device=trainer.device)])
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterable, List, Optional

import torch

from paddle_tpu_torch.device import DeviceLike
from paddle_tpu_torch.graph.argument import Argument
from paddle_tpu_torch.graph.machine import GradientMachine
from paddle_tpu_torch.graph.recurrent_group import beams_of
from paddle_tpu_torch.optimizer.updater import Updater
from paddle_tpu_torch.trainer import checkpoint as ckpt
from paddle_tpu_torch.trainer.evaluators import EvaluatorChain
from paddle_tpu_torch.utils.logging import logger

Batch = Dict[str, Argument]


class Trainer:
    """``config`` is a TrainerConfig (``model_config`` + ``opt_config``).
    ``device=None`` trains on the card, ``device="cpu"`` on the CPU with
    the kernels' plain versions. Parameters are drawn from ``seed``, and
    dropout draws from a ``torch.Generator`` seeded with ``seed`` as well.
    ``params`` and ``opt_state`` are plain attributes: assign both to start
    from other parameters."""

    def __init__(self, config, device: DeviceLike = None, seed: int = 1,
                 save_dir: Optional[str] = None, log_period: int = 100):
        self.config = config
        opt = config.opt_config
        self.gm = GradientMachine(config.model_config, device,
                                  conv_s2d=opt.conv_s2d, conv_stats_mode=opt.conv_stats_mode)
        self.device = self.gm.device
        self.updater = Updater(config.opt_config, config.model_config)
        self.params = self.gm.init_params(seed)
        self.opt_state = self.updater.init_state(self.params)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))
        self.save_dir = save_dir
        self.log_period = max(1, int(log_period))
        self._grad_fn = self.gm.grad_fn()

    @staticmethod
    def batch_size(batch: Batch) -> int:
        return next(iter(batch.values())).batch_size

    def train_one_batch(self, batch: Batch) -> torch.Tensor:
        """One step: gradients, then the update, then the state updates.
        Returns the batch's loss as a (device) scalar tensor."""
        loss, grads, _outputs, state_updates = self._grad_fn(self.params, batch,
                                                             self.generator)
        self.params, self.opt_state = self.updater(self.params, grads, self.opt_state,
                                                   self.batch_size(batch))
        self.params.update(state_updates)
        return loss

    def train(self, num_passes: int, batches: Iterable[Batch]) -> List[float]:
        """``num_passes`` passes over ``batches`` (iterated once per pass);
        logs AvgCost (the mean per-sample cost since the last log) every
        ``log_period`` batches and saves each pass when ``save_dir`` is
        set. Returns each pass's mean per-sample cost."""
        pass_costs = []
        for pass_id in range(num_passes):
            total = window = 0.0
            samples = window_samples = 0
            for batch_id, batch in enumerate(batches):
                n = self.batch_size(batch)
                cost = float(self.train_one_batch(batch)) * n
                total, window = total + cost, window + cost
                samples, window_samples = samples + n, window_samples + n
                if (batch_id + 1) % self.log_period == 0:
                    logger.info("Pass %d, Batch %d, AvgCost %f", pass_id, batch_id + 1,
                                window / max(window_samples, 1))
                    window, window_samples = 0.0, 0
            pass_costs.append(total / max(samples, 1))
            logger.info("Pass %d done, AvgCost %f", pass_id, pass_costs[-1])
            if self.save_dir:
                self.save(pass_id)
        return pass_costs

    def test(self, batches: Iterable[Batch]) -> Dict[str, float]:
        """One test pass over ``batches`` with the averaged parameters: a
        forward without gradients per batch, the mean per-sample cost, and
        the model's evaluators fed on the host. Returns ``{"cost": ...,
        "<evaluator>.<metric>": ...}`` as the JAX package's ``test()``."""
        params = self.updater.averaged_params(self.params, self.opt_state)
        evaluators = EvaluatorChain(self.config.model_config)
        evaluators.start()
        total, samples = 0.0, 0
        for batch in batches:
            n = self.batch_size(batch)
            outputs, _ = self.gm.forward(params, batch, pass_type="test")
            total += float(self.gm.total_cost(outputs)) * n
            samples += n
            # the evaluators read their inputs through numpy
            evaluators.eval_batch({name: _on_host(outputs[name])
                                   for name in evaluators.needed_layers if name in outputs})
        results = {"cost": total / max(samples, 1)}
        results.update(evaluators.results())
        logger.info("Test: AvgCost %f  %s", results["cost"], evaluators.summary())
        return results

    def generate(self, batches: Iterable[Batch], result_file: Optional[str] = None):
        """Sequence generation over ``batches`` with the averaged parameters
        (the JAX package's ``generate``; ref: RecurrentGradientMachine
        generateSequence and demo/seqToseq gen.conf), beam search on the
        machine's device.

        Writes to ``result_file`` (default: the generator's
        ``result_file``), per sample, an index line (the sample's id from
        ``gen.id_input_layer`` when set, else its running index), then
        ``score\ttok tok ...`` for each of the first
        ``num_results_per_sample`` beams, words from ``dict_file`` when it
        exists. Returns the (best_ids, beam_ids, beam_scores, beam_lens)
        numpy arrays of each batch."""
        gen_sub = next((s for s in self.config.model_config.sub_models
                        if s.generator is not None), None)
        if gen_sub is None:
            raise ValueError("config has no generator (use beam_search in the config)")
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
                ids = outputs[group].ids.cpu().numpy()
                beam_ids, scores, lens = beams_of(outputs, group)
                results.append((ids, beam_ids, scores, lens))
                if out_f is None:
                    continue
                for b in range(ids.shape[0]):
                    tag = sample_ids[b] if sample_ids is not None else sample_idx
                    out_f.write(f"{tag}\n")
                    for k in range(min(n_keep, beam_ids.shape[1])):
                        toks = beam_ids[b, k, : lens[b, k]].tolist()
                        text = " ".join(words[t] if words and t < len(words) else str(t)
                                        for t in toks)
                        out_f.write(f"{scores[b, k]:.6f}\t{text}\n")
                    sample_idx += 1
        finally:
            if out_f is not None:
                out_f.close()
                logger.info("generation results written to %s", result_file)
        return results

    def save(self, pass_id: int) -> str:
        if not self.save_dir:
            raise ValueError("Trainer.save needs save_dir")
        return ckpt.save_checkpoint(self.save_dir, pass_id, self.params, self.opt_state)

    def restore(self, path: str) -> Dict:
        """Load parameters and optimizer state from a pass directory;
        returns its meta."""
        params, opt_state, meta = ckpt.load_checkpoint(
            path, self.opt_state, device=self.device, expected_params=self.params)
        self.params = params
        if opt_state is not None:
            self.opt_state = opt_state
        return meta


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
