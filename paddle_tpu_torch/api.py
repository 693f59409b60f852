"""Embedding API — drive the framework from user Python programs.

Port of ``paddle_tpu/api.py`` (the role of the reference's SWIG binding,
PaddleAPI.h and py_paddle/util.py): load a parsed config, build a
machine, run forward/forwardBackward on feeds of
:class:`~paddle_tpu_torch.graph.Argument`, read and write parameters, and
run beam-search generation, without the Trainer. Every machine runs on
the card unless ``device="cpu"`` is asked for.

    tc = nmt_gen_config(vocab=30000, dim=512, beam_size=3, max_length=32)
    machine = GradientMachine.createFromConfigProto(tc.model_config)
    machine.loadParameters("./output/pass-00009")
    results = machine.asSequenceGenerator(beam_size=3).generate(
        nmt_gen_batch(vocab=30000, B=64, T=32, device=machine.device))
    best = results[0][0]          # {"ids": [...], "score": ..., "words"?: [...]}

``initPaddle`` parses flags into the port's ``FLAGS`` (``--use_tpu=false``
puts the machines made afterwards without a ``device`` on the CPU), and
``DataProviderConverter`` packs samples into a feed with the data path's
``BatchAssembler``, as the command line's providers do.
"""

from __future__ import annotations

import copy
import os
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.data.feeder import BatchAssembler
from paddle_tpu_torch.device import DeviceLike
from paddle_tpu_torch.graph.argument import Argument
from paddle_tpu_torch.graph.machine import GradientMachine as _CoreMachine
from paddle_tpu_torch.proto import ModelConfig
from paddle_tpu_torch.trainer import checkpoint as ckpt
from paddle_tpu_torch.trainer.trainer import beam_lists
from paddle_tpu_torch.utils.flags import FLAGS

__all__ = [
    "initPaddle",
    "GradientMachine",
    "DataProviderConverter",
    "SequenceGenerator",
]

def initPaddle(*args: str) -> None:
    """Process-level init (ref: swig_paddle.initPaddle). Flags in
    ``--name=value`` form; unknown names are ignored."""
    FLAGS.parse(list(args))


class DataProviderConverter:
    """samples -> feed dict of Arguments, on the host (ref: py_paddle
    DataProviderWrapperConverter / dataprovider_converter.py:22-56).

    ``input_types`` are the @provider slot declarations; ``slot_names``
    the data-layer names in config input order. A machine's ``_feed``
    moves the feed to its device.
    """

    def __init__(self, input_types: Sequence, slot_names: Sequence[str]):
        self.assembler = BatchAssembler(input_types, slot_names)

    def __call__(self, samples: List[Sequence[Any]]) -> Dict[str, Argument]:
        return self.assembler.assemble(samples)


def _on(arg: Argument, device: torch.device) -> Argument:
    return Argument(**{f: None if getattr(arg, f) is None else getattr(arg, f).to(device)
                       for f in ("value", "ids", "seq_lengths", "sub_seq_lengths", "weight")})


class GradientMachine:
    """Machine wrapper with numpy-faced parameters (ref: PaddleAPI.h:626
    GradientMachine). ``device=None`` means the card, unless
    ``initPaddle("--use_tpu=false")`` asked for the CPU."""

    def __init__(self, model_config: ModelConfig, params=None, seed: int = 1,
                 device: DeviceLike = None):
        if device is None and not FLAGS.use_tpu:
            device = "cpu"
        self._core = _CoreMachine(model_config, device)
        self.device = self._core.device
        self.model_config = model_config
        self.params = params if params is not None else self._core.init_params(seed=seed)

    # -- construction ----------------------------------------------------

    @classmethod
    def createFromConfigProto(cls, model_config: ModelConfig, seed: int = 1,
                              device: DeviceLike = None):
        return cls(model_config, seed=seed, device=device)

    @classmethod
    def createFromConfigFile(cls, config_file: str, config_args: str = "",
                             device: DeviceLike = None):
        from paddle_tpu_torch.config import parse_config

        conf = parse_config(config_file, config_args)
        return cls(conf.model_config, device=device)

    # -- parameters ------------------------------------------------------

    def loadParameters(self, path: str) -> None:
        """Load parameters from a checkpoint dir (pass-NNNNN), a save_dir
        containing pass dirs (the latest wins), or a merged-model .npz."""
        if os.path.isfile(path):  # a merged model
            with np.load(path, allow_pickle=False) as z:
                loaded = {k: z[k] for k in z.files if k != "__config_json__"}
            missing = sorted(set(self.params) - set(loaded))
            if missing:
                raise KeyError(f"parameters {missing} missing from {path}")
            self.params = {k: torch.from_numpy(np.array(loaded[k])).to(self.device)
                           for k in self.params}
            return
        if not ckpt.has_params_tree(path):
            latest = ckpt.latest_pass(path)
            if latest is None:
                raise FileNotFoundError(f"no checkpoint under {path}")
            path = os.path.join(path, ckpt.PASS_FMT % latest)
        self.params, _, _ = ckpt.load_checkpoint(path, None, device=self.device,
                                                 expected_params=self.params)

    def saveParameters(self, save_dir: str, pass_id: int = 0) -> None:
        ckpt.save_checkpoint(save_dir, pass_id, self.params)

    def getParameterNames(self) -> List[str]:
        return sorted(self.params.keys())

    def getParameter(self, name: str) -> np.ndarray:
        return self.params[name].detach().cpu().numpy()

    def setParameter(self, name: str, value) -> None:
        cur = self.params[name]
        arr = torch.as_tensor(np.asarray(value), dtype=cur.dtype).to(cur.device)
        if arr.shape != cur.shape:
            raise ValueError(f"{name}: {tuple(arr.shape)} != {tuple(cur.shape)}")
        self.params[name] = arr

    # -- inference -------------------------------------------------------

    def input_layer_names(self) -> List[str]:
        return list(self.model_config.input_layer_names)

    def output_layer_names(self) -> List[str]:
        return list(self._core.network.output_layer_names)

    def _feed(self, in_args) -> Dict[str, Argument]:
        """Normalize a feed onto the machine's device: a dict keyed by
        data-layer names, a positionally keyed dict ("0", "1", ...), or a
        list of Arguments in config input order."""
        names = self.input_layer_names()
        if isinstance(in_args, dict):
            if not any(n in in_args for n in names):
                in_args = {n: in_args[str(i)] for i, n in enumerate(names)
                           if str(i) in in_args}
        else:
            in_args = dict(zip(names, in_args))
        return {n: _on(a, self.device) for n, a in in_args.items()}

    def forwardTest(self, in_args) -> List[Dict[str, np.ndarray]]:
        """Forward in test mode; one dict per output layer with numpy
        ``value`` / ``id`` / ``sequence_lengths`` entries."""
        outputs, _ = self._core.forward(self.params, self._feed(in_args), pass_type="test")
        result = []
        for name in self.output_layer_names():
            arg = outputs[name]
            entry: Dict[str, np.ndarray] = {}
            for key, field in (("value", "value"), ("id", "ids"),
                               ("sequence_lengths", "seq_lengths")):
                if getattr(arg, field) is not None:
                    entry[key] = getattr(arg, field).cpu().numpy()
            result.append(entry)
        return result

    def forwardBackward(self, in_args, seed: Optional[int] = None):
        """One loss and gradient evaluation (custom training loops); ``seed``
        draws the layers' random bits (dropout). Returns (loss: float,
        grads: dict name -> numpy)."""
        loss, grads, _, _ = self._core.grad_fn()(self.params, self._feed(in_args), seed)
        # row-sparse embedding gradients densify for this numpy API (small
        # models only; training never materializes them)
        return float(loss), {k: (v.to_dense() if hasattr(v, "to_dense") else v).detach().cpu()
                             .numpy() for k, v in grads.items()}

    # -- generation ------------------------------------------------------

    def asSequenceGenerator(self, dict_file: str = "", begin_token: Optional[int] = None,
                            end_token: Optional[int] = None, max_length: Optional[int] = None,
                            beam_size: Optional[int] = None) -> "SequenceGenerator":
        """Overrides (when given) go into a copy of the generator's config
        (ref: PaddleAPI.h:775)."""
        return SequenceGenerator(self, dict_file, begin_token=begin_token,
                                 end_token=end_token, max_length=max_length,
                                 beam_size=beam_size)

    def asDecodeEngine(self, slots: int = 8, prompt_tokens: int = 32, queue_cap: int = 0,
                       request_timeout_s: float = 60.0, decode_block=1,
                       pipeline: bool = True, fused_step: bool = False,
                       spec_tokens="0", slot_dtype: str = "f32"):
        """The continuous-batching engine over this machine's generation
        graph: greedy decode, the argmax of each step's log-probabilities.
        Its streams equal :class:`SequenceGenerator`'s at beam 1 token for
        token but where two words' float32 totals cum + logp round to one
        number: beam 1 then takes the lower index, the argmax may take the
        other (PERF.md, the beam cell). Returns it unstarted."""
        from paddle_tpu_torch.serving.frontend import build_engine

        return build_engine(self._core, self.params, slots=slots,
                            prompt_tokens=prompt_tokens, queue_cap=queue_cap,
                            request_timeout_s=request_timeout_s, decode_block=decode_block,
                            pipeline=pipeline, fused_step=fused_step,
                            spec_tokens=spec_tokens, slot_dtype=slot_dtype)


def _feed_signature(in_args):
    """The feed's shapes: a call with a new signature is flagged
    ``cold_start`` (the JAX package's jit retraces per shape). An
    unreadable feed collapses to one bucket."""
    try:
        parts = []
        items = sorted(in_args.items()) if isinstance(in_args, dict) else enumerate(in_args)
        for name, arg in items:
            for field in ("ids", "value", "seq_lengths"):
                v = getattr(arg, field, None)
                if v is not None:
                    parts.append((str(name), field, tuple(v.shape)))
        return tuple(parts)
    except (AttributeError, TypeError):
        return None


def _feed_batch_size(in_args) -> int:
    """Sample count of a feed from any input's leading dimension, at least 1
    (one error record beats none)."""
    try:
        for arg in (in_args.values() if isinstance(in_args, dict) else in_args):
            for field in ("seq_lengths", "ids", "value"):
                v = getattr(arg, field, None)
                if v is not None:
                    return max(int(v.shape[0]), 1)
    except (AttributeError, TypeError, IndexError):
        pass
    return 1


def _prompt_token_counts(in_args) -> List[int]:
    """Per-sample prompt token counts from the feed's first sequence input;
    a dense-only feed gives an empty list."""
    try:
        for arg in (in_args.values() if isinstance(in_args, dict) else in_args):
            sl = getattr(arg, "seq_lengths", None)
            if sl is not None:
                return [int(x) for x in torch.as_tensor(sl).reshape(-1).tolist()]
    except (AttributeError, TypeError):
        pass
    return []


class SequenceGenerator:
    """Beam-search generation facade (ref: PaddleAPI.h:775 and
    ISequenceResults) over a config whose sub-model declares a generator
    (``beam_search`` in the DSL). One call is one run-to-completion cohort;
    for concurrent use the continuous-batching engine
    (``machine.asDecodeEngine``) subsumes it at beam_size=1."""

    def __init__(self, machine: GradientMachine, dict_file: str = "",
                 begin_token: Optional[int] = None, end_token: Optional[int] = None,
                 max_length: Optional[int] = None, beam_size: Optional[int] = None):
        self.machine = machine
        self.words: Optional[List[str]] = None
        if dict_file:
            with open(dict_file) as f:
                self.words = [line.rstrip("\n") for line in f]
        # overrides go into a private copy of the model config, so they never
        # leak into the machine or later generators; a core machine of its
        # own walks the copy with the machine's live parameters
        model_cfg = machine.model_config
        if any(x is not None for x in (begin_token, end_token, max_length, beam_size)):
            model_cfg = copy.deepcopy(machine.model_config)
        subs = [s for s in model_cfg.sub_models if s.generator is not None]
        if not subs:
            raise ValueError("config declares no generator sub-model (beam_search)")
        self.sub = subs[0]
        group_cfg = next((l for l in model_cfg.layers if l.name == self.sub.name), None)
        if max_length is not None:
            self.sub.generator.max_num_frames = int(max_length)
        if beam_size is not None and group_cfg is not None:
            group_cfg.beam_size = int(beam_size)
            self.sub.generator.beam_size = int(beam_size)
        if begin_token is not None and group_cfg is not None:
            group_cfg.bos_id = int(begin_token)
        if end_token is not None and group_cfg is not None:
            group_cfg.eos_id = int(end_token)
        self._core = (machine._core if model_cfg is machine.model_config
                      else _CoreMachine(model_cfg, machine.device))
        self._seen_sigs: set = set()

    def generate(self, in_args) -> List[List[Dict[str, Any]]]:
        """Returns, per input sample, its beams best first:
        ``{"ids": [...], "score": float, "words": [...]}`` (``words`` with a
        dict file).

        With telemetry configured (``observability.metrics.configure``),
        every call emits one ``kind=request`` record per sample: the call is
        one cohort, each sample a request with no queue wait; the first call
        of each feed signature is flagged ``cold_start``."""
        from paddle_tpu_torch.observability import metrics as _metrics
        from paddle_tpu_torch.observability import serving as _serving

        telemetry = _metrics.enabled()
        sig = _feed_signature(in_args) if telemetry else None
        cold_start = telemetry and sig not in self._seen_sigs
        prompt_lens = _prompt_token_counts(in_args) if telemetry else []
        beam_size = self.sub.generator.beam_size
        t0 = time.perf_counter()
        try:
            outputs, _ = self._core.forward(self.machine.params, self.machine._feed(in_args),
                                            pass_type="gen")
            if self.machine.device.type == "cuda":
                torch.cuda.synchronize(self.machine.device)
        except Exception:
            if telemetry:
                # even a dense-only feed leaves error evidence, sized from
                # the feed
                _serving.log_oneshot(prompt_lens, [], time.perf_counter() - t0,
                                     beam_size=beam_size, outcome="error",
                                     n=len(prompt_lens) or _feed_batch_size(in_args),
                                     cold_start=cold_start)
            raise
        service_s = time.perf_counter() - t0
        if telemetry:
            self._seen_sigs.add(sig)
        results = []
        for beams in beam_lists(outputs, self.sub.name):
            sample = []
            for score, ids in beams:
                entry: Dict[str, Any] = {"ids": ids, "score": score}
                if self.words is not None:
                    entry["words"] = [self.words[i] if 0 <= i < len(self.words) else "<unk>"
                                      for i in ids]
                sample.append(entry)
            sample.sort(key=lambda e: -e["score"])
            results.append(sample)
        # gen_tokens counts the best beam's tokens, from the sorted results
        _serving.log_oneshot(
            prompt_lens if len(prompt_lens) == len(results) else [0] * len(results),
            [len(sample[0]["ids"]) if sample else 0 for sample in results],
            service_s, beam_size=beam_size, cold_start=cold_start)
        return results
