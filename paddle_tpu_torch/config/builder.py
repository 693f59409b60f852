"""Config build context — the state behind the DSL.

Role of the reference's config_parser globals (g_config, g_layer_map,
g_parameter_map, g_current_submodel; /root/reference/python/paddle/trainer/
config_parser.py:167-430): DSL calls append LayerConfig/ParameterConfig
records here; ``parse_config`` opens a context, executes the user script,
and closes it into a TrainerConfig.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional

from paddle_tpu_torch.proto import (
    DataConfig,
    LayerConfig,
    ModelConfig,
    OptimizationConfig,
    ParameterConfig,
    SubModelConfig,
    TrainerConfig,
)

_current: Optional["ConfigContext"] = None


def current_context() -> "ConfigContext":
    global _current
    if _current is None:
        _current = ConfigContext()
    return _current


@contextlib.contextmanager
def fresh_context():
    global _current
    prev = _current
    _current = ConfigContext()
    try:
        yield _current
    finally:
        _current = prev


class ConfigContext:
    def __init__(self) -> None:
        self.trainer_config = TrainerConfig()
        self.model: ModelConfig = self.trainer_config.model_config
        self.layer_map: Dict[str, LayerConfig] = {}
        self.param_map: Dict[str, ParameterConfig] = {}
        # settings() state — mirrors the reference's `settings` dict
        self.settings: Dict[str, Any] = {}
        # per-parameter defaults set by settings()/default_* calls
        # (reference: default_decay_rate / default_momentum / ...)
        self.defaults: Dict[str, Any] = {}
        # sub-model stack: None = root scope
        self.submodel_stack: List[SubModelConfig] = []
        self.root_submodel: Optional[SubModelConfig] = None
        self.config_args: Dict[str, str] = {}
        # memory links declared in the current recurrent group
        self._counters: Dict[str, int] = {}

    # ------------------------------------------------------------ layers

    def unique_name(self, prefix: str) -> str:
        # per-prefix invoke counter (reference wrap_name_default semantics,
        # default_decorators.py:74): names stay stable between configs that
        # differ elsewhere — critical for train vs. generation configs
        # sharing one checkpoint.
        n = self._counters.get(prefix, 0)
        self._counters[prefix] = n + 1
        return f"__{prefix}_{n}__"

    def has_layer(self, name: str) -> bool:
        return name in self.layer_map

    def get_layer(self, name: str) -> LayerConfig:
        try:
            return self.layer_map[name]
        except KeyError:
            raise KeyError(f"unknown layer {name!r}") from None

    def add_layer(self, cfg: LayerConfig) -> LayerConfig:
        if cfg.name in self.layer_map:
            raise ValueError(f"duplicate layer name {cfg.name!r}")
        self.layer_map[cfg.name] = cfg
        self.model.layers.append(cfg)
        if self.submodel_stack:
            self.submodel_stack[-1].layer_names.append(cfg.name)
        elif self.root_submodel is not None:
            self.root_submodel.layer_names.append(cfg.name)
        return cfg

    # -------------------------------------------------------- parameters

    def add_parameter(self, cfg: ParameterConfig) -> ParameterConfig:
        if cfg.name in self.param_map:
            return self.param_map[cfg.name]  # shared parameter reuse
        cfg.para_id = len(self.model.parameters)
        self.param_map[cfg.name] = cfg
        self.model.parameters.append(cfg)
        return cfg

    # -------------------------------------------------------- sub-models

    def ensure_root_submodel(self) -> SubModelConfig:
        """Once any recurrent group exists, the root layer set must be
        tracked explicitly (reference: SubModelBegin/End with 'root')."""
        if self.root_submodel is None:
            root = SubModelConfig(name="root")
            root.layer_names = [l.name for l in self.model.layers]
            self.model.sub_models.insert(0, root)
            self.root_submodel = root
        return self.root_submodel

    def begin_submodel(self, name: str, recurrent: bool = True) -> SubModelConfig:
        self.ensure_root_submodel()
        sub = SubModelConfig(name=name, is_recurrent_layer_group=recurrent)
        self.model.sub_models.append(sub)
        self.submodel_stack.append(sub)
        return sub

    def end_submodel(self) -> SubModelConfig:
        return self.submodel_stack.pop()

    @property
    def in_recurrent_group(self) -> bool:
        return bool(self.submodel_stack)

    def current_submodel(self) -> Optional[SubModelConfig]:
        return self.submodel_stack[-1] if self.submodel_stack else None

    # ------------------------------------------------------------ inputs

    def mark_input(self, name: str) -> None:
        if self.submodel_stack:
            sub = self.submodel_stack[-1]
            if name not in sub.input_layer_names:
                sub.input_layer_names.append(name)
            if sub.is_recurrent_layer_group:
                return
            # plain (multi_nn) sub-network inputs are fed from the data
            # provider like root inputs — fall through
        if name not in self.model.input_layer_names:
            self.model.input_layer_names.append(name)

    def mark_output(self, name: str) -> None:
        if self.submodel_stack:
            sub = self.submodel_stack[-1]
            if name not in sub.output_layer_names:
                sub.output_layer_names.append(name)
            if sub.is_recurrent_layer_group:
                return
            if name not in self.model.output_layer_names:
                self.model.output_layer_names.append(name)
        else:
            if name not in self.model.output_layer_names:
                self.model.output_layer_names.append(name)
            if self.root_submodel is not None and name not in self.root_submodel.output_layer_names:
                self.root_submodel.output_layer_names.append(name)

    # ---------------------------------------------------------- finalize

    def finalize(self) -> TrainerConfig:
        opt = self.trainer_config.opt_config
        s = self.settings
        if s:
            _apply_settings(opt, s)
        if self.root_submodel is not None:
            self.root_submodel.input_layer_names = list(self.model.input_layer_names)
            # model-level outputs include plain (multi_nn) sub-network
            # outputs; the root network serves them all
            self.root_submodel.output_layer_names = list(
                dict.fromkeys(
                    list(self.root_submodel.output_layer_names)
                    + list(self.model.output_layer_names)
                )
            )
        return self.trainer_config


def _apply_settings(opt: OptimizationConfig, s: Dict[str, Any]) -> None:
    direct = [
        "batch_size",
        "algorithm",
        "learning_rate",
        "learning_rate_decay_a",
        "learning_rate_decay_b",
        "learning_rate_schedule",
        "learning_rate_args",
        "average_window",
        "max_average_window",
        "do_average_in_cpu",
        "delta_add_rate",
        "ada_epsilon",
        "ada_rou",
        "shrink_parameter_value",
        "adam_beta1",
        "adam_beta2",
        "adam_epsilon",
        "num_batches_per_send_parameter",
        "num_batches_per_get_parameter",
        "async_lagged_grad_discard_ratio",
        "gradient_clipping_threshold",
        "dtype",
        "mesh_shape",
        "remat",
        "scan_unroll",
        "batches_per_launch",
        "pallas_rnn",
        "pallas_flat",
        "conv_s2d",
        "conv_stats_mode",
        "pallas_decoder",
        "c1",
        "backoff",
        "owlqn_steps",
        "max_backoff",
    ]
    for k in direct:
        if k in s and s[k] is not None:
            setattr(opt, k, s[k])
    if s.get("learning_method") is not None:
        opt.learning_method = s["learning_method"]
    if s.get("l1weight") is not None:
        opt.l1weight = s["l1weight"]
    if s.get("l2weight") is not None:
        opt.l2weight = s["l2weight"]
