"""Parameter / layer attribute objects.

API-compatible with the reference's trainer_config_helpers.attrs
(/root/reference/python/paddle/trainer_config_helpers/attrs.py): users pass
``ParamAttr(...)`` / ``ExtraAttr(...)`` into layer functions to control
init, per-parameter learning rate/regularization, dropout, etc.
"""

from __future__ import annotations

from typing import Optional

__all__ = [
    "HookAttr",
    "HookAttribute",
    "ParamAttr",
    "ExtraAttr",
    "ParameterAttribute",
    "ExtraLayerAttribute",
]


class HookAttribute:
    """Parameter updater hook declaration (StaticPruningHook,
    /root/reference/paddle/parameter/ParameterUpdaterHook.cpp:37):
    ``HookAttr(type="pruning", mask_filename="layer.mask")`` keeps the
    weights disabled by the bitmask file at zero through training."""

    def __init__(self, type: str = "pruning", mask_filename: str = ""):
        assert type in ("pruning", "static_pruning"), type
        assert mask_filename, "pruning hook needs a mask_filename"
        self.type = type
        self.mask_filename = mask_filename


class ParameterAttribute:
    def __init__(
        self,
        name: Optional[str] = None,
        is_static: bool = False,
        initial_std: Optional[float] = None,
        initial_mean: Optional[float] = None,
        initial_max: Optional[float] = None,
        initial_min: Optional[float] = None,
        l1_rate: Optional[float] = None,
        l2_rate: Optional[float] = None,
        learning_rate: Optional[float] = None,
        momentum: Optional[float] = None,
        sparse_update: bool = False,
        # TPU extension: logical mesh-axis sharding for this parameter,
        # e.g. sharding=("model", None)
        sharding=None,
        update_hooks=None,
    ):
        self.name = name
        self.is_static = is_static
        self.initial_std = initial_std
        self.initial_mean = initial_mean
        self.initial_max = initial_max
        self.initial_min = initial_min
        self.l1_rate = l1_rate
        self.l2_rate = l2_rate
        self.learning_rate = learning_rate
        self.momentum = momentum
        self.sparse_update = sparse_update
        self.sharding = sharding
        if update_hooks is not None and not isinstance(update_hooks, (list, tuple)):
            update_hooks = [update_hooks]
        self.update_hooks = update_hooks

    def apply_to(self, pc) -> None:
        """Fill a ParameterConfig with the attribute's overrides."""
        if self.is_static:
            pc.is_static = True
        if self.initial_max is not None or self.initial_min is not None:
            lo = self.initial_min if self.initial_min is not None else 0.0
            hi = self.initial_max if self.initial_max is not None else 1.0
            pc.initial_strategy = 1
            pc.initial_mean = (lo + hi) / 2.0
            pc.initial_std = (hi - lo) / 2.0
            pc.initial_smart = False
        elif self.initial_mean is not None or self.initial_std is not None:
            if self.initial_mean is not None:
                pc.initial_mean = self.initial_mean
            if self.initial_std is not None:
                pc.initial_std = self.initial_std
            pc.initial_smart = False
        elif not self.is_static:
            # ParamAttr() with no init fields means "smart" init —
            # std = 1/sqrt(fan_in) (reference attrs.py:67).
            pc.initial_smart = True
        if self.l1_rate is not None:
            pc.decay_rate_l1 = self.l1_rate
        if self.l2_rate is not None:
            pc.decay_rate = self.l2_rate
        if self.learning_rate is not None:
            pc.learning_rate = self.learning_rate
        if self.momentum is not None:
            pc.momentum = self.momentum
        if self.sparse_update:
            pc.sparse_update = True
        if self.sharding is not None:
            pc.sharding = list(self.sharding)
        if self.update_hooks:
            from paddle_tpu_torch.proto import ParameterUpdaterHookConfig

            pc.update_hooks = [
                ParameterUpdaterHookConfig(
                    type=h.type, purning_mask_filename=h.mask_filename
                )
                for h in self.update_hooks
            ]


class ExtraLayerAttribute:
    def __init__(
        self,
        error_clipping_threshold: Optional[float] = None,
        drop_rate: Optional[float] = None,
    ):
        self.error_clipping_threshold = error_clipping_threshold
        self.drop_rate = drop_rate

    def apply_to(self, layer_cfg) -> None:
        if self.error_clipping_threshold is not None:
            layer_cfg.error_clipping_threshold = self.error_clipping_threshold
        if self.drop_rate is not None:
            layer_cfg.drop_rate = self.drop_rate


ParamAttr = ParameterAttribute
HookAttr = HookAttribute
ExtraAttr = ExtraLayerAttribute
