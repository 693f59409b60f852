"""Parameter updater — the reference optimizer family as one update function.

Port of ``paddle_tpu/optimizer/updater.py`` (reference
FirstOrderOptimizer.h: Sgd/momentum, Adagrad, DecayedAdagrad, RMSProp,
AdaDelta, Adam, Adamax; OptimizerWithGradientClipping; L1/L2 decay;
AverageOptimizer's windowed parameter averaging). Per-parameter
attributes honored (ParameterConfig): learning_rate scale, momentum,
decay_rate (L2), decay_rate_l1, gradient_clipping_threshold, is_static.

The update is functional, as in the JAX package: it returns new parameter
and slot tensors and leaves its inputs untouched. Counters and scalar
rates live on the host (Python numbers), computed in float32 as the JAX
package computes them, so a step needs no device-to-host copy. Row-sparse
gradients (``sparse_update`` tables) and the pruning hooks are a later
slice and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from paddle_tpu_torch.optimizer.schedules import learning_rate_at
from paddle_tpu_torch.proto import ModelConfig, OptimizationConfig, ParameterConfig

Tensor = torch.Tensor
Params = Dict[str, Tensor]
_f32 = np.float32


class UpdaterState(NamedTuple):
    step: int                               # batch counter
    num_samples: float                      # samples processed (lr schedules)
    slots: Dict[str, Dict[str, Tensor]]     # per-parameter optimizer buffers
    # sliding-window parameter averaging: the current window's running
    # sum and count plus the previous full window;
    # average = (sum + old_sum) / (count + old_count)
    avg_sum: Optional[Params]
    avg_count: float
    avg_old_sum: Optional[Params] = None
    avg_old_count: Optional[float] = None


class Updater:
    def __init__(self, opt: OptimizationConfig, model: ModelConfig):
        self.opt = opt
        self.param_configs: Dict[str, ParameterConfig] = {p.name: p for p in model.parameters}
        self.method = opt.learning_method
        self.averaging = opt.average_window > 0
        # window limits (AverageOptimizer): the current window closes once
        # it holds >= min(max_average_window, numUpdates * average_window)
        # batches (and >= min_window)
        self.avg_frac = float(opt.average_window)
        self.max_window = float(opt.max_average_window)
        self.min_window = float(min(10000, opt.max_average_window))
        for name, cfg in self.param_configs.items():
            if any(h.type in ("pruning", "static_pruning") for h in cfg.update_hooks):
                raise NotImplementedError(
                    f"parameter {name!r}: pruning hooks are not ported yet")

    # ------------------------------------------------------------- state

    def _slot_names(self):
        m = self.method
        if m in ("momentum", "sparse_momentum", "sgd"):
            return ["mom"]
        if m in ("adagrad", "decayed_adagrad"):
            return ["accum"]
        if m == "rmsprop":
            return ["accum_g2", "accum_g"]
        if m == "adadelta":
            return ["accum_g2", "accum_dx"]
        if m == "adam":
            return ["m", "v"]
        if m == "adamax":
            return ["m", "u"]
        raise ValueError(f"unknown learning_method {m!r}")

    def init_state(self, params: Params) -> UpdaterState:
        slots = {}
        for name, p in params.items():
            cfg = self.param_configs.get(name)
            if cfg is not None and cfg.is_static:
                slots[name] = {}
                continue
            slots[name] = {s: torch.zeros_like(p) for s in self._slot_names()}
        zeros = (lambda: {k: torch.zeros_like(v) for k, v in params.items()})
        return UpdaterState(
            step=0, num_samples=0.0, slots=slots,
            avg_sum=zeros() if self.averaging else None, avg_count=0.0,
            avg_old_sum=zeros() if self.averaging else None, avg_old_count=0.0)

    # ------------------------------------------------------------- update

    def __call__(self, params: Params, grads: Params, state: UpdaterState,
                 batch_size) -> Tuple[Params, UpdaterState]:
        opt = self.opt
        t = state.step + 1
        num_samples = float(_f32(state.num_samples) + _f32(batch_size))
        base_lr = learning_rate_at(opt, num_samples)
        new_params: Params = {}
        new_slots: Dict[str, Dict[str, Tensor]] = {}
        for name, w in params.items():
            cfg = self.param_configs.get(name)
            if cfg is None or cfg.is_static or name not in grads:
                new_params[name] = w
                new_slots[name] = state.slots.get(name, {})
                continue
            g = grads[name]
            clip = cfg.gradient_clipping_threshold or opt.gradient_clipping_threshold
            lr = float(_f32(base_lr) * _f32(cfg.learning_rate if cfg.learning_rate else 1.0))
            if cfg.sparse_update and g.dim() >= 2:
                raise NotImplementedError(
                    f"parameter {name!r}: sparse_update (row-sparse updates) is not "
                    "ported yet")
            if clip and clip > 0:
                g = g.clamp(-clip, clip)
            # L2 regularization folds decay into the gradient (the reference's
            # OptimizerWithRegularizer)
            if cfg.decay_rate:
                g = g + cfg.decay_rate * w
            w2, slots2 = self._apply_method(cfg, w, g, state.slots[name], lr, t)
            # L1 regularization: proximal soft-threshold after the step
            if cfg.decay_rate_l1:
                thresh = float(_f32(lr) * _f32(cfg.decay_rate_l1))
                w2 = torch.sign(w2) * torch.clamp(torch.abs(w2) - thresh, min=0.0)
            new_params[name] = w2
            new_slots[name] = slots2
        avg_sum, avg_count = state.avg_sum, state.avg_count
        avg_old_sum, avg_old_count = state.avg_old_sum, state.avg_old_count
        if self.averaging:
            cur = {k: avg_sum[k] + new_params[k] for k in new_params}
            n_acc = avg_count + 1.0
            # close the window once it has grown past the configured span
            # (isAverageWindowTooLong): the full window becomes the "old"
            # bucket and a fresh one starts accumulating
            limit = min(self.max_window, float(_f32(t) * _f32(self.avg_frac)))
            if n_acc >= self.min_window and n_acc >= limit:
                avg_old_sum, avg_old_count = cur, n_acc
                avg_sum, avg_count = {k: torch.zeros_like(v) for k, v in cur.items()}, 0.0
            else:
                avg_sum, avg_count = cur, n_acc
        return new_params, UpdaterState(t, num_samples, new_slots, avg_sum, avg_count,
                                        avg_old_sum, avg_old_count)

    def _apply_method(self, cfg, w, g, slots, lr, t):
        m = self.method
        opt = self.opt
        eps = opt.ada_epsilon
        rou = opt.ada_rou
        if m in ("momentum", "sparse_momentum", "sgd"):
            v = cfg.momentum * slots["mom"] - lr * g
            return w + v, {"mom": v}
        if m == "adagrad":
            accum = slots["accum"] + g * g
            return w - lr * g / (torch.sqrt(accum) + eps), {"accum": accum}
        if m == "decayed_adagrad":
            accum = rou * slots["accum"] + (1.0 - rou) * g * g
            return w - lr * g / torch.sqrt(accum + eps), {"accum": accum}
        if m == "rmsprop":
            g2 = rou * slots["accum_g2"] + (1.0 - rou) * g * g
            g1 = rou * slots["accum_g"] + (1.0 - rou) * g
            return (w - lr * g / torch.sqrt(g2 - g1 * g1 + eps),
                    {"accum_g2": g2, "accum_g": g1})
        if m == "adadelta":
            g2 = rou * slots["accum_g2"] + (1.0 - rou) * g * g
            dx = -torch.sqrt((slots["accum_dx"] + eps) / (g2 + eps)) * g
            accum_dx = rou * slots["accum_dx"] + (1.0 - rou) * dx * dx
            return w + lr * dx, {"accum_g2": g2, "accum_dx": accum_dx}
        if m == "adam":
            b1, b2 = opt.adam_beta1, opt.adam_beta2
            mt = b1 * slots["m"] + (1.0 - b1) * g
            vt = b2 * slots["v"] + (1.0 - b2) * g * g
            mhat = mt / float(_f32(1.0) - np.power(_f32(b1), _f32(t)))
            vhat = vt / float(_f32(1.0) - np.power(_f32(b2), _f32(t)))
            return w - lr * mhat / (torch.sqrt(vhat) + opt.adam_epsilon), {"m": mt, "v": vt}
        if m == "adamax":
            b1, b2 = opt.adam_beta1, opt.adam_beta2
            mt = b1 * slots["m"] + (1.0 - b1) * g
            ut = torch.maximum(b2 * slots["u"], torch.abs(g))
            step = float(_f32(lr) / (_f32(1.0) - np.power(_f32(b1), _f32(t))))
            return w - step * mt / (ut + 1e-12), {"m": mt, "u": ut}
        raise ValueError(f"unknown learning_method {m!r}")

    # ----------------------------------------------------------- averaging

    def averaged_params(self, params: Params, state: UpdaterState) -> Params:
        """The averaged parameters (AverageOptimizer apply()):
        (sum + old_sum) / (count + old_count)."""
        if not self.averaging or state.avg_sum is None:
            return params
        old_sum = state.avg_old_sum
        count = max(state.avg_count + (state.avg_old_count or 0.0), 1.0)
        return {k: (state.avg_sum[k] + (old_sum[k] if old_sum is not None else 0.0)) / count
                for k in params}
