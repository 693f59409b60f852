"""Parameter updater — the reference optimizer family as one update function.

Port of ``paddle_tpu/optimizer/updater.py`` (reference
FirstOrderOptimizer.h: Sgd/momentum, Adagrad, DecayedAdagrad, RMSProp,
AdaDelta, Adam, Adamax; OptimizerWithGradientClipping; L1/L2 decay;
AverageOptimizer's windowed parameter averaging). Per-parameter
attributes honored (ParameterConfig): learning_rate scale, momentum,
decay_rate (L2), decay_rate_l1, gradient_clipping_threshold, is_static.

The update is functional, as in the JAX package, but for the indexed
sparse path below: it returns new parameter and slot tensors and leaves
its inputs untouched. Counters and scalar
rates live on the host (Python numbers), computed in float32 as the JAX
package computes them, so a step needs no device-to-host copy.

A ``sparse_update`` table takes one of two row-sparse paths, with the JAX
package's semantics (SparseRowCpuMatrix::sgdUpdate and
OptimizerWithRegularizerSparse's lazy catch-up): only the rows a batch
touches advance, and the L2 and L1 decay a row missed since its last
touch (slot ``t_last``, int32 [V]) is applied when it is touched again.
A :class:`~paddle_tpu_torch.optimizer.sparse.RowSparseGrad` goes to
``_apply_sparse_indexed``, O(N·D) in the batch's N occurrences; a dense
gradient of such a table (gradient accumulation, fused launch groups,
a table used other than through a data-fed table projection) goes to
``_apply_sparse_rows``, a functional scan over all V rows.

The indexed path updates the table and its slots **in place** (unless
``sparse_in_place`` is False): a functional copy of a 10 M-row table a
step is the O(V) cost the path exists to avoid. Its scatter is static in
shape and never reads the distinct count on the host: an entry past the
distinct rows, or a row whose summed gradient is exactly zero (padded
ids), writes the value of the first row the step does update (or, with
none, its own row's old value back), so no index is out of range and no
two entries write different values to one row, and CUDA's unordered
``index_copy_`` gives one result. While ``undo`` is a list, each in-place
write appends (tensor, rows, old values) to it: ``undo_sparse`` puts them
back, which is how the pass loop hands back the pre-step state under
``--nonfinite_policy=skip|rollback``, O(N·D) instead of a copy.

The StaticPruningHook (``optimizer/hooks.py``): a parameter with a
``pruning`` hook has its values masked once (``apply_init_hooks``, after
init or restore) and its gradient masked every step.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from paddle_tpu_torch.optimizer.schedules import learning_rate_at
from paddle_tpu_torch.optimizer.sparse import RowSparseGrad, dedupe
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
    def __init__(self, opt: OptimizationConfig, model: ModelConfig,
                 init_model_path: str = ""):
        self.opt = opt
        # the pruning masks' search root (the reference's ctor falls back
        # to --init_model_path); the trainer passes its resolved path
        self.init_model_path = init_model_path
        self.param_configs: Dict[str, ParameterConfig] = {p.name: p for p in model.parameters}
        self.method = opt.learning_method
        self.averaging = opt.average_window > 0
        # window limits (AverageOptimizer): the current window closes once
        # it holds >= min(max_average_window, numUpdates * average_window)
        # batches (and >= min_window)
        self.avg_frac = float(opt.average_window)
        self.max_window = float(opt.max_average_window)
        self.min_window = float(min(10000, opt.max_average_window))
        # StaticPruningHook: masks loaded lazily (they need the shapes)
        self._prune_files = {
            name: h.purning_mask_filename
            for name, cfg in self.param_configs.items()
            for h in cfg.update_hooks
            if h.type in ("pruning", "static_pruning")
        }
        self._masks: Dict[str, Tensor] = {}
        self.sparse_in_place = True
        self.undo: Optional[List[Tuple[Tensor, Tensor, Tensor]]] = None

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

    def _load_masks(self, params: Params) -> None:
        if not self._prune_files or self._masks:
            return
        from paddle_tpu_torch.optimizer.hooks import resolve_mask
        from paddle_tpu_torch.utils.flags import FLAGS

        root = self.init_model_path or FLAGS.init_model_path
        for name, fn in self._prune_files.items():
            cfg = self.param_configs[name]
            assert not cfg.sparse_update, (
                f"{name}: pruning hook is not supported together with "
                "sparse_update (the row-sparse gradient path)")
            p = params[name]
            mask = resolve_mask(fn, tuple(p.shape), root)
            self._masks[name] = torch.from_numpy(mask.astype(np.float32)).to(p.device, p.dtype)

    def apply_init_hooks(self, params: Params) -> Params:
        """StaticPruningHook::init: mask parameter values once at startup
        (after init or restore)."""
        self._load_masks(params)
        if not self._masks:
            return params
        return {k: (v * self._masks[k] if k in self._masks else v) for k, v in params.items()}

    def init_state(self, params: Params) -> UpdaterState:
        self._load_masks(params)
        slots = {}
        for name, p in params.items():
            cfg = self.param_configs.get(name)
            if cfg is not None and cfg.is_static:
                slots[name] = {}
                continue
            slots[name] = {s: torch.zeros_like(p) for s in self._slot_names()}
            if cfg is not None and cfg.sparse_update and p.dim() >= 2:
                # each row's last-touched step, for the lazy decay catch-up
                slots[name]["t_last"] = torch.zeros(p.shape[0], dtype=torch.int32,
                                                    device=p.device)
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
            if name in self._masks and not isinstance(g, RowSparseGrad):
                # StaticPruningHook::update: pruned weights get no gradient
                g = g * self._masks[name]
            clip = cfg.gradient_clipping_threshold or opt.gradient_clipping_threshold
            lr = float(_f32(base_lr) * _f32(cfg.learning_rate if cfg.learning_rate else 1.0))
            if isinstance(g, RowSparseGrad):
                w2, slots2 = self._apply_sparse_indexed(cfg, w, g, state.slots[name], lr, t,
                                                        clip)
                new_params[name] = w2
                new_slots[name] = slots2
                continue
            if clip and clip > 0:
                g = g.clamp(-clip, clip)
            if cfg.sparse_update and g.dim() >= 2:
                w2, slots2 = self._apply_sparse_rows(cfg, w, g, state.slots[name], lr, t)
            else:
                # L2 regularization folds decay into the gradient (the
                # reference's OptimizerWithRegularizer)
                if cfg.decay_rate:
                    g = g + cfg.decay_rate * w
                w2, slots2 = self._apply_method(cfg, w, g, state.slots[name], lr, t)
                # L1 regularization: proximal soft-threshold after the step
                if cfg.decay_rate_l1:
                    w2 = _soft_threshold(w2, float(_f32(lr) * _f32(cfg.decay_rate_l1)))
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

    def _apply_sparse_indexed(self, cfg, w, sg: RowSparseGrad, slots, lr, t, clip):
        """Row-sparse update from a RowSparseGrad, O(N·D): dedupe the
        occurrences, gather the touched rows of the table and its slots,
        catch up the decay they missed, run the method on those rows and
        write them back (in place, see the module's docstring)."""
        V, N = w.shape[0], sg.ids.shape[0]
        uid, g_rows, valid = dedupe(sg.ids, sg.rows.reshape(N, -1), V)
        # rows whose summed gradient is exactly zero (ids at padded
        # positions) stay frozen, t_last too, as in the dense row scan
        valid = valid & (g_rows != 0).any(dim=1)
        if clip and clip > 0:           # the summed gradient, as the dense path clips
            g_rows = g_rows.clamp(-clip, clip)
        uid_c = uid.clamp(max=V - 1)
        t_last = slots.get("t_last")
        inner = {k: v for k, v in slots.items() if k != "t_last"}
        w_old = w[uid_c]                                    # [N, D]
        inner_old = {k: v[uid_c] for k, v in inner.items()}
        tl_old = t_last[uid_c] if t_last is not None else torch.zeros_like(uid_c)
        elapsed = torch.clamp(t - 1 - tl_old, min=0).to(w.dtype)[:, None]
        w_rows, g = w_old, g_rows
        if cfg.decay_rate:
            w_rows = w_rows * torch.pow(float(_f32(1.0) - _f32(lr) * _f32(cfg.decay_rate)),
                                        elapsed)
            g = g + cfg.decay_rate * w_rows
        if cfg.decay_rate_l1:
            w_rows = _soft_threshold(w_rows, float(_f32(lr) * _f32(cfg.decay_rate_l1)) * elapsed)
        w2_rows, inner2_rows = self._apply_method(cfg, w_rows, g, inner_old, lr, t)
        if cfg.decay_rate_l1:
            w2_rows = _soft_threshold(w2_rows, float(_f32(lr) * _f32(cfg.decay_rate_l1)))
        # the static scatter: an entry that updates nothing takes the
        # position of the first entry that does (or of entry 0, whose old
        # value goes back), so every row written gets one value
        first = torch.argmax(valid.to(torch.uint8))
        pos = torch.where(valid, torch.arange(N, device=valid.device), first)
        idx = uid_c[pos]

        def write(dst, new_rows, old_rows):
            m = valid.reshape((N,) + (1,) * (new_rows.dim() - 1))
            vals = torch.where(m, new_rows.to(dst.dtype), old_rows)[pos]
            if not self.sparse_in_place:
                return dst.index_copy(0, idx, vals)
            if self.undo is not None:
                self.undo.append((dst, idx, old_rows[pos]))
            return dst.index_copy_(0, idx, vals)

        w_new = write(w, w2_rows, w_old)
        slots_new = {k: write(inner[k], inner2_rows[k], inner_old[k]) for k in inner}
        if t_last is not None:
            slots_new["t_last"] = write(t_last, torch.full_like(tl_old, t), tl_old)
        return w_new, slots_new

    def _apply_sparse_rows(self, cfg, w, g, slots, lr, t):
        """Row-sparse update from a dense gradient, functional and O(V):
        the rows with a nonzero gradient are the touched ones; the others
        and their slots stay as they are."""
        row_mask = (g != 0).reshape(g.shape[0], -1).any(dim=1)          # [V]
        rm = row_mask.reshape((-1,) + (1,) * (g.dim() - 1))
        t_last = slots["t_last"]
        inner = {k: v for k, v in slots.items() if k != "t_last"}
        elapsed = torch.clamp(t - 1 - t_last, min=0).to(w.dtype)         # missed batches
        w_base = w
        if cfg.decay_rate:
            # compound the missed decays, then fold the step's own into the
            # gradient as the dense path does
            decay = torch.pow(float(_f32(1.0) - _f32(lr) * _f32(cfg.decay_rate)), elapsed)
            w_base = w * torch.where(row_mask, decay, torch.ones_like(decay)).reshape(rm.shape)
            g = g + cfg.decay_rate * w_base * rm
        if cfg.decay_rate_l1:
            thresh = (float(_f32(lr) * _f32(cfg.decay_rate_l1)) * elapsed).reshape(rm.shape) * rm
            w_base = _soft_threshold(w_base, thresh)
        w2, inner2 = self._apply_method(cfg, w_base, g, inner, lr, t)
        if cfg.decay_rate_l1:
            w2 = _soft_threshold(w2, float(_f32(lr) * _f32(cfg.decay_rate_l1)))
        slots_new = {k: torch.where(rm, inner2[k], inner[k]) for k in inner}
        slots_new["t_last"] = torch.where(row_mask, torch.full_like(t_last, t), t_last)
        return torch.where(rm, w2, w), slots_new

    def undo_sparse(self, log) -> None:
        """Put back what the in-place writes recorded in ``log`` changed,
        newest first: the tables and slots hold their values from before
        the first of them again."""
        for dst, idx, old in reversed(log or ()):
            dst.index_copy_(0, idx, old)

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


def _soft_threshold(w: Tensor, thresh) -> Tensor:
    """L1's proximal step: sign(w) · max(|w| - thresh, 0)."""
    return torch.sign(w) * torch.clamp(torch.abs(w) - thresh, min=0.0)
