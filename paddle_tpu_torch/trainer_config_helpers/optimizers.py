"""settings() and optimizer/regularization DSL objects.

API-compatible with /root/reference/python/paddle/trainer_config_helpers/
optimizers.py:73-338. Each optimizer maps to a learning_method name
implemented in paddle_tpu_torch.optimizer; regularization/model-average/clipping
fold into OptimizationConfig and per-parameter defaults.
"""

from __future__ import annotations

from typing import Optional

from paddle_tpu_torch.config.builder import current_context

__all__ = [
    "Optimizer",
    "BaseSGDOptimizer",
    "MomentumOptimizer",
    "AdamOptimizer",
    "AdamaxOptimizer",
    "AdaGradOptimizer",
    "RMSPropOptimizer",
    "DecayedAdaGradOptimizer",
    "AdaDeltaOptimizer",
    "LBFGSOptimizer",
    "OWLQNOptimizer",
    "BaseRegularization",
    "L1Regularization",
    "L2Regularization",
    "ModelAverage",
    "GradientClippingThreshold",
    "settings",
]


class Optimizer:
    def to_settings(self, s: dict, defaults: dict) -> None:
        raise NotImplementedError


class BaseSGDOptimizer(Optimizer):
    pass


class MomentumOptimizer(BaseSGDOptimizer):
    def __init__(self, momentum: float = 0.0, sparse: bool = False):
        self.momentum = momentum
        self.sparse = sparse

    def to_settings(self, s, defaults):
        s["learning_method"] = "sparse_momentum" if self.sparse else "momentum"
        defaults["momentum"] = self.momentum


class AdamOptimizer(BaseSGDOptimizer):
    def __init__(self, beta1: float = 0.9, beta2: float = 0.999, epsilon: float = 1e-8):
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def to_settings(self, s, defaults):
        s["learning_method"] = "adam"
        s["adam_beta1"] = self.beta1
        s["adam_beta2"] = self.beta2
        s["adam_epsilon"] = self.epsilon


class AdamaxOptimizer(BaseSGDOptimizer):
    def __init__(self, beta1: float = 0.9, beta2: float = 0.999):
        self.beta1, self.beta2 = beta1, beta2

    def to_settings(self, s, defaults):
        s["learning_method"] = "adamax"
        s["adam_beta1"] = self.beta1
        s["adam_beta2"] = self.beta2


class AdaGradOptimizer(BaseSGDOptimizer):
    def to_settings(self, s, defaults):
        s["learning_method"] = "adagrad"


class RMSPropOptimizer(BaseSGDOptimizer):
    def __init__(self, rho: float = 0.95, epsilon: float = 1e-6):
        self.rho, self.epsilon = rho, epsilon

    def to_settings(self, s, defaults):
        s["learning_method"] = "rmsprop"
        s["ada_rou"] = self.rho
        s["ada_epsilon"] = self.epsilon


class DecayedAdaGradOptimizer(BaseSGDOptimizer):
    def __init__(self, rho: float = 0.95, epsilon: float = 1e-6):
        self.rho, self.epsilon = rho, epsilon

    def to_settings(self, s, defaults):
        s["learning_method"] = "decayed_adagrad"
        s["ada_rou"] = self.rho
        s["ada_epsilon"] = self.epsilon


class AdaDeltaOptimizer(BaseSGDOptimizer):
    def __init__(self, rho: float = 0.95, epsilon: float = 1e-6):
        self.rho, self.epsilon = rho, epsilon

    def to_settings(self, s, defaults):
        s["learning_method"] = "adadelta"
        s["ada_rou"] = self.rho
        s["ada_epsilon"] = self.epsilon


class LBFGSOptimizer(Optimizer):
    """Whole-data L-BFGS: one line-searched quasi-Newton update per pass
    (the reference's batch-algorithm mode, Trainer::trainOnePassBatch —
    selected there by any non-SGD learning method, algorithm='owlqn').
    Hyperparameter names follow reference config_parser.py settings
    (c1/backoff/owlqn_steps/max_backoff)."""

    learning_method = "lbfgs"

    def __init__(self, history: int = 10, c1: float = 1e-4, backoff: float = 0.5,
                 max_backoff: int = 5):
        self.history, self.c1 = history, c1
        self.backoff, self.max_backoff = backoff, max_backoff

    def to_settings(self, s, defaults):
        s["algorithm"] = "owlqn"
        s["learning_method"] = self.learning_method
        s["owlqn_steps"] = self.history
        s["c1"] = self.c1
        s["backoff"] = self.backoff
        s["max_backoff"] = self.max_backoff


class OWLQNOptimizer(LBFGSOptimizer):
    """L-BFGS with L1 regularization (orthant-wise limited-memory
    quasi-Newton). Pair with L1Regularization(rate) — under
    algorithm='owlqn' the rate becomes OptimizationConfig.l1weight
    (reference optimizers.py:288 maps regularization the same way)."""

    learning_method = "owlqn"


class BaseRegularization(Optimizer):
    def to_settings(self, s, defaults):
        pass


class L2Regularization(BaseRegularization):
    def __init__(self, rate: float):
        self.rate = rate

    def to_settings(self, s, defaults):
        if s.get("algorithm") == "owlqn":
            # batch methods fold l2 into the objective (reference
            # optimizers.py:288-291 maps the rate to l2weight)
            s["l2weight"] = self.rate
            return
        # sgd path: becomes the per-parameter default decay_rate
        # (reference: default_decay_rate(rate))
        defaults["decay_rate"] = self.rate


class L1Regularization(BaseRegularization):
    def __init__(self, rate: float):
        self.rate = rate

    def to_settings(self, s, defaults):
        if s.get("algorithm") == "owlqn":
            s["l1weight"] = self.rate
            return
        defaults["decay_rate_l1"] = self.rate


class ModelAverage(Optimizer):
    def __init__(self, average_window, max_average_window=None, do_average_in_cpu=False):
        self.average_window = average_window
        self.max_average_window = max_average_window
        self.do_average_in_cpu = do_average_in_cpu

    def to_settings(self, s, defaults):
        s["average_window"] = self.average_window
        if self.max_average_window is not None:
            s["max_average_window"] = self.max_average_window
        s["do_average_in_cpu"] = self.do_average_in_cpu


class GradientClippingThreshold(Optimizer):
    def __init__(self, threshold: float):
        self.threshold = threshold

    def to_settings(self, s, defaults):
        s["gradient_clipping_threshold"] = self.threshold
        defaults["gradient_clipping_threshold"] = self.threshold


def settings(
    batch_size,
    learning_rate: float = 1e-3,
    learning_method: Optional[Optimizer] = None,
    regularization: Optional[BaseRegularization] = None,
    is_async: bool = False,
    async_lagged_grad_discard_ratio: Optional[float] = None,
    model_average: Optional[ModelAverage] = None,
    gradient_clipping_threshold: Optional[float] = None,
    learning_rate_decay_a: float = 0.0,
    learning_rate_decay_b: float = 0.0,
    learning_rate_schedule: Optional[str] = None,
    learning_rate_args: str = "",
    # TPU extensions
    dtype: Optional[str] = None,
    mesh_shape: Optional[str] = None,
    remat: Optional[str] = None,
    scan_unroll: Optional[int] = None,
    num_batches_per_send_parameter: Optional[int] = None,
    batches_per_launch: Optional[int] = None,
    pallas_rnn: Optional[bool] = None,
    pallas_flat: Optional[bool] = None,
    conv_s2d: Optional[bool] = None,
    conv_stats_mode: Optional[str] = None,
    pallas_decoder: Optional[bool] = None,
):
    ctx = current_context()
    s, defaults = ctx.settings, ctx.defaults
    s["batch_size"] = batch_size
    s["learning_rate"] = learning_rate
    if learning_method is None:
        learning_method = MomentumOptimizer()
    assert isinstance(learning_method, Optimizer)
    s["algorithm"] = "async_sgd" if is_async else "sgd"
    if async_lagged_grad_discard_ratio is not None:
        # async mode's staleness gate (here: replica drift gate at the
        # merge — paddle_tpu/parallel/local_sgd.py)
        s["async_lagged_grad_discard_ratio"] = async_lagged_grad_discard_ratio
    learning_method.to_settings(s, defaults)
    if regularization is not None:
        regs = regularization if isinstance(regularization, (list, tuple)) else [regularization]
        for r in regs:
            r.to_settings(s, defaults)
    if model_average is not None:
        model_average.to_settings(s, defaults)
    if gradient_clipping_threshold is not None:
        GradientClippingThreshold(gradient_clipping_threshold).to_settings(s, defaults)
    s["learning_rate_decay_a"] = learning_rate_decay_a
    s["learning_rate_decay_b"] = learning_rate_decay_b
    if learning_rate_schedule is not None:
        s["learning_rate_schedule"] = learning_rate_schedule
    if learning_rate_args:
        s["learning_rate_args"] = learning_rate_args
    if dtype is not None:
        s["dtype"] = dtype
    if remat is not None:
        s["remat"] = remat
    if scan_unroll is not None:
        s["scan_unroll"] = scan_unroll
    if batches_per_launch is not None:
        s["batches_per_launch"] = batches_per_launch
    if pallas_rnn is not None:
        s["pallas_rnn"] = pallas_rnn
    if pallas_flat is not None:
        # transpose-free pallas_rnn interface (batch-major [B, T*width]
        # reads instead of a materialized time-major swap)
        s["pallas_flat"] = pallas_flat
    if conv_s2d is not None:
        s["conv_s2d"] = conv_s2d
    if conv_stats_mode is not None:
        # fused 1x1-conv + BN statistics: "gram" | "pallas" | ""
        s["conv_stats_mode"] = conv_stats_mode
    if pallas_decoder is not None:
        s["pallas_decoder"] = pallas_decoder
    if num_batches_per_send_parameter is not None:
        # gradient accumulation: N batches per optimizer update
        s["num_batches_per_send_parameter"] = num_batches_per_send_parameter
    if mesh_shape is not None:
        s["mesh_shape"] = mesh_shape


# ------------------------------------------------- global init defaults
# (reference config_parser.py:55-60: default_initial_std / default_initial_mean
#  / default_initial_strategy / default_initial_smart / default_decay_rate /
#  default_momentum set g_default_* consumed by every later Parameter())


def _set_default(key, val):
    from paddle_tpu_torch.config.builder import current_context

    current_context().defaults[key] = val


def default_initial_std(val: float) -> None:
    _set_default("initial_std", val)


def default_initial_mean(val: float) -> None:
    _set_default("initial_mean", val)


def default_initial_strategy(val: int) -> None:
    _set_default("initial_strategy", val)


def default_initial_smart(val: bool) -> None:
    _set_default("initial_smart", val)


def default_decay_rate(val: float) -> None:
    _set_default("decay_rate", val)


def default_momentum(val: float) -> None:
    _set_default("momentum", val)


def default_gradient_clipping_threshold(val: float) -> None:
    _set_default("gradient_clipping_threshold", val)


__all__ += [
    "default_initial_std",
    "default_initial_mean",
    "default_initial_strategy",
    "default_initial_smart",
    "default_decay_rate",
    "default_momentum",
    "default_gradient_clipping_threshold",
]
