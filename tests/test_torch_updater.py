"""The port's Updater against the JAX package's, on the CPU.

Each of the seven learning methods takes 3 updates of the same parameters
with the same gradients in both packages, with gradient clipping, L2 and
L1 decay, a per-parameter learning-rate scale, a static parameter and
sliding-window parameter averaging switched on. Tolerance rtol 1e-6 /
atol 1e-7: both compute the same float32 arithmetic elementwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.optimizer import Updater as JaxUpdater
from paddle_tpu.optimizer.updater import UpdaterState as JaxUpdaterState
from paddle_tpu.proto import ModelConfig as JaxModelConfig
from paddle_tpu.proto import OptimizationConfig as JaxOptimizationConfig
from paddle_tpu.proto import ParameterConfig as JaxParameterConfig
from paddle_tpu_torch.bridge import opt_state_from_numpy, opt_state_to_numpy
from paddle_tpu_torch.optimizer import Updater, learning_rate_at
from paddle_tpu_torch.proto import ModelConfig, OptimizationConfig, ParameterConfig

torch.set_num_threads(1)
TOL = dict(rtol=1e-6, atol=1e-7)
METHODS = ("momentum", "adagrad", "decayed_adagrad", "rmsprop", "adadelta", "adam", "adamax")


def _configs(proto, method):
    model_cls, opt_cls, param_cls = proto
    m = model_cls()
    m.parameters.append(param_cls(name="w", size=12, dims=[3, 4], momentum=0.9,
                                  decay_rate=0.01, decay_rate_l1=0.001,
                                  gradient_clipping_threshold=0.5, learning_rate=2.0))
    m.parameters.append(param_cls(name="b", size=4, dims=[4]))
    m.parameters.append(param_cls(name="frozen", size=4, dims=[4], is_static=True))
    opt = opt_cls(learning_rate=0.05, learning_method=method, learning_rate_schedule="poly",
                  learning_rate_decay_a=0.1, learning_rate_decay_b=0.5, batch_size=2,
                  gradient_clipping_threshold=1.0, average_window=0.5,
                  max_average_window=2)
    return opt, m


def _draws(seed):
    rng = np.random.RandomState(seed)
    params = {"w": rng.randn(3, 4), "b": rng.randn(4), "frozen": rng.randn(4)}
    grads = [{"w": rng.randn(3, 4) * 2, "b": rng.randn(4), "frozen": rng.randn(4)}
             for _ in range(3)]
    f32 = lambda d: {k: np.asarray(v, np.float32) for k, v in d.items()}
    return f32(params), [f32(g) for g in grads]


@pytest.mark.parametrize("method", METHODS)
def test_three_updates_match_the_jax_updater(method):
    params, grads = _draws(METHODS.index(method))
    jupd = JaxUpdater(*_configs((JaxModelConfig, JaxOptimizationConfig, JaxParameterConfig),
                                method))
    upd = Updater(*_configs((ModelConfig, OptimizationConfig, ParameterConfig), method))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jupd.init_state(jp), upd.init_state(tp)
    for g in grads:
        jp, js = jupd(jp, {k: jnp.asarray(v) for k, v in g.items()}, js, 2.0)
        tp, ts = upd(tp, {k: torch.from_numpy(v) for k, v in g.items()}, ts, 2)
        for k in sorted(params):
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), err_msg=k, **TOL)
    np.testing.assert_array_equal(tp["frozen"].numpy(), params["frozen"])
    assert ts.step == int(js.step) == 3
    assert ts.avg_count == float(js.avg_count) and ts.avg_old_count == float(js.avg_old_count)
    jslots = {k: {s: np.asarray(v) for s, v in d.items()} for k, d in js.slots.items()}
    for k, slots in ts.slots.items():
        assert sorted(slots) == sorted(jslots[k])
        for s, v in slots.items():
            np.testing.assert_allclose(v.numpy(), jslots[k][s], err_msg=f"{k}/{s}", **TOL)
    javg = jupd.averaged_params(jp, js)
    for k, v in upd.averaged_params(tp, ts).items():
        np.testing.assert_allclose(v.numpy(), np.asarray(javg[k]), err_msg=k, **TOL)


def test_state_crosses_over_both_ways():
    """A JAX UpdaterState carried into the port and back, then one more
    update in each package from the carried state."""
    params, grads = _draws(11)
    jupd = JaxUpdater(*_configs((JaxModelConfig, JaxOptimizationConfig, JaxParameterConfig),
                                "adam"))
    upd = Updater(*_configs((ModelConfig, OptimizationConfig, ParameterConfig), "adam"))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jupd.init_state(jp)
    for g in grads[:2]:
        jp, js = jupd(jp, {k: jnp.asarray(v) for k, v in g.items()}, js, 2.0)
    ts = opt_state_from_numpy(js, "cpu")
    back = opt_state_to_numpy(ts)
    js2 = JaxUpdaterState(**{k: (v if not isinstance(v, dict) else
                                 {p: ({s: jnp.asarray(a) for s, a in d.items()}
                                      if isinstance(d, dict) else jnp.asarray(d))
                                  for p, d in v.items()})
                             for k, v in back.items()})
    assert back["step"].dtype == np.int32 and int(back["step"]) == 2
    tp = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in jp.items()}
    g = grads[2]
    jp, js = jupd(jp, {k: jnp.asarray(v) for k, v in g.items()}, js2, 2.0)
    tp, ts = upd(tp, {k: torch.from_numpy(v) for k, v in g.items()}, ts, 2)
    for k in sorted(params):
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), err_msg=k, **TOL)


@pytest.mark.parametrize("sched,args", [
    ("constant", {}), ("poly", dict(learning_rate_decay_a=0.1, learning_rate_decay_b=0.5)),
    ("exp", dict(learning_rate_decay_a=0.5, learning_rate_decay_b=100.0)),
    ("discexp", dict(learning_rate_decay_a=0.5, learning_rate_decay_b=30.0)),
    ("linear", dict(learning_rate_decay_a=1e-4, learning_rate_decay_b=0.01)),
    ("caffe_poly", dict(learning_rate_decay_a=1000.0, learning_rate_decay_b=2.0)),
    ("manual", dict(learning_rate_args="50:0.1,120:0.01,1000:0.001")),
])
def test_learning_rate_schedules_match(sched, args):
    from paddle_tpu.optimizer.schedules import learning_rate_at as jax_lr

    for n in (0.0, 10.0, 64.0, 128.0, 500.0):
        jopt = JaxOptimizationConfig(learning_rate=0.1, learning_rate_schedule=sched, **args)
        opt = OptimizationConfig(learning_rate=0.1, learning_rate_schedule=sched, **args)
        np.testing.assert_allclose(learning_rate_at(opt, n),
                                   float(jax_lr(jopt, jnp.float32(n))), rtol=1e-6)


def test_what_is_not_ported_raises(tmp_path):
    """The two refusals this test once held, a ``sparse_update`` table and
    a pruning hook, are ported: the same table and hook take one update as
    the JAX updater does (the table's row scan, its t_last slot; the
    masked weight's values and gradient)."""
    from paddle_tpu.proto import ParameterUpdaterHookConfig as JaxHook
    from paddle_tpu_torch.optimizer.hooks import write_mask_file
    from paddle_tpu_torch.proto import ParameterUpdaterHookConfig

    mask = np.array([[1, 0], [0, 1], [1, 1]], np.float32)
    write_mask_file(str(tmp_path / "w.mask"), mask)

    def configs(model_cls, opt_cls, param_cls, hook_cls):
        m = model_cls()
        m.parameters.append(param_cls(name="t", size=6, dims=[3, 2], sparse_update=True,
                                      decay_rate=0.01))
        m.parameters.append(param_cls(name="w", size=6, dims=[3, 2], update_hooks=[
            hook_cls(type="pruning", purning_mask_filename="w.mask")]))
        return opt_cls(learning_method="adam", learning_rate=0.1), m

    rng = np.random.RandomState(4)
    p = {k: rng.randn(3, 2).astype(np.float32) for k in ("t", "w")}
    g = {k: rng.randn(3, 2).astype(np.float32) for k in ("t", "w")}
    g["t"][1] = 0.0                                 # an untouched row
    jupd = JaxUpdater(*configs(JaxModelConfig, JaxOptimizationConfig, JaxParameterConfig,
                               JaxHook), init_model_path=str(tmp_path))
    upd = Updater(*configs(ModelConfig, OptimizationConfig, ParameterConfig,
                           ParameterUpdaterHookConfig), init_model_path=str(tmp_path))
    jp = jupd.apply_init_hooks({k: jnp.asarray(v) for k, v in p.items()})
    tp = upd.apply_init_hooks({k: torch.from_numpy(v.copy()) for k, v in p.items()})
    jp, js = jupd(jp, {k: jnp.asarray(v) for k, v in g.items()}, jupd.init_state(jp), 1)
    tp, ts = upd(tp, {k: torch.from_numpy(v) for k, v in g.items()}, upd.init_state(tp), 1)
    for k in p:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), err_msg=k, **TOL)
    assert ts.slots["t"]["t_last"].dtype == torch.int32
    np.testing.assert_array_equal(ts.slots["t"]["t_last"].numpy(),
                                  np.asarray(js.slots["t"]["t_last"]))
    assert (tp["w"].numpy()[mask == 0] == 0).all()
