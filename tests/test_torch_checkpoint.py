"""The port's single-host checkpoint format against the JAX package's.

A ``pass-00000`` written by the JAX package's ``save_checkpoint`` loads in
the port, and one written by the port loads in the JAX package's
``load_checkpoint``, with ``MANIFEST.json`` verifying either way. Values
are exact: both write and read the same float32 arrays.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.optimizer import Updater as JaxUpdater
from paddle_tpu.proto import ModelConfig as JaxModelConfig
from paddle_tpu.proto import OptimizationConfig as JaxOptimizationConfig
from paddle_tpu.proto import ParameterConfig as JaxParameterConfig
from paddle_tpu.resilience import manifest as jax_manifest
from paddle_tpu.trainer import checkpoint as jax_ckpt
from paddle_tpu_torch.optimizer import Updater
from paddle_tpu_torch.proto import ModelConfig, OptimizationConfig, ParameterConfig
from paddle_tpu_torch.resilience import CheckpointCorruptError
from paddle_tpu_torch.resilience import manifest
from paddle_tpu_torch.trainer import checkpoint as ckpt


def _configs(proto):
    model_cls, opt_cls, param_cls = proto
    m = model_cls()
    m.parameters.append(param_cls(name="w", size=6, dims=[2, 3]))
    m.parameters.append(param_cls(name="b", size=3, dims=[3]))
    m.parameters.append(param_cls(name="frozen", size=3, dims=[3], is_static=True))
    opt = opt_cls(learning_rate=0.1, learning_method="adam", average_window=0.5,
                  max_average_window=4)
    return opt, m


def _params(seed):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(2, 3).astype(np.float32), "b": rng.randn(3).astype(np.float32),
            "frozen": rng.randn(3).astype(np.float32)}


def _grads(seed):
    rng = np.random.RandomState(seed + 100)
    return {k: rng.randn(*v.shape).astype(np.float32) for k, v in _params(seed).items()}


def _assert_state_equal(params, state, jparams, jstate):
    for k in jparams:
        np.testing.assert_array_equal(params[k].numpy(), np.asarray(jparams[k]), err_msg=k)
    assert state.step == int(jstate.step)
    assert state.num_samples == float(jstate.num_samples)
    assert state.avg_count == float(jstate.avg_count)
    assert state.avg_old_count == float(jstate.avg_old_count)
    for k, slots in jstate.slots.items():
        assert sorted(state.slots.get(k, {})) == sorted(slots), k
        for s, v in slots.items():
            np.testing.assert_array_equal(state.slots[k][s].numpy(), np.asarray(v))
    for a, b in ((state.avg_sum, jstate.avg_sum), (state.avg_old_sum, jstate.avg_old_sum)):
        for k in b:
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]), err_msg=k)


def test_a_jax_checkpoint_loads_in_the_port(tmp_path):
    jupd = JaxUpdater(*_configs((JaxModelConfig, JaxOptimizationConfig, JaxParameterConfig)))
    jp = {k: jnp.asarray(v) for k, v in _params(0).items()}
    js = jupd.init_state(jp)
    for s in range(3):
        jp, js = jupd(jp, {k: jnp.asarray(v) for k, v in _grads(s).items()}, js, 2.0)
    path = jax_ckpt.save_checkpoint(str(tmp_path), 0, jp, js)
    assert os.path.basename(path) == "pass-00000"
    assert manifest.verify_dir(path) == []

    upd = Updater(*_configs((ModelConfig, OptimizationConfig, ParameterConfig)))
    template = upd.init_state({k: torch.from_numpy(v) for k, v in _params(0).items()})
    params, state, meta = ckpt.load_checkpoint(path, template, device="cpu")
    assert meta["pass_id"] == 0
    _assert_state_equal(params, state, jp, js)


def test_a_port_checkpoint_loads_in_jax(tmp_path):
    upd = Updater(*_configs((ModelConfig, OptimizationConfig, ParameterConfig)))
    tp = {k: torch.from_numpy(v) for k, v in _params(1).items()}
    ts = upd.init_state(tp)
    for s in range(3):
        tp, ts = upd(tp, {k: torch.from_numpy(v) for k, v in _grads(s).items()}, ts, 2)
    path = ckpt.save_checkpoint(str(tmp_path), 0, tp, ts)
    assert sorted(os.listdir(path)) == [
        "MANIFEST.json", "meta.json", "optimizer_avg.npz", "optimizer_avg_old.npz",
        "optimizer_slots.npz", "params.npz"]
    assert jax_manifest.verify_dir(path) == []

    jupd = JaxUpdater(*_configs((JaxModelConfig, JaxOptimizationConfig, JaxParameterConfig)))
    template = jupd.init_state({k: jnp.asarray(v) for k, v in _params(1).items()})
    jparams, jstate, meta = jax_ckpt.load_checkpoint(path, template)
    assert meta["pass_id"] == 0 and meta["optimizer"]["step"] == 3
    _assert_state_equal(tp, ts, jparams, jstate)


def test_saves_are_atomic_rotate_and_verify(tmp_path):
    upd = Updater(*_configs((ModelConfig, OptimizationConfig, ParameterConfig)))
    tp = {k: torch.from_numpy(v) for k, v in _params(2).items()}
    ts = upd.init_state(tp)
    os.makedirs(tmp_path / "pass-00001.tmp")               # a crashed earlier attempt
    for p in range(5):
        ckpt.save_checkpoint(str(tmp_path), p, tp, ts, keep=3)
    ckpt.save_checkpoint(str(tmp_path), 4, tp, ts, keep=3)  # a re-save of the same pass
    assert sorted(os.listdir(tmp_path)) == ["pass-00002", "pass-00003", "pass-00004"]
    path = str(tmp_path / "pass-00004")
    with open(os.path.join(path, "meta.json")) as f:
        assert json.load(f)["optimizer"]["step"] == 0
    with open(os.path.join(path, "params.npz"), "r+b") as f:   # flip one byte
        f.seek(40)
        byte = f.read(1)
        f.seek(40)
        f.write(bytes([byte[0] ^ 0xFF]))
    with pytest.raises(CheckpointCorruptError, match="crc32"):
        ckpt.load_checkpoint(path, ts, device="cpu")
    with pytest.raises(FileNotFoundError):
        ckpt.load_checkpoint(str(tmp_path / "pass-00009"), ts, device="cpu")
