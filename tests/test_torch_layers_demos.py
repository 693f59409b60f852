"""The demos the layer library's tail unblocks, against the JAX package on
the CPU.

- quick_start's text CNN (``trainer_config.cnn.py``: the ``context``
  projection, ``sequence_conv_pool``) trains one pass through both
  packages' ``paddle train`` from the same start, the JAX package's
  ``init_params(seed=1)`` written as a checkpoint: the test pass's cost and
  error within 1e-5 relative. Its ``is_predict=1`` config (``maxid``)
  forwards the first test batch at the JAX package's pass through both
  ``GradientMachine``s: the same ids wherever the top-2 margin exceeds
  1e-5;
- the model_zoo embedding demo (``hsigmoid``), the recommendation demo
  (``context``, ``cos``, ``square_error``; its ``sparse_update`` matters
  only to the updater, ROADMAP Queue 1 item 6) and the sentiment demo's
  ``bidirectional_lstm_net`` (``first_seq``): the first batch's loss
  within 1e-5 relative and every gradient within 1e-4 of max(1, max |JAX
  gradient|), through both ``GradientMachine``s, dropout off.
"""

import contextlib
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from test_torch_cli import QUIET, _run
from test_torch_layers_library import GRAD_TOL, _close
import paddle_tpu.graph  # noqa: F401
from paddle_tpu.config import parse_config_at as jax_parse_config_at
from paddle_tpu.graph import GradientMachine as JaxMachine
from paddle_tpu.graph.argument import Argument as JArg
from paddle_tpu_torch.bridge import params_from_numpy
from paddle_tpu_torch.config import parse_config_at
from paddle_tpu_torch.data.feeder import create_data_provider
from paddle_tpu_torch.graph import GradientMachine
from paddle_tpu_torch.trainer import checkpoint as ckpt

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def _cwd(path):
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


def _workspace(ws, demo, names, train="train-seed-1", test="test-seed-1"):
    for name in names:
        shutil.copy(os.path.join(REPO, "demo", demo, name), ws)
    (ws / "train.list").write_text(f"{train}\n")
    (ws / "test.list").write_text(f"{test}\n")
    return str(ws)


def test_quick_start_cnn_trains_and_predicts_as_the_jax_command_line(tmp_path):
    ws = _workspace(tmp_path, "quick_start",
                    ("common.py", "dataprovider_emb.py", "trainer_config.cnn.py"))
    jcfg = jax_parse_config_at(os.path.join(ws, "trainer_config.cnn.py"), "")
    assert "context" in {ic.proj_conf.type for l in jcfg.model_config.layers
                         for ic in l.inputs if ic.proj_conf}
    params = JaxMachine(jcfg.model_config).init_params(seed=1)
    init = ckpt.save_checkpoint(os.path.join(ws, "init"), 0,
                                params_from_numpy({k: np.asarray(v) for k, v in params.items()},
                                                  "cpu"))
    tests = {who: _run(who, ["train", "--config=trainer_config.cnn.py", "--num_passes=1",
                             f"--init_model_path={init}", f"--save_dir={who}"] + QUIET, ws)
             for who in ("jax", "port")}
    assert len(tests["port"]) == len(tests["jax"]) == 1
    assert sorted(tests["port"][0]) == sorted(tests["jax"][0])
    for key, want in tests["jax"][0].items():
        np.testing.assert_allclose(tests["port"][0][key], want, rtol=1e-5, err_msg=key)
    assert tests["port"][0]["cost"] < 0.69                    # below chance after one pass

    # is_predict=1 (maxid) forward from the JAX package's pass, on the
    # first test batch: the ids where the top-2 margin leaves no tie
    with np.load(os.path.join(ws, "jax", "pass-00000", "params.npz")) as z:
        trained = {k: z[k] for k in z.files}
    with _cwd(ws):
        jpred = jax_parse_config_at(os.path.join(ws, "trainer_config.cnn.py"), "is_predict=1")
        pred = parse_config_at(os.path.join(ws, "trainer_config.cnn.py"), "is_predict=1")
        cfg = parse_config_at(os.path.join(ws, "trainer_config.cnn.py"), "")
        dp = create_data_provider(cfg.test_data_config, cfg.opt_config.batch_size,
                                  cfg.model_config.input_layer_names, async_prefetch=False,
                                  seed=1, for_test=True)
        batch = {"word": next(iter(dp.batches()))["word"]}
    assert pred.model_config.to_json() == jpred.model_config.to_json()
    (name,) = pred.model_config.output_layer_names
    jm = JaxMachine(jpred.model_config)
    jouts, _ = jm.forward({k: jax.numpy.asarray(v) for k, v in trained.items()},
                          {"word": _jax_arg(batch["word"])})
    outs, _ = GradientMachine(pred.model_config, device="cpu").forward(
        params_from_numpy(trained, "cpu"), batch, seed=1)
    probs = np.sort(np.asarray(jouts[pred.model_config.layers[-1].inputs[0].input_layer_name]
                               .value), axis=-1)
    clear = probs[:, -1] - probs[:, -2] > 1e-5
    got, want = outs[name].ids.numpy(), np.asarray(jouts[name].ids)
    assert got.shape == want.shape == (128,) and clear.sum() > 100
    assert np.array_equal(got[clear], want[clear])
    assert 0 < want.sum() < 128                               # both classes predicted


def _jax_arg(arg):
    get = lambda f: None if getattr(arg, f) is None else jax.numpy.asarray(  # noqa: E731
        getattr(arg, f).numpy())
    return JArg(value=get("value"), ids=get("ids"), seq_lengths=get("seq_lengths"),
                sub_seq_lengths=get("sub_seq_lengths"))


def _first_batch_parity(ws, config, config_args="", seed=1):
    """Both packages parse the demo config to the same model; from the JAX
    package's init_params both machines take the first batch of the port's
    feeder: the loss and every gradient."""
    with _cwd(ws):
        jcfg = jax_parse_config_at(os.path.join(ws, config), config_args)
        cfg = parse_config_at(os.path.join(ws, config), config_args)
        assert cfg.model_config.to_json() == jcfg.model_config.to_json()
        # seeded dropout stays off: torch cannot draw jax's bits
        for layer in list(cfg.model_config.layers) + list(jcfg.model_config.layers):
            layer.drop_rate = 0.0
        dp = create_data_provider(cfg.data_config, cfg.opt_config.batch_size,
                                  cfg.model_config.input_layer_names, async_prefetch=False,
                                  seed=1)
        batch = next(iter(dp.batches()))
    jm = JaxMachine(jcfg.model_config)
    jparams = jm.init_params(seed=seed)
    jloss, jgrads, _, _ = jax.jit(jm.grad_fn(sparse=False))(
        jparams, {k: _jax_arg(a) for k, a in batch.items()}, jax.random.PRNGKey(0))
    pm = GradientMachine(cfg.model_config, device="cpu")
    loss, grads, _, _ = pm.grad_fn(sparse=False)(
        params_from_numpy({k: np.asarray(v) for k, v in jparams.items()}, "cpu"), batch,
        seed=1)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert sorted(grads) == sorted(jgrads)
    for name in jgrads:
        _close(grads[name].numpy(), np.asarray(jgrads[name]), GRAD_TOL, f"grad {name}")
    return cfg, float(loss)


def test_embedding_demo_first_batch_matches(tmp_path):
    ws = _workspace(tmp_path, "model_zoo/embedding", ("common.py", "dataprovider.py",
                                                       "trainer_config.py"),
                    train="corpus-seed-1", test="corpus-seed-2")
    cfg, loss = _first_batch_parity(ws, "trainer_config.py", "dim=16")
    assert "hsigmoid" in {l.type for l in cfg.model_config.layers}
    assert np.isfinite(loss)


def test_recommendation_forward_and_gradients_match(tmp_path):
    ws = _workspace(tmp_path, "recommendation", ("common.py", "dataprovider.py",
                                                 "trainer_config.py"),
                    train="seed1", test="seed2")
    cfg, _ = _first_batch_parity(ws, "trainer_config.py")
    types = {l.type for l in cfg.model_config.layers}
    assert {"cos", "square_error"} <= types
    assert any(p.sparse_update for p in cfg.model_config.parameters)


@pytest.mark.parametrize("net", ["bidirectional_lstm_net"])
def test_sentiment_bidirectional_lstm_matches(net, tmp_path):
    ws = _workspace(tmp_path, "sentiment", ("common.py", "dataprovider.py", "sentiment_net.py"))
    (tmp_path / "bi_config.py").write_text(
        "from paddle.trainer_config_helpers import *\n"
        "from sentiment_net import *\n"
        "dict_dim, class_dim = sentiment_data()\n"
        "settings(batch_size=16, learning_rate=2e-3, learning_method=AdamOptimizer())\n"
        f"{net}(dict_dim, class_dim, emb_dim=16, lstm_dim=16)\n")
    cfg, _ = _first_batch_parity(ws, "bi_config.py")
    last = [l for l in cfg.model_config.layers if l.type == "seqlastins"]
    assert any(l.select_first for l in last) and any(not l.select_first for l in last)
