"""The last command-line demos through the port, on the CPU: sentiment,
vgg_16_cifar and long_context, each against the JAX package's command
line or its pinned band.

The port draws its initial parameters from a ``torch.Generator``, so for
the same ``--seed`` they are not the JAX package's (``ops/init.py``). Every
run here therefore starts from the JAX package's own first parameters
(``GradientMachine.init_params(seed=1)``, what its ``Trainer`` starts
from), written with its checkpoint writer and passed as
``--init_model_path``; from there both command lines see the same batches
in the same order.

- vgg_16_cifar ``small=1`` (the demo's own lists, 3 passes): both command
  lines train three passes, every pass's test cost within 1e-4 relative
  of the JAX package's and within +-3% of ``tests/test_quality_curves.py``'s
  ``PINNED_VGG_COST``, and ``test`` of the JAX package's ``pass-00000``
  through both within 1e-5 relative.
- sentiment: the band's 1,600 / 800 reviews take ~185 s a run on one CPU
  thread, so the full band runs on the card (``chip_smoke.py``'s ``demos``
  phase) and this test takes a cut corpus, the first 256 training and 128
  test reviews of the band's generator written as the demo's
  '<label>\\t<text>' files: both command lines train one pass (the JAX
  package's first pass; the demo's drop_rate sits on ``lstmemory``, which
  applies none in either package): the test costs within 1e-4 relative and
  the errors equal, and ``test`` of the JAX package's ``pass-00000``
  through both within 1e-5 relative.
- long_context at its laptop defaults (vocab 500, 256 tokens, width 64,
  4 heads, 2 blocks, batch 8): both command lines train one pass (no
  dropout: each test cost within 1e-4 relative), and both ``test`` the
  JAX package's ``pass-00000`` to within 1e-5 relative.

No ``compat/`` on ``PYTHONPATH``: the port's shim binds ``paddle``, and
``image_provider.py`` reaches the port's copy of ``utils/image_util``.
"""

import importlib.util
import os
import shutil
import sys

import numpy as np

from paddle_tpu.config import parse_config as jax_parse_config
from paddle_tpu.graph import GradientMachine as JaxMachine
from paddle_tpu.trainer import checkpoint as jax_ckpt
from test_quality_curves import PINNED_VGG_COST
from test_torch_cli import ERR_KEY, QUIET, REPO, _cwd, _run

SENTIMENT_CUT = (256, 128)


def _demo(tmp_path, demo, names):
    for name in names:
        shutil.copy(os.path.join(REPO, "demo", demo, name), tmp_path)
    return str(tmp_path)


def _jax_init(ws, conf, config_args=""):
    """The JAX package's first parameters for ``conf`` (its Trainer's
    init_params(seed=1)), as a pass directory under ``ws``."""
    with _cwd(ws):
        sys.path.insert(0, ws)
        try:
            cfg = jax_parse_config(conf, config_arg_str=config_args)
        finally:
            sys.path.remove(ws)
    params = JaxMachine(cfg.model_config).init_params(seed=1)
    return jax_ckpt.save_checkpoint(os.path.join(ws, "init"), 0, params)


def test_vgg_16_cifar_band_through_the_port_command_line(tmp_path, monkeypatch):
    """vgg_16_cifar small=1 from the JAX package's first parameters: three
    passes through each command line, the port's test costs within 1e-4
    relative of the JAX package's and inside the pinned +-3% band, then
    the JAX package's pass-00000 tested by both within 1e-5 relative.
    Every image the port reads is preprocessed by its copy of image_util
    (the demo's image_provider imports ``paddle_tpu.utils``, which the
    shim renames)."""
    from paddle_tpu_torch.utils import image_util

    calls = []
    preprocess = image_util.preprocess_img

    def counted(*a, **k):
        calls.append(1)
        return preprocess(*a, **k)

    monkeypatch.setattr(image_util, "preprocess_img", counted)
    ws = _demo(tmp_path, "image_classification",
               ("image_provider.py", "vgg_16_cifar.py", "train.list", "test.list"))
    init = _jax_init(ws, "vgg_16_cifar.py", "small=1")
    tests = {who: _run(who, ["train", "--config=vgg_16_cifar.py", "--config_args=small=1",
                             "--num_passes=3", f"--init_model_path={init}",
                             f"--save_dir={who}"] + QUIET, ws)
             for who in ("jax", "port")}
    assert len(calls) == 3 * (1024 + 256), len(calls)       # 4 + 1 list entries of 256
    assert len(tests["port"]) == len(tests["jax"]) == 3, tests
    for i, (got, want, pinned) in enumerate(zip(tests["port"], tests["jax"], PINNED_VGG_COST)):
        assert abs(got["cost"] - want["cost"]) <= 1e-4 * want["cost"], (i, got, want)
        assert abs(got["cost"] - pinned) <= 0.03 * pinned, (i, got, pinned)
    again = {who: _run(who, ["test", "--config=vgg_16_cifar.py", "--config_args=small=1",
                             "--init_model_path=jax/pass-00000"] + QUIET, ws)
             for who in ("jax", "port")}
    (want,), (got,) = again["jax"], again["port"]
    assert abs(got["cost"] - want["cost"]) <= 1e-5 * want["cost"], again


def _sentiment_corpus(ws):
    """The band's generator's first reviews, cut, as '<label>\\t<text>'
    files the demo's provider reads."""
    spec = importlib.util.spec_from_file_location("sentiment_common",
                                                  os.path.join(ws, "common.py"))
    common = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(common)
    for name, seed, n in (("train", "seed-train-1", SENTIMENT_CUT[0]),
                          ("test", "seed-test-1", SENTIMENT_CUT[1])):
        with open(os.path.join(ws, f"{name}.txt"), "w") as f:
            for label, words in common.synth_reviews(seed, n):
                f.write(f"{label}\t{' '.join(words)}\n")
        with open(os.path.join(ws, f"{name}.list"), "w") as f:
            f.write(f"{name}.txt\n")


def test_sentiment_first_pass_through_the_port_command_line(tmp_path):
    """The sentiment demo (stacked_lstm_net: emb 128, hid_dim 512, three
    ReLU lstmemory of 128, batch 128, sort_by_length) on a cut corpus: one
    pass through each command line from the JAX package's first
    parameters, then the JAX package's pass-00000 tested by both."""
    ws = _demo(tmp_path, "sentiment", ("common.py", "dataprovider.py", "sentiment_net.py",
                                       "trainer_config.py"))
    _sentiment_corpus(ws)
    init = _jax_init(ws, "trainer_config.py")
    tests = {who: _run(who, ["train", "--config=trainer_config.py", "--num_passes=1",
                             f"--init_model_path={init}", f"--save_dir={who}"] + QUIET, ws)
             for who in ("jax", "port")}
    (jax_test,), (port_test,) = tests["jax"], tests["port"]
    assert abs(port_test["cost"] - jax_test["cost"]) <= 1e-4 * jax_test["cost"], tests
    assert port_test[ERR_KEY] == jax_test[ERR_KEY], tests
    again = {who: _run(who, ["test", "--config=trainer_config.py",
                             "--init_model_path=jax/pass-00000"] + QUIET, ws)
             for who in ("jax", "port")}
    (want,), (got,) = again["jax"], again["port"]
    assert abs(got["cost"] - want["cost"]) <= 1e-5 * want["cost"], again
    assert got[ERR_KEY] == want[ERR_KEY], again
    assert abs(want["cost"] - jax_test["cost"]) <= 1e-6 * want["cost"]


def test_long_context_through_the_port_command_line(tmp_path):
    """demo/long_context at its laptop defaults: one training pass through
    each command line from the JAX package's first parameters (test costs
    within 1e-4 relative), and test of the JAX package's pass-00000 through
    both within 1e-5 relative."""
    ws = _demo(tmp_path, "long_context", ("dataprovider.py", "trainer_config.py"))
    (tmp_path / "train.list").write_text("seed-train-1\n")
    (tmp_path / "test.list").write_text("seed-test-1\n")
    init = _jax_init(ws, "trainer_config.py")
    tests = {who: _run(who, ["train", "--config=trainer_config.py", "--num_passes=1",
                             f"--init_model_path={init}", f"--save_dir={who}"] + QUIET, ws)
             for who in ("jax", "port")}
    (jax_test,), (port_test,) = tests["jax"], tests["port"]
    assert abs(port_test["cost"] - jax_test["cost"]) <= 1e-4 * jax_test["cost"], tests
    again = {who: _run(who, ["test", "--config=trainer_config.py",
                             "--init_model_path=jax/pass-00000"] + QUIET, ws)
             for who in ("jax", "port")}
    (want,), (got,) = again["jax"], again["port"]
    assert abs(got["cost"] - want["cost"]) <= 1e-5 * want["cost"], again
    with np.load(os.path.join(ws, "port", "pass-00000", "params.npz")) as z:
        assert all(np.isfinite(z[k]).all() for k in z.files)
