"""The port's pass loop against the JAX package's, on the CPU.

A small classifier (20 inputs, a tanh layer ``h`` of 8, a softmax
``output`` of 3; Adam) over one seeded provider of 192 samples, written
the reference's way, trains in both packages from the same config and
seed. Held to the JAX package:

- gradient accumulation (4 batches of 16 equal 1 batch of 64, and the JAX
  package's accumulated parameters, at rtol 2e-4 / atol 2e-5, the bound of
  ``tests/test_grad_accum.py``);
- fused launch groups (``batches_per_launch``): every step's loss equal to
  the unfused loop's, the parameters too, the pass's remainder run as
  single launches, groups only of one signature, accumulation refused;
- the non-finite policies: abort, skip and rollback each emit the
  ``nonfinite`` records the JAX package's run of the same fault spec emits
  (pass, batch, policy, blamed layer and phase) and end as it ends;
- a rollback run ends with the parameters of an uninterrupted run that
  skipped the same batches (dropout on, shuffled data), within 1e-6;
- the telemetry records validate, ``paddle metrics`` renders the run, the
  StatSet dump comes once a pass, the profiler window writes its trace and
  the heartbeat beats; ``paddle faults`` lists the JAX package's sites;
- the exit codes: an injected OOM returns 20 with ``oom_report.json``; a
  SIGTERM'd and a hung ``train`` child exit 18 and 19 (one subprocess each).
"""

import contextlib
import json
import logging
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from paddle_tpu.config import parse_config as jax_parse_config
from paddle_tpu.observability import metrics as jax_obs
from paddle_tpu.resilience import NonFiniteLossError as JaxNonFiniteLossError
from paddle_tpu.resilience import faultinject as jax_faults
from paddle_tpu.trainer import Trainer as JaxTrainer
from paddle_tpu.utils.flags import _Flags as JaxFlags
from paddle_tpu_torch import cli
from paddle_tpu_torch.bridge import params_from_numpy
from paddle_tpu_torch.config import parse_config
from paddle_tpu_torch.observability import metrics as obs
from paddle_tpu_torch.resilience import EXIT_HANG, EXIT_PREEMPTED, NonFiniteLossError
from paddle_tpu_torch.resilience import faultinject
from paddle_tpu_torch.trainer import Trainer
from paddle_tpu_torch.trainer import checkpoint as ckpt
from paddle_tpu_torch.utils.flags import _Flags

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=2e-4, atol=2e-5)

PROVIDER = """
import numpy as np
from paddle.trainer.PyDataProvider2 import *


def _samples():
    rng = np.random.RandomState(7)
    for _ in range(192):
        y = rng.randint(0, 3)
        x = (rng.randn(20) * 0.4 + y).astype(np.float32)
        yield x.tolist(), int(y)


@provider(input_types=[dense_vector(20), integer_value(3)], should_shuffle=False)
def process(settings, filename):
    yield from _samples()


@provider(input_types=[dense_vector(20), integer_value(3)], should_shuffle=True)
def shuffled(settings, filename):
    yield from _samples()
"""

CONFIG = """
from paddle.trainer_config_helpers import *

define_py_data_sources2(train_list="train.list", test_list="train.list",
                        module="loopprov", obj=get_config_arg("obj", str, "process"))
settings(batch_size=get_config_arg("bs", int, 16), learning_rate=0.05,
         learning_method=AdamOptimizer(),
         num_batches_per_send_parameter=get_config_arg("accum", int, 1),
         batches_per_launch=get_config_arg("fuse", int, 1))
data = data_layer(name="x", size=20)
h = fc_layer(input=data, size=8, act=TanhActivation(), name="h",
             layer_attr=ExtraAttr(drop_rate=get_config_arg("drop", float, 0.0)))
output = fc_layer(input=h, size=3, act=SoftmaxActivation(), name="output")
label = data_layer(name="label", size=3)
outputs(classification_cost(input=output, label=label))
"""

QUIET = dict(log_period=0, dot_period=0, seed=1, use_tpu=False)


@pytest.fixture()
def ws(tmp_path):
    (tmp_path / "loopprov.py").write_text(PROVIDER)
    (tmp_path / "loop_conf.py").write_text(CONFIG)
    (tmp_path / "train.list").write_text("a\n")
    old = os.getcwd()
    os.chdir(tmp_path)
    sys.path.insert(0, str(tmp_path))
    try:
        yield tmp_path
    finally:
        sys.path.remove(str(tmp_path))
        os.chdir(old)
        sys.modules.pop("loopprov", None)
        for module in (obs, jax_obs):
            module.configure("")
        faultinject.configure("")
        jax_faults.configure("")


def _train(who, ws, args="", passes=2, spec="", init=None, spy=False, **flags):
    """Train ``passes`` passes in one package, the port from ``init`` (the
    JAX package's initial parameters, as numpy) where given; returns
    (trainer, the error it raised or None, its telemetry records). A JAX
    trainer keeps its initial parameters in ``init``; with ``spy`` a port
    trainer keeps every step's loss in ``losses``."""
    run = str(ws / f"{who}_run")
    kw = dict(QUIET, metrics_path=run, **flags)
    if who == "jax":
        trainer = JaxTrainer(jax_parse_config("loop_conf.py", args), JaxFlags(**kw))
        trainer.init = _params(trainer)
        jax_faults.configure(spec)
    else:
        trainer = Trainer(parse_config("loop_conf.py", args), _Flags(**kw))
        if init is not None:
            trainer.params = params_from_numpy(init, "cpu")
            trainer.opt_state = trainer.updater.init_state(trainer.params)
        if spy:
            trainer.losses = _spy_losses(trainer)
        faultinject.configure(spec)
    err = None
    try:
        trainer.train(num_passes=passes)
    except (NonFiniteLossError, JaxNonFiniteLossError) as e:
        err = e
    finally:
        faultinject.configure("")
        jax_faults.configure("")
    (jax_obs if who == "jax" else obs).flush()
    return trainer, err, _records(run)


def _records(run_dir):
    return [r for path in obs.metrics_files(run_dir) for r in obs.read_records(path)]


def _params(trainer):
    return {k: np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in trainer.params.items()}


def _assert_params(got, want, **tol):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def _spy_losses(trainer):
    """Every step's loss, read after the run (the spy adds no sync)."""
    losses, step = [], trainer._step

    def spy(batch, seed):
        loss, outputs = step(batch, seed)
        losses.append(loss)
        return loss, outputs

    trainer._step = spy
    return losses


# ------------------------------------------------------ accumulation


def test_accumulation_of_4x16_equals_one_batch_of_64_and_the_jax_package(ws):
    jax_accum, _, _ = _train("jax", ws, "bs=16,accum=4")
    accum, _, _ = _train("port", ws, "bs=16,accum=4", init=jax_accum.init)
    big, _, _ = _train("port", ws, "bs=64", init=jax_accum.init)
    _assert_params(_params(accum), _params(big), **TOL)
    _assert_params(_params(accum), _params(jax_accum), **TOL)
    # 2 passes of 3 updates each, whatever the batch
    assert accum.opt_state.step == big.opt_state.step == 6


# ------------------------------------------------------ fused launches


def test_fused_launches_equal_single_launches_and_the_jax_package(ws):
    """12 batches of 16 a pass at batches_per_launch=5: two groups of 5 and
    a remainder of 2 single launches; every step's loss bit-equal to the
    unfused loop's, and the JAX package's launch counts and parameters."""
    jax_fused, _, jax_recs = _train("jax", ws, "fuse=5")
    fused, _, recs = _train("port", ws, "fuse=5", init=jax_fused.init, spy=True)
    single, _, _ = _train("port", ws, "fuse=1", init=jax_fused.init, spy=True)
    fused_losses, single_losses = fused.losses, single.losses
    assert len(fused_losses) == len(single_losses) == 24
    assert [float(x) for x in fused_losses] == [float(x) for x in single_losses]
    _assert_params(_params(fused), _params(single), rtol=0, atol=0)
    ends = [r for r in recs if r["kind"] == "pass_end"]
    assert [(r["launches_fused"], r["launches_single"]) for r in ends] == [(2, 2), (2, 2)]
    assert [(r["launches_fused"], r["launches_single"]) for r in jax_recs
            if r["kind"] == "pass_end"] == [(2, 2), (2, 2)]
    _assert_params(_params(fused), _params(jax_fused), **TOL)


def test_launch_groups_form_only_from_consecutive_batches_of_one_signature(ws):
    trainer = Trainer(parse_config("loop_conf.py", "fuse=2"), _Flags(**QUIET))

    from paddle_tpu_torch.graph import Argument

    stream = [(None, {"x": Argument(value=torch.zeros(4, t))})
              for t in (3, 3, 5, 3, 3, 3, 4, 4, 4)]
    groups = list(trainer._launch_groups(stream))
    assert [(kind, len(g) if kind == "fused" else 1) for kind, g in groups] == [
        ("fused", 2), ("single", 1), ("fused", 2), ("single", 1), ("fused", 2), ("single", 1)]


def test_fused_launches_with_accumulation_are_refused(ws):
    with pytest.raises(ValueError, match="batches_per_launch > 1 cannot combine"):
        Trainer(parse_config("loop_conf.py", "fuse=2,accum=2"), _Flags(**QUIET))


# ------------------------------------------------------ non-finite


def _nonfinite(records):
    return [(r["pass"], r["step"], r["policy"], r.get("blame_layer"), r.get("blame_phase"))
            for r in records if r["kind"] == "nonfinite"]


@pytest.mark.parametrize("policy,spec,flags", [
    ("abort", "trainer.nonfinite_layer=raise:h@15", {}),
    ("skip", "trainer.nonfinite=raise@5", {}),
    ("skip", "trainer.nonfinite_layer=raise:output@3", dict(max_nonfinite_steps=1)),
    ("rollback", "trainer.nonfinite_layer=raise:h@15", {}),
], ids=["abort-layer", "skip-loss", "skip-layer", "rollback-layer"])
def test_nonfinite_policy_ends_and_blames_as_the_jax_package(ws, policy, spec, flags):
    """The records of both packages: the same batches, policy and blame; the
    same ending (an error naming the layer, or a finished run with the same
    parameters)."""
    runs = {"jax": _train("jax", ws, spec=spec, nonfinite_policy=policy,
                          save_dir=str(ws / "jax_save"), **flags)}
    runs["port"] = _train("port", ws, spec=spec, nonfinite_policy=policy, init=runs["jax"][0].init,
                          save_dir=str(ws / "port_save"), **flags)
    (port, port_err, port_recs), (jax_t, jax_err, jax_recs) = runs["port"], runs["jax"]
    assert _nonfinite(port_recs) == _nonfinite(jax_recs) and _nonfinite(port_recs)
    for r in port_recs:
        assert obs.validate_record(r) == [], r
    assert (port_err is None) == (jax_err is None)
    if port_err is not None:
        layer = _nonfinite(port_recs)[-1][3]
        assert f"layer {layer!r}" in str(port_err) and f"layer {layer!r}" in str(jax_err)
    else:
        assert port.rollbacks == jax_t.rollbacks == (policy == "rollback")
        _assert_params(_params(port), _params(jax_t), **TOL)
    if spec.startswith("trainer.nonfinite="):
        # a faked loss: the model is healthy and nothing is blamed
        assert _nonfinite(port_recs)[0][3] is None


def test_rollback_replays_the_pass_as_a_run_that_skipped_its_batches(ws):
    """Dropout on and shuffled data: the rolled-back pass draws the same
    bits over the same batches in the same order, so the run ends with the
    parameters of one that trained pass 0, tempered the rate and skipped
    pass 1's batches 0-2 (fast-forward past the poisoned batch 2)."""
    args = "obj=shuffled,drop=0.3"
    rolled, err, _ = _train("port", ws, args, spec="trainer.nonfinite_layer=raise:h@15",
                            nonfinite_policy="rollback", save_dir=str(ws / "rolled"))
    assert err is None and rolled.rollbacks == 1
    straight = Trainer(parse_config("loop_conf.py", args), _Flags(**QUIET))
    one_pass = straight.train_one_pass

    def temper_then_skip(pass_id, provider):
        if pass_id == 1:
            straight.config.opt_config.learning_rate *= 0.5
            straight._ff_target = (1, 3)
        return one_pass(pass_id, provider)

    straight.train_one_pass = temper_then_skip
    straight.train(num_passes=2)
    _assert_params(_params(rolled), _params(straight), rtol=0, atol=1e-6)
    assert rolled.opt_state.step == straight.opt_state.step == 12 + 9


# ------------------------------------------------------ telemetry


def test_records_validate_and_paddle_metrics_renders_the_run(ws, capsys, caplog):
    logger = logging.getLogger("paddle_tpu")
    logger.addHandler(caplog.handler)
    try:
        port, err, recs = _train(
            "port", ws, save_dir=str(ws / "save"), log_period=4, numerics_log_period=4,
            profile_dir=str(ws / "prof"), profile_start_batch=2, profile_num_batches=2,
            heartbeat_interval=0.05)
    finally:
        logger.removeHandler(caplog.handler)
    assert err is None
    kinds = [r["kind"] for r in recs]
    for kind in ("run_start", "restart", "train_window", "numerics", "test", "pass_end"):
        assert kind in kinds, kind
    assert kinds[-1] == "run_end" and recs[-1]["status"] == "completed"
    assert kinds.count("pass_end") == 2 and kinds.count("restart") == 1
    for r in recs:
        assert obs.validate_record(r) == [], r
    ends = [r for r in recs if r["kind"] == "pass_end"]
    # the counter saw the one batch signature once, in pass 0
    assert [r["flops_counted_steps"] for r in ends] == [1, 0]
    assert all(r["model_tflops_per_sec"] > 0 and "mfu" not in r for r in ends)
    numerics = [r for r in recs if r["kind"] == "numerics"]
    assert len(numerics) == 2 * (3 + 1) and set(numerics[0]["layers"]) == {"h", "output"}
    assert sum("=== StatSet global ===" in r.getMessage() for r in caplog.records) == 2
    trace = json.load(open(ws / "prof" / "trace-pass00000.json"))
    assert any(e.get("name") == "train_step" for e in trace["traceEvents"])
    beats = os.listdir(ws / "save" / "heartbeats")
    assert beats == ["host-0.json"]
    capsys.readouterr()
    assert cli.main(["metrics", str(ws / "port_run")]) == 0
    out = capsys.readouterr().out.splitlines()
    # one row a pass in the pass table, and the restart and numerics planes
    rows = [line.split() for line in out if line.split()[:2] in (["0", "192"], ["1", "192"])]
    assert [r[0] for r in rows] == ["0", "1"]
    assert "numerics telemetry: 8 record(s)" in out


def test_a_failed_flop_count_leaves_the_mfu_fields_out_and_trains_on(ws, monkeypatch, caplog):
    from torch.utils import flop_counter

    class Broken(flop_counter.FlopCounterMode):
        def __enter__(self):
            raise RuntimeError("no counter here")

    counted, _, _ = _train("port", ws)
    monkeypatch.setattr(flop_counter, "FlopCounterMode", Broken)
    logger = logging.getLogger("paddle_tpu")
    logger.addHandler(caplog.handler)
    try:
        broken, err, recs = _train("port", ws)
    finally:
        logger.removeHandler(caplog.handler)
    assert err is None
    # both runs wrote to one run dir: the counted run's 2 passes, then these
    ends = [r for r in recs if r["kind"] == "pass_end"]
    assert len(ends) == 4 and all("model_tflops_per_sec" in r for r in ends[:2])
    assert not any("model_tflops_per_sec" in r for r in ends[2:])
    assert sum("FLOPs accounting failed" in r.getMessage() for r in caplog.records) == 1
    # every step ran once: the parameters of the counted run
    _assert_params(_params(broken), _params(counted), rtol=0, atol=0)


def test_paddle_faults_lists_the_jax_packages_sites(capsys):
    from paddle_tpu import cli as jax_cli

    assert jax_cli.main(["faults"]) == 0
    want = capsys.readouterr().out
    assert cli.main(["faults"]) == 0
    assert capsys.readouterr().out == want and "trainer.nonfinite_layer" in want


# ------------------------------------------------------ exit codes


def _cli_flags(ws, *extra):
    return ["--config=loop_conf.py", "--use_tpu=false", "--log_period=0", "--dot_period=0",
            f"--save_dir={ws / 'out'}", *extra]


@contextlib.contextmanager
def _fresh_flags():
    from paddle_tpu_torch.utils.flags import FLAGS

    saved = dict(vars(FLAGS))
    vars(FLAGS).update(vars(_Flags()))
    try:
        yield
    finally:
        vars(FLAGS).update(saved)


def test_an_oom_returns_20_with_its_report(ws):
    with _fresh_flags():
        rc = cli.main(["train", *_cli_flags(ws, "--num_passes=1",
                                             "--fault_spec=trainer.oom=raise@2")])
    assert rc == 20
    report = json.load(open(ws / "out" / "oom_report.json"))
    assert report["reason"] == "oom" and report["where"] == {"pass": 0, "step": 1}
    assert "oom" in [r["kind"] for r in _records(str(ws / "out"))]


def _child(ws, *extra):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.Popen([sys.executable, "-m", "paddle_tpu_torch", "train",
                             *_cli_flags(ws, *extra)], cwd=str(ws), env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def test_sigterm_mid_run_saves_and_exits_18(ws):
    proc = _child(ws, "--num_passes=1000")
    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and proc.poll() is None:
            if ckpt.latest_pass(str(ws / "out")) is not None:   # a pass is saved
                break
            time.sleep(0.1)
        assert proc.poll() is None, proc.stdout.read().decode()[-3000:]
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == EXIT_PREEMPTED, out.decode()[-3000:]
    assert b"preemption: checkpoint saved" in out
    newest = ckpt.find_restorable_checkpoint(str(ws / "out"))
    assert newest is not None and ckpt.verify_checkpoint(newest) == []
    kinds = [r["kind"] for r in _records(str(ws / "out"))]
    assert "preempt" in kinds and kinds[-1] == "run_end"


def test_a_hung_step_loop_exits_19_with_its_report(ws):
    proc = _child(ws, "--num_passes=1", "--step_hang_timeout=10",
                  "--fault_spec=trainer.stall=sleep:600@3")
    out, _ = proc.communicate(timeout=120)
    assert proc.returncode == EXIT_HANG, out.decode()[-3000:]
    report = json.load(open(ws / "out" / "hang_report.json"))
    assert report["reason"] == "step_hang" and report["last_progress"] == {"pass": 0, "step": 2}
