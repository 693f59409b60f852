"""The port's command line against the JAX package's, on the CPU.

``paddle_tpu.cli.main`` and ``paddle_tpu_torch.cli.main`` run the seqToseq
demo (synthetic mode, width 32) with ``--use_tpu=false``, each into its own
``save_dir``, each call starting from the flags' defaults as a new process
would. The JAX package trains pass 0; from its ``pass-00000`` both
packages train passes 1-2 (per-pass test costs within 1e-4 relative,
``pass-00002``'s parameters within 1e-3 of each parameter's max |value|);
both packages' ``test --test_pass=1`` over the JAX package's passes give
equal costs (1e-5 relative) and both ``gen`` runs on its ``pass-00002``
write result files with equal ids and scores within 1e-5 relative.
Besides: ``--start_pass`` and ``--init_model_path=auto`` resume as in
``tests/test_trainer.py:77-93``, the log, test, parameter-stats and
batch-save periods log the JAX package's lines, a cost-less config's
``test`` job writes its predictions, ``dump_config`` prints what the JAX
package prints, ``version`` exits 0 and the subcommands not ported exit 2;
the quick_start LR demo trains through the port's command line inside the
pinned ±3% band of ``tests/test_quality_curves.py``; and the port's
``train``, ``test`` and ``gen`` run in an interpreter that refuses to
import jax and the JAX package, as on the machine with the card.
"""

import contextlib
import json
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from paddle_tpu import cli as jax_cli
from paddle_tpu.observability import metrics as jax_obs
from paddle_tpu.trainer import Trainer as JaxTrainer
from paddle_tpu.utils.flags import FLAGS as JAX_FLAGS
from paddle_tpu_torch import cli
from paddle_tpu_torch.config import parse_config
from paddle_tpu_torch.observability import metrics as port_obs
from paddle_tpu_torch.trainer import Trainer
from paddle_tpu_torch.trainer import checkpoint as ckpt
from paddle_tpu_torch.trainer.trainer import read_result_file
from paddle_tpu_torch.utils.flags import FLAGS, _Flags

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ = os.path.join(REPO, "demo", "seqToseq")
# the quick_start LR band, as tests/test_quality_curves.py pins it
PINNED_LR_COST = [0.29132, 0.22416, 0.19969, 0.18781]
ERR_KEY = "__cost_0__.classification_error.classification_error"


@contextlib.contextmanager
def _cwd(path):
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


def _run(who, argv, cwd):
    """One command line call from ``cwd``, from the flags' defaults; the
    package's FLAGS are put back afterwards. Returns the results of every
    test pass it ran, in order."""
    main, flags, trainer_cls = ((jax_cli.main, JAX_FLAGS, JaxTrainer) if who == "jax"
                                else (cli.main, FLAGS, Trainer))
    saved = dict(vars(flags))
    vars(flags).update(vars(type(flags)()))
    tests = []
    test = trainer_cls.test

    def spy(self, *a, **k):
        results = test(self, *a, **k)
        tests.append(results)
        return results

    with pytest.MonkeyPatch.context() as mp, _cwd(cwd):
        mp.setattr(trainer_cls, "test", spy)
        try:
            assert main(argv) == 0
        finally:
            vars(flags).update(saved)
            # close the run's telemetry writer here: left open, a relative
            # --save_dir's stream would take later tests' records into
            # whatever directory they run from
            (jax_obs if who == "jax" else port_obs).configure("")
    return tests


def _seq_workspace(ws):
    for name in ("dataprovider.py", "seqToseq_net.py", "train.conf", "gen.conf"):
        shutil.copy(os.path.join(SEQ, name), ws)
    with open(os.path.join(ws, "train.list"), "w") as f:
        f.write("seed1\n")
    with open(os.path.join(ws, "test.list"), "w") as f:
        f.write("seed2\n")
    return str(ws)


QUIET = ["--use_tpu=false", "--log_period=0", "--dot_period=0"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The JAX package trains pass 0; both packages then train passes 1-2
    from its pass-00000, each into its own save_dir."""
    ws = _seq_workspace(tmp_path_factory.mktemp("seqToseq"))
    _run("jax", ["train", "--config=train.conf", "--num_passes=1", "--save_dir=start"] + QUIET, ws)
    tests = {}
    for who in ("jax", "port"):
        tests[who] = _run(who, ["train", "--config=train.conf", "--num_passes=3", "--start_pass=1",
                                "--init_model_path=start/pass-00000", f"--save_dir={who}"]
                          + QUIET, ws)
    return ws, tests


def test_train_from_the_jax_packages_pass_matches_it(trained):
    ws, tests = trained
    for who in ("jax", "port"):
        assert {"pass-00001", "pass-00002"} <= set(os.listdir(os.path.join(ws, who)))
    costs = {who: [t["cost"] for t in tests[who]] for who in tests}
    assert len(costs["port"]) == 2 and costs["port"][1] < costs["port"][0]
    np.testing.assert_allclose(costs["port"], costs["jax"], rtol=1e-4)
    for key in tests["jax"][0]:
        np.testing.assert_allclose([t[key] for t in tests["port"]],
                                   [t[key] for t in tests["jax"]], rtol=1e-4, err_msg=key)
    with np.load(os.path.join(ws, "jax", "pass-00002", "params.npz")) as j, \
            np.load(os.path.join(ws, "port", "pass-00002", "params.npz")) as p:
        assert sorted(p.files) == sorted(j.files)
        for name in j.files:
            scale = float(np.abs(j[name]).max())
            assert float(np.abs(p[name] - j[name]).max()) <= 1e-3 * scale, name
    with open(os.path.join(ws, "port", "pass-00002", "meta.json")) as f:
        meta = json.load(f)
    assert meta["pass_id"] == 2 and meta["optimizer"]["step"] == 3 * 19
    assert json.loads(meta["config_json"])["model_config"]["layers"]


def test_test_job_over_saved_passes_matches_the_jax_package(trained):
    ws, _ = trained
    argv = ["test", "--config=train.conf", "--save_dir=jax", "--test_pass=1",
            "--num_passes=3"] + QUIET
    got = {who: _run(who, argv, ws) for who in ("jax", "port")}
    assert len(got["port"]) == 2
    np.testing.assert_allclose([t["cost"] for t in got["port"]],
                               [t["cost"] for t in got["jax"]], rtol=1e-5)


def test_gen_writes_the_jax_packages_result_file(trained):
    ws, _ = trained
    for who in ("jax", "port"):
        _run(who, ["gen", "--config=gen.conf", "--init_model_path=jax/pass-00002",
                   f"--gen_result=gen_{who}.txt"] + QUIET, ws)
    want = read_result_file(os.path.join(ws, "gen_jax.txt"))
    got = read_result_file(os.path.join(ws, "gen_port.txt"))
    assert len(got) == len(want) == 300
    assert [idx for idx, _ in got] == [idx for idx, _ in want]
    for (_, gb), (_, wb) in zip(got, want):
        assert [ids for _, ids in gb] == [ids for _, ids in wb]
        np.testing.assert_allclose([s for s, _ in gb], [s for s, _ in wb], rtol=1e-5)


def test_dump_config_prints_what_the_jax_package_prints(tmp_path, capsys):
    ws = _seq_workspace(tmp_path)
    printed = []
    for who in ("jax", "port"):
        _run(who, ["dump_config", "--config=train.conf", "--use_tpu=false"], ws)
        printed.append(capsys.readouterr().out)
    assert printed[1] == printed[0]
    assert json.loads(printed[1])["model_config"]["layers"]


def test_use_tpu_means_the_card(tmp_path):
    """--use_tpu=true, the default, trains on the card: without one the run
    raises, and never moves to the CPU unasked."""
    ws = _seq_workspace(tmp_path)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _run("port", ["train", "--config=train.conf", "--num_passes=1", "--save_dir=out"], ws)
    assert not os.path.exists(os.path.join(ws, "out"))


def test_version_and_the_subcommands_not_ported(capsys):
    assert cli.main(["version"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("paddle_tpu_torch ") and f"torch {torch.__version__}" in out
    for cmd in ("checkgrad", "merge_model", "check-checkpoint", "memory"):
        assert cli.main([cmd]) == 2
        assert f"ROADMAP Queue 1 item {cli.NOT_PORTED[cmd]}" in capsys.readouterr().err
    # the serving surface, the supervisor, `faults` and `metrics` are ported
    # (tests/test_torch_serve_cli.py, tests/test_torch_serve_fleet.py,
    # tests/test_torch_pass_loop.py): both dispatch
    assert not {"serve", "serve-fleet", "serve_fleet", "serve-status", "serve_status",
                "serve-report", "serve_report", "supervise", "faults",
                "metrics"} & set(cli.NOT_PORTED)
    assert cli.main(["faults"]) == 0
    assert "trainer.nonfinite_layer" in capsys.readouterr().out
    with pytest.raises(SystemExit) as done:      # argparse's --help
        cli.main(["metrics", "--help"])
    assert done.value.code == 0 and "paddle metrics" in capsys.readouterr().out
    assert cli.main(["no-such-command"]) == 2


# ---------------------------------------------------- resume (test_trainer)


def _lr_workspace(tmp_path):
    shutil.copy(os.path.join(REPO, "tests", "providers", "synthetic_bow.py"), tmp_path)
    (tmp_path / "train.list").write_text("1\n2\n3\n")
    (tmp_path / "test.list").write_text("99\n")
    (tmp_path / "lr_config.py").write_text(textwrap.dedent("""
        from paddle.trainer_config_helpers import *

        define_py_data_sources2(train_list="train.list", test_list="test.list",
                                module="synthetic_bow", obj="process")
        settings(batch_size=64, learning_rate=0.02, learning_method=AdamOptimizer())
        data = data_layer(name="word", size=100)
        output = fc_layer(input=data, size=2, act=SoftmaxActivation(), name="output")
        label = data_layer(name="label", size=2)
        outputs(classification_cost(input=output, label=label))
        """))
    return str(tmp_path)


def test_start_pass_and_auto_resume(tmp_path):
    """tests/test_trainer.py:77-93 for the port: a trainer with
    --start_pass=1 starts from pass-00000 (parameters and the optimizer's
    step equal the first run's); --init_model_path=auto resumes after the
    newest pass, and starts fresh where there is none."""
    ws = _lr_workspace(tmp_path)
    with _cwd(ws):
        cfg = parse_config("lr_config.py")
        out = os.path.join(ws, "out")
        t1 = Trainer(cfg, _Flags(save_dir=out, log_period=0, dot_period=0, use_tpu=False))
        t1.train(num_passes=1)
        t2 = Trainer(cfg, _Flags(save_dir=out, start_pass=1, log_period=0, dot_period=0,
                                 use_tpu=False))
        np.testing.assert_array_equal(t2.params["_output.w0"].numpy(),
                                      t1.params["_output.w0"].numpy())
        assert t2.opt_state.step == t1.opt_state.step > 0
        assert t2._restored_pass == 0
        t2.train(num_passes=2)
        assert ckpt.latest_pass(out) == 1
        auto = _Flags(save_dir=out, init_model_path="auto", use_tpu=False)
        t3 = Trainer(cfg, auto)
        assert t3.start_pass == 2 and t3.opt_state.step == t2.opt_state.step
        np.testing.assert_array_equal(t3.params["_output.w0"].numpy(),
                                      t2.params["_output.w0"].numpy())
        fresh = Trainer(cfg, _Flags(save_dir=os.path.join(ws, "empty"), init_model_path="auto",
                                    use_tpu=False))
        assert fresh.start_pass == 0 and fresh.opt_state.step == 0
    # through the command line: auto picks up at pass 2 and trains pass 2 only
    tests = _run("port", ["train", "--config=lr_config.py", "--save_dir=out", "--num_passes=3",
                          "--init_model_path=auto"] + QUIET, ws)
    assert len(tests) == 1 and tests[0][ERR_KEY] < 0.1
    # (the save_dir is the run dir of the telemetry records too)
    assert sorted(os.listdir(os.path.join(ws, "out"))) == ["metrics.jsonl", "pass-00000",
                                                           "pass-00001", "pass-00002"]


def _log_lines(who, argv, cwd):
    """The pass loop's own log lines of one command line call: the batch and
    pass-end lines, the test passes and the parameter stats, with their
    numbers, and the checkpoints saved."""
    import logging

    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    handler = Keep()
    logger = logging.getLogger("paddle_tpu")
    logger.addHandler(handler)
    try:
        _run(who, argv, cwd)
    finally:
        logger.removeHandler(handler)
    kinds = ("Pass ", "Test (pass", "Param ", "saved checkpoint")
    return [m.split("  (")[0] for m in records if m.startswith(kinds)]


def test_periods_log_what_the_jax_package_logs(tmp_path):
    """--log_period, --test_period, --show_parameter_stats_period and
    --saving_period_by_batches on the LR demo from the same JAX-written
    pass: the same lines in the same order, their numbers within 1e-4."""
    ws = _lr_workspace(tmp_path)
    _run("jax", ["train", "--config=lr_config.py", "--num_passes=1", "--save_dir=start"] + QUIET,
             ws)
    flags = ["--config=lr_config.py", "--num_passes=3", "--start_pass=1",
             "--init_model_path=start/pass-00000", "--log_period=5", "--test_period=7",
             "--show_parameter_stats_period=9", "--saving_period_by_batches=10",
             "--use_tpu=false", "--dot_period=0"]
    lines = {who: _log_lines(who, ["train", f"--save_dir={who}"] + flags, ws)
             for who in ("jax", "port")}
    assert len(lines["port"]) == len(lines["jax"]) > 20
    for got, want in zip(lines["port"], lines["jax"]):
        got = got.replace("port/pass-", "jax/pass-")
        gw, ww = got.split(), want.split()
        assert len(gw) == len(ww), (got, want)
        for g, w in zip(gw, ww):
            if g == w:
                continue
            gk, _, gv = g.rpartition("=")
            wk, _, wv = w.rpartition("=")
            assert gk == wk, (got, want)
            np.testing.assert_allclose(float(gv), float(wv), rtol=1e-4, atol=1e-7,
                                       err_msg=f"{got} / {want}")
    for kind in ("Test (pass", "Param ", "saved checkpoint", "Pass 1 batch 10"):
        assert any(line.startswith(kind) for line in lines["port"]), kind


PREDICT_PROVIDER = """
import random
from paddle.trainer.PyDataProvider2 import *

@provider(input_types=[sparse_binary_vector(100)], should_shuffle=False)
def words(settings, filename):
    rng = random.Random(int(filename))
    for _ in range(70):
        yield [sorted({rng.randrange(100) for _ in range(rng.randint(5, 15))})]
"""


def test_predict_job_writes_the_jax_packages_files(tmp_path):
    """A config without a cost: `paddle test` predicts, one line a sample
    per output layer, into --predict_output_dir, from the same JAX-written
    parameters: the same values (printed to 6 digits)."""
    ws = _lr_workspace(tmp_path)
    _run("jax", ["train", "--config=lr_config.py", "--num_passes=1", "--save_dir=out"] + QUIET, ws)
    (tmp_path / "predict_provider.py").write_text(PREDICT_PROVIDER)
    (tmp_path / "pred.list").write_text("7\n")
    (tmp_path / "predict.py").write_text(textwrap.dedent("""
        from paddle.trainer_config_helpers import *

        define_py_data_sources2(train_list=None, test_list="pred.list",
                                module="predict_provider", obj="words")
        settings(batch_size=64, learning_rate=0.02, learning_method=AdamOptimizer())
        data = data_layer(name="word", size=100)
        outputs(fc_layer(input=data, size=2, act=SoftmaxActivation(), name="output"))
        """))
    for who in ("jax", "port"):
        _run(who, ["test", "--config=predict.py", "--init_model_path=out/pass-00000",
                   f"--predict_output_dir=pred_{who}"] + QUIET, ws)
    read = lambda who: np.loadtxt(os.path.join(ws, f"pred_{who}", "predict_output.txt"))  # noqa: E731
    assert read("port").shape == read("jax").shape == (70, 2)
    np.testing.assert_allclose(read("port"), read("jax"), rtol=1e-5)


def test_load_missing_parameter_strategy(tmp_path):
    """A checkpoint without one parameter: fail raises, zero zeros it, rand
    keeps the fresh value."""
    ws = _lr_workspace(tmp_path)
    with _cwd(ws):
        cfg = parse_config("lr_config.py")
        base = Trainer(cfg, _Flags(save_dir="", use_tpu=False))
        params = dict(base.params)
        dropped = params.pop("_output.wbias")
        path = ckpt.save_checkpoint(os.path.join(ws, "partial"), 0, params)
        with pytest.raises(KeyError, match="missing from checkpoint"):
            Trainer(cfg, _Flags(init_model_path=path, use_tpu=False))
        zero = Trainer(cfg, _Flags(init_model_path=path, use_tpu=False,
                                   load_missing_parameter_strategy="zero"))
        assert not zero.params["_output.wbias"].any()
        rand = Trainer(cfg, _Flags(init_model_path=path, use_tpu=False, seed=1,
                                   load_missing_parameter_strategy="rand"))
        assert torch.equal(rand.params["_output.wbias"], dropped)


# ---------------------------------------------------- the quick_start band


def test_quick_start_lr_curve_through_the_port_command_line(tmp_path):
    """tests/test_quality_curves.py's quick_start LR band: 25 train and 5
    test entries, 4 passes, every pass's test cost within ±3% of the pinned
    curve, the final error in 0.05-0.10."""
    for name in ("common.py", "dataprovider_bow.py", "trainer_config.lr.py"):
        shutil.copy(os.path.join(REPO, "demo", "quick_start", name), tmp_path)
    (tmp_path / "train.list").write_text("".join(f"seed-train-{i}\n" for i in range(1, 26)))
    (tmp_path / "test.list").write_text("".join(f"seed-test-{i}\n" for i in range(1, 6)))
    tests = _run("port", ["train", "--config=trainer_config.lr.py", "--num_passes=4",
                          "--save_dir="] + QUIET, str(tmp_path))
    assert len(tests) == 4
    for i, (got, want) in enumerate(zip([t["cost"] for t in tests], PINNED_LR_COST)):
        assert abs(got - want) <= 0.03 * want, (i, got, want)
    assert 0.05 < tests[-1][ERR_KEY] < 0.10, tests[-1]


# ------------------------------------------- the card machine's situation

_NO_JAX = """
import importlib.abc, os, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "paddle_tpu"):
            raise ImportError("refused: " + name)
        return None

sys.meta_path.insert(0, Refuse())
sys.path.insert(0, {repo!r})
from paddle_tpu_torch.cli import main
from paddle_tpu_torch.utils.flags import FLAGS, _Flags

for ws, argv in {runs!r}:
    os.chdir(ws)
    vars(FLAGS).update(vars(_Flags()))
    assert main(argv) == 0, argv
print(sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "paddle_tpu")))
"""


def test_the_command_line_runs_where_jax_cannot_be_imported(tmp_path):
    """quick_start (synthetic) and seqToseq (real mode, a tiny dict) through
    the port's train, test and gen, in an interpreter whose imports of jax,
    jaxlib, flax and the JAX package fail."""
    qs = tmp_path / "quick_start"
    qs.mkdir()
    for name in ("common.py", "dataprovider_bow.py", "trainer_config.lr.py"):
        shutil.copy(os.path.join(REPO, "demo", "quick_start", name), qs)
    (qs / "train.list").write_text("seed-train-1\n")
    (qs / "test.list").write_text("seed-test-1\n")
    seq = tmp_path / "seqToseq"
    seq.mkdir()
    _seq_workspace(seq)
    words = ["<s>", "<e>", "<unk>"] + [f"w{i}" for i in range(3, 30)]
    (seq / "dict.txt").write_text("\n".join(words) + "\n")
    rng = np.random.RandomState(1)
    for name, n in (("train.txt", 40), ("test.txt", 10)):
        (seq / name).write_text("".join(
            " ".join(words[i] for i in rng.randint(3, 30, rng.randint(1, 9))) + "\t"
            + " ".join(words[i] for i in rng.randint(3, 30, rng.randint(1, 9))) + "\n"
            for _ in range(n)))
    (seq / "train.list").write_text("train.txt\n")
    (seq / "test.list").write_text("test.txt\n")
    args = "--config_args=src_dict=dict.txt,trg_dict=dict.txt"
    runs = [(str(qs), ["train", "--config=trainer_config.lr.py", "--num_passes=1",
                       "--save_dir=out"] + QUIET),
            (str(qs), ["test", "--config=trainer_config.lr.py", "--init_model_path=out/pass-00000"]
             + QUIET),
            (str(seq), ["train", "--config=train.conf", "--num_passes=1", "--save_dir=out", args]
             + QUIET),
            (str(seq), ["test", "--config=train.conf", "--save_dir=out", "--test_pass=0",
                        "--num_passes=1", args] + QUIET),
            (str(seq), ["gen", "--config=gen.conf", "--init_model_path=out/pass-00000",
                        "--gen_result=gen.txt", args] + QUIET)]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    done = subprocess.run([sys.executable, "-c", _NO_JAX.format(repo=REPO, runs=runs)],
                          cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-3000:]
    assert done.stdout.strip().splitlines()[-1] == "[]"
    blocks = (seq / "gen.txt").read_text().split("\n")
    assert sum(1 for line in blocks if line and "\t" not in line) == 10
    # gen.conf decodes through gen_dict in real mode: the beams are words
    beams = [line.split("\t")[1].split() for line in blocks if "\t" in line]
    assert beams and all(w in words for b in beams for w in b)
