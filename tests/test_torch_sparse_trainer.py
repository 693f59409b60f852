"""Sparse training through the port's pass loop and command line, against
the JAX package's, on the CPU.

The ctr demo (two ``sparse_embedding`` tables under AdaGrad, one list
entry: 32 batches of 32 a pass): the JAX package's ``train`` writes
``pass-00000``; from it both packages' ``train`` run passes 1-2. Each
pass's average cost within 1e-5 relative; ``pass-00002``'s tables, their
``accum`` slots and every other parameter within 1e-5 of max(1, max |JAX|),
``t_last`` (int32) equal; the checkpoints' ``sparse_tables`` and
``sparse_hosts`` equal; one ``kind=sparse`` record a pass, equal to the JAX
package's but for its rate and time. The same pass with a poisoned loss at
batch 3 under ``--nonfinite_policy=skip`` (the in-place rows put back) ends
with the JAX package's tables. The JAX ``pass-00000`` with its ``t_last``
restores into the port unchanged, and ``opt_state_from_numpy`` carries the
int slot. A crash mid-pass (``trainer.crash``) restores the tables of the
last committed pass bit-exactly (after ``tests/test_sparse_chaos.py:265``).
The recommendation demo (six ``sparse_update`` tables under RMSProp, one
of them under a sequence with padded ids) trains one pass through both
command lines from the JAX package's ``init_params(seed=1)``: test costs
within 1e-5 relative. Gradient accumulation over a ``sparse_update``
table (``tests/test_grad_accum.py:102``'s config) ends with the JAX
package's parameters (1e-5 of scale). Besides, on the port alone: fused
launch groups take the dense gradient and the row scan and end where single
launches end; under ``--numerics_log_period`` the tables update
functionally and the health table reads their rows; a restore from another
host set counts a reshard; the numpy API densifies row gradients.
"""

import json
import os
import shutil
import textwrap

import numpy as np
import pytest
import torch

from test_torch_cli import QUIET, _cwd, _run
from paddle_tpu.graph import GradientMachine as JaxMachine
from paddle_tpu.config import parse_config as jax_parse_config
from paddle_tpu.optimizer import Updater as JaxUpdater
from paddle_tpu.resilience import faultinject as jax_faults
from paddle_tpu.trainer import checkpoint as jax_ckpt
from paddle_tpu_torch.bridge import opt_state_from_numpy, opt_state_to_numpy, params_from_numpy
from paddle_tpu_torch.config import parse_config
from paddle_tpu_torch.resilience import faultinject
from paddle_tpu_torch.sparse import clear_tables
from paddle_tpu_torch.trainer import Trainer
from paddle_tpu_torch.trainer import checkpoint as ckpt
from paddle_tpu_torch.utils.flags import _Flags

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COST_TOL = 1e-5        # relative
PARAM_TOL = 1e-5       # of max(1, max |JAX|)


def _scale_close(got, want, tol, what):
    want = np.asarray(want, np.float64)
    err = float(np.max(np.abs(np.asarray(got, np.float64) - want)))
    assert err <= tol * max(1.0, float(np.max(np.abs(want)))), (what, err)


def _demo(ws, demo, train, test=None):
    for name in os.listdir(os.path.join(REPO, "demo", demo)):
        if name.endswith(".py"):
            shutil.copy(os.path.join(REPO, "demo", demo, name), ws)
    (ws / "train.list").write_text(f"{train}\n")
    if test:
        (ws / "test.list").write_text(f"{test}\n")
    return str(ws)


def _records(run_dir, kind):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if r.get("kind") == kind]


def _npz(path, tree):
    with np.load(os.path.join(path, f"{tree}.npz")) as z:
        return {k: z[k] for k in z.files}


def _meta(path):
    with open(os.path.join(path, "meta.json")) as f:
        return json.load(f)


def _run_faulted(who, spec, argv, ws):
    (jax_faults if who == "jax" else faultinject).configure(spec, 0)
    try:
        return _run(who, argv, ws)
    finally:
        (jax_faults if who == "jax" else faultinject).configure("", 0)


@pytest.fixture(scope="module")
def ctr(tmp_path_factory):
    """The JAX package trains pass 0; both packages train passes 1-2 from
    its pass-00000, and again pass 1 with a poisoned loss under skip."""
    ws = _demo(tmp_path_factory.mktemp("ctr"), "ctr", "impressions-seed-1")
    conf = ["train", "--config=trainer_config.py"] + QUIET
    _run("jax", conf + ["--num_passes=1", "--save_dir=start"], ws)
    resume = ["--start_pass=1", "--init_model_path=start/pass-00000"]
    for who in ("jax", "port"):
        _run(who, conf + resume + ["--num_passes=3", f"--save_dir={who}",
                                   f"--metrics_path={who}_run"], ws)
        _run_faulted(who, "trainer.nonfinite=raise@3",
                     conf + resume + ["--num_passes=2", f"--save_dir={who}_skip",
                                      "--nonfinite_policy=skip", "--max_nonfinite_steps=2"], ws)
    clear_tables()
    return ws


def test_ctr_trains_from_a_jax_checkpoint_as_the_jax_command_line(ctr):
    costs = {who: [r["AvgCost"] for r in _records(os.path.join(ctr, f"{who}_run"), "pass_end")]
             for who in ("jax", "port")}
    assert len(costs["port"]) == len(costs["jax"]) == 2
    np.testing.assert_allclose(costs["port"], costs["jax"], rtol=COST_TOL)
    for who in ("", "_skip"):
        last = "pass-00002" if not who else "pass-00001"
        want_dir, got_dir = (os.path.join(ctr, f"{p}{who}", last) for p in ("jax", "port"))
        for tree in ("params", "optimizer_slots"):
            want, got = _npz(want_dir, tree), _npz(got_dir, tree)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                if k.endswith("/t_last"):
                    np.testing.assert_array_equal(got[k], want[k], err_msg=f"{who} {k}")
                else:
                    _scale_close(got[k], want[k], PARAM_TOL, f"{who} {k}")
        jm, pm = _meta(want_dir), _meta(got_dir)
        assert pm["sparse_tables"] == jm["sparse_tables"] == {"_user_emb": 120, "_ad_emb": 48}
        assert pm["sparse_hosts"] == jm["sparse_hosts"] == 1
        assert pm["optimizer"]["step"] == jm["optimizer"]["step"]
    # the skipped batch left no trace: one update fewer than the full pass
    assert _meta(os.path.join(ctr, "port_skip", "pass-00001"))["optimizer"]["step"] == 63


def test_sparse_records_equal_the_jax_trainers(ctr):
    recs = {who: _records(os.path.join(ctr, f"{who}_run"), "sparse") for who in ("jax", "port")}
    assert [r["pass"] for r in recs["port"]] == [1, 2]
    for got, want in zip(recs["port"], recs["jax"]):
        assert got["rows_touched"] == 2 * 1024
        for k in ("t", "sparse_rows_per_sec"):
            got.pop(k), want.pop(k)
        assert got == want


def test_a_jax_checkpoint_with_t_last_restores_into_the_port(ctr):
    start = os.path.join(ctr, "start", "pass-00000")
    slots = _npz(start, "optimizer_slots")
    cfg = parse_config(os.path.join(ctr, "trainer_config.py"))
    with _cwd(ctr):
        trainer = Trainer(cfg, _Flags(use_tpu=False, init_model_path=start))
    clear_tables()
    t_last = trainer.opt_state.slots["_user_emb"]["t_last"]
    assert t_last.dtype == torch.int32 and int(t_last.max()) == 32
    np.testing.assert_array_equal(t_last.numpy(), slots["_user_emb/t_last"])
    assert trainer.opt_state.step == 32
    jcfg = jax_parse_config(os.path.join(ctr, "trainer_config.py"))
    jm = JaxMachine(jcfg.model_config)
    _, jstate, _ = jax_ckpt.load_checkpoint(
        start, JaxUpdater(jcfg.opt_config, jcfg.model_config).init_state(jm.init_params(seed=1)))
    state = opt_state_from_numpy(jstate, "cpu")
    assert state.slots["_ad_emb"]["t_last"].dtype == torch.int32
    back = opt_state_to_numpy(state)
    for pn, tree in back["slots"].items():
        for k, v in tree.items():
            want = np.asarray(jstate.slots[pn][k])
            assert v.dtype == want.dtype and np.array_equal(v, want), (pn, k)


def test_ctr_crash_mid_pass_restores_the_tables_bit_exact(tmp_path):
    ws = _demo(tmp_path, "ctr", "impressions-seed-1")
    save_dir = str(tmp_path / "output")
    flags = dict(use_tpu=False, log_period=0, save_dir=save_dir)
    cfg = parse_config(os.path.join(ws, "trainer_config.py"))
    with _cwd(ws):
        try:
            Trainer(cfg, _Flags(num_passes=2, **flags)).train()
            emb1 = _npz(os.path.join(save_dir, ckpt.PASS_FMT % 1), "params")
            faultinject.configure("trainer.crash=raise@5", 0)
            with pytest.raises(faultinject.FaultInjected):
                Trainer(cfg, _Flags(num_passes=4, init_model_path="auto", **flags)).train()
            faultinject.configure("", 0)
            recovered = Trainer(cfg, _Flags(num_passes=4, init_model_path="auto", **flags))
            for k in ("_user_emb", "_ad_emb"):
                np.testing.assert_array_equal(recovered.params[k].numpy(), emb1[k], err_msg=k)
            assert recovered.start_pass == 2
            recovered.train()
        finally:
            faultinject.configure("", 0)
            clear_tables()
    assert os.path.isdir(os.path.join(save_dir, ckpt.PASS_FMT % 3))
    for k in ("_user_emb", "_ad_emb"):
        assert not np.array_equal(recovered.params[k].numpy(), emb1[k])


def _from_jax_init(ws, conf):
    """The JAX package's init_params(seed=1) of ``conf`` as a checkpoint."""
    with _cwd(ws):
        jcfg = jax_parse_config(conf)
    params = JaxMachine(jcfg.model_config).init_params(seed=1)
    return ckpt.save_checkpoint(os.path.join(ws, "init"), 0, params_from_numpy(
        {k: np.asarray(v) for k, v in params.items()}, "cpu"))


def test_recommendation_trains_as_the_jax_command_line(tmp_path):
    ws = _demo(tmp_path, "recommendation", "seed1", "seed2")
    init = _from_jax_init(ws, "trainer_config.py")
    tests = {who: _run(who, ["train", "--config=trainer_config.py", "--num_passes=1",
                             f"--init_model_path={init}", f"--save_dir={who}"] + QUIET, ws)
             for who in ("jax", "port")}
    clear_tables()
    assert len(tests["port"]) == len(tests["jax"]) == 1
    np.testing.assert_allclose(tests["port"][0]["cost"], tests["jax"][0]["cost"], rtol=COST_TOL)
    slots = _npz(os.path.join(ws, "port", "pass-00000"), "optimizer_slots")
    assert slots["_title_emb/t_last"].dtype == np.int32 and slots["_title_emb/t_last"].max() > 0


ACCUM_CONFIG = """
from paddle.trainer_config_helpers import *

define_py_data_sources2(train_list="train.list", test_list=None, module="seqprov",
                        obj="process")
settings(batch_size=16, learning_rate=0.1, learning_method=AdamOptimizer(),
         num_batches_per_send_parameter=3)
words = data_layer(name="words", size=50)
emb = embedding_layer(input=words, size=8, param_attr=ParamAttr(name="emb", sparse_update=True))
pool = pooling_layer(input=emb, pooling_type=AvgPooling())
output = fc_layer(input=pool, size=2, act=SoftmaxActivation(), name="output")
label = data_layer(name="label", size=2)
outputs(classification_cost(input=output, label=label))
"""

ACCUM_PROVIDER = """
import numpy as np
from paddle.trainer.PyDataProvider2 import *

@provider(input_types=[integer_value_sequence(50), integer_value(2)], should_shuffle=False)
def process(settings, filename):
    rng = np.random.RandomState(3)
    for _ in range(96):
        y = rng.randint(0, 2)
        toks = rng.randint(25 * y, 25 * y + 25, rng.randint(3, 8))
        yield [int(t) for t in toks], int(y)
"""


def test_accumulation_over_a_sparse_table_matches_jax(tmp_path):
    (tmp_path / "accum.py").write_text(ACCUM_CONFIG)
    (tmp_path / "seqprov.py").write_text(textwrap.dedent(ACCUM_PROVIDER))
    (tmp_path / "train.list").write_text("a\n")
    ws = str(tmp_path)
    init = _from_jax_init(ws, "accum.py")
    for who in ("jax", "port"):
        _run(who, ["train", "--config=accum.py", "--num_passes=2", f"--init_model_path={init}",
                   f"--save_dir={who}"] + QUIET, ws)
    clear_tables()
    want = _npz(os.path.join(ws, "jax", "pass-00001"), "params")
    got = _npz(os.path.join(ws, "port", "pass-00001"), "params")
    assert sorted(got) == sorted(want)
    for k in want:
        _scale_close(got[k], want[k], PARAM_TOL, k)
    # 6 batches of 16 a pass, 3 a send: 4 updates in the two passes
    assert _meta(os.path.join(ws, "port", "pass-00001"))["optimizer"]["step"] == 4


def _ctr_trainer(ws, **flags):
    cfg = parse_config(os.path.join(ws, "trainer_config.py"))
    with _cwd(ws):
        return cfg, Trainer(cfg, _Flags(use_tpu=False, log_period=0, **flags))


def test_fused_launches_take_the_row_scan_and_match_single_launches(tmp_path):
    """batches_per_launch=4 runs the dense gradient and the row scan, as the
    JAX package's fused scan does; on the CPU it ends where single launches
    of the indexed path end (1e-6 of scale, t_last equal)."""
    ws = _demo(tmp_path, "ctr", "impressions-seed-1")
    runs = {}
    for k in (1, 4):
        cfg = parse_config(os.path.join(ws, "trainer_config.py"))
        cfg.opt_config.batches_per_launch = k
        with _cwd(ws):
            trainer = Trainer(cfg, _Flags(use_tpu=False, log_period=0))
        seen = []
        dense = trainer._dense_grad_fn
        trainer._dense_grad_fn = lambda *a, _f=dense: seen.append(1) or _f(*a)
        with _cwd(ws):
            trainer.train_one_pass(0, trainer._provider(for_test=False))
        runs[k] = (trainer, len(seen))
    clear_tables()
    assert runs[1][1] == 0 and runs[4][1] == 32
    (one, _), (four, _) = runs[1], runs[4]
    for k, v in one.params.items():
        _scale_close(four.params[k].numpy(), v.numpy(), 1e-6, k)
    for pn, slots in one.opt_state.slots.items():
        for k, v in slots.items():
            if k == "t_last":
                assert torch.equal(four.opt_state.slots[pn][k], v), pn
            else:
                _scale_close(four.opt_state.slots[pn][k].numpy(), v.numpy(), 1e-6, f"{pn}/{k}")


def test_numerics_read_the_row_gradients_and_a_functional_update(tmp_path):
    """Under --numerics_log_period the tables update functionally, so the
    health table reads each update as new minus old; the embedding layers'
    rows show a gradient and an update."""
    from paddle_tpu_torch.observability import numerics as obs_num

    ws = _demo(tmp_path, "ctr", "impressions-seed-1")
    _, trainer = _ctr_trainer(ws, numerics_log_period=8)
    assert trainer.updater.sparse_in_place is False
    table = trainer.params["_user_emb"]
    with _cwd(ws):
        trainer.train_one_pass(0, trainer._provider(for_test=False))
    clear_tables()
    assert trainer.params["_user_emb"] is not table
    layers, nonfinite, _ = obs_num.derive(trainer._numerics_last.numpy(),
                                          list(trainer._numerics_groups))
    assert not nonfinite
    for layer in ("user", "ad"):
        assert layers[layer]["grad_norm"] > 0 and layers[layer]["update_ratio"] > 0, layer


def test_a_restore_from_another_host_set_counts_a_reshard(tmp_path, monkeypatch):
    ws = _demo(tmp_path, "ctr", "impressions-seed-1")
    _, trainer = _ctr_trainer(ws)
    real = ckpt.load_checkpoint

    def from_two_hosts(*a, **k):
        params, state, meta = real(*a, **k)
        return params, state, dict(meta, sparse_hosts=2)

    trainer.save_dir = str(tmp_path / "out")
    path = trainer.save(0)
    assert _meta(path)["sparse_hosts"] == 1
    monkeypatch.setattr(ckpt, "load_checkpoint", from_two_hosts)
    trainer.restore(path)
    clear_tables()
    assert trainer._sparse_stats.pass_record()["reshard_events"] == 1


def test_the_numpy_api_densifies_row_gradients(tmp_path):
    from paddle_tpu_torch import api

    ws = _demo(tmp_path, "ctr", "impressions-seed-1")
    cfg = parse_config(os.path.join(ws, "trainer_config.py"))
    with _cwd(ws):
        batch = next(iter(_ctr_trainer(ws)[1]._provider(for_test=False).batches()))
    clear_tables()
    machine = api.GradientMachine.createFromConfigProto(cfg.model_config, device="cpu")
    loss, grads = machine.forwardBackward(batch)
    assert np.isfinite(loss) and grads["_user_emb"].shape == (120, 16)
    rows = set(batch["user_id"].ids.reshape(-1).tolist())
    touched = set(np.flatnonzero(np.abs(grads["_user_emb"]).sum(1)).tolist())
    assert touched <= rows and len(touched) > 0
