"""Sparse training's pieces against the JAX package, on the CPU.

- ``dedupe``: the same distinct ids, validity and summed rows as the JAX
  ``dedupe`` on seeded ids with duplicates;
- both row-sparse update paths (``_apply_sparse_indexed`` from a
  ``RowSparseGrad``, ``_apply_sparse_rows`` from its dense gradient) over 4
  steps of overlapping and disjoint id sets with a padded id, for each of
  the seven methods with no decay, L2, L1 and clipping: the table and every
  slot within 1e-6 of max(1, max |JAX|) after every step, ``t_last``
  equal; both paths leave a row whose summed gradient is exactly zero as it
  was, ``t_last`` too; the updater's undo log puts an in-place step back;
- ``GradientMachine.grad_fn`` on the ctr and recommendation demos: the same
  prefetch plan, a ``RowSparseGrad`` for each planned table whose dense
  form equals the JAX one's (1e-4 of max(1, max |JAX|), the dense
  gradients too; the cost within 1e-5 relative); a table used other than
  through a data-fed table projection keeps a dense gradient;
- the pruning hook: the mask file read back by the other package, pruned
  weights exactly 0 through 5 momentum steps with L2 equal to the JAX
  updater's, the mask found under ``init_model_path``;
- the row budget's refusal names ``_user_emb``, as the JAX trainer's does.
"""

import contextlib
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.config import parse_config_at as jax_parse_config_at
from paddle_tpu.graph import GradientMachine as JaxMachine
from paddle_tpu.graph.argument import Argument as JArg
from paddle_tpu.optimizer import Updater as JaxUpdater
from paddle_tpu.optimizer import hooks as jax_hooks
from paddle_tpu.optimizer.sparse import RowSparseGrad as JaxRowSparseGrad
from paddle_tpu.optimizer.sparse import dedupe as jax_dedupe
from paddle_tpu.proto import ModelConfig as JaxModelConfig
from paddle_tpu.proto import OptimizationConfig as JaxOptimizationConfig
from paddle_tpu.proto import ParameterConfig as JaxParameterConfig
from paddle_tpu_torch.bridge import params_from_numpy
from paddle_tpu_torch.config import parse_config_at
from paddle_tpu_torch.data.feeder import create_data_provider
from paddle_tpu_torch.graph import GradientMachine
from paddle_tpu_torch.optimizer import Updater
from paddle_tpu_torch.optimizer import hooks
from paddle_tpu_torch.optimizer.sparse import RowSparseGrad, dedupe, touched_row_bytes
from paddle_tpu_torch.proto import ModelConfig, OptimizationConfig, ParameterConfig

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METHODS = ("momentum", "adagrad", "decayed_adagrad", "rmsprop", "adadelta", "adam", "adamax")
VARIANTS = {"plain": {}, "l2": dict(decay_rate=0.05), "l1": dict(decay_rate_l1=0.01),
            "clip": dict(gradient_clipping_threshold=0.5)}
UPDATE_TOL = 1e-6       # of max(1, max |JAX|), after every update
GRAD_TOL = 1e-4         # of max(1, max |JAX gradient|): a whole backward
COST_TOL = 1e-5         # relative
V, D = 10, 3
# four steps of ids: overlapping (1, 2, 3, 5) and disjoint sets, duplicates,
# and id 0 at a padded position (its row is zero)
STEP_IDS = ([1, 3, 3, 5, 0], [2, 4, 6, 6, 9], [1, 2, 7, 7, 0], [8, 8, 3, 5, 0])


def _scale_close(got, want, tol, what):
    want = np.asarray(want, np.float64)
    err = float(np.max(np.abs(np.asarray(got, np.float64) - want))) if want.size else 0.0
    assert err <= tol * max(1.0, float(np.max(np.abs(want))) if want.size else 1.0), \
        (what, err)


def test_dedupe_matches_jax():
    rng = np.random.RandomState(0)
    for n, nrows in ((1, 4), (6, 8), (40, 12), (64, 1000)):
        ids = rng.randint(0, nrows, n).astype(np.int32)
        rows = rng.randn(n, 5).astype(np.float32)
        uid, g, valid = dedupe(torch.from_numpy(ids), torch.from_numpy(rows), nrows)
        juid, jg, jvalid = jax_dedupe(jnp.asarray(ids), jnp.asarray(rows), nrows)
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
        np.testing.assert_array_equal(uid.numpy(), np.asarray(juid))
        k = int(valid.sum())
        assert k == np.unique(ids).size and (uid.numpy()[k:] == nrows).all()
        _scale_close(g.numpy()[:k], np.asarray(jg)[:k], UPDATE_TOL, "g_rows")
    sg = RowSparseGrad(torch.tensor([3, 1, 3]), torch.ones(3, 2), 6)
    assert sg.shape == (6, 2) and sg.to_dense()[3].tolist() == [2.0, 2.0]
    assert touched_row_bytes(sg) == (3 * 8, 2 * 8)


def _updaters(method, variant):
    def make(model_cls, opt_cls, param_cls, upd_cls):
        m = model_cls()
        m.parameters.append(param_cls(name="emb", size=V * D, dims=[V, D], momentum=0.9,
                                      sparse_update=True, **VARIANTS[variant]))
        opt = opt_cls(learning_rate=0.1, learning_method=method,
                      learning_rate_schedule="constant", batch_size=2)
        return upd_cls(opt, m)

    return (make(JaxModelConfig, JaxOptimizationConfig, JaxParameterConfig, JaxUpdater),
            make(ModelConfig, OptimizationConfig, ParameterConfig, Updater))


def _steps(seed):
    rng = np.random.RandomState(seed)
    out = []
    for ids in STEP_IDS:
        rows = (rng.randn(len(ids), D) * 2).astype(np.float32)
        rows[np.asarray(ids) == 0] = 0.0
        out.append((np.asarray(ids, np.int32), rows))
    return rng.randn(V, D).astype(np.float32), out


def _check_state(tp, ts, jp, js, what):
    _scale_close(tp["emb"].numpy(), jp["emb"], UPDATE_TOL, f"{what} emb")
    for k, v in js.slots["emb"].items():
        if k == "t_last":
            assert ts.slots["emb"][k].dtype == torch.int32
            np.testing.assert_array_equal(ts.slots["emb"][k].numpy(), np.asarray(v), what)
        else:
            _scale_close(ts.slots["emb"][k].numpy(), v, UPDATE_TOL, f"{what} {k}")


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("method", METHODS)
def test_sparse_updates_match_the_jax_updater(method, variant):
    """Both paths, each against the JAX updater's same path, after each of
    four steps; the padded id 0 is never updated."""
    w0, steps = _steps(METHODS.index(method) * 4 + sorted(VARIANTS).index(variant))
    for indexed in (True, False):
        jupd, upd = _updaters(method, variant)
        jp, tp = {"emb": jnp.asarray(w0)}, {"emb": torch.from_numpy(w0.copy())}
        js, ts = jupd.init_state(jp), upd.init_state(tp)
        for i, (ids, rows) in enumerate(steps):
            jg = JaxRowSparseGrad(jnp.asarray(ids), jnp.asarray(rows), V)
            tg = RowSparseGrad(torch.from_numpy(ids), torch.from_numpy(rows), V)
            if not indexed:
                jg, tg = jg.to_dense(), tg.to_dense()
            jp, js = jupd(jp, {"emb": jg}, js, 2.0)
            tp, ts = upd(tp, {"emb": tg}, ts, 2)
            _check_state(tp, ts, jp, js, f"{'indexed' if indexed else 'rows'} step {i}")
        np.testing.assert_array_equal(tp["emb"].numpy()[0], w0[0])
        assert int(ts.slots["emb"]["t_last"][0]) == 0


def test_zero_aggregate_rows_stay_frozen():
    """Row 2's two occurrences cancel exactly: it, its slots and its t_last
    stay as they are on both paths, as in the JAX package."""
    ids = np.array([2, 5, 2, 7], np.int32)
    x = np.array([0.5, -1.0, 2.0], np.float32)
    rows = np.stack([x, np.ones(D, np.float32), -x, -np.ones(D, np.float32)])
    w0 = np.random.RandomState(3).randn(V, D).astype(np.float32)
    for indexed in (True, False):
        jupd, upd = _updaters("adam", "l2")
        jp, tp = {"emb": jnp.asarray(w0)}, {"emb": torch.from_numpy(w0.copy())}
        js, ts = jupd.init_state(jp), upd.init_state(tp)
        for _ in range(2):
            tg = RowSparseGrad(torch.from_numpy(ids), torch.from_numpy(rows), V)
            jg = JaxRowSparseGrad(jnp.asarray(ids), jnp.asarray(rows), V)
            if not indexed:
                jg, tg = jg.to_dense(), tg.to_dense()
            jp, js = jupd(jp, {"emb": jg}, js, 2.0)
            tp, ts = upd(tp, {"emb": tg}, ts, 2)
        _check_state(tp, ts, jp, js, "indexed" if indexed else "rows")
        np.testing.assert_array_equal(tp["emb"].numpy()[2], w0[2])
        assert (ts.slots["emb"]["m"].numpy()[2] == 0).all()
        assert ts.slots["emb"]["t_last"].tolist() == [0, 0, 0, 0, 0, 2, 0, 2, 0, 0]


def test_undo_log_puts_an_in_place_step_back():
    """In place, the step writes into the caller's tensors; with a log, one
    undo per launch restores every row and slot it wrote, over two steps."""
    _, steps = _steps(7)
    jupd, upd = _updaters("adagrad", "l1")
    w0 = np.random.RandomState(8).randn(V, D).astype(np.float32)
    tp = {"emb": torch.from_numpy(w0.copy())}
    ts = upd.init_state(tp)
    tp, ts = upd(tp, {"emb": RowSparseGrad(*map(torch.from_numpy, steps[0]), V)}, ts, 2)
    before = {k: v.clone() for k, v in [("emb", tp["emb"])] + list(ts.slots["emb"].items())}
    table = tp["emb"]
    upd.undo = log = []
    for ids, rows in steps[1:3]:
        tp, ts = upd(tp, {"emb": RowSparseGrad(torch.from_numpy(ids), torch.from_numpy(rows),
                                               V)}, ts, 2)
    assert tp["emb"] is table and not torch.equal(table, before["emb"])
    upd.undo_sparse(log)
    for k, v in [("emb", tp["emb"])] + list(ts.slots["emb"].items()):
        assert torch.equal(v, before[k]), k
    upd.sparse_in_place, upd.undo = False, None
    tp2, _ = upd(tp, {"emb": RowSparseGrad(*map(torch.from_numpy, steps[1]), V)}, ts, 2)
    assert tp2["emb"] is not table and torch.equal(table, before["emb"])


@contextlib.contextmanager
def _cwd(path):
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


def _jax_arg(arg):
    get = lambda f: None if getattr(arg, f) is None else jnp.asarray(  # noqa: E731
        getattr(arg, f).numpy())
    return JArg(value=get("value"), ids=get("ids"), seq_lengths=get("seq_lengths"),
                sub_seq_lengths=get("sub_seq_lengths"))


def _demo(ws, demo, train):
    for name in os.listdir(os.path.join(REPO, "demo", demo)):
        if name.endswith(".py"):
            shutil.copy(os.path.join(REPO, "demo", demo, name), ws)
    (ws / "train.list").write_text(f"{train}\n")
    (ws / "test.list").write_text(f"{train}\n")
    return str(ws)


@pytest.mark.parametrize("demo,train,tables", [
    ("ctr", "impressions-seed-1", {"_user_emb", "_ad_emb"}),
    ("recommendation", "seed1", {"_movie_id_emb", "_title_emb", "_user_id_emb",
                                 "_user_gender_emb", "_user_age_emb", "_user_job_emb"}),
])
def test_grad_fn_gives_row_sparse_gradients_as_the_jax_machine(demo, train, tables, tmp_path):
    ws = _demo(tmp_path, demo, train)
    with _cwd(ws):
        jcfg = jax_parse_config_at(os.path.join(ws, "trainer_config.py"), "")
        cfg = parse_config_at(os.path.join(ws, "trainer_config.py"), "")
        dp = create_data_provider(cfg.data_config, cfg.opt_config.batch_size,
                                  cfg.model_config.input_layer_names, async_prefetch=False,
                                  seed=1)
        batch = next(iter(dp.batches()))
    jm, pm = JaxMachine(jcfg.model_config), GradientMachine(cfg.model_config, device="cpu")
    plan = pm.sparse_prefetch_plan()
    assert plan == jm.sparse_prefetch_plan() and {pn for pn, _ in plan} == tables
    jparams = jm.init_params(seed=1)
    jloss, jgrads, _, _ = jax.jit(jm.grad_fn())(
        jparams, {k: _jax_arg(a) for k, a in batch.items()}, jax.random.PRNGKey(0))
    loss, grads, _, _ = pm.grad_fn()(
        params_from_numpy({k: np.asarray(v) for k, v in jparams.items()}, "cpu"), batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=COST_TOL)
    assert list(grads) == sorted(jparams) and sorted(grads) == sorted(jgrads)
    for name, jg in jgrads.items():
        if name in tables:
            assert isinstance(grads[name], RowSparseGrad) and isinstance(jg, JaxRowSparseGrad)
            assert grads[name].shape == jg.shape
            np.testing.assert_array_equal(grads[name].ids.numpy(), np.asarray(jg.ids))
            got, want = grads[name].to_dense(), jg.to_dense()
        else:
            got, want = grads[name], jg
        _scale_close(got.numpy(), np.asarray(want), GRAD_TOL, name)


def test_an_unresolvable_table_falls_back_dense():
    """One table read by a data-fed table projection and as an fc layer's
    weight keeps the dense gradient on both packages (the reach of the
    reference's prefetch), and the row scan updates it."""
    from paddle_tpu.config.builder import fresh_context as jax_fresh
    import paddle_tpu.trainer_config_helpers as jh
    from paddle_tpu_torch.config.builder import fresh_context
    from paddle_tpu_torch.graph.argument import Argument
    import paddle_tpu_torch.trainer_config_helpers as th

    def build(fresh, h):
        with fresh() as ctx:
            h.settings(batch_size=4, learning_rate=0.05)
            attr = lambda: h.ParamAttr(name="emb", sparse_update=True)  # noqa: E731
            emb = h.embedding_layer(input=h.data_layer(name="words", size=20), size=4,
                                    param_attr=attr())
            dense = h.fc_layer(input=h.data_layer(name="x", size=20), size=4,
                               param_attr=attr(), bias_attr=False, name="dense")
            pool = h.pooling_layer(input=emb, pooling_type=h.MaxPooling())
            out = h.fc_layer(input=[pool, dense], size=3, act=h.SoftmaxActivation(),
                             name="output")
            h.outputs(h.classification_cost(input=out, label=h.data_layer(name="label",
                                                                          size=3)))
            return ctx.finalize()

    jtc, tc = build(jax_fresh, jh), build(fresh_context, th)
    jm = JaxMachine(jtc.model_config)
    pm = GradientMachine(tc.model_config, device="cpu")
    assert pm.sparse_prefetch_plan() == jm.sparse_prefetch_plan() == []
    rng = np.random.RandomState(2)
    ids = rng.randint(0, 20, (4, 5)).astype(np.int32)
    batch = {"words": Argument(ids=torch.from_numpy(ids),
                               seq_lengths=torch.tensor([5, 3, 4, 1], dtype=torch.int32)),
             "x": Argument(value=torch.from_numpy(rng.randn(4, 20).astype(np.float32))),
             "label": Argument(ids=torch.from_numpy(rng.randint(0, 3, 4).astype(np.int32)))}
    jparams = jm.init_params(seed=2)
    jloss, jgrads, _, _ = jm.grad_fn()(jparams, {k: _jax_arg(a) for k, a in batch.items()},
                                       None)
    params = params_from_numpy({k: np.asarray(v) for k, v in jparams.items()}, "cpu")
    loss, grads, _, _ = pm.grad_fn()(params, batch)
    assert isinstance(grads["emb"], torch.Tensor) and grads["emb"].shape == (20, 4)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=COST_TOL)
    _scale_close(grads["emb"].numpy(), np.asarray(jgrads["emb"]), GRAD_TOL, "emb")
    jup, up = JaxUpdater(jtc.opt_config, jtc.model_config), Updater(tc.opt_config,
                                                                      tc.model_config)
    jp, _ = jup(jparams, jgrads, jup.init_state(jparams), 4.0)
    tp, ts = up(params, grads, up.init_state(params), 4)
    assert int(ts.slots["emb"]["t_last"].max()) == 1
    _scale_close(tp["emb"].numpy(), np.asarray(jp["emb"]), UPDATE_TOL, "emb updated")


def test_pruning_mask_file_round_trip(tmp_path):
    rng = np.random.RandomState(0)
    for n in (5, 8, 29, 64):
        mask = rng.rand(n) < 0.5
        hooks.write_mask_file(str(tmp_path / f"p{n}.mask"), mask)
        jax_hooks.write_mask_file(str(tmp_path / f"j{n}.mask"), mask)
        np.testing.assert_array_equal(jax_hooks.load_mask_file(str(tmp_path / f"p{n}.mask")),
                                      mask)
        np.testing.assert_array_equal(hooks.load_mask_file(str(tmp_path / f"j{n}.mask")), mask)
    np.save(tmp_path / "m.npy", rng.rand(3, 4) < 0.5)
    np.testing.assert_array_equal(hooks.resolve_mask(str(tmp_path / "m.npy"), (3, 4)),
                                  jax_hooks.resolve_mask(str(tmp_path / "m.npy"), (3, 4)))


def _pruning_configs(mask_path):
    from paddle_tpu.config.builder import fresh_context as jax_fresh
    from paddle_tpu_torch.config.builder import fresh_context
    import paddle_tpu.trainer_config_helpers as jh
    import paddle_tpu_torch.trainer_config_helpers as th

    out = []
    for fresh, h in ((jax_fresh, jh), (fresh_context, th)):
        with fresh() as ctx:
            h.settings(batch_size=8, learning_rate=0.1, learning_method=h.MomentumOptimizer(0.9))
            x = h.data_layer(name="x", size=10)
            out_l = h.fc_layer(input=x, size=4, act=h.SoftmaxActivation(), name="out",
                               param_attr=h.ParamAttr(name="w_pruned", l2_rate=1e-3,
                                                      update_hooks=h.HookAttr(
                                                          type="pruning",
                                                          mask_filename=mask_path)))
            h.outputs(h.classification_cost(input=out_l, label=h.data_layer(name="label",
                                                                            size=4)))
            out.append(ctx.finalize())
    return out


def test_pruned_weights_stay_zero_through_training_as_in_jax(tmp_path):
    from paddle_tpu.graph import make_dense, make_ids
    from paddle_tpu_torch.graph.argument import Argument

    rng = np.random.RandomState(1)
    mask = rng.rand(10, 4) < 0.6
    hooks.write_mask_file(str(tmp_path / "w.mask"), mask)
    jtc, tc = _pruning_configs(str(tmp_path / "w.mask"))
    jm, pm = JaxMachine(jtc.model_config), GradientMachine(tc.model_config, device="cpu")
    jup, up = JaxUpdater(jtc.opt_config, jtc.model_config), Updater(tc.opt_config,
                                                                    tc.model_config)
    jparams = jm.init_params(seed=3)
    js = jup.init_state(jparams)
    jparams = jup.apply_init_hooks(jparams)
    params = params_from_numpy({k: np.asarray(v) for k, v in jm.init_params(seed=3).items()},
                               "cpu")
    ts = up.init_state(params)
    params = up.apply_init_hooks(params)
    np.testing.assert_array_equal(params["w_pruned"].numpy()[~mask], 0.0)
    x = rng.randn(8, 10).astype(np.float32)
    y = rng.randint(0, 4, (8,)).astype(np.int32)
    jbatch = {"x": make_dense(x), "label": make_ids(y)}
    batch = {"x": Argument(value=torch.from_numpy(x)), "label": Argument(ids=torch.from_numpy(y))}
    before = params["w_pruned"].numpy().copy()
    for _ in range(5):
        _, jg, _, _ = jm.grad_fn()(jparams, jbatch, None)
        jparams, js = jup(jparams, jg, js, jnp.asarray(8.0))
        _, g, _, _ = pm.grad_fn()(params, batch)
        params, ts = up(params, g, ts, 8)
    after = params["w_pruned"].numpy()
    np.testing.assert_array_equal(after[~mask], 0.0)
    assert np.all(after[mask] != before[mask])
    for k in jparams:
        _scale_close(params[k].numpy(), np.asarray(jparams[k]), GRAD_TOL, k)


def test_pruning_mask_searched_in_init_model_path(tmp_path):
    mask = np.ones((10, 4), np.float32)
    mask[0] = 0
    os.makedirs(tmp_path / "model")
    hooks.write_mask_file(str(tmp_path / "model" / "rel.mask"), mask)
    _, tc = _pruning_configs("rel.mask")
    with _cwd(tmp_path):
        up = Updater(tc.opt_config, tc.model_config, init_model_path=str(tmp_path / "model"))
        p = up.apply_init_hooks({"w_pruned": torch.ones(10, 4), "out.wbias": torch.ones(1, 4)})
        with pytest.raises(AssertionError, match="rel.mask"):
            Updater(tc.opt_config, tc.model_config).apply_init_hooks(
                {"w_pruned": torch.ones(10, 4)})
    np.testing.assert_array_equal(p["w_pruned"].numpy(), mask)
    assert (p["out.wbias"] == 1).all()


def test_the_row_budget_refusal_names_the_table(tmp_path):
    from paddle_tpu.trainer import Trainer as JaxTrainer
    from paddle_tpu.utils.flags import _Flags as JaxFlags
    from paddle_tpu_torch.trainer import Trainer
    from paddle_tpu_torch.utils.flags import _Flags

    ws = _demo(tmp_path, "ctr", "impressions-seed-1")
    with _cwd(ws):
        jcfg = jax_parse_config_at(os.path.join(ws, "trainer_config.py"), "")
        cfg = parse_config_at(os.path.join(ws, "trainer_config.py"), "")
        with pytest.raises(ValueError) as jerr:
            JaxTrainer(jcfg, JaxFlags(use_tpu=False, sparse_row_budget=100))
        with pytest.raises(ValueError, match="'_user_emb' of 120 rows") as err:
            Trainer(cfg, _Flags(use_tpu=False, sparse_row_budget=100))
        assert str(err.value) == str(jerr.value)
        Trainer(cfg, _Flags(use_tpu=False, sparse_row_budget=120))
