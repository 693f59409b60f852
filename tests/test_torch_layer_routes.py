"""The layers' choice between the kernels and their eager computation.

``gated_recurrent``, ``lstmemory`` and ``full_attention`` call their
kernels when the ops module's ``supported()`` accepts the config and the
shapes, and otherwise run their own eager computation (a time loop over the
cell; the plain attention), counted in the ops module's ``EAGER_ROUTES``:
the port's counterpart of the JAX layers' ``lax.scan``/XLA branches. Here,
on the CPU: each ``supported()`` at its edges; a config it refuses takes the
eager route, counts it, and matches the JAX layer (loss and every gradient
of a small classifier, or the attention function's output and gradients);
a config it accepts goes to the fused op. Tolerances: loss 1e-5 relative,
gradients 1e-4 of max(1, max |JAX|) (float32 sums in another order).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.graph import GradientMachine as JaxMachine
from paddle_tpu.graph import make_ids as jax_make_ids
from paddle_tpu.graph import make_seq as jax_make_seq
from paddle_tpu.parallel.sequence_parallel import full_attention as jax_full_attention
from paddle_tpu_torch.bridge import params_from_numpy
from paddle_tpu_torch.graph import GradientMachine, make_ids, make_seq
from paddle_tpu_torch.layers import recurrent as port_recurrent
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import fused_gru as fg
from paddle_tpu_torch.ops import fused_lstm as fl
from paddle_tpu_torch.parallel import sequence_parallel as sp

torch.set_num_threads(1)
GRAD_TOL = 1e-4


def test_gru_supported_at_its_edges():
    B = 3                                   # the batch bounds the backward's grid
    for a in ("tanh", "sigmoid", "relu", "linear"):
        assert fg.supported((a, "sigmoid"), 8, B) and fg.supported(("tanh", a), 8, B)
    assert fg.supported(fg.KERNEL_ACTS, 1, B) and fg.supported(fg.KERNEL_ACTS, fg.MAX_H, B)
    assert not fg.supported(fg.KERNEL_ACTS, fg.MAX_H + 1, B)
    assert not fg.supported(fg.KERNEL_ACTS, 0, B)
    assert not fg.supported(("softmax", "sigmoid"), 8, B)
    assert not fg.supported(("tanh", "softmax"), 8, B)
    assert not fg.supported(("tanh", "sigmoid", "sigmoid"), 8, B)


H100_SMS = 132


@pytest.mark.parametrize("H", [512, 1024])
@pytest.mark.parametrize("B", [1, 64, 512])
def test_gru_backward_grid_holds_at_the_demo_widths(H, B):
    """Kernel 3's grid at 132 SMs takes H <= 1024 for every B <= 512, at
    every activation pair: w's rows in shared memory, dW's too where they
    fit beside the rows' state."""
    for a in fg.ACT_CODES:
        for b in fg.ACT_CODES:
            assert fg.supported((a, b), H, B, num_sms=H100_SMS)
    plan = fg.grid_plan(B, H, H100_SMS)
    assert plan["w_in_smem"] and plan["smem_bytes"] <= fg.SMEM_LIMIT
    assert plan["dw_in_smem"] == (not (H == 1024 and B == 512))


def test_gru_backward_main_path_plan():
    """T = 32, B = 64, H = 512: 128 blocks of 4 hidden units (one per SM),
    each holding its rows of w and dW (24,576 B each), the rows' state
    (5,120 B) and the cross-warp sums (8,192 B); two barriers a step."""
    assert fg.grid_plan(64, 512, H100_SMS) == dict(
        blocks=128, unit_groups_per_block=1, smem_bytes=62464, w_in_smem=1, dw_in_smem=1)
    assert fg.grid_barriers(32) == 64
    wide = fg.grid_plan(2, 2100, H100_SMS)           # four unit groups a block
    assert wide["unit_groups_per_block"] == 4 and not wide["w_in_smem"]


@pytest.mark.parametrize("H,B", [(0, 64), (512, 0), (fg.MAX_H + 1, 1), (1024, 4096),
                                 (fg.MAX_H, 512)])
def test_gru_gate_refuses_an_empty_dimension_or_what_cannot_fit(H, B):
    """An empty dimension; a width past MAX_H; the rows' state of too many
    rows (20 floats a row and unit group in shared memory)."""
    assert not fg.supported(fg.KERNEL_ACTS, H, B, num_sms=H100_SMS)


def test_nmt_encoder_takes_the_eager_route_where_the_gate_refuses(monkeypatch):
    """With fused_gru.supported refusing, the seqToseq encoder's two
    gated_recurrent layers (one per direction) run their eager loops,
    counted once each, and the loss (1e-5 relative) and every gradient
    (1e-4 of max(1, max |JAX|)) still match the JAX package."""
    import paddle_tpu.graph  # noqa: F401  (break the layers<->graph import cycle)
    from paddle_tpu.flagship import nmt_batch as jax_nmt_batch
    from paddle_tpu.flagship import nmt_config as jax_nmt_config
    from paddle_tpu_torch.flagship import nmt_batch, nmt_config

    tc = jax_nmt_config(vocab=50, dim=16, batch_size=4)
    jm = JaxMachine(tc.model_config)
    jparams = jm.init_params(seed=11)
    jloss, jgrads, _, _ = jm.grad_fn()(jparams, jax_nmt_batch(vocab=50, B=4, T=5),
                                       jax.random.PRNGKey(0))
    asked = []
    monkeypatch.setattr(fg, "supported", lambda *a, **k: asked.append(a) or False)
    calls = []
    orig = port_recurrent.fused_gru
    monkeypatch.setattr(port_recurrent, "fused_gru",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    before = fg.EAGER_ROUTES
    machine = GradientMachine(nmt_config(vocab=50, dim=16, batch_size=4).model_config,
                              device="cpu")
    loss, grads, _, _ = machine.grad_fn()(
        params_from_numpy({k: np.asarray(v) for k, v in jparams.items()}, "cpu"),
        nmt_batch(vocab=50, B=4, T=5, device="cpu"))
    assert asked == [(("tanh", "sigmoid"), 16, 4)] * 2      # (acts, H, B), each direction
    assert calls == [] and fg.EAGER_ROUTES == before + 2
    _assert_same((loss, grads), (jloss, jgrads))


def test_lstm_supported_at_its_edges():
    B = 3                                   # the batch bounds the backward's grid
    assert fl.supported(fl.DEFAULT_ACTS, 1, B) and fl.supported(fl.DEFAULT_ACTS, fl.MAX_H, B)
    assert fl.MAX_H == 1024 and not fl.supported(fl.DEFAULT_ACTS, fl.MAX_H + 1, B)
    assert not fl.supported(fl.DEFAULT_ACTS, 0, B)
    assert fl.supported(("relu", "linear", "tanh"), 16, B)
    assert not fl.supported(("tanh", "softmax", "tanh"), 16, B)
    assert not fl.supported(("tanh", "sigmoid"), 16, B)


@pytest.mark.parametrize("H", [512, 1024])
@pytest.mark.parametrize("B", [1, 256, 512])
def test_lstm_backward_grid_holds_at_the_demo_widths(H, B):
    """Kernel 8's grid at 132 SMs takes H <= 1024 for every B <= 512, at
    every activation triple: the rows' state in shared memory, w's and dW's
    rows there too where they fit (at H = 512 w's always do and dW's up to
    256 rows; at H = 1024 dW's never do, and w's only beside a few rows'
    state)."""
    for acts in itertools.product(fl.ACT_CODES, repeat=3):
        assert fl.supported(acts, H, B, num_sms=H100_SMS)
    plan = fl.grid_plan(B, H, H100_SMS)
    assert plan["smem_bytes"] <= fl.SMEM_LIMIT and plan["blocks"] <= H100_SMS
    assert plan["dw_in_smem"] == (H == 512 and B <= 256)
    assert plan["w_in_smem"] == (H == 512 or B == 1)


@pytest.mark.parametrize("H,B", [(0, 64), (512, 0), (fl.MAX_H + 1, 1), (1032, 256),
                                 (1024, 4096)])
def test_lstm_gate_refuses_an_empty_dimension_or_what_cannot_fit(H, B):
    """An empty dimension; a width past the forwards' MAX_H; the rows'
    state of too many rows (3 floats a row and unit in shared memory)."""
    assert not fl.supported(fl.DEFAULT_ACTS, H, B, num_sms=H100_SMS)


def test_lstm_backward_main_path_plan():
    """T = 64, B = 256, H = 512: two row groups of 64 blocks (128 in all),
    each block owning 8 units, 128 rows, its rows of w and dW (65,536 B
    each), the rows' state (12,288 B), the cross-warp sums (16,384 B), the
    peephole sums (3,072 B) and the ring that stages dx4's rows (65,536 B);
    one barrier a step and one over the grid. With one row group: 128
    blocks of 4 units and all 256 rows."""
    assert fl.grid_plan(256, 512, H100_SMS) == dict(
        blocks=128, row_groups=2, blocks_per_group=64, unit_groups_per_block=2,
        units_per_bundle=8, bundles=1, rows_per_group=128, smem_bytes=228352, w_in_smem=1,
        dw_in_smem=1)
    one = fl.grid_plan(256, 512, H100_SMS, row_groups=1)
    assert (one["blocks"], one["units_per_bundle"], one["rows_per_group"]) == (128, 4, 256)
    assert fl.grid_barriers(64, 2) == 65 and fl.grid_barriers(64, 1) == 64
    few = fl.grid_plan(3, 37, H100_SMS)               # a row group a row
    assert (few["row_groups"], few["rows_per_group"]) == (3, 1)


def test_lstm_forward_main_path_plan():
    """T = 64, B = 256, H = 512: four row groups of 32 blocks (128 in all),
    each block owning 4 unit groups (16 units, 4 quads) and 64 rows. QP = 2
    warps share each 16 rows (a warp: 16 rows x 2 quads on the tensor
    cores), so a pass covers 16 * 8 / 2 = 64 rows, and h is staged in
    chunks of 128 columns (64 x (2 x 128 + 4) > 12,800 floats). Shared
    memory: w's columns, 4 quads x (16 x 512 + 16) floats = 131,328 B; c
    and the carried h, 2 x 64 x 16 floats = 8,192 B; the ring, 2 slots of
    64 rows x (128 + 4) floats = 67,584 B; 207,104 B in all. 63 barriers a
    launch (one a step but after the last). With kernel 8's two row groups:
    8 units, 128 rows and 64 columns a chunk; with one: 4 units, 256 rows
    in two passes of 128."""
    assert fl.fwd_plan(256, 512, H100_SMS) == dict(
        blocks=128, row_groups=4, blocks_per_group=32, unit_groups_per_block=4,
        units_per_block=16, rows_per_group=64, rows_per_pass=64, chunk=128,
        smem_bytes=207104, w_in_smem=1, wslice_floats=32832)
    two = fl.fwd_plan(256, 512, H100_SMS, row_groups=2)
    assert (two["blocks"], two["units_per_block"], two["rows_per_group"], two["chunk"],
            two["smem_bytes"]) == (128, 8, 128, 64, 143488)
    one = fl.fwd_plan(256, 512, H100_SMS, row_groups=1)
    assert (one["blocks"], one["units_per_block"], one["rows_per_group"],
            one["rows_per_pass"], one["smem_bytes"]) == (128, 4, 256, 128, 110656)
    assert fl.fwd_barriers(64) == 63 and fl.fwd_barriers(1) == 0 and fl.fwd_barriers(0) == 0
    # the gate's edge at H = 1024: four unit groups a block leave no room for
    # w's columns, so kernel 8's single row group, w's columns in device memory
    wide = fl.fwd_plan(1536, 1024, H100_SMS)
    assert (wide["row_groups"], wide["units_per_block"], wide["w_in_smem"]) == (1, 8, 0)
    assert wide["smem_bytes"] == 4 * (2 * 1536 * 8 + 2 * 128 * 68)


def _lstm_grid_edge(H):
    """The largest B at which kernel 8's plan fits at 132 SMs (bisection)."""
    lo, hi = 1, 1 << 20
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if fl.grid_plan(mid, H, H100_SMS)["smem_bytes"] <= fl.SMEM_LIMIT:
            lo = mid
        else:
            hi = mid - 1
    return lo


@pytest.mark.parametrize("H", [1, 8, 37, 130, 512, 600, 1024])
def test_lstm_forward_plan_fits_wherever_the_backward_plan_does(H):
    """Every B up to kernel 8's edge at 132 SMs (or 8192 where it has none
    so low) and one past it: wherever grid_plan fits, fwd_plan fits (w's
    columns in device memory where they do not fit beside the rows' state),
    so supported() takes every (H, B) it took with kernel 8's plan alone."""
    edge = min(_lstm_grid_edge(H), 8192)
    for B in range(1, edge + 2):
        back = fl.grid_plan(B, H, H100_SMS)["smem_bytes"] <= fl.SMEM_LIMIT
        fwd = fl.fwd_plan(B, H, H100_SMS)
        assert fwd["smem_bytes"] <= fl.SMEM_LIMIT or not back, (H, B, fwd)
        assert fl.supported(fl.DEFAULT_ACTS, H, B, num_sms=H100_SMS) == back, (H, B)
    assert fl.supported(fl.DEFAULT_ACTS, H, edge, num_sms=H100_SMS)


@pytest.mark.parametrize("H,B_max", [(1024, 1536), (512, 3072), (256, 6144)])
def test_lstm_gate_keeps_its_edges_with_the_persistent_forwards(H, B_max):
    """fused_lstm.supported does not narrow with the forwards' grid: kernel
    8's edges at 132 SMs (PR 10) hold and one row past them is refused."""
    assert fl.supported(fl.DEFAULT_ACTS, H, B_max, num_sms=H100_SMS)
    assert not fl.supported(fl.DEFAULT_ACTS, H, B_max + 1, num_sms=H100_SMS)
    assert fl.fwd_plan(B_max, H, H100_SMS)["smem_bytes"] <= fl.SMEM_LIMIT


@pytest.mark.parametrize("sms,H", [(4, 256), (8, 512), (12, 768), (16, 1024)])
def test_lstm_gate_refuses_a_forward_block_past_64_units(sms, H):
    """On a card of few SMs a block of the forwards owns ceil(H / 4) /
    sms unit groups; past 16 of them (64 units, H > 64 * sms) a pass has
    no rows. supported() asks what _launch_fwd asks (fused_lstm._fwd_fits),
    so it refuses there although kernel 8's plan fits, and takes H = 64 *
    sms."""
    for B in (1, 64):
        assert fl.supported(fl.DEFAULT_ACTS, H, B, num_sms=sms)
        wider = fl.fwd_plan(B, H + 4, sms)
        assert wider["units_per_block"] > 64 and not fl._fwd_fits(wider, sms)
        assert fl.grid_plan(B, H + 4, sms)["smem_bytes"] <= fl.SMEM_LIMIT
        assert not fl.supported(fl.DEFAULT_ACTS, H + 4, B, num_sms=sms)


@pytest.mark.parametrize("H,B_max", [(1024, 1401), (2100, 700), (9685, 147)])
def test_gru_gate_keeps_its_edges_with_the_persistent_forward(H, B_max):
    """fused_gru.supported does not narrow with kernel 2's grid: kernel 3's
    edges at 132 SMs hold, one row past them is refused, and kernel 2's
    plan fits wherever the gate holds (w's columns in device memory where
    they do not fit beside the rows' state)."""
    assert fg.supported(fg.KERNEL_ACTS, H, B_max, num_sms=H100_SMS)
    assert not fg.supported(fg.KERNEL_ACTS, H, B_max + 1, num_sms=H100_SMS)
    for B in (1, B_max // 2, B_max):
        plan = fg.fwd_plan(B, H, H100_SMS)
        assert plan["smem_bytes"] <= fg.SMEM_LIMIT
        assert plan["blocks"] == fg.grid_plan(B, H, H100_SMS)["blocks"]
    assert fg.fwd_plan(64, 512, H100_SMS) == dict(
        blocks=128, unit_groups_per_block=1, smem_bytes=29696, w_in_smem=1)
    assert fg.fwd_barriers(32) == 63 and fg.fwd_barriers(0) == 0


@pytest.mark.parametrize("sms", [132, 114])              # H100 SXM and PCIe
@pytest.mark.parametrize("H", [256, 512, 1024, 2100, 9685])
def test_gru_forward_plan_fits_to_the_gate_edge(H, sms):
    """Kernels 1 and 2 run one plan (fwd_plan): for every B the gate takes,
    up to its edge, it fits a block (kernel 3's blocks and unit groups, the
    rows' state [B][20] of each group, w's columns [H][12] beside it where
    they fit, as gru_fwd.cu's fwd_smem_floats counts them); one row past
    the edge the gate refuses."""
    B = 1
    while fg.supported(fg.KERNEL_ACTS, H, B, num_sms=sms):
        plan, back = fg.fwd_plan(B, H, sms), fg.grid_plan(B, H, sms)
        gpb = plan["unit_groups_per_block"]
        assert (plan["blocks"], gpb) == (back["blocks"], back["unit_groups_per_block"])
        assert plan["smem_bytes"] == 4 * gpb * (12 * H * plan["w_in_smem"] + 20 * B)
        assert plan["smem_bytes"] <= fg.SMEM_LIMIT
        assert plan["w_in_smem"] == (4 * gpb * (12 * H + 20 * B) <= fg.SMEM_LIMIT)
        B += 1
    assert B > 64                                          # a full serve admission
    assert fg.grid_plan(B, H, sms)["smem_bytes"] > fg.SMEM_LIMIT


def test_lstmemory_asks_the_gate_with_the_batch(monkeypatch):
    """lstmemory asks fused_lstm.supported(acts, H, B) before anything
    runs, with the batch of its input."""
    asked = []
    orig = fl.supported
    monkeypatch.setattr(fl, "supported", lambda *a, **k: asked.append(a) or orig(*a, **k))
    cfg = _recurrent_net("paddle_tpu_torch", "lstm", 8, "relu", 5)
    rng = np.random.RandomState(4)
    ids = rng.randint(0, 20, (3, 5)).astype(np.int32)
    batch = {"words": make_seq(None, np.array([5, 3, 1], np.int32), ids=ids, device="cpu"),
             "label": make_ids(rng.randint(0, 2, (3,)).astype(np.int32), device="cpu")}
    m = GradientMachine(cfg.model_config, device="cpu")
    m.grad_fn()(m.init_params(seed=5), batch)
    assert asked == [(("relu", "sigmoid", "tanh"), 8, 3)]          # (acts, H, B)


def test_lstm_classifier_takes_the_eager_route_where_the_gate_refuses(monkeypatch):
    """With fused_lstm.supported refusing, the small LSTM classifier's
    lstmemory runs its eager loop, counted once, and the loss (1e-5
    relative) and every gradient (1e-4 of max(1, max |JAX|)) still match
    the JAX package."""
    monkeypatch.setattr(fl, "supported", lambda *a, **k: False)
    before = fl.EAGER_ROUTES
    jax_, port, fused_calls = _loss_and_grads("lstm", 8, "tanh", 5, monkeypatch)
    assert (fl.EAGER_ROUTES - before, fused_calls) == (1, 0)
    _assert_same(port, jax_)


def test_flash_supported_at_its_edges():
    assert fa.supported(1, 1, 1, 1) and fa.supported(8, 2048, 8, fa.MAX_D)
    assert fa.MAX_D == 256 and not fa.supported(1, 8, 1, fa.MAX_D + 1)
    assert not fa.supported(1, 8, 1, 0) and not fa.supported(1, 0, 1, 8)
    assert fa.supported(fa.MAX_GRID, 1, fa.MAX_GRID, 8)
    assert not fa.supported(fa.MAX_GRID + 1, 1, 1, 8)
    assert not fa.supported(1, 1, fa.MAX_GRID + 1, 8)
    assert not fa.supported(0, 1, 1, 8) and not fa.supported(1, 1, 0, 8)


def _recurrent_net(pkg, kind, size, act, T):
    """words -> embedding -> fc (the x-projection) -> grumemory/lstmemory ->
    max pool -> softmax fc, in either package's DSL."""
    import importlib

    tch = importlib.import_module(f"{pkg}.trainer_config_helpers")
    fresh_context = importlib.import_module(f"{pkg}.config.builder").fresh_context
    acts = {"relu": tch.ReluActivation, "softmax": tch.SoftmaxActivation,
            "tanh": tch.TanhActivation}
    with fresh_context() as ctx:
        tch.settings(batch_size=3, learning_rate=1e-2)
        words = tch.data_layer(name="words", size=20)
        emb = tch.embedding_layer(input=words, size=8)
        gates = 3 if kind == "gru" else 4
        proj = tch.fc_layer(input=emb, size=gates * size, act=tch.LinearActivation(),
                            bias_attr=False)
        rnn = (tch.grumemory if kind == "gru" else tch.lstmemory)(
            input=proj, act=acts[act](), name="rnn")
        pool = tch.pooling_layer(input=rnn, pooling_type=tch.MaxPooling())
        out = tch.fc_layer(input=pool, size=2, act=tch.SoftmaxActivation())
        label = tch.data_layer(name="label", size=2)
        tch.outputs(tch.classification_cost(input=out, label=label))
        return ctx.finalize()


def _loss_and_grads(kind, size, act, T, monkeypatch):
    """(loss, grads) of the JAX machine and of the port's, on one seeded
    ragged batch, and the number of calls of the port's fused op."""
    jcfg = _recurrent_net("paddle_tpu", kind, size, act, T)
    cfg = _recurrent_net("paddle_tpu_torch", kind, size, act, T)
    rng = np.random.RandomState(4)
    ids = rng.randint(0, 20, (3, T)).astype(np.int32)
    lengths = np.array([T, max(T - 2, 1), 1], np.int32)
    labels = rng.randint(0, 2, (3,)).astype(np.int32)
    jbatch = {"words": jax_make_seq(None, lengths, ids=ids), "label": jax_make_ids(labels)}
    batch = {"words": make_seq(None, lengths, ids=ids, device="cpu"),
             "label": make_ids(labels, device="cpu")}
    jm = JaxMachine(jcfg.model_config)
    jparams = jm.init_params(seed=5)
    jloss, jgrads, _, _ = jm.grad_fn()(jparams, jbatch, None)
    calls = []
    name = "fused_gru" if kind == "gru" else "fused_lstm"
    orig = getattr(port_recurrent, name)
    monkeypatch.setattr(port_recurrent, name, lambda *a, **k: calls.append(1) or orig(*a, **k))
    m = GradientMachine(cfg.model_config, device="cpu")
    params = params_from_numpy({k: np.asarray(v) for k, v in jparams.items()}, "cpu")
    loss, grads, _, _ = m.grad_fn()(params, batch)
    return (jloss, jgrads), (loss, grads), len(calls)


def _assert_same(port, jax_):
    (loss, grads), (jloss, jgrads) = port, jax_
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5, atol=1e-6)
    assert sorted(grads) == sorted(jgrads)
    for name in sorted(jgrads):
        want = np.asarray(jgrads[name])
        err = float(np.abs(grads[name].numpy() - want).max()) / max(1.0, float(np.abs(want).max()))
        assert err <= GRAD_TOL, (name, err)


@pytest.mark.parametrize("kind,size,act,T,eager", [
    ("gru", 8, "softmax", 5, True),      # an activation outside the kernels' four
    ("gru", 8, "relu", 5, False),        # relu: the kernels take it
    ("lstm", 1032, "tanh", 3, True),     # wider than the LSTM kernels' 1024
    ("lstm", 8, "relu", 5, False),
])
def test_recurrent_layer_routes_match_the_jax_layer(monkeypatch, kind, size, act, T, eager):
    """The route the config decides, counted, and the JAX layer's loss and
    gradients either way."""
    mod = fg if kind == "gru" else fl
    before = mod.EAGER_ROUTES
    jax_, port, fused_calls = _loss_and_grads(kind, size, act, T, monkeypatch)
    assert (mod.EAGER_ROUTES - before, fused_calls) == ((1, 0) if eager else (0, 1))
    _assert_same(port, jax_)


@pytest.mark.parametrize("causal", [False, True])
def test_full_attention_wider_than_the_kernels_takes_the_eager_route(monkeypatch, causal):
    """Head dim 264 (> MAX_D): full_attention never reaches the flash
    function, counts the eager route, and matches the JAX function's output
    and gradients at the rows that see a key."""
    B, T, H, D = 3, 24, 2, 264
    rng = np.random.RandomState(6)
    q, k, v = (rng.randn(B, T, H, D).astype(np.float32) for _ in range(3))
    cot = rng.randn(B, T, H, D).astype(np.float32)
    lens = np.array([T, 17, 1], np.int32)

    def jloss(q_, k_, v_):
        o = jax_full_attention(q_, k_, v_, lengths=jnp.asarray(lens), causal=causal)
        return jnp.sum(o * jnp.asarray(cot)), o

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    calls = []
    monkeypatch.setattr(sp, "flash_attention", lambda *a, **kw: calls.append(1))
    before = fa.EAGER_ROUTES
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = sp.full_attention(*leaves, lengths=torch.from_numpy(lens), causal=causal)
    assert calls == [] and fa.EAGER_ROUTES == before + 1
    assert not fa.supported(B, T, H, D)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=2e-5, rtol=0)
    for leaf, g, name in zip(leaves, jgrads, ("dq", "dk", "dv")):
        want = np.asarray(g)
        err = float(np.abs(leaf.grad.numpy() - want).max()) / max(1.0, float(np.abs(want).max()))
        assert err <= GRAD_TOL, (name, err)
