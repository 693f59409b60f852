"""Speculative decode, bf16 slot state and hot reload of the port's serve
backend, against the JAX package's, on the CPU.

The tiny NMT generation model of ``tests/test_torch_serving.py``
(``nmt_gen_config(vocab=50, dim=16, beam_size=1, max_length=8)``, 3 slots,
4 prompt tokens), with the JAX package's ``init_params(seed=1)`` carried
across by ``paddle_tpu_torch.bridge``:

- the verify launch's streams equal plain decode's exactly, the port's and
  the JAX package's, for two speculation ladders and both scheduler loops;
- the verify loop's semantics through a scripted step: a draft that
  diverges at each position, a budget and an eos that land mid-draft
  (the cases of the JAX package's FakeBackend tests);
- bf16 slot storage within ``parity_tol`` of float32 storage and of the
  JAX package's bf16, speculation over it exact, its stored bytes under
  0.62x of float32's;
- the slot-dtype plans equal the JAX package's;
- a ``WeightReloader`` swap serves what a fresh engine on the new
  checkpoint serves.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
SLOTS, T = 3, 4


@pytest.fixture(scope="module")
def tiny():
    from paddle_tpu.flagship import nmt_gen_config as jax_config
    from paddle_tpu.graph import GradientMachine as JaxMachine
    from paddle_tpu_torch.bridge import params_from_numpy
    from paddle_tpu_torch.flagship import nmt_gen_config
    from paddle_tpu_torch.graph import GradientMachine

    kw = dict(vocab=50, dim=16, beam_size=1, max_length=8, batch_size=2)
    jtc, ttc = jax_config(**kw), nmt_gen_config(**kw)
    jm = JaxMachine(jtc.model_config)
    jp = jm.init_params(seed=1)
    tm = GradientMachine(ttc.model_config, device="cpu")
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    rng = np.random.RandomState(7)
    prompts = [rng.randint(2, 50, size=rng.randint(1, T + 1)).tolist() for _ in range(10)]
    return dict(jtc=jtc, ttc=ttc, jm=jm, jp=jp, tm=tm, tp=tp, prompts=prompts)


def _streams(engine, prompts):
    futs = [engine.submit(p, rid=f"g{i}") for i, p in enumerate(prompts)]
    out = [f.result(timeout=120.0) for f in futs]
    assert engine.drain(timeout=60.0)
    assert all(r.outcome == "ok" and r.tokens for r in out), [r.outcome for r in out]
    return [r.tokens for r in out]


def _port(tiny, **kw):
    from paddle_tpu_torch.serving.frontend import build_engine

    engine = build_engine(tiny["tm"], tiny["tp"], slots=SLOTS, prompt_tokens=T,
                          **kw).start()
    return _streams(engine, tiny["prompts"]), engine


def _jax(tiny, **kw):
    from paddle_tpu.serving.frontend import build_engine

    engine = build_engine(tiny["jm"], tiny["jp"], slots=SLOTS, prompt_tokens=T,
                          **kw).start()
    return _streams(engine, tiny["prompts"]), engine


@pytest.fixture(scope="module")
def plain(tiny):
    """Plain decode's streams, float32 and bf16 slots, in both packages."""
    return {"port": _port(tiny)[0], "jax": _jax(tiny)[0],
            "port_bf16": _port(tiny, slot_dtype="bf16")[0],
            "jax_bf16": _jax(tiny, slot_dtype="bf16")[0]}


@pytest.mark.parametrize("spec", ["2", "1,3"])
@pytest.mark.parametrize("pipeline", [True, False], ids=["pipelined", "blocking"])
def test_spec_streams_equal_plain_and_jax(tiny, plain, spec, pipeline):
    got, engine = _port(tiny, spec_tokens=spec, pipeline=pipeline)
    assert plain["port"] == plain["jax"]
    assert got == plain["port"]
    backend = engine._backend
    assert backend.spec_blocks == tuple(int(k) for k in spec.split(","))
    assert backend.verify_launches > len(backend.spec_blocks)   # beyond the warmup's


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_bf16_spec_equals_bf16_plain(tiny, plain, fused):
    got, engine = _port(tiny, spec_tokens="2", slot_dtype="bf16", fused_step=fused)
    assert got == plain["port_bf16"]
    assert engine._backend.slot_dtype == "bf16" and engine._backend.spec_blocks == (2,)


def _mismatches(a, b):
    flat_a = [t for r in a for t in r]
    flat_b = [t for r in b for t in r]
    assert len(flat_a) == len(flat_b)
    return sum(x != y for x, y in zip(flat_a, flat_b)), len(flat_a)


def test_bf16_slots_within_parity_tol_of_f32_and_of_jax(tiny, plain):
    from paddle_tpu_torch.graph.decode_step import SLOT_PARITY_TOL

    tol = SLOT_PARITY_TOL["bf16"]
    assert tol == 0.05
    # 0 of 67 tokens differ in either comparison at this width
    bad, n = _mismatches(plain["port_bf16"], plain["port"])
    assert bad <= tol * n, (bad, n)
    bad, n = _mismatches(plain["port_bf16"], plain["jax_bf16"])
    assert bad <= tol * n, (bad, n)


def test_bf16_slot_state_bytes(tiny):
    from paddle_tpu_torch.serving.torch_backend import TorchDecodeBackend

    f32 = TorchDecodeBackend(tiny["tm"], tiny["tp"], slots=SLOTS, prompt_tokens=T)
    bf16 = TorchDecodeBackend(tiny["tm"], tiny["tp"], slots=SLOTS, prompt_tokens=T,
                              slot_dtype="bf16")
    assert (f32.parity_tol, bf16.parity_tol) == (0.0, 0.05)
    assert bf16.slot_state_bytes() < 0.62 * f32.slot_state_bytes()
    floats = [t for d in bf16._state["statics"].values() for t in d.values()
              if t.is_floating_point()] + list(bf16._state["carries"])
    assert floats and all(t.dtype == torch.bfloat16 for t in floats)


def test_slot_dtype_plans_equal_jax(tiny):
    from paddle_tpu.graph.decode_step import plan_fused_step as jax_fused
    from paddle_tpu.graph.decode_step import plan_of as jax_plan_of
    from paddle_tpu.graph.decode_step import plan_slot_dtype as jax_slot
    from paddle_tpu_torch.graph.decode_step import plan_fused_step, plan_of, plan_slot_dtype

    jplan, _ = jax_plan_of(tiny["jm"])
    tplan, _ = plan_of(tiny["tm"])
    for dtype in ("f32", "bf16", "fp8"):
        assert plan_slot_dtype(dtype) == jax_slot(dtype)
        assert plan_fused_step(tiny["tm"], tplan, slot_dtype=dtype) == \
            jax_fused(tiny["jm"], jplan, slot_dtype=dtype)
    fp, why = plan_fused_step(tiny["tm"], tplan, slot_dtype="fp8")
    assert fp is None and "fp8" in why


# ------------------------------------ the verify loop through a scripted step

STREAM = (11, 12, 13)


def _scripted(tiny, stream=STREAM, slots=2, budgets=(8, 8)):
    """A backend whose step emits ``stream[i % 3]`` at a row's i-th step,
    counting the steps in the carry (finished rows freeze it and emit eos,
    as the real step does); the slots admitted with ``budgets``."""
    from paddle_tpu_torch.observability import serving as slog
    from paddle_tpu_torch.serving.torch_backend import TorchDecodeBackend

    be = TorchDecodeBackend(tiny["tm"], tiny["tp"], slots=slots, prompt_tokens=T,
                            spec_tokens="4")
    eos = be._plan.eos
    table = torch.tensor(stream)

    def step(params, statics, carries, prev_tok, finished):
        (h,) = carries
        i = h[:, 0].long()
        tok = torch.where(finished, torch.full_like(i, eos), table[i % len(stream)])
        keep = finished[:, None]
        return (torch.where(keep, h, h + 1),), tok, finished | (tok == eos)

    be._step = step
    reqs = [slog.Request(rid=f"r{b}", t_enqueue=0.0, prompt=[2]) for b in range(len(budgets))]
    be.admit(list(range(len(budgets))), reqs, list(budgets))
    be._state["carries"] = (torch.zeros_like(be._state["carries"][0]),)
    return be, eos


def _emitted(out, b):
    return [int(out.tokens[u, b]) for u in range(out.tokens.shape[0]) if out.live[u, b]]


def test_verify_full_accept_and_a_slot_without_draft(tiny):
    be, _ = _scripted(tiny)
    out = be.step(draft={0: [11, 12, 13, 11]})
    assert _emitted(out, 0) == [11, 12, 13, 11]         # K accepted
    assert _emitted(out, 1) == [11]                     # no draft: one plain step
    assert be.verify_launches == 1
    out = be.step(block=1)
    assert _emitted(out, 0) == [12] and _emitted(out, 1) == [12]


@pytest.mark.parametrize("pos", [0, 1, 2, 3])
def test_verify_divergence_at_each_draft_position(tiny, pos):
    """Slot 1's draft is wrong at ``pos``: it commits the ``pos`` accepted
    tokens and the model's correction, then stays frozen — its carry, its
    committed token and its budget untouched by the rest of the launch —
    while slot 0 accepts all four; the next plain step goes on from the
    correction."""
    be, _ = _scripted(tiny)
    want = [11, 12, 13, 11]
    draft = list(want)
    draft[pos] = 99
    out = be.step(draft={0: want, 1: draft})
    assert _emitted(out, 0) == want
    assert _emitted(out, 1) == want[:pos + 1]
    st = be._state
    assert st["carries"][0][:, 0].tolist() == [4, pos + 1]
    assert st["steps"].tolist() == [4, pos + 1]
    assert st["prev_tok"].tolist() == [want[3], want[pos]]
    assert st["finished"].tolist() == [False, False]
    out = be.step(block=1)
    assert _emitted(out, 0) == [STREAM[4 % 3]]
    assert _emitted(out, 1) == [STREAM[(pos + 1) % 3]]


def test_verify_budget_lands_mid_draft(tiny):
    be, _ = _scripted(tiny, slots=1, budgets=(2,))
    out = be.step(draft={0: [11, 12, 13, 11]})
    assert _emitted(out, 0) == [11, 12] and bool(out.finished[0])
    assert be._state["prev_tok"].tolist() == [12]


def test_verify_eos_mid_draft(tiny):
    from paddle_tpu_torch.serving.torch_backend import TorchDecodeBackend

    eos = TorchDecodeBackend(tiny["tm"], tiny["tp"], slots=1, prompt_tokens=T)._plan.eos
    be, _ = _scripted(tiny, stream=(11, eos, 13), slots=1, budgets=(8,))
    out = be.step(draft={0: [11, eos, 13]})
    assert _emitted(out, 0) == [11, eos] and bool(out.finished[0])
    assert be._state["steps"].tolist() == [2]


# --------------------------------------------------------------- hot reload


def test_weight_reloader_swap_equals_a_fresh_engine(tiny, tmp_path):
    """A checkpoint that lands in the watched dir after start is staged
    by ``WeightReloader`` and swapped at an iteration boundary: the
    requests in flight all finish, and every request after the swap gets
    what a fresh engine on the new checkpoint gives."""
    from paddle_tpu_torch import api
    from paddle_tpu_torch.serving.frontend import build_engine
    from paddle_tpu_torch.serving.resilience import WeightReloader
    from paddle_tpu_torch.trainer import checkpoint as ckpt

    new = api.GradientMachine(tiny["ttc"].model_config, seed=2, device="cpu")
    fresh = build_engine(tiny["tm"], new.params, slots=SLOTS, prompt_tokens=T).start()
    want = _streams(fresh, tiny["prompts"])

    engine = build_engine(tiny["tm"], tiny["tp"], slots=SLOTS, prompt_tokens=T).start()
    loader_gm = api.GradientMachine(tiny["ttc"].model_config, device="cpu")

    def load(path):
        loader_gm.loadParameters(path)
        return loader_gm.params

    watch = tmp_path / "ckpts"
    watch.mkdir()
    reloader = WeightReloader(str(watch), engine, load)
    before = [engine.submit(p, rid=f"pre{i}") for i, p in enumerate(tiny["prompts"][:4])]
    ckpt.save_checkpoint(str(watch), 1, new.params)
    assert reloader.check_once() is True
    after = [engine.submit(p, rid=f"post{i}") for i, p in enumerate(tiny["prompts"])]
    pre = [f.result(timeout=120.0) for f in before]
    post = [f.result(timeout=120.0) for f in after]
    assert engine.drain(timeout=60.0)
    assert all(r.outcome == "ok" and r.tokens for r in pre + post)
    assert [r.tokens for r in post] == want
    assert engine.status()["reloads"] == 1 and reloader.reloads == 1
    assert reloader.check_once() is False                      # no news
