"""The port's seqToseq serving slice against the JAX package, on the CPU.

The tiny NMT generation model of the JAX engine tests
(``nmt_gen_config(vocab=50, dim=16, beam_size=1, max_length=8)``, slots=3,
prompt_tokens=4): both DSLs build the same config, JAX ``init_params(seed=1)``
crosses over through ``paddle_tpu_torch.bridge``, and then the prefill
capture, one decode step's probabilities (1e-5) and the engines' greedy
token streams (exactly) must agree.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
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
    prompts = [rng.randint(2, 50, size=rng.randint(1, T + 1)).tolist() for _ in range(8)]
    return dict(jtc=jtc, ttc=ttc, jm=jm, jp=jp, tm=tm, tp=tp, prompts=prompts)


def _feeds(prompts):
    from paddle_tpu.graph import make_seq as jax_seq
    from paddle_tpu_torch.graph import make_seq

    ids = np.zeros((len(prompts), T), np.int32)
    lens = np.zeros((len(prompts),), np.int32)
    for i, p in enumerate(prompts):
        ids[i, : len(p)] = p
        lens[i] = len(p)
    name = "source_language_word"
    return ({name: jax_seq(None, lens, ids=ids)},
            {name: make_seq(None, lens, ids=ids, device="cpu")})


def test_both_dsls_build_the_same_config(tiny):
    assert tiny["ttc"].to_json() == tiny["jtc"].to_json()
    assert sorted(tiny["tp"]) == sorted(tiny["jp"])


def _captures(tiny):
    from paddle_tpu.graph.decode_step import capture_prefill as jax_capture
    from paddle_tpu.graph.decode_step import plan_of as jax_plan_of
    from paddle_tpu_torch.graph.decode_step import capture_prefill, plan_of

    jfeed, tfeed = _feeds(tiny["prompts"][:4])
    jplan, _ = jax_plan_of(tiny["jm"])
    tplan, _ = plan_of(tiny["tm"])
    return (jplan, tplan, jax_capture(tiny["jm"], jplan, tiny["jp"], jfeed),
            capture_prefill(tiny["tm"], tplan, tiny["tp"], tfeed))


def test_capture_prefill_matches_jax(tiny):
    _, _, (jst, jboots), (tst, tboots) = _captures(tiny)
    assert sorted(jst) == sorted(tst)
    for name in jst:
        assert sorted(jst[name]) == sorted(tst[name])
        for f in jst[name]:
            np.testing.assert_allclose(tst[name][f].numpy(), np.asarray(jst[name][f]), **TOL)
    assert len(jboots) == len(tboots) == 1
    np.testing.assert_allclose(tboots[0].numpy(), np.asarray(jboots[0]), **TOL)


def test_one_step_probabilities_match_jax(tiny):
    import jax.numpy as jnp

    from paddle_tpu.graph.argument import Argument as JaxArgument
    from paddle_tpu.graph.decode_step import _static_args as jax_static_args
    from paddle_tpu.graph.recurrent_group import _run_submodel_step as jax_step
    from paddle_tpu.layers.base import LayerContext as JaxContext
    from paddle_tpu_torch.graph.argument import Argument
    from paddle_tpu_torch.graph.decode_step import _static_args
    from paddle_tpu_torch.graph.recurrent_group import _run_submodel_step
    from paddle_tpu_torch.layers.base import LayerContext

    jplan, tplan, (jst, jboots), (tst, tboots) = _captures(tiny)
    prev = np.array([0, 5, 17, 42], np.int32)
    mem = jplan.memories[0]
    jfed = dict(jax_static_args(jst))
    jfed[jplan.predict_agent] = JaxArgument(ids=jnp.asarray(prev))
    jfed[mem.link_name] = JaxArgument(value=jboots[0])
    jctx = JaxContext(params=tiny["jp"], model=tiny["jm"].model, pass_type="gen")
    ref = jax_step(tiny["jm"].network, jplan.sub, jctx, jfed, None)[jplan.score_layer].value
    tfed = dict(_static_args(tst))
    tfed[tplan.predict_agent] = Argument(ids=torch.from_numpy(prev))
    tfed[mem.link_name] = Argument(value=tboots[0])
    tctx = LayerContext(params=tiny["tp"], model=tiny["tm"].model, pass_type="gen")
    got = _run_submodel_step(tiny["tm"].network, tplan.sub, tctx, tfed)[tplan.score_layer].value
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("pipeline,fused", [(True, False), (False, False), (True, True)],
                         ids=["pipelined", "blocking", "fused"])
def test_engine_streams_equal_jax_engine(tiny, pipeline, fused):
    """More requests than slots, so admission and eviction interleave."""
    from paddle_tpu.serving.engine import Engine as JaxEngine
    from paddle_tpu.serving.jax_backend import JaxDecodeBackend
    from paddle_tpu_torch.serving.frontend import build_engine

    def run(engine):
        futs = [engine.submit(p, rid=f"g{i}") for i, p in enumerate(tiny["prompts"])]
        out = [f.result(timeout=120.0) for f in futs]
        assert engine.drain(timeout=60.0)
        assert all(r.outcome == "ok" and r.tokens for r in out)
        return [r.tokens for r in out]

    jax_engine = JaxEngine(JaxDecodeBackend(tiny["jm"], tiny["jp"], slots=SLOTS,
                                            prompt_tokens=T, pipeline=pipeline,
                                            fused_step=fused), pipeline=pipeline)
    ours = build_engine(tiny["tm"], tiny["tp"], slots=SLOTS, prompt_tokens=T,
                        pipeline=pipeline, fused_step=fused)
    assert run(ours.start()) == run(jax_engine.start())


def test_decode_block_and_budgets(tiny):
    """Several micro-steps per launch: budgets land exactly and the
    streams equal the one-step launches'."""
    from paddle_tpu_torch.serving.frontend import build_engine

    outs = {}
    for block in (1, 3):
        eng = build_engine(tiny["tm"], tiny["tp"], slots=2, prompt_tokens=T,
                           decode_block=block).start()
        futs = [eng.submit([5 + i, 9], max_new_tokens=1 + i, rid=f"r{i}")
                for i in range(4)]
        res = [f.result(timeout=120.0) for f in futs]
        assert eng.drain(timeout=60.0)
        assert [len(r.tokens) for r in res] == [1, 2, 3, 4]
        outs[block] = [r.tokens for r in res]
    assert outs[1] == outs[3]


def test_refusals_name_what_is_not_ported(tiny):
    from paddle_tpu_torch.graph import GradientMachine
    from paddle_tpu_torch.graph.decode_step import plan_fused_step, plan_of
    from paddle_tpu_torch.serving.torch_backend import (TorchDecodeBackend,
                                                        UnsupportedModelError)

    tm, tp = tiny["tm"], tiny["tp"]
    with pytest.raises(NotImplementedError, match="not ported yet"):
        TorchDecodeBackend(tm, tp, slots=2, prompt_tokens=T, slot_dtype="bf16")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        TorchDecodeBackend(tm, tp, slots=2, prompt_tokens=T, spec_tokens="2")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        GradientMachine(tiny["ttc"].model_config, device="cpu", compute_dtype="bfloat16")
    _, feed = _feeds(tiny["prompts"][:2])
    with pytest.raises(NotImplementedError, match="beam search"):
        tm.forward(tp, feed, pass_type="gen")
    # a step graph off the attention-GRU template is refused with the reason
    machine = GradientMachine(tiny["ttc"].model_config, device="cpu")
    plan, _ = plan_of(machine)
    machine.network.layer_map[plan.memories[0].layer_name].active_type = "relu"
    fp, why = plan_fused_step(machine, plan)
    assert fp is None and "activations" in why
    with pytest.raises(UnsupportedModelError, match="fused_step"):
        TorchDecodeBackend(machine, tp, slots=2, prompt_tokens=T, fused_step=True)
