"""The port's beam-search generation against the JAX package, on the CPU.

Every case runs the JAX package and the port on the same parameters (JAX
``init_params`` carried across with ``paddle_tpu_torch.bridge``) and the
same feed: the batched beam loop of ``graph/recurrent_group.py`` on the
tiny seqToseq model (``nmt_gen_config(vocab=50, dim=16, max_length=8)``)
at beam 1 and 3, on the generation configs of
``tests/test_recurrent_group.py`` and ``tests/test_nested_recurrent.py``
with their seeds, on those of ``tests/test_gen_seq_memory.py`` (a
sequence-valued memory) and ``tests/test_gen_nested_inlink.py`` (a nested
in-link) greedy and at beam 3, on probabilities that tie bit for bit, and on a batch
that finishes before ``max_length``; then ``api.SequenceGenerator``,
the greedy engines against it, and ``Trainer.generate``'s result file.
Ids and lengths must be equal; scores agree within 1e-5 (relative and
absolute, float32 sums of up to 8 log-probabilities in another order),
and against a numpy re-scoring within 2e-4 as the JAX test holds them.
"""

import copy
import os
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import api as jax_api
from paddle_tpu.config import parse_config as jax_parse_config
from paddle_tpu.flagship import nmt_gen_config as jax_nmt_gen_config
from paddle_tpu.graph import GradientMachine as JaxMachine
from paddle_tpu.graph import make_dense as jax_make_dense
from paddle_tpu.graph import make_seq as jax_make_seq
from paddle_tpu_torch import api
from paddle_tpu_torch.bridge import params_from_numpy
from paddle_tpu_torch.config import parse_config
from paddle_tpu_torch.flagship import nmt_gen_config
from paddle_tpu_torch.graph import Argument, GradientMachine, make_dense, make_seq
from paddle_tpu_torch.graph import recurrent_group as rg
from paddle_tpu_torch.observability import metrics as obs
from paddle_tpu_torch.observability.analyze import load_run
from paddle_tpu_torch.trainer import Trainer
from paddle_tpu_torch.trainer.trainer import read_result_file

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
GROUP = "decoder_group"
SRC = "source_language_word"
VOCAB, T = 50, 6


def _parse_both(tmp_path, text):
    path = tmp_path / "gen_conf.py"
    path.write_text(textwrap.dedent(text))
    return jax_parse_config(str(path)), parse_config(str(path))


def _machines(jtc, ttc, seed, edit=None):
    """The JAX machine and parameters, and the port's machine on the CPU with
    the same parameters (``edit`` changes the numpy parameters first)."""
    jm = JaxMachine(jtc.model_config)
    params = {k: np.array(v) for k, v in jm.init_params(seed=seed).items()}
    if edit is not None:
        edit(params)
    tm = GradientMachine(ttc.model_config, device="cpu")
    return jm, {k: jnp.asarray(v) for k, v in params.items()}, tm, params_from_numpy(params, "cpu")


def _generate_both(jtc, ttc, seed, jfeed, tfeed, edit=None):
    jm, jp, tm, tp = _machines(jtc, ttc, seed, edit)
    jout, _ = jm.forward(jp, jfeed, "gen")
    tout, _ = tm.forward(tp, tfeed, "gen")
    return jout, tout, jp


def _assert_same_generation(jout, tout, name):
    """The best beam's ids and length, and every beam's ids and length,
    equal; every beam's score within TOL."""
    np.testing.assert_array_equal(tout[name].ids.numpy(), np.asarray(jout[name].ids))
    np.testing.assert_array_equal(tout[name].seq_lengths.numpy(),
                                  np.asarray(jout[name].seq_lengths))
    jb, tb = jout[f"{name}@beams"], tout[f"{name}@beams"]
    np.testing.assert_array_equal(tb.ids.numpy(), np.asarray(jb.ids))
    np.testing.assert_array_equal(tb.sub_seq_lengths.numpy(), np.asarray(jb.sub_seq_lengths))
    np.testing.assert_array_equal(tb.seq_lengths.numpy(), np.asarray(jb.seq_lengths))
    np.testing.assert_allclose(tb.value.numpy(), np.asarray(jb.value), **TOL)


def _nmt_configs(beam_size, **kw):
    kw = dict(vocab=VOCAB, dim=16, beam_size=beam_size, max_length=8, batch_size=4, **kw)
    return jax_nmt_gen_config(**kw), nmt_gen_config(**kw)


def _prompt_feeds(n=4, seed=7):
    rng = np.random.RandomState(seed)
    ids = np.zeros((n, T), np.int32)
    lens = rng.randint(1, T + 1, n).astype(np.int32)
    for i in range(n):
        ids[i, : lens[i]] = rng.randint(2, VOCAB, lens[i])
    return ({SRC: jax_make_seq(None, lens, ids=ids)},
            {SRC: make_seq(None, lens, ids=ids, device="cpu")})


# ------------------------------------------------------------- the loop


@pytest.mark.parametrize("beam_size", [1, 3])
def test_nmt_generation_matches_jax(beam_size):
    jtc, ttc = _nmt_configs(beam_size)
    jfeed, tfeed = _prompt_feeds()
    jout, tout, _ = _generate_both(jtc, ttc, 1, jfeed, tfeed)
    _assert_same_generation(jout, tout, GROUP)
    assert tout[GROUP].ids.shape == (4, 8)
    assert tout[f"{GROUP}@beams"].ids.shape == (4, beam_size, 8)
    # the score layer's name is an alias of the best beam
    score_layer = next(s for s in ttc.model_config.sub_models if s.generator).out_links[0]
    assert tout[score_layer.layer_name] is tout[GROUP]


def test_top_k_matches_lax_top_k_among_ties():
    """The tie rule of top-K: jax.lax.top_k's order (descending, the lower
    index first among equals, -0.0 below +0.0), on rows full of ties."""
    rng = np.random.RandomState(0)
    pool = np.array([0.0, -0.0, 1.0, -1.0, 2.5, -1e30, np.inf, -np.inf], np.float32)
    for _ in range(100):
        n = rng.randint(1, 40)
        k = rng.randint(1, n + 1)
        x = rng.choice(pool, size=(3, n))
        x = np.where(rng.rand(3, n) < 0.3, rng.randn(3, n), x).astype(np.float32)
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = rg._top_k_lower_index_first(torch.from_numpy(x), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy().view(np.int32), np.asarray(jv).view(np.int32))


def test_expand_beams_repeats_each_row_in_place():
    arg = make_seq(np.arange(6, dtype=np.float32).reshape(2, 3, 1), [3, 1], device="cpu")
    ex = rg._expand_beams(arg, 2)
    np.testing.assert_array_equal(ex.value[:, :, 0].numpy(),
                                  [[0, 1, 2], [0, 1, 2], [3, 4, 5], [3, 4, 5]])
    np.testing.assert_array_equal(ex.seq_lengths.numpy(), [3, 3, 1, 1])


# the generation configs of tests/test_recurrent_group.py, as written there
BEAM_GEN = """
from paddle.trainer_config_helpers import *
settings(batch_size=4, learning_rate=1e-3)
src = data_layer(name="src", size=10)
src_emb = embedding_layer(input=src, size=6, param_attr=ParamAttr(name="emb"))
enc = simple_gru(input=src_emb, size=6, name="encoder")
enc_last = last_seq(input=enc, name="enc_last")

def gen_step(enc_l, cur_emb):
    mem = memory(name="dec", size=6, boot_layer=enc_l)
    inp = mixed_layer(size=18, input=[full_matrix_projection(cur_emb)],
                      name="dec_in")
    step = gru_step_layer(input=inp, output_mem=mem, size=6, name="dec")
    return fc_layer(input=step, size=10, act=SoftmaxActivation(), name="scores")

gen = beam_search(step=gen_step,
                  input=[StaticInput(enc_last),
                         GeneratedInput(size=10, embedding_name="emb",
                                        embedding_size=6)],
                  bos_id=0, eos_id=1, beam_size=3, max_length=7,
                  name="generator")
"""

GREEDY_GEN = """
from paddle.trainer_config_helpers import *
settings(batch_size=4, learning_rate=1e-3)
boot = data_layer(name="boot", size=5)

def gen_step(b, cur_emb):
    mem = memory(name="dec", size=5, boot_layer=b)
    inp = mixed_layer(size=15, input=[full_matrix_projection(cur_emb, param_attr=ParamAttr(name="w_x"))],
                      name="dec_in", bias_attr=False)
    step = gru_step_layer(input=inp, output_mem=mem, size=5, name="dec",
                          param_attr=ParamAttr(name="w_g"), bias_attr=False)
    return fc_layer(input=step, size=8, act=SoftmaxActivation(), name="scores",
                    param_attr=ParamAttr(name="w_s"), bias_attr=False)

gen = beam_search(step=gen_step,
                  input=[StaticInput(boot),
                         GeneratedInput(size=8, embedding_name="gen_emb",
                                        embedding_size=6)],
                  bos_id=0, eos_id=1, beam_size=1, max_length=5,
                  name="generator")
"""

RESCORE_V, RESCORE_E, RESCORE_EOS = 7, 4, 6
# a memoryless step: the scores depend only on the previous token
MEMORYLESS_GEN = f"""
from paddle.trainer_config_helpers import *
settings(batch_size=4, learning_rate=1e-3)
boot = data_layer(name="boot", size={RESCORE_E})

def gen_step(b, cur_emb):
    h = mixed_layer(size={RESCORE_E}, name="h", bias_attr=False,
                    input=[full_matrix_projection(cur_emb, param_attr=ParamAttr(name="wx"))])
    comb = addto_layer(input=[h, b], act=TanhActivation(), bias_attr=False)
    return fc_layer(input=comb, size={RESCORE_V}, act=SoftmaxActivation(), name="scores")

gen = beam_search(step=gen_step,
                  input=[StaticInput(boot),
                         GeneratedInput(size={RESCORE_V}, embedding_name="Tg",
                                        embedding_size={RESCORE_E})],
                  bos_id=0, eos_id={RESCORE_EOS}, beam_size=3, max_length={{max_length}},
                  name="generator")
"""


def _boot_feeds(boot):
    return {"boot": jax_make_dense(boot)}, {"boot": make_dense(boot, device="cpu")}


def _case_beam():
    src_ids = np.array([[2, 3, 4, 0], [5, 6, 0, 0]], np.int32)
    lens = np.array([3, 2], np.int32)
    return BEAM_GEN, 6, ({"src": jax_make_seq(None, lens, ids=src_ids)},
                         {"src": make_seq(None, lens, ids=src_ids, device="cpu")})


def _case_greedy():
    return GREEDY_GEN, 9, _boot_feeds(np.random.RandomState(1).randn(2, 5).astype(np.float32))


def _case_rescore():
    boot = np.random.RandomState(2).randn(2, RESCORE_E).astype(np.float32) * 1.5
    return MEMORYLESS_GEN.replace("{max_length}", "5"), 8, _boot_feeds(boot)


@pytest.mark.parametrize("case", [_case_beam, _case_greedy, _case_rescore],
                         ids=["beam_search", "greedy_rollout", "rescore"])
def test_recurrent_group_generation_matches_jax(tmp_path, case):
    text, seed, (jfeed, tfeed) = case()
    jtc, ttc = _parse_both(tmp_path, text)
    jout, tout, _ = _generate_both(jtc, ttc, seed, jfeed, tfeed)
    _assert_same_generation(jout, tout, "generator")


def _np_softmax(x):
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


def test_beam_scores_rescore_exactly(tmp_path):
    """Every beam's reported cumulative log-prob equals a numpy re-scoring
    of its tokens under the model (the bookkeeping of reindexing and
    freezing), within 2e-4 as the JAX package's test holds it."""
    text, seed, (_, tfeed) = _case_rescore()
    ttc = parse_config(_write(tmp_path, text))
    tm = GradientMachine(ttc.model_config, device="cpu")
    params = tm.init_params(seed=seed)
    out, _ = tm.forward(params, tfeed, "gen")
    beams = out["generator@beams"]
    ids, scores, lens = (beams.ids.numpy(), beams.value.numpy(), beams.sub_seq_lengths.numpy())
    boot = tfeed["boot"].value.numpy()
    Tg, Wx = params["Tg"].numpy(), params["wx"].numpy()
    W, bias = params["_scores.w0"].numpy(), params["_scores.wbias"].numpy().reshape(-1)
    for b in range(ids.shape[0]):
        for k in range(ids.shape[1]):
            assert lens[b, k] > 0
            prev, total = 0, 0.0
            for t in range(int(lens[b, k])):
                tok = int(ids[b, k, t])
                p = _np_softmax(np.tanh(Tg[prev] @ Wx + boot[b]) @ W + bias)
                total += np.log(max(p[tok], 1e-20))
                prev = tok
            np.testing.assert_allclose(total, scores[b, k], rtol=2e-4, atol=2e-4,
                                       err_msg=f"{b},{k}")


def test_greedy_generation_matches_manual_rollout(tmp_path):
    """beam_size=1 equals an argmax rollout computed step by step in numpy."""
    text, seed, (_, tfeed) = _case_greedy()
    ttc = parse_config(_write(tmp_path, text))
    tm = GradientMachine(ttc.model_config, device="cpu")
    params = tm.init_params(seed=seed)
    got = tm.forward(params, tfeed, "gen")[0]["generator"].ids.numpy()
    p = {k: v.numpy() for k, v in params.items()}
    w_x, w_g, w_s = p["w_x"].reshape(6, 15), p["w_g"].reshape(5, 15), p["w_s"].reshape(5, 8)
    sigmoid = lambda v: 1 / (1 + np.exp(-v))
    h = tfeed["boot"].value.numpy().copy()
    tok = np.zeros((2,), np.int64)
    done = np.zeros((2,), bool)
    expect = []
    for _ in range(5):
        x3 = p["gen_emb"][tok] @ w_x
        g = x3[:, :10] + h @ w_g[:, :10]
        u, r = sigmoid(g[:, :5]), sigmoid(g[:, 5:10])
        cand = np.tanh(x3[:, 10:] + (r * h) @ w_g[:, 10:])
        h = np.where(done[:, None], h, u * h + (1 - u) * cand)
        nxt = np.where(done, 1, np.argmax(_np_softmax(h @ w_s), axis=1))
        expect.append(nxt)
        done = done | (nxt == 1)
        tok = nxt
    np.testing.assert_array_equal(got, np.stack(expect, axis=1))


def _write(tmp_path, text):
    path = tmp_path / "gen_conf.py"
    path.write_text(textwrap.dedent(text))
    return str(path)


# the flat in-link generation config of tests/test_nested_recurrent.py
GEN_INLINK = """
from paddle.trainer_config_helpers import *
settings(batch_size=4, learning_rate=1e-3)
src = data_layer(name="src", size=11)
def gen_step(x_t, prev):
    e = embedding_layer(input=x_t, size=7, name="src_emb",
                        param_attr=ParamAttr(name="Tsrc"))
    h = concat_layer(input=[e, prev], name="h")
    return fc_layer(input=h, size=9, act=SoftmaxActivation(), name="scorer")
out = beam_search(step=gen_step,
                  input=[src, GeneratedInput(size=9, embedding_name="Tgen",
                                             embedding_size=7)],
                  bos_id=0, eos_id=8, beam_size={beam_size}, max_length=8, name="gen")
"""


@pytest.mark.parametrize("beam_size", [1, 3])
@pytest.mark.parametrize("seed,data_seed,lens", [(7, 2, [5, 3, 4]), (8, 6, [4, 0])],
                         ids=["ragged", "an_empty_sequence"])
def test_generation_consumes_input_frames(tmp_path, beam_size, seed, data_seed, lens):
    """A flat sequence in-link: one input frame a generated token, each
    sample bounded by its own length (an empty one generates nothing)."""
    lens = np.array(lens, np.int32)
    src = np.random.RandomState(data_seed).randint(0, 11, (len(lens), 5)).astype(np.int32)
    jtc, ttc = _parse_both(tmp_path, GEN_INLINK.format(beam_size=beam_size))
    jout, tout, _ = _generate_both(jtc, ttc, seed, {"src": jax_make_seq(None, lens, ids=src)},
                                   {"src": make_seq(None, lens, ids=src, device="cpu")})
    _assert_same_generation(jout, tout, "gen")
    got_lens = tout["gen"].seq_lengths.numpy()
    assert (got_lens <= np.minimum(lens, 8)).all()
    assert ((got_lens == 0) == (lens == 0)).all()


TIE_V, TIE_EOS, TIED = 6, 5, (1, 2, 3, 4)


def _tie_params(params):
    """Vocabulary columns 1-4 of the output layer all zero, their bias 0:
    their logits are +-0 on every row, whatever the summation order, so
    their probabilities tie bit for bit. The other columns sit ~3 lower,
    eos ~6, so the tied four lead every beam and no beam ends."""
    w = params["_scores.w0"]
    w *= 0.25
    w[:, list(TIED)] = 0.0
    bias = np.full(params["_scores.wbias"].shape, -3.0, np.float32)
    bias.reshape(-1)[list(TIED)] = 0.0
    bias.reshape(-1)[TIE_EOS] = -6.0
    params["_scores.wbias"] = bias


def test_exact_ties_pick_the_lower_index_first(tmp_path):
    """Probabilities that tie bit for bit, four candidates of a beam for
    three places, and across beams (the same cumulative score): the port
    picks the JAX package's beams, the lower flat index first."""
    text = MEMORYLESS_GEN.replace("{max_length}", "4").replace(
        f"size={RESCORE_V}", f"size={TIE_V}").replace(
        f"eos_id={RESCORE_EOS}", f"eos_id={TIE_EOS}")
    boot = np.random.RandomState(3).randn(3, RESCORE_E).astype(np.float32)
    jtc, ttc = _parse_both(tmp_path, text)
    jfeed, tfeed = _boot_feeds(boot)
    jout, tout, _ = _generate_both(jtc, ttc, 5, jfeed, tfeed, edit=_tie_params)
    _assert_same_generation(jout, tout, "generator")
    beams = tout["generator@beams"]
    scores, ids = beams.value.numpy(), beams.ids.numpy()
    # the tie is real: the three beams differ only in their last token
    # (1, 2, 3 of the tied 1-4) and score the same bits
    assert (scores[:, 0] == scores[:, 1]).all() and (scores[:, 1] == scores[:, 2]).all()
    np.testing.assert_array_equal(ids[:, :, -1], np.tile([1, 2, 3], (3, 1)))
    np.testing.assert_array_equal(ids[:, 0, :-1], ids[:, 1, :-1])
    np.testing.assert_array_equal(ids[:, 0, :-1], ids[:, 2, :-1])


def test_beam1_takes_the_lower_index_where_float32_totals_tie(tmp_path):
    """Beam 1 is not argmax decoding in float32: it takes the top-1 of
    cum + logp, and once |cum| is large, two candidates whose logps differ
    by less than cum's float32 spacing tie there and the lower index wins.
    Here token 2's logit sits 1e-6 above token 1's at every step (both
    columns zero, the bias alone), so argmax picks 2 every step; beam 1
    picks 2 while cum is small, then 1, in the JAX package as in the port.
    Whether a given step's totals round together depends on their last
    bits, which differ between the packages' softmaxes, so the step at
    which each turns to 1 is not compared."""
    V, eos = 64, 63
    text = MEMORYLESS_GEN.replace("{max_length}", "12").replace(
        f"size={RESCORE_V}", f"size={V}").replace(
        f"eos_id={RESCORE_EOS}", f"eos_id={eos}").replace("beam_size=3", "beam_size=1")

    def near_tie(params):
        params["_scores.w0"] *= 0.01
        params["_scores.w0"][:, [1, 2]] = 0.0
        bias = np.zeros(params["_scores.wbias"].shape, np.float32)
        bias.reshape(-1)[1] = 0.5
        bias.reshape(-1)[2] = np.float32(0.5) + np.float32(1e-6)
        bias.reshape(-1)[eos] = -5.0
        params["_scores.wbias"] = bias

    boot = np.random.RandomState(5).randn(2, RESCORE_E).astype(np.float32)
    jtc, ttc = _parse_both(tmp_path, text)
    jfeed, tfeed = _boot_feeds(boot)
    jout, tout, _ = _generate_both(jtc, ttc, 2, jfeed, tfeed, edit=near_tie)
    for ids in (np.asarray(jout["generator"].ids), tout["generator"].ids.numpy()):
        for row in ids.tolist():
            assert row[0] == 2 and 1 in row, row          # argmax would give all 2s
            assert set(row) == {1, 2} and row.index(1) >= 2, row


def test_generation_stops_when_every_beam_has_finished(tmp_path):
    """eos leads every beam: the loop stops before max_length, and the
    history past the last step stays 0, as the JAX while_loop leaves it."""
    text = MEMORYLESS_GEN.replace("{max_length}", "8")
    boot = np.random.RandomState(4).randn(2, RESCORE_E).astype(np.float32)

    def eos_likely(params):
        params["_scores.wbias"].reshape(-1)[RESCORE_EOS] = 4.0

    jtc, ttc = _parse_both(tmp_path, text)
    jfeed, tfeed = _boot_feeds(boot)
    before = rg.BEAM_STEPS
    jout, tout, _ = _generate_both(jtc, ttc, 8, jfeed, tfeed, edit=eos_likely)
    steps = rg.BEAM_STEPS - before
    _assert_same_generation(jout, tout, "generator")
    beams = tout["generator@beams"]
    assert 1 <= steps < 8
    assert int(beams.sub_seq_lengths.max()) <= steps
    assert not beams.ids[:, :, steps:].any()
    assert (beams.ids[:, :, steps - 1] == RESCORE_EOS).all()


# ------------------------------------------------------ SequenceGenerator


def _api_machines(beam_size=3, **kw):
    """The JAX and port api.GradientMachine of the tiny NMT generation
    model, on the same parameters."""
    jtc, ttc = _nmt_configs(beam_size, **kw)
    jm = jax_api.GradientMachine(jtc.model_config)
    tm = api.GradientMachine(ttc.model_config, device="cpu")
    tm.params = params_from_numpy({k: np.asarray(v) for k, v in jm.params.items()}, "cpu")
    return jm, tm, ttc


def _assert_same_results(jres, tres):
    assert len(jres) == len(tres)
    for js, ts in zip(jres, tres):
        assert [e["ids"] for e in ts] == [e["ids"] for e in js]
        assert [e.get("words") for e in ts] == [e.get("words") for e in js]
        np.testing.assert_allclose([e["score"] for e in ts], [e["score"] for e in js], **TOL)
        scores = [e["score"] for e in ts]
        assert scores == sorted(scores, reverse=True)          # best first


def test_sequence_generator_matches_jax(tmp_path):
    words = tmp_path / "dict.txt"
    words.write_text("".join(f"w{i}\n" for i in range(VOCAB - 5)))   # ids past it: <unk>
    jm, tm, _ = _api_machines()
    jfeed, tfeed = _prompt_feeds(n=5, seed=11)
    jres = jm.asSequenceGenerator(dict_file=str(words)).generate(jfeed)
    tres = tm.asSequenceGenerator(dict_file=str(words)).generate(tfeed)
    _assert_same_results(jres, tres)
    assert all(len(s) == 3 for s in tres)


def test_sequence_generator_overrides_leave_the_machine_config_untouched():
    jm, tm, ttc = _api_machines()
    before = ttc.model_config.to_json()
    jfeed, tfeed = _prompt_feeds(seed=12)
    kw = dict(beam_size=2, max_length=5, begin_token=3, end_token=4)
    tres = tm.asSequenceGenerator(**kw).generate(tfeed)
    _assert_same_results(jm.asSequenceGenerator(**kw).generate(jfeed), tres)
    assert ttc.model_config.to_json() == before
    assert all(len(s) == 2 for s in tres)
    assert all(len(e["ids"]) <= 5 for s in tres for e in s)
    # the machine's own generator still runs the config's beam 3, length 8
    plain = tm.asSequenceGenerator().generate(tfeed)
    assert all(len(s) == 3 for s in plain)
    _assert_same_results(jm.asSequenceGenerator().generate(jfeed), plain)


@pytest.fixture
def telemetry(tmp_path):
    obs.registry().reset()
    obs.configure(str(tmp_path))
    yield str(tmp_path)
    obs.configure("")


def _requests(run_dir):
    recs = [r for recs in load_run(run_dir).values() for r in recs]
    for rec in recs:
        assert not obs.validate_record(rec), (rec, obs.validate_record(rec))
    return [r for r in recs if r["kind"] == "request"]


def test_sequence_generator_emits_request_records(telemetry, monkeypatch):
    """One request record per sample and call, as the JAX package's
    ``SequenceGenerator`` writes them: ``cold_start`` on the first call of
    a feed signature, a new cohort per call, error records when the
    forward raises."""
    _, tm, _ = _api_machines(beam_size=2)
    gen = tm.asSequenceGenerator()
    _, feed = _prompt_feeds(n=2, seed=13)
    results = gen.generate(feed)
    obs.flush()
    assert len(results) == 2
    reqs = _requests(telemetry)
    assert len(reqs) == 2
    for r in reqs:
        assert r["outcome"] == "ok" and r["cohort_size"] == 2 and r["beam_size"] == 2
        assert r["prompt_tokens"] >= 1 and r["gen_tokens"] >= 1 and r["e2e_s"] > 0
        assert r["cold_start"] is True
    assert len({r["cohort"] for r in reqs}) == 1
    gen.generate(feed)
    obs.flush()
    reqs2 = _requests(telemetry)
    assert len({r["cohort"] for r in reqs2}) == 2
    warm = [r for r in reqs2 if r["id"] not in {x["id"] for x in reqs}]
    assert len(warm) == 2 and all("cold_start" not in r for r in warm)
    # another feed signature pays a first call again
    _, feed3 = _prompt_feeds(n=3, seed=14)
    gen.generate(feed3)
    obs.flush()
    new = [r for r in _requests(telemetry) if r["cohort_size"] == 3]
    assert len(new) == 3 and all(r["cold_start"] is True for r in new)

    def boom(*args, **kwargs):
        raise RuntimeError("boom")

    monkeypatch.setattr(gen._core, "forward", boom)
    with pytest.raises(RuntimeError, match="boom"):
        gen.generate(feed)
    obs.flush()
    errs = [r for r in _requests(telemetry) if r["outcome"] == "error"]
    assert len(errs) == 2


@pytest.mark.parametrize("pipeline,fused", [(True, False), (False, False), (True, True)],
                         ids=["pipelined", "blocking", "fused"])
def test_engine_matches_sequence_generator_golden(pipeline, fused):
    """The port's greedy engine streams equal its SequenceGenerator at beam 1,
    token for token (tests/test_engine.py's golden test): pipelined,
    blocking and the fused decode step."""
    tc = nmt_gen_config(vocab=VOCAB, dim=16, beam_size=1, max_length=8, batch_size=2)
    am = api.GradientMachine(tc.model_config, device="cpu")
    rng = np.random.RandomState(7)
    prompts = [rng.randint(2, VOCAB, size=rng.randint(1, 5)).astype(np.int32)
               for _ in range(4)]
    Tp = 4
    ids = np.zeros((4, Tp), np.int32)
    lens = np.zeros((4,), np.int32)
    for i, p in enumerate(prompts):
        ids[i, : len(p)] = p
        lens[i] = len(p)
    golden = [r[0]["ids"] for r in am.asSequenceGenerator().generate(
        {SRC: make_seq(None, lens, ids=ids, device="cpu")})]
    eng = am.asDecodeEngine(slots=3, prompt_tokens=Tp, pipeline=pipeline,
                            fused_step=fused).start()
    futs = [eng.submit(p.tolist(), rid=f"g{i}") for i, p in enumerate(prompts)]
    out = [f.result(timeout=120.0).tokens for f in futs]
    assert eng.drain(timeout=60.0)
    assert out == golden


# ---------------------------------------------------------- the Trainer


def test_trainer_generate_writes_the_reference_result_file(tmp_path):
    jm, _, ttc = _api_machines()
    ttc = copy.deepcopy(ttc)
    next(s for s in ttc.model_config.sub_models if s.generator).generator \
        .num_results_per_sample = 2
    trainer = Trainer(ttc, device="cpu")
    trainer.params = params_from_numpy({k: np.asarray(v) for k, v in jm.params.items()}, "cpu")
    feeds = [_prompt_feeds(n=3, seed=s) for s in (15, 16)]
    path = str(tmp_path / "gen_result.txt")
    returned = trainer.generate_batches([t for _, t in feeds], result_file=path)
    blocks = read_result_file(path)
    jres = [s for j, _ in feeds for s in jm.asSequenceGenerator().generate(j)]
    assert [idx for idx, _ in blocks] == [str(i) for i in range(6)]
    for (_, beams), want in zip(blocks, jres):
        assert len(beams) == 2
        assert [ids for _, ids in beams] == [e["ids"] for e in want[:2]]
        np.testing.assert_allclose([s for s, _ in beams], [e["score"] for e in want[:2]],
                                   **TOL)
    assert len(returned) == 2
    best_ids, beam_ids, scores, lens = returned[0]
    assert beam_ids.shape == (3, 3, 8) and scores.shape == (3, 3) and lens.shape == (3, 3)
    for b in range(3):
        assert best_ids[b, : lens[b, 0]].tolist() == jres[b][0]["ids"]


# ------------------------------------------------ the card-vs-CPU check


def test_beam_parity_catches_a_loop_that_skips_the_best_candidate(monkeypatch):
    """beam_parity, the check that holds the card's beam search to the
    CPU's, at nmt_gen_spread_params' weights: a machine passes against
    itself, and one whose top-K skips the best candidate from the fourth
    step on fails at that step (not a near tie)."""
    from paddle_tpu_torch.flagship import nmt_gen_batch, nmt_gen_spread_params
    from paddle_tpu_torch.tools.beam_parity import beam_parity

    tc = nmt_gen_config(vocab=300, dim=64, beam_size=3, max_length=12, batch_size=8)
    base = api.GradientMachine(tc.model_config, device="cpu")
    machine = api.GradientMachine(tc.model_config, device="cpu",
                                  params=nmt_gen_spread_params(base.params, tc.model_config))
    feed = nmt_gen_batch(vocab=300, B=8, T=10, seed=3, device="cpu")
    assert beam_parity(machine, machine, feed, feed, 12, 1e-4) == ([], [], 0.0)

    good, calls = rg._top_k_lower_index_first, [0]

    def skip_best_from_step_3(flat, k):
        calls[0] += 1
        if calls[0] <= 3:
            return good(flat, k)
        values, idx = good(flat, k + 1)
        return values[..., 1:], idx[..., 1:]

    class Mutated:
        def asSequenceGenerator(self, **kw):
            gen = machine.asSequenceGenerator(**kw)

            class Gen:
                def generate(self, in_args):
                    calls[0] = 0
                    with monkeypatch.context() as m:
                        m.setattr(rg, "_top_k_lower_index_first", skip_best_from_step_3)
                        return gen.generate(in_args)
            return Gen()

    with pytest.raises(AssertionError, match="not a near tie") as err:
        beam_parity(Mutated(), machine, feed, feed, 12, 1e-4)
    assert err.value.args[0][2] == 3                # the first step it skipped


# ------------------------------- nested in-links and sequence memories

# tests/test_gen_seq_memory.py's config: the step adds the fed-back word's
# embedding to a carried SEQUENCE (memory(is_seq=True)) and scores the
# next word from its average
GEN_SEQ_MEM = """
from paddle.trainer_config_helpers import *
settings(batch_size=4, learning_rate=1e-3)
boot = data_layer(name="boot", size=6)
def gen_step(prev_word):
    mem = memory(name="accseq", size=6, is_seq=True, boot_layer=boot)
    exp = expand_layer(input=prev_word, expand_as=mem)
    acc = addto_layer(input=[exp, mem], name="accseq", act=LinearActivation(),
                      bias_attr=False)
    pooled = pooling_layer(input=acc, pooling_type=AvgPooling())
    return fc_layer(input=pooled, size=9, act=SoftmaxActivation(), name="scorer")
out = beam_search(step=gen_step,
                  input=[GeneratedInput(size=9, embedding_name="Tgen",
                                        embedding_size=6)],
                  bos_id=0, eos_id=8, beam_size=1, max_length=7, name="gen")
"""

# tests/test_gen_nested_inlink.py's config: each generated step reads one
# whole sub-sequence of a nested in-link
GEN_NESTED = """
from paddle.trainer_config_helpers import *
settings(batch_size=4, learning_rate=1e-3)
ctxt = data_layer(name="ctxt", size=5)
def gen_step(prev_emb, sub_ctx):
    pooled = pooling_layer(input=sub_ctx, pooling_type=AvgPooling())
    comb = addto_layer(input=[pooled, prev_emb], act=LinearActivation(),
                       bias_attr=False)
    return fc_layer(input=comb, size=8, act=SoftmaxActivation(), name="scorer")
out = beam_search(step=gen_step,
                  input=[GeneratedInput(size=8, embedding_name="Tgen",
                                        embedding_size=5),
                         SubsequenceInput(ctxt)],
                  bos_id=0, eos_id=7, beam_size=1, max_length=6, name="gen")
"""


def _seq_mem_feeds(B, T, lens, data_seed):
    boot = np.random.RandomState(data_seed).randn(B, T, 6).astype(np.float32)
    lens = np.array(lens, np.int32)
    return ({"boot": jax_make_seq(boot, lens)}, {"boot": make_seq(boot, lens, device="cpu")})


def _nested_feeds(n_subs, sub_lens, data_seed, T=3):
    from paddle_tpu.graph.argument import Argument as JArg

    n_subs, sub_lens = np.array(n_subs, np.int32), np.array(sub_lens, np.int32)
    x = np.random.RandomState(data_seed).randn(len(n_subs), sub_lens.shape[1], T, 5)
    x = (x * 2.0).astype(np.float32)
    return ({"ctxt": JArg(value=jnp.asarray(x), seq_lengths=jnp.asarray(n_subs),
                          sub_seq_lengths=jnp.asarray(sub_lens))},
            {"ctxt": Argument(value=torch.from_numpy(x), seq_lengths=torch.from_numpy(n_subs),
                              sub_seq_lengths=torch.from_numpy(sub_lens))})


@pytest.mark.parametrize("text,feed,what", [
    (GEN_SEQ_MEM, lambda: _seq_mem_feeds(3, 4, [4, 2, 3], 3), 9),
    (GEN_NESTED, lambda: _nested_feeds([4, 2, 3], [[3, 1, 2, 3], [2, 3, 0, 0], [1, 1, 2, 0]],
                                       11), 4),
], ids=["sequence_memory", "nested_in_link"])
def test_generation_refuses_what_is_not_ported(tmp_path, text, feed, what):
    """Generation with a sequence-valued memory and with a nested in-link,
    once refused, now runs: greedy, on the data and parameter seed
    (``what``) of tests/test_gen_seq_memory.py and
    tests/test_gen_nested_inlink.py, the ids, lengths and scores are the
    JAX package's."""
    jtc, ttc = _parse_both(tmp_path, text)
    jfeed, tfeed = feed()
    jout, tout, _ = _generate_both(jtc, ttc, what, jfeed, tfeed)
    _assert_same_generation(jout, tout, "gen")
    assert (tout["gen"].seq_lengths.numpy() > 0).all()


@pytest.mark.parametrize("text,feed,seed", [
    (GEN_SEQ_MEM, lambda: _seq_mem_feeds(2, 3, [3, 2], 5), 2),
    (GEN_NESTED, lambda: _nested_feeds([3, 1, 2], [[3, 2, 1], [3, 0, 0], [0, 2, 0]], 12), 4),
], ids=["sequence_memory", "nested_in_link"])
def test_beam_search_carries_sequence_memories_and_nested_in_links(tmp_path, text, feed, seed):
    """Beam 3 (tests/test_gen_seq_memory.py:165's case, and a nested in-link
    with an empty sub-sequence): each beam's sequence memory is frozen once
    it finishes and reordered with its beam; ids, lengths and scores are
    the JAX package's."""
    jtc, ttc = _parse_both(tmp_path, text.replace("beam_size=1", "beam_size=3"))
    jfeed, tfeed = feed()
    jout, tout, _ = _generate_both(jtc, ttc, seed, jfeed, tfeed)
    _assert_same_generation(jout, tout, "gen")
    scores = tout["gen@beams"].value.numpy()
    assert np.isfinite(scores[:, 0]).all() and (scores[:, 0] >= scores[:, 1:].max(1) - 1e-6).all()


def test_the_data_path_pieces_of_the_api_raise():
    """The API's data-path pieces, refused until the data path was ported,
    now work as the JAX package's: ``initPaddle`` parses flags (ignoring a
    name it does not know; ``--use_tpu=false`` puts machines made without
    a device on the CPU), and ``DataProviderConverter`` packs samples into
    the JAX package's feed. The converter raises only when the slots do
    not match the data layers."""
    from paddle_tpu.data.provider import integer_value as jax_integer_value
    from paddle_tpu.data.provider import integer_value_sequence as jax_integer_value_sequence
    from paddle_tpu_torch.data.provider import integer_value, integer_value_sequence
    from paddle_tpu_torch.utils.flags import FLAGS

    samples = [([3, 4, 5], 1), ([6], 0), ([7, 8], 1)]
    want = jax_api.DataProviderConverter(
        [jax_integer_value_sequence(10), jax_integer_value(2)], ["src", "label"])(samples)
    got = api.DataProviderConverter([integer_value_sequence(10), integer_value(2)],
                                    ["src", "label"])(samples)
    for name in ("src", "label"):
        for field in ("ids", "seq_lengths"):
            w, g = getattr(want[name], field), getattr(got[name], field)
            assert (w is None) == (g is None)
            if w is not None:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(AssertionError, match="slots"):
        api.DataProviderConverter([integer_value(2)], ["src", "label"])
    _, ttc = _nmt_configs(3)
    use_tpu = FLAGS.use_tpu
    try:
        api.initPaddle("--use_tpu=false", "--use_gpu=0")
        assert api.GradientMachine(ttc.model_config).device == torch.device("cpu")
    finally:
        FLAGS.use_tpu = use_tpu


def test_api_machine_parameters_round_trip(tmp_path):
    """loadParameters from a pass directory, from a save_dir (the latest
    pass) and from a merged .npz; get/setParameter through numpy."""
    _, tm, ttc = _api_machines()
    tm.saveParameters(str(tmp_path / "out"), pass_id=0)
    name = tm.getParameterNames()[0]
    orig = tm.getParameter(name)
    changed = orig + 1.0
    tm.setParameter(name, changed)
    tm.saveParameters(str(tmp_path / "out"), pass_id=1)
    other = api.GradientMachine(ttc.model_config, seed=2, device="cpu")
    other.loadParameters(str(tmp_path / "out"))
    np.testing.assert_array_equal(other.getParameter(name), changed)
    other.loadParameters(str(tmp_path / "out" / "pass-00000"))
    np.testing.assert_array_equal(other.getParameter(name), orig)
    np.savez(tmp_path / "merged.npz", **{n: tm.getParameter(n) for n in tm.getParameterNames()})
    other.loadParameters(str(tmp_path / "merged.npz"))
    for n in tm.getParameterNames():
        np.testing.assert_array_equal(other.getParameter(n), tm.getParameter(n))
    with pytest.raises(ValueError):
        other.setParameter(name, np.zeros((1, 1), np.float32))
    assert os.path.isdir(tmp_path / "out" / "pass-00001")


def test_api_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    """api.GradientMachine and Trainer default to the card and raise without
    one; generation never moves to the CPU unasked."""
    _, ttc = _nmt_configs(3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.GradientMachine(ttc.model_config)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(ttc)
    machine = api.GradientMachine.createFromConfigProto(ttc.model_config, device="cpu")
    assert machine.device == torch.device("cpu")
    assert machine.asSequenceGenerator(beam_size=2)._core.device == torch.device("cpu")
