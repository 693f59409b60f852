"""The structured and random layers against the JAX package, on the CPU.

crf, crf_decoding, ctc and lambda_cost in small configs, as in
``tests/test_torch_layers_library.py`` (outputs 1e-5 of scale, loss 1e-5
relative, gradients 1e-4 of scale; Viterbi paths equal), with ragged
lengths. The random layers draw with torch, which cannot reproduce jax's
bits, so:

- nce's cost is held to the JAX layer's on the negatives jax drew from the
  same key (``jax.random`` of ``fold_in(key, crc32("<name>/nce"))``, handed
  to the port in place of its sampler), uniform and with
  ``neg_distribution``;
- nce's sampler and sampling_id are held to their distributions: 10^5
  draws at a fixed seed, a chi-square test at p = 0.001; the draws repeat
  for a seed and differ between layers and between recurrent-group steps.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from test_torch_layers_library import (B, LENGTHS, T, dense, id_seq, ids, run_config,
                                       seq)
from paddle_tpu_torch.graph.argument import Argument
from paddle_tpu_torch.layers import misc as port_misc
from paddle_tpu_torch.layers.base import LayerContext, forward_layer
from paddle_tpu_torch.proto import LayerConfig, LayerInputConfig, ModelConfig

torch.set_num_threads(1)
C = 5


def test_crf_and_crf_decoding_match_the_jax_package(tmp_path):
    body = (
        f"x = fc_layer(input=data_layer('x', size=6), size={C}, name='emis')\n"
        f"lab = data_layer('tag', size={C})\n"
        "outputs(crf_layer(input=x, label=lab, param_attr=ParamAttr(name='_crfw'), name='crf'),"
        " crf_decoding_layer(input=x, param_attr=ParamAttr(name='_crfw'), name='dec'),"
        " crf_decoding_layer(input=x, label=lab, param_attr=ParamAttr(name='_crfw'),"
        " name='dec_err'))\n")
    _, jouts, pouts = run_config(tmp_path, body, dict(x=seq(6, 1), tag=id_seq(C, 2)))
    path = pouts["dec"].ids.numpy()
    assert path.shape == (B, T) and (path[np.arange(T)[None] >= LENGTHS[:, None]] == 0).all()
    assert np.array_equal(path, np.asarray(jouts["dec"].ids))


def _brute_viterbi(x, param, n):
    import itertools

    a, b, w = param[0], param[1], param[2:]
    best = max(itertools.product(range(x.shape[1]), repeat=n),
               key=lambda s: a[s[0]] + b[s[-1]] + sum(x[t, s[t]] for t in range(n))
               + sum(w[s[t - 1], s[t]] for t in range(1, n)))
    return list(best)


def test_crf_decode_is_the_best_path():
    from paddle_tpu_torch.layers.structured import crf_decode

    rng = np.random.RandomState(3)
    x = rng.randn(3, 4, 3).astype(np.float32)
    param = rng.randn(5, 3).astype(np.float32)
    lengths = np.array([4, 2, 1], np.int32)
    path = crf_decode(torch.as_tensor(x), torch.as_tensor(lengths), torch.as_tensor(param))
    for i, n in enumerate(lengths):
        assert path[i, :n].tolist() == _brute_viterbi(x[i], param, n)
        assert not path[i, n:].any()


@pytest.mark.parametrize("norm_by_times", [False, True])
def test_ctc_matches_the_jax_package(norm_by_times, tmp_path):
    body = (
        f"h = fc_layer(input=data_layer('x', size=6), size={C}, act=SoftmaxActivation(),"
        " name='probs')\n"
        f"outputs(ctc_layer(input=h, label=data_layer('lab', size={C}), size={C},"
        f" norm_by_times={norm_by_times}, name='ctc'))\n")
    labels = id_seq(C - 1, 4, lengths=np.array([2, 1, 0, 3], np.int32))
    labels["ids"] = labels["ids"][:, :3]
    run_config(tmp_path, body, dict(x=seq(6, 1), lab=labels))


def test_ctc_loss_sums_over_alignments():
    """-log of the summed probability of every frame labelling that
    collapses to the target (repeats merged, blanks dropped)."""
    import itertools

    from paddle_tpu_torch.layers.structured import ctc_loss

    rng = np.random.RandomState(5)
    Tn, Cn, blank = 4, 3, 2
    logits = rng.randn(1, Tn, Cn)
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    target = [0, 1]
    total = 0.0
    for path in itertools.product(range(Cn), repeat=Tn):
        collapsed = [c for i, c in enumerate(path) if c != blank and (i == 0 or c != path[i - 1])]
        if collapsed == target:
            total += np.exp(sum(logp[0, t, c] for t, c in enumerate(path)))
    got = ctc_loss(torch.as_tensor(logp), torch.tensor([Tn]), torch.tensor([target]),
                   torch.tensor([2]), blank)
    np.testing.assert_allclose(got.numpy(), [-np.log(total)], rtol=1e-9)


def test_lambda_cost_matches_the_jax_package(tmp_path):
    body = ("s = fc_layer(input=data_layer('x', size=6), size=1, name='score')\n"
            "outputs(lambda_cost(input=s, score=data_layer('rel', size=1), NDCG_num=3,"
            " name='lambda'))\n")
    rel = {"value": np.random.RandomState(7).randint(0, 4, (B, T, 1)).astype(np.float32),
           "lengths": LENGTHS}
    run_config(tmp_path, body, dict(x=seq(6, 1), rel=rel))


# ------------------------------------------------------------------ nce

NCE_CLASSES, NCE_K = 11, 3
NCE_DIST = [0.05, 0.15, 0.1, 0.1, 0.05, 0.05, 0.1, 0.1, 0.1, 0.1, 0.1]


def _jax_negatives(name, dist):
    """What the JAX nce layer draws under the machine's PRNGKey(0)."""
    key = jax.random.fold_in(jax.random.PRNGKey(0), zlib.crc32(f"{name}/nce".encode()))
    if dist:
        logits = jnp.log(jnp.clip(jnp.asarray(dist), 1e-10, None))
        return np.asarray(jax.random.categorical(key, logits, shape=(B, NCE_K)))
    return np.asarray(jax.random.randint(key, (B, NCE_K), 0, NCE_CLASSES, jnp.int32))


@pytest.mark.parametrize("dist", [None, NCE_DIST])
def test_nce_cost_matches_the_jax_package_on_its_negatives(dist, tmp_path, monkeypatch):
    drawn = []

    def jax_draws(cfg, n, ctx, device):
        neg = np.array(_jax_negatives(cfg.name, dist))
        drawn.append(neg)
        return torch.as_tensor(neg, dtype=torch.long, device=device)

    monkeypatch.setattr(port_misc, "nce_negatives", jax_draws)
    extra = f", neg_distribution={dist}" if dist else ""
    body = ("h = fc_layer(input=data_layer('a', size=8), size=6, act=TanhActivation(),"
            " name='h')\n"
            f"outputs(nce_layer(input=h, label=data_layer('c', size={NCE_CLASSES}),"
            f" num_classes={NCE_CLASSES}, num_neg_samples={NCE_K}{extra}, name='nce'))\n")
    run_config(tmp_path, body, dict(a=dense(8, 1), c=ids(NCE_CLASSES, 3)))
    assert len(drawn) == 1


def _chi2_p(counts, probs):
    probs = np.asarray(probs, np.float64)
    return scipy.stats.chisquare(counts, counts.sum() * probs / probs.sum()).pvalue


def _nce_cfg(name, dist):
    return LayerConfig(name=name, type="nce", num_classes=NCE_CLASSES, num_neg_samples=NCE_K,
                       neg_sampling_dist=list(dist or []))


@pytest.mark.parametrize("dist", [None, NCE_DIST])
def test_nce_sampler_draws_its_distribution(dist):
    ctx = LayerContext(params={}, model=ModelConfig(), pass_type="train", seed=11)
    n = 100_000 // NCE_K
    neg = port_misc.nce_negatives(_nce_cfg("nce", dist), n, ctx, torch.device("cpu"))
    assert neg.shape == (n, NCE_K)
    counts = np.bincount(neg.reshape(-1).numpy(), minlength=NCE_CLASSES)
    assert _chi2_p(counts, dist or [1.0] * NCE_CLASSES) > 1e-3
    again = port_misc.nce_negatives(_nce_cfg("nce", dist), n, ctx, torch.device("cpu"))
    other = port_misc.nce_negatives(_nce_cfg("nce2", dist), n, ctx, torch.device("cpu"))
    assert torch.equal(neg, again) and not torch.equal(neg, other)


# ----------------------------------------------------------- sampling_id

SAMPLE_P = np.array([0.05, 0.4, 0.0, 0.25, 0.3], np.float32)


def _sample(name, seed, rows):
    cfg = LayerConfig(name=name, type="sampling_id", size=1)
    cfg.inputs.append(LayerInputConfig(input_layer_name="p"))
    ctx = LayerContext(params={}, model=ModelConfig(), pass_type="gen", seed=seed)
    p = torch.as_tensor(np.tile(SAMPLE_P, (rows, 1)))
    return forward_layer(cfg, [Argument(value=p)], ctx).ids


def test_sampling_id_draws_each_rows_distribution():
    got = _sample("sid", 3, 100_000)
    assert got.dtype == torch.int32 and got.shape == (100_000,)
    counts = np.bincount(got.numpy(), minlength=len(SAMPLE_P))
    assert counts[2] == 0
    keep = SAMPLE_P > 0
    assert _chi2_p(counts[keep], SAMPLE_P[keep]) > 1e-3
    assert torch.equal(got, _sample("sid", 3, 100_000))
    assert not torch.equal(got, _sample("sid", 4, 100_000))
    assert not torch.equal(got, _sample("sid2", 3, 100_000))


def test_sampling_id_pins_a_degenerate_row_and_needs_a_seed():
    cfg = LayerConfig(name="sid", type="sampling_id", size=1)
    p = torch.zeros(4, 5)
    p[:, 2] = 1.0
    ctx = LayerContext(params={}, model=ModelConfig(), pass_type="gen", seed=0)
    assert forward_layer(cfg, [Argument(value=p)], ctx).ids.tolist() == [2] * 4
    with pytest.raises(ValueError, match="no seed"):
        forward_layer(cfg, [Argument(value=p)], LayerContext(params={}, model=ModelConfig()))


def test_recurrent_group_steps_draw_apart():
    from paddle_tpu_torch.layers.base import fold_seed

    seeds = [fold_seed(5, t) for t in range(64)]
    assert len(set(seeds)) == 64 and fold_seed(None, 3) is None
    assert [fold_seed(5, t) for t in range(64)] == seeds
    assert all(0 <= s < 2 ** 31 for s in seeds) and fold_seed(6, 0) not in seeds


def test_trainer_seeds_steps_by_pass_and_batch_and_tests_with_none(monkeypatch):
    """A training step's seed is fold_seed(--seed, pass, batch), whatever
    ran between steps; test forwards get no seed, as the JAX package's
    run with rng=None (so sampling_id and nce refuse a test pass there and
    here)."""
    from paddle_tpu_torch.flagship import example_batch, flagship_config
    from paddle_tpu_torch.layers.base import fold_seed
    from paddle_tpu_torch.trainer.trainer import Trainer

    trainer = Trainer(flagship_config(dict_dim=50, emb_dim=8, hidden=8), device="cpu")
    batches = [example_batch(50, B=4, T=6, seed=s, device="cpu") for s in range(3)]
    seen = {"train": [], "test": []}
    grad_fn, forward = trainer._grad_fn, trainer.gm.forward

    def spy_grad(params, batch, seed):
        seen["train"].append(seed)
        return grad_fn(params, batch, seed)

    def spy_forward(*a, **kw):
        if kw.get("pass_type") == "test":
            seen["test"].append(kw.get("seed"))
        return forward(*a, **kw)

    monkeypatch.setattr(trainer, "_grad_fn", spy_grad)
    monkeypatch.setattr(trainer.gm, "forward", spy_forward)
    provider = type("P", (), {"batches": lambda self: iter(batches)})()
    trainer.train_one_pass(0, provider)
    trainer.test_batches(batches[:2])
    trainer.train_one_pass(1, provider)
    s = int(trainer.flags.seed)
    assert seen["train"] == [fold_seed(s, p, b) for p in (0, 1) for b in range(3)]
    assert len(set(seen["train"])) == 6 and seen["test"] == [None, None]
