"""The port's data path against the JAX package's, batch for batch.

Each case writes a workspace (a config, its provider module and file
lists, as the demos lay them out), parses the config with each package,
builds each package's provider with ``create_data_provider`` from the same
seed, and runs two passes over both: every batch's slots, ids, values,
``seq_lengths`` and ``sub_seq_lengths`` must be numpy-equal, in the same
order (the shuffle pool, ``sort_by_length`` and ``bucket_length`` shape
them; the provider object is kept between passes, so its
``random.Random(seed)`` carries over as in ``Trainer.train``). The native
packers' cases of ``tests/test_native_datapath.py`` hold the port's
``BatchAssembler`` to the JAX package's, native and NumPy alike. Last, a
port run leaves the JAX package its own ``paddle_tpu.data`` and its own
cached demo modules, while the port's provider reads its corpus through
the port's ``datasets`` on the feeder's threads.
"""

import importlib
import os
import random
import shutil
import sys
import textwrap

import numpy as np
import pytest
import torch

from paddle_tpu.config import parse_config_at as jax_parse_config_at
from paddle_tpu.data import feeder as jax_feeder
from paddle_tpu.data.binary import write_shard as jax_write_shard
from paddle_tpu.proto import DataConfig as JaxDataConfig
from paddle_tpu_torch.compat import PORT_BUILTINS
from paddle_tpu_torch.config import parse_config_at
from paddle_tpu_torch.data import feeder
from paddle_tpu_torch.proto import DataConfig

torch.set_num_threads(1)
# the packages' ``data`` re-exports the ``provider`` decorator under the
# submodule's name
jax_provider_mod = importlib.import_module("paddle_tpu.data.provider")
provider_mod = importlib.import_module("paddle_tpu_torch.data.provider")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("value", "ids", "seq_lengths", "sub_seq_lengths", "weight")


def _assert_same_batches(jax_batches, port_batches):
    assert len(port_batches) == len(jax_batches)
    for i, (jb, pb) in enumerate(zip(jax_batches, port_batches)):
        assert list(pb) == list(jb), i
        for name in jb:
            for field in FIELDS:
                jv, pv = getattr(jb[name], field), getattr(pb[name], field)
                assert (jv is None) == (pv is None), (i, name, field)
                if jv is not None:
                    assert isinstance(pv, torch.Tensor) and pv.device.type == "cpu"
                    jv = np.asarray(jv)
                    assert pv.numpy().dtype == jv.dtype, (i, name, field)
                    np.testing.assert_array_equal(pv.numpy(), jv, err_msg=f"{i} {name}.{field}")


def _two_passes(provider):
    return [list(provider.batches()) for _ in range(2)]


def _both_providers(ws, config, config_args="", for_test=False):
    """(JAX provider, port provider) of ``config`` in workspace ``ws``, the
    cwd, as the command line builds them."""
    made = []
    for parse, create in ((jax_parse_config_at, jax_feeder.create_data_provider),
                          (parse_config_at, feeder.create_data_provider)):
        cfg = parse(os.path.join(ws, config), config_args)
        dc = cfg.test_data_config if for_test else cfg.data_config
        made.append(create(dc, cfg.opt_config.batch_size,
                           cfg.model_config.input_layer_names, seed=1, for_test=for_test))
    return made


def _copy_demo(demo, ws, *names):
    for name in names:
        shutil.copy(os.path.join(REPO, "demo", demo, name), ws)


def _write(path, text):
    with open(path, "w") as f:
        f.write(textwrap.dedent(text).lstrip())


LR_CONF = """
from paddle.trainer_config_helpers import *
define_py_data_sources2(train_list="train.list", test_list="test.list",
                        module="{module}", obj="{obj}")
settings(batch_size={batch}, learning_rate=0.02, learning_method=AdamOptimizer())
data = data_layer(name="{x}", size={dim})
output = fc_layer(input=data, size=2, act=SoftmaxActivation())
outputs(classification_cost(input=output, label=data_layer(name="label", size=2)))
"""


def _seq2seq_corpus(ws, n_train, n_test, vocab=40, seed=1):
    """A dict (<s>, <e>, <unk>, w3 ... ) and tab-separated corpora."""
    rng = np.random.RandomState(seed)
    words = ["<s>", "<e>", "<unk>"] + [f"w{i}" for i in range(3, vocab)]
    with open(os.path.join(ws, "dict.txt"), "w") as f:
        f.write("\n".join(words) + "\n")
    for name, n in (("train.txt", n_train), ("test.txt", n_test)):
        with open(os.path.join(ws, name), "w") as f:
            for _ in range(n):
                # an out-of-dict word now and then maps to <unk>
                src = [words[i] for i in rng.randint(3, vocab, size=rng.randint(1, 20))] + ["zz"]
                trg = [words[i] for i in rng.randint(3, vocab, size=rng.randint(1, 20))]
                f.write(" ".join(src) + "\t" + " ".join(trg) + "\n")
    return "src_dict=dict.txt,trg_dict=dict.txt"


def case_synthetic_bow(ws):
    shutil.copy(os.path.join(REPO, "tests", "providers", "synthetic_bow.py"), ws)
    _write(os.path.join(ws, "conf.py"), LR_CONF.format(module="synthetic_bow", obj="process",
                                                        batch=64, x="word", dim=100))
    _write(os.path.join(ws, "train.list"), "1\n2\n3\n")
    _write(os.path.join(ws, "test.list"), "99\n")
    return "conf.py", ""


def case_seqToseq_synthetic(ws):
    _copy_demo("seqToseq", ws, "dataprovider.py", "seqToseq_net.py", "train.conf")
    _write(os.path.join(ws, "train.list"), "seed1\n")
    _write(os.path.join(ws, "test.list"), "seed2\n")
    return "train.conf", ""


def case_seqToseq_real(ws):
    _copy_demo("seqToseq", ws, "dataprovider.py", "seqToseq_net.py", "train.conf")
    _write(os.path.join(ws, "train.list"), "train.txt\n")
    _write(os.path.join(ws, "test.list"), "test.txt\n")
    return "train.conf", _seq2seq_corpus(ws, 90, 37)


def case_quick_start_bow_cached(ws):
    """dataprovider_bow: CACHE_PASS_IN_MEM, so pass 2 shuffles the cache."""
    _copy_demo("quick_start", ws, "common.py", "dataprovider_bow.py", "trainer_config.lr.py")
    _write(os.path.join(ws, "train.list"), "seed-train-1\nseed-train-2\n")
    _write(os.path.join(ws, "test.list"), "seed-test-1\n")
    return "trainer_config.lr.py", ""


SORTED_PROVIDER = """
from paddle.trainer.PyDataProvider2 import *
import random

@provider(input_types={"x": integer_value_sequence(50), "label": integer_value(2)},
          pool_size=48, sort_by_length=True)
def process(settings, file_name):
    rng = random.Random(int(file_name))
    for i in range(150):
        yield {"x": [rng.randrange(50) for _ in range(rng.randint(1, 70))], "label": i % 2}
"""


def case_sort_by_length_pool(ws):
    _write(os.path.join(ws, "sorted_provider.py"), SORTED_PROVIDER)
    _write(os.path.join(ws, "conf.py"), LR_CONF.format(module="sorted_provider", obj="process",
                                                        batch=16, x="x", dim=50))
    _write(os.path.join(ws, "train.list"), "5\n6\n")
    _write(os.path.join(ws, "test.list"), "7\n")
    return "conf.py", ""


MULTI_PROVIDER = """
from paddle.trainer.PyDataProvider2 import *

@provider(input_types=[dense_vector(4), integer_value(2)])
def pos(settings, file_name):
    for i in range(int(file_name.split("-")[-1])):
        yield [1.0, 0.0, 0.0, float(i % 3)], 1

@provider(input_types=[dense_vector(4), integer_value(2)])
def neg(settings, file_name):
    for i in range(int(file_name.split("-")[-1])):
        yield [0.0, 1.0, 0.0, float(i % 3)], 0
"""


def case_multi_ratios(ws):
    _write(os.path.join(ws, "providers_multi.py"), MULTI_PROVIDER)
    _write(os.path.join(ws, "pos.list"), "n-300\n")
    _write(os.path.join(ws, "neg.list"), "n-130\n")
    _write(os.path.join(ws, "conf.py"), """
        from paddle.trainer_config_helpers import *
        define_multi_py_data_sources2(train_lists=['pos.list', 'neg.list'],
                                      module='providers_multi', obj=['pos', 'neg'], ratios=[3, 1])
        settings(batch_size=40, learning_rate=0.1)
        d = data_layer('x', size=4)
        out = fc_layer(input=d, size=2, act=SoftmaxActivation())
        outputs(classification_cost(input=out, label=data_layer('label', size=2)))
        """)
    return "conf.py", ""


def case_binary_shard(ws):
    types = [jax_provider_mod.integer_value_sequence(50), jax_provider_mod.dense_vector(4),
             jax_provider_mod.sparse_binary_vector(30), jax_provider_mod.integer_value(3)]
    rng = np.random.RandomState(0)
    for shard in range(2):
        samples = [[[int(x) for x in rng.randint(0, 50, rng.randint(1, 12))],
                    rng.rand(4).tolist(),
                    sorted(int(i) for i in rng.choice(30, 5, replace=False)),
                    int(rng.randint(0, 3))] for _ in range(45)]
        jax_write_shard(os.path.join(ws, f"shard{shard}.npz"), samples, types)
    _write(os.path.join(ws, "train.list"),
           "".join(os.path.join(ws, f"shard{i}.npz") + "\n" for i in range(2)))
    _write(os.path.join(ws, "conf.py"), """
        from paddle.trainer_config_helpers import *
        define_bin_data_sources('train.list')
        settings(batch_size=16, learning_rate=0.1)
        ids = data_layer('ids', size=50)
        d = data_layer('x', size=4)
        bow = data_layer('bow', size=30)
        out = fc_layer(input=[d, bow], size=3, act=SoftmaxActivation())
        outputs(classification_cost(input=out, label=data_layer('label', size=3)))
        """)
    return "conf.py", ""


CASES = {f.__name__[len("case_"):]: f for f in (
    case_synthetic_bow, case_seqToseq_synthetic, case_seqToseq_real,
    case_quick_start_bow_cached, case_sort_by_length_pool, case_multi_ratios,
    case_binary_shard)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_batches_equal_the_jax_packages_over_two_passes(case, tmp_path, monkeypatch):
    ws = str(tmp_path)
    monkeypatch.chdir(ws)
    config, args = CASES[case](ws)
    jax_prov, port_prov = _both_providers(ws, config, args)
    assert type(port_prov).__name__ == type(jax_prov).__name__
    jax_passes, port_passes = _two_passes(jax_prov), _two_passes(port_prov)
    for jp, pp in zip(jax_passes, port_passes):
        _assert_same_batches(jp, pp)
    # the second pass is shuffled anew: the rng carried over
    first = [next(iter(p[0].values())) for p in port_passes]
    assert not all(torch.equal(a.ids if a.ids is not None else a.value,
                               b.ids if b.ids is not None else b.value)
                   for a, b in zip(first, first[1:])), case


def test_test_providers_keep_file_order(tmp_path, monkeypatch):
    """The test provider of the seqToseq demo in real mode: in file order,
    a partial last batch, equal to the JAX package's."""
    ws = str(tmp_path)
    monkeypatch.chdir(ws)
    config, args = case_seqToseq_real(ws)
    jax_prov, port_prov = _both_providers(ws, config, args, for_test=True)
    jax_passes, port_passes = _two_passes(jax_prov), _two_passes(port_prov)
    for jp, pp in zip(jax_passes, port_passes):
        _assert_same_batches(jp, pp)
    sizes = [b["source_language_word"].batch_size for b in port_passes[0]]
    assert sizes == [16, 16, 5]
    _assert_same_batches(port_passes[0], port_passes[1])
    # bucket_length: every padded length a multiple of 8 (all below 64)
    assert all(b["source_language_word"].max_len % 8 == 0 for b in port_passes[0])


# ------------------------------------------------- the native packers


def _native_case(name):
    rng = random.Random(7)
    if name == "index_and_sparse":
        types = ("integer_value_sequence", 50), ("sparse_binary_vector", 40), \
            ("sparse_value_slot", 30), ("integer_value", 9)
        samples = [[[rng.randrange(50) for _ in range(rng.randint(1, 23))],
                    sorted(rng.sample(range(40), rng.randint(0, 10))),
                    [(i, rng.random()) for i in sorted(rng.sample(range(30), 4))],
                    rng.randrange(9)] for _ in range(17)]
    elif name == "dense_and_sparse_sequences":
        types = ("dense_vector_sequence", 8), ("sparse_binary_vector_sequence", 25), \
            ("sparse_vector_sequence", 15)
        samples = []
        for _ in range(9):
            n = rng.randint(1, 12)
            samples.append([
                [[rng.random() for _ in range(8)] for _ in range(n)],
                [sorted(rng.sample(range(25), rng.randint(0, 5))) for _ in range(n)],
                [[(i, rng.random()) for i in sorted(rng.sample(range(15), rng.randint(0, 4)))]
                 for _ in range(n)]])
    else:
        types = (("integer_value_sub_sequence", 60),)
        samples = [[[[rng.randrange(60) for _ in range(rng.randint(1, 9))]
                     for _ in range(rng.randint(1, 5))]] for _ in range(7)]
    return types, samples


@pytest.mark.parametrize("case", ["index_and_sparse", "dense_and_sparse_sequences",
                                  "nested_index_sequences"])
@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_batch_assembler_matches_the_jax_packages(case, native):
    types, samples = _native_case(case)
    names = [f"s{i}" for i in range(len(types))]
    want = jax_feeder.BatchAssembler(
        [getattr(jax_provider_mod, t)(d) for t, d in types], names).assemble(samples)
    assembler = feeder.BatchAssembler([getattr(provider_mod, t)(d) for t, d in types], names)
    if native:
        assert assembler._native is not None, "the native datapath did not build"
    else:
        assembler._native = None
    _assert_same_batches([want], [assembler.assemble(samples)])


def test_out_of_range_sparse_index_raises():
    assembler = feeder.BatchAssembler([provider_mod.sparse_binary_vector(10)], ["bow"])
    for bad in ([3, 10], [-1, 2]):
        with pytest.raises(IndexError):
            assembler.assemble([[bad]])


# ------------------------------------------ what a port run leaves behind


def test_a_port_run_leaves_the_jax_package_its_modules(tmp_path, monkeypatch):
    """The JAX package loads the seqToseq demo's provider in real mode (its
    ``paddle_tpu.data`` and ``dataprovider`` then sit in ``sys.modules``);
    the port then loads and iterates the same demo's provider. The port's
    corpus reads go through ``paddle_tpu_torch.data.datasets``, on the
    feeder's threads, and none through the JAX package's; afterwards
    ``sys.modules`` holds the JAX package's modules and its
    ``dataprovider`` as before, and no module bound to the port."""
    import paddle_tpu.data as jax_data
    from paddle_tpu.data import datasets as jax_datasets
    from paddle_tpu_torch.data import datasets as port_datasets

    ws = str(tmp_path)
    config, args = case_seqToseq_real(ws)
    monkeypatch.chdir(ws)
    jcfg = jax_parse_config_at(os.path.join(ws, config), args)
    jax_prov = jax_feeder.create_data_provider(
        jcfg.data_config, jcfg.opt_config.batch_size, jcfg.model_config.input_layer_names)
    jax_module = sys.modules["dataprovider"]
    before = {n: sys.modules[n] for n in ("paddle_tpu.data", "paddle_tpu.data.datasets",
                                          "dataprovider", "seqToseq_net")
              if n in sys.modules}
    reads = {"jax": 0, "port": 0}

    def spy(who, orig):
        def read(*a, **k):
            reads[who] += 1
            return orig(*a, **k)
        return read

    monkeypatch.setattr(jax_datasets, "read_parallel_lines",
                        spy("jax", jax_datasets.read_parallel_lines))
    monkeypatch.setattr(port_datasets, "read_parallel_lines",
                        spy("port", port_datasets.read_parallel_lines))
    cfg = parse_config_at(os.path.join(ws, config), args)
    port_prov = feeder.create_data_provider(
        cfg.data_config, cfg.opt_config.batch_size, cfg.model_config.input_layer_names)
    n = sum(b["source_language_word"].batch_size for b in port_prov.batches())
    assert n == 90 and reads == {"jax": 0, "port": 1}
    gen_fn = port_prov.provider.generator_fn
    assert gen_fn.__globals__["__builtins__"] is PORT_BUILTINS
    assert sys.modules["paddle_tpu.data"] is jax_data
    assert {n: sys.modules.get(n) for n in before} == before
    assert sys.modules["dataprovider"] is jax_module
    assert gen_fn.__globals__ is not jax_module.__dict__
    assert not any(getattr(m, "__builtins__", None) is PORT_BUILTINS
                   for m in list(sys.modules.values()))
    # the JAX package's provider still reads through its own datasets
    assert sum(b["source_language_word"].batch_size for b in jax_prov.batches()) == 90
    assert reads == {"jax": 1, "port": 1}


def test_provider_modules_import_the_port_by_the_jax_packages_name(tmp_path, monkeypatch):
    """A provider written against the JAX package (``from paddle_tpu.data
    import provider, integer_value``, tests/providers/synthetic_bow.py)
    loads under the port with the port's ``@provider`` and slot types."""
    ws = str(tmp_path)
    case_synthetic_bow(ws)
    monkeypatch.chdir(ws)
    cached = sys.modules.get("synthetic_bow")
    dc = DataConfig(type="py2", files="train.list", load_data_module="synthetic_bow",
                    load_data_object="process")
    prov = feeder.create_data_provider(dc, 64, ["word", "label"])
    assert sys.modules.get("synthetic_bow") is cached
    assert all(type(t) is provider_mod.InputType for t in prov.settings.input_types)
    jdc = JaxDataConfig(type="py2", files="train.list", load_data_module="synthetic_bow",
                        load_data_object="process")
    jprov = jax_feeder.create_data_provider(jdc, 64, ["word", "label"])
    assert all(type(t) is jax_provider_mod.InputType for t in jprov.settings.input_types)
