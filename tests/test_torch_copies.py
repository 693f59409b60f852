"""Rules of the port that keep it honest.

- Every framework-free module it copies from the JAX package is a verbatim
  copy, with ``paddle_tpu.`` renamed to ``paddle_tpu_torch.``. The stated
  exceptions: ``config/config_parser.py`` runs a config under the port's
  own ``paddle`` shim (``paddle_tpu_torch.compat.paddle_shim``) where the
  JAX package puts ``compat/`` on ``sys.path`` (that ``paddle`` resolves to
  the JAX package), ``data/binary.py`` keeps the shard format's magic
  string (``paddle_tpu.bin.v1``, which the rename would change), and
  ``utils/__init__.py`` is the port's own.
- No module of the port, and not ``chip_smoke.py``, imports ``jax`` or
  ``paddle_tpu``.
- The entry points run on the card unless the caller passes
  ``device="cpu"``; without a card they raise.
"""

import ast
import os

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "paddle_tpu_torch")

COPIES = (
    "proto/__init__.py", "proto/message.py", "proto/configs.py",
    "config/__init__.py", "config/builder.py", "config/config_parser.py",
    "trainer_config_helpers/__init__.py", "trainer_config_helpers/activations.py",
    "trainer_config_helpers/attrs.py", "trainer_config_helpers/data_sources.py",
    "trainer_config_helpers/evaluators.py", "trainer_config_helpers/layers.py",
    "trainer_config_helpers/networks.py", "trainer_config_helpers/optimizers.py",
    "trainer_config_helpers/poolings.py",
    "serving/backend.py", "serving/draft.py", "serving/engine.py",
    "observability/__init__.py", "observability/metrics.py", "observability/spans.py",
    "observability/serving.py", "observability/analyze.py",
    "resilience/__init__.py", "resilience/faultinject.py", "resilience/manifest.py",
    "trainer/evaluators.py",
    "utils/concurrency.py", "utils/logging.py", "utils/error.py", "utils/registry.py",
    "utils/flags.py", "utils/retry.py", "version.py", "native/__init__.py", "native/datapath.cc",
    "data/provider.py", "data/datasets.py", "data/binary.py",
    "resilience/hangwatch.py", "resilience/heartbeat.py", "resilience/supervisor.py",
    "serving/resilience.py", "serving/transport.py", "serving/fleet.py",
    "observability/costs.py", "utils/image_util.py",
    "optimizer/hooks.py", "sparse/__init__.py", "sparse/rowshard.py", "sparse/runtime.py",
    "sparse/reshard.py", "sparse/ckpt.py",
)
# the deliberate changes to copies: the port never puts compat/ on
# sys.path, it binds ``paddle`` to its own shim while a config runs; the
# binary shards the two packages write are one format
CHANGED = {"data/binary.py": (('MAGIC = "paddle_tpu_torch.bin.v1"', 'MAGIC = "paddle_tpu.bin.v1"'),),
           "config/config_parser.py": (
    ("from paddle_tpu_torch.config.builder import",
     "from paddle_tpu_torch.compat import paddle_shim\nfrom paddle_tpu_torch.config.builder import"),
    ('''def _ensure_compat_path() -> None:
    """Make `import paddle.trainer_config_helpers` resolve to our shim."""
    shim_dir = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(__file__))), "compat")
    if os.path.isdir(shim_dir) and shim_dir not in sys.path:
        sys.path.insert(0, shim_dir)


''', ""),
    ("    _ensure_compat_path()\n    with fresh_context() as ctx:\n",
     "    config_dir = None if callable(config) else os.path.dirname(os.path.abspath(config))\n"
     "    with paddle_shim(config_dir), fresh_context() as ctx:\n"),
)}


def _read(path):
    with open(path) as f:
        return f.read()


@pytest.mark.parametrize("rel", COPIES)
def test_copy_is_verbatim(rel):
    want = _read(os.path.join(REPO, "paddle_tpu", rel)).replace("paddle_tpu.", "paddle_tpu_torch.")
    for before, after in CHANGED.get(rel, ()):
        assert want.count(before) == 1, before
        want = want.replace(before, after)
    assert _read(os.path.join(PORT, rel)) == want


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in sorted(files) if f.endswith(".py")]
    return sorted(os.path.relpath(p, REPO) for p in out)


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(_read(path), filename=path)):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("rel", _port_sources())
def test_port_imports_neither_jax_nor_the_jax_package(rel):
    bad = _imported_roots(os.path.join(REPO, rel)) & {"jax", "jaxlib", "flax", "paddle_tpu", "paddle"}
    assert not bad, f"{rel} imports {sorted(bad)}"


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    from paddle_tpu_torch.device import resolve_device
    from paddle_tpu_torch.flagship import nmt_gen_config
    from paddle_tpu_torch.graph import GradientMachine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = nmt_gen_config(vocab=20, dim=8, beam_size=1, max_length=4).model_config
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GradientMachine(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert GradientMachine(cfg, device="cpu").device == torch.device("cpu")


def test_wrapper_checks_refuse_what_the_kernels_do_not_take():
    from paddle_tpu_torch.ops._build import check

    cpu = torch.device("cpu")
    x = torch.zeros(2, 3, 4)
    check(x, "x", (2, 3, 4), cpu)
    check(x.transpose(0, 1), "x", (3, 2, 4), cpu, contiguous=False)
    with pytest.raises(ValueError, match="float32"):
        check(x.double(), "x", (2, 3, 4), cpu)
    with pytest.raises(ValueError, match="shape"):
        check(x, "x", (2, 3, 5), cpu)
    with pytest.raises(ValueError, match="contiguous"):
        check(x.transpose(0, 1), "x", (3, 2, 4), cpu)
    with pytest.raises(ValueError, match="last dimension"):
        check(x.transpose(1, 2), "x", (2, 4, 3), cpu, contiguous=False)
    with pytest.raises(ValueError, match="is on"):
        check(x, "x", (2, 3, 4), torch.device("meta"))


def test_kernel_builds_are_keyed_by_their_sources():
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import fused_attention_gru as fa
    from paddle_tpu_torch.ops import fused_conv1x1_bn as fc
    from paddle_tpu_torch.ops import flash_attention as fl_attn
    from paddle_tpu_torch.ops import fused_gru as fg
    from paddle_tpu_torch.ops import fused_lstm as fl

    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    kernels = fg.KERNELS + fa.KERNELS + fl.KERNELS + fc.KERNELS + fl_attn.KERNELS
    # 13 float32 entry points, the bf16 instances of kernels 1-3 and 5-12,
    # and the bf16 bodies of 6, 8, 10, 11 and 12 for Hopper
    assert len({k.symbol for k in kernels}) == 30
    assert {k.symbol for k in kernels if k.symbol.endswith("_sm90")} == {
        "flash_attn_fwd_bf16_sm90", "flash_attn_dq_bf16_sm90", "flash_attn_dkv_bf16_sm90",
        "attention_gru_bwd_bf16_sm90", "lstm_bwd_bf16_sm90"}
    assert {k.symbol for k in kernels if k.symbol.endswith("_bf16")} == {
        "gru_fwd_bf16", "gru_fwd_train_bf16", "gru_bwd_bf16",
        "attention_gru_fwd_train_bf16", "attention_gru_bwd_bf16",
        "lstm_fwd_bf16", "lstm_fwd_train_bf16", "lstm_bwd_bf16", "conv1x1_stats_bf16",
        "flash_attn_fwd_bf16", "flash_attn_dq_bf16", "flash_attn_dkv_bf16"}
    # a kernel and its training variant share one source and its library,
    # but for the attention GRU's: its two forwards are entries of their own
    # sources over one header (attention_gru_fwd.cuh); the Hopper bodies of
    # the recurrent backwards (6 and 8) are sources of their own
    paths = {k.library_path() for k in kernels}
    assert {os.path.basename(p).split("-")[0] for p in paths} == {
        "gru_fwd", "gru_bwd", "attention_gru_fwd", "attention_gru_fwd_train",
        "attention_gru_bwd", "lstm_fwd", "lstm_bwd", "conv1x1_bn", "flash_attn_fwd",
        "flash_attn_bwd", "attention_gru_bwd_sm90", "lstm_bwd_sm90"}
    assert fa.ATTENTION_GRU_FWD.library_path() != fa.ATTENTION_GRU_FWD_TRAIN.library_path()
    assert fg.GRU_FWD.library_path() == fg.GRU_FWD_TRAIN.library_path()
    # a bf16 instance is an entry of its float32 kernel's source and library
    for f32, bf16 in ((fg.GRU_FWD, fg.GRU_FWD_BF16), (fg.GRU_FWD_TRAIN, fg.GRU_FWD_TRAIN_BF16),
                      (fg.GRU_BWD, fg.GRU_BWD_BF16),
                      (fa.ATTENTION_GRU_FWD_TRAIN, fa.ATTENTION_GRU_FWD_TRAIN_BF16),
                      (fa.ATTENTION_GRU_BWD, fa.ATTENTION_GRU_BWD_BF16),
                      (fl.LSTM_FWD, fl.LSTM_FWD_BF16), (fl.LSTM_FWD_TRAIN, fl.LSTM_FWD_TRAIN_BF16),
                      (fl.LSTM_BWD, fl.LSTM_BWD_BF16),
                      (fl_attn.FLASH_ATTN_FWD, fl_attn.FLASH_ATTN_FWD_BF16_SM90),
                      (fl_attn.FLASH_ATTN_DQ, fl_attn.FLASH_ATTN_DQ_BF16_SM90),
                      (fl_attn.FLASH_ATTN_DKV, fl_attn.FLASH_ATTN_DKV_BF16_SM90)):
        assert f32.library_path() == bf16.library_path()
    assert fl.LSTM_FWD.library_path() == fl.LSTM_FWD_TRAIN.library_path()
    assert fl_attn.FLASH_ATTN_DQ.library_path() == fl_attn.FLASH_ATTN_DKV.library_path()
    for p in paths:
        assert p.startswith(os.path.join(REPO, "build", "paddle_tpu_torch") + os.sep)
    for k in kernels:
        assert os.path.isfile(k.source_path)
        assert k.argtypes[-1] is _build.PTR                # the stream
    for header in _build.HEADERS:
        assert os.path.isfile(os.path.join(_build.CSRC_DIR, header))


def test_training_wrappers_take_the_plain_version_on_the_cpu():
    """On a CPU tensor the wrappers run the plain version, with autograd,
    and launch nothing."""
    from paddle_tpu_torch.ops import fused_attention_gru as fa
    from paddle_tpu_torch.ops import fused_conv1x1_bn as fc
    from paddle_tpu_torch.ops import fused_gru as fg
    from paddle_tpu_torch.ops import fused_lstm as fl
    from paddle_tpu_torch.ops.flash_attention import KERNELS as FLASH_KERNELS, flash_attention

    kernels = fg.KERNELS + fa.KERNELS + fl.KERNELS + fc.KERNELS + FLASH_KERNELS
    before = [k.launches for k in kernels]
    x3 = torch.randn(3, 2, 12, requires_grad=True)
    fg.fused_gru(x3, torch.ones(3, 2), torch.randn(4, 12)).sum().backward()
    assert x3.grad is not None
    x4 = torch.randn(3, 2, 16, requires_grad=True)
    peep = torch.randn(3, 4, requires_grad=True)
    fl.fused_lstm(x4, torch.ones(3, 2), torch.randn(4, 16), peep).sum().backward()
    assert x4.grad is not None and peep.grad is not None
    with torch.no_grad():
        fl.fused_lstm(x4, torch.ones(3, 2), torch.randn(4, 16), peep, reverse=True)
    x = torch.randn(6, 4, requires_grad=True)
    y, s, q = fc.conv1x1_stats(x, torch.randn(3, 4), torch.randn(3))
    (y.sum() + s.sum() + q.sum()).backward()
    assert x.grad is not None
    fc.conv1x1_stats(x.detach(), torch.randn(3, 4))
    q = torch.randn(2, 5, 3, 4, requires_grad=True)
    flash_attention(q, q, q, causal=True).sum().backward()
    assert q.grad is not None
    with torch.no_grad():
        flash_attention(q, q, q, lengths=torch.tensor([5, 0]))
    assert [k.launches for k in kernels] == before


def test_conv1x1_stats_refuses_what_the_kernel_does_not_take():
    """Kernel 9's wrapper checks its operands on every device and never
    copies: a non-contiguous or float64 x, a w of another width, a 4-D x
    and an empty shape all raise."""
    from paddle_tpu_torch.ops.fused_conv1x1_bn import conv1x1_stats

    x, w = torch.randn(8, 4), torch.randn(3, 4)
    conv1x1_stats(x, w)
    with pytest.raises(ValueError, match="contiguous"):
        conv1x1_stats(torch.randn(4, 8).t(), w)
    with pytest.raises(ValueError, match="float32"):
        conv1x1_stats(x.double(), w)
    with pytest.raises(ValueError, match="shape"):
        conv1x1_stats(x, torch.randn(3, 5))
    with pytest.raises(ValueError, match="shape"):
        conv1x1_stats(x, w, torch.randn(4))
    with pytest.raises(ValueError, match=r"x \[M, K\]"):
        conv1x1_stats(x.reshape(2, 2, 2, 4), w)
    with pytest.raises(ValueError, match="M, K, N >= 1"):
        conv1x1_stats(torch.randn(0, 4), w)
    with pytest.raises(ValueError, match="contiguous"):
        conv1x1_stats(torch.randn(4, 8).t().requires_grad_(), w)
