"""Rules of the port that keep it honest.

- Every framework-free module it copies from the JAX package is a verbatim
  copy, with ``paddle_tpu.`` renamed to ``paddle_tpu_torch.``. The stated
  exceptions: ``config/config_parser.py`` drops its ``_ensure_compat_path()``
  call (``compat/paddle`` resolves to the JAX package), and
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
    "resilience/__init__.py", "resilience/faultinject.py",
    "utils/concurrency.py", "utils/logging.py", "utils/error.py", "utils/registry.py",
)
# the one deliberate change to a copy: the port never puts compat/ on sys.path
DROPPED = {"config/config_parser.py": "    _ensure_compat_path()\n"}


def _read(path):
    with open(path) as f:
        return f.read()


@pytest.mark.parametrize("rel", COPIES)
def test_copy_is_verbatim(rel):
    want = _read(os.path.join(REPO, "paddle_tpu", rel)).replace("paddle_tpu.", "paddle_tpu_torch.")
    if rel in DROPPED:
        assert want.count(DROPPED[rel]) == 1
        want = want.replace(DROPPED[rel], "")
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
    from paddle_tpu_torch.ops.fused_attention_gru import ATTENTION_GRU_FWD
    from paddle_tpu_torch.ops.fused_gru import GRU_FWD

    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    paths = {k.library_path() for k in (GRU_FWD, ATTENTION_GRU_FWD)}
    assert len(paths) == 2
    for p in paths:
        assert p.startswith(os.path.join(REPO, "build", "paddle_tpu_torch") + os.sep)
    for k in (GRU_FWD, ATTENTION_GRU_FWD):
        assert os.path.isfile(k.source_path)
        assert k.argtypes[-1] is _build.PTR                # the stream
