"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with nvcc (they build csrc/ at first use)
and skip without one. The repository's conftest imports JAX, so on a
machine with the card and no JAX run them without it:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Tolerance 1e-4 absolute in float32 with TF32 off (sums over K terms taken
in another order than the plain version's matmuls).
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu
TOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from paddle_tpu_torch.device import resolve_device

    return resolve_device(None)


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)


@pytest.mark.parametrize("T,B,H", [(7, 5, 40), (1, 1, 8), (3, 2, 600)])
@pytest.mark.parametrize("reverse", [False, True])
def test_gru_kernel_matches_plain_version(dev, T, B, H, reverse):
    from paddle_tpu_torch.ops.fused_gru import GRU_FWD, fused_gru, gru_forward_reference

    rng = np.random.RandomState(T * 100 + H)
    # batch-major storage read through a time-major view, as the layer does
    x3 = _t(rng.randn(B, T, 3 * H) * 0.5, dev).transpose(0, 1)
    w = _t(rng.randn(H, 3 * H) / np.sqrt(H), dev)
    lens = rng.randint(0, T + 1, B)
    mask = _t(np.arange(T)[:, None] < lens[None, :], dev)
    before = GRU_FWD.launches
    got = fused_gru(x3, mask, w, reverse=reverse)
    assert GRU_FWD.launches == before + 1
    ref = gru_forward_reference(x3, mask, w, reverse=reverse)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) <= TOL


@pytest.mark.parametrize("Td,Te,B,D,E", [(3, 37, 4, 24, 40), (1, 1, 1, 8, 8), (2, 5, 3, 520, 1040)])
def test_attention_kernel_matches_plain_version(dev, Td, Te, B, D, E):
    from paddle_tpu_torch.ops.fused_attention_gru import (
        ATTENTION_GRU_FWD, attention_gru_reference, attention_gru_step, fused_attention_gru)

    rng = np.random.RandomState(Te * 10 + D)
    r = lambda *s: _t(rng.randn(*s) * 0.3, dev)
    lens = rng.randint(1, Te + 1, B)
    lens[-1] = 0                                      # an all-masked row
    em = _t((np.arange(Te)[:, None] < lens[None, :])[:, :, None], dev)
    ep = r(B, Te, D).transpose(0, 1)                  # strided, as the serve step passes it
    ev = r(B, Te, E).transpose(0, 1)
    args = (ep, ev, em, r(Td, B, 3 * D), _t(rng.rand(Td, B, 1) > 0.3, dev), r(B, D),
            r(D, D), r(1, D), r(1, D), r(E, 3 * D), r(D, 3 * D))
    before = ATTENTION_GRU_FWD.launches
    got = fused_attention_gru(*args)
    ref = attention_gru_reference(*args)
    step = attention_gru_step(args[5], ep, ev, em, args[3][0], *args[6:])
    torch.cuda.synchronize()
    assert ATTENTION_GRU_FWD.launches == before + 2
    assert torch.isfinite(got).all()
    assert float((got - ref).abs().max()) <= TOL
    assert float((step - ref[0]).abs().max()) <= TOL


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    from paddle_tpu_torch.ops.fused_gru import fused_gru

    x3 = torch.zeros(2, 3, 12, device=dev)
    mask = torch.ones(2, 3, device=dev)
    w = torch.zeros(4, 12, device=dev)
    with pytest.raises(ValueError, match="float32"):
        fused_gru(x3.double(), mask, w)
    with pytest.raises(ValueError, match="is on"):
        fused_gru(x3, mask, w.cpu())
    with pytest.raises(ValueError, match="activations"):
        fused_gru(x3, mask, w, acts=("relu", "sigmoid"))
