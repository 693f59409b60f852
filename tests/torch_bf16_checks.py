"""Comparisons of the port's bf16 results with the JAX package's.

The bf16 plain versions round where the Pallas kernels do in bf16; where
one step's rounding points are compared, results agree elementwise within
one bf16 spacing (:func:`assert_within_one_ulp`); over a sequence or a
whole step, where float32 sums taken in another order may flip a rounding
and the flip propagates, within 1e-2 of the reference's largest magnitude
(:func:`assert_within_scale`: a bf16 ulp there is 2^-8 of it).
"""

import jax.numpy as jnp
import numpy as np
import torch

BF16_SCALE_TOL = 1e-2


def f32(a) -> np.ndarray:
    """A torch tensor or a jax array (bf16 or not) as a float32 numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.array(jnp.asarray(a).astype(jnp.float32))


def bf16(a: np.ndarray):
    """The same float32 array rounded to bf16 (to the nearest, ties to even)
    as a jax array and as a torch tensor."""
    return jnp.asarray(a).astype(jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


def assert_within_one_ulp(got, want, name="", floor=0.0):
    """Elementwise within one bf16 spacing of the larger magnitude: the same
    float32 value rounded at the same point, or a neighbour where the float32
    sums, taken in another order, straddle a rounding boundary. With
    ``floor``, the spacing is taken at no less than that fraction of the
    tensor's scale: where a float32 sum cancels to far below its terms, two
    summation orders differ by several of the result's own bf16 ulps."""
    got, want = f32(got), f32(want)
    big = np.maximum(np.abs(got), np.abs(want))
    if want.size:
        big = np.maximum(big, floor * np.abs(want).max())
    ulp = np.exp2(np.floor(np.log2(np.maximum(big, np.finfo(np.float32).tiny))) - 7)
    assert (np.abs(got - want) <= ulp).all(), (name, float(np.abs(got - want).max()))


def assert_within_scale(got, want, name="", tol=BF16_SCALE_TOL):
    got, want = f32(got), f32(want)
    scale = float(np.abs(want).max())
    assert np.abs(got - want).max() <= tol * scale, (
        name, float(np.abs(got - want).max()), scale)
