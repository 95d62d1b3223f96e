"""Port parity: the projective warps of kernel K6 (``ops/warp.py``, plain
versions) against the JAX package's XLA warps and its Pallas warp kernel
(run in interpret mode, as its own tests run it) on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emfusion_tpu.ops.fusion_pencil import warp_image_to_grid as jwarp
from emfusion_tpu.ops.pallas.warp_pallas import (
    select_grid_at_pixels_pallas, warp_image_to_grid_pallas,
)
from emfusion_tpu.ops.raycast_sweep import warp_grid_to_pixels
from emfusion_tpu_torch import kernels
from emfusion_tpu_torch.ops import warp as pwarp

torch.set_num_threads(2)


def positive_image(H, W, seed):
    """Values in [0.5, 1.5): a wrongly read zero cannot pass for one."""
    rng = np.random.RandomState(seed)
    return (0.5 + rng.rand(H, W)).astype(np.float32)


def flips(a, b):
    """Share of cells whose values differ by more than the Pallas kernel's
    bf16 hi/lo reconstruction error: a different pixel was picked."""
    return float(np.mean(np.abs(a - b) > 1e-3))


@pytest.mark.parametrize("H, W, tilt", [(60, 80, 0.013), (123, 200, -0.3)])
def test_warp_image_to_grid_matches_jax(H, W, tilt):
    """Against the XLA gather (``mxu=False``): the same float32 operations
    in the same order, so the same pixels and the same values, exactly.
    Against the Pallas kernel: the same picks up to its tolerance (its
    own tests allow 0.2% of picks to flip at half-pixel boundaries) and
    values within its bf16 hi/lo reconstruction error. ``tilt < 0`` puts
    part of the grid behind the plane (homogeneous z <= 0), which reads
    0; the grid also reaches past the image on two sides."""
    Bmat = np.array([[W * 0.12, 2.0, W * 0.3], [1.5, H * 0.11, H * 0.25],
                     [tilt, 0.007, 1.0]], np.float32)
    img = positive_image(H, W, seed=H)
    a0, b0, da, db = -2.5, -2.0, 9.0, 8.0
    nS, nL = 75, 112
    ref = np.asarray(jwarp(jnp.asarray(img), jnp.asarray(Bmat), H, W, a0, b0,
                           da, db, nS, nL, mxu=False))
    pallas = np.asarray(warp_image_to_grid_pallas(
        jnp.asarray(img), jnp.asarray(Bmat), H, W, a0, b0, da, db, nS, nL,
        interpret=True))
    before = dict(kernels.launches)
    out = pwarp.warp_image_to_grid(torch.tensor(img), torch.tensor(Bmat), H,
                                   W, a0, b0, da, db, nS, nL).numpy()
    assert kernels.launches == before       # the CPU takes the plain twin
    assert out.shape == (nS, nL)
    assert (out == 0).any() and (out > 0).mean() > 0.2
    np.testing.assert_array_equal(out, ref)
    assert flips(out, pallas) < 2e-3
    keep = np.abs(out - pallas) <= 1e-3
    np.testing.assert_allclose(out[keep], pallas[keep], rtol=5e-5, atol=1e-5)


@pytest.mark.parametrize("SB, LB", [(64, 128), (52, 100)])
def test_select_grid_at_pixels_matches_jax(SB, LB):
    """The port composes the grid-index scaling into the homography, as
    the Pallas kernel does; the XLA warp-back divides in two steps. Both
    floor, so a pixel on a cell boundary may land in the neighbouring
    cell: at most 0.2% of pixels (the Pallas kernel's own tolerance);
    every other pixel reads the same cell's exact value. Pixels that map
    outside the grid clamp to its edge (no zeros)."""
    H, W = 60, 100
    grid = positive_image(SB, LB, seed=3)
    Binv = np.array([[0.0201317, 0.0010071, -0.3013717],
                     [0.0008093, 0.0251893, -0.2041477],
                     [0.0, 0.0, 1.0]], np.float32)
    a0, b0, da, db = 0.0137, 0.0071, 1.10713, 0.90317
    xla = np.asarray(warp_grid_to_pixels(jnp.asarray(grid), jnp.asarray(Binv),
                                         a0, b0, da, db, H, W))
    pallas = np.asarray(select_grid_at_pixels_pallas(
        jnp.asarray(grid), jnp.asarray(Binv), a0, b0, da, db, H, W,
        interpret=True))
    before = dict(kernels.launches)
    out = pwarp.select_grid_at_pixels(torch.tensor(grid), torch.tensor(Binv),
                                      a0, b0, da, db, H, W).numpy()
    assert kernels.launches == before
    assert out.shape == (H, W) and out.min() > 0.0
    for ref, rtol in ((xla, 0.0), (pallas, 5e-5)):
        assert flips(out, ref) < 2e-3
        keep = np.abs(out - ref) <= 1e-3
        np.testing.assert_allclose(out[keep], ref[keep], rtol=rtol,
                                   atol=1e-5 if rtol else 0.0)
