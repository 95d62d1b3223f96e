"""Port parity: depth preprocessing (kernel K5's plain version, the
bilateral filter) and the camera model, against
``emfusion_tpu/geometry/camera.py`` on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emfusion_tpu.geometry import camera as jcam
from emfusion_tpu_torch import kernels
from emfusion_tpu_torch.geometry import camera as pcam

torch.set_num_threads(2)


def noisy_depth(H, W, seed):
    """A sloped surface with steps, sensor noise and holes (zeros)."""
    rng = np.random.RandomState(seed)
    ys, xs = np.mgrid[0:H, 0:W]
    d = 1.2 + 0.8 * xs / W + 0.3 * ys / H
    d[:, W // 2:] += 0.25                      # a depth edge
    d += rng.normal(0.0, 0.01, (H, W))
    d[rng.uniform(size=(H, W)) < 0.1] = 0.0    # dropouts
    d[:3, :5] = 0.0                            # a hole at the border
    return d.astype(np.float32)


def intr_for(H, W):
    f = 0.8 * W
    return np.array([[f, 0, W / 2 - 0.5], [0, f, H / 2 - 0.5], [0, 0, 1]],
                    np.float32)


CASES = [(60, 80, 7, 0.04, 4.5), (120, 160, 7, 0.04, 4.5),
         (61, 83, 5, 0.1, 2.0)]


@pytest.mark.parametrize("H, W, k, sd, ss", CASES)
def test_bilateral_and_preprocess_match_jax(H, W, k, sd, ss):
    """Reflect-101 borders and zero taps left out, as the JAX filter.
    Tolerance 2e-6 m (a few float32 ulps at 4 m): both sum the same taps
    in the same order, but XLA's and PyTorch's vectorised exp may differ
    in the last bit.

    The filter is compared where the raw depth is positive: at a pixel
    whose raw depth is 0, every tap's weight can fall into float32's
    denormal range, which XLA flushes to zero and PyTorch keeps, so the
    two may return 0 and a depth there. ``preprocess_depth`` zeroes those
    pixels, and it is compared everywhere."""
    raw = noisy_depth(H, W, seed=H + W)
    ref_f = np.asarray(jcam.bilateral_filter(jnp.asarray(raw), k, sd, ss))
    ref_p = np.asarray(jcam.preprocess_depth(jnp.asarray(raw), k, sd, ss))
    before = dict(kernels.launches)
    out_f = pcam.bilateral_filter(torch.tensor(raw), k, sd, ss).numpy()
    out_p = pcam.preprocess_depth(torch.tensor(raw), k, sd, ss).numpy()
    assert kernels.launches == before       # the CPU takes the plain twin
    seen = raw > 0
    np.testing.assert_allclose(out_f[seen], ref_f[seen], rtol=0, atol=2e-6)
    np.testing.assert_allclose(out_p, ref_p, rtol=0, atol=2e-6)
    np.testing.assert_array_equal(out_p == 0, ref_p == 0)
    assert (out_p[raw == 0] == 0).all()


@pytest.mark.parametrize("H, W", [(60, 80), (120, 160)])
def test_backproject_and_project_match_jax(H, W):
    """Back-projection is elementwise: 1 ulp. Projection rounds half to
    even on both sides: the pixels agree exactly, including points built
    to land on .5 boundaries."""
    raw = noisy_depth(H, W, seed=3)
    intr = intr_for(H, W)
    ref = np.asarray(jcam.backproject_depth(jnp.asarray(raw),
                                            jnp.asarray(intr)))
    pts = pcam.backproject_depth(torch.tensor(raw), torch.tensor(intr))
    np.testing.assert_allclose(pts.numpy(), ref, rtol=1.2e-7, atol=1e-7)

    f, cx = intr[0, 0], intr[0, 2]
    half = np.zeros((3, 4), np.float32)          # x = k + 0.5 exactly
    half[2] = 1.0
    half[0] = (np.array([10.5, 11.5, 12.5, -0.5]) - cx) / f
    cases = [ref.reshape(3, -1), half]
    for p in cases:
        jx, jy, jz = jcam.project_points(jnp.asarray(p), jnp.asarray(intr))
        qx, qy, qz = pcam.project_points(torch.tensor(p), torch.tensor(intr))
        np.testing.assert_array_equal(qx.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(qy.numpy(), np.asarray(jy))
        np.testing.assert_array_equal(qz.numpy(), np.asarray(jz))
