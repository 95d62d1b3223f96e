"""Port parity: the background raycast (kernel K4's plain version) and its
gradient normals, against ``emfusion_tpu/ops/raycast.raycast_volume`` fed
with ``ops/fusion.compute_gradients`` on the CPU, on the fused scene of
``test_torch_fusion``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emfusion_tpu.ops.fusion import compute_gradients
from emfusion_tpu.ops.raycast import raycast_volume as jax_raycast
from emfusion_tpu_torch import kernels
from emfusion_tpu_torch.ops.raycast import (
    raycast_volume, raycast_volume_plain,
)
from test_torch_fusion import TRUNC, VOXEL, fused_scene, rel_co

torch.set_num_threads(2)


@pytest.mark.parametrize("frame, max_steps", [(1, 256), (3, 256), (2, 12)])
def test_raycast_volume_matches_jax(frame, max_steps):
    """The same adaptive march, t* interpolation, weight check and
    back-face cull. Normals: the port samples the forward differences at
    the 8 corners instead of reading a gradient volume; the sums are the
    same. Both march the same float32 steps, so the hit masks agree
    exactly and raylengths and vertices within 1e-5 (a ray's result ends
    a chain of up to hundreds of dependent steps, and XLA may fuse a
    product and a sum that PyTorch rounds apart). Normals within 1e-4: a
    unit normal is the gradient over its norm, and where the TSDF is
    nearly flat (differences of a few hundredths per voxel) a 1e-6 shift
    of t* moves it by up to ~1e-4. ``max_steps=12`` cuts most rays
    short."""
    tsdf, weights, depths, intr = fused_scene()
    H, W = depths[0].shape
    R, t = rel_co(frame)
    ref = jax_raycast(jnp.asarray(tsdf), compute_gradients(jnp.asarray(tsdf)),
                      jnp.asarray(weights), jnp.asarray(R), jnp.asarray(t),
                      jnp.asarray(intr), VOXEL, TRUNC, H, W,
                      max_steps=max_steps)
    before = dict(kernels.launches)
    out = raycast_volume(torch.tensor(tsdf), torch.tensor(weights),
                         torch.tensor(R), torch.tensor(t), torch.tensor(intr),
                         VOXEL, TRUNC, H, W, max_steps=max_steps)
    assert kernels.launches == before
    mask = np.asarray(ref["mask"])
    np.testing.assert_array_equal(out["mask"].numpy(), mask)
    if max_steps > 100:
        assert mask.mean() > 0.3
    for key, tol in (("raylengths", 1e-5), ("vertices", 1e-5),
                     ("normals", 1e-4)):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   rtol=0, atol=tol, err_msg=key)
    # normals are unit vectors where hit
    n = np.linalg.norm(out["normals"].numpy()[:, mask], axis=0)
    np.testing.assert_allclose(n, 1.0, atol=1e-5)
    # a vertex lies where the depth camera saw the surface (within the
    # fused volume's resolution) for the frames that were fused
    if frame == 1 and max_steps > 100:
        d = depths[1]
        ok = mask & (d > 0)
        z = out["vertices"].numpy()[2][ok]
        assert np.median(np.abs(z - d[ok])) < VOXEL


def test_raycast_stats_leave_outputs():
    """The march counts of the plain version: asking for them changes no
    output, the per-ray phase-2 steps add up to the total, and half the
    volume zeroed shows up as samples that read 8 zero corners."""
    tsdf, weights, depths, intr = fused_scene()
    tsdf, weights = tsdf.copy(), weights.copy()
    tsdf[:, :, :tsdf.shape[2] // 2] = 0.0
    weights[:, :, :weights.shape[2] // 2] = 0.0
    H, W = depths[0].shape
    R, t = rel_co(1)
    args = (torch.tensor(tsdf), torch.tensor(weights), torch.tensor(R),
            torch.tensor(t), torch.tensor(intr), VOXEL, TRUNC, H, W, 256)
    st = {}
    counted = raycast_volume_plain(*args, stats=st)
    plain = raycast_volume_plain(*args)
    for key in plain:
        assert torch.equal(counted[key], plain[key]), key
    assert int(st["steps_phase2"].sum()) == st["steps"] > 0
    assert st["steps_phase1"].shape == st["steps_phase2"].shape == (H, W)
    assert 0 < st["zero_samples"] < st["samples"] <= st["steps"]
    assert 0 <= st["weight_samples"] < st["samples"]
