"""Port parity: projective TSDF fusion (kernel K1's plain version) and the
gradient volume, against ``emfusion_tpu/ops/fusion.py`` on the CPU.

Also home of :func:`fused_scene`, the small fused background volume the
other port parity tests share: the synthetic spheres-and-floor scene of
``tests/synthetic.py`` fused over two frames by the JAX package.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emfusion_tpu.ops.fusion import compute_gradients as jax_gradients
from emfusion_tpu.ops.fusion import integrate_tsdf as jax_integrate
from emfusion_tpu_torch import kernels
from emfusion_tpu_torch.ops.fusion import compute_gradients, integrate_tsdf
from synthetic import SyntheticScene

torch.set_num_threads(2)

RES = 48
VOXEL = 2.56 / RES
TRUNC = 10 * VOXEL
VOL_POSE_T = np.array([0.0, 0.0, 1.28], np.float32)


def cam_pose(i):
    """Camera-to-world pose of frame ``i`` (world = frame-0 camera)."""
    th = 0.012 * i
    c, s = np.cos(th), np.sin(th)
    return np.array([[c, 0, s, 0.02 * i],
                     [0, 1, 0, -0.012 * i],
                     [-s, 0, c, 0.008 * i],
                     [0, 0, 0, 1]], np.float32)


def rel_oc(i):
    """Volume-to-camera transform of frame ``i`` (rotation, translation)."""
    T = np.linalg.inv(cam_pose(i)).astype(np.float32)
    T[:3, 3] += T[:3, :3] @ VOL_POSE_T
    return T[:3, :3].copy(), T[:3, 3].copy()


def rel_co(i, jitter=0.0, seed=0):
    """Camera-to-volume transform of frame ``i``, optionally perturbed by
    a small rotation and translation (an LM iterate's pose)."""
    R, t = rel_oc(i)
    Ri, ti = R.T.copy(), (-R.T @ t).astype(np.float32)
    if jitter:
        rng = np.random.RandomState(seed)
        a = rng.normal(0, jitter, 3)
        K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
        Ri = ((np.eye(3) + K) @ Ri).astype(np.float32)
        ti = (ti + rng.normal(0, jitter, 3)).astype(np.float32)
    return Ri, ti


@functools.lru_cache(maxsize=None)
def fused_scene(n_fused=2, H=60, W=80):
    """(tsdf, weights, depth frames, intr) of the synthetic scene fused by
    the JAX package over frames 0..n_fused-1 (default carve rules)."""
    scene = SyntheticScene(
        H=H, W=W, f=0.8 * W, floor_y=0.75,
        bg_spheres=((np.array([-0.45, 0.05, 1.3]), 0.35),
                    (np.array([0.5, -0.3, 1.5]), 0.3)),
        obj_sphere_r=0.0)
    depths = [scene.render(cam_pose(i), np.array([9.0, 9.0, 9.0]))[0]
              for i in range(n_fused + 2)]
    intr = scene.intr
    tsdf = jnp.zeros((RES, RES, RES), jnp.float32)
    weights = jnp.zeros((RES, RES, RES), jnp.float32)
    for i in range(n_fused):
        R, t = rel_oc(i)
        tsdf, weights = jax_integrate(
            tsdf, weights, jnp.asarray(depths[i]), jnp.ones((H, W)),
            jnp.asarray(R), jnp.asarray(t), jnp.asarray(intr), VOXEL, TRUNC,
            64.0, carve_dist=0.04, carve_weight_cap=0.0, carve_margin=0.25)
    return np.asarray(tsdf), np.asarray(weights), depths, intr


CARVE_CASES = {
    "reference": dict(),
    "carve_dist": dict(carve_dist=0.04),
    "carve_cap": dict(carve_dist=0.04, carve_weight_cap=0.0),
    "carve_cap_margin": dict(carve_dist=0.04, carve_weight_cap=0.0,
                             carve_margin=0.25),
    "cap_one": dict(carve_dist=0.03, carve_weight_cap=1.0,
                    carve_margin=0.1),
}


@pytest.mark.parametrize("case", sorted(CARVE_CASES))
def test_integrate_tsdf_matches_jax(case):
    """One more frame fused into the two-frame volume, with association
    weights below 1 so the carve rules matter. Tolerance: the two sides
    compute the same float32 arithmetic, but XLA may reassociate, so a
    voxel centre that lands within an ulp of a pixel boundary can round to
    the neighbouring pixel; at most 1 voxel in 10^4 may differ, and every
    other voxel agrees to 1e-5."""
    tsdf0, w0, depths, intr = fused_scene()
    H, W = depths[2].shape
    rng = np.random.RandomState(7)
    assoc = rng.uniform(0.0, 1.0, (H, W)).astype(np.float32)
    R, t = rel_oc(2)
    kw = CARVE_CASES[case]
    jt, jw = jax_integrate(jnp.asarray(tsdf0), jnp.asarray(w0),
                           jnp.asarray(depths[2]), jnp.asarray(assoc),
                           jnp.asarray(R), jnp.asarray(t), jnp.asarray(intr),
                           VOXEL, TRUNC, 64.0, **kw)
    before = dict(kernels.launches)
    pt, pw = torch.tensor(tsdf0), torch.tensor(w0)
    out = integrate_tsdf(pt, pw, torch.tensor(depths[2]),
                         torch.tensor(assoc), torch.tensor(R),
                         torch.tensor(t), torch.tensor(intr), VOXEL, TRUNC,
                         64.0, **kw)
    assert out[0] is pt and out[1] is pw          # updated in place
    assert kernels.launches == before             # CPU: plain version
    for port, ref in ((pt.numpy(), np.asarray(jt)),
                      (pw.numpy(), np.asarray(jw))):
        off = np.abs(port - ref) > 1e-5
        assert off.mean() <= 1e-4, (case, off.sum())
    assert not np.array_equal(pt.numpy(), tsdf0)  # the frame changed it


def test_integrate_tsdf_into_empty_volume_matches_jax():
    """Frame 0 into a zeroed volume: the -1 and 0 rules for unseen voxels
    (same tolerance as above)."""
    _, _, depths, intr = fused_scene()
    H, W = depths[0].shape
    R, t = rel_oc(0)
    z = np.zeros((RES, RES, RES), np.float32)
    jt, jw = jax_integrate(jnp.asarray(z), jnp.asarray(z),
                           jnp.asarray(depths[0]), jnp.ones((H, W)),
                           jnp.asarray(R), jnp.asarray(t), jnp.asarray(intr),
                           VOXEL, TRUNC, 64.0)
    pt, pw = integrate_tsdf(torch.zeros(RES, RES, RES),
                            torch.zeros(RES, RES, RES),
                            torch.tensor(depths[0]), torch.ones(H, W),
                            torch.tensor(R), torch.tensor(t),
                            torch.tensor(intr), VOXEL, TRUNC, 64.0)
    assert (np.asarray(jt) == -1.0).any()
    for port, ref in ((pt.numpy(), np.asarray(jt)),
                      (pw.numpy(), np.asarray(jw))):
        assert (np.abs(port - ref) > 1e-5).mean() <= 1e-4


def test_compute_gradients_matches_jax():
    """Forward differences with the zero outer slab: exact."""
    tsdf, _, _, _ = fused_scene()
    ref = np.asarray(jax_gradients(jnp.asarray(tsdf)))
    np.testing.assert_array_equal(compute_gradients(torch.tensor(tsdf))
                                  .numpy(), ref)
