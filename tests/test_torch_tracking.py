"""Port parity: SE(3) and the camera LM with the capture sampler, against
``emfusion_tpu/geometry/se3.py`` and ``emfusion_tpu/tracking.py`` on the
CPU, on the fused scene of ``test_torch_fusion``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emfusion_tpu.geometry import se3 as jse3
from emfusion_tpu.geometry.camera import backproject_depth
from emfusion_tpu.tracking import TrackConfig as JaxTrackConfig
from emfusion_tpu.tracking import track_volume as jax_track
from emfusion_tpu_torch import kernels
from emfusion_tpu_torch.geometry import se3 as pse3
from emfusion_tpu_torch.tracking import TrackConfig, track_volume
from test_torch_fusion import VOXEL, fused_scene, rel_co

torch.set_num_threads(2)


def twists(n=16, seed=0):
    """Twists with rotation angles from 0 to ~2 rad, through the
    small-angle (Taylor) branches."""
    rng = np.random.RandomState(seed)
    xi = rng.normal(0, 1, (n, 6)).astype(np.float32)
    xi[:, 3:] *= np.logspace(-6, 0.3, n)[:, None]
    xi[0, 3:] = 0.0
    return xi


def test_se3_exp_log_match_jax():
    """Both evaluate the same closed forms in the same order: 2e-6 on
    rotations and rotation vectors.

    Two of the closed forms cancel catastrophically in float32 for small
    angles above the Taylor branches' 1e-4 switch, in both packages:
    ``se3_exp``'s (1 - cos t) / t^2 and ``se3_log``'s
    (1 - t sin t / (2 (1 - cos t))) / t^2. A one-ulp difference between
    XLA's and PyTorch's cos (6e-8 near 1) reaches the exp's translation
    divided by t, so each twist's is held to 2e-6 + 2.4e-7 |upsilon| / t.
    The log's translation is compared where it is conditioned (t <= 1e-4
    or t >= 0.1): between, both packages' values are off by up to metres
    (the reference fault in ROADMAP section 3; the LM reads the log only
    to scale its step-convergence test)."""
    xi = twists()
    theta = np.maximum(np.linalg.norm(xi[:, 3:], axis=1), 1e-6)
    T_ref = np.asarray(jse3.se3_exp(jnp.asarray(xi)))
    T = pse3.se3_exp(torch.tensor(xi)).numpy()
    np.testing.assert_allclose(T[:, :3, :3], T_ref[:, :3, :3], rtol=0,
                               atol=2e-6)
    tol = 2e-6 + 2.4e-7 * np.linalg.norm(xi[:, :3], axis=1) / theta
    assert (np.abs(T[:, :3, 3] - T_ref[:, :3, 3]).max(axis=1) <= tol).all()
    np.testing.assert_array_equal(T[:, 3], T_ref[:, 3])
    R_ref = np.asarray(jse3.so3_exp(jnp.asarray(xi[:, 3:])))
    np.testing.assert_allclose(pse3.so3_exp(torch.tensor(xi[:, 3:]))
                               .numpy(), R_ref, rtol=0, atol=2e-6)
    np.testing.assert_allclose(
        pse3.so3_log(torch.tensor(R_ref)).numpy(),
        np.asarray(jse3.so3_log(jnp.asarray(R_ref))), rtol=0, atol=2e-6)
    log = pse3.se3_log(torch.tensor(T_ref)).numpy()
    log_ref = np.asarray(jse3.se3_log(jnp.asarray(T_ref)))
    np.testing.assert_allclose(log[:, 3:], log_ref[:, 3:], rtol=0,
                               atol=2e-6)
    ok = (theta <= 1e-4) | (theta >= 0.1)
    assert ok.sum() >= 8
    np.testing.assert_allclose(log[ok], log_ref[ok], rtol=0, atol=2e-6)
    np.testing.assert_allclose(log[ok], xi[ok], rtol=0, atol=1e-5)


def test_pose_inverse_and_reorthonormalize_match_jax():
    """Inverse: exact arithmetic on both sides (1e-6). Re-orthonormalised
    rotations: both take a QR with a positive diagonal, 1e-6."""
    T = np.asarray(jse3.se3_exp(jnp.asarray(twists(seed=1))))
    rng = np.random.RandomState(2)
    noisy = T.copy()
    noisy[:, :3, :3] += rng.normal(0, 1e-3, (len(T), 3, 3)).astype(
        np.float32)
    np.testing.assert_allclose(
        pse3.pose_inverse(torch.tensor(T)).numpy(),
        np.asarray(jse3.pose_inverse(jnp.asarray(T))), rtol=0, atol=1e-6)
    for M in noisy:
        ref = np.asarray(jse3.reorthonormalize(jnp.asarray(M)))
        out = pse3.reorthonormalize(torch.tensor(M)).numpy()
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
        np.testing.assert_allclose(out[:3, :3] @ out[:3, :3].T, np.eye(3),
                                   atol=1e-6)


def rot_angle(Ra, Rb):
    c = (np.trace(Ra.T @ Rb) - 1.0) / 2.0
    return float(np.arccos(np.clip(c, -1.0, 1.0)))


@pytest.mark.parametrize("start", ["previous", "jittered"])
def test_track_volume_capture_matches_jax(start):
    """Frame 2 tracked against the two-frame volume from the previous
    frame's pose (the pipeline's start), or from a pose 1-2 voxels off.
    The LM sums its 6x6 system over the points in another order than
    XLA, so the iterates differ in the last bits and the loop may stop a
    few iterations apart (one side meets eps2 while the other runs to
    max_iter); the final poses agree to 1e-4 m and 1e-4 rad (under 0.2%
    of a voxel), and the last combined weights to 1e-3."""
    tsdf, weights, depths, intr = fused_scene()
    pts = np.asarray(backproject_depth(jnp.asarray(depths[2]),
                                       jnp.asarray(intr))).reshape(3, -1)
    rng = np.random.RandomState(4)
    assoc = rng.uniform(0.5, 1.0, pts.shape[1]).astype(np.float32)
    R0, t0 = rel_co(1) if start == "previous" else rel_co(2, 0.03, seed=9)
    init = np.eye(4, dtype=np.float32)
    init[:3, :3], init[:3, 3] = R0, t0
    init = np.asarray(jse3.reorthonormalize(jnp.asarray(init)))
    gt_R, gt_t = rel_co(2)

    ref, ref_stats = jax_track(
        jnp.asarray(tsdf), jnp.asarray(weights), VOXEL, jnp.asarray(pts),
        jnp.asarray(assoc), jnp.asarray(init),
        JaxTrackConfig(max_iter=50, sampler="capture"))
    ref = np.asarray(ref)
    before = dict(kernels.launches)
    out, stats = track_volume(torch.tensor(tsdf), torch.tensor(weights),
                              VOXEL, torch.tensor(pts), torch.tensor(assoc),
                              torch.tensor(init),
                              TrackConfig(max_iter=50, sampler="capture"))
    assert kernels.launches == before
    out = out.numpy()
    assert np.abs(out[:3, 3] - ref[:3, 3]).max() < 1e-4
    assert rot_angle(out[:3, :3], ref[:3, :3]) < 1e-4
    # both starts end at the same optimum, within a voxel of the truth
    # (the coarse two-frame volume biases it)
    assert np.linalg.norm(out[:3, 3] - gt_t) < VOXEL
    assert abs(stats["iterations"] - int(ref_stats["iterations"])) <= 10
    assert stats["recaptures"] == int(ref_stats["recaptures"])
    assert stats["dropped_points"] == int(ref_stats["dropped_points"])
    np.testing.assert_allclose(stats["track_weights"].numpy(),
                               np.asarray(ref_stats["track_weights"]),
                               rtol=0, atol=1e-3)

