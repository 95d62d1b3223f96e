"""The two sensor-noise scenes of ``tests/test_object_survival.py:90-133``
in the port, under the accelerator configuration, with float32 and with
bf16 background volumes (bf16 storage changes the stored values that the
carve rules compare): the receding object survives Gaussian depth noise
and overshoot outliers, and the carve's weight cap does not punch the
noise through settled surfaces. The JAX package runs these gates at its
float32 default on the CPU; here the image is cut from 640x480 to
160x120 at the same field of view, as ``tests/test_torch_accel_config.py``
cut the receding scene (f 525 -> 131.25; visibility 1600 -> 100, mask
size 2500 -> 156, boundary 20 -> 5 pixels), so that the plain versions'
raycasts fit the CPU's time."""

import numpy as np
import pytest
import torch

from emfusion_tpu_torch.config import Params
from emfusion_tpu_torch.pipeline import EMFusionPipeline
from synthetic import SyntheticScene
from test_object_survival import _sensor_noise
from test_torch_accel_config import ACCEL, rigid_provider

torch.set_num_threads(2)

DTYPES = ("float32", "bfloat16")


def run_receding(volume_dtype, n_frames=14, res=128, noise=None, **over):
    """The receding-object scene (a 5.12 m background volume, the object
    receding 1 cm a frame, a mask every frame) at 160x120, the depth
    corrupted by ``noise(depth, frame)`` where given."""
    H, W, vol_m = 120, 160, 5.12
    scene = SyntheticScene(
        H=H, W=W, f=131.25, floor_y=0.8,
        bg_spheres=((np.array([-0.6, 0.0, 2.0]), 0.55),
                    (np.array([0.7, -0.5, 2.4]), 0.4)),
        obj_sphere_r=0.18)
    params = Params(frameSize=(W, H), fx=131.25, fy=131.25, cx=79.5,
                    cy=59.5, globalVolumeDims=(res, res, res),
                    globalVoxelSize=vol_m / res,
                    volumePose=(0.0, 0.0, vol_m / 2), visibilityThresh=100,
                    mask_min_pixels=156, boundary=5,
                    volume_dtype=volume_dtype, **ACCEL, **over)
    masks = {}
    pipe = EMFusionPipeline(params, rigid_provider(masks), device="cpu",
                            sampler="capture")
    for f in range(n_frames):
        th = 0.004 * f
        c, s = np.cos(th), np.sin(th)
        cam = np.array([[c, 0, s, 0.01 * f], [0, 1, 0, -0.005 * f],
                        [-s, 0, c, 0.002 * f], [0, 0, 0, 1]], np.float32)
        depth, masks[f] = scene.render(
            cam, np.array([0.55, 0.25, 1.6 + 0.01 * f]))
        if noise is not None:
            depth = noise(depth, f)
        pipe.process_frame(None, depth)
    assert pipe.state.bg_tsdf.dtype == getattr(torch, volume_dtype)
    return pipe


@pytest.mark.parametrize("volume_dtype", DTYPES)
def test_receding_object_survives_under_sensor_noise(volume_dtype):
    """``test_receding_object_survives_under_sensor_noise``: with Gaussian
    depth noise (5 mm) and 0.5% +20 cm overshoot outliers the receding
    object is alive at the end."""
    pipe = run_receding(volume_dtype, noise=_sensor_noise())
    assert pipe.active_object_ids == [1]


def bg_err(pipe_a, pipe_b) -> float:
    """Mean |tsdf_a - tsdf_b| over the voxels near ``b``'s surfaces that
    both observed (``|tsdf_b| < 0.5``, ``w_b > 2``, ``w_a > 0``), as the
    JAX gate measures it."""
    ta, tb = pipe_a.state.bg_tsdf.float(), pipe_b.state.bg_tsdf.float()
    wa, wb = pipe_a.state.bg_weights.float(), pipe_b.state.bg_weights.float()
    near = (torch.abs(tb) < 0.5) & (wb > 2) & (wa > 0)
    return float(torch.abs(ta - tb)[near].mean())


@pytest.mark.parametrize("volume_dtype", DTYPES)
def test_carve_no_hole_punching_under_noise(volume_dtype):
    """``test_carve_no_hole_punching_under_noise`` (10 frames, 96^3): the
    noisy background deviates from the clean one near surfaces by under
    0.08 tsdf units on average (0.8 voxel of surface jitter in the
    10-voxel band), and the carve's contradiction margin does no worse
    than capping every carve vote (``bg_carve_margin=-2``) within 5%."""
    kw = dict(n_frames=10, res=96)
    clean = run_receding(volume_dtype, **kw)
    gated = run_receding(volume_dtype, noise=_sensor_noise(), **kw)
    ungated = run_receding(volume_dtype, noise=_sensor_noise(),
                           bg_carve_margin=-2.0, **kw)
    e_gated, e_ungated = bg_err(gated, clean), bg_err(ungated, clean)
    assert e_gated < 0.08, e_gated
    assert e_gated <= e_ungated * 1.05, (e_gated, e_ungated)
