"""The port's slice as a whole: the background-only frame step of
``EMFusionPipeline`` (preprocess, E-step, camera LM, E-step, E-step,
raycast, fusion) against the JAX pipeline on the CPU, over the synthetic
sequence of ``tests/test_accuracy_gate.py``, and the carry-over of a JAX
state into the port."""

import numpy as np
import pytest
import torch

from emfusion_tpu.config import Params as JaxParams
from emfusion_tpu.eval.ate import evaluate_ate as jax_ate
from emfusion_tpu.pipeline import EMFusionPipeline as JaxPipeline
from emfusion_tpu_torch import kernels
from emfusion_tpu_torch.config import Params
from emfusion_tpu_torch.eval.ate import evaluate_ate
from emfusion_tpu_torch.pipeline import EMFusionPipeline, state_from_numpy
from synthetic import SyntheticScene

torch.set_num_threads(2)

N_FRAMES = 6
RES = 128
VOXEL = 2.56 / RES
# the gate's exact-path configuration (tests/test_accuracy_gate.py)
BASE = dict(frameSize=(160, 120), fx=130.0, fy=130.0, cx=79.5, cy=59.5,
            globalVolumeDims=(RES, RES, RES), globalVoxelSize=VOXEL,
            volumePose=(0.0, 0.0, 1.28), objVolumeDims=(16, 16, 16),
            maxTrackingIter=50, raycast_max_steps=256, max_objects=4,
            maskRCNNFrames=1000)
EXACT = dict(fusion_backend="gather", raycast_backend="march",
             tracking_stride=1, estep_scale=1, matmul_bf16=False,
             volume_dtype="float32")
STATE_KEYS = ("bg_tsdf", "bg_weights", "bg_pose", "bg_assoc", "cam_pose")


def sequence():
    scene = SyntheticScene(
        H=120, W=160, f=130.0, floor_y=0.75,
        bg_spheres=((np.array([-0.45, 0.05, 1.3]), 0.35),
                    (np.array([0.5, -0.3, 1.5]), 0.3)),
        obj_sphere_r=0.0)
    frames, gt = [], {}
    for i in range(N_FRAMES):
        th = 0.006 * i
        c, s = np.cos(th), np.sin(th)
        cam = np.array([[c, 0, s, 0.012 * i],
                        [0, 1, 0, -0.008 * i],
                        [-s, 0, c, 0.004 * i],
                        [0, 0, 0, 1]], np.float32)
        frames.append(scene.render(cam, np.array([9.0, 9.0, 9.0]))[0])
        gt[float(i)] = cam
    return frames, gt


def state_arrays(state):
    return {k: np.array(getattr(state, k)) for k in STATE_KEYS}


@pytest.fixture(scope="module")
def runs():
    """Both packages over the sequence, both with the capture sampler
    (``EMF_TRACK_SAMPLER=capture`` on the JAX side, read at construction;
    ``sampler="capture"`` on the port's): this file holds the capture LM
    of both packages, ``test_torch_gather_lm.py`` their default (gather)
    LM. The JAX state is kept after frames 1 and 2."""
    frames, gt = sequence()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("EMF_TRACK_SAMPLER", "capture")
        jax_pipe = JaxPipeline(JaxParams(**BASE, **EXACT), None)
    assert jax_pipe.track_cfg.sampler == "capture"
    snaps = {}
    for f, depth in enumerate(frames):
        jax_pipe.process_frame(None, depth, timestamp=float(f))
        if f in (1, 2):
            snaps[f] = state_arrays(jax_pipe.state)
    jax_poses = {float(f): p for f, p in jax_pipe.poses.items()}

    pipe = EMFusionPipeline(Params(**BASE, **EXACT), device="cpu",
                            sampler="capture")
    before = dict(kernels.launches)
    for f, depth in enumerate(frames):
        pipe.process_frame(None, depth, timestamp=float(f))
    assert kernels.launches == before      # the CPU takes the plain twins
    port_poses = {float(f): p for f, p in pipe.poses.items()}
    return dict(frames=frames, gt=gt, jax=jax_poses, port=port_poses,
                snaps=snaps, pipe=pipe)


def test_slice_camera_poses_match_jax(runs):
    """Per frame, camera positions within 0.1 voxel and orientations
    within 1e-3 rad of the JAX pipeline's. The two sum the LM's 6x6
    system and the fused volumes' running averages in other orders, and
    the small differences carry from frame to frame through the volume."""
    jax_poses, port_poses = runs["jax"], runs["port"]
    assert sorted(port_poses) == sorted(jax_poses) == \
        [float(i) for i in range(N_FRAMES)]
    for f in jax_poses:
        a, b = port_poses[f], jax_poses[f]
        assert np.linalg.norm(a[:3, 3] - b[:3, 3]) < 0.1 * VOXEL, f
        c = (np.trace(a[:3, :3].T @ b[:3, :3]) - 1.0) / 2.0
        assert np.arccos(np.clip(c, -1, 1)) < 1e-3, f
    # the camera moved about 7 cm over the sequence, and both followed
    assert np.linalg.norm(port_poses[5.0][:3, 3]) > 0.05


def test_slice_ate_no_worse_than_jax(runs):
    """ATE against the ground truth, each package through its own
    evaluator: the port's at most 1.05x the JAX one + 1 mm, and under a
    quarter voxel."""
    gt = runs["gt"]
    r_port = evaluate_ate(runs["port"], gt, max_difference=0.5)
    r_jax = jax_ate(runs["jax"], gt, max_difference=0.5)
    assert r_port["pairs"] == r_jax["pairs"] == N_FRAMES
    assert r_port["rmse"] <= 1.05 * r_jax["rmse"] + 0.001, (r_port, r_jax)
    assert r_port["rmse"] < 0.25 * VOXEL


def test_slice_records_timestamps_phases_and_raycast(runs):
    pipe = runs["pipe"]
    assert pipe.timestamps == {f: float(f) for f in range(N_FRAMES)}
    calls = pipe.timer.counts
    assert calls["preprocess"] == calls["integrate"] == N_FRAMES
    for name in ("estep_pre", "track_camera", "estep_mid", "estep_post",
                 "raycast"):
        assert calls[name] == N_FRAMES - 1, name
    rc = pipe.last_raycast
    assert rc["mask"].float().mean() > 0.3
    assert rc["vertices"].shape == (3, 120, 160)
    assert pipe.last_track_stats["iterations"] > 0


def test_state_carry_over_from_jax(runs):
    """The JAX state after frame 1, moved with ``state_from_numpy``: the
    port's frame 2 from it gives the JAX frame 2's camera pose within
    1e-4 m and 1e-4 rad, and its volumes: tsdf and weights agree within
    1e-5 at all but 0.1% of the voxels, those whose centre projects
    within rounding of a pixel boundary, where the pose's last bits pick
    the neighbouring pixel."""
    snaps, frames = runs["snaps"], runs["frames"]
    pipe = EMFusionPipeline(Params(**BASE, **EXACT), device="cpu",
                            sampler="capture")
    state = state_from_numpy(snaps[1], device="cpu")
    assert state.bg_tsdf.shape == (RES, RES, RES)
    pipe.load_state(state, frame=2)
    pipe.process_frame(None, frames[2], timestamp=2.0)
    assert sorted(pipe.poses) == [2]
    a, b = pipe.poses[2], snaps[2]["cam_pose"]
    assert np.abs(a[:3, 3] - b[:3, 3]).max() < 1e-4
    c = (np.trace(a[:3, :3].T @ b[:3, :3]) - 1.0) / 2.0
    assert np.arccos(np.clip(c, -1, 1)) < 1e-4
    for key in ("bg_tsdf", "bg_weights"):
        port = getattr(pipe.state, key).numpy()
        off = np.abs(port - snaps[2][key]) > 1e-5
        assert off.mean() <= 1e-3, (key, off.sum())
        assert not np.array_equal(port, snaps[1][key])
    np.testing.assert_allclose(pipe.state.bg_assoc.numpy(),
                               snaps[2]["bg_assoc"], rtol=1e-5, atol=1e-6)
