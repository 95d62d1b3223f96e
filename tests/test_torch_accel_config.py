"""The port under the JAX package's accelerator tracking configuration
(``tracking_stride=3``, ``estep_scale=2``, ``motion_model="constvel"``,
``capture_backend="band"``; volumes stay float32): the background-only
slice against the JAX pipeline, the escale-2 E-step with a culled object
against the JAX package's, and the port's own gates that mirror the JAX
ones for that configuration (``tests/test_accuracy_gate_objects.py``,
``tests/test_object_survival.py``), all on the CPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from emfusion_tpu.config import Params as JaxParams
from emfusion_tpu.pipeline import EMFusionPipeline as JaxPipeline
from emfusion_tpu_torch import kernels
from emfusion_tpu_torch.config import Params
from emfusion_tpu_torch.pipeline import EMFusionPipeline, state_from_numpy
from emfusion_tpu_torch.segmentation import (
    CallableMaskProvider, Detection, make_score_vector,
)
from synthetic import SyntheticScene
from test_accuracy_gate_objects import _make_sequence
from test_torch_pipeline import BASE, EXACT, VOXEL, sequence
from test_torch_pipeline_objects import GATE, OBJ_KEYS

torch.set_num_threads(2)

# the accelerator configuration's tracking knobs (pipeline.py:167-176,
# 261-264, 387-411 of the JAX package resolve `auto` to these on a chip)
ACCEL = dict(tracking_stride=3, estep_scale=2, motion_model="constvel",
             capture_backend="band")
STATE_KEYS = ("bg_tsdf", "bg_weights", "bg_pose", "bg_assoc", "cam_pose")


def angle(a, b):
    """The small angle between two float32 rotations, from the skew part
    of ``Ra^T Rb`` (the trace's arccos cannot resolve 1e-4 rad from the
    rotations' float32 rounding)."""
    d = a[:3, :3].astype(np.float64).T @ b[:3, :3].astype(np.float64)
    v = np.array([d[2, 1] - d[1, 2], d[0, 2] - d[2, 0], d[1, 0] - d[0, 1]])
    return float(np.arcsin(min(np.linalg.norm(v) / 2.0, 1.0)))


@pytest.fixture(scope="module")
def background_runs():
    """Six frames of the background-only sequence of
    ``tests/test_torch_pipeline.py`` at 128^3 in both packages with stride
    3, escale 2 and the constant-velocity start (the JAX side on its exact
    backends and capture sampler otherwise), frame by frame: before every
    frame the two packages' predicted motions, after it their poses; and
    the JAX state and recorded poses after frame 2."""
    frames, _ = sequence()
    cfg = {**BASE, **EXACT, **ACCEL, "capture_backend": "auto"}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("EMF_TRACK_SAMPLER", "capture")
        jpipe = JaxPipeline(JaxParams(**cfg), None)
    pipe = EMFusionPipeline(Params(**cfg), device="cpu", sampler="capture")
    assert (pipe.stride, pipe.escale, pipe.motion_model) == (3, 2, "constvel")
    before = dict(kernels.launches)
    deltas, snap = [], None
    for f, depth in enumerate(frames):
        jd, pd = jpipe._motion_delta(), pipe.motion_delta()
        deltas.append((None if jd is None else np.asarray(jd), pd,
                       sorted(jpipe.poses)[-2:], sorted(pipe.poses)[-2:]))
        jpipe.process_frame(None, depth, timestamp=float(f))
        jpipe.flush()
        pipe.process_frame(None, depth, timestamp=float(f))
        if f == 2:
            snap = dict(arrays={k: np.array(getattr(jpipe.state, k))
                                for k in STATE_KEYS},
                        poses=dict(jpipe.poses))
    assert kernels.launches == before
    return dict(cfg=cfg, frames=frames, jax=jpipe, port=pipe, deltas=deltas,
                snap=snap)


def test_background_slice_matches_jax(background_runs):
    """Before every frame both packages predict the same motion from the
    same two recorded frames (none before frame 2), and every frame's
    camera pose agrees within 0.1 voxel and 1e-3 rad."""
    jpipe, pipe = background_runs["jax"], background_runs["port"]
    for f, (jd, pd, jkeys, pkeys) in enumerate(background_runs["deltas"]):
        assert (jd is None) == (pd is None) == (f < 2), f
        if pd is not None:
            assert pkeys == jkeys == [f - 2, f - 1]
            np.testing.assert_allclose(pd.numpy(), jd, rtol=0, atol=1e-5)
    for f in range(len(background_runs["frames"])):
        a, b = pipe.poses[f], jpipe.poses[f]
        assert np.linalg.norm(a[:3, 3] - b[:3, 3]) < 0.1 * VOXEL, f
        assert angle(a, b) < 1e-3, f
    assert np.linalg.norm(pipe.poses[5][:3, 3]) > 0.05   # the camera moved
    np.testing.assert_allclose(pipe.state.bg_assoc.numpy(),
                               np.asarray(jpipe.state.bg_assoc), rtol=0,
                               atol=1e-4)


def test_carry_over_continues_constvel(background_runs):
    """The JAX state after frame 2 and its recorded poses, loaded into the
    port (``state_from_numpy``, ``load_state(poses=)``): the port's frame
    3 starts from the JAX package's constant-velocity prediction and ends
    within 1e-4 m and 1e-4 rad of the JAX frame 3's camera pose."""
    snap = background_runs["snap"]
    pipe = EMFusionPipeline(Params(**background_runs["cfg"]), device="cpu",
                            sampler="capture")
    pipe.load_state(state_from_numpy(snap["arrays"], device="cpu"), frame=3,
                    poses=snap["poses"])
    jd = background_runs["deltas"][3][0]
    np.testing.assert_array_equal(pipe.motion_delta().numpy(), jd)
    pipe.process_frame(None, background_runs["frames"][3], timestamp=3.0)
    a, b = pipe.poses[3], background_runs["jax"].poses[3]
    assert np.abs(a[:3, 3] - b[:3, 3]).max() < 1e-4
    assert angle(a, b) < 1e-4


def rigid_provider(masks):
    def detect(rgb, f):
        return [Detection(mask=masks[f], scores=make_score_vector(3, 0.9))
                ] if f in masks else []
    return CallableMaskProvider(detect)


def run_rigid(over, snap_at=None, sampler=None):
    """The port over the rigid scene of the JAX object gate; the object's
    trajectory, and the state's arrays after frame ``snap_at``. Before
    every frame from 2 on, the constant-velocity model reads the poses of
    the two frames before it (mask frames record theirs before the
    lifecycle, the others at their end)."""
    _, frames, masks, obj_x = _make_sequence(grow=False)
    pipe = EMFusionPipeline(Params(**dict(GATE, **over)),
                            rigid_provider(masks), device="cpu",
                            sampler=sampler)
    snap, reads = None, []
    for f, depth in enumerate(frames):
        if f >= 2:
            assert sorted(pipe.poses)[-2:] == [f - 2, f - 1]
        pipe.process_frame(None, depth, timestamp=float(f))
        if pipe.last_batched_lm is not None and f > 0:
            reads.append((pipe.last_batched_lm["host_reads"],
                          pipe.last_batched_lm["loop_iterations"]))
        if f == snap_at:
            s, o = pipe.state, pipe.state.objs
            snap = {k: getattr(s, k).numpy().copy() for k in STATE_KEYS}
            snap["objs"] = {k: getattr(o, k).numpy().copy() for k in OBJ_KEYS}
    ids = pipe.active_object_ids
    return dict(pipe=pipe, frames=frames, obj_x=obj_x, ids=ids, reads=reads,
                traj=pipe.obj_poses[ids[0]] if ids else {}, snap=snap)


@pytest.fixture(scope="module")
def rigid_accel():
    return run_rigid(ACCEL, snap_at=4, sampler="capture")


def test_rigid_scene_gate(rigid_accel):
    """The JAX object gate (``test_accuracy_gate_objects.py:127-165``)
    under the port's accelerator configuration: the object is tracked, its
    x-motion recovers 0.35-2.0 of the truth, and its centre stays within
    8 object voxels of the port's exact path every frame. The batched LM
    reads the device at most twice a call."""
    exact = run_rigid({})
    acc = rigid_accel
    assert acc["ids"] == exact["ids"] == [1]
    assert acc["pipe"].object_lm == "batched"
    assert exact["pipe"].object_lm == "serial"
    traj, obj_x = acc["traj"], acc["obj_x"]
    fs = sorted(traj)
    dx_est = traj[fs[-1]][0, 3] - traj[fs[0]][0, 3]
    dx_true = obj_x[fs[-1]] - obj_x[fs[0]]
    assert 0.35 * dx_true < dx_est < 2.0 * dx_true, (dx_est, dx_true)
    vs = max(float(p.state.objs.voxel_size[p._slot_of(1)])
             for p in (acc["pipe"], exact["pipe"]))
    common = sorted(set(traj) & set(exact["traj"]))
    assert len(common) == len(acc["frames"])
    for f in common:
        d = np.linalg.norm(traj[f][:3, 3] - exact["traj"][f][:3, 3])
        assert d < 8.0 * vs, (f, d, vs)
    assert len(acc["reads"]) == len(acc["frames"]) - 1
    assert all(0 < r <= 2 for r, n in acc["reads"])


def test_escale_estep_matches_jax(rigid_accel):
    """The E-step at escale 2 with a live object whose box footprint
    exceeds the ``estep_obj_subset`` budget (48 points on the half-scale
    grid), on one state: the port's after frame 4 of the rigid scene,
    carried into both packages, and frame 5's point map. The background
    and object association images agree within 1e-5 at every pixel."""
    snap = rigid_accel["snap"]
    cfg = dict(GATE, **ACCEL, estep_obj_subset=48)
    pipe = EMFusionPipeline(Params(**cfg), device="cpu")
    pipe.load_state(state_from_numpy(snap, device="cpu"), frame=5)
    _, points = pipe.preprocess(rigid_accel["frames"][5])
    slots = [int(k) for k in np.nonzero(snap["objs"]["active"])[0]]
    assert len(slots) == 1
    _, _, inside = pipe.culled_points(
        slots[0], points[:, ::2, ::2].contiguous())
    assert int(inside.sum()) > 48                   # the budget culls
    pipe.estep(points, slots)

    jpipe = JaxPipeline(JaxParams(**cfg), None)
    js = jpipe.state
    o = snap["objs"]
    jstate = js.replace(
        **{k: jnp.asarray(snap[k]) for k in STATE_KEYS},
        objs=js.objs.replace(**{k: jnp.asarray(o[k]) for k in OBJ_KEYS}))
    jstate, _ = jpipe._estep_subset(jstate, jnp.asarray(points.numpy()),
                                    jnp.asarray(slots, jnp.int32))
    np.testing.assert_allclose(pipe.state.bg_assoc.numpy(),
                               np.asarray(jstate.bg_assoc), rtol=0,
                               atol=1e-5)
    port_obj = pipe.state.objs.assoc.numpy()
    np.testing.assert_allclose(port_obj, np.asarray(jstate.objs.assoc),
                               rtol=0, atol=1e-5)
    assert port_obj.shape == (GATE["max_objects"], 120, 160)
    kept = port_obj[slots[0]] > 0
    # each kept grid point covers a 2 x 2 block of pixels
    assert 0 < kept.sum() <= 4 * 48


def test_receding_object_survives():
    """The receding-object scene of ``tests/test_object_survival.py:25-75``
    (a background volume of 5.12 m at 128^3, the object receding 1 cm a
    frame for 14 frames, a mask every frame) under the port's accelerator
    configuration: the object is alive and visible at the end. The image
    is cut from 640x480 to 160x120 at the same field of view (f 525 ->
    131.25), and the pixel-count thresholds with it (visibility 1600 ->
    100, mask size 2500 -> 156, boundary 20 -> 5 pixels), so that the
    plain versions' raycasts fit the CPU's time."""
    H, W, vol_m, res = 120, 160, 5.12, 128
    scene = SyntheticScene(
        H=H, W=W, f=131.25, floor_y=0.8,
        bg_spheres=((np.array([-0.6, 0.0, 2.0]), 0.55),
                    (np.array([0.7, -0.5, 2.4]), 0.4)),
        obj_sphere_r=0.18)
    params = Params(frameSize=(W, H), fx=131.25, fy=131.25, cx=79.5,
                    cy=59.5, globalVolumeDims=(res, res, res),
                    globalVoxelSize=vol_m / res,
                    volumePose=(0.0, 0.0, vol_m / 2), visibilityThresh=100,
                    mask_min_pixels=156, boundary=5, **ACCEL)
    masks = {}
    pipe = EMFusionPipeline(params, rigid_provider(masks), device="cpu",
                            sampler="capture")
    for f in range(14):
        th = 0.004 * f
        c, s = np.cos(th), np.sin(th)
        cam = np.array([[c, 0, s, 0.01 * f], [0, 1, 0, -0.005 * f],
                        [-s, 0, c, 0.002 * f], [0, 0, 0, 1]], np.float32)
        depth, masks[f] = scene.render(
            cam, np.array([0.55, 0.25, 1.6 + 0.01 * f]))
        pipe.process_frame(None, depth)
    assert pipe.active_object_ids == [1]
    k = pipe._slot_of(1)
    assert int(pipe.last_raycast["vis_counts"][k]) > params.visibilityThresh
