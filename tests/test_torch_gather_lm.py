"""The port's exact LM: the gather sampler (``sample_system_at_points`` and
``track_volume``'s gather branch) against the JAX package's, and the
port's default against the JAX package's default on the CPU, which is the
gather sampler (``tracking.py:148-150``): no ``EMF_TRACK_SAMPLER`` is set
on either side here.

The capture-against-capture parity tests stay in ``test_torch_tracking``,
``test_torch_pipeline`` and ``test_torch_pipeline_objects``, which pass
``capture`` to both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emfusion_tpu.config import Params as JaxParams
from emfusion_tpu.geometry import sampling as jax_sampling
from emfusion_tpu.geometry import se3 as jse3
from emfusion_tpu.geometry.camera import backproject_depth
from emfusion_tpu.pipeline import EMFusionPipeline as JaxPipeline
from emfusion_tpu.segmentation import CallableMaskProvider as JaxProvider
from emfusion_tpu.segmentation import Detection as JaxDetection
from emfusion_tpu.tracking import TrackConfig as JaxTrackConfig
from emfusion_tpu.tracking import track_volume as jax_track
from emfusion_tpu_torch import kernels
from emfusion_tpu_torch.config import Params, resolve_params
from emfusion_tpu_torch.geometry.sampling import sample_system_at_points
from emfusion_tpu_torch.pipeline import EMFusionPipeline
from emfusion_tpu_torch.segmentation import (
    CallableMaskProvider, Detection, make_score_vector,
)
from emfusion_tpu_torch.tracking import TrackConfig, track_volume
from test_accuracy_gate_objects import _make_sequence
from test_torch_fusion import VOXEL, fused_scene, rel_co
from test_torch_pipeline import BASE, EXACT
from test_torch_pipeline import VOXEL as SLICE_VOXEL
from test_torch_pipeline import sequence
from test_torch_pipeline_objects import GATE, angle, drive

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def no_sampler_override(monkeypatch):
    """Both packages read ``EMF_TRACK_SAMPLER`` at construction: run every
    test here with it unset, so each takes its default."""
    monkeypatch.delenv("EMF_TRACK_SAMPLER", raising=False)


def points_around(shape, vs, R, t, n, seed):
    """Camera-frame points whose grid coordinates cover every axis from
    2.5 voxels below 0 to 1.5 past ``res`` (inside, on and past each of
    the margin-1 and margin-2 bounds and the clipped corners), with 20
    points at each of those bounds per axis, and a tenth moved behind the
    camera (z <= 0)."""
    Z, Y, X = shape
    rng = np.random.RandomState(seed)
    res = np.array([X, Y, Z], np.float64)[:, None]
    v = rng.uniform(-2.5, 1.5, (3, n)) + rng.uniform(0, 1, (3, n)) * res
    for a, r in enumerate((X, Y, Z)):
        edges = np.array([-1.0, -0.5, 0.0, 0.5, r - 3, r - 2.5, r - 2,
                          r - 1.5, r - 1])
        k = len(edges) * 20
        v[a, a * k:(a + 1) * k] = np.repeat(edges, 20)
    p = (v - (res - 1) / 2) * vs
    pc = (R.T @ (p - t[:, None])).astype(np.float32)
    pc[2, :n // 10] = -np.abs(pc[2, :n // 10])
    return pc


@pytest.mark.parametrize("gather", ["scalar", "rows"])
@pytest.mark.parametrize("seed", [0, 1])
def test_sample_system_matches_jax(gather, seed, monkeypatch):
    """ψ and the gradient ``g3`` at random poses, at points near and past
    every bound, against both of the JAX package's gather forms
    (``EMF_GATHER=scalar`` and ``rows`` compute the same values): 1e-6
    abs (both evaluate the same trilerps in the same order)."""
    monkeypatch.setattr(jax_sampling, "_GATHER_BACKEND", gather)
    rng = np.random.RandomState(10 + seed)
    shape, vs = (20, 24, 28), 0.05
    vol = rng.uniform(-1, 1, shape).astype(np.float32)
    xi = rng.normal(0, 0.3, 6).astype(np.float32)
    R = np.asarray(jse3.se3_exp(jnp.asarray(xi)))[:3, :3]
    # the camera 2 m behind the volume's centre along its own z
    t = (-R @ np.array([0.0, 0.0, 2.0], np.float32)).astype(np.float32)
    pts = points_around(shape, vs, R, t, 6000, seed)
    psi_ref, g3_ref = jax_sampling.sample_system_at_points(
        jnp.asarray(vol), jnp.asarray(pts), jnp.asarray(R), jnp.asarray(t),
        vs)
    psi, g3 = sample_system_at_points(torch.tensor(vol), torch.tensor(pts),
                                      torch.tensor(R), torch.tensor(t), vs)
    assert g3.shape == (3, 6000)
    np.testing.assert_allclose(psi.numpy(), np.asarray(psi_ref), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(g3.numpy(), np.asarray(g3_ref), rtol=0,
                               atol=1e-6)
    # the case mix: valid and invalid values, and gradients cut by the
    # per-shift bounds
    valid = np.asarray(psi_ref) != 0
    assert 0.1 < valid.mean() < 0.9
    assert ((np.asarray(g3_ref) == 0) & valid[None]).any()


def camera_jump(off_voxels):
    """Frame 2's points of the two-frame fused scene, and a start
    ``off_voxels`` voxels from frame 2's pose along x."""
    tsdf, weights, depths, intr = fused_scene()
    pts = np.asarray(backproject_depth(jnp.asarray(depths[2]),
                                       jnp.asarray(intr))).reshape(3, -1)
    assoc = np.ones(pts.shape[1], np.float32)
    R, t = rel_co(2)
    init = np.eye(4, dtype=np.float32)
    init[:3, :3] = R
    init[:3, 3] = t + np.array([off_voxels * VOXEL, 0.0, 0.0], np.float32)
    return tsdf, weights, pts, assoc, init


@pytest.mark.parametrize("off", [5, 6])
def test_default_lm_after_camera_jump_matches_jax_default(off):
    """The fault ROADMAP section 3.1 recorded: a camera jump of 5-6
    voxels, where the capture sampler spends its re-capture budget and
    points drop out of their windows (JAX ``sampler="capture"``:
    ``recaptures == max_recaptures`` and ``dropped_points > 0``), and its
    pose parts from the gather sampler's by more than a voxel. There the
    port's default LM follows the JAX package's default (gather) to 0.01
    voxel, with no dropped points and no re-captures."""
    tsdf, weights, pts, assoc, init = camera_jump(off)
    args = [jnp.asarray(a) for a in (tsdf, weights)] + [VOXEL] + [
        jnp.asarray(a) for a in (pts, assoc, init)]
    cap, cap_st = jax_track(*args, JaxTrackConfig(max_iter=50,
                                                  sampler="capture"))
    assert int(cap_st["recaptures"]) == JaxTrackConfig().max_recaptures
    assert int(cap_st["dropped_points"]) > 0
    ref, ref_st = jax_track(*args, JaxTrackConfig(max_iter=50))
    ref = np.asarray(ref)
    assert np.linalg.norm(np.asarray(cap)[:3, 3] - ref[:3, 3]) > VOXEL
    before = dict(kernels.launches)
    out, st = track_volume(*map(torch.tensor, (tsdf, weights)), VOXEL,
                           *map(torch.tensor, (pts, assoc, init)),
                           TrackConfig(max_iter=50))
    assert kernels.launches == before
    out = out.numpy()
    assert np.linalg.norm(out[:3, 3] - ref[:3, 3]) < 0.01 * VOXEL
    assert angle(out, ref) < 1e-4
    assert st["dropped_points"] == 0 and st["recaptures"] == 0
    assert abs(st["iterations"] - int(ref_st["iterations"])) <= 10


@pytest.mark.parametrize("start", ["previous", "jittered"])
def test_track_volume_gather_matches_jax(start):
    """``test_torch_tracking``'s two starts with the gather sampler asked
    for by name on both sides: poses within 1e-4 m and 1e-4 rad, the last
    combined weights within 1e-3, iterations within 10 (the LM sums its
    system in another order, and may stop a few iterations apart)."""
    tsdf, weights, depths, intr = fused_scene()
    pts = np.asarray(backproject_depth(jnp.asarray(depths[2]),
                                       jnp.asarray(intr))).reshape(3, -1)
    assoc = np.random.RandomState(4).uniform(
        0.5, 1.0, pts.shape[1]).astype(np.float32)
    R0, t0 = rel_co(1) if start == "previous" else rel_co(2, 0.03, seed=9)
    init = np.eye(4, dtype=np.float32)
    init[:3, :3], init[:3, 3] = R0, t0
    init = np.asarray(jse3.reorthonormalize(jnp.asarray(init)))
    ref, ref_st = jax_track(
        jnp.asarray(tsdf), jnp.asarray(weights), VOXEL, jnp.asarray(pts),
        jnp.asarray(assoc), jnp.asarray(init),
        JaxTrackConfig(max_iter=50, sampler="gather"))
    ref = np.asarray(ref)
    out, st = track_volume(torch.tensor(tsdf), torch.tensor(weights), VOXEL,
                           torch.tensor(pts), torch.tensor(assoc),
                           torch.tensor(init),
                           TrackConfig(max_iter=50, sampler="gather"))
    out = out.numpy()
    assert np.abs(out[:3, 3] - ref[:3, 3]).max() < 1e-4
    assert angle(out, ref) < 1e-4
    assert abs(st["iterations"] - int(ref_st["iterations"])) <= 10
    np.testing.assert_allclose(st["track_weights"].numpy(),
                               np.asarray(ref_st["track_weights"]),
                               rtol=0, atol=1e-3)


def test_sampler_resolution(monkeypatch):
    """``auto`` is the gather sampler, and the capture sampler under
    ``capture_backend="band"``; the pipeline reads ``EMF_TRACK_SAMPLER``
    at construction, an explicit ``sampler`` overrides it, and an unknown
    name raises."""
    assert TrackConfig().sampler == "gather"
    with pytest.raises(ValueError):
        TrackConfig(sampler="auto")
    params = Params(**BASE, **EXACT)
    band = Params(**BASE, **EXACT, capture_backend="band")
    assert resolve_params(params).sampler == "gather"
    assert resolve_params(band).sampler == "capture"
    assert resolve_params(band, "gather").sampler == "gather"
    assert EMFusionPipeline(params, device="cpu").sampler == "gather"
    assert EMFusionPipeline(band, device="cpu").sampler == "capture"
    monkeypatch.setenv("EMF_TRACK_SAMPLER", "capture")
    assert EMFusionPipeline(params, device="cpu").sampler == "capture"
    assert EMFusionPipeline(params, device="cpu",
                            sampler="auto").sampler == "gather"
    assert EMFusionPipeline(params, device="cpu").track_cfg.sampler \
        == "capture"
    with pytest.raises(ValueError):
        EMFusionPipeline(params, device="cpu", sampler="band")


@pytest.fixture(scope="module")
def background():
    """The background-only slice of ``test_torch_pipeline`` in both
    packages with their default samplers, and the port's LM counts of
    every frame."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("EMF_TRACK_SAMPLER", raising=False)
        jpipe = JaxPipeline(JaxParams(**BASE, **EXACT), None)
    assert jpipe.track_cfg.sampler == "auto"
    frames, _ = sequence()
    pipe = EMFusionPipeline(Params(**BASE, **EXACT), device="cpu")
    counts = []
    for f, depth in enumerate(frames):
        jpipe.process_frame(None, depth, timestamp=float(f))
        pipe.process_frame(None, depth, timestamp=float(f))
        counts.append(pipe.lm_counts())
    return dict(jax=dict(jpipe.poses), port=dict(pipe.poses), counts=counts)


def test_background_slice_default_matches_jax_default(background):
    """Camera positions within 0.1 voxel and rotations within 1e-3 rad of
    the JAX pipeline's every frame (the bound of
    ``test_torch_pipeline``), with no re-capture and no dropped point."""
    jp, pp = background["jax"], background["port"]
    assert sorted(pp) == sorted(jp)
    for f in jp:
        assert np.linalg.norm(pp[f][:3, 3] - jp[f][:3, 3]) \
            < 0.1 * SLICE_VOXEL, f
        assert angle(pp[f], jp[f]) < 1e-3, f
    assert np.linalg.norm(pp[max(pp)][:3, 3]) > 0.05
    for c in background["counts"][1:]:
        assert c["camera"]["iterations"] > 0
        assert c["camera"]["recaptures"] == c["camera"]["dropped_points"] \
            == 0


@pytest.fixture(scope="module")
def rigid_default():
    """The rigid object scene of ``test_torch_pipeline_objects`` in both
    packages with their default samplers."""
    _, frames, masks, _ = _make_sequence(grow=False)

    def jax_provider(rgb, f):
        return [JaxDetection(mask=masks[f], scores=make_score_vector(3, 0.9))
                ] if f in masks else []

    def provider(rgb, f):
        return [Detection(mask=masks[f], scores=make_score_vector(3, 0.9))
                ] if f in masks else []

    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("EMF_TRACK_SAMPLER", raising=False)
        jpipe = JaxPipeline(JaxParams(**GATE), JaxProvider(jax_provider))
    pipe = EMFusionPipeline(Params(**GATE), CallableMaskProvider(provider),
                            device="cpu")
    assert pipe.sampler == "gather" and pipe.object_lm == "serial"
    jax_run = drive(jpipe, frames,
                    lambda p, k: float(np.asarray(p.state.objs.voxel_size)[k]))
    port_run = drive(pipe, frames,
                     lambda p, k: float(p.state.objs.voxel_size[k]))
    return dict(jax=jax_run, port=port_run,
                stats=pipe.last_obj_track_stats)


def test_rigid_scene_default_matches_jax_default(rigid_default):
    """The same lifecycle (live ids and voxel sizes after every frame),
    camera positions within 0.1 background voxel and object positions
    within 0.1 object voxel of the JAX pipeline's every frame, rotations
    within 1e-3 rad; the object LM drops no point."""
    jr, pr = rigid_default["jax"], rigid_default["port"]
    assert [r["ids"] for r in pr["rec"]] == [r["ids"] for r in jr["rec"]]
    assert all(r["ids"] == [1] for r in pr["rec"])
    for a, b in zip(pr["rec"], jr["rec"]):
        for oid, vs in b["vs"].items():
            assert abs(a["vs"][oid] - vs) <= 1e-6 * vs
    for f in jr["poses"]:
        a, b = pr["poses"][f], jr["poses"][f]
        assert np.linalg.norm(a[:3, 3] - b[:3, 3]) \
            < 0.1 * GATE["globalVoxelSize"], f
        assert angle(a, b) < 1e-3, f
    vs = jr["rec"][-1]["vs"][1]
    for f, b in jr["obj_poses"][1].items():
        a = pr["obj_poses"][1][f]
        assert np.linalg.norm(a[:3, 3] - b[:3, 3]) < 0.1 * vs, f
        assert angle(a, b) < 1e-3, f
    st = rigid_default["stats"][1]
    assert st["dropped_points"] == st["recaptures"] == 0
