"""The batched object LM of the accelerator configuration against the JAX
package on the CPU: the batched capture
(``geometry.capture.capture_neighborhoods_batched``), the two-stage
fixed-cache LM (``tracking.track_volumes_batched``) and the pipeline's
batched object step (``EMFusionPipeline.track_objects`` under
``capture_backend="band"``, against the JAX pipeline's
``_track_objs_subset(..., subset_unroll=len(slots))``), on the fused
object volume of the rigid scene of ``tests/test_accuracy_gate_objects.py``.

The LMs track the object against its own frame's points (moved half an
object voxel for the pipeline step), not the next frame's: the object
moves 1 cm (two object voxels) a frame there, and a fixed-cache stage
that has to follow that far loses every point from its windows and
stops with zero weights, in both packages alike, which would leave the
weights nothing to compare.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emfusion_tpu.config import Params as JaxParams
from emfusion_tpu.geometry import se3 as jse3
from emfusion_tpu.geometry.capture import (
    capture_neighborhoods_batched as jax_capture_batched,
)
from emfusion_tpu.pipeline import EMFusionPipeline as JaxPipeline
from emfusion_tpu.segmentation import CallableMaskProvider as JaxProvider
from emfusion_tpu.segmentation import Detection as JaxDetection
from emfusion_tpu.tracking import TrackConfig as JaxTrackConfig
from emfusion_tpu.tracking import track_volumes_batched as jax_batched
from emfusion_tpu_torch import kernels
from emfusion_tpu_torch.config import Params
from emfusion_tpu_torch.geometry.capture import capture_neighborhoods_batched
from emfusion_tpu_torch.pipeline import (
    EMFusionPipeline, ObjectMeta, state_from_numpy,
)
from emfusion_tpu_torch.segmentation import make_score_vector
from emfusion_tpu_torch.tracking import TrackConfig, track_volumes_batched
from test_accuracy_gate_objects import _make_sequence
from test_torch_pipeline_objects import GATE, jax_arrays

torch.set_num_threads(2)

SNAP_FRAME = 4      # the JAX state after this frame (one live object)
SHIFT = 0.5         # the pipeline step's point shift, in object voxels


def test_capture_batched_matches_jax():
    """3 slots of 32^3 at three voxel sizes, random poses, points inside
    the volumes, across their faces and beyond them: both packages read
    the same clipped voxels and take the same unclipped anchors, bit for
    bit."""
    rng = np.random.RandomState(0)
    S, res, M = 3, 32, 600
    vols = rng.uniform(-1, 1, (S, 2, res, res, res)).astype(np.float32)
    T = np.asarray(jse3.se3_exp(jnp.asarray(
        rng.normal(0, 0.3, (S, 6)).astype(np.float32))))
    vs = np.array([0.01, 0.013, 0.008], np.float32)
    # points in each volume's frame, up to 1.4 half-extents from its
    # centre, then in the camera's
    half = (res * vs / 2)[:, None, None]
    p_vol = rng.uniform(-1.4, 1.4, (S, 3, M)) * half
    pts = np.einsum("sji,sjm->sim", T[:, :3, :3],
                    p_vol - T[:, :3, 3, None]).astype(np.float32)
    jc, ja = jax_capture_batched(
        jnp.asarray(vols), jnp.asarray(pts), jnp.asarray(T[:, :3, :3]),
        jnp.asarray(T[:, :3, 3]), jnp.asarray(vs))
    before = dict(kernels.launches)
    pc, pa = capture_neighborhoods_batched(
        torch.tensor(vols[:, 0]), torch.tensor(vols[:, 1]),
        torch.tensor(pts), torch.tensor(T[:, :3, :3]),
        torch.tensor(T[:, :3, 3]), torch.tensor(vs))
    assert kernels.launches == before      # the CPU takes the plain version
    assert pc.shape == (S, 2, 6, 6, 6, M) and pa.dtype == torch.int32
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    ja = np.asarray(ja)
    inside = ((ja >= 0) & (ja + 6 <= res)).all(axis=1)
    assert inside.sum() > 20 and (~inside).sum() > 20   # clipping exercised


@pytest.fixture(scope="module")
def carried():
    """The JAX pipeline over the rigid scene up to frame ``SNAP_FRAME``
    (its state with one live object, its host bookkeeping and poses) and
    that frame's point map from its preprocessing."""
    _, frames, masks, _ = _make_sequence(grow=False)

    def provider(rgb, f):
        return [JaxDetection(mask=masks[f], scores=make_score_vector(3, 0.9))
                ] if f in masks else []

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("EMF_TRACK_SAMPLER", "capture")
        pipe = JaxPipeline(JaxParams(**GATE), JaxProvider(provider))
    for f in range(SNAP_FRAME + 1):
        pipe.process_frame(None, frames[f], timestamp=float(f))
        pipe.flush()
    _, points = pipe._preprocess(jnp.asarray(frames[SNAP_FRAME]))
    slots = [int(k) for k in np.nonzero(np.asarray(pipe.state.objs.active))[0]]
    assert len(slots) == 1
    return dict(pipe=pipe, state=pipe.state, arrays=jax_arrays(pipe),
                points=np.asarray(points), slots=slots,
                meta={i: dataclasses.asdict(m) for i, m in pipe.meta.items()},
                next_id=pipe._next_id, poses=dict(pipe.poses))


def object_case(carried, budget=4096):
    """The live object's volumes, its top-``budget`` association-weighted
    points and the re-orthonormalised camera-to-object start."""
    st, k = carried["state"], carried["slots"][0]
    pts = carried["points"].reshape(3, -1)
    assoc = np.asarray(st.objs.assoc[k]).reshape(-1)
    idx = np.argsort(-assoc, kind="stable")[:budget]
    rel = np.linalg.inv(np.asarray(st.objs.pose[k])) @ np.asarray(st.cam_pose)
    rel = np.asarray(jse3.reorthonormalize(jnp.asarray(rel.astype(np.float32))))
    return dict(tsdf=np.asarray(st.objs.tsdf[k]),
                weights=np.asarray(st.objs.weights[k]),
                vs=float(np.asarray(st.objs.voxel_size[k])),
                pts=pts[:, idx], assoc=assoc[idx], rel=rel)


def angle(a, b):
    """The small angle between two float32 rotations, from the skew part
    of ``Ra^T Rb`` (the trace's arccos cannot resolve 1e-4 rad from the
    rotations' float32 rounding)."""
    d = a[:3, :3].astype(np.float64).T @ b[:3, :3].astype(np.float64)
    v = np.array([d[2, 1] - d[1, 2], d[0, 2] - d[2, 0], d[1, 0] - d[0, 1]])
    return float(np.arcsin(min(np.linalg.norm(v) / 2.0, 1.0)))


def test_track_volumes_batched_matches_jax(carried):
    """Three slots of the fused object against its frame's points, with a
    30-iteration budget (stages of 15): slot 0 starts at the pipeline's
    start and converges in stage 1, slot 1 starts 1.9 object voxels off
    and needs stage 2 (a re-capture), slot 2 is inactive. The two packages
    sum the (S, 6, M) x (S, M, 6) systems in another order, so the
    iterates differ in the last bits: final translations within 0.01
    object voxel and rotations within 1e-4 rad, the same converged flags
    and re-captures, iterations within 3, the last weights within 1e-5.
    The call reads the device at most twice (once a stage)."""
    c = object_case(carried)
    S, vs = 3, c["vs"]
    rels = np.stack([c["rel"]] * S).astype(np.float32)
    off = np.eye(4, dtype=np.float32)
    off[:3, 3] = np.array([1.5, -1.0, 0.5], np.float32) * vs
    rels[1] = off @ rels[1]
    active = np.array([True, True, False])
    args = [np.stack([c[key]] * S) for key in ("tsdf", "weights")] + [
        np.full(S, vs, np.float32), np.stack([c["pts"]] * S),
        np.stack([c["assoc"]] * S), rels]
    ref, ref_st = jax_batched(*map(jnp.asarray, args),
                              JaxTrackConfig(max_iter=30),
                              jnp.asarray(active))
    ref = np.asarray(ref)
    before = dict(kernels.launches)
    out, st = track_volumes_batched(*map(torch.tensor, args),
                                    TrackConfig(max_iter=30),
                                    torch.tensor(active))
    assert kernels.launches == before
    out = out.numpy()
    for s in range(S):
        assert np.linalg.norm(out[s, :3, 3] - ref[s, :3, 3]) < 0.01 * vs, s
        assert angle(out[s], ref[s]) < 1e-4, s
    np.testing.assert_array_equal(st["converged"].numpy(),
                                  np.asarray(ref_st["converged"]))
    np.testing.assert_array_equal(st["recaptures"].numpy(),
                                  np.asarray(ref_st["recaptures"]))
    assert st["recaptures"].tolist() == [0, 1, 0]
    it, ref_it = st["iterations"].numpy(), np.asarray(ref_st["iterations"])
    assert np.abs(it - ref_it).max() <= 3, (it, ref_it)
    assert it[0] < 15 < it[1] and it[2] == 0
    np.testing.assert_array_equal(out[2], rels[2])      # inactive: kept
    for key in ("track_weights", "huber_weights"):
        np.testing.assert_allclose(st[key].numpy(), np.asarray(ref_st[key]),
                                   rtol=0, atol=1e-5)
    assert not st["track_weights"][2].any()
    assert st["dropped_points"].shape == (S,)
    assert st["dropped_points"][2] == 0 and st["dropped_points"].min() >= 0
    assert (st["huber_weights"][:2] != 0).sum(dim=1).min() > 300
    assert st["host_reads"] <= 2
    assert st["loop_iterations"] == it[1]     # stage 1's 15, then slot 1


def port_pipeline(carried, **over):
    """A port pipeline under ``capture_backend="band"`` continuing from
    the carried JAX state (``state_from_numpy``)."""
    pipe = EMFusionPipeline(Params(**dict(GATE, capture_backend="band",
                                          **over)), device="cpu")
    pipe.load_state(state_from_numpy(carried["arrays"], device="cpu"),
                    frame=SNAP_FRAME + 1,
                    meta={i: ObjectMeta(**m) for i, m in carried["meta"].items()},
                    next_id=carried["next_id"], poses=carried["poses"])
    assert pipe.object_lm == "batched"
    return pipe


@pytest.mark.parametrize("budget", [4096, 192])
def test_pipeline_batched_object_step_matches_jax(carried, budget):
    """The pipeline's batched object step on the carried state and its
    frame's points moved half an object voxel along x: the JAX pipeline's
    ``_track_objs_subset`` with ``subset_unroll`` against the port's
    ``track_objects``, at the default budget of 4096 points (the object's
    association footprint is ~420 pixels, so the top 4096 are mostly
    zero-weight points, ties that both break by the lower index) and at
    192, below the footprint (as
    ``test_subset_lm_drift_at_overflowing_footprint``). Object poses
    within 0.01 object voxel and 1e-4 rad; the scattered track and huber
    weight images with the same support and within 1e-5."""
    slots = carried["slots"]
    k = slots[0]
    vs = float(carried["arrays"]["objs"]["voxel_size"][k])
    points = carried["points"].copy()
    points[0] += np.where(points[2] > 0, np.float32(SHIFT * vs), 0.0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("EMF_TRACK_SAMPLER", "capture")
        jpipe = (carried["pipe"] if budget == 4096 else JaxPipeline(
            JaxParams(**GATE, obj_track_points=budget), None))
    state, tw, hw = jpipe._track_objs_subset(
        carried["state"], jnp.asarray(points),
        jnp.asarray(slots, jnp.int32), subset_unroll=len(slots))
    pipe = port_pipeline(carried, obj_track_points=budget)
    before = dict(kernels.launches)
    pipe.track_objects(torch.tensor(points), slots)
    assert kernels.launches == before
    oid = int(pipe.state.objs.object_id[k])
    a, b = pipe.state.objs.pose[k].numpy(), np.asarray(state.objs.pose[k])
    assert np.linalg.norm(a[:3, 3] - b[:3, 3]) < 0.01 * vs
    assert angle(a, b) < 1e-4
    assert np.linalg.norm(a[:3, 3] - carried["arrays"]["objs"]["pose"][k][
        :3, 3]) > 0.25 * vs                           # the object moved
    ptw, phw = pipe.last_obj_track_weights[oid]
    for port, ref in ((ptw, np.asarray(tw)[0]), (phw, np.asarray(hw)[0])):
        assert port.shape == ref.shape == (120, 160)
        np.testing.assert_array_equal(port.numpy() != 0, ref != 0)
        np.testing.assert_allclose(port.numpy(), ref, rtol=0, atol=1e-5)
    assert 150 < np.count_nonzero(np.asarray(hw)[0]) <= budget
    lm = pipe.last_batched_lm
    assert lm["points"] == budget and lm["slots"] == 1
    assert lm["host_reads"] <= 2
    stats = pipe.last_obj_track_stats[oid]
    assert stats["iterations"] > 0 and stats["recaptures"] in (0, 1)
