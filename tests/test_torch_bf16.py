"""bf16 background volumes (``Params.volume_dtype="bfloat16"``, the JAX
package's accelerator storage) in the port against the JAX package on the
CPU: the plain versions of K1-K4 on a bf16 pair against the JAX functions
run under ``jax.jit`` (as the JAX pipeline runs them: XLA computes a bf16
volume's arithmetic in float32 and rounds once where it stores), the
background-only slice on the exact and on the accelerator configuration,
a JAX bf16 state carried into the port, checkpoints both ways, and the
accelerator E-step of a rigid-scene state whose bf16 background shares
one K2 table with a float32 object.

Run as a script, it measures instead (several minutes on one CPU): the
rigid scene of ``tests/test_accuracy_gate_objects.py`` under the
accelerator configuration with float32 and with bf16 background volumes,
in the JAX package and in the port, then in the port with only the tsdf
or only the weights in bf16, and prints each run's x-motion recovery of
the object (the object gate's measure)::

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_bf16.py

The JAX side runs its own capture path there (``EMF_TRACK_SAMPLER=capture``
with ``capture_backend="band"``: its camera LM takes the band capture, a
TPU formulation the port does not have), so the two packages' float32
figures differ; the point is each package's float32 against its bf16."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emfusion_tpu.checkpoint import load_checkpoint as jax_load_checkpoint
from emfusion_tpu.checkpoint import save_checkpoint as jax_save_checkpoint
from emfusion_tpu.config import Params as JaxParams
from emfusion_tpu.geometry import capture as jcap
from emfusion_tpu.geometry.sampling import (
    sample_system_at_points as jax_system,
    sample_volume_at_points as jax_sample,
)
from emfusion_tpu.ops.fusion import compute_gradients as jax_gradients
from emfusion_tpu.ops.fusion import integrate_tsdf as jax_integrate
from emfusion_tpu.ops.raycast import raycast_volume as jax_raycast
from emfusion_tpu.pipeline import EMFusionPipeline as JaxPipeline
from emfusion_tpu.segmentation import CallableMaskProvider as JaxProvider
from emfusion_tpu.segmentation import Detection as JaxDetection
from emfusion_tpu_torch import kernels
from emfusion_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
from emfusion_tpu_torch.config import Params
from emfusion_tpu_torch.geometry.capture import capture_neighborhoods
from emfusion_tpu_torch.geometry.sampling import (
    sample_system_at_points, sample_volume_at_points,
)
from emfusion_tpu_torch.ops.fusion import integrate_tsdf
from emfusion_tpu_torch.ops.raycast import _gradient_sample, raycast_volume
from emfusion_tpu_torch.pipeline import EMFusionPipeline, state_from_numpy
from emfusion_tpu_torch.segmentation import make_score_vector
from synthetic import SyntheticScene
from test_accuracy_gate_objects import _make_sequence
from test_torch_accel_config import ACCEL, angle, rigid_provider
from test_torch_fusion import cam_pose, rel_co, rel_oc
from test_torch_pipeline import BASE, EXACT, STATE_KEYS, VOXEL, sequence
from test_torch_pipeline_objects import GATE, OBJ_KEYS

torch.set_num_threads(2)

RES = 64
VOX = 2.56 / RES
TRUNC = 10 * VOX
CARVE = dict(carve_dist=0.04, carve_weight_cap=0.0, carve_margin=0.25)
BF16 = dict(volume_dtype="bfloat16")


def bits(a) -> np.ndarray:
    """A bf16 array's (numpy, JAX or torch) bits as ordered integers: one
    apart where the values are one bf16 ulp apart."""
    if isinstance(a, torch.Tensor):
        b = a.view(torch.int16).numpy().view(np.uint16)
    else:
        b = np.asarray(a).view(np.uint16)
    b = b.astype(np.int32)
    return np.where(b & 0x8000, -(b & 0x7FFF), b)


@functools.lru_cache(maxsize=None)
def scene64(H=60, W=80):
    """A 64^3 bf16 background pair of the synthetic scene, fused over
    frames 0-1 by the JAX package's jitted fusion with the pipeline's
    carve rules and cast back to bf16 at each store (``pipeline.py:
    755-757``), and the depth frames 0-3."""
    scene = SyntheticScene(
        H=H, W=W, f=0.8 * W, floor_y=0.75,
        bg_spheres=((np.array([-0.45, 0.05, 1.3]), 0.35),
                    (np.array([0.5, -0.3, 1.5]), 0.3)),
        obj_sphere_r=0.0)
    depths = [scene.render(cam_pose(i), np.array([9.0, 9.0, 9.0]))[0]
              for i in range(4)]
    tsdf = jnp.zeros((RES,) * 3, jnp.bfloat16)
    weights = jnp.zeros((RES,) * 3, jnp.bfloat16)
    for i in range(2):
        R, t = rel_oc(i)
        tsdf, weights = fuse_jax(tsdf, weights, jnp.asarray(depths[i]),
                                 jnp.ones((H, W)), jnp.asarray(R),
                                 jnp.asarray(t), jnp.asarray(scene.intr))
    return np.asarray(tsdf), np.asarray(weights), depths, scene.intr


@jax.jit
def fuse_jax(tsdf, weights, depth, assoc, R, t, intr):
    out_t, out_w = jax_integrate(tsdf, weights, depth, assoc, R, t, intr,
                                 VOX, TRUNC, 64.0, **CARVE)
    return out_t.astype(tsdf.dtype), out_w.astype(weights.dtype)


def points(depth, intr, extra=200, seed=3):
    """The frame's back-projected points (3, N) and points scattered
    around and beyond the volume, some behind the camera."""
    H, W = depth.shape
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    z = depth
    pts = np.stack([(xs - intr[0, 2]) / intr[0, 0] * z,
                    (ys - intr[1, 2]) / intr[1, 1] * z, z]).reshape(3, -1)
    rng = np.random.RandomState(seed)
    far = rng.uniform(-1.6, 1.6, (3, extra)).astype(np.float32)
    far[2] += 1.3
    far[2, :20] = -np.abs(far[2, :20])
    return np.concatenate([pts, far], axis=1).astype(np.float32)


def test_fused_bf16_frame_matches_jax():
    """Frame 2 into the 64^3 bf16 pair, with association weights in [0, 1)
    and the pipeline's carve rules (so the weight cap and the margin,
    read from the stored bf16 values, decide): the port's plain K1
    (float32 arithmetic, one round to nearest even at the store) against
    the JAX pipeline's jitted fusion cast back to bf16. The stored bits
    are equal on >= 99.9% of the voxels (measured: the weights on all
    262,144, the tsdf on all but 2, 99.9992%) and at most one bf16 ulp
    apart elsewhere (XLA's jitted float32 arithmetic may round a product
    or a pixel pick apart from PyTorch's, as in the float32 test)."""
    tsdf0, w0, depths, intr = scene64()
    H, W = depths[2].shape
    assoc = np.random.RandomState(7).uniform(0, 1, (H, W)).astype(
        np.float32)
    R, t = rel_oc(2)
    jt, jw = fuse_jax(jnp.asarray(tsdf0), jnp.asarray(w0),
                      jnp.asarray(depths[2]), jnp.asarray(assoc),
                      jnp.asarray(R), jnp.asarray(t), jnp.asarray(intr))
    pt = torch.tensor(tsdf0.astype(np.float32)).to(torch.bfloat16)
    pw = torch.tensor(w0.astype(np.float32)).to(torch.bfloat16)
    np.testing.assert_array_equal(bits(pt), bits(tsdf0))    # lossless
    before = dict(kernels.launches)
    out = integrate_tsdf(pt, pw, torch.tensor(depths[2]),
                         torch.tensor(assoc), torch.tensor(R),
                         torch.tensor(t), torch.tensor(intr), VOX, TRUNC,
                         64.0, **CARVE)
    assert out[0] is pt and pt.dtype == torch.bfloat16
    assert kernels.launches == before
    for port, ref in ((pt, jt), (pw, jw)):
        d = np.abs(bits(port) - bits(ref))
        assert (d == 0).mean() >= 0.999, (d != 0).sum()
        assert d.max() <= 1
    assert (bits(pt) != bits(tsdf0)).mean() > 0.01     # the frame fused


def test_samplers_on_bf16_volume_match_jax():
    """ψ (margins 1 and 2) and the gather LM's ``sample_system_at_points``
    on the bf16 volume, at jittered poses, against the JAX functions on
    the same bf16 volume: both convert the corners to float32 exactly and
    blend them with float32 fractions (no bf16 x bf16 arithmetic, so an
    eager call computes what the jitted pipeline computes; under ``jit``
    XLA also reassociates the float32 grid transform, which moves 13 of
    5,000 values by up to 7e-6 for float32 volumes alike). Values within
    1e-6, with the same exact-zero sentinels; the port's bf16 results
    equal its float32 results on the cast volume bit for bit."""
    tsdf, _, depths, intr = scene64()
    pts = points(depths[2], intr)
    tt = torch.tensor(tsdf.astype(np.float32)).to(torch.bfloat16)
    for jitter in (0.0, 0.01):
        R, t = rel_co(2, jitter)
        args = (jnp.asarray(pts), jnp.asarray(R), jnp.asarray(t))
        targs = (torch.tensor(pts), torch.tensor(R), torch.tensor(t))
        for margin in (1, 2):
            ref = np.asarray(jax_sample(jnp.asarray(tsdf), *args, VOX,
                                        margin=margin))
            out = sample_volume_at_points(tt, *targs, VOX,
                                          margin=margin).numpy()
            np.testing.assert_array_equal(out == 0.0, ref == 0.0)
            np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
            np.testing.assert_array_equal(out, sample_volume_at_points(
                tt.float(), *targs, VOX, margin=margin).numpy())
        jpsi, jg = jax_system(jnp.asarray(tsdf), *args, VOX)
        psi, g = sample_system_at_points(tt, *targs, VOX)
        assert 0.2 < (np.asarray(jpsi) != 0).mean() < 0.99
        np.testing.assert_allclose(psi.numpy(), np.asarray(jpsi), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0,
                                   atol=1e-6 / VOX)


def test_capture_cache_bf16_is_exact():
    """The capture of a bf16 pair is cached in bf16 (the JAX LM casts its
    capture to the volume's dtype, ``tracking.py:157-165``): the port's
    cache equals the JAX capture cast to bf16 bit for bit, with the same
    anchors."""
    tsdf, weights, depths, intr = scene64()
    pts = points(depths[2], intr)
    R, t = rel_co(2)
    jc, ja = jax.jit(lambda v, p, r, s: jcap.capture_neighborhoods(
        v, p, r, s, VOX))(jnp.stack([jnp.asarray(tsdf), jnp.asarray(weights)]),
                          jnp.asarray(pts), jnp.asarray(R), jnp.asarray(t))
    vols = tuple(torch.tensor(v.astype(np.float32)).to(torch.bfloat16)
                 for v in (tsdf, weights))
    pc, pa = capture_neighborhoods(vols, torch.tensor(pts), torch.tensor(R),
                                   torch.tensor(t), VOX)
    assert pc.dtype == torch.bfloat16
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(bits(pc), bits(jc.astype(jnp.bfloat16)))


@pytest.mark.parametrize("frame, max_steps", [(1, 256), (3, 256)])
def test_raycast_bf16_matches_jax(frame, max_steps):
    """The raycast of the bf16 pair against the JAX raycast of the same
    pair fed with ``compute_gradients`` of its float32 cast, as the JAX
    pipeline feeds it (no bf16 x bf16 arithmetic: an eager call computes
    what the jitted pipeline does). The port's bf16 raycast equals its
    float32 raycast of the cast pair bit for bit. Against JAX,
    ``tests/test_torch_raycast.py``'s tolerances and reasons: hit masks
    exactly, raylengths and vertices within 1e-5, normals within 1e-4,
    the bound that its reason (a 1e-6 shift of t* turns the normal by up
    to ~1e-4 where the TSDF changes by a few hundredths, 0.03, a voxel)
    gives wherever |∇ψ| >= 0.03. Where the TSDF is flatter the same
    reason gives 3e-6 / |∇ψ|: 3 pixels of frame 1 (|∇ψ| 0.005-0.008,
    the same on the float32 cast) turn by up to 3.1e-4 there."""
    tsdf, weights, depths, intr = scene64()
    H, W = depths[0].shape
    R, t = rel_co(frame)
    ref = jax_raycast(jnp.asarray(tsdf),
                      jax_gradients(jnp.asarray(tsdf).astype(jnp.float32)),
                      jnp.asarray(weights), jnp.asarray(R), jnp.asarray(t),
                      jnp.asarray(intr), VOX, TRUNC, H, W,
                      max_steps=max_steps)
    vols = [torch.tensor(v.astype(np.float32)).to(torch.bfloat16)
            for v in (tsdf, weights)]
    cam = (torch.tensor(R), torch.tensor(t), torch.tensor(intr), VOX, TRUNC,
           H, W)
    out = raycast_volume(*vols, *cam, max_steps=max_steps)
    out32 = raycast_volume(*(v.float() for v in vols), *cam,
                           max_steps=max_steps)
    for key in out:
        assert torch.equal(out[key], out32[key]), key
    mask = np.asarray(ref["mask"])
    np.testing.assert_array_equal(out["mask"].numpy(), mask)
    assert mask.mean() > 0.3
    for key in ("raylengths", "vertices"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   rtol=0, atol=1e-5, err_msg=key)
    # |∇ψ| at t*, in tsdf units a voxel, from the vertices
    v = (torch.tensor(R) @ out["vertices"].reshape(3, -1)
         + torch.tensor(t)[:, None]) / VOX + (RES - 1) / 2.0
    g = _gradient_sample(vols[0], v[0], v[1], v[2],
                         out["mask"].reshape(-1))
    gn = torch.linalg.vector_norm(g, dim=0).reshape(H, W).numpy()
    tol = np.maximum(1e-4, 3e-6 / np.maximum(gn, 1e-12))
    err = np.abs(out["normals"].numpy() - np.asarray(ref["normals"])).max(0)
    assert (err <= tol).all(), (err.max(), gn[err > tol])


@pytest.fixture(scope="module")
def exact_runs(tmp_path_factory):
    """The background-only sequence of ``tests/test_torch_pipeline.py``
    (6 frames, 128^3) in both packages with bf16 volumes on the exact
    path (the JAX ``EXACT`` backends; both LMs' default, the gather
    sampler); the JAX state and poses after frame 2, and the JAX
    pipeline's checkpoint at the end."""
    frames, _ = sequence()
    cfg = {**BASE, **EXACT, **BF16}
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("EMF_TRACK_SAMPLER", raising=False)
        jpipe = JaxPipeline(JaxParams(**cfg), None)
        pipe = EMFusionPipeline(Params(**cfg), device="cpu")
    assert jpipe.state.bg_tsdf.dtype == jnp.bfloat16
    assert pipe.sampler == "gather"
    snap = None
    for f, depth in enumerate(frames):
        jpipe.process_frame(None, depth, timestamp=float(f))
        jpipe.flush()
        pipe.process_frame(None, depth, timestamp=float(f))
        if f == 2:
            snap = dict(arrays={k: np.array(getattr(jpipe.state, k))
                                for k in STATE_KEYS},
                        poses=dict(jpipe.poses))
    ckpt = str(tmp_path_factory.mktemp("bf16") / "jax.npz")
    jax_save_checkpoint(jpipe, ckpt)
    return dict(cfg=cfg, frames=frames, jax=jpipe, port=pipe, snap=snap,
                ckpt=ckpt, tmp=os.path.dirname(ckpt))


def test_exact_slice_bf16_matches_jax(exact_runs):
    """Every frame's camera pose within 0.1 voxel and 1e-3 rad of the JAX
    pipeline's with bf16 volumes; the port keeps the background pair in
    bf16 and the rest in float32."""
    jpipe, pipe = exact_runs["jax"], exact_runs["port"]
    for f in range(len(exact_runs["frames"])):
        a, b = pipe.poses[f], jpipe.poses[f]
        assert np.linalg.norm(a[:3, 3] - b[:3, 3]) < 0.1 * VOXEL, f
        assert angle(a, b) < 1e-3, f
    assert np.linalg.norm(pipe.poses[5][:3, 3]) > 0.05   # the camera moved
    s = pipe.state
    assert s.bg_tsdf.dtype == s.bg_weights.dtype == torch.bfloat16
    assert s.bg_assoc.dtype == s.objs.tsdf.dtype == torch.float32


def test_bf16_state_carry_over(exact_runs):
    """The JAX bf16 state after frame 2 carried into the port
    (``state_from_numpy`` to float32, stored back in bf16: lossless) and
    continued at frame 3: the pair is the JAX pair bit for bit, and frame
    3's camera pose is within 0.1 voxel and 1e-3 rad of the JAX frame
    3's."""
    snap = exact_runs["snap"]
    pipe = EMFusionPipeline(Params(**exact_runs["cfg"]), device="cpu")
    pipe.load_state(state_from_numpy(snap["arrays"], device="cpu"), frame=3,
                    poses=snap["poses"])
    for k in ("bg_tsdf", "bg_weights"):
        t = getattr(pipe.state, k)
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(bits(t), bits(snap["arrays"][k]))
    pipe.process_frame(None, exact_runs["frames"][3], timestamp=3.0)
    a, b = pipe.poses[3], exact_runs["jax"].poses[3]
    assert np.linalg.norm(a[:3, 3] - b[:3, 3]) < 0.1 * VOXEL
    assert angle(a, b) < 1e-3


def test_checkpoints_bf16_both_ways(exact_runs):
    """Checkpoints hold float32 and cast back on load: the JAX
    bf16-configured checkpoint loads into a bf16 port pipeline with the
    JAX pair bit for bit, and the port's checkpoint of that state loads
    into a bf16 JAX pipeline bit for bit."""
    jpipe = exact_runs["jax"]
    with np.load(exact_runs["ckpt"]) as z:
        assert z["bg_tsdf"].dtype == np.float32
    pipe = EMFusionPipeline(Params(**exact_runs["cfg"]), device="cpu")
    load_checkpoint(pipe, exact_runs["ckpt"])
    for k in ("bg_tsdf", "bg_weights"):
        assert getattr(pipe.state, k).dtype == torch.bfloat16
        np.testing.assert_array_equal(bits(getattr(pipe.state, k)),
                                      bits(getattr(jpipe.state, k)))
    assert pipe.frame == jpipe.frame
    path = os.path.join(exact_runs["tmp"], "port.npz")
    save_checkpoint(pipe, path)
    with np.load(path) as z:
        assert z["bg_weights"].dtype == np.float32
    j2 = JaxPipeline(JaxParams(**exact_runs["cfg"]), None)
    jax_load_checkpoint(j2, path)
    for k in ("bg_tsdf", "bg_weights"):
        assert getattr(j2.state, k).dtype == jnp.bfloat16
        np.testing.assert_array_equal(bits(getattr(j2.state, k)),
                                      bits(getattr(jpipe.state, k)))


def test_accel_slice_bf16_matches_jax():
    """The background-only sequence under the accelerator configuration
    with bf16 volumes in both packages: stride 3, escale 2, the
    constant-velocity start and the capture LM, whose cache is bf16 in
    both (the port's camera captures under ``capture_backend="band"``;
    the JAX side is given ``EMF_TRACK_SAMPLER=capture`` with
    ``capture_backend="auto"`` so that its camera also captures exactly,
    rather than through the band resampling, a TPU formulation the port
    does not have). Before every frame the predicted motions agree within
    1e-5, and every frame's pose within 0.1 voxel and 1e-3 rad."""
    frames, _ = sequence()
    cfg = {**BASE, **EXACT, **ACCEL, **BF16, "capture_backend": "auto"}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("EMF_TRACK_SAMPLER", "capture")
        jpipe = JaxPipeline(JaxParams(**cfg), None)
    pipe = EMFusionPipeline(Params(**cfg), device="cpu", sampler="capture")
    assert pipe.state.bg_tsdf.dtype == torch.bfloat16
    for f, depth in enumerate(frames):
        jd, pd = jpipe._motion_delta(), pipe.motion_delta()
        assert (jd is None) == (pd is None) == (f < 2), f
        if pd is not None:
            np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=0,
                                       atol=1e-5)
        jpipe.process_frame(None, depth, timestamp=float(f))
        jpipe.flush()
        pipe.process_frame(None, depth, timestamp=float(f))
        a, b = pipe.poses[f], jpipe.poses[f]
        assert np.linalg.norm(a[:3, 3] - b[:3, 3]) < 0.1 * VOXEL, f
        assert angle(a, b) < 1e-3, f
    assert pipe.last_track_stats["iterations"] > 0


def test_accel_estep_bf16_background_with_object_matches_jax():
    """The accelerator E-step (escale 2) on a carried rigid-scene state:
    the port runs frames 0-2 of the rigid scene of
    ``tests/test_accuracy_gate_objects.py`` under the accelerator
    configuration with bf16 volumes (one object spawned at frame 0), and
    its state is carried into both packages; frame 3's E-step samples the
    bf16 background and the float32 object in one table. The background
    and object association images agree within 1e-5 at every pixel."""
    _, frames, masks, _ = _make_sequence(grow=False)
    cfg = dict(GATE, **ACCEL, **BF16)
    pipe = EMFusionPipeline(Params(**cfg), rigid_provider(masks),
                            device="cpu", sampler="capture")
    for f in range(3):
        pipe.process_frame(None, frames[f], timestamp=float(f))
    slots = [int(k) for k in np.nonzero(pipe._h_active)[0]]
    assert len(slots) == 1
    s, o = pipe.state, pipe.state.objs
    snap = {k: getattr(s, k).float().numpy().copy() for k in STATE_KEYS}
    objs = {k: getattr(o, k).numpy().copy() for k in OBJ_KEYS}
    carried = EMFusionPipeline(Params(**cfg), device="cpu")
    carried.load_state(state_from_numpy(dict(snap, objs=objs),
                                        device="cpu"), frame=3)
    assert carried.state.bg_tsdf.dtype == torch.bfloat16
    _, pts = carried.preprocess(frames[3])
    carried.estep(pts, slots)

    jpipe = JaxPipeline(JaxParams(**cfg), None)
    js = jpipe.state
    assert js.bg_tsdf.dtype == jnp.bfloat16
    vol_keys = ("bg_tsdf", "bg_weights")
    jstate = js.replace(
        **{k: jnp.asarray(snap[k], js.bg_tsdf.dtype if k in vol_keys
                          else jnp.float32) for k in STATE_KEYS},
        objs=js.objs.replace(**{k: jnp.asarray(objs[k]) for k in OBJ_KEYS}))
    jstate, _ = jpipe._estep_subset(jstate, jnp.asarray(pts.numpy()),
                                    jnp.asarray(slots, jnp.int32))
    np.testing.assert_allclose(carried.state.bg_assoc.numpy(),
                               np.asarray(jstate.bg_assoc), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(carried.state.objs.assoc.numpy(),
                               np.asarray(jstate.objs.assoc), rtol=0,
                               atol=1e-5)
    assert (carried.state.objs.assoc.numpy()[slots[0]] > 0).sum() > 50


def bf16_recovery(package: str, volume_dtype: str, only=None) -> float:
    """The x-motion recovery of the rigid scene's object under the
    accelerator configuration in ``package`` ("jax" or "port"); ``only``
    ("bg_tsdf" or "bg_weights"): the port with just that volume in bf16
    (cast in the state before the first frame)."""
    _, frames, masks, obj_x = _make_sequence(grow=False)
    cfg = dict(GATE, **ACCEL, volume_dtype=volume_dtype)
    if package == "jax":
        os.environ["EMF_TRACK_SAMPLER"] = "capture"
        pipe = JaxPipeline(JaxParams(**cfg), JaxProvider(
            lambda rgb, f: [JaxDetection(
                mask=masks[f], scores=make_score_vector(3, 0.9))]
            if f in masks else []))
    else:
        pipe = EMFusionPipeline(Params(**cfg), rigid_provider(masks),
                                device="cpu", sampler="capture")
        if only is not None:
            setattr(pipe.state, only,
                    getattr(pipe.state, only).to(torch.bfloat16))
    for f, depth in enumerate(frames):
        pipe.process_frame(None, depth, timestamp=float(f))
    pipe.flush()
    traj = pipe.obj_poses[pipe.active_object_ids[0]]
    fs = sorted(traj)
    return float((traj[fs[-1]][0, 3] - traj[fs[0]][0, 3])
                 / (obj_x[fs[-1]] - obj_x[fs[0]]))


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    for package in ("jax", "port"):
        for vd in ("float32", "bfloat16"):
            print(f"{package} {vd}: x-motion recovery "
                  f"{bf16_recovery(package, vd):.4f}", flush=True)
    for only in ("bg_tsdf", "bg_weights"):
        print(f"port, only {only} bf16: x-motion recovery "
              f"{bf16_recovery('port', 'float32', only):.4f}", flush=True)
