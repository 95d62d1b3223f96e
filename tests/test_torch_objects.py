"""Port parity of the object slice's modules against the JAX package on
the CPU: foreground probabilities, the object E-step term (kernel K2's
two samples), fg/bg mask evidence, the object raycast (K4 on masked
weights), the raycast composite, the lifecycle's device math (masked
percentiles, IoUs, resample on resize, the culled object E-step) and
host math (volume IoU), Phong rendering, and the copied segmentation
providers. Inputs come from one JAX run of the rigid object scene of
``tests/test_accuracy_gate_objects.py`` (an object spawned at frame 0 and
matched at frame 3)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emfusion_tpu import segmentation as jax_seg
from emfusion_tpu.config import Params as JaxParams
from emfusion_tpu.geometry.sampling import \
    trilinear_sample_channels as jax_tri_channels
from emfusion_tpu.geometry.se3 import pose_inverse as jax_pose_inverse
from emfusion_tpu.ops.association import \
    association_weights as jax_association
from emfusion_tpu.ops.fusion import compute_gradients as jax_gradients
from emfusion_tpu.ops.fusion import integrate_fg_mask as jax_fg_mask
from emfusion_tpu.ops.raycast import raycast_volume as jax_raycast
from emfusion_tpu.ops.render import make_colormap as jax_colormap
from emfusion_tpu.ops.render import render_phong as jax_render
from emfusion_tpu.pipeline import EMFusionPipeline as JaxPipeline
from emfusion_tpu.volume import fg_probs as jax_fg_probs
from emfusion_tpu_torch import kernels
from emfusion_tpu_torch import segmentation as seg
from emfusion_tpu_torch.config import Params
from emfusion_tpu_torch.geometry.sampling import (
    SampleItem, sample_items, trilinear_sample_channels,
)
from emfusion_tpu_torch.ops.association import weights_from_samples
from emfusion_tpu_torch.ops.fusion import integrate_fg_mask
from emfusion_tpu_torch.ops.raycast import raycast_object
from emfusion_tpu_torch.ops.render import make_colormap, render_phong
from emfusion_tpu_torch.pipeline import (
    EMFusionPipeline, ObjectMeta, composite_raycasts, mask_iou_matrix,
    masked_percentiles, resample_slot, spawn_percentiles, state_from_numpy,
    surface_and_new_percentiles, volume_iou,
)
from emfusion_tpu_torch.volume import fg_probs
from test_accuracy_gate_objects import _make_sequence
from test_torch_pipeline_objects import GATE, jax_arrays

torch.set_num_threads(2)

K_SLOT = 0          # the object's pool slot
N_RUN = 4           # JAX frames run before the modules are compared


@pytest.fixture(scope="module")
def world():
    """The JAX pipeline after 4 frames of the rigid scene (the object
    spawned at frame 0, matched and mask-integrated at frame 3), its state
    as numpy, and frame 4's filtered depth and points."""
    _, frames, masks, _ = _make_sequence(grow=False)

    def provider(rgb, f):
        return [jax_seg.Detection(mask=masks[f],
                                  scores=jax_seg.make_score_vector(3, 0.9))
                ] if f in masks else []

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("EMF_TRACK_SAMPLER", "capture")
        jp = JaxPipeline(JaxParams(**GATE),
                         jax_seg.CallableMaskProvider(provider))
    for f in range(N_RUN):
        jp.process_frame(None, frames[f])
        jp.flush()
    assert jp.active_object_ids == [1] and jp._slot_of(1) == K_SLOT
    depth, points = jp._preprocess(jnp.asarray(frames[N_RUN]))
    arrays = jax_arrays(jp)
    o = arrays["objs"]
    assert (o["fg_counts"][K_SLOT].sum(0) > 0).sum() > 100
    return dict(jp=jp, arrays=arrays, depth=np.asarray(depth),
                points=np.asarray(points), masks=masks, frames=frames,
                intr=np.asarray(JaxParams(**GATE).intr))


def obj(world, key):
    return world["arrays"]["objs"][key][K_SLOT]


def rel_co(world, pose=None):
    """Camera-to-object transform (float32) of the slot's pose."""
    a = world["arrays"]
    pose = obj(world, "pose") if pose is None else pose
    rel = np.linalg.inv(pose).astype(np.float32) @ a["cam_pose"]
    return rel[:3, :3].copy(), rel[:3, 3].copy()


def t(x):
    return torch.tensor(np.asarray(x))


def test_fg_probs_matches_jax():
    rng = np.random.RandomState(0)
    counts = rng.randint(0, 4, (2, 5, 6, 7)).astype(np.float32)
    counts[:, 0] = 0.0                        # no evidence -> 0
    ref = np.asarray(jax_fg_probs(jnp.asarray(counts)))
    out = fg_probs(t(counts)).numpy()
    np.testing.assert_array_equal(out, ref)
    assert (out[0] == 0).all() and (out > 0.5).any()


def test_object_association_weights_match_jax(world):
    """``w`` and ``fg_vals`` of the object form: the Laplace term times the
    fg probability at the same point, which K2's wrapper
    (``sample_items``) blends from the fg/bg counts. The same arithmetic
    in the same order: within 1e-6 relative."""
    tp = JaxParams(**GATE).tsdfParams
    R, tr = rel_co(world)
    vs, td = obj(world, "voxel_size"), obj(world, "truncdist")
    pts = world["points"]
    args = (tp.assocSigma, tp.alpha, tp.uniPrior)
    w_ref, fg_ref = jax_association(
        jnp.asarray(obj(world, "tsdf")), jnp.asarray(pts), jnp.asarray(R),
        jnp.asarray(tr), vs, td, *args,
        fg_prob_vol=jax_fg_probs(jnp.asarray(obj(world, "fg_counts"))))
    before = dict(kernels.launches)
    [(psi, fg)] = sample_items([SampleItem(
        t(obj(world, "tsdf")), t(pts), t(R), t(tr), float(vs),
        counts=t(obj(world, "fg_counts")))])
    w = weights_from_samples(psi, float(td), *args, fg_vals=fg)
    assert kernels.launches == before
    np.testing.assert_allclose(w.numpy(), np.asarray(w_ref), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(fg.numpy(), np.asarray(fg_ref), rtol=1e-6,
                               atol=1e-7)
    assert (fg.numpy() > 0.5).sum() > 100
    assert (w.numpy() > 1.0).sum() > 100   # object pixels above the prior


def test_integrate_fg_mask_matches_jax(world):
    """Evidence counts from a random mask with a random occlusion mask:
    whole numbers, so equal exactly."""
    rng = np.random.RandomState(1)
    H, W = world["depth"].shape
    mask = rng.rand(H, W) < 0.5
    occl = rng.rand(H, W) < 0.2
    R, tr = rel_co(world)
    Ro, to = R.T.copy(), (-R.T @ tr).astype(np.float32)
    vs = obj(world, "voxel_size")
    ref = jax_fg_mask(jnp.asarray(obj(world, "tsdf")),
                      jnp.asarray(obj(world, "weights")),
                      jnp.asarray(obj(world, "fg_counts")), jnp.asarray(mask),
                      jnp.asarray(occl), jnp.asarray(Ro), jnp.asarray(to),
                      jnp.asarray(world["intr"]), vs)
    out = integrate_fg_mask(t(obj(world, "tsdf")), t(obj(world, "weights")),
                            t(obj(world, "fg_counts")), t(mask), t(occl),
                            t(Ro), t(to), t(world["intr"]), float(vs))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert (out.numpy() != obj(world, "fg_counts")).any()


def test_object_raycast_matches_jax(world):
    """K4's plain version on the object's volume with the weights masked
    to fg probability > 0.5 (``pipeline.py:609-614``), against the JAX
    march: tolerances as ``test_torch_raycast``."""
    R, tr = rel_co(world)
    H, W = world["depth"].shape
    vs, td = float(obj(world, "voxel_size")), float(obj(world, "truncdist"))
    tsdf = obj(world, "tsdf")
    rc_w = jnp.where(jax_fg_probs(jnp.asarray(obj(world, "fg_counts"))) > 0.5,
                     jnp.asarray(obj(world, "weights")), 0.0)
    ref = jax_raycast(jnp.asarray(tsdf), jax_gradients(jnp.asarray(tsdf)),
                      rc_w, jnp.asarray(R), jnp.asarray(tr),
                      jnp.asarray(world["intr"]), vs, td, H, W,
                      max_steps=256)
    out = raycast_object(t(tsdf), t(obj(world, "weights")),
                         t(obj(world, "fg_counts")), t(R), t(tr),
                         t(world["intr"]), vs, td, H, W, 256)
    mask = np.asarray(ref["mask"])
    np.testing.assert_array_equal(out["mask"].numpy(), mask)
    assert mask.sum() > 100
    for key, tol in (("raylengths", 1e-5), ("vertices", 1e-5),
                     ("normals", 1e-4)):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   rtol=0, atol=tol, err_msg=key)


def two_object_state(world):
    """The JAX state with a second object: a copy of the first in slot 1,
    id 2, 3 cm to the right and 4 cm further away, so the two overlap in
    the image and the composite must pick the nearer."""
    import dataclasses as dc
    s = world["jp"].state
    o = s.objs
    shift = np.eye(4, dtype=np.float32)
    shift[:3, 3] = [0.03, 0.0, 0.04]

    def put(a, v):
        return a.at[1].set(v)

    o2 = dc.replace(
        o, tsdf=put(o.tsdf, o.tsdf[0]), weights=put(o.weights, o.weights[0]),
        grads=put(o.grads, o.grads[0]),
        fg_counts=put(o.fg_counts, o.fg_counts[0]),
        pose=put(o.pose, jnp.asarray(shift) @ o.pose[0]),
        voxel_size=put(o.voxel_size, o.voxel_size[0]),
        truncdist=put(o.truncdist, o.truncdist[0]),
        active=put(o.active, True), visible=put(o.visible, True),
        object_id=put(o.object_id, 2), assoc=put(o.assoc, o.assoc[0]))
    return s.replace(objs=o2)


def test_composite_matches_jax(world):
    """The composite of ``raycast_subset`` (nearest object per pixel, the
    5 cm background override, the segmentation, the model masks and the
    boundary-eroded visibility counts), fed per-model raycasts computed as
    the JAX pipeline computes them, against its output: the segmentation,
    masks and counts equal; raylengths and vertices within 1e-5, normals
    within 1e-4 (the per-model raycasts here are compiled as programs of
    their own, and XLA may fuse a product and a sum differently than
    inside the pipeline's program: the bounds of ``test_torch_raycast``).
    """
    jp = world["jp"]
    state = two_object_state(world)
    slots = [0, 1]
    ref_state, ref = jp._raycast_subset(state, jnp.asarray(slots, jnp.int32))
    p = JaxParams(**GATE)
    H, W = p.height, p.width
    intr = jnp.asarray(p.intr)

    @jax.jit
    def jax_rc(tsdf, grads, weights, pose, vs, td):
        rel = jax_pose_inverse(pose) @ state.cam_pose
        return jax_raycast(tsdf, grads, weights, rel[:3, :3], rel[:3, 3],
                           intr, vs, td, H, W, max_steps=p.raycast_max_steps)

    def rc(*args):
        return {k: t(v) for k, v in jax_rc(*args).items()}

    bg_rc = rc(state.bg_tsdf, state.bg_grads, state.bg_weights,
               state.bg_pose, p.globalVoxelSize, p.global_truncdist)
    o = state.objs
    obj_rcs = [rc(o.tsdf[k], o.grads[k],
                  jnp.where(jax_fg_probs(o.fg_counts[k]) > 0.5,
                            o.weights[k], 0.0),
                  o.pose[k], o.voxel_size[k], o.truncdist[k]) for k in slots]
    out = composite_raycasts(bg_rc, obj_rcs, slots,
                             t(np.asarray(o.object_id)), t(np.asarray(o.active)),
                             p.boundary)
    seg_ref = np.asarray(ref["seg"])
    assert set(np.unique(seg_ref)) == {0, 1, 2}
    both_hit = obj_rcs[0]["mask"] & obj_rcs[1]["mask"]
    assert both_hit.sum() > 20                  # the objects overlap
    for key in ("seg", "obj_masks", "vis_counts"):
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)
    for key, tol in (("vertices", 1e-5), ("normals", 1e-4),
                     ("raylengths", 1e-5), ("bg_raylengths", 1e-5)):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   rtol=0, atol=tol, err_msg=key)
    # the override took some object pixels back for the background
    any_obj = (obj_rcs[0]["mask"] | obj_rcs[1]["mask"]).numpy()
    assert ((seg_ref == 0) & any_obj).any()
    vis = np.asarray(ref_state.objs.visible)
    np.testing.assert_array_equal(
        np.asarray(o.active) & (out["vis_counts"].numpy()
                                > p.visibilityThresh), vis)


# counts at which int(n * 0.9) differs between float32 arithmetic and
# float64 arithmetic with the float32 constant (every multiple of 10)
@pytest.mark.parametrize("n", [0, 1, 7, 10, 30, 1230, 4000])
def test_masked_percentiles_matches_jax(world, n):
    """The per-axis 10/90 percentiles at ``int(n * 0.1)`` and ``int(n *
    0.9)`` computed in float32 (exact: the same sorted values), with
    invalid rows sorted to the end as inf (all inf at n = 0)."""
    rng = np.random.RandomState(n)
    P = 4000
    pts = rng.normal(0, 1, (P, 3)).astype(np.float32)
    valid = np.zeros(P, bool)
    valid[rng.permutation(P)[:n]] = True
    ref = world["jp"]._masked_percentiles(jnp.asarray(pts), jnp.asarray(valid))
    out = masked_percentiles(t(pts), t(valid))
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert np.isinf(out[0].numpy()).all() == (n == 0)


def test_spawn_percentiles_match_jax(world):
    """World percentiles and each slot's object-frame percentiles of the
    frame's masked points: the world part exactly; the object frames
    within 1e-6 (a 3x3 product may round apart)."""
    a = world["arrays"]
    cam = a["cam_pose"]
    pts = world["points"]
    pts_w = (pts.reshape(3, -1).T @ cam[:3, :3].T
             + cam[:3, 3]).astype(np.float32)
    valid = (world["masks"][3] & (pts[2] > 0)).reshape(-1)
    ref = np.asarray(world["jp"]._spawn_percentiles(
        jnp.asarray(pts_w), jnp.asarray(valid),
        jnp.asarray(a["objs"]["pose"])))
    out = spawn_percentiles(t(pts_w), t(valid), t(a["objs"]["pose"]))
    np.testing.assert_array_equal(out[:7], ref[:7])
    np.testing.assert_allclose(out[7:], ref[7:], rtol=1e-6, atol=1e-7)
    assert out[6] == valid.sum() > 100


def test_surface_and_new_percentiles_match_jax(world):
    """The resize input: percentiles over the near-surface fg voxels and
    the new points in the object frame. Exact: the same values."""
    pts = world["points"].reshape(3, -1).T.copy()
    valid = world["masks"][3].reshape(-1) & (pts[:, 2] > 0)
    vs = obj(world, "voxel_size")
    args = [obj(world, k) for k in ("tsdf", "weights", "fg_counts")]
    ref = world["jp"]._surface_new_percentiles(
        *[jnp.asarray(x) for x in args], vs, jnp.asarray(pts),
        jnp.asarray(valid))
    out = surface_and_new_percentiles(*[t(x) for x in args], t(vs), t(pts),
                                      t(valid))
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("scale, offset", [(1.25, (1, -2, 0)),
                                           (1.5, (0, 0, 0))])
def test_resample_slot_matches_jax(world, scale, offset):
    """Rescale-and-recentre on resize: the trilinear resample of tsdf,
    weights and fg counts, with the tsdf band rescaled by old/new voxel
    size and saturated values kept at their sign. Within 1e-6."""
    args = [obj(world, k) for k in ("tsdf", "weights", "fg_counts")]
    vs = float(obj(world, "voxel_size"))
    new_vs = vs * scale
    center = np.asarray(offset, np.float32) * np.float32(vs)
    ref = world["jp"]._resample_slot(*[jnp.asarray(x) for x in args], vs,
                                     new_vs, jnp.asarray(center))
    out = resample_slot(*[t(x) for x in args], np.float32(vs),
                        np.float32(new_vs), t(center))
    # JAX also returns the gradient volume (third), which the port drops
    for a, b in zip(out, (ref[0], ref[1], ref[3])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)
    assert (np.abs(out[0].numpy()) == 1.0).any()
    assert (out[1].numpy() > 0).sum() > 100


def test_volume_iou_matches_jax(world):
    """The host's volumeIOU on the same float32 inputs: equal."""
    jp = world["jp"]
    rng = np.random.RandomState(4)
    vs = np.float32(obj(world, "voxel_size"))
    for _ in range(20):
        c = rng.normal(0, 0.05, 3).astype(np.float32)
        ext = rng.uniform(0.01, 0.3, 3).astype(np.float32)
        p10, p90 = c - ext / 2, c + ext / 2
        ref = jp._volume_iou(K_SLOT, vs, p10, p90)
        assert volume_iou(p10, p90, vs, jp.obj_res, GATE["volPad"]) == ref
    far = np.full(3, 5.0, np.float32)
    assert volume_iou(far, far + 0.1, vs, jp.obj_res, 1.0) == 0.0


def test_mask_iou_matrix_matches_jax(world):
    rng = np.random.RandomState(5)
    H, W = world["depth"].shape
    segm = rng.randint(0, 4, (H, W)).astype(np.int32)
    masks = rng.rand(3, H, W) < 0.3
    masks[0] = segm == 2
    ids = np.array([1, 2, 0, 3], np.int32)
    ref = world["jp"]._mask_iou_matrix(jnp.asarray(masks), jnp.asarray(segm),
                                       jnp.asarray(ids))
    out = mask_iou_matrix(t(masks), t(segm), t(ids))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert out[0, 1] == 1.0


def port_pipeline(world, **over):
    """A port pipeline continuing from the world's JAX state."""
    cfg = dict(GATE, **over)
    jp = world["jp"]
    pipe = EMFusionPipeline(Params(**cfg), device="cpu", sampler="capture")
    pipe.load_state(state_from_numpy(world["arrays"], device="cpu"),
                    frame=N_RUN,
                    meta={i: ObjectMeta(**dataclasses.asdict(m))
                          for i, m in jp.meta.items()},
                    next_id=jp._next_id)
    return pipe


@pytest.mark.parametrize("budget", [0, 96])
def test_object_estep_matches_jax(world, budget):
    """The E-step with the object on the same points: ``budget`` 0
    evaluates every point; 96 is far below the object's box footprint
    (~640 points here), so the centre-priority culling keeps the 96 points
    nearest the volume's centre and the overflow gets weight 0
    (``pipeline.py:326-355``). Ties at the cut keep the lower index in
    both. The kept points may differ by one where two distances round
    apart; elsewhere the normalised weights agree within 1e-5."""
    cfg = dict(GATE, estep_obj_subset=budget)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("EMF_TRACK_SAMPLER", "capture")
        jp = JaxPipeline(JaxParams(**cfg), None)
    ref, _ = jp._estep_subset(world["jp"].state,
                              jnp.asarray(world["points"]),
                              jnp.asarray([K_SLOT], jnp.int32))
    pipe = port_pipeline(world, estep_obj_subset=budget)
    pipe.estep(t(world["points"]), [K_SLOT])
    a_ref = np.asarray(ref.objs.assoc)[K_SLOT]
    a = pipe.state.objs.assoc[K_SLOT].numpy()
    kept_ref, kept = a_ref > 0, a > 0
    assert (kept_ref != kept).sum() <= 2
    both = kept_ref & kept
    np.testing.assert_allclose(a[both], a_ref[both], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(pipe.state.bg_assoc.numpy()[both],
                               np.asarray(ref.bg_assoc)[both], rtol=1e-5,
                               atol=1e-7)
    if budget:
        assert kept.sum() <= budget
        # the kept points are the box's centre: nearer the object's
        # centre pixel than the ones an uncut E-step also weighs
        full = port_pipeline(world)
        full.estep(t(world["points"]), [K_SLOT])
        full_kept = full.state.objs.assoc[K_SLOT].numpy() > 0
        assert full_kept.sum() > 3 * budget
        yy, xx = np.nonzero(full_kept)
        d = np.hypot(yy - yy.mean(), xx - xx.mean())
        assert d[kept[full_kept]].mean() < d[~kept[full_kept]].mean()


def test_render_phong_matches_jax(world):
    """Phong shading of the last composited raycast: equal at >= 99.9% of
    the pixels and never more than 1 apart (the last float bits of the
    shading may move a uint8)."""
    rc = world["jp"]._last_raycast
    ref = np.asarray(jax_render(rc["vertices"], rc["normals"],
                                jnp.asarray(rc["seg"]) % 256,
                                jnp.asarray(jax_colormap())))
    np.testing.assert_array_equal(make_colormap(), jax_colormap())
    out = render_phong(t(rc["vertices"]), t(rc["normals"]),
                       t(rc["seg"]) % 256, make_colormap()).numpy()
    assert out.dtype == np.uint8 and out.shape == ref.shape
    diff = np.abs(out.astype(int) - ref.astype(int))
    assert diff.max() <= 1
    assert np.all(diff == 0, axis=-1).mean() >= 0.999
    assert (out.sum(-1) > 0).mean() > 0.3


def test_trilinear_sample_channels_matches_jax():
    rng = np.random.RandomState(6)
    vol = rng.normal(0, 1, (2, 5, 6, 7)).astype(np.float32)
    vx, vy, vz = [rng.uniform(-0.5, n - 0.5, 50).astype(np.float32)
                  for n in (7, 6, 5)]
    valid = (vx >= 0) & (vy >= 0) & (vz >= 0) & (vx < 6) & (vy < 5) \
        & (vz < 4)
    ref = jax_tri_channels(jnp.asarray(vol), jnp.asarray(vx), jnp.asarray(vy),
                           jnp.asarray(vz), jnp.asarray(valid))
    out = trilinear_sample_channels(t(vol), t(vx), t(vy), t(vz), t(valid))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)


def test_segmentation_copy_matches_jax(tmp_path):
    """The copied providers: class filtering, the reference pickle format
    (save + replay), and the TorchScript provider's parsing of a
    torchvision-style dict and of (boxes, masks, per-class scores)."""
    rng = np.random.RandomState(7)
    H, W = 80, 100
    dets, jdets = [], []
    for cid, px in ((3, 3000), (1, 2600), (14, 3000), (3, 100)):
        mask = np.zeros((H, W), bool)
        mask.reshape(-1)[rng.permutation(H * W)[:px]] = True
        scores = seg.make_score_vector(cid, 0.8)
        dets.append(seg.Detection(mask=mask, scores=scores,
                                  box=np.array([1, 2, 30, 40])))
        jdets.append(jax_seg.Detection(mask=mask, scores=scores,
                                       box=np.array([1, 2, 30, 40])))
    static = ["bench"]
    kept = seg.filter_detections(dets, [], static)
    jkept = jax_seg.filter_detections(jdets, [], static)
    assert [d.class_id for d in kept] == [d.class_id for d in jkept] == [3, 1]
    assert [d.class_id for d in seg.filter_detections(dets, ["car"], [])] \
        == [3]
    seg.save_detections(str(tmp_path / "Mask0002.plk"), kept)
    back = seg.ReplayMaskProvider(str(tmp_path)).detect(None, 2)
    jback = jax_seg.ReplayMaskProvider(str(tmp_path)).detect(None, 2)
    assert seg.ReplayMaskProvider(str(tmp_path)).detect(None, 3) is None
    for a, b, c in zip(back, jback, kept):
        np.testing.assert_array_equal(a.mask, b.mask)
        np.testing.assert_array_equal(a.mask, c.mask)
        np.testing.assert_array_equal(a.scores, b.scores)

    def provider(module):
        p = module.TorchScriptMaskProvider.__new__(
            module.TorchScriptMaskProvider)
        p._torch, p.score_thresh, p.mask_thresh = torch, 0.7, 0.5
        return p

    masks = torch.tensor(rng.rand(3, 1, H, W).astype(np.float32))
    outs = [
        {"boxes": torch.rand(3, 4), "masks": masks,
         "labels": torch.tensor([3, 1, 62]),
         "scores": torch.tensor([0.9, 0.6, 0.95])},
        (torch.rand(3, 4), masks[:, 0],
         torch.tensor(rng.dirichlet(np.ones(81), 3).astype(np.float32)
                      * 0.2 + np.eye(81)[[3, 5, 7]] * 0.8)),
    ]
    for out in outs:
        got = provider(seg)._parse(out, (H, W))
        want = provider(jax_seg)._parse(out, (H, W))
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.mask, b.mask)
            np.testing.assert_array_equal(a.scores, b.scores)


def test_entry_runs_a_frame_step_with_an_object():
    """``entry.entry`` (the ``__graft_entry__.entry`` mirror): the frame
    step from a state whose pool holds one object; the object stays and
    is in the segmentation. The CPU takes the plain versions."""
    from emfusion_tpu_torch.entry import entry
    before = dict(kernels.launches)
    fn, (state, depth) = entry(device="cpu")
    assert state.objs.active.sum() == 1
    state, seg_img = fn(state, depth)
    assert seg_img.shape == depth.shape
    assert int(state.objs.object_id[0]) == 1 and bool(state.objs.active[0])
    assert (seg_img == 1).sum() > 16
    assert kernels.launches == before
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            entry()


def test_entry_step_leaves_its_arguments_and_repeats():
    """The frame step is a function of its arguments: it leaves the
    state it is given as it was, and a second call with the same
    arguments (a warm-up, then a timed call) gives the same poses, volumes
    and segmentation."""
    from emfusion_tpu_torch.entry import copy_state, entry
    fn, args = entry(device="cpu")
    seed = copy_state(args[0])
    a, seg_a = fn(*args)
    b, seg_b = fn(*args)
    for key in ("bg_tsdf", "bg_weights", "cam_pose"):
        assert torch.equal(getattr(args[0], key), getattr(seed, key))
    for key in ("tsdf", "weights", "fg_counts", "pose", "assoc"):
        assert torch.equal(getattr(args[0].objs, key),
                           getattr(seed.objs, key))
        assert torch.equal(getattr(a.objs, key), getattr(b.objs, key))
    assert torch.equal(a.cam_pose, b.cam_pose)
    assert torch.equal(seg_a, seg_b)
    assert not torch.equal(a.objs.tsdf, seed.objs.tsdf)   # it did fuse
