"""Port parity of the batched kernels' plain versions against the JAX
package on the CPU: K1 (``ops.fusion.integrate_tsdf_batched``) fusing one
frame into the background and three object slots at once, and its voxel
classes (``ops.fusion.voxel_classes``); K2
(``geometry.sampling.sample_items``) sampling the background and object
slots of one E-step, with each object's foreground probability taken
from its fg/bg counts. Small sizes: the 48^3 background of
``test_torch_fusion`` at 60x80, 16^3 and 12x16x20 slots; every input
comes from a numpy seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emfusion_tpu.geometry.sampling import (
    sample_volume_at_points as jax_sample,
)
from emfusion_tpu.ops.association import (
    association_weights as jax_association,
)
from emfusion_tpu.ops.fusion import integrate_tsdf as jax_integrate
from emfusion_tpu.volume import fg_probs as jax_fg_probs
from emfusion_tpu_torch import kernels
from emfusion_tpu_torch.geometry.sampling import (
    SampleItem, sample_items, sample_volume_at_points_plain,
)
from emfusion_tpu_torch.ops.association import weights_from_samples
from emfusion_tpu_torch.ops.fusion import (
    BAND, BEHIND, HOLE, NEG, SKIP, FusionItem, integrate_tsdf_batched,
    voxel_classes,
)
from emfusion_tpu_torch.volume import fg_probs
from test_torch_fusion import TRUNC, VOXEL, fused_scene, rel_co, rel_oc

torch.set_num_threads(2)

BG_CARVE = dict(carve_dist=0.04, carve_weight_cap=0.0, carve_margin=0.25)
# object slots: (shape (Z, Y, X), voxel size, truncdist, centre in the
# frame-2 camera, yaw): on the first background sphere, on the second
# (turned), straddling the camera plane (voxels behind the camera and
# beside the image), and one left out of the launch
SLOTS = [((16, 16, 16), 0.03, 0.09, (-0.4, 0.05, 0.95), 0.0),
         ((16, 16, 16), 0.02, 0.05, (0.45, -0.3, 1.2), 0.4),
         ((12, 16, 20), 0.04, 0.16, (0.1, 0.0, 0.1), -0.3),
         ((16, 16, 16), 0.03, 0.09, (0.0, 0.2, 1.0), 0.0)]
LEFT_OUT = 3
# E-step mixture (assocSigma, alpha, uniPrior)
MIX = (0.02, 0.8, 1.0)


def slot_pose(centre, yaw):
    """Object-to-camera rotation and translation."""
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    return R, np.asarray(centre, np.float32)


def slot_volumes(shape, seed):
    """A slot's tsdf in [-1, 1] and weights with a third of them 0."""
    rng = np.random.RandomState(seed)
    tsdf = rng.uniform(-1, 1, shape).astype(np.float32)
    w = rng.uniform(0.5, 8, shape).astype(np.float32)
    w[rng.uniform(size=shape) < 0.33] = 0.0
    return tsdf, w


@pytest.fixture(scope="module")
def frame():
    """Frame 2's depth with 10% of its pixels dropped, and per model an
    association image in [0, 1] with a tenth of it 0."""
    _, _, depths, intr = fused_scene()
    rng = np.random.RandomState(3)
    depth = depths[2].copy()
    depth[rng.uniform(size=depth.shape) < 0.1] = 0.0
    assoc = rng.uniform(0, 1, (1 + len(SLOTS),) + depth.shape)
    assoc[rng.uniform(size=assoc.shape) < 0.1] = 0.0
    return depth, assoc.astype(np.float32), intr


def fusion_inputs(frame):
    """Per model (background first): (tsdf, weights, assoc, R, t, vs, td,
    carve kwargs) as numpy, volume-to-camera."""
    depth, assoc, intr = frame
    tsdf0, w0, _, _ = fused_scene()
    R, t = rel_oc(2)
    out = [(tsdf0, w0, assoc[0], R, t, VOXEL, TRUNC, BG_CARVE)]
    for i, (shape, vs, td, centre, yaw) in enumerate(SLOTS):
        Rs, ts = slot_pose(centre, yaw)
        tsdf, w = slot_volumes(shape, 10 + i)
        out.append((tsdf, w, assoc[1 + i], Rs, ts, vs, td, {}))
    return out


@pytest.fixture(scope="module")
def fused(frame):
    """The batched plain K1 over the background and slots 0-2 (slot 3 is
    not in the table), and the JAX package's integrate_tsdf per model."""
    depth, _, intr = frame
    inputs = fusion_inputs(frame)
    vols = [(torch.tensor(a[0]), torch.tensor(a[1])) for a in inputs]
    items = [FusionItem(t, w, torch.tensor(a[2]), torch.tensor(a[3]),
                        torch.tensor(a[4]), a[5], a[6], 64.0, **a[7])
             for m, ((t, w), a) in enumerate(zip(vols, inputs))
             if m != 1 + LEFT_OUT]
    before = dict(kernels.launches)
    integrate_tsdf_batched(items, torch.tensor(depth), torch.tensor(intr))
    assert kernels.launches == before            # CPU: plain versions
    ref = [tuple(np.asarray(v) for v in jax_integrate(
        jnp.asarray(a[0]), jnp.asarray(a[1]), jnp.asarray(depth),
        jnp.asarray(a[2]), jnp.asarray(a[3]), jnp.asarray(a[4]),
        jnp.asarray(intr), a[5], a[6], 64.0, **a[7])) for a in inputs]
    return inputs, vols, ref


@pytest.mark.parametrize("model", range(1 + len(SLOTS)))
def test_batched_fusion_matches_jax(fused, model):
    """Each model of the batch against ``integrate_tsdf`` alone, with its
    own pose, voxel size, truncation and (background) carve rules. Both
    sides compute the same float32 arithmetic, but XLA may reassociate or
    round its square roots and divisions otherwise:
    * a voxel centre within an ulp of a pixel boundary may round to the
      neighbouring pixel, so at most 1 voxel in 10^4 may differ;
    * every other weight agrees to 1e-6, and every other tsdf to 1e-6
      plus 2.4e-7 / truncdist: one ulp of a 1-2 m camera distance, which
      the cancellation in ``sdf = depth - |p| / lambda`` carries into the
      truncated value.
    The slot left out of the table stays bit for bit."""
    inputs, vols, ref = fused
    t, w = vols[model]
    if model == 1 + LEFT_OUT:
        np.testing.assert_array_equal(t.numpy(), inputs[model][0])
        np.testing.assert_array_equal(w.numpy(), inputs[model][1])
        return
    td = inputs[model][6]
    for port, r, tol in ((t.numpy(), ref[model][0], 1e-6 + 2.4e-7 / td),
                         (w.numpy(), ref[model][1], 1e-6)):
        off = np.abs(port - r) > tol
        assert off.mean() <= 1e-4, (model, off.sum())
    assert not np.array_equal(t.numpy(), inputs[model][0])


@pytest.mark.parametrize("model", range(1 + len(SLOTS)))
def test_voxel_classes_match_jax_changes(frame, fused, model):
    """The class split says which voxels a frame can change, as the JAX
    package computes it: ``integrate_tsdf`` leaves every ``SKIP`` voxel
    (in front of the camera, outside the image) bit-equal, and every
    ``BEHIND``/``HOLE``/``NEG`` voxel with a weight; it changes no weight
    outside
    ``BAND``. The slot straddling the camera plane has voxels beside the
    image and behind the camera; the others have voxels behind the
    surface."""
    depth, _, intr = frame
    tsdf, w, _, R, t, vs, td, _ = fusion_inputs(frame)[model]
    cls = voxel_classes(tsdf.shape, torch.tensor(depth), torch.tensor(R),
                        torch.tensor(t), torch.tensor(intr), vs,
                        td).numpy()
    rt, rw = fused[2][model]
    t_changed = rt.view(np.uint32) != tsdf.view(np.uint32)
    w_changed = rw.view(np.uint32) != w.view(np.uint32)
    assert not t_changed[cls == SKIP].any()
    assert not (t_changed & np.isin(cls, (BEHIND, HOLE, NEG))
                & (w > 0)).any()
    assert not w_changed[cls != BAND].any()
    assert t_changed.any()
    seen = set(np.unique(cls).tolist())
    if model == 3:          # the slot straddling the camera plane
        assert {SKIP, BEHIND, HOLE, BAND} <= seen
        assert (cls == SKIP).mean() > 0.1
    else:
        assert {HOLE, NEG, BAND} <= seen


def sample_inputs(frame):
    """The E-step's items: the background at every pixel's point (frame
    2, a small pose jitter), then per object slot its TSDF, fg/bg counts
    (whole numbers, with corners of no evidence) and a random subset of
    points around its box, some outside it; one slot has no points, one
    has dims 12x16x20."""
    depth, _, intr = frame
    tsdf0, _, _, _ = fused_scene()
    from emfusion_tpu.geometry.camera import backproject_depth
    pts = np.asarray(backproject_depth(jnp.asarray(depth),
                                       jnp.asarray(intr)))
    R, t = rel_co(2, 0.01)
    items = [(tsdf0, None, pts, R, t, VOXEL, TRUNC)]
    rng = np.random.RandomState(4)
    for i, (shape, vs, td, centre, yaw) in enumerate(SLOTS):
        Roc, toc = slot_pose(centre, yaw)
        tsdf, _ = slot_volumes(shape, 20 + i)
        counts = rng.randint(0, 3, (2,) + shape).astype(np.float32)
        n = 0 if i == 1 else 700
        half = 0.6 * vs * np.array(shape[::-1])
        p_obj = rng.uniform(-half, half, (n, 3)).astype(np.float32)
        p_cam = (p_obj @ Roc.T + toc).T.astype(np.float32)     # (3, n)
        Rco = Roc.T.copy()
        tco = (-Roc.T @ toc).astype(np.float32)
        items.append((tsdf, counts, np.ascontiguousarray(p_cam), Rco, tco,
                      vs, td))
    return items


@pytest.fixture(scope="module")
def sampled(frame):
    inputs = sample_inputs(frame)
    items = [SampleItem(torch.tensor(v), torch.tensor(p), torch.tensor(R),
                        torch.tensor(t), vs,
                        counts=None if c is None else torch.tensor(c))
             for v, c, p, R, t, vs, _ in inputs]
    before = dict(kernels.launches)
    out = sample_items(items)
    assert kernels.launches == before            # CPU: plain versions
    return inputs, out


@pytest.mark.parametrize("model", range(1 + len(SLOTS)))
def test_batched_sample_matches_jax(sampled, model):
    """Each item against the JAX package alone: ψ against
    ``sample_volume_at_points`` (the same float32 arithmetic in the same
    order: within 1e-6, and exact zeros at the same points), and the
    association weight against ``association_weights`` (with
    ``fg_prob_vol = fg_probs(counts)`` for an object; 1e-6 relative)."""
    inputs, out = sampled
    vol, counts, pts, R, t, vs, td = inputs[model]
    psi, fg = out[model]
    assert (fg is None) == (counts is None)
    assert psi.shape == pts.shape[1:]
    ref = np.asarray(jax_sample(jnp.asarray(vol), jnp.asarray(pts),
                                jnp.asarray(R), jnp.asarray(t), vs,
                                margin=1))
    np.testing.assert_array_equal(psi.numpy() == 0.0, ref == 0.0)
    np.testing.assert_allclose(psi.numpy(), ref, rtol=0, atol=1e-6)
    fgv = None if counts is None else jax_fg_probs(jnp.asarray(counts))
    w_ref, fg_ref = jax_association(
        jnp.asarray(vol), jnp.asarray(pts), jnp.asarray(R), jnp.asarray(t),
        vs, td, *MIX, fg_prob_vol=fgv)
    w = weights_from_samples(psi, td, *MIX, fg)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_ref), rtol=1e-6,
                               atol=1e-7)
    if counts is not None:
        np.testing.assert_allclose(fg.numpy(), np.asarray(fg_ref),
                                   rtol=1e-6, atol=1e-7)
    if model != 2:          # the slot with no points
        assert 0.1 < (ref != 0).mean() < 0.99


@pytest.mark.parametrize("margin", [1, 2])
def test_fg_from_counts_equals_fg_probs_sample(frame, margin):
    """The foreground probability from the counts at each corner equals
    ``fg_probs`` of the counts sampled by the ψ sampler, bit for bit."""
    for vol, counts, pts, R, t, vs, _ in sample_inputs(frame)[1:]:
        args = (torch.tensor(pts), torch.tensor(R), torch.tensor(t), vs)
        _, fg = sample_items([SampleItem(torch.tensor(vol), *args,
                                         counts=torch.tensor(counts),
                                         margin=margin)])[0]
        ref = sample_volume_at_points_plain(fg_probs(torch.tensor(counts)),
                                            *args, margin=margin)
        np.testing.assert_array_equal(fg.numpy(), ref.numpy())
