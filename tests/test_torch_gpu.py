"""The port's CUDA kernels against their plain PyTorch versions on the
card, at small ragged shapes (sizes that are not multiples of the
kernels' block sizes), on a scene fused by the plain versions; K1-K4 also
at object shapes (64^3 and 37x41x53 volumes at two object voxel sizes),
the pipeline's fusion over a pool with an invisible slot, K1, K2 and K3
over work tables of 1 to 18 volumes of mixed shapes, the batched
object LM on the card against the same call on the CPU, and the bf16
forms: K1 and K2 over a bf16 volume beside float32 ones in one table,
K3's bf16 cache, K4 on a bf16 pair at the camera and from an orbit
camera outside the volume, and the wrappers refusing other dtypes; K1's
slab form (the z-sharded background) against the plain slab and the
whole-volume launch, and the sharded pipeline on two ranks under NCCL
against the one-card pipeline (skips with fewer than two cards); the
device-resident LM: the split kernels (``lm_system``, ``lm_trial``,
``lm_step``, with their fixed-order final passes) phase by phase against
their plain versions over tables of 1, 3 and 16 LMs at 1, 31 and 4,097
points; the cooperative ``lm_run`` iteration by iteration against the
plain iteration over tables of 1 and 17 LMs (bf16 items among them, an
item of 0 points), on its own grid and on grids smaller than the span
count, a table that stops in its first iteration and one that runs into
``max_iter``; ``lm_cluster`` (a thread-block cluster an LM) over tables
of 2, 16 and 17 cache items (the batched object LM's stages: K3 window
caches of float32 and bf16, ragged point counts, an empty item, part of
the points outside their windows) and the cooperative ``lm_run`` over
cache items with one of 34 spans, iteration by iteration and in one
launch, each LM kernel and the split kernels refusing the others'
tables; ``lm_cluster`` over re-capturing cache items (the capture
sampler's LM: K3 at each flagged trial pose between launches) in
lockstep, as ``tracking.capture_table``, and, with ``lm_run`` too, in
one launch where a flagged LM leaves while the others run on; and whole
LMs (the device LM, the batched
object LM, the capture LM) on the card against the plain versions on the
CPU; K6 at ragged sizes with cells behind the plane; and a deletion with
its slot re-used by a new object, card against CPU.

Needs a CUDA device, ``nvcc`` and nothing of JAX; without a card every
test skips. On a machine with a card::

    python -m pytest --noconftest -q tests/test_torch_gpu.py

(``--noconftest``: the repository's conftest imports JAX, which the port
does not need and a GPU machine may not have.)
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from emfusion_tpu_torch import kernels
from emfusion_tpu_torch.config import Params
from emfusion_tpu_torch.geometry import camera, capture, sampling
from emfusion_tpu_torch.ops import fusion, raycast, warp
from emfusion_tpu_torch.ops.fusion import FusionItem
from emfusion_tpu_torch.pipeline import EMFusionPipeline
from emfusion_tpu_torch.tracking import TrackConfig, track_volumes_batched
from emfusion_tpu_torch.volume import fg_probs
from synthetic import SyntheticScene

pytestmark = pytest.mark.gpu

SHAPE = (37, 45, 51)          # (Z, Y, X)
VOXEL = 0.06
TRUNC = 5 * VOXEL
H, W = 61, 83


@pytest.fixture(scope="module")
def cuda():
    """Decided at run time, never at collection: skip without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def cam_to_vol(i):
    """Camera-to-volume transform of frame ``i`` (volume centre 1.3 m in
    front of the frame-0 camera)."""
    th = 0.02 * i
    c, s = np.cos(th), np.sin(th)
    T = np.array([[c, 0, s, 0.03 * i], [0, 1, 0, -0.02 * i],
                  [-s, 0, c, 0.01 * i - 1.3], [0, 0, 0, 1]], np.float32)
    return T


@pytest.fixture(scope="module")
def scene(cuda):
    """Two frames fused into the volume by the plain version (CPU), the
    third frame's filtered depth and points, and the intrinsics."""
    sc = SyntheticScene(H=H, W=W, f=0.8 * W, floor_y=0.6)
    intr = torch.tensor(sc.intr)
    tsdf, wts = torch.zeros(SHAPE), torch.zeros(SHAPE)
    frames = []
    for i in range(3):
        cam = np.linalg.inv(cam_to_vol(0)) @ cam_to_vol(i)
        d = torch.tensor(sc.render(cam, np.array([9.0, 9.0, 9.0]))[0])
        frames.append(camera.preprocess_depth(d))
    for i in range(2):
        T = np.linalg.inv(cam_to_vol(i))
        fusion.integrate_tsdf_plain(
            tsdf, wts, frames[i], torch.ones(H, W), torch.tensor(T[:3, :3]),
            torch.tensor(T[:3, 3]), intr, VOXEL, TRUNC, 64.0, 0.8 * TRUNC,
            0.0, 0.25)
    assert (wts > 0).float().mean() > 0.05
    pts = camera.backproject_depth(frames[2], intr)
    return dict(tsdf=tsdf, wts=wts, depth=frames[2], pts=pts, intr=intr)


def launched(name, fn):
    """Run ``fn`` and check that it launched kernel ``name`` once."""
    before = kernels.launches[name]
    out = fn()
    torch.cuda.synchronize()
    assert kernels.launches[name] == before + 1
    return out


def test_bilateral_kernel(cuda):
    rng = np.random.RandomState(0)
    d = (1.0 + rng.uniform(0, 2, (H, W))).astype(np.float32)
    d[rng.uniform(size=(H, W)) < 0.1] = 0.0
    dc = torch.tensor(d, device=cuda)
    k = launched("bilateral", lambda: camera.bilateral_filter(dc))
    q = camera.bilateral_filter_plain(dc)
    assert torch.equal(k, q)


@pytest.mark.parametrize("kernel_size, h, w", [(5, H, W), (7, 37, 45),
                                                (9, H, W), (15, 29, 33)])
def test_bilateral_kernel_sizes(cuda, kernel_size, h, w):
    """The unrolled 7x7 path and the run-time-radius path, on images that
    are not multiples of the 32x16 output tile."""
    rng = np.random.RandomState(kernel_size)
    d = (0.5 + rng.uniform(0, 3, (h, w))).astype(np.float32)
    d[rng.uniform(size=(h, w)) < 0.15] = 0.0
    dc = torch.tensor(d, device=cuda)
    k = launched("bilateral", lambda: camera.bilateral_filter(
        dc, kernel_size, 0.05, 3.0))
    q = camera.bilateral_filter_plain(dc, kernel_size, 0.05, 3.0)
    assert torch.equal(k, q)


def test_bilateral_kernel_refuses_large_window(cuda):
    dc = torch.ones((40, 40), device=cuda)
    with pytest.raises(ValueError):
        camera.bilateral_filter(dc, camera.MAX_KERNEL_SIZE + 2)


@pytest.mark.parametrize("margin", [1, 2])
def test_sample_kernel(cuda, scene, margin):
    T = torch.tensor(cam_to_vol(2))
    vol, pts = scene["tsdf"].to(cuda), scene["pts"].to(cuda)
    k = launched("sample", lambda: sampling.sample_volume_at_points(
        vol, pts, T[:3, :3], T[:3, 3], VOXEL, margin))
    q = sampling.sample_volume_at_points_plain(
        vol, pts, T[:3, :3].to(cuda), T[:3, 3].to(cuda), VOXEL, margin)
    assert torch.equal(k == 0, q == 0) and (k != 0).any()
    assert torch.equal(k, q)


def test_capture_kernel(cuda, scene):
    T = torch.tensor(cam_to_vol(2))
    vols = (scene["tsdf"].to(cuda), scene["wts"].to(cuda))
    pts = scene["pts"].reshape(3, -1).to(cuda)
    kc, ka = launched("capture", lambda: capture.capture_neighborhoods(
        vols, pts, T[:3, :3], T[:3, 3], VOXEL))
    qc, qa = capture.capture_neighborhoods_plain(
        vols, pts, T[:3, :3].to(cuda), T[:3, 3].to(cuda), VOXEL)
    assert torch.equal(ka, qa) and torch.equal(kc, qc)


def test_raycast_kernel(cuda, scene):
    T = torch.tensor(cam_to_vol(2))
    tsdf, wts = scene["tsdf"].to(cuda), scene["wts"].to(cuda)
    k = launched("raycast", lambda: raycast.raycast_volume(
        tsdf, wts, T[:3, :3], T[:3, 3], scene["intr"], VOXEL, TRUNC, H, W,
        256))
    q = raycast.raycast_volume_plain(tsdf, wts, T[:3, :3].to(cuda),
                                     T[:3, 3].to(cuda), scene["intr"],
                                     VOXEL, TRUNC, H, W, 256)
    assert torch.equal(k["mask"], q["mask"]) and q["mask"].any()
    for key in ("raylengths", "vertices", "normals"):
        assert torch.allclose(k[key], q[key], rtol=0, atol=1e-5), key


def raycast_both(tsdf, wts, T, intr, h, w, max_steps):
    """K4 and its plain version on the same CUDA inputs: the masks equal,
    the values within 1e-5 (as test_raycast_kernel)."""
    k = launched("raycast", lambda: raycast.raycast_volume(
        tsdf, wts, T[:3, :3], T[:3, 3], intr, VOXEL, TRUNC, h, w,
        max_steps))
    q = raycast.raycast_volume_plain(tsdf, wts, T[:3, :3].to(tsdf.device),
                                     T[:3, 3].to(tsdf.device), intr, VOXEL,
                                     TRUNC, h, w, max_steps)
    assert torch.equal(k["mask"], q["mask"])
    for key in ("raylengths", "vertices", "normals"):
        assert torch.allclose(k[key], q[key], rtol=0, atol=1e-5), key
    return q


@pytest.mark.parametrize("max_steps", [4, 16])
def test_raycast_kernel_budget(cuda, scene, max_steps):
    """Budgets that cut most rays short: each ray keeps its own count
    while the other rays of its warp march on."""
    T = torch.tensor(cam_to_vol(2))
    q = raycast_both(scene["tsdf"].to(cuda), scene["wts"].to(cuda), T,
                     scene["intr"], H, W, max_steps)
    assert not q["mask"].all()


@pytest.mark.parametrize("h, w", [(1, 1), (7, 13), (4, 8), (61, 83)])
def test_raycast_kernel_image_sizes(cuda, scene, h, w):
    """Images smaller than, and not multiples of, the 32x4-pixel block:
    rows narrower than a warp, and 83-pixel rows that end in a partial
    warp."""
    T = torch.tensor(cam_to_vol(2))
    f = 0.8 * W * min(h, w) / min(H, W)
    intr = torch.tensor([[f, 0.0, (w - 1) / 2.0], [0.0, f, (h - 1) / 2.0],
                         [0.0, 0.0, 1.0]])
    q = raycast_both(scene["tsdf"].to(cuda), scene["wts"].to(cuda), T,
                     intr, h, w, 256)
    assert q["mask"].any() or h * w == 1    # the one centre ray misses


def test_raycast_kernel_unobserved(cuda, scene):
    """A volume whose left half was never observed (exact zeros): rays
    cross it at half-voxel steps."""
    tsdf, wts = scene["tsdf"].clone(), scene["wts"].clone()
    tsdf[:, :, :SHAPE[2] // 2] = 0.0
    wts[:, :, :SHAPE[2] // 2] = 0.0
    T = torch.tensor(cam_to_vol(2))
    q = raycast_both(tsdf.to(cuda), wts.to(cuda), T, scene["intr"], H, W,
                     256)
    assert q["mask"].any()


@pytest.mark.parametrize("pitch", ["x51", "x52", "x52 unaligned"])
def test_raycast_kernel_load_paths(cuda, scene, pitch):
    """X pitches that are and are not a multiple of 4 floats, and volumes
    that are not 16-byte aligned: the kernel's scalar corner loads take
    any of them."""
    tsdf, wts = scene["tsdf"], scene["wts"]
    if pitch != "x51":
        tsdf = torch.nn.functional.pad(tsdf, (0, 1))
        wts = torch.nn.functional.pad(wts, (0, 1))
    if pitch.endswith("unaligned"):
        def shifted(v):
            buf = torch.empty(v.numel() + 1, device=cuda)
            out = buf[1:].view(v.shape)
            out.copy_(v)
            return out
        tsdf, wts = shifted(tsdf), shifted(wts)
    else:
        tsdf, wts = tsdf.to(cuda), wts.to(cuda)
    assert (tsdf.data_ptr() % 16 == 0) == (pitch != "x52 unaligned")
    T = torch.tensor(cam_to_vol(2))
    q = raycast_both(tsdf, wts, T, scene["intr"], H, W, 256)
    assert q["mask"].any()


def test_warp_kernel(cuda):
    """K6 at the frame step's sizes: a 480x640 image onto a 600x896 grid
    (nearest pixel, zero outside the image and behind the plane) and the
    grid back onto the pixels (floor, clamped)."""
    Hh, Ww, nS, nL = 480, 640, 600, 896
    rng = np.random.RandomState(2)
    img = torch.tensor((0.5 + rng.rand(Hh, Ww)).astype(np.float32),
                       device=cuda)
    Bmat = torch.tensor([[Ww * 0.12, 2.0, Ww * 0.3],
                         [1.5, Hh * 0.11, Hh * 0.25], [-0.05, 0.007, 1.0]])
    plane = (-2.5, -2.0, 9.0, 8.0)
    k = launched("warp", lambda: warp.warp_image_to_grid(
        img, Bmat, Hh, Ww, *plane, nS, nL))
    q = warp.warp_homography_plain(img, Bmat, nS, nL, plane)
    assert torch.equal(k, q) and (k == 0).any() and (k > 0).any()
    Binv = torch.linalg.inv(Bmat)
    k2 = launched("warp", lambda: warp.select_grid_at_pixels(
        k, Binv, *plane, Hh, Ww))
    M = warp.grid_index_homography(Binv, *plane, nS, nL)
    q2 = warp.warp_homography_plain(k, M, Hh, Ww, None, round_half=False,
                                    mask_oob=False)
    assert torch.equal(k2, q2)


@pytest.mark.parametrize("nL", [67, 68])
def test_warp_kernel_ragged(cuda, nL):
    """K6 at ragged sizes, exact both ways: a 37x53 image onto a 41 x
    ``nL`` grid (67: rows that are no multiple of four cells; 68: rows of
    whole four-cell groups) through a homography that sends part of the
    grid behind the plane (those cells read 0) and part outside the
    image, and the grid back onto the pixels."""
    Hh, Ww, nS = 37, 53, 41
    rng = np.random.RandomState(5)
    img = torch.tensor((0.5 + rng.rand(Hh, Ww)).astype(np.float32),
                       device=cuda)
    Bmat = torch.tensor([[Ww * 0.12, 2.0, Ww * 0.3],
                         [1.5, Hh * 0.11, Hh * 0.25], [-0.3, 0.007, 1.0]])
    plane = (-2.5, -2.0, 9.0, 8.0)
    k = launched("warp", lambda: warp.warp_image_to_grid(
        img, Bmat, Hh, Ww, *plane, nS, nL))
    q = warp.warp_homography_plain(img, Bmat, nS, nL, plane)
    ag = (torch.arange(nL) + 0.5) / nL * plane[2] + plane[0]
    bg = (torch.arange(nS) + 0.5) / nS * plane[3] + plane[1]
    hz = Bmat[2, 0] * ag[None, :] + Bmat[2, 1] * bg[:, None] + Bmat[2, 2]
    assert (hz <= 0).any() and (hz > 0).any()   # cells behind the plane
    assert torch.equal(k, q) and (k == 0).any() and (k > 0).any()
    Binv = torch.linalg.inv(Bmat)
    k2 = launched("warp", lambda: warp.select_grid_at_pixels(
        k, Binv, *plane, Hh, Ww))
    M = warp.grid_index_homography(Binv, *plane, nS, nL)
    q2 = warp.warp_homography_plain(k, M, Hh, Ww, None, round_half=False,
                                    mask_oob=False)
    assert torch.equal(k2, q2)


def test_fusion_kernel(cuda, scene):
    T = torch.tensor(np.linalg.inv(cam_to_vol(2)))
    rng = np.random.RandomState(1)
    assoc = torch.tensor(rng.uniform(0, 1, (H, W)).astype(np.float32),
                         device=cuda)
    args = (scene["depth"].to(cuda), assoc, T[:3, :3], T[:3, 3],
            scene["intr"], VOXEL, TRUNC, 64.0, 0.8 * TRUNC, 0.0, 0.25)
    kt = scene["tsdf"].to(cuda, copy=True)
    kw = scene["wts"].to(cuda, copy=True)
    launched("fusion", lambda: fusion.integrate_tsdf(kt, kw, *args))
    qt = scene["tsdf"].to(cuda, copy=True)
    qw = scene["wts"].to(cuda, copy=True)
    fusion.integrate_tsdf_plain(qt, qw, *args)
    assert torch.equal(kt, qt) and torch.equal(kw, qw)
    assert not torch.equal(kt, scene["tsdf"].to(cuda))


# ---------------------------------------------------------------------
# K1-K4 at object shapes: a sphere fused into its own small volume at an
# object's voxel size (the object slice runs the same kernels per slot)
OBJ_CASES = [((64, 64, 64), 0.009), ((64, 64, 64), 0.006),
             ((37, 41, 53), 0.009), ((37, 41, 53), 0.006)]
OBJ_CENTRE = np.array([0.05, 0.02, 1.0])    # in the frame-0 camera


def obj_to_cam(i):
    """Object-to-camera transform of frame ``i`` (the camera moves a few
    mm and a few mrad a frame; the object's origin is the sphere's
    centre)."""
    th = 0.01 * i
    c, s = np.cos(th), np.sin(th)
    cam = np.array([[c, 0, s, 0.01 * i], [0, 1, 0, -0.005 * i],
                    [-s, 0, c, 0.004 * i], [0, 0, 0, 1]])
    T = np.eye(4)
    T[:3, 3] = OBJ_CENTRE
    return cam, (np.linalg.inv(cam) @ T).astype(np.float32)


def build_object_scene(shape, vs):
    """Two frames fused into a (Z, Y, X) = ``shape`` object volume by the
    plain versions (association 1 on the object's mask, 0 elsewhere, as
    after a spawn), its fg/bg counts from the masks, and the third frame's
    depth, points, mask and camera-to-object transform."""
    sc = SyntheticScene(H=H, W=W, f=0.8 * W, floor_y=0.6)
    intr = torch.tensor(sc.intr)
    tsdf, wts = torch.zeros(shape), torch.zeros(shape)
    fgc = torch.zeros((2,) + shape)
    td = 10 * vs
    for i in range(3):
        cam, T = obj_to_cam(i)
        d, m = sc.render(cam, OBJ_CENTRE)
        depth = camera.preprocess_depth(torch.tensor(d))
        mask = torch.tensor(m)
        if i == 2:
            break
        R, t = torch.tensor(T[:3, :3]), torch.tensor(T[:3, 3])
        fusion.integrate_tsdf_plain(tsdf, wts, depth, mask.float(), R, t,
                                    intr, vs, td, 64.0)
        fgc = fusion.integrate_fg_mask(tsdf, wts, fgc, mask,
                                       torch.zeros_like(mask), R, t, intr, vs)
    assert (wts > 0).sum() > 500 and (fgc[0] > 0).sum() > 100
    Tco = torch.tensor(np.linalg.inv(T))
    return dict(tsdf=tsdf, wts=wts, fgc=fgc, depth=depth, mask=mask,
                pts=camera.backproject_depth(depth, intr), intr=intr, vs=vs,
                td=td, T=torch.tensor(T), Tco=Tco)


@pytest.fixture(scope="module", params=OBJ_CASES,
                ids=[f"{'x'.join(map(str, s))}-{v * 1e3:g}mm"
                     for s, v in OBJ_CASES])
def obj_scene(cuda, request):
    return build_object_scene(*request.param)


def test_object_fusion_kernel(cuda, obj_scene):
    o = obj_scene
    T = o["T"]
    args = (o["depth"].to(cuda), o["mask"].float().to(cuda), T[:3, :3],
            T[:3, 3], o["intr"], o["vs"], o["td"], 64.0)
    kt, kw = o["tsdf"].to(cuda, copy=True), o["wts"].to(cuda, copy=True)
    launched("fusion", lambda: fusion.integrate_tsdf(kt, kw, *args))
    qt, qw = o["tsdf"].to(cuda, copy=True), o["wts"].to(cuda, copy=True)
    fusion.integrate_tsdf_plain(qt, qw, *args)
    assert torch.equal(kt, qt) and torch.equal(kw, qw)
    assert not torch.equal(kw, o["wts"].to(cuda))


@pytest.mark.parametrize("volume", ["tsdf", "fg_probs"])
def test_object_sample_kernel(cuda, obj_scene, volume):
    """K2's two object samples: the TSDF and the fg probability."""
    o = obj_scene
    vol = (o["tsdf"] if volume == "tsdf" else fg_probs(o["fgc"])).to(cuda)
    T, pts = o["Tco"], o["pts"].to(cuda)
    k = launched("sample", lambda: sampling.sample_volume_at_points(
        vol, pts, T[:3, :3], T[:3, 3], o["vs"], 1))
    q = sampling.sample_volume_at_points_plain(
        vol, pts, T[:3, :3].to(cuda), T[:3, 3].to(cuda), o["vs"], 1)
    assert torch.equal(k, q) and (k != 0).sum() > 100


def test_object_capture_kernel(cuda, obj_scene):
    o = obj_scene
    T = o["Tco"]
    vols = (o["tsdf"].to(cuda), o["wts"].to(cuda))
    pts = o["pts"].reshape(3, -1).to(cuda)
    kc, ka = launched("capture", lambda: capture.capture_neighborhoods(
        vols, pts, T[:3, :3], T[:3, 3], o["vs"]))
    qc, qa = capture.capture_neighborhoods_plain(
        vols, pts, T[:3, :3].to(cuda), T[:3, 3].to(cuda), o["vs"])
    assert torch.equal(ka, qa) and torch.equal(kc, qc)


def test_object_raycast_kernel(cuda, obj_scene):
    """K4 on the object volume with its weights masked to fg > 0.5
    (``raycast.raycast_object``), as ``test_raycast_kernel``."""
    o = obj_scene
    T = o["Tco"]
    tsdf, wts, fgc = (o[k].to(cuda) for k in ("tsdf", "wts", "fgc"))
    k = launched("raycast", lambda: raycast.raycast_object(
        tsdf, wts, fgc, T[:3, :3], T[:3, 3], o["intr"], o["vs"], o["td"], H,
        W, 256))
    masked = torch.where(fg_probs(fgc) > 0.5, wts, 0.0)
    q = raycast.raycast_volume_plain(tsdf, masked, T[:3, :3].to(cuda),
                                     T[:3, 3].to(cuda), o["intr"], o["vs"],
                                     o["td"], H, W, 256)
    assert torch.equal(k["mask"], q["mask"]) and q["mask"].sum() > 50
    for key in ("raylengths", "vertices", "normals"):
        assert torch.allclose(k[key], q[key], rtol=0, atol=1e-5), key


def test_fusion_skips_invisible_slot(cuda):
    """The pipeline's fusion launches K1 once, over the background and
    each active object the raycast saw, and no other slot: an active but
    invisible slot and an empty one keep their volumes bit for bit (K1
    works in place, so fusing them would change them)."""
    o = build_object_scene((64, 64, 64), 0.009)
    sc = SyntheticScene(H=H, W=W, f=0.8 * W, floor_y=0.6)
    params = Params(frameSize=(W, H), fx=sc.f, fy=sc.f, cx=sc.cx, cy=sc.cy,
                    globalVolumeDims=(32, 32, 32), globalVoxelSize=0.08,
                    volumePose=(0.0, 0.0, 1.28), objVolumeDims=(64, 64, 64),
                    max_objects=3)
    pipe = EMFusionPipeline(params, device=cuda)
    p = pipe.state.objs
    cam, _ = obj_to_cam(2)
    pipe.state.cam_pose = torch.tensor(cam, dtype=torch.float32)
    for k in (0, 1, 2):
        p.tsdf[k] = o["tsdf"].to(cuda)
        p.weights[k] = o["wts"].to(cuda)
        p.assoc[k] = o["mask"].float().to(cuda)
        p.pose[k, :3, 3] = torch.tensor(OBJ_CENTRE, dtype=torch.float32)
        p.voxel_size[k], p.truncdist[k] = o["vs"], o["td"]
    p.active[:] = torch.tensor([True, True, False])
    p.visible[:] = torch.tensor([True, False, False])
    before = [(p.tsdf[k].clone(), p.weights[k].clone()) for k in range(3)]
    n0 = kernels.launches["fusion"]
    by_shape = dict(kernels.launches_by_shape)
    pipe.integrate(o["depth"].to(cuda))
    torch.cuda.synchronize()
    assert kernels.launches["fusion"] == n0 + 1       # one batched launch
    for shape in ((32, 32, 32), (64, 64, 64)):     # background, object
        key = ("fusion", shape)
        assert kernels.launches_by_shape[key] == by_shape.get(key, 0) + 1
    assert not torch.equal(p.weights[0], before[0][1])
    for k in (1, 2):
        assert torch.equal(p.tsdf[k], before[k][0])
        assert torch.equal(p.weights[k], before[k][1])


# ---------------------------------------------------------------------
# K1 and K2 over work tables: the background and object volumes of mixed
# shapes in one launch (bit for bit against the plain versions)
def misaligned(v):
    """A copy of ``v`` 4 bytes past a 16-byte boundary: K1 then takes its
    one-voxel-a-lane path although X is a multiple of 4."""
    buf = torch.empty(v.numel() + 1, device=v.device)
    out = buf[1:].view(v.shape)
    out.copy_(v)
    return out


def fusion_models(cuda, scene, n):
    """``n`` fusion items on the card as (tsdf, weights, assoc, R, t, vs,
    td, carve kwargs): the scene's background volume (37x45x51, one voxel
    a lane) with carve rules, then object volumes cycling through: a
    sphere in 64^3 at 9 mm, in 37x41x53 at 6 mm, the background volume
    around the camera (voxels behind it), a 64^3 volume wholly beside the
    image, an all-zero 64^3 volume (only the -1 and 0 rules fire), a
    16-byte-misaligned 64^3 copy, and a random 8x40x256 volume whose rows
    run out of the image on one side (pieces of a row skipped, others
    fused)."""
    T = np.linalg.inv(cam_to_vol(2))
    depth = scene["depth"].to(cuda)
    rng = np.random.RandomState(n)
    models = [(scene["tsdf"], scene["wts"], T[:3, :3], T[:3, 3], VOXEL,
               TRUNC, dict(carve_dist=0.8 * TRUNC, carve_weight_cap=0.0,
                           carve_margin=0.25))]
    o64 = build_object_scene((64, 64, 64), 0.009)
    o53 = build_object_scene((37, 41, 53), 0.006)
    cycle = [
        (o64["tsdf"], o64["wts"], o64["T"][:3, :3], o64["T"][:3, 3],
         0.009, 0.09),
        (o53["tsdf"], o53["wts"], o53["T"][:3, :3], o53["T"][:3, 3],
         0.006, 0.06),
        (scene["tsdf"], scene["wts"], torch.eye(3),
         torch.tensor([0.1, 0.0, 0.3]), VOXEL, TRUNC),
        (o64["tsdf"], o64["wts"], torch.eye(3),
         torch.tensor([3.0, 0.0, 1.0]), 0.009, 0.09),
        (torch.zeros(64, 64, 64), torch.zeros(64, 64, 64), torch.eye(3),
         torch.tensor([0.0, 0.1, 1.0]), 0.012, 0.06),
        (o64["tsdf"], o64["wts"], o64["T"][:3, :3], o64["T"][:3, 3],
         0.009, 0.09),
        (torch.tensor(rng.uniform(-1, 1, (8, 40, 256)), dtype=torch.float32),
         torch.tensor(rng.choice([0.0, 2.0], (8, 40, 256)),
                      dtype=torch.float32),
         torch.eye(3), torch.tensor([0.2, 0.0, 1.0]), 0.01, 0.05)]
    for i in range(n - 1):
        t, w, R, tr, vs, td = cycle[i % len(cycle)]
        shift = torch.tensor(rng.uniform(-0.05, 0.05, 3), dtype=torch.float32)
        models.append((t, w, R, torch.as_tensor(tr) + shift, vs, td, {}))
    out = []
    for i, (t, w, R, tr, vs, td, kw) in enumerate(models):
        assoc = torch.tensor(rng.uniform(0, 1, (H, W)).astype(np.float32),
                             device=cuda)
        out.append((t.to(cuda), w.to(cuda), assoc, torch.as_tensor(R),
                    torch.as_tensor(tr), vs, td, kw,
                    i > 0 and (i - 1) % len(cycle) == 5))
    return depth, out


@pytest.mark.parametrize("n", [1, 2, 7, 17, 18])
def test_batched_fusion_kernel(cuda, scene, n):
    """K1 over ``n`` volumes in one launch (18: two launches, 17 and 1)
    against the plain version per volume, bit for bit; every volume is
    updated in place and only its own."""
    depth, models = fusion_models(cuda, scene, n)
    kept, ref = [], []
    for t, w, assoc, R, tr, vs, td, kw, mis in models:
        kt = misaligned(t) if mis else t.clone()
        kw_ = misaligned(w) if mis else w.clone()
        kept.append(FusionItem(kt, kw_, assoc, R, tr, vs, td, 64.0, **kw))
        qt, qw = t.clone(), w.clone()
        fusion.integrate_tsdf_plain(qt, qw, depth, assoc, R.to(cuda),
                                    tr.to(cuda), scene["intr"], vs, td, 64.0,
                                    **kw)
        ref.append((qt, qw))
    before = kernels.launches["fusion"]
    fusion.integrate_tsdf_batched(kept, depth, scene["intr"])
    torch.cuda.synchronize()
    assert kernels.launches["fusion"] == before + (1 if n <= 17 else 2)
    for it, (qt, qw) in zip(kept, ref):
        assert torch.equal(it.tsdf, qt) and torch.equal(it.weights, qw)
    assert not torch.equal(kept[0].weights, models[0][1])


def sample_models(cuda, scene, n):
    """``n`` sample items on the card: the background at every pixel's
    point, then object items cycling through: the 64^3 sphere with its
    counts at its points, the 37x41x53 one at a strided subset, an item
    with no points, all-zero counts, and the background volume as an
    object with random counts."""
    T = torch.tensor(cam_to_vol(2))
    items = [sampling.SampleItem(scene["tsdf"].to(cuda),
                                 scene["pts"].to(cuda), T[:3, :3], T[:3, 3],
                                 VOXEL)]
    o64 = build_object_scene((64, 64, 64), 0.009)
    o53 = build_object_scene((37, 41, 53), 0.006)
    p64 = o64["pts"].reshape(3, -1).to(cuda)
    p53 = o53["pts"].reshape(3, -1)[:, ::3].contiguous().to(cuda)
    rng = np.random.RandomState(n)
    counts = torch.tensor(rng.randint(0, 3, (2,) + SHAPE).astype(np.float32))
    cycle = [(o64["tsdf"], o64["fgc"], p64, o64["Tco"], 0.009),
             (o53["tsdf"], o53["fgc"], p53, o53["Tco"], 0.006),
             (o64["tsdf"], o64["fgc"], p64[:, :0], o64["Tco"], 0.009),
             (o64["tsdf"], torch.zeros_like(o64["fgc"]), p64, o64["Tco"],
              0.009),
             (scene["tsdf"], counts, scene["pts"].to(cuda), T, VOXEL)]
    for i in range(n - 1):
        vol, fgc, pts, Tm, vs = cycle[i % len(cycle)]
        items.append(sampling.SampleItem(vol.to(cuda), pts, Tm[:3, :3],
                                         Tm[:3, 3], vs,
                                         counts=fgc.to(cuda)))
    return items


@pytest.mark.parametrize("n", [1, 2, 6, 17, 18])
def test_batched_sample_kernel(cuda, scene, n):
    """K2 over ``n`` items in one launch against the plain version per
    item, bit for bit: ψ and, for objects, the foreground probability
    from the counts; the all-zero counts give 0. Items without points
    are not sent to the kernel (18 items hold 15 with points)."""
    items = sample_models(cuda, scene, n)
    before = kernels.launches["sample"]
    k = sampling.sample_items(items)
    torch.cuda.synchronize()
    assert kernels.launches["sample"] == before + 1
    q = sampling.sample_items_plain([
        sampling.SampleItem(it.vol, it.points, it.rot.to(cuda),
                            it.trans.to(cuda), it.voxel_size,
                            counts=it.counts) for it in items])
    for it, (kp, kf), (qp, qf) in zip(items, k, q):
        assert kp.shape == it.points.shape[1:]
        assert torch.equal(kp, qp)
        assert (kf is None) == (it.counts is None)
        if kf is not None:
            assert torch.equal(kf, qf)
            if not it.counts.any():
                assert not kf.any()
    assert (k[0][0] != 0).any()
    if n > 1:
        assert (k[1][1] > 0.5).sum() > 100


def capture_slots(cuda, n, m):
    """``n`` slots of a batched capture on the card, cycling through the
    64^3 sphere at 9 mm and a 40^3 crop of it at 6 mm, each at its
    frame-2 pose, moved up to 5 cm, with ``m`` of its points (a strided
    pick of the image's, so some lie beyond the volume and some are
    invalid)."""
    o64 = build_object_scene((64, 64, 64), 0.009)
    o40 = build_object_scene((40, 40, 40), 0.006)
    rng = np.random.RandomState(n)
    tsdfs, wts, pts, rots, trans, vss = [], [], [], [], [], []
    for i in range(n):
        o = (o64, o40)[i % 2]
        flat = o["pts"].reshape(3, -1)
        step = flat.shape[1] // m
        pts.append(flat[:, (i % step)::step][:, :m])
        tsdfs.append(o["tsdf"].to(cuda))
        wts.append(o["wts"].to(cuda))
        rots.append(o["Tco"][:3, :3])
        trans.append(o["Tco"][:3, 3] + torch.tensor(
            rng.uniform(-0.05, 0.05, 3), dtype=torch.float32))
        vss.append(o["vs"])
    return (tsdfs, wts, torch.stack(pts).to(cuda), torch.stack(rots),
            torch.stack(trans), torch.tensor(vss, dtype=torch.float32))


@pytest.mark.parametrize("n", [1, 3, 18])
def test_batched_capture_kernel(cuda, n):
    """K3 over ``n`` slots in one launch (18: two launches, 17 and 1),
    mixed 64^3 and 40^3 volumes, 1000 points a slot (not a multiple of
    the 256-point block), against the plain version per slot, bit for
    bit; each launch counts once under each volume shape it touched."""
    tsdfs, wts, pts, rots, trans, vss = capture_slots(cuda, n, 1000)
    before = kernels.launches["capture"]
    by_shape = dict(kernels.launches_by_shape)
    kc, ka = capture.capture_neighborhoods_batched(tsdfs, wts, pts, rots,
                                                   trans, vss)
    torch.cuda.synchronize()
    assert kernels.launches["capture"] == before + (1 if n <= 17 else 2)
    want = {}
    for i0 in range(0, n, 17):
        for shape in {tuple(t.shape) for t in tsdfs[i0:i0 + 17]}:
            want[shape] = want.get(shape, 0) + 1
    for shape, count in want.items():
        key = ("capture", shape)
        assert kernels.launches_by_shape[key] == by_shape.get(key, 0) + count
    qc, qa = capture.capture_neighborhoods_batched_plain(
        tsdfs, wts, pts, rots.to(cuda), trans.to(cuda), vss)
    assert kc.shape == (n, 2, 6, 6, 6, 1000)
    assert torch.equal(ka, qa) and torch.equal(kc, qc)
    inside = ((qa >= 0) & (qa + 6 <= 40)).all(dim=1)
    assert inside.any() and (~inside).any()


def rot_angle(a, b):
    d = a[:3, :3].double().T @ b[:3, :3].double()
    v = torch.stack([d[2, 1] - d[1, 2], d[0, 2] - d[2, 0], d[1, 0] - d[0, 1]])
    return float(torch.arcsin(torch.clamp(v.norm() / 2.0, max=1.0)))


def test_batched_lm_card_matches_cpu(cuda):
    """``track_volumes_batched`` on the card (per stage one K3 launch, one
    ``lm_run`` over cache items and one read) against the same call on
    the CPU (the plain iteration): three slots of the 64^3 sphere at frame
    1's points (a frame it was fused from, so both LMs converge), one at
    the frame's camera-to-object transform, one 1.9 voxels off it, one
    inactive, 30 iterations (the first two converge in stage 2). The
    per-point arithmetic is the same on both; the CPU's sin and cos round
    apart from the card's, so the poses are held within 1e-5, the int
    words (iterations, converged flags, re-captures) equal, the last
    weights within 1e-5. The card call launches K3 and ``lm_cluster`` at
    most twice each, no cooperative ``lm_run`` and no split LM kernel, and
    reads the card at most twice."""
    o = build_object_scene((64, 64, 64), 0.009)
    sc = SyntheticScene(H=H, W=W, f=0.8 * W, floor_y=0.6)
    cam, T = obj_to_cam(1)
    d, m = sc.render(cam, OBJ_CENTRE)
    flat = camera.backproject_depth(camera.preprocess_depth(torch.tensor(d)),
                                    o["intr"]).reshape(3, -1)
    mask = torch.tensor(m).reshape(-1).float()
    idx = torch.sort(mask, descending=True, stable=True).indices[:2048]
    vs = o["vs"]
    rels = torch.tensor(np.linalg.inv(T)).repeat(3, 1, 1)
    rels[1, :3, 3] += torch.tensor([1.5, -1.0, 0.5]) * vs
    args = dict(voxel_sizes=torch.full((3,), vs),
                rel_poses=rels, cfg=TrackConfig(max_iter=30),
                active=torch.tensor([True, True, False]))
    pts = flat[:, idx].repeat(3, 1, 1)
    asc = mask[idx].repeat(3, 1)
    q, qs = track_volumes_batched([o["tsdf"]] * 3, [o["wts"]] * 3,
                                  points=pts, assoc=asc, **args)
    assert qs["converged"].all() and qs["recaptures"].tolist() == [1, 1, 0]
    before = dict(kernels.launches)
    k, ks = track_volumes_batched([o["tsdf"].to(cuda)] * 3,
                                  [o["wts"].to(cuda)] * 3,
                                  points=pts.to(cuda), assoc=asc.to(cuda),
                                  **args)
    torch.cuda.synchronize()
    ran = {n: kernels.launches[n] - before[n] for n in kernels.launches}
    stages = 1 + int(ks["recaptures"].any())
    assert ran["capture"] == stages and ran["lm_cluster"] == stages
    assert ran["lm_run"] == 0
    assert ran["lm_system"] == ran["lm_trial"] == ran["lm_step"] == 0
    assert ks["host_reads"] == stages <= 2
    for s in range(3):
        assert (k[s] - q[s]).abs().max() <= 1e-5, s
    for key in ("iterations", "converged", "recaptures"):
        assert torch.equal(ks[key], qs[key]), key
    for key in ("track_weights", "huber_weights"):
        assert torch.allclose(ks[key].cpu(), qs[key], rtol=0, atol=1e-5), key
    assert (qs["huber_weights"][:2] != 0).sum(dim=1).min() > 100
    assert ks["loop_iterations"] == qs["loop_iterations"]


# ---------------------------------------------------------------------
# bf16 volumes (Params.volume_dtype="bfloat16"): the background pair in
# bf16 beside float32 object slots in one K1 / K2 table, the bf16 capture
# cache, the bf16 raycast, and K4 from an orbit camera outside the volume
def bf16(v):
    return v.to(torch.bfloat16)


@pytest.mark.parametrize("vec", [False, True])
def test_bf16_fusion_kernel(cuda, scene, vec):
    """K1 over a bf16 volume (37x45x51: one voxel a lane; or the 64^3
    object volume as bf16: four voxels, 8 bytes, a lane) and two float32
    object volumes in one launch, against the plain version per volume,
    bit for bit: float32 arithmetic, one round to nearest even at the
    store."""
    depth, models = fusion_models(cuda, scene, 3)
    if vec:
        models[0] = models[1][:4] + models[0][4:]
    kept, ref = [], []
    for i, (t, w, assoc, R, tr, vs, td, kw, _) in enumerate(models):
        if i == 0:
            t, w = bf16(t), bf16(w)
        kept.append(FusionItem(t.clone(), w.clone(), assoc, R, tr, vs, td,
                               64.0, **kw))
        qt, qw = t.clone(), w.clone()
        fusion.integrate_tsdf_plain(qt, qw, depth, assoc, R.to(cuda),
                                    tr.to(cuda), scene["intr"], vs, td, 64.0,
                                    **kw)
        ref.append((qt, qw))
    launched("fusion", lambda: fusion.integrate_tsdf_batched(
        kept, depth, scene["intr"]))
    assert kept[0].tsdf.dtype == torch.bfloat16
    for it, (qt, qw) in zip(kept, ref):
        assert torch.equal(it.tsdf, qt) and torch.equal(it.weights, qw)
    assert not torch.equal(kept[0].weights, bf16(models[0][1]))


def test_bf16_sample_and_capture_kernels(cuda, scene):
    """K2 over the bf16 background and float32 object items in one table,
    and K3 of the bf16 pair (a bf16 cache), against the plain versions,
    bit for bit."""
    items = sample_models(cuda, scene, 4)
    items[0] = dataclasses.replace(items[0], vol=bf16(items[0].vol))
    k = launched("sample", lambda: sampling.sample_items(items))
    q = sampling.sample_items_plain(
        [dataclasses.replace(it, rot=it.rot.to(cuda),
                             trans=it.trans.to(cuda)) for it in items])
    for (kp, kf), (qp, qf) in zip(k, q):
        assert torch.equal(kp, qp)
        assert (kf is None) == (qf is None) and (kf is None or
                                                 torch.equal(kf, qf))
    assert (k[0][0] != 0).any()
    T = torch.tensor(cam_to_vol(2))
    vols = (bf16(scene["tsdf"].to(cuda)), bf16(scene["wts"].to(cuda)))
    pts = scene["pts"].reshape(3, -1).to(cuda)
    kc, ka = launched("capture", lambda: capture.capture_neighborhoods(
        vols, pts, T[:3, :3], T[:3, 3], VOXEL))
    qc, qa = capture.capture_neighborhoods_plain(
        vols, pts, T[:3, :3].to(cuda), T[:3, 3].to(cuda), VOXEL)
    assert kc.dtype == torch.bfloat16
    assert torch.equal(ka, qa) and torch.equal(kc, qc)


@pytest.mark.parametrize("pose", ["camera", "orbit"])
def test_bf16_raycast_kernel(cuda, scene, pose):
    """K4 on the bf16 pair at the camera, and at an orbit pose 1.1 x the
    volume's extent from its centre (outside the box: rays enter through
    the slab test or miss it): bit for bit against the plain version."""
    if pose == "camera":
        T = torch.tensor(cam_to_vol(2))
    else:
        from emfusion_tpu_torch.viz import _look_at
        ext = max(SHAPE) * VOXEL
        eye = np.array([0.4, -0.3, -1.1], np.float32) * ext
        T = torch.tensor(_look_at(eye, np.zeros(3, np.float32)))
    tsdf, wts = bf16(scene["tsdf"].to(cuda)), bf16(scene["wts"].to(cuda))
    k = launched("raycast", lambda: raycast.raycast_volume(
        tsdf, wts, T[:3, :3], T[:3, 3], scene["intr"], VOXEL, TRUNC, H, W,
        256))
    q = raycast.raycast_volume_plain(tsdf, wts, T[:3, :3].to(cuda),
                                     T[:3, 3].to(cuda), scene["intr"],
                                     VOXEL, TRUNC, H, W, 256)
    assert q["mask"].any() and not q["mask"].all()
    for key in k:
        assert torch.equal(k[key], q[key]), key


def test_kernels_refuse_other_dtypes(cuda, scene):
    """A CUDA volume that is neither float32 nor bf16, or a pair of mixed
    dtypes, raises in the wrapper: no launch, no fallback."""
    T = torch.tensor(cam_to_vol(2))
    t, w = scene["tsdf"].to(cuda), scene["wts"].to(cuda)
    before = dict(kernels.launches)
    with pytest.raises(ValueError):
        fusion.integrate_tsdf(t.half(), w.half(), scene["depth"].to(cuda),
                              torch.ones(H, W, device=cuda), T[:3, :3],
                              T[:3, 3], scene["intr"], VOXEL, TRUNC, 64.0)
    with pytest.raises(ValueError):
        raycast.raycast_volume(bf16(t), w, T[:3, :3], T[:3, 3],
                               scene["intr"], VOXEL, TRUNC, H, W, 16)
    with pytest.raises(ValueError):
        capture.capture_neighborhoods((bf16(t), w),
                                      scene["pts"].reshape(3, -1).to(cuda),
                                      T[:3, :3], T[:3, 3], VOXEL)
    with pytest.raises(ValueError):
        sampling.sample_volume_at_points(t.double(), scene["pts"].to(cuda),
                                         T[:3, :3], T[:3, 3], VOXEL)
    assert kernels.launches == before


@pytest.mark.parametrize("cuts", [(0, 18, 37), (0, 5, 21, 37), (0, 36, 37)])
def test_slab_fusion_kernel(cuda, scene, cuts):
    """K1's slab form (the z-sharded background): the 37-plane volume cut
    into z-slabs at ``cuts`` (ragged, one of a single plane), each fused
    alone in its own launch as a rank of a mesh fuses its slab, is bit
    for bit the plain version of the slab and the same planes of one
    whole-volume launch; float32 and bf16, 4-voxel lanes and single."""
    T = np.linalg.inv(cam_to_vol(2))
    R, tr = torch.tensor(T[:3, :3]), torch.tensor(T[:3, 3])
    Z = SHAPE[0]
    depth = scene["depth"].to(cuda)
    for dtype in (torch.float32, torch.bfloat16):
        t0 = scene["tsdf"].to(cuda, dtype)
        w0 = scene["wts"].to(cuda, dtype)
        for vec in (True, False):
            whole = FusionItem(t0.clone(), w0.clone(), torch.ones(
                H, W, device=cuda), R, tr, VOXEL, TRUNC, 64.0, 0.8 * TRUNC,
                0.0, 0.25)
            if vec:                # X = 48: 4 voxels a lane (51: one)
                whole = dataclasses.replace(
                    whole, tsdf=whole.tsdf[..., :48].contiguous(),
                    weights=whole.weights[..., :48].contiguous())
            base = copy_vol(whole)
            launched("fusion", lambda: fusion.integrate_tsdf_batched(
                [whole], depth, scene["intr"]))
            for z0, z1 in zip(cuts[:-1], cuts[1:]):
                slab = dataclasses.replace(
                    base, tsdf=base.tsdf[z0:z1].clone(),
                    weights=base.weights[z0:z1].clone(), z0=z0, Z=Z)
                plain = copy_vol(slab)
                launched("fusion", lambda: fusion.integrate_tsdf_batched(
                    [slab], depth, scene["intr"]))
                fusion.integrate_tsdf_plain(
                    plain.tsdf, plain.weights, depth, plain.assoc,
                    R.to(cuda), tr.to(cuda), scene["intr"], VOXEL, TRUNC,
                    64.0, 0.8 * TRUNC, 0.0, 0.25, z0=z0, Z=Z)
                for a in (plain, dataclasses.replace(
                        whole, tsdf=whole.tsdf[z0:z1],
                        weights=whole.weights[z0:z1])):
                    assert torch.equal(slab.tsdf, a.tsdf)
                    assert torch.equal(slab.weights, a.weights)


def copy_vol(item):
    return dataclasses.replace(item, tsdf=item.tsdf.clone(),
                               weights=item.weights.clone())


def test_slab_outside_volume_refused(cuda, scene):
    t = scene["tsdf"].to(cuda)
    item = FusionItem(t[:10].clone(), t[:10].clone(),
                      torch.ones(H, W, device=cuda), torch.eye(3),
                      torch.zeros(3), VOXEL, TRUNC, 64.0, z0=30, Z=SHAPE[0])
    with pytest.raises(ValueError):
        fusion.integrate_tsdf_batched([item], scene["depth"].to(cuda),
                                      scene["intr"])


def test_sharded_pipeline_nccl(cuda):
    """Two ranks under NCCL, one card each (skips with fewer cards): the
    background-only frames of ``tests/test_distributed.py``'s
    ``TestShardedPipeline`` and the 16-object stress state, sharded over a
    (1, 2) mesh, against the one-card pipeline: E-step images, composite,
    poses, volumes and the sharded meshes bit for bit."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards (NCCL takes one rank a card)")
    import torch_dist_workers as W
    from emfusion_tpu_torch.distributed.mesh import launch
    P = dict(W.SHARDED_PIPELINE, max_objects=16, visibilityThresh=16,
             boundary=2)
    frames = W.wave_frames(4)
    st = W.stress_state(P, frames[0], z=1.0)
    res = launch("torch_dist_workers:pipeline_rank", 2,
                 args=(P, frames[1:], None, st, 1, True), device="cuda",
                 timeout_s=600)
    ref = W.run_frames(W.make_pipeline(P, device=cuda, state=st),
                       frames[1:], 1, True)
    W.assert_same_records(res[0]["recs"], ref)
    assert len(ref[-1]["ids"]) > 8


# ---------------------------------------------------------------------
# the device-resident LM (csrc/lm.cu): lm_system, lm_trial and lm_step
def lm_items(cuda, scene, n, S):
    """S LMs on the scene's volume (every third as a bf16 pair), each at n
    of frame 2's valid points (a ragged count; repeated where the frame
    has fewer), with its own association weights and a start moved off
    frame 2's camera-to-volume transform by its own twist."""
    from emfusion_tpu_torch.geometry.se3 import reorthonormalize, se3_exp
    from emfusion_tpu_torch.tracking import LMItem
    flat = scene["pts"].reshape(3, -1)
    valid = torch.nonzero(flat[2] > 0).flatten()
    rng = np.random.RandomState(100 * S + n)
    items = []
    for k in range(S):
        idx = valid[torch.tensor(rng.randint(0, len(valid), n))]
        pts = flat[:, idx].contiguous().to(cuda)
        asc = torch.tensor(rng.uniform(0.3, 1.0, n).astype(np.float32),
                           device=cuda)
        xi = torch.tensor(rng.normal(0, 0.01, 6).astype(np.float32))
        start = reorthonormalize(torch.tensor(cam_to_vol(2)) @ se3_exp(xi))
        tsdf, wts = scene["tsdf"].to(cuda), scene["wts"].to(cuda)
        if k % 3 == 2:
            tsdf, wts = bf16(tsdf), bf16(wts)
        items.append(LMItem(tsdf, wts, VOXEL, pts, asc, start))
    return items


def hold_lm_phase(kernel_run, plain_run, launch, plain, name):
    """One phase on both runs: ``launch`` through the kernel wrapper, which
    must launch kernel ``name``, and ``plain``, its plain version."""
    before = kernels.launches[name]
    launch(kernel_run)
    torch.cuda.synchronize()
    assert kernels.launches[name] > before
    plain(plain_run)


def assert_sums_agree(k, q):
    """The float64 sums, rounded to float32, equal (a tie may put one a
    float32 ulp apart); then the plain run takes the kernel's sums, so
    both go on from one state."""
    kf, qf = k.float(), q.float()
    ulp = torch.abs(torch.nextafter(qf, torch.full_like(qf, np.inf)) - qf)
    assert (torch.abs(kf - qf) <= ulp).all()
    assert (kf == qf).float().mean() > 0.99
    q.copy_(k)


def assert_states_agree(k, q):
    """The records after a step: the int words bit-equal, the float words
    within 1e-5 (sinf, cosf, acosf there against PyTorch's CUDA
    operators); then the plain run takes the kernel's record."""
    assert torch.equal(k.si, q.si)
    assert torch.allclose(k.sf, q.sf, rtol=1e-5, atol=1e-6)
    q.sf.copy_(k.sf)


@pytest.mark.parametrize("n", [1, 31, 4097])
@pytest.mark.parametrize("S", [1, 3, 16])
def test_lm_kernels_match_plain(cuda, scene, n, S):
    """Every phase of ten LM iterations of S LMs (n points each) held
    against its plain version on the card, in lockstep: the per-point
    values (ψ, gradient, clamped weight, Huber and track weights) and the
    weight maxima bit-equal, the float64 sums equal once rounded to
    float32, the step's records as ``assert_states_agree`` states."""
    from emfusion_tpu_torch import tracking as tr
    cfg = TrackConfig(max_iter=10)
    items = lm_items(cuda, scene, n, S)
    k, q = tr.LMRun(items, cfg), tr.LMRun(items, cfg)
    for _ in range(cfg.max_iter):
        hold_lm_phase(k, q, lambda r: tr.lm_system(r, cfg),
                      lambda r: tr.lm_system_plain(r, cfg), "lm_system")
        for a, b in ((k.w, q.w), (k.hub, q.hub), (k.scratch, q.scratch),
                     (k.wmax, q.wmax)):
            assert torch.equal(a, b)
        assert_sums_agree(k.sys, q.sys)
        for phase, name in ((0, "lm_step"), (None, "lm_trial"),
                            (1, "lm_step")):
            if phase is None:
                hold_lm_phase(k, q, lambda r: tr.lm_trial(r, cfg),
                              lambda r: tr.lm_trial_plain(r, cfg), name)
                assert_sums_agree(k.trial, q.trial)
                continue
            hold_lm_phase(k, q, lambda r: tr.lm_step(r, cfg, phase),
                          lambda r: tr.lm_step_plain(r, cfg, phase), name)
            assert_states_agree(k, q)
    assert int(k.si[:, tr.SI_IT].max()) >= 2
    if n > 1:
        assert (k.w != 0).any()


def test_lm_kernels_refuse_bad_inputs(cuda, scene):
    """A volume pair of two dtypes, or points without contiguous rows,
    raise at the table's binding."""
    from emfusion_tpu_torch.tracking import LMItem, LMRun
    it = lm_items(cuda, scene, 64, 1)[0]
    bad = [LMItem(it.tsdf, bf16(it.weights), VOXEL, it.points, it.assoc,
                  it.rel_pose),
           LMItem(it.tsdf, it.weights, VOXEL, it.points.t().contiguous().t(),
                  it.assoc, it.rel_pose)]
    for b in bad:
        with pytest.raises(ValueError):
            LMRun([b], TrackConfig())


def test_lm_table_cap_is_the_kernels(cuda, scene):
    """A table takes as many LMs as ``lm.cu``'s launch does
    (``emf_max_items``; the plain tables take ``LM_MAX_ITEMS``, its
    value), and one LM more runs as a second table."""
    from emfusion_tpu_torch import tracking as tr
    cap = kernels.library("lm_system").emf_max_items()
    assert cap == tr.LM_MAX_ITEMS
    items = lm_items(cuda, scene, 31, cap + 1)
    before = dict(kernels.launches)
    res = tr.run_lm_items(items, TrackConfig(max_iter=1))
    assert len(res) == cap + 1
    assert all(r["iterations"] == 1 for r in res)
    assert kernels.launches["lm_run"] - before["lm_run"] == 2
    assert kernels.launches["lm_step"] == before["lm_step"]


def test_device_lm_card_matches_cpu(cuda, scene):
    """Whole LMs: ``run_lm_items`` on the card (the kernels) against the
    plain versions on the CPU, over a table of three LMs at 4,097 points:
    the same iterations (within 1) and converged flags, poses within
    1e-5; the card reads the state once (one ``lm_run`` a table). The
    CPU's sin and cos round apart from the card's, so the last
    evaluations' poses differ by up to 1e-5, and a point there may cross
    a validity bound, where its weights jump to 0: the last weights agree
    within 1e-4 at all but 0.5% of the points."""
    from emfusion_tpu_torch import tracking as tr
    cfg = TrackConfig(max_iter=40)
    items = lm_items(cuda, scene, 4097, 3)
    cpu = [tr.LMItem(it.tsdf.cpu(), it.weights.cpu(), it.voxel_size,
                     it.points.cpu(), it.assoc.cpu(), it.rel_pose)
           for it in items]
    before = dict(kernels.launches)
    kres = tr.run_lm_items(items, cfg)
    torch.cuda.synchronize()
    qres = tr.run_lm_items(cpu, cfg)
    assert kres[0]["host_reads"] == 1
    assert kernels.launches["lm_run"] > before["lm_run"]
    assert kernels.launches["lm_trial"] == before["lm_trial"]
    for a, b in zip(kres, qres):
        assert abs(a["iterations"] - b["iterations"]) <= 1
        assert a["converged"] == b["converged"]
        assert torch.allclose(a["pose"], b["pose"], rtol=0, atol=1e-5)
        for key in ("track_weights", "huber_weights"):
            off = (a[key].cpu() - b[key]).abs() > 1e-4
            assert off.float().mean() < 0.005, key


def plain_iteration(run, cfg):
    """One LM iteration of the plain versions (on the card here)."""
    from emfusion_tpu_torch import tracking as tr
    tr.lm_system_plain(run, cfg)
    tr.lm_step_plain(run, cfg, 0)
    tr.lm_trial_plain(run, cfg)
    tr.lm_step_plain(run, cfg, 1)


def hold_lm_run(k, q, cfg, iters):
    """``iters`` iterations of ``lm_run`` on the card (one launch each)
    against the plain iteration, in lockstep: the per-point values and
    the weight maxima bit-equal, the sums equal once rounded to float32,
    the records as ``assert_states_agree`` states; then the plain run
    takes the kernel's state."""
    from emfusion_tpu_torch import tracking as tr
    for _ in range(iters):
        launched(k.kernel, lambda: tr.lm_run(k, cfg, 1))
        plain_iteration(q, cfg)
        for a, b in ((k.w, q.w), (k.hub, q.hub), (k.scratch, q.scratch),
                     (k.wmax, q.wmax)):
            assert torch.equal(a, b)
        assert_sums_agree(k.sys, q.sys)
        assert_sums_agree(k.trial, q.trial)
        assert_states_agree(k, q)
        q.si.copy_(k.si)


@pytest.mark.parametrize("grid", [None, 1, 5])
@pytest.mark.parametrize("n, S", [(4097, 1), (31, 17), (2500, 17)])
def test_lm_run_matches_plain(cuda, scene, n, S, grid):
    """``lm_run`` over S LMs of n points (every third a bf16 pair; with 17
    items the first has 0 points) on the grid the wrapper computes
    (min(spans, co-resident blocks)) and on grids of 1 and 5 blocks,
    passed through the C entry's grid argument: eight iterations held
    against the plain iteration, a launch each; then one launch of all
    eight from the fresh state ends on the same bits (records, sums,
    per-point values)."""
    from emfusion_tpu_torch import tracking as tr
    cfg = TrackConfig(max_iter=8)
    items = lm_items(cuda, scene, n, S)
    if S > 1:
        empty = items[0].points[:, :0].contiguous()
        items[0] = dataclasses.replace(items[0], points=empty,
                                       assoc=items[0].assoc[:0])
    k, q = tr.LMRun(items, cfg), tr.LMRun(items, cfg)
    spans = sum(max(1, -(-m // 1024)) for m in k.n)
    assert k.grid == min(spans, kernels.lm_run_blocks(k.dev))
    if grid is not None:
        k.grid = grid
    hold_lm_run(k, q, cfg, cfg.max_iter)
    assert int(k.si[:, tr.SI_IT].max()) >= 2
    whole = tr.LMRun(items, cfg)
    whole.grid = k.grid
    launched("lm_run", lambda: tr.lm_run(whole, cfg, cfg.max_iter))
    for name in ("si", "sf", "sys", "trial", "w", "hub", "scratch", "wmax"):
        assert torch.equal(getattr(whole, name), getattr(k, name)), name
    if S > 1:
        assert int(k.si[0, tr.SI_IT]) == 1 and int(k.si[0, tr.SI_CONV])


def test_lm_run_stops_on_the_device(cuda, scene):
    """A table whose LMs all converge at their first evaluation (no
    association weight): one launch of 10 iterations leaves them at 1;
    a table that runs into ``max_iter`` (3) stops there whatever the
    launch asks; both as the plain loop ends them."""
    from emfusion_tpu_torch import tracking as tr
    items = lm_items(cuda, scene, 4097, 3)
    still = [dataclasses.replace(it, assoc=torch.zeros_like(it.assoc))
             for it in items]
    for table, cfg, want in ((still, TrackConfig(max_iter=50), 1),
                             (items, TrackConfig(max_iter=3), 3)):
        k, q = tr.LMRun(table, cfg), tr.LMRun(table, cfg)
        launched("lm_run", lambda: tr.lm_run(k, cfg, 10))
        for _ in range(10):      # emf_lm_run's stop rule
            if not bool(q.running(q.si, cfg).any()):
                break
            plain_iteration(q, cfg)
        assert (k.si[:, tr.SI_IT] == want).all()
        assert torch.equal(k.si, q.si)
        assert torch.allclose(k.sf, q.sf, rtol=1e-5, atol=1e-6)


def test_lm_run_refuses_a_grid_too_large(cuda, scene):
    """A grid beyond the blocks the card holds at once is refused by the
    C entry, and the wrapper raises (no fallback)."""
    from emfusion_tpu_torch import tracking as tr
    cfg = TrackConfig(max_iter=4)
    k = tr.LMRun(lm_items(cuda, scene, 31, 1), cfg)
    k.grid = kernels.lm_run_blocks(k.dev) + 1
    with pytest.raises(RuntimeError):
        tr.lm_run(k, cfg, 1)


# ---------------------------------------------------------------------
# lm_run over cache items (the batched object LM's fixed-cache stages)
CACHE_SHIFT = (1.8, -1.2, 0.9)   # voxels between a window's capture and
                                 # its LM's start: part of the points lie
                                 # outside their windows


def cache_lm_items(cuda, scene, ns, dtype):
    """LMs of ``lm_items`` with the point counts ``ns`` as cache items:
    the scene's volumes in ``dtype``, each item's windows captured by K3
    at its start moved by ``CACHE_SHIFT`` voxels."""
    from emfusion_tpu_torch.tracking import LMItem
    base = lm_items(cuda, scene, max(ns), len(ns))
    tsdf = scene["tsdf"].to(cuda).to(dtype)
    wts = scene["wts"].to(cuda).to(dtype)
    items = []
    for it, n in zip(base, ns):
        pts = it.points[:, :n].contiguous()
        R, t = it.rel_pose[:3, :3], it.rel_pose[:3, 3]
        cache, anchor = capture.capture_neighborhoods(
            (tsdf, wts), pts, R, t + torch.tensor(CACHE_SHIFT) * VOXEL,
            VOXEL)
        items.append(LMItem(tsdf, wts, VOXEL, pts, it.assoc[:n].contiguous(),
                            it.rel_pose, cache=cache, anchor=anchor))
    return items


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ns", [(4097, 1000),
                                tuple([0] + [31 + 263 * k for k in range(15)]),
                                tuple(31 + 950 * k for k in range(17)),
                                (34000, 500)])
def test_lm_run_cache_matches_plain(cuda, scene, ns, dtype):
    """``lm_run`` over 2, 16 and 17 cache items of ragged point counts
    (one of 0), which ``lm_cluster`` runs (a cluster of the most spans of
    an item, at most 16, blocks an item), and over 2 with one of 34 spans,
    which the cooperative ``lm_run`` runs (a block a span), float32 and
    bf16 caches: eight iterations a launch each in
    lockstep with the plain iteration on the card (per-point values and
    weight maxima bit-equal, sums equal once rounded to float32, int
    words equal, float words within 1e-5); then one launch of all eight
    from the fresh state ends on the same bits, and the plain iteration
    alone ends on the same int words and poses within 1e-5. Part of the
    points lie outside their windows (they drop out)."""
    from emfusion_tpu_torch import tracking as tr
    cfg = TrackConfig(max_iter=8)
    items = cache_lm_items(cuda, scene, list(ns), dtype)
    k, q = tr.LMRun(items, cfg), tr.LMRun(items, cfg)
    assert k.cached
    spans = [max(1, -(-m // 1024)) for m in k.n]
    if max(spans) <= 16:
        assert k.kernel == "lm_cluster" and k.cluster == max(spans)
        assert k.grid == len(ns) * k.cluster
    else:
        assert k.kernel == "lm_run" and k.cluster == 0
        assert k.grid == min(sum(spans), kernels.lm_run_blocks(k.dev, True))
    out = sum(int(capture.out_of_window_count(
        it.anchor, it.points, it.rel_pose[:3, :3].to(cuda),
        it.rel_pose[:3, 3].to(cuda), VOXEL, SHAPE)) for it in items)
    assert 0 < out < sum(ns) // 2
    hold_lm_run(k, q, cfg, cfg.max_iter)
    assert int(k.si[:, tr.SI_IT].max()) >= 2 and (k.w != 0).any()
    whole = tr.LMRun(items, cfg)
    launched(k.kernel, lambda: tr.lm_run(whole, cfg, cfg.max_iter))
    for name in ("si", "sf", "sys", "trial", "w", "hub", "scratch", "wmax"):
        assert torch.equal(getattr(whole, name), getattr(k, name)), name
    alone = tr.LMRun(items, cfg)
    for _ in range(cfg.max_iter):
        if not bool(alone.running(alone.si, cfg).any()):
            break
        plain_iteration(alone, cfg)
    assert torch.equal(alone.si, whole.si)
    assert (alone.sf[:, :tr.SF_X] - whole.sf[:, :tr.SF_X]).abs().max() <= 1e-5


def test_lm_kernels_refuse_the_other_kind(cuda, scene):
    """Each LM kernel's C entry refuses the others' tables: the
    cooperative ``lm_run`` a table of cache items that fits a cluster,
    ``lm_cluster`` a table of gather items and one of cache items with an
    item of 34 spans; the launch raises and counts nothing."""
    import ctypes
    from emfusion_tpu_torch import tracking as tr
    cfg = TrackConfig(max_iter=4)
    cache = tr.LMRun(cache_lm_items(cuda, scene, [64, 64], torch.float32),
                     cfg)
    large = tr.LMRun(cache_lm_items(cuda, scene, [34000, 64],
                                    torch.float32), cfg)
    gather = tr.LMRun(lm_items(cuda, scene, 64, 2), cfg)
    assert (cache.kernel, large.kernel) == ("lm_cluster", "lm_run")
    before = dict(kernels.launches)
    for run, name, grid in ((cache, "lm_run", (1,)), (gather, "lm_cluster",
                                                      ()),
                            (large, "lm_cluster", ())):
        with pytest.raises(RuntimeError):
            kernels.launch(name, ctypes.addressof(run.table), 2, 1,
                           ctypes.addressof(run.bufs),
                           ctypes.addressof(run.cfg_args), *grid,
                           device=run.dev)
    assert kernels.launches == before


def test_split_kernels_refuse_cache_items(cuda, scene):
    """The split kernels take gather items only: a table of cache items
    raises at ``lm_system`` and ``lm_trial`` before any launch, and a
    table of both kinds at its binding."""
    from emfusion_tpu_torch import tracking as tr
    cfg = TrackConfig(max_iter=4)
    items = cache_lm_items(cuda, scene, [64, 64], torch.float32)
    run = tr.LMRun(items, cfg)
    before = dict(kernels.launches)
    for fn in (tr.lm_system, tr.lm_trial):
        with pytest.raises(ValueError):
            fn(run, cfg)
    assert kernels.launches == before
    with pytest.raises(ValueError):
        tr.LMRun([items[0], lm_items(cuda, scene, 64, 1)[0]], cfg)


# ---------------------------------------------------------------------
# lm_run over re-capturing cache items (the capture sampler's LM)
CAPTURE_STARTS = (0.5, 2.0, 4.0)   # voxels along x off each LM's start


def capture_lm_items(cuda, scene, dtype, n=4097):
    """Three LMs of ``lm_items`` (``n`` points) on the scene's volumes in
    ``dtype``, their starts moved ``CAPTURE_STARTS`` voxels along x, as
    gather items (``tracking.capture_items`` captures their windows)."""
    from emfusion_tpu_torch.tracking import LMItem
    items = []
    for it, dx in zip(lm_items(cuda, scene, n, 3), CAPTURE_STARTS):
        start = it.rel_pose.clone()
        start[0, 3] += dx * VOXEL
        items.append(LMItem(scene["tsdf"].to(cuda).to(dtype),
                            scene["wts"].to(cuda).to(dtype), VOXEL,
                            it.points, it.assoc, start))
    return items


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_capture_lm_matches_plain(cuda, scene, dtype):
    """A table of three re-capturing cache items (the capture sampler's
    LM, budget ``max_recaptures``), float32 and bf16 caches: a launch an
    iteration in lockstep with the plain iteration on the card (as
    ``hold_lm_run``: the drift counts, the re-capture flag and count
    among the int words), and after an iteration that flagged an item,
    K3 at its trial pose into the card run's windows and the plain
    capture into the plain run's (windows and anchors bit-equal); then
    ``tracking.capture_table`` from the start ends on the same bits,
    reading the state at most 1 + its re-captures times; at least one
    re-capture."""
    import dataclasses
    from emfusion_tpu_torch import tracking as tr
    cfg = TrackConfig(max_iter=30, sampler="capture")
    start = tr.capture_items(capture_lm_items(cuda, scene, dtype))
    fresh = [dataclasses.replace(it, cache=it.cache.clone(),
                                 anchor=it.anchor.clone()) for it in start]
    ki = [dataclasses.replace(it, cache=it.cache.clone(),
                              anchor=it.anchor.clone()) for it in start]
    qi = [dataclasses.replace(it, cache=it.cache.clone(),
                              anchor=it.anchor.clone()) for it in start]
    k = tr.LMRun(ki, cfg, recaps=cfg.max_recaptures)
    q = tr.LMRun(qi, cfg, recaps=cfg.max_recaptures)
    recaps = 0
    for _ in range(cfg.max_iter + cfg.max_recaptures + 1):
        if not bool(q.running(q.si, cfg).any()):
            break
        hold_lm_run(k, q, cfg, 1)
        flagged = torch.nonzero(k.si[:, tr.SI_PEND]).flatten().tolist()
        for j in flagged:
            recaps += 1
            pose = k.sf[j, tr.SF_RN:tr.SF_RN + 12].cpu()
            a, b = ki[j], qi[j]
            launched("capture", lambda: capture.capture_into([
                (a.tsdf, a.weights, a.points, pose[:9].reshape(3, 3),
                 pose[9:], VOXEL, a.cache, a.anchor)]))
            c, an = capture.capture_neighborhoods_plain(
                (b.tsdf, b.weights), b.points, pose[:9].reshape(3, 3).to(
                    cuda), pose[9:].to(cuda), VOXEL)
            assert torch.equal(c, a.cache) and torch.equal(an, a.anchor)
            b.cache.copy_(c)
            b.anchor.copy_(an)
    assert recaps >= 1
    assert not bool(k.running(k.si, cfg).any())
    run, (si, _) = tr.capture_table(fresh, cfg)
    for name in ("si", "sf", "sys", "trial", "w", "hub", "scratch", "wmax"):
        assert torch.equal(getattr(run, name), getattr(k, name)), name
    assert run.reads <= 1 + int(si[:, tr.SI_RECAP].sum())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n, kernel", [(4097, "lm_cluster"),
                                       (17000, "lm_run")])
def test_cache_lm_runs_each_lm_on_its_own(cuda, scene, dtype, n, kernel):
    """One launch of ``max_iter`` iterations over the three re-capturing
    cache items of ``n`` points (5 spans: ``lm_cluster``; 17: the
    cooperative ``lm_run``): an LM flagged for a re-capture leaves it
    while the others run on, so the launch ends with an LM flagged and
    another stopped at more iterations (each LM leaves the loop on its
    own record). Held against a chain of one-iteration launches in
    lockstep with the plain iteration under the same rule (the plain
    LMs that left marked ``held``; the launch would resume a flagged
    trial, so a left LM's record and trial error are put back after
    each): per-point values bit-equal, sums equal once rounded to
    float32, records as ``assert_states_agree`` states; then the one
    launch ends on the chain's bits."""
    from emfusion_tpu_torch import tracking as tr
    cfg = TrackConfig(max_iter=30, sampler="capture")
    start = tr.capture_items(capture_lm_items(cuda, scene, dtype, n))

    def table():
        return tr.LMRun([dataclasses.replace(
            it, cache=it.cache.clone(), anchor=it.anchor.clone())
            for it in start], cfg, recaps=cfg.max_recaptures)
    k, q, whole = table(), table(), table()
    assert k.kernel == kernel
    held = torch.zeros(len(start), dtype=torch.bool)
    for i in range(cfg.max_iter):
        if i:
            held |= q.si[:, tr.SI_PEND].cpu() != 0
        if not bool((q.running(q.si.cpu(), cfg) & ~held).any()):
            break
        keep = [x.clone() for x in (k.si, k.sf, k.trial)]
        launched(kernel, lambda: tr.lm_run(k, cfg, 1))
        q.held[:] = held
        plain_iteration(q, cfg)
        q.held[:] = False
        h = held.to(cuda)
        for x, y in zip((k.si, k.sf, k.trial), keep):
            x[h] = y[h]
        for a, b in ((k.w, q.w), (k.hub, q.hub), (k.scratch, q.scratch),
                     (k.wmax, q.wmax)):
            assert torch.equal(a, b)
        assert_sums_agree(k.sys, q.sys)
        assert_sums_agree(k.trial, q.trial)
        assert_states_agree(k, q)
        q.si.copy_(k.si)
    launched(kernel, lambda: tr.lm_run(whole, cfg, cfg.max_iter))
    for name in ("si", "sf", "sys", "trial", "w", "hub", "scratch", "wmax"):
        assert torch.equal(getattr(whole, name), getattr(k, name)), name
    si = whole.si.cpu()
    flagged = si[:, tr.SI_PEND] != 0
    stopped = ~whole.running(si, cfg)
    assert flagged.any() and stopped.any()
    assert int(si[stopped, tr.SI_IT].max()) > int(si[flagged, tr.SI_IT].min())


def test_capture_lm_card_matches_cpu(cuda, scene):
    """Whole capture LMs: ``track_volumes_capture`` on the card (K3 and
    ``lm_run``) against the plain versions on the CPU, a table of the
    three LMs: the same re-captures, iterations within 1, converged flags
    and poses within 1e-5 (the CPU's sin and cos round apart from the
    card's, as in ``test_device_lm_card_matches_cpu``); the card reads
    at most 1 + the table's re-captures times, and its dropped points
    stay on the card."""
    from emfusion_tpu_torch import tracking as tr
    cfg = TrackConfig(max_iter=30, sampler="capture")
    items = capture_lm_items(cuda, scene, torch.float32)
    cpu = [tr.LMItem(it.tsdf.cpu(), it.weights.cpu(), it.voxel_size,
                     it.points.cpu(), it.assoc.cpu(), it.rel_pose)
           for it in items]
    before = dict(kernels.launches)
    kres = tr.track_volumes_capture(items, cfg)
    torch.cuda.synchronize()
    qres = tr.track_volumes_capture(cpu, cfg)
    assert kernels.launches["lm_cluster"] > before["lm_cluster"]
    assert kernels.launches["lm_run"] == before["lm_run"]
    assert kernels.launches["capture"] > before["capture"]
    recaps = sum(st["recaptures"] for _, st in kres)
    assert kres[0][1]["host_reads"] <= 1 + recaps and recaps >= 1
    for (kp, ks), (qp, qs) in zip(kres, qres):
        assert ks["dropped_points"].is_cuda
        assert ks["recaptures"] == qs["recaptures"]
        assert abs(ks["iterations"] - qs["iterations"]) <= 1
        assert ks["converged"] == qs["converged"]
        assert torch.allclose(kp, qp, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------
# a deletion and the freed slot re-used, card against CPU
# tests/test_torch_pipeline_objects.py's SMALL configuration
SMALL = dict(frameSize=(160, 120), fx=120.0, fy=120.0, cx=79.5, cy=59.5,
             globalVolumeDims=(96, 96, 96), globalVoxelSize=0.03,
             volumePose=(0.0, 0.0, 1.4), objVolumeDims=(32, 32, 32),
             maxTrackingIter=30, maskRCNNFrames=3, visibilityThresh=60,
             mask_min_pixels=60, raycast_max_steps=384, max_objects=4)


def respawn_run(dev):
    """``tests/test_torch_pipeline_objects.respawn_sequence`` on ``dev``:
    a static camera, object A seen at frames 0-2 (masked at 0), far out
    of view at 3-5, object C elsewhere at frame 6, masked there. Per
    frame the live ids and their slots; the camera and object poses, the
    object voxel sizes, and slot 0's largest tsdf, weight and fg count
    magnitude as C's spawn left it, before its first fusion."""
    from emfusion_tpu_torch.segmentation import (
        CallableMaskProvider, Detection, make_score_vector,
    )
    sc = SyntheticScene()
    cam = np.eye(4, dtype=np.float32)
    shots = [sc.render(cam, np.array(c)) for c in
             [(0.22, 0.1, 1.05)] * 3 + [(50.0, 50.0, 50.0)] * 3
             + [(-0.1, -0.2, 1.0)]]

    def detect(rgb, frame):
        return [Detection(mask=shots[frame][1],
                          scores=make_score_vector(3, 0.9))
                ] if frame in (0, 6) else []
    pipe = EMFusionPipeline(Params(**SMALL), CallableMaskProvider(detect),
                            device=dev)
    fuse, spawned = pipe.integrate, {}

    def integrate(depth):
        if pipe.frame == 6:
            o = pipe.state.objs
            spawned[0] = max(float(t[0].abs().max())
                             for t in (o.tsdf, o.weights, o.fg_counts))
        return fuse(depth)
    pipe.integrate = integrate
    life, vs = [], {}
    for d, _ in shots:
        pipe.process_frame(None, d)
        ids = pipe.active_object_ids
        life.append({i: pipe._slot_of(i) for i in ids})
        vs.update({i: float(pipe.state.objs.voxel_size[pipe._slot_of(i)])
                   for i in ids})
    return dict(life=life, poses=dict(pipe.poses), vs=vs,
                obj_poses={i: dict(t) for i, t in pipe.obj_poses.items()},
                spawned=spawned)


def test_respawn_card_matches_cpu(cuda):
    """A deletion and the freed slot re-used (the respawn scene of
    ``tests/test_torch_pipeline_objects.py``) on the card and on the CPU:
    A deleted at frame 3, C spawned at frame 6 into slot 0 from zeroed
    volumes, the same ids in the same slots after every frame, camera
    positions within 0.1 background voxel and object positions within
    0.1 object voxel."""
    before = dict(kernels.launches)
    card = respawn_run(cuda)
    for name in ("fusion", "sample", "raycast", "bilateral", "lm_run"):
        assert kernels.launches[name] > before[name], name
    cpu = respawn_run(torch.device("cpu"))
    assert card["life"] == cpu["life"] \
        == [{1: 0}] * 3 + [{}] * 3 + [{2: 0}]
    assert card["spawned"] == cpu["spawned"] == {0: 0.0}
    for f, q in cpu["poses"].items():
        assert np.linalg.norm(card["poses"][f][:3, 3] - q[:3, 3]) \
            < 0.1 * SMALL["globalVoxelSize"], f
    assert card["obj_poses"].keys() == cpu["obj_poses"].keys()
    for i, traj in cpu["obj_poses"].items():
        assert card["obj_poses"][i].keys() == traj.keys()
        for f, q in traj.items():
            assert np.linalg.norm(card["obj_poses"][i][f][:3, 3] - q[:3, 3]) \
                < 0.1 * cpu["vs"][i], (i, f)


# ---------------------------------------------------------------------
# every launch on its tensors' card (not on the current card)
def second_card_run(dev, n_frames=3):
    """The object path on ``dev`` at a small size: a sphere moving 1 cm a
    frame, its mask handed out on frame 0 (a spawn), then tracked; then
    the serial object LMs' table of the next frame run alone. Returns
    the camera and object poses, every state tensor on the host and the
    LMs' results."""
    from emfusion_tpu_torch import tracking as tr
    from emfusion_tpu_torch.segmentation import (
        CallableMaskProvider, Detection, make_score_vector,
    )
    sc = SyntheticScene(H=H, W=W, f=0.8 * W, floor_y=0.6)
    shots = [sc.render(obj_to_cam(i)[0], OBJ_CENTRE + [0.01 * i, 0, 0])
             for i in range(n_frames + 1)]
    params = Params(frameSize=(W, H), fx=0.8 * W, fy=0.8 * W,
                    cx=W / 2 - 0.5, cy=H / 2 - 0.5,
                    globalVolumeDims=(64, 64, 64), globalVoxelSize=0.04,
                    volumePose=(0.0, 0.0, 1.3), objVolumeDims=(32, 32, 32),
                    maxTrackingIter=20, raycast_max_steps=256,
                    max_objects=4, maskRCNNFrames=n_frames + 1,
                    visibilityThresh=16, mask_min_pixels=30, boundary=2)

    def detect(rgb, frame):
        return [Detection(mask=shots[0][1], scores=make_score_vector(3, 0.9))
                ] if frame == 0 else []
    pipe = EMFusionPipeline(params, CallableMaskProvider(detect), device=dev)
    for d, _ in shots[:n_frames]:
        pipe.process_frame(None, d)
    s, o = pipe.state, pipe.state.objs
    live = [int(k) for k in np.nonzero(pipe._h_active)[0]]
    _, points = pipe.preprocess(torch.as_tensor(shots[n_frames][0]))
    lms = tr.run_lm_items(pipe.object_lm_items(points, live), pipe.track_cfg)
    tensors = [s.bg_tsdf, s.bg_weights, s.bg_assoc, s.cam_pose, o.tsdf,
               o.weights, o.fg_counts, o.assoc, o.pose]
    return dict(live=live, poses=dict(pipe.poses),
                obj_poses={i: dict(t) for i, t in pipe.obj_poses.items()},
                tensors=[t.cpu() for t in tensors],
                lms=[{k: (v.cpu() if torch.is_tensor(v) else v)
                      for k, v in r.items()} for r in lms])


def assert_same_run(a, b):
    """Two :func:`second_card_run` results, bit for bit."""
    assert a["live"] == b["live"] and a["live"]
    for key in ("poses", "obj_poses"):
        assert a[key].keys() == b[key].keys()
    for f in a["poses"]:
        np.testing.assert_array_equal(a["poses"][f], b["poses"][f])
    for i in a["obj_poses"]:
        for f, q in a["obj_poses"][i].items():
            np.testing.assert_array_equal(q, b["obj_poses"][i][f])
    for x, y in zip(a["tensors"], b["tensors"]):
        assert torch.equal(x, y)
    for x, y in zip(a["lms"], b["lms"]):
        assert x.keys() == y.keys()
        for k in x:
            assert (torch.equal(x[k], y[k]) if torch.is_tensor(x[k])
                    else x[k] == y[k]), k


def test_second_card_matches_the_first(cuda):
    """The object path (a spawn, then the object tracked) and a table of
    the serial object LMs on ``cuda:1``, while ``cuda:0`` stays the
    current card, bit-equal to the same on ``cuda:0``: every kernel and
    ``lm_run`` launch on the card of its tensors (skips with one card)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    torch.cuda.set_device(0)
    before = dict(kernels.launches)
    one = second_card_run(torch.device("cuda", 1))
    assert torch.cuda.current_device() == 0
    for name in ("fusion", "sample", "raycast", "bilateral", "lm_run"):
        assert kernels.launches[name] > before[name], name
    assert_same_run(one, second_card_run(torch.device("cuda", 0)))
    with pytest.raises(ValueError):
        kernels.check_cuda("test", torch.zeros(3, device="cuda:1"),
                           device=torch.device("cuda", 0))


def test_prefetcher_feeds_the_cli(cuda, tmp_path, monkeypatch):
    """``apps.run_emfusion`` on the card over an 8-frame 64x48 TUM
    sequence: every frame comes through the reader's
    ``NativePrefetcher`` (4 decode workers), in order, the frames run
    the kernels, and ``--frame-meshes 4`` lands its files through the
    run's ``AsyncWriter``."""
    from emfusion_tpu_torch.apps import run_emfusion
    from emfusion_tpu_torch.io import codecs, readers
    h, w, n = 48, 64, 8
    sc = SyntheticScene(H=h, W=w, f=0.8 * w, floor_y=0.6)
    seq = tmp_path / "seq"
    for sub in ("rgb", "depth"):
        (seq / sub).mkdir(parents=True)
    assoc = []
    for i in range(n):
        d, _ = sc.render(obj_to_cam(i)[0], OBJ_CENTRE)
        ts = f"{1000 + i / 30:.6f}"
        grey = np.clip(255 - d * 60, 0, 255).astype(np.uint8)
        codecs.write_png(str(seq / "rgb" / f"{ts}.png"),
                         np.stack([grey] * 3, -1))
        codecs.write_png(str(seq / "depth" / f"{ts}.png"),
                         np.round(d * 5000).astype(np.uint16))
        assoc.append(f"{ts} rgb/{ts}.png {ts} depth/{ts}.png\n")
    (seq / "associations.txt").write_text("".join(assoc))
    (seq / "cfg.cfg").write_text(
        f"[Params]\nframeSize = {w} {h}\nglobalVolumeDims = 64 64 64\n"
        "globalVoxelSize = 0.04\nvolumePose = 0.0 0.0 1.3\n"
        f"[Params.intr]\nfx = {0.8 * w}\nfy = {0.8 * w}\n"
        f"cx = {w / 2 - 0.5}\ncy = {h / 2 - 0.5}\n")
    seen = []

    class Counting(readers.NativePrefetcher):
        def next(self):
            out = super().next()
            if out is not None:
                seen.append(out[2])
            return out
    monkeypatch.setattr(readers, "NativePrefetcher", Counting)
    before = dict(kernels.launches)
    out = tmp_path / "out"
    assert run_emfusion.main(["-t", str(seq), "-e", str(out), "-c",
                              str(seq / "cfg.cfg"),
                              "--frame-meshes", "4"]) == 0
    assert seen == list(range(n))
    assert kernels.launches["fusion"] - before["fusion"] == n
    assert len((out / "poses-cam.txt").read_text().splitlines()) == n
    assert sorted(os.listdir(out / "frame_meshes")) == [
        "mesh_bg_0004.ply", "mesh_bg_0008.ply"]
