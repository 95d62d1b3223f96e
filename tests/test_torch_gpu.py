"""The port's CUDA kernels against their plain PyTorch versions on the
card, at small ragged shapes (sizes that are not multiples of the
kernels' block sizes), on a scene fused by the plain versions.

Needs a CUDA device, ``nvcc`` and nothing of JAX; without a card every
test skips. On a machine with a card::

    python -m pytest --noconftest -q tests/test_torch_gpu.py

(``--noconftest``: the repository's conftest imports JAX, which the port
does not need and a GPU machine may not have.)
"""

import numpy as np
import pytest
import torch

from emfusion_tpu_torch import kernels
from emfusion_tpu_torch.geometry import camera, capture, sampling
from emfusion_tpu_torch.ops import fusion, raycast, warp
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
