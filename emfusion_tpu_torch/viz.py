"""Offline visualisation: detection overlays and turntable renders.

Port of ``emfusion_tpu/viz.py``, on numpy alone (the GPU machine has no
PIL):

  * :func:`visualize_detections` (``MaskRCNN::visualize``,
    ``src/core/MaskRCNN.cpp:284-323``): each instance's colour blended
    50/50 into the RGB frame and its bounding box outlined. The JAX
    version also writes a "class: score" label with PIL's bitmap font;
    this one draws no text.
  * :func:`render_orbit_view` / :func:`render_turntable` (the reference's
    cv::viz 3-D window, ``src/core/EMFusion.cpp:162-233``): the fused
    model seen from a virtual orbit camera, through the pipeline's own
    raycast (K4 for the background and each live object, composited) and
    Phong shading, with each object's volume box and the real camera's
    frustum drawn over it by :func:`draw_line`. The orbit camera sits
    outside the background volume, so its rays enter the box through
    K4's slab test, and many miss it. A render holds the pipeline's
    ``lock``, so it sees one whole frame's state.
  * :func:`save_frames` writes frames with ``io.codecs.write_png``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from emfusion_tpu_torch import segmentation as seg_mod
from emfusion_tpu_torch.io.codecs import write_png
from emfusion_tpu_torch.ops.render import make_colormap, render_phong

_CMAP = make_colormap()


def _instance_color(i: int) -> np.ndarray:
    return _CMAP[(i % 255) + 1]


def _mask_bbox(mask: np.ndarray) -> Optional[np.ndarray]:
    ys, xs = np.nonzero(mask)
    if len(ys) == 0:
        return None
    return np.array([ys.min(), xs.min(), ys.max(), xs.max()])


def visualize_detections(rgb: Optional[np.ndarray],
                         dets: Sequence[seg_mod.Detection]) -> np.ndarray:
    """Overlay instance masks and boxes on ``rgb`` (H, W, 3 uint8); a
    black canvas of the first mask's shape where ``rgb`` is None."""
    if rgb is None:
        if not dets:
            return np.zeros((1, 1, 3), np.uint8)
        h, w = dets[0].mask.shape
        rgb = np.zeros((h, w, 3), np.uint8)
    vis = rgb.astype(np.float32).copy()
    for i, d in enumerate(dets):
        m = d.mask.astype(bool)
        vis[m] = 0.5 * vis[m] + 0.5 * _instance_color(i).astype(
            np.float32)[None, :]
    img = vis.astype(np.uint8)
    H, W = img.shape[:2]
    for i, d in enumerate(dets):
        box = d.box if d.box is not None else _mask_bbox(d.mask)
        if box is None:
            continue
        y1, x1, y2, x2 = [int(v) for v in box]
        y1, y2 = np.clip([y1, y2], 0, H - 1)
        x1, x2 = np.clip([x1, x2], 0, W - 1)
        color = _instance_color(i)
        img[y1, x1:x2 + 1] = color
        img[y2, x1:x2 + 1] = color
        img[y1:y2 + 1, x1] = color
        img[y1:y2 + 1, x2] = color
    return img


# ---------------------------------------------------------------------
# turntable rendering
# ---------------------------------------------------------------------

def _look_at(eye: np.ndarray, target: np.ndarray,
             up=(0.0, -1.0, 0.0)) -> np.ndarray:
    """World-from-camera pose whose +z axis looks from eye at target."""
    z = target - eye
    z = z / np.linalg.norm(z)
    up = np.asarray(up, np.float32)
    x = np.cross(up, z)
    if np.linalg.norm(x) < 1e-6:
        x = np.array([1.0, 0.0, 0.0], np.float32)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = x, y, z, eye
    return pose


def _project(pts_w: np.ndarray, cam_pose: np.ndarray, intr: np.ndarray):
    """World points (N, 3) -> pixel coords (N, 2) + in-front mask."""
    T = np.linalg.inv(cam_pose)
    pc = pts_w @ T[:3, :3].T + T[:3, 3]
    z = pc[:, 2]
    ok = z > 1e-6
    zs = np.where(ok, z, 1.0)
    u = pc[:, 0] / zs * intr[0, 0] + intr[0, 2]
    v = pc[:, 1] / zs * intr[1, 1] + intr[1, 2]
    return np.stack([u, v], axis=1), ok


_BOX_EDGES = [(0, 1), (0, 2), (0, 4), (1, 3), (1, 5), (2, 3), (2, 6),
              (3, 7), (4, 5), (4, 6), (5, 7), (6, 7)]
_FRUSTUM_EDGES = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 4), (4, 3),
                  (3, 1)]


def _clip_range(p0, p1, lo, hi):
    """The parameter range [t0, t1] of segment p0-p1 that lies inside the
    box [lo, hi] per axis (Liang-Barsky), or None."""
    t0, t1 = 0.0, 1.0
    d = p1 - p0
    for a in range(2):
        for q, r in ((-d[a], p0[a] - lo[a]), (d[a], hi[a] - p0[a])):
            if q == 0:
                if r < 0:
                    return None
                continue
            t = r / q
            if q < 0:
                t0 = max(t0, t)
            else:
                t1 = min(t1, t)
    return None if t0 > t1 else (t0, t1)


def draw_line(img: np.ndarray, p0, p1, color) -> None:
    """Draw the one-pixel line from ``p0`` to ``p1`` ((x, y) pixel
    coordinates) into ``img`` (H, W, 3) in place, as PIL's
    ``ImageDraw.line`` does: the ends truncated to integers, then one
    pixel per step along the longer axis, the other axis rounded. Only
    the steps that fall near the image are taken, so far-away ends cost
    nothing."""
    H, W = img.shape[:2]
    a = np.trunc(np.asarray(p0, np.float64))
    b = np.trunc(np.asarray(p1, np.float64))
    n = max(abs(b[0] - a[0]), abs(b[1] - a[1]))
    span = _clip_range(a, b, (-1.0, -1.0), (float(W), float(H)))
    if span is None:
        return
    k = np.arange(np.floor(span[0] * n), np.ceil(span[1] * n) + 1)
    t = k / n if n > 0 else np.zeros(1)
    xs = np.rint(a[0] + t * (b[0] - a[0])).astype(np.int64)
    ys = np.rint(a[1] + t * (b[1] - a[1])).astype(np.int64)
    keep = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
    img[ys[keep], xs[keep]] = color


def _draw_lines(img, pts2d, ok, edges, color):
    for a, b in edges:
        if ok[a] and ok[b]:
            draw_line(img, pts2d[a], pts2d[b], color)


def orbit_pose(pipe, yaw: float, pitch: float = -0.25,
               radius: Optional[float] = None) -> np.ndarray:
    """The camera-to-world pose of the orbit camera at ``yaw`` radians
    around the background volume's centre, ``pitch`` the eye height as a
    fraction of the radius (negative = above), ``radius`` by default 1.1
    x the volume's extent (``viz.py:139-145`` of the JAX package)."""
    p = pipe.params
    center = np.asarray(pipe.state.bg_pose, np.float32)[:3, 3]
    if radius is None:
        radius = 1.1 * max(p.globalVolumeDims) * p.globalVoxelSize
    eye = center + radius * np.array([np.sin(yaw), pitch, np.cos(yaw)],
                                     np.float32)
    return _look_at(eye.astype(np.float32), center.astype(np.float32))


def render_orbit_view(pipe, yaw: float, pitch: float = -0.25,
                      radius: Optional[float] = None,
                      with_widgets: bool = True) -> np.ndarray:
    """Render the current fused model from one virtual orbit camera
    (:func:`orbit_pose`): the pipeline's raycast composite from that pose
    and its Phong shading, then, with ``with_widgets``, each live
    object's volume box in its id's colour and the real camera's frustum
    in yellow. Returns an (H, W, 3) uint8 frame; the scene is untouched.
    On a mesh every rank calls it, since the raycast gathers each rank's
    nearest object surface; rank 0 shades the view and the others return
    None.
    """
    pose = orbit_pose(pipe, yaw, pitch, radius)
    intr = np.asarray(pipe.params.intr, np.float32)
    with pipe.lock:
        slots = [int(k) for k in np.nonzero(pipe._h_active)[0]]
        rc = pipe.raycast(slots, cam_pose=torch.from_numpy(pose))
        if not pipe.is_writer:
            return None
        img = render_phong(rc["vertices"], rc["normals"], rc["seg"] % 256,
                           pipe.colormap).cpu().numpy()
        o = pipe.state.objs
        boxes = [(int(pipe._h_ids[k]), o.pose[k].numpy().copy(),
                  float(o.voxel_size[k])) for k in slots]
        cam = pipe.cam_pose.copy()
    if not with_widgets:
        return img
    img = img.copy()
    signs = np.array([[sx, sy, sz] for sz in (-1, 1) for sy in (-1, 1)
                      for sx in (-1, 1)], np.float32)
    for oid, T, vs in boxes:
        corners_o = signs * ((pipe.obj_res - 1) * vs / 2)
        corners_w = corners_o @ T[:3, :3].T + T[:3, 3]
        pts2d, ok = _project(corners_w, pose, intr)
        _draw_lines(img, pts2d, ok, _BOX_EDGES, pipe.colormap[oid % 256])
    zf = 0.25
    fr = np.array([[0, 0, 0],
                   [-zf, -zf * 0.75, zf], [zf, -zf * 0.75, zf],
                   [-zf, zf * 0.75, zf], [zf, zf * 0.75, zf]], np.float32)
    pts2d, ok = _project(fr @ cam[:3, :3].T + cam[:3, 3], pose, intr)
    _draw_lines(img, pts2d, ok, _FRUSTUM_EDGES, (255, 255, 0))
    return img


def render_turntable(pipe, n_views: int = 12,
                     radius: Optional[float] = None,
                     with_widgets: bool = True) -> List[np.ndarray]:
    """The current fused model from a horizontal camera orbit
    (:func:`render_orbit_view` at ``n_views`` evenly spaced yaws; every
    rank of a mesh calls it, and the views are rank 0's)."""
    return [render_orbit_view(pipe, 2 * np.pi * i / n_views,
                              radius=radius, with_widgets=with_widgets)
            for i in range(n_views)]


def save_frames(frames: Sequence[np.ndarray], path_pattern: str) -> None:
    """Write frames as PNGs (``path_pattern % index``)."""
    for i, f in enumerate(frames):
        write_png(path_pattern % i, f)
