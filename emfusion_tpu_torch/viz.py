"""Detection overlays for the export tree.

Port of ``visualize_detections`` of ``emfusion_tpu/viz.py``
(``MaskRCNN::visualize``, ``src/core/MaskRCNN.cpp:284-323``): each
instance's colour blended 50/50 into the RGB frame and its bounding box
outlined. The JAX version also writes a "class: score" label with PIL's
bitmap font; this one draws no text, so it needs numpy alone. The turntable
and the live viewer are not ported yet (ROADMAP queue 1).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from emfusion_tpu_torch import segmentation as seg_mod
from emfusion_tpu_torch.ops.render import make_colormap

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
