"""Phong rendering of composited vertex/normal maps.

Port of ``emfusion_tpu/ops/render.py`` (reference ``kernel_renderPhong`` /
``renderGPU``, ``src/core/cuda/EMFusion.cu:100-186``): an elementwise map,
plain PyTorch on the maps' device.
"""

from __future__ import annotations

import colorsys

import numpy as np
import torch


def make_colormap(seed: int = 6893) -> np.ndarray:
    """Deterministic 256-entry id -> RGB colormap; id 0 is white
    (structure of ``EMFusion::randomColors``, ``src/core/EMFusion.cpp:
    614-633``; the shuffle order differs from the OpenCV RNG)."""
    rng = np.random.RandomState(seed)
    cmap = np.zeros((256, 3), dtype=np.uint8)
    hues = np.arange(1, 256) / 256.0
    rng.shuffle(hues)
    for i, h in enumerate(hues, start=1):
        r, g, b = colorsys.hsv_to_rgb(h, 1.0, 1.0)
        cmap[i] = (int(r * 255), int(g * 255), int(b * 255))
    cmap[0] = (255, 255, 255)
    return cmap


def _normalize(v: torch.Tensor) -> torch.Tensor:
    n = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
    return v / torch.clamp(n, min=1e-12)


def render_phong(vertices: torch.Tensor, normals: torch.Tensor,
                 segmentation: torch.Tensor, colormap,
                 light_pos=(0.0, 0.0, 0.0)) -> torch.Tensor:
    """Phong-shade composited maps: ``vertices``/``normals`` (3, H, W) in
    the camera frame, ``segmentation`` (H, W) ids, ``colormap`` (256, 3)
    uint8. Returns (H, W, 3) uint8 on the maps' device. Coefficients as
    the reference: ka = .3, kd = .5, ks = .2, alpha = 20."""
    ka, kd, ks, alpha = 0.3, 0.5, 0.2, 20
    p = vertices.permute(1, 2, 0)
    n = normals.permute(1, 2, 0)
    valid = torch.any(p != 0.0, dim=-1)
    cmap = torch.as_tensor(np.asarray(colormap), device=p.device)
    colors = (cmap.to(torch.float32) / 255.0)[segmentation.long()]
    light = torch.tensor(light_pos, dtype=torch.float32, device=p.device)
    l = _normalize(light - p)
    pv = _normalize(-p)
    ndotl = torch.sum(n * l, dim=-1, keepdim=True)
    r = _normalize(2.0 * ndotl * n - l)
    rdotv = torch.sum(r * pv, dim=-1, keepdim=True)
    intensity = ka * 1.0 + kd * colors * ndotl + ks * 1.0 * rdotv ** alpha
    img = torch.clamp(intensity * 255.0, 0.0, 255.0)
    img = torch.where(valid[..., None], img, 0.0)
    return img.to(torch.uint8)
