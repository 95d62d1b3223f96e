"""Background TSDF volume state.

Port of the parts of ``emfusion_tpu/volume.py`` that the background-only
pipeline needs. A volume is a pair of dense (Z, Y, X) float32 tensors
(tsdf in units of the truncation distance, and integration weights) that
the fusion kernel updates in place; its pose and voxel size live with the
pipeline.
"""

from __future__ import annotations

from typing import Tuple

import torch


def make_volume(res_xyz: Tuple[int, int, int], device,
                dtype=torch.float32):
    """Zeroed (tsdf, weights) of shape (Z, Y, X) (reference
    ``TSDF::TSDF``/``reset``, ``src/core/TSDF.cpp:28-79``)."""
    X, Y, Z = res_xyz
    return (torch.zeros((Z, Y, X), dtype=dtype, device=device),
            torch.zeros((Z, Y, X), dtype=dtype, device=device))


def volume_corners(res_xyz, voxel_size):
    """Low/high metric corners in the volume frame
    (reference ``TSDF::getCorners``, ``src/core/TSDF.cpp:81-86``)."""
    res = torch.as_tensor(res_xyz, dtype=torch.float32)
    corner = (res - 1.0) * voxel_size / 2.0
    return -corner, corner
