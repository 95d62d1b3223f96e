"""TSDF volume state.

Port of ``emfusion_tpu/volume.py``. A volume is a pair of dense (Z, Y, X)
tensors (tsdf in units of the truncation distance, and integration
weights) that the fusion kernel updates in place; its pose and voxel
size live with the pipeline. Object volumes are float32; the background
pair is float32 or, under ``Params.volume_dtype="bfloat16"``, bf16
(:data:`VOLUME_DTYPES`). Object volumes add a channel-first
(2, Z, Y, X) pair of foreground / background evidence counts.
"""

from __future__ import annotations

from typing import Tuple

import torch


# Params.volume_dtype, resolved, -> the background pair's storage dtype
VOLUME_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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


def fg_probs(fg_counts: torch.Tensor) -> torch.Tensor:
    """Per-voxel foreground probability fg / (fg + bg) of (2, ...) counts,
    0 where there is no evidence (reference ``ObjTSDF::computeFgProbs``,
    ``src/core/ObjTSDF.cpp:218-226``)."""
    total = fg_counts[0] + fg_counts[1]
    return torch.where(total > 0,
                       fg_counts[0] / torch.clamp(total, min=1e-30), 0.0)
