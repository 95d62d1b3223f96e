"""E-step: probabilistic data-association weights.

Port of ``emfusion_tpu/ops/association.py`` (reference
``TSDF::computeAssociation``/``computeLaplace``, ``TSDF.cpp:125-156``, and
the per-pixel normalisation of ``EMFusion::computeAssociationWeights``,
``EMFusion.cpp:635-670``). The ψ sample goes through kernel K2
(:func:`~emfusion_tpu_torch.geometry.sampling.sample_volume_at_points`);
the rest is elementwise.
"""

from __future__ import annotations

import torch

from emfusion_tpu_torch.geometry.sampling import sample_volume_at_points


def compute_laplace(tsdf: torch.Tensor, points_cam: torch.Tensor,
                    rel_rot_co, rel_trans_co, voxel_size, truncdist,
                    assoc_sigma):
    """Laplace likelihood of the TSDF value sampled at each pixel's point:
    ``exp(-truncdist*|psi|/sigma) / (2 sigma)``, and the reference's
    exact-zero sentinel mask (``TSDF.cpp:148-149``)."""
    psi = sample_volume_at_points(tsdf, points_cam, rel_rot_co,
                                  rel_trans_co, voxel_size, margin=1)
    invalid = psi == 0.0
    lap = torch.exp(-truncdist * torch.abs(psi) / assoc_sigma) \
        / (2.0 * assoc_sigma)
    return lap, invalid


def association_weights(tsdf: torch.Tensor, points_cam: torch.Tensor,
                        rel_rot_co, rel_trans_co, voxel_size, truncdist,
                        assoc_sigma, alpha, uni_prior) -> torch.Tensor:
    """Unnormalised background association weight
    ``alpha * laplace + (1-alpha) * uniPrior``, zero where the sample was
    invalid."""
    lap, invalid = compute_laplace(tsdf, points_cam, rel_rot_co,
                                   rel_trans_co, voxel_size, truncdist,
                                   assoc_sigma)
    w = alpha * lap + (1.0 - alpha) * uni_prior
    return torch.where(invalid, 0.0, w)


def object_association_weights(tsdf: torch.Tensor, fg_prob_vol: torch.Tensor,
                               points_cam: torch.Tensor, rel_rot_co,
                               rel_trans_co, voxel_size, truncdist,
                               assoc_sigma, alpha, uni_prior):
    """Unnormalised object association weight (``ObjTSDF.cpp:189-200``):
    the Laplace likelihood times the foreground probability sampled at the
    same point, mixed with the uniform prior, zero where the TSDF sample
    was invalid. Both samples go through K2. Returns ``(w, fg_vals)``."""
    lap, invalid = compute_laplace(tsdf, points_cam, rel_rot_co,
                                   rel_trans_co, voxel_size, truncdist,
                                   assoc_sigma)
    fg_vals = sample_volume_at_points(fg_prob_vol, points_cam, rel_rot_co,
                                      rel_trans_co, voxel_size, margin=1)
    w = alpha * (lap * fg_vals) + (1.0 - alpha) * uni_prior
    return torch.where(invalid, 0.0, w), fg_vals


def normalize_associations(bg_weights: torch.Tensor,
                           obj_weights: torch.Tensor,
                           obj_active: torch.Tensor):
    """Normalise association weights across models per pixel.
    ``obj_weights`` (K, H, W), ``obj_active`` (K,) bool; inactive slots
    contribute nothing and stay zero. 0/0 -> 0, as ``cv::cuda::divide``
    (``EMFusion.cpp:653-669``)."""
    obj_w = torch.where(obj_active[:, None, None], obj_weights, 0.0)
    norm = bg_weights + torch.sum(obj_w, dim=0)
    ok = norm > 0.0
    safe = torch.where(ok, norm, 1.0)
    bg_out = torch.where(ok, bg_weights / safe, 0.0)
    obj_out = torch.where(ok, obj_w / safe, 0.0)
    return bg_out, obj_out
