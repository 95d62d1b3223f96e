"""E-step: probabilistic data-association weights.

Port of ``emfusion_tpu/ops/association.py`` (reference
``TSDF::computeAssociation``/``computeLaplace``, ``TSDF.cpp:125-156``, and
the per-pixel normalisation of ``EMFusion::computeAssociationWeights``,
``EMFusion.cpp:635-670``). The ψ sample goes through kernel K2
(:func:`~emfusion_tpu_torch.geometry.sampling.sample_items`, one launch
for the background and every object of an E-step); the rest is
elementwise and reads the samples (:func:`weights_from_samples`).
"""

from __future__ import annotations

import torch


def laplace_from_psi(psi: torch.Tensor, truncdist, assoc_sigma):
    """Laplace likelihood of sampled TSDF values:
    ``exp(-truncdist*|psi|/sigma) / (2 sigma)``, and the reference's
    exact-zero sentinel mask (``TSDF.cpp:148-149``)."""
    invalid = psi == 0.0
    lap = torch.exp(-truncdist * torch.abs(psi) / assoc_sigma) \
        / (2.0 * assoc_sigma)
    return lap, invalid


def weights_from_samples(psi: torch.Tensor, truncdist, assoc_sigma, alpha,
                         uni_prior, fg_vals=None) -> torch.Tensor:
    """Unnormalised association weight from a model's samples:
    ``alpha * laplace + (1-alpha) * uniPrior``, the Laplace term times the
    foreground probability ``fg_vals`` for an object
    (``ObjTSDF.cpp:189-200``), zero where the ψ sample was invalid."""
    lap, invalid = laplace_from_psi(psi, truncdist, assoc_sigma)
    if fg_vals is not None:
        lap = lap * fg_vals
    w = alpha * lap + (1.0 - alpha) * uni_prior
    return torch.where(invalid, 0.0, w)


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
