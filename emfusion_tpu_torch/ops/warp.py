"""Nearest-pixel projective warps between an image and a grid.

Port of ``emfusion_tpu/ops/pallas/warp_pallas.py`` (kernel K6,
``csrc/warp.cu``) and of the two XLA forms it stands in for:
:func:`warp_image_to_grid` (``fusion_pencil.warp_image_to_grid``, the
stage-1 pencil warp) and :func:`select_grid_at_pixels` (the sweep
raycast's pixel -> grid warp-back, ``raycast_sweep.warp_grid_to_pixels``).

On the TPU both are stages inside the fusion, psi-sample, raycast and band
kernels, which work on a reference-plane grid. The port's kernels need no
reference plane: the fusion kernel makes the same nearest-pixel projective
pick for each voxel itself, and the psi sampler and the raycast work per
pixel. So the frame step does not call these functions; the tests hold
them against the JAX package's warps, and ``chip_smoke.py`` holds the
kernel against :func:`warp_homography_plain` at the frame step's sizes
(a 480x640 depth image to a 600x896 grid and back).

:func:`warp_homography` on a CUDA image launches K6; on a CPU image it
takes :func:`warp_homography_plain`.
"""

from __future__ import annotations

import torch

from emfusion_tpu_torch import kernels
from emfusion_tpu_torch.geometry.sampling import scalar


def _homography_args(M, plane):
    m = torch.as_tensor(M, dtype=torch.float32).detach().cpu().reshape(9)
    a0, b0, da, db = (0.0, 0.0, 1.0, 1.0) if plane is None else plane
    g = torch.tensor([a0, b0, da, db], dtype=torch.float32)
    return [float(v) for v in m.tolist()] + [float(v) for v in g.tolist()]


def warp_homography_plain(img: torch.Tensor, M, nS: int, nL: int,
                          plane=None, round_half: bool = True,
                          mask_oob: bool = True) -> torch.Tensor:
    """Plain PyTorch version of K6: an (nS, nL) float32 image whose cell
    (s, l) reads ``img`` (H, W) at the pixel the homography ``M`` (3, 3)
    maps the cell to.

    The cell's coordinates are (l, s), or with ``plane = (a0, b0, da, db)``
    the centre of the cell in [a0, a0+da) x [b0, b0+db):
    ``((l+0.5)/nL*da + a0, (s+0.5)/nS*db + b0)``. The pixel is
    ``floor(u + 0.5)`` with ``round_half``, else ``floor(u)``, clamped into
    the image; with ``mask_oob`` a cell whose point lies outside
    ``(-0.5, W-0.5) x (-0.5, H-0.5)`` or has homogeneous z <= 0 gets 0."""
    f32 = torch.float32
    H, W = img.shape
    m = _homography_args(M, plane)
    dev = img.device
    lv = torch.arange(nL, dtype=f32, device=dev)[None, :].expand(nS, nL)
    sv = torch.arange(nS, dtype=f32, device=dev)[:, None].expand(nS, nL)
    if plane is not None:
        # divided by tensors, not Python numbers: see geometry/sampling.py
        a0, b0, da, db = m[9:]
        ag = (lv + 0.5) / scalar(nL, img) * da + a0
        bg = (sv + 0.5) / scalar(nS, img) * db + b0
    else:
        ag, bg = lv, sv
    hu = m[0] * ag + m[1] * bg + m[2]
    hw = m[3] * ag + m[4] * bg + m[5]
    hz = m[6] * ag + m[7] * bg + m[8]
    zs = torch.where(torch.abs(hz) < 1e-12, 1e-12, hz)
    ug = hu / zs
    wg = hw / zs
    off = 0.5 if round_half else 0.0
    pu = torch.clamp(torch.floor(ug + off), 0.0, W - 1.0).long()
    pw = torch.clamp(torch.floor(wg + off), 0.0, H - 1.0).long()
    out = img.reshape(-1)[pw * W + pu].to(f32)
    if mask_oob:
        inb = ((ug > -0.5) & (ug < W - 0.5) & (wg > -0.5) & (wg < H - 0.5)
               & (hz > 0.0))
        out = torch.where(inb, out, 0.0)
    return out


def warp_homography(img: torch.Tensor, M, nS: int, nL: int, plane=None,
                    round_half: bool = True,
                    mask_oob: bool = True) -> torch.Tensor:
    """Kernel K6 wrapper (see :func:`warp_homography_plain`)."""
    if not img.is_cuda:
        return warp_homography_plain(img, M, nS, nL, plane, round_half,
                                     mask_oob)
    H, W = img.shape
    img = img.to(torch.float32).contiguous()
    out = torch.empty((nS, nL), dtype=torch.float32, device=img.device)
    dev = kernels.check_cuda("warp_homography", img, out)
    kernels.launch("warp", img.data_ptr(), out.data_ptr(), H, W, nS, nL,
                   *_homography_args(M, plane), int(plane is not None),
                   int(round_half), int(mask_oob), device=dev)
    return out


def grid_index_homography(Binv, a0, b0, da, db, SB: int, LB: int):
    """``Binv`` followed by the map from plane coordinates (a, b) to grid
    indices ``((a-a0)/da*LB, (b-b0)/db*SB)``, as one 3x3 matrix."""
    f32 = torch.float32
    Binv = torch.as_tensor(Binv, dtype=f32).detach().cpu()
    sa = torch.tensor(LB, dtype=f32) / torch.tensor(da, dtype=f32)
    sb = torch.tensor(SB, dtype=f32) / torch.tensor(db, dtype=f32)
    zero, one = torch.tensor(0.0), torch.tensor(1.0)
    S = torch.stack([
        torch.stack([sa, zero, -torch.tensor(a0, dtype=f32) * sa]),
        torch.stack([zero, sb, -torch.tensor(b0, dtype=f32) * sb]),
        torch.stack([zero, zero, one]),
    ])
    return S @ Binv


def warp_image_to_grid(img: torch.Tensor, Bmat, H: int, W: int, a0, b0,
                       da, db, nS: int, nL: int) -> torch.Tensor:
    """Resample ``img`` (H, W) onto the (nS, nL) reference-plane grid
    spanning [a0, a0+da) x [b0, b0+db): each cell centre goes through
    ``Bmat`` to the nearest pixel; cells that leave the image read 0."""
    if tuple(img.shape) != (H, W):
        raise ValueError(f"warp_image_to_grid: image {tuple(img.shape)} "
                         f"is not ({H}, {W})")
    return warp_homography(img, Bmat, nS, nL, plane=(a0, b0, da, db),
                           round_half=True, mask_oob=True)


def select_grid_at_pixels(grid: torch.Tensor, Binv, a0, b0, da, db,
                          H: int, W: int) -> torch.Tensor:
    """For every pixel of an (H, W) image, the cell of ``grid`` (SB, LB)
    that its ray passes through: ``(a, b)`` = dehomogenised
    ``Binv @ (x, y, 1)``, cell ``(floor((b-b0)/db*SB),
    floor((a-a0)/da*LB))`` clamped into the grid (no zeroing)."""
    SB, LB = grid.shape
    M = grid_index_homography(Binv, a0, b0, da, db, SB, LB)
    return warp_homography(grid, M, H, W, plane=None, round_half=False,
                           mask_oob=False)
