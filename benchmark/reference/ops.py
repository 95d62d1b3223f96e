"""The plain reference's operations: a frozen copy of the port's plain
PyTorch versions of its kernels and of the steps around them.

Copied from ``emfusion_tpu_torch`` (``geometry/se3.py``, ``geometry/
camera.py``, ``geometry/sampling.py``, ``ops/association.py``,
``volume.py``, ``ops/fusion.py``, ``ops/raycast.py``, ``geometry/
capture.py``'s window tests and ``pipeline.py``'s composite) so that a
later change to the program cannot move the yardstick. Nothing here
imports the port. Each function computes its kernel's arithmetic op for
op in float32 (sums as the plain versions order them); the raycast also
takes a subset of image rows (``rows``), since the plain march of every
pixel costs seconds.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

_EPS = 1e-8
# voxels per z-chunk of the plain fusion (bounds its temporaries)
_PLAIN_CHUNK_VOXELS = 1 << 24
# K1's voxel classes (see voxel_classes)
SKIP, BEHIND, HOLE, NEG, BAND = 0, 1, 2, 3, 4
WIN = 6          # a capture window's size per axis
DRIFT_TOL = 0.01


# ---- from the port's geometry.se3 (frozen copy)


def _skew(w: torch.Tensor) -> torch.Tensor:
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    o = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([o, -wz, wy], dim=-1),
        torch.stack([wz, o, -wx], dim=-1),
        torch.stack([-wy, wx, o], dim=-1),
    ], dim=-2)


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def so3_exp(omega: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula, Taylor-safe near zero."""
    theta2 = torch.sum(omega * omega, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    K = _skew(omega)
    K2 = K @ K
    small = theta2 > _EPS
    a = torch.where(small, torch.sin(theta) / theta, 1.0 - theta2 / 6.0)
    b = torch.where(small, (1.0 - torch.cos(theta)) / theta2,
                    0.5 - theta2 / 24.0)
    return _eye3(omega) + a[..., None, None] * K + b[..., None, None] * K2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> axis-angle vector (robust away from theta=pi)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    w = torch.stack([
        R[..., 2, 1] - R[..., 1, 2],
        R[..., 0, 2] - R[..., 2, 0],
        R[..., 1, 0] - R[..., 0, 1],
    ], dim=-1)
    sin_theta = torch.sin(theta)
    small = torch.abs(sin_theta) < 1e-6
    scale = torch.where(small, 0.5 + theta * theta / 12.0,
                        theta / (2.0 * torch.where(small, 1.0, sin_theta)))
    near_pi = theta > 3.0
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis = torch.sqrt(torch.clamp((diag + 1.0) * 0.5, 0.0, 1.0))
    signs = torch.sign(torch.where(torch.abs(w) > 1e-12, w, 1.0))
    w_pi = axis * signs * theta[..., None]
    return torch.where(near_pi[..., None], w_pi, w * scale[..., None])


def _bottom_row(top: torch.Tensor) -> torch.Tensor:
    row = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=top.dtype,
                       device=top.device)
    return torch.cat([top, row.expand(top.shape[:-2] + (1, 4))], dim=-2)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Twist [upsilon, omega] -> 4x4 pose (Sophus convention)."""
    ups, omega = xi[..., :3], xi[..., 3:]
    theta2 = torch.sum(omega * omega, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    K = _skew(omega)
    K2 = K @ K
    R = so3_exp(omega)
    small = theta2 > _EPS
    b = torch.where(small, (1.0 - torch.cos(theta)) / theta2,
                    0.5 - theta2 / 24.0)
    c = torch.where(small, (theta - torch.sin(theta)) / (theta2 * theta),
                    1.0 / 6.0 - theta2 / 120.0)
    V = _eye3(xi) + b[..., None, None] * K + c[..., None, None] * K2
    t = torch.einsum("...ij,...j->...i", V, ups)
    return _bottom_row(torch.cat([R, t[..., None]], dim=-1))


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """4x4 pose -> twist [upsilon, omega]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    omega = so3_log(R)
    theta2 = torch.sum(omega * omega, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    K = _skew(omega)
    K2 = K @ K
    cos_t = torch.cos(theta)
    sin_t = torch.sin(theta)
    denom = 2.0 * (1.0 - cos_t)
    coef = torch.where(
        theta2 > 1e-8,
        (1.0 - theta * sin_t
         / torch.where(torch.abs(denom) > 1e-12, denom, 1.0)) / theta2,
        1.0 / 12.0 + theta2 / 720.0)
    Vinv = _eye3(T) - 0.5 * K + coef[..., None, None] * K2
    ups = torch.einsum("...ij,...j->...i", Vinv, t)
    return torch.cat([ups, omega], dim=-1)


def pose_inverse(T: torch.Tensor) -> torch.Tensor:
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    ti = -torch.einsum("...ij,...j->...i", Rt, t)
    return _bottom_row(torch.cat([Rt, ti[..., None]], dim=-1))


def reorthonormalize(T: torch.Tensor) -> torch.Tensor:
    """Re-orthonormalize the rotation block via QR with a positive-diagonal
    sign fix (``TSDF::prepareTracking``, ``src/core/TSDF.cpp:174-186``).
    Returns a new tensor."""
    Q, Rm = torch.linalg.qr(T[..., :3, :3])
    signs = torch.sign(torch.diagonal(Rm, dim1=-2, dim2=-1))
    signs = torch.where(signs == 0, 1.0, signs)
    out = T.clone()
    out[..., :3, :3] = Q * signs[..., None, :]
    return out


# ---- from the port's geometry.camera (frozen copy)


def backproject_depth(depth: torch.Tensor, intr) -> torch.Tensor:
    """Depth image (H, W) -> camera-space point map, component-first
    (3, H, W): p = ((x-cx)/fx*d, (y-cy)/fy*d, d). Pixels with depth 0 map
    to (0, 0, 0), which downstream code treats as invalid (z <= 0)."""
    H, W = depth.shape
    fx, fy, cx, cy = intrinsics(intr)
    xs = torch.arange(W, dtype=depth.dtype, device=depth.device)
    ys = torch.arange(H, dtype=depth.dtype, device=depth.device)
    u = (xs[None, :] - cx) / fx
    v = (ys[:, None] - cy) / fy
    return torch.stack([u * depth, v * depth, depth], dim=0)


def intrinsics(intr):
    """(fx, fy, cx, cy) as Python floats of their float32 values."""
    m = torch.as_tensor(intr, dtype=torch.float32).detach().cpu()
    return (float(m[0, 0]), float(m[1, 1]), float(m[0, 2]), float(m[1, 2]))


def _spatial_terms(kernel_size: int, sigma_spatial: float) -> list:
    """-(dx^2 + dy^2) / (2 sigma_s^2) per tap, row-major over (dy, dx)."""
    r = kernel_size // 2
    inv2ss = 1.0 / (2.0 * sigma_spatial * sigma_spatial)
    return [-(dx * dx + dy * dy) * inv2ss
            for dy in range(-r, r + 1) for dx in range(-r, r + 1)]


def bilateral_filter_plain(depth: torch.Tensor, kernel_size: int = 7,
                           sigma_depth: float = 0.04,
                           sigma_spatial: float = 4.5) -> torch.Tensor:
    """Plain PyTorch version of K5: k x k bilateral filter with a Gaussian
    spatial and range kernel, reflect-101 borders (OpenCV's default), and
    zero-depth taps left out."""
    r = kernel_size // 2
    inv2sd = 1.0 / (2.0 * sigma_depth * sigma_depth)
    H, W = depth.shape
    pad = torch.nn.functional.pad(depth[None, None], (r, r, r, r),
                                  mode="reflect")[0, 0]
    spatial = _spatial_terms(kernel_size, sigma_spatial)
    num = torch.zeros_like(depth)
    den = torch.zeros_like(depth)
    k = 0
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            shifted = pad[r + dy:r + dy + H, r + dx:r + dx + W]
            dv = shifted - depth
            w = torch.exp(spatial[k] - dv * dv * inv2sd)
            w = torch.where(shifted > 0, w, 0.0)
            num = num + w * shifted
            den = den + w
            k += 1
    return torch.where(den > 0, num / den, 0.0)


# ---- from the port's geometry.sampling (frozen copy)


def scalar(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a float32 0-d tensor on ``like``'s device."""
    return torch.as_tensor(x, dtype=torch.float32).to(like.device)


def transform_to_grid(points_cam: torch.Tensor, rel_rot, rel_trans,
                      voxel_size, shape):
    """Rigid transform + world->grid for component-first points. Returns
    (vx, vy, vz, z_cam)."""
    Z, Y, X = shape
    R = torch.as_tensor(rel_rot, dtype=torch.float32).to(points_cam.device)
    t = torch.as_tensor(rel_trans, dtype=torch.float32).to(points_cam.device)
    px, py, pz = points_cam[0], points_cam[1], points_cam[2]
    wx = R[0, 0] * px + R[0, 1] * py + R[0, 2] * pz + t[0]
    wy = R[1, 0] * px + R[1, 1] * py + R[1, 2] * pz + t[1]
    wz = R[2, 0] * px + R[2, 1] * py + R[2, 2] * pz + t[2]
    vs = scalar(voxel_size, points_cam)
    vx = wx / vs + (X - 1.0) / 2.0
    vy = wy / vs + (Y - 1.0) / 2.0
    vz = wz / vs + (Z - 1.0) / 2.0
    return vx, vy, vz, pz


def trilinear_cell(shape, vx, vy, vz):
    """Base corner (flat int64 index, clipped to [0, res-2] per axis) and
    the fractions against the unclipped floor."""
    Z, Y, X = shape
    x0 = torch.floor(vx).to(torch.int32)
    y0 = torch.floor(vy).to(torch.int32)
    z0 = torch.floor(vz).to(torch.int32)
    fx = vx - x0
    fy = vy - y0
    fz = vz - z0
    base = ((torch.clamp(z0, 0, Z - 2).long() * Y
             + torch.clamp(y0, 0, Y - 2)) * X + torch.clamp(x0, 0, X - 2))
    return base, fx, fy, fz


def lerp8(corner, fx, fy, fz):
    """Trilinear blend of the corners ``corner(dz, dy, dx)``: x, then y,
    then z, as the reference's ``interpolateTrilinear``."""
    c00 = corner(0, 0, 0) * (1 - fx) + corner(0, 0, 1) * fx
    c01 = corner(0, 1, 0) * (1 - fx) + corner(0, 1, 1) * fx
    c10 = corner(1, 0, 0) * (1 - fx) + corner(1, 0, 1) * fx
    c11 = corner(1, 1, 0) * (1 - fx) + corner(1, 1, 1) * fx
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def trilinear_sample(vol: torch.Tensor, vx, vy, vz,
                     valid: torch.Tensor | None = None) -> torch.Tensor:
    """Trilinear interpolation of ``vol`` (Z, Y, X) at fractional grid
    coordinates; out-of-range coordinates must be masked by ``valid``
    (they are clamped for the gather and zeroed in the output)."""
    Z, Y, X = vol.shape
    base, fx, fy, fz = trilinear_cell((Z, Y, X), vx, vy, vz)
    flat = vol.reshape(-1)

    def corner(dz, dy, dx):
        return flat[base + ((dz * Y + dy) * X + dx)].to(torch.float32)

    out = lerp8(corner, fx, fy, fz)
    if valid is not None:
        out = torch.where(valid, out, 0.0)
    return out


def trilinear_sample_channels(vol: torch.Tensor, vx, vy, vz,
                              valid: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """:func:`trilinear_sample` of each channel of a channel-first
    (C, Z, Y, X) volume; returns (C, ...)."""
    return torch.stack([trilinear_sample(v, vx, vy, vz, valid)
                        for v in vol])


def _grid_and_valid(points_cam, rel_rot, rel_trans, voxel_size, shape,
                    margin):
    """Grid coordinates of the points and the validity of K2's sample:
    ``z_cam > 0`` and ``v`` inside ``[0, res - 1 - margin)`` per axis."""
    Z, Y, X = shape
    vx, vy, vz, pz = transform_to_grid(points_cam, rel_rot, rel_trans,
                                       voxel_size, shape)
    valid = (pz > 0) & (vx >= 0.0) & (vy >= 0.0) & (vz >= 0.0)
    valid &= (vx + margin < X) & (vy + margin < Y) & (vz + margin < Z)
    return vx, vy, vz, valid


def sample_volume_at_points_plain(vol: torch.Tensor,
                                  points_cam: torch.Tensor, rel_rot,
                                  rel_trans, voxel_size,
                                  margin: int = 1) -> torch.Tensor:
    """Plain PyTorch version of K2's ψ (``kernel_getVolumeVals``,
    ``TSDF.cu:662-726``): ``p = R p_cam + t``, ``v = p/voxel + (res-1)/2``;
    the result is exactly 0 where the point is invalid (``z_cam <= 0``) or
    ``v`` lies outside ``[0, res - 1 - margin)`` on any axis.
    ``vol`` (Z, Y, X) or (C, Z, Y, X); returns the points' trailing shape
    (with a leading C for a multi-channel volume)."""
    vx, vy, vz, valid = _grid_and_valid(points_cam, rel_rot, rel_trans,
                                        voxel_size, vol.shape[-3:], margin)
    if vol.dim() == 3:
        return trilinear_sample(vol, vx, vy, vz, valid)
    return trilinear_sample_channels(vol, vx, vy, vz, valid)


def trilinear_fg_probs(counts: torch.Tensor, vx, vy, vz,
                       valid: torch.Tensor) -> torch.Tensor:
    """The foreground probability of (2, Z, Y, X) fg/bg ``counts`` at
    fractional grid coordinates: each corner's ``fg / max(fg + bg,
    1e-30)``, 0 where ``fg + bg`` is 0 (``volume.fg_probs``, in its
    operation order), blended as :func:`trilinear_sample` blends, so it
    equals sampling ``fg_probs(counts)`` without building that volume.
    Zero where not ``valid``."""
    Z, Y, X = counts.shape[1:]
    base, fx, fy, fz = trilinear_cell((Z, Y, X), vx, vy, vz)
    fg, bg = counts[0].reshape(-1), counts[1].reshape(-1)

    def corner(dz, dy, dx):
        idx = base + ((dz * Y + dy) * X + dx)
        f = fg[idx]
        total = f + bg[idx]
        return torch.where(total > 0, f / torch.clamp(total, min=1e-30),
                           0.0)

    return torch.where(valid, lerp8(corner, fx, fy, fz), 0.0)


def sample_system_at_points(vol: torch.Tensor, points_cam: torch.Tensor,
                            rel_rot, rel_trans, voxel_size):
    """The LM's residual and finite-difference gradient in one gather
    (``sampling.py:178-267`` of the JAX package): the margin-1 value
    (``kernel_getVolumeVals``, ``TSDF.cu:662-726``) and the margin-2 base
    and three axis-shifted trilerps whose differences give the SDF
    gradient (``kernel_computePoseGradients``, ``TSDF.cu:603-660``), all
    from the 3x3x3 corner neighbourhood of each point, gathered once
    (one ``torch.take`` of a (3, 3, 3, ...) index tensor; each corner
    index clipped to the volume per axis).

    Returns ``(psi, g3)``: ``psi`` of the points' trailing shape and
    ``g3`` (3,) + trailing, already divided by ``voxel_size``."""
    Z, Y, X = vol.shape
    dev = vol.device
    vx, vy, vz, pz = transform_to_grid(points_cam, rel_rot, rel_trans,
                                       voxel_size, (Z, Y, X))
    x0 = torch.floor(vx).to(torch.int32)
    y0 = torch.floor(vy).to(torch.int32)
    z0 = torch.floor(vz).to(torch.int32)
    fx = vx - x0
    fy = vy - y0
    fz = vz - z0
    d = torch.arange(3, dtype=torch.int64, device=dev).reshape(
        (3,) + (1,) * x0.dim())
    xi = torch.clamp(x0.long() + d, 0, X - 1)
    yi = torch.clamp(y0.long() + d, 0, Y - 1)
    zi = torch.clamp(z0.long() + d, 0, Z - 1)
    idx = (zi[:, None, None] * Y + yi[None, :, None]) * X \
        + xi[None, None, :]
    c = torch.take(vol, idx).to(torch.float32)   # c[dz][dy][dx]

    def trilerp(oz, oy, ox):
        def lx(dy, dz):
            return c[dz, dy, ox] * (1 - fx) + c[dz, dy, ox + 1] * fx

        def ly(dz):
            return lx(oy, dz) * (1 - fy) + lx(oy + 1, dz) * fy

        return ly(oz) * (1 - fz) + ly(oz + 1) * fz

    base_val = trilerp(0, 0, 0)
    inside = (pz > 0) & (vx >= 0.0) & (vy >= 0.0) & (vz >= 0.0)
    valid1 = inside & (vx + 1 < X) & (vy + 1 < Y) & (vz + 1 < Z)
    valid2 = inside & (vx + 2 < X) & (vy + 2 < Y) & (vz + 2 < Z)
    psi = torch.where(valid1, base_val, 0.0)
    base = torch.where(valid2, base_val, 0.0)

    # the validity of each shifted trilerp is evaluated on the shifted
    # coordinates, as sample_volume_at_points(grid_offset=e) would
    def vld(ex, ey, ez):
        return ((pz > 0)
                & (vx + ex >= 0.0) & (vy + ey >= 0.0) & (vz + ez >= 0.0)
                & (vx + ex + 2 < X) & (vy + ey + 2 < Y) & (vz + ez + 2 < Z))

    sx = torch.where(vld(1, 0, 0), trilerp(0, 0, 1), 0.0)
    sy = torch.where(vld(0, 1, 0), trilerp(0, 1, 0), 0.0)
    sz = torch.where(vld(0, 0, 1), trilerp(1, 0, 0), 0.0)
    g3 = torch.stack([sx - base, sy - base, sz - base]) \
        / scalar(voxel_size, vol)
    return psi, g3


# ---- from the port's ops.association (frozen copy)


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


# ---- from the port's volume (frozen copy)


def fg_probs(fg_counts: torch.Tensor) -> torch.Tensor:
    """Per-voxel foreground probability fg / (fg + bg) of (2, ...) counts,
    0 where there is no evidence (reference ``ObjTSDF::computeFgProbs``,
    ``src/core/ObjTSDF.cpp:218-226``)."""
    total = fg_counts[0] + fg_counts[1]
    return torch.where(total > 0,
                       fg_counts[0] / torch.clamp(total, min=1e-30), 0.0)


# ---- from the port's ops.fusion (frozen copy)


def _carve_flags(truncdist, carve_dist, carve_weight_cap, carve_margin,
                 dtype=torch.float32):
    """(carve_dist, has_cap, cap, has_margin, margin), the cap rounded to
    the volume's storage ``dtype``."""
    carve = truncdist if carve_dist is None else carve_dist
    has_cap = carve_weight_cap is not None
    has_margin = has_cap and carve_margin is not None
    cap = (float(torch.tensor(float(carve_weight_cap)).to(dtype))
           if has_cap else 0.0)
    return (float(carve), has_cap, cap,
            has_margin, float(carve_margin) if has_margin else 0.0)


def _project_voxels(R, t, xs, ys, zs, intr, H, W):
    """The voxel centres ``xs`` x ``ys`` x ``zs`` (metric, volume frame)
    in the camera, and the pixel each projects to, rounded half to even:
    (ccx, ccy, ccz, in_front, pix_x, pix_y, in_frame, pix), ``pix`` the
    flat pixel index clamped into the image."""
    fx, fy, cx, cy = intrinsics(intr)
    px, py, pz = xs[None, None, :], ys[None, :, None], zs[:, None, None]
    ccx = R[0, 0] * px + R[0, 1] * py + R[0, 2] * pz + t[0]
    ccy = R[1, 0] * px + R[1, 1] * py + R[1, 2] * pz + t[1]
    ccz = R[2, 0] * px + R[2, 1] * py + R[2, 2] * pz + t[2]
    in_front = ccz > 0.0
    zsafe = torch.where(in_front, ccz, 1.0)
    pix_x = torch.round(ccx * fx / zsafe + cx).to(torch.int32)
    pix_y = torch.round(ccy * fy / zsafe + cy).to(torch.int32)
    in_frame = (pix_x >= 0) & (pix_x < W) & (pix_y >= 0) & (pix_y < H)
    pix = (torch.clamp(pix_y, 0, H - 1).long() * W
           + torch.clamp(pix_x, 0, W - 1))
    return ccx, ccy, ccz, in_front, pix_x, pix_y, in_frame, pix


def _axis(n: int, vs: torch.Tensor) -> torch.Tensor:
    """Metric voxel-centre coordinates along an axis of ``n`` voxels."""
    return (torch.arange(n, dtype=torch.float32, device=vs.device)
            - (n - 1) / 2.0) * vs


def _chunks(shape, depth, rel_rot_oc, rel_trans_oc, intr, voxel_size,
            like, slab_z0: int = 0, full_Z=None):
    """Per z-chunk of a (Z, Y, X) volume: ``(z0, z1, terms)``, ``terms``
    the voxels' projection, the depth at their pixel, ``valid`` and the
    sdf (the part of K1 that every voxel computes). The volume may be the
    planes ``[slab_z0, slab_z0 + Z)`` of one ``full_Z`` planes deep: its
    centres are then that volume's (chunk bounds stay slab-local)."""
    Z, Y, X = shape
    full_Z = Z if full_Z is None else full_Z
    H, W = depth.shape
    dev = like.device
    fx, fy, cx, cy = intrinsics(intr)
    fx_t, fy_t = scalar(fx, like), scalar(fy, like)
    vs = scalar(voxel_size, like)
    R = torch.as_tensor(rel_rot_oc, dtype=torch.float32).to(dev)
    t = torch.as_tensor(rel_trans_oc, dtype=torch.float32).to(dev)
    dflat = depth.reshape(-1)
    xs, ys = _axis(X, vs), _axis(Y, vs)
    step = max(1, _PLAIN_CHUNK_VOXELS // (Y * X))
    for z0 in range(0, Z, step):
        z1 = min(Z, z0 + step)
        zs = (torch.arange(slab_z0 + z0, slab_z0 + z1, dtype=torch.float32,
                           device=dev) - (full_Z - 1) / 2.0) * vs
        ccx, ccy, ccz, in_front, pix_x, pix_y, in_frame, pix = \
            _project_voxels(R, t, xs, ys, zs, intr, H, W)
        depth_val = dflat[pix]
        valid = in_front & in_frame & (depth_val > 0.0)
        ux = (pix_x.to(torch.float32) - cx) / fx_t
        uy = (pix_y.to(torch.float32) - cy) / fy_t
        lam = torch.sqrt(ux * ux + uy * uy + 1.0)
        norm_cam = torch.sqrt(ccx * ccx + ccy * ccy + ccz * ccz)
        yield z0, z1, dict(in_front=in_front, in_frame=in_frame, pix=pix,
                           depth_val=depth_val, valid=valid,
                           sdf=depth_val - norm_cam / lam)


def voxel_classes(shape, depth: torch.Tensor, rel_rot_oc, rel_trans_oc,
                  intr, voxel_size, truncdist, z0: int = 0,
                  Z=None) -> torch.Tensor:
    """K1's class of each voxel of a (Z, Y, X) volume for this frame, as
    int8: ``SKIP`` in front of the camera and outside the image, or on a
    pixel whose depth is NaN (no rule can change it); ``BEHIND`` behind
    the camera and ``HOLE`` on a pixel without depth (only the 0 rule,
    where the weight is 0); ``NEG`` more than ``truncdist`` behind the
    surface (only the -1 rule, where the weight is 0); ``BAND`` the rest,
    which takes the full update. The kernel loads a voxel's weight unless
    it is ``SKIP``, and its tsdf for ``BAND`` or where the weight is 0.
    ``z0``/``Z``: a slab's first plane and the whole depth (FusionItem)."""
    out = torch.empty(tuple(shape), dtype=torch.int8, device=depth.device)
    td = scalar(truncdist, depth)
    for zc0, zc1, c in _chunks(shape, depth, rel_rot_oc, rel_trans_oc, intr,
                               voxel_size, depth, z0, Z):
        cls = torch.where(c["in_front"], SKIP, BEHIND)
        cls = torch.where(c["in_front"] & c["in_frame"]
                          & (c["depth_val"] <= 0.0), HOLE, cls)
        cls = torch.where(c["valid"] & (c["sdf"] < -td), NEG, cls)
        cls = torch.where(c["valid"] & (c["sdf"] >= -td), BAND, cls)
        out[zc0:zc1] = cls.to(torch.int8)
    return out


def integrate_tsdf_plain(tsdf: torch.Tensor, weights: torch.Tensor,
                         depth: torch.Tensor, assoc_weights: torch.Tensor,
                         rel_rot_oc, rel_trans_oc, intr, voxel_size,
                         truncdist, max_weight: float, carve_dist=None,
                         carve_weight_cap=None, carve_margin=None,
                         z0: int = 0, Z=None):
    """Plain PyTorch version of K1, ``kernel_updateTSDF`` semantics
    (``TSDF.cu:327-427``), in place, a z-chunk at a time:

    * a voxel behind the camera, or projecting to a pixel without depth,
      with weight 0: tsdf reset to 0;
    * ``sdf < -truncdist`` with weight 0: tsdf set to -1;
    * inside the band: running weighted average with the pixel's
      association weight (1.0 for ``sdf >= carve_dist``, default
      ``truncdist``), the weight capped at ``max_weight``;
    * ``carve_weight_cap``: on carve votes the stored weight entering the
      average is clamped to it, only where ``tsdf_meas - tsdf`` exceeds
      ``carve_margin`` when that is given (see the JAX docstring).

    A bf16 pair is read as float32 and rounded once at the store. ``z0``
    and ``Z``: a slab's first plane and the whole depth (FusionItem).
    """
    td = scalar(truncdist, tsdf)
    carve, has_cap, cap, has_margin, margin = _carve_flags(
        truncdist, carve_dist, carve_weight_cap, carve_margin, tsdf.dtype)
    aflat = assoc_weights.reshape(-1)
    for zc0, zc1, c in _chunks(tsdf.shape, depth, rel_rot_oc, rel_trans_oc,
                               intr, voxel_size, tsdf, z0, Z):
        valid, sdf = c["valid"], c["sdf"]
        assoc_val = aflat[c["pix"]]
        t_old = tsdf[zc0:zc1].to(torch.float32)
        w_old = weights[zc0:zc1].to(torch.float32)
        in_band = valid & (sdf >= -td)
        tsdf_meas = torch.sign(sdf) * torch.clamp(torch.abs(sdf) / td,
                                                  max=1.0)
        carving = valid & (sdf >= carve)
        new_w = torch.where(carving, 1.0, assoc_val)
        w_eff = w_old
        if has_cap:
            capped = carving
            if has_margin:
                capped = carving & (tsdf_meas - t_old > margin)
            w_eff = torch.where(capped, torch.clamp(w_old, max=cap), w_old)
        denom = w_eff + new_w
        do_update = in_band & (denom > 0.0)
        fused = (w_eff * t_old + new_w * tsdf_meas) \
            / torch.where(do_update, denom, 1.0)
        t_out = torch.where(do_update, fused, t_old)
        w_out = torch.where(do_update, torch.clamp(denom, max=max_weight),
                            w_old)
        unseen = w_old == 0.0
        t_out = torch.where(valid & (sdf < -td) & unseen, -1.0, t_out)
        reset = unseen & ((c["in_frame"] & c["in_front"]
                           & (c["depth_val"] <= 0.0)) | ~c["in_front"])
        t_out = torch.where(reset, 0.0, t_out)
        tsdf[zc0:zc1] = t_out      # rounds to nearest even into bf16
        weights[zc0:zc1] = w_out
    return tsdf, weights


def integrate_fg_mask(tsdf: torch.Tensor, weights: torch.Tensor,
                      fg_counts: torch.Tensor, mask: torch.Tensor,
                      occluded_mask: torch.Tensor, rel_rot_oc, rel_trans_oc,
                      intr, voxel_size) -> torch.Tensor:
    """Per-voxel foreground / background evidence from a segmentation
    mask (``kernel_updateFgBgProbs``, ``ObjTSDF.cu:29-107``): a voxel with
    ``|tsdf| < 1`` and weight > 0 that projects in front of the camera to
    a pixel in the frame that is not occluded adds the mask to its fg
    count and its complement to its bg count. ``fg_counts`` (2, Z, Y, X);
    returns the new counts. This runs once per matched object on a mask
    frame, so it stays plain PyTorch (its JAX form has no Pallas kernel).
    """
    Z, Y, X = tsdf.shape
    H, W = mask.shape
    dev = tsdf.device
    vs = scalar(voxel_size, tsdf)
    R = torch.as_tensor(rel_rot_oc, dtype=torch.float32).to(dev)
    t = torch.as_tensor(rel_trans_oc, dtype=torch.float32).to(dev)
    _, _, _, in_front, _, _, in_frame, pix = _project_voxels(
        R, t, _axis(X, vs), _axis(Y, vs), _axis(Z, vs), intr, H, W)
    m = mask.to(torch.float32).reshape(-1)[pix]
    occ = occluded_mask.to(torch.float32).reshape(-1)[pix]
    update = (torch.abs(tsdf) < 1.0) & (weights > 0.0) & in_front \
        & in_frame & (occ == 0.0)
    fg = fg_counts[0] + torch.where(update, m, 0.0)
    bg = fg_counts[1] + torch.where(update, 1.0 - m, 0.0)
    return torch.stack([fg, bg])


# ---- from the port's ops.raycast (frozen copy)


def _safe_dir(d):
    return torch.where(torch.abs(d) < 1e-12,
                       torch.where(d < 0, -1e-12, 1e-12), d)


def _gradient_sample(tsdf: torch.Tensor, vx, vy, vz, valid):
    """Trilinear sample of the forward-difference gradient (3, ...) with
    compute_gradients' zero outer slab, from the 8 corners' differences."""
    Z, Y, X = tsdf.shape
    base, fx, fy, fz = trilinear_cell((Z, Y, X), vx, vy, vz)
    flat = tsdf.reshape(-1)
    xc = base % X
    yc = (base // X) % Y
    zc = base // (X * Y)

    def grad(axis_stride):
        def corner(dz, dy, dx):
            idx = base + ((dz * Y + dy) * X + dx)
            inner = (zc + dz < Z - 1) & (yc + dy < Y - 1) & (xc + dx < X - 1)
            nxt = torch.clamp(idx + axis_stride, max=flat.numel() - 1)
            return torch.where(inner, flat[nxt].to(torch.float32)
                               - flat[idx].to(torch.float32), 0.0)
        return lerp8(corner, fx, fy, fz)

    g = torch.stack([grad(1), grad(X), grad(X * Y)])
    return torch.where(valid[None], g, 0.0)


def _rotate_back(R, a):
    """R^T a for a (3, ...) stack, summed left to right."""
    return torch.stack([R[0, i] * a[0] + R[1, i] * a[1] + R[2, i] * a[2]
                        for i in range(3)])


def raycast_volume_plain(tsdf_vol: torch.Tensor, weights_vol: torch.Tensor,
                         rel_rot_co, rel_trans_co, intr, voxel_size,
                         truncdist, height: int, width: int,
                         max_steps: int = 2048, stats: dict | None = None,
                         rows: torch.Tensor | None = None):
    """Plain PyTorch version of K4; with ``rows`` (int), only those image
    rows, as (len(rows), W) images. ``rel_rot_co``/``rel_trans_co``: the
    camera-to-volume transform. Returns a dict with ``raylengths`` (t*
    where hit, else 0), ``vertices`` and ``normals`` (3, H, W) in camera
    coordinates, and the bool ``mask`` (H, W). ``stats``, if given,
    receives ``steps``: the march steps taken over all rays; per ray,
    ``steps_phase1`` and ``steps_phase2`` (int32 (H, W)); and over all
    phase-2 steps, ``samples`` (TSDF samples taken), ``zero_samples``
    (those whose 8 corners are all exactly 0.0: unobserved voxels) and
    ``weight_samples`` (those where the back-face test needs the weight
    sample: the TSDF went from negative to positive)."""
    Z, Y, X = tsdf_vol.shape
    dev = tsdf_vol.device
    fx, fy, cx, cy = intrinsics(intr)
    vs = scalar(voxel_size, tsdf_vol)
    td = scalar(truncdist, tsdf_vol)
    R = torch.as_tensor(rel_rot_co, dtype=torch.float32).to(dev)
    campos = torch.as_tensor(rel_trans_co, dtype=torch.float32).to(dev)
    res = [float(X), float(Y), float(Z)]

    xs = torch.arange(width, dtype=torch.float32, device=dev)
    if rows is None:
        ys = torch.arange(height, dtype=torch.float32, device=dev)
    else:
        ys = rows.to(device=dev, dtype=torch.float32)
        height = ys.shape[0]
    ux = ((xs[None, :] - cx) / scalar(fx, tsdf_vol)).expand(height, width)
    uy = ((ys[:, None] - cy) / scalar(fy, tsdf_vol)).expand(height, width)
    ray = torch.stack([R[i, 0] * ux + R[i, 1] * uy + R[i, 2] * 1.0
                       for i in range(3)])
    norm = torch.sqrt(ray[0] * ray[0] + ray[1] * ray[1] + ray[2] * ray[2])
    dirs = ray / norm

    d = _safe_dir(dirs)
    t_enter = t_exit = None
    for i in range(3):
        box = (res[i] - 1.0) / 2.0 * vs
        lo = torch.where(d[i] > 0, -box, box)
        hi = torch.where(d[i] > 0, box, -box)
        te = (lo - campos[i]) / d[i]
        tx = (hi - campos[i]) / d[i]
        t_enter = te if t_enter is None else torch.maximum(t_enter, te)
        t_exit = tx if t_exit is None else torch.minimum(t_exit, tx)
    raylength = t_enter + vs
    max_raylength = t_exit - vs
    alive = raylength < max_raylength

    def grid_at(t):
        return [(campos[i] + dirs[i] * t) / vs + (res[i] - 1.0) / 2.0
                for i in range(3)]

    def inside(v, margin):
        vx, vy, vz = v
        return ((vx >= 0.0) & (vx + margin < res[0])
                & (vy >= 0.0) & (vy + margin < res[1])
                & (vz >= 0.0) & (vz + margin < res[2]))

    count = stats is not None
    if count:
        steps1 = torch.zeros(raylength.shape, dtype=torch.int32, device=dev)
        steps2 = torch.zeros_like(steps1)
        n_samples = n_zero = n_weight = 0

    # phase 1: skip ahead at truncdist steps until inside (margin 1)
    for _ in range(max_steps):
        need = alive & ~inside(grid_at(raylength), 1.0) \
            & (raylength < max_raylength)
        if not bool(need.any()):
            break
        raylength = torch.where(need, raylength + td, raylength)
        if count:
            steps1 += need

    v0 = grid_at(raylength)
    cur = trilinear_sample(tsdf_vol, *v0, inside(v0, 1.0))
    raystep = torch.full_like(raylength, float(truncdist))
    raystep = torch.where(torch.abs(cur) < 1.0, vs, raystep)
    raystep = torch.where(torch.abs(cur) < 0.8, 0.5 * vs, raystep)

    # phase 2: adaptive march, over the rays still marching only: each
    # ray's arithmetic is elementwise, so this equals the lock-step march
    # of every ray under its mask, step for step and bit for bit
    hit = torch.zeros_like(alive)
    t_star = torch.zeros_like(raylength)
    rl_f, rs_f = raylength.reshape(-1), raystep.reshape(-1)
    cur_f, mrl_f = cur.reshape(-1), max_raylength.reshape(-1)
    hit_f, ts_f = hit.reshape(-1), t_star.reshape(-1)
    d_f = dirs.reshape(3, -1)
    if count:
        steps2_f = steps2.reshape(-1)
    idx = torch.nonzero(alive.reshape(-1)).squeeze(1)
    steps = 0

    def grid_sub(t, dd):
        return [(campos[i] + dd[i] * t) / vs + (res[i] - 1.0) / 2.0
                for i in range(3)]

    for _ in range(max_steps):
        if idx.numel() == 0:
            break
        steps += idx.numel()
        rs, c, dd = rs_f[idx], cur_f[idx], d_f[:, idx]
        t_new = rl_f[idx] + rs
        in_budget = t_new <= mrl_f[idx]
        v = grid_sub(t_new, dd)
        do_sample = in_budget & inside(v, 2.0)
        nxt = trilinear_sample(tsdf_vol, *v, do_sample)
        w = trilinear_sample(weights_vol, *v, do_sample)
        if count:
            steps2_f[idx] += 1
            n_samples = n_samples + do_sample.sum()
            n_zero = n_zero + (do_sample & _zero_corners(tsdf_vol, *v)).sum()
            n_weight = n_weight + (do_sample & (c < 0) & (nxt > 0)).sum()
        backface = do_sample & (c < 0) & (nxt > 0) & (w > 0)
        step_new = torch.where(do_sample & (torch.abs(nxt) < 1.0), vs, rs)
        step_new = torch.where(do_sample & (torch.abs(nxt) < 0.8),
                               0.5 * vs, step_new)
        step_new = torch.where(backface, rs, step_new)
        crossing = do_sample & ~backface & (c > 0) & (nxt < 0)
        denom = nxt - c
        denom = torch.where(torch.abs(denom) > 1e-30, denom, 1e-30)
        ts = t_new - step_new * c / denom
        vstar = grid_sub(ts, dd)
        vstar_inb = inside(vstar, 2.0)
        wstar = trilinear_sample(weights_vol, *vstar, crossing & vstar_inb)
        hit_now = crossing & vstar_inb & (wstar > 0)
        skip_update = crossing & ~vstar_inb
        cur_f[idx] = torch.where(do_sample & ~backface & ~skip_update, nxt,
                                 c)
        rl_f[idx] = t_new
        rs_f[idx] = step_new
        hit_f[idx] = hit_now
        ts_f[idx] = torch.where(hit_now, ts, ts_f[idx])
        idx = idx[in_budget & ~backface & ~hit_now]
    if count:
        stats.update(steps=steps, steps_phase1=steps1, steps_phase2=steps2,
                     samples=int(n_samples), zero_samples=int(n_zero),
                     weight_samples=int(n_weight))

    vstar = grid_at(t_star)
    grad = _gradient_sample(tsdf_vol, *vstar, hit)
    gnorm = torch.sqrt(grad[0] * grad[0] + grad[1] * grad[1]
                       + grad[2] * grad[2])
    grad = grad / torch.where(gnorm > 0, gnorm, 1.0)
    vertices = _rotate_back(R, dirs * t_star[None])
    normals = _rotate_back(R, grad)
    return {
        "raylengths": torch.where(hit, t_star, 0.0),
        "vertices": torch.where(hit[None], vertices, 0.0),
        "normals": torch.where(hit[None], normals, 0.0),
        "mask": hit,
    }


# ---- from the port's geometry.capture (frozen copy)


def _grid(points_cam, rel_rot, rel_trans, voxel_size, shape):
    """:func:`~emfusion_tpu_torch.geometry.sampling.transform_to_grid`
    over leading slot dimensions (points (..., 3, N)), with the same
    products and sums in the same order."""
    Z, Y, X = shape
    dev = points_cam.device
    R = torch.as_tensor(rel_rot, dtype=torch.float32).to(dev)[..., None]
    t = torch.as_tensor(rel_trans, dtype=torch.float32).to(dev)[..., None]
    vs = torch.as_tensor(voxel_size, dtype=torch.float32).to(dev)[..., None]
    px = points_cam[..., 0, :]
    py = points_cam[..., 1, :]
    pz = points_cam[..., 2, :]
    wx = R[..., 0, 0, :] * px + R[..., 0, 1, :] * py + R[..., 0, 2, :] * pz \
        + t[..., 0, :]
    wy = R[..., 1, 0, :] * px + R[..., 1, 1, :] * py + R[..., 1, 2, :] * pz \
        + t[..., 1, :]
    wz = R[..., 2, 0, :] * px + R[..., 2, 1, :] * py + R[..., 2, 2, :] * pz \
        + t[..., 2, :]
    vx = wx / vs + (X - 1.0) / 2.0
    vy = wy / vs + (Y - 1.0) / 2.0
    vz = wz / vs + (Z - 1.0) / 2.0
    return vx, vy, vz, pz


def _local_coords(anchor, points_cam, rel_rot, rel_trans, voxel_size,
                  shape):
    vx, vy, vz, pz = _grid(points_cam, rel_rot, rel_trans, voxel_size,
                           shape)
    lx = vx - anchor[..., 0, :].to(torch.float32)
    ly = vy - anchor[..., 1, :].to(torch.float32)
    lz = vz - anchor[..., 2, :].to(torch.float32)
    return (vx, vy, vz, pz), (lx, ly, lz)


def _relevant(vx, vy, vz, pz, shape):
    """In front of the camera and within one voxel of the volume."""
    Z, Y, X = shape
    return (pz > 0) & (vx >= -1) & (vy >= -1) & (vz >= -1) \
        & (vx < X) & (vy < Y) & (vz < Z)


def _window_ok(lx, ly, lz):
    """Local coords (incl. the +1-shifted system tents) stay inside the
    cached window; drifted points drop out here."""
    hi = WIN - 2.0
    return ((lx >= 0) & (lx <= hi) & (ly >= 0) & (ly <= hi)
            & (lz >= 0) & (lz <= hi))


def drift_counts(anchor, points_cam, rel_rot, rel_trans, voxel_size,
                 shape):
    """(relevant points that left their windows (``vl`` outside [0, WIN-2]
    on an axis), relevant points), float32, one per slot."""
    (vx, vy, vz, pz), (lx, ly, lz) = _local_coords(
        anchor, points_cam, rel_rot, rel_trans, voxel_size, shape)
    rel = _relevant(vx, vy, vz, pz, shape)
    hi = WIN - 2.0
    bad = (lx < 0) | (lx > hi) | (ly < 0) | (ly > hi) \
        | (lz < 0) | (lz > hi)
    return (torch.sum((rel & bad).to(torch.float32), dim=-1),
            torch.sum(rel.to(torch.float32), dim=-1))


def drift_within(nbad, nrel, tol: float = DRIFT_TOL):
    """The drift test on :func:`drift_counts`' (possibly summed) counts."""
    return nbad <= tol * torch.clamp(nrel, min=1.0)


# ---- from the port's pipeline (frozen copy)


def nearest_object(obj_rcs: List[dict], slots: List[int],
                   active: torch.Tensor, H: int, W: int, dev,
                   n_slots: Optional[int] = None, s0: int = 0) -> dict:
    """The nearest object surface per pixel among the raycasts ``obj_rcs``
    of the pool slots ``slots`` (``pipeline.py:616-650``): ``ray`` (H, W)
    its raylength (``inf`` where no slot hits), ``best`` its slot
    (int64; 0 where none), ``vertices`` and ``normals`` (3, H, W) (0 where
    none) and ``obj_masks`` (n, H, W), the hits of the ``n_slots`` slots
    from ``s0`` on (default: all K). Among equal raylengths the lowest
    slot wins, ``torch.min``'s first index. ``active`` (K,)."""
    K = active.shape[0]
    n = K if n_slots is None else n_slots
    obj_masks = torch.zeros((n, H, W), dtype=torch.bool, device=dev)
    if not slots:
        zeros3 = torch.zeros((3, H, W), dtype=torch.float32, device=dev)
        return dict(ray=torch.full((H, W), torch.inf, device=dev),
                    best=torch.zeros((H, W), dtype=torch.int64, device=dev),
                    vertices=zeros3, normals=zeros3.clone(),
                    obj_masks=obj_masks)
    act = active.to(dev)
    sl = torch.tensor(slots, dtype=torch.long, device=dev)
    hit = torch.stack([r["mask"] for r in obj_rcs]) & act[sl][:, None, None]
    ray = torch.where(hit, torch.stack([r["raylengths"]
                                        for r in obj_rcs]), torch.inf)
    min_ray, best = torch.min(ray, dim=0)
    any_obj = torch.isfinite(min_ray)

    def take_best(key):
        stack = torch.stack([r[key] for r in obj_rcs])        # (n, 3, H, W)
        idx = best[None, None].expand(1, 3, H, W)
        return torch.gather(stack, 0, idx)[0]

    obj_masks[sl - s0] = hit
    return dict(ray=min_ray, best=sl[best],
                vertices=torch.where(any_obj[None], take_best("vertices"),
                                     0.0),
                normals=torch.where(any_obj[None], take_best("normals"),
                                    0.0),
                obj_masks=obj_masks)


def composite_raycasts(bg_rc: dict, obj_rcs: List[dict], slots: List[int],
                       object_id: torch.Tensor, active: torch.Tensor,
                       boundary: int, near: Optional[dict] = None) -> dict:
    """The compositing half of ``EMFusion::raycast`` (``EMFusion.cpp:
    726-795``, ``pipeline.py:616-674``): the nearest object surface per
    pixel among the raycasts ``obj_rcs`` of the pool slots ``slots``
    (:func:`nearest_object`, or ``near`` where given), the background
    where it is more than 5 cm nearer (``:773-776``), the segmentation by
    object id, and per slot its pixel count inside the frame eroded by
    ``boundary``. ``object_id``/``active`` (K,) for all slots. Pixels that
    no object hits have all-``inf`` raylengths; they are gated on
    ``any_obj``, never on ``argmin``'s index."""
    dev = bg_rc["mask"].device
    H, W = bg_rc["mask"].shape
    ids = object_id.to(dev)
    if near is None:
        near = nearest_object(obj_rcs, slots, active, H, W, dev)
    any_obj = torch.isfinite(near["ray"])
    comp_ray = torch.where(any_obj, near["ray"], 0.0)
    comp_verts, comp_norms = near["vertices"], near["normals"]
    obj_masks = near["obj_masks"]
    seg = torch.where(any_obj, ids[near["best"]], 0)

    take_bg = bg_rc["mask"] & any_obj \
        & (comp_ray - bg_rc["raylengths"] > 0.05)
    seg = torch.where(take_bg, 0, seg).to(torch.int32)
    no_obj = seg == 0
    b = boundary
    inner = torch.zeros((H, W), dtype=torch.bool, device=dev)
    inner[b:H - b, b:W - b] = True
    seg_in = torch.where(inner, seg, 0)
    vis_counts = ((seg_in[None] == ids[:, None, None])
                  & (ids[:, None, None] > 0)).sum(dim=(1, 2))
    return {
        "vertices": torch.where(no_obj[None], bg_rc["vertices"], comp_verts),
        "normals": torch.where(no_obj[None], bg_rc["normals"], comp_norms),
        "mask": torch.where(no_obj, bg_rc["mask"], True),
        "seg": seg, "raylengths": comp_ray,
        "bg_raylengths": bg_rc["raylengths"], "obj_masks": obj_masks,
        "vis_counts": vis_counts,
    }
