"""Trilinear volume sampling.

Port of ``emfusion_tpu/geometry/sampling.py``. A point ``p`` in the volume
frame maps to the fractional grid index ``v = p / voxel_size + (res-1)/2``
per axis (X, Y, Z); volumes are (Z, Y, X) or channel-first (C, Z, Y, X),
points component-first (3, N) / (3, H, W).

:func:`sample_volume_at_points` on a single-channel volume wraps kernel
K2 (``csrc/sample.cu``): a CUDA tensor launches the kernel, a CPU tensor
takes :func:`sample_volume_at_points_plain`.

The plain versions divide by tensors on the volume's device rather than
by Python floats: PyTorch turns a division by a Python scalar on the GPU
into a product with its reciprocal, which would round differently from
the kernels' true division.
"""

from __future__ import annotations

import torch

from emfusion_tpu_torch import kernels


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
        return flat[base + ((dz * Y + dy) * X + dx)]

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


def sample_volume_at_points_plain(vol: torch.Tensor,
                                  points_cam: torch.Tensor, rel_rot,
                                  rel_trans, voxel_size,
                                  margin: int = 1) -> torch.Tensor:
    """Plain PyTorch version of K2 (``kernel_getVolumeVals``,
    ``TSDF.cu:662-726``): ``p = R p_cam + t``, ``v = p/voxel + (res-1)/2``;
    the result is exactly 0 where the point is invalid (``z_cam <= 0``) or
    ``v`` lies outside ``[0, res - 1 - margin)`` on any axis.
    ``vol`` (Z, Y, X) or (C, Z, Y, X); returns the points' trailing shape
    (with a leading C for a multi-channel volume)."""
    shape = vol.shape[-3:]
    Z, Y, X = shape
    vx, vy, vz, pz = transform_to_grid(points_cam, rel_rot, rel_trans,
                                       voxel_size, shape)
    valid = (pz > 0) & (vx >= 0.0) & (vy >= 0.0) & (vz >= 0.0)
    valid &= (vx + margin < X) & (vy + margin < Y) & (vz + margin < Z)
    if vol.dim() == 3:
        return trilinear_sample(vol, vx, vy, vz, valid)
    return trilinear_sample_channels(vol, vx, vy, vz, valid)


def sample_volume_at_points(vol: torch.Tensor, points_cam: torch.Tensor,
                            rel_rot, rel_trans, voxel_size,
                            margin: int = 1) -> torch.Tensor:
    """Kernel K2 wrapper (see :func:`sample_volume_at_points_plain`). The
    kernel takes a single-channel float32 volume."""
    if not vol.is_cuda:
        return sample_volume_at_points_plain(vol, points_cam, rel_rot,
                                             rel_trans, voxel_size, margin)
    if vol.dim() != 3 or vol.dtype != torch.float32:
        raise ValueError("sample_volume_at_points: the CUDA kernel takes "
                         "one float32 (Z, Y, X) volume")
    Z, Y, X = vol.shape
    lead = points_cam.shape[1:]
    pts = points_cam.reshape(3, -1).contiguous()
    N = pts.shape[1]
    out = torch.empty(N, dtype=torch.float32, device=vol.device)
    vol = vol.contiguous()
    kernels.check_cuda("sample_volume_at_points", vol, pts, out)
    kernels.launch("sample", vol.data_ptr(), pts.data_ptr(), out.data_ptr(),
                   N, Z, Y, X, *kernels.pose_args(rel_rot, rel_trans),
                   float(voxel_size), int(margin), shape=(Z, Y, X))
    return out.reshape(lead)
