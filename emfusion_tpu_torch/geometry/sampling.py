"""Trilinear volume sampling.

Port of ``emfusion_tpu/geometry/sampling.py``. A point ``p`` in the volume
frame maps to the fractional grid index ``v = p / voxel_size + (res-1)/2``
per axis (X, Y, Z); volumes are (Z, Y, X) or channel-first (C, Z, Y, X),
points component-first (3, N) / (3, H, W).

:func:`sample_items` wraps kernel K2 (``csrc/sample.cu``): one launch
samples the TSDF of the background and of every object slot of an
E-step, each at its own points (a :class:`SampleItem`), and an object's
foreground probability from its fg/bg counts at the same points. CUDA
tensors launch the kernel; CPU tensors take :func:`sample_items_plain`.
:func:`sample_volume_at_points` on a single-channel volume is its
one-item form. :func:`sample_system_at_points` is the exact (gather) LM's
sampler: plain PyTorch on every device, as in the JAX package, where it
is XLA code outside any Pallas kernel.

A TSDF volume may be float32 or bf16 (the background under
``Params.volume_dtype="bfloat16"``): every sampler converts the gathered
corners to float32 before any arithmetic, exactly, as the JAX package's
gathers of a bf16 volume do (``sampling.py:220-227``).

The plain versions divide by tensors on the volume's device rather than
by Python floats: PyTorch turns a division by a Python scalar on the GPU
into a product with its reciprocal, which would round differently from
the kernels' true division.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

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


@dataclasses.dataclass
class SampleItem:
    """One volume of a ψ-sampling launch: its (Z, Y, X) TSDF ``vol``, the
    (3, ...) camera-frame ``points`` to sample it at, the camera-to-volume
    rotation and translation, the voxel size, and for an object its
    (2, Z, Y, X) fg/bg ``counts``."""
    vol: torch.Tensor
    points: torch.Tensor
    rot: torch.Tensor
    trans: torch.Tensor
    voxel_size: float
    counts: Optional[torch.Tensor] = None
    margin: int = 1


Samples = List[Tuple[torch.Tensor, Optional[torch.Tensor]]]


def sample_items_plain(items: Sequence[SampleItem]) -> Samples:
    """Plain PyTorch version of K2: per item, ψ at its points
    (:func:`sample_volume_at_points_plain`) and, where it has counts, the
    foreground probability at the same points
    (:func:`trilinear_fg_probs`, 0 where ψ's point is invalid); each of
    the points' trailing shape."""
    out = []
    for it in items:
        vx, vy, vz, valid = _grid_and_valid(it.points, it.rot, it.trans,
                                            it.voxel_size, it.vol.shape,
                                            it.margin)
        out.append((trilinear_sample(it.vol, vx, vy, vz, valid),
                    None if it.counts is None else
                    trilinear_fg_probs(it.counts, vx, vy, vz, valid)))
    return out


def sample_items(items: Sequence[SampleItem]) -> Samples:
    """Kernel K2 wrapper (see :func:`sample_items_plain`): one launch
    (:func:`kernels.launch_table`) for the items with points, writing
    one packed buffer. The kernel takes contiguous float32 or bf16
    volumes (each item its own), float32 counts, and float32 points whose
    rows are contiguous, on one CUDA device; anything else raises."""
    if not any(it.vol.is_cuda or it.points.is_cuda for it in items):
        return sample_items_plain(items)
    dev = items[0].vol.device
    flat, sizes, codes = [], [], []
    for it in items:
        if it.vol.dim() != 3 or (
                it.counts is not None
                and (it.counts.dtype != torch.float32
                     or it.counts.shape != (2,) + tuple(it.vol.shape))):
            raise ValueError("sample_items: the CUDA kernel takes a (Z, Y, "
                             "X) volume and float32 (2, Z, Y, X) counts")
        codes.append(kernels.volume_dtype_code("sample_items", it.vol))
        pts = it.points.reshape(3, -1)
        if pts.dtype != torch.float32 or pts.stride(1) != 1:
            raise ValueError("sample_items: float32 (3, N) points with "
                             "contiguous rows")
        kernels.check_cuda("sample_items", it.vol, *(
            [] if it.counts is None else [it.counts]), allow_bf16=True,
            device=dev)
        if pts.device != dev:
            raise ValueError("sample_items: all tensors must be on one "
                             "CUDA device")
        flat.append(pts)
        sizes.append(pts.shape[1] * (1 if it.counts is None else 2))
    out = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    results, table, off = [], [], 0
    for it, pts, size, code in zip(items, flat, sizes, codes):
        n = pts.shape[1]
        lead = it.points.shape[1:]
        psi = out[off:off + n]
        fg = out[off + n:off + size] if it.counts is not None else None
        off += size
        results.append((psi.view(lead),
                        None if fg is None else fg.view(lead)))
        if n == 0:
            continue
        Z, Y, X = it.vol.shape
        table.append(kernels.SampleArgs(
            it.vol.data_ptr(),
            0 if it.counts is None else it.counts.data_ptr(),
            pts.data_ptr(), psi.data_ptr(),
            0 if fg is None else fg.data_ptr(), pts.stride(0), n, Z, Y, X,
            code, kernels.pose_array(it.rot, it.trans), float(it.voxel_size),
            float(it.margin)))
    kernels.launch_table("sample", table, device=dev)
    return results


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


def sample_volume_at_points(vol: torch.Tensor, points_cam: torch.Tensor,
                            rel_rot, rel_trans, voxel_size,
                            margin: int = 1) -> torch.Tensor:
    """:func:`sample_volume_at_points_plain` of one volume; on the card
    (one float32 or bf16 (Z, Y, X) volume) a one-item
    :func:`sample_items`."""
    if not vol.is_cuda:
        return sample_volume_at_points_plain(vol, points_cam, rel_rot,
                                             rel_trans, voxel_size, margin)
    return sample_items([SampleItem(vol, points_cam, rel_rot, rel_trans,
                                    voxel_size, margin=margin)])[0][0]
