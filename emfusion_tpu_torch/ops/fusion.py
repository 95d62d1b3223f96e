"""Projective TSDF fusion, fg/bg evidence counting, gradient volume.

Port of ``emfusion_tpu/ops/fusion.py`` (``integrate_tsdf``,
``integrate_fg_mask``, ``compute_gradients``).
:func:`integrate_tsdf_batched` wraps kernel K1 (``csrc/fusion.cu``): one
launch fuses a depth frame into the background and every object volume
given as a :class:`FusionItem`. CUDA tensors launch the kernel; CPU
tensors take :func:`integrate_tsdf_plain` per item.
:func:`integrate_tsdf` is the one-volume form.

Unlike the JAX version, both update ``tsdf`` and ``weights`` IN PLACE and
return them: a 512^3 float32 volume is 537 MB, and a second copy of each
would double the fusion's memory and traffic.

A volume pair is float32 or bf16 (the background under
``Params.volume_dtype="bfloat16"``; one launch may mix both). A bf16 pair
is loaded as float32, fused in float32 and rounded once, to nearest even,
where it is stored: what the JAX pipeline's jitted fusion computes on the
CPU before it casts the result back (``pipeline.py:755-757``). The carve
and reset rules read the stored values, and the carve weight cap is
rounded to the storage dtype, as JAX's ``minimum`` of a bf16 volume and a
Python float rounds it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from emfusion_tpu_torch import kernels
from emfusion_tpu_torch.geometry.camera import intrinsics
from emfusion_tpu_torch.geometry.sampling import scalar

# voxels per z-chunk of the plain version (bounds its temporaries)
_PLAIN_CHUNK_VOXELS = 1 << 24
# K1's voxel classes (see voxel_classes)
SKIP, BEHIND, HOLE, NEG, BAND = 0, 1, 2, 3, 4


@dataclasses.dataclass
class FusionItem:
    """One volume of a fusion launch: its (Z, Y, X) ``tsdf`` and
    ``weights`` (updated in place), its (H, W) association image, the
    volume-to-camera rotation and translation, voxel size, truncation
    distance, weight cap and carve rules (see
    :func:`integrate_tsdf_plain`; None switches a rule off). A z-slab of a
    volume (``tsdf`` and ``weights`` its planes ``[z0, z0 + Z_slab)``)
    gives the slab's first global plane ``z0`` and the whole volume's
    depth ``Z`` (None: the tensor's own), so that its voxel centres are
    those of the whole volume: the slab fuses bit for bit as the same
    planes of the whole volume do."""
    tsdf: torch.Tensor
    weights: torch.Tensor
    assoc: torch.Tensor
    rot: torch.Tensor
    trans: torch.Tensor
    voxel_size: float
    truncdist: float
    max_weight: float
    carve_dist: Optional[float] = None
    carve_weight_cap: Optional[float] = None
    carve_margin: Optional[float] = None
    z0: int = 0
    Z: Optional[int] = None

    @property
    def depth_Z(self) -> int:
        """The whole volume's depth, of which this item may be a slab."""
        return self.tsdf.shape[0] if self.Z is None else int(self.Z)


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


def integrate_tsdf_batched(items: Sequence[FusionItem],
                           depth: torch.Tensor, intr) -> None:
    """Kernel K1 wrapper: fuse ``depth`` into every item's volumes in
    place (see :func:`integrate_tsdf_plain`), in one launch
    (:func:`kernels.launch_table`). CPU tensors take the plain version per
    item; CUDA tensors the kernel, which takes contiguous float32 images
    and volume pairs of float32 or bf16 (each item its own) on one
    device, or raises."""
    if not items:
        return
    if not (depth.is_cuda or any(it.tsdf.is_cuda for it in items)):
        for it in items:
            integrate_tsdf_plain(it.tsdf, it.weights, depth, it.assoc,
                                 it.rot, it.trans, intr, it.voxel_size,
                                 it.truncdist, it.max_weight, it.carve_dist,
                                 it.carve_weight_cap, it.carve_margin,
                                 it.z0, it.Z)
        return
    H, W = depth.shape
    dev = kernels.check_cuda("integrate_tsdf", depth)
    fx, fy, cx, cy = intrinsics(intr)
    table = []
    for it in items:
        dt = kernels.volume_dtype_code("integrate_tsdf", it.tsdf,
                                       it.weights)
        kernels.check_cuda("integrate_tsdf", depth, it.tsdf, it.weights,
                           it.assoc, allow_bf16=True)
        if it.assoc.dtype != torch.float32 or depth.dtype != torch.float32:
            raise ValueError("integrate_tsdf: the CUDA kernel takes float32 "
                             "images")
        if it.weights.shape != it.tsdf.shape or it.tsdf.dim() != 3 or \
                tuple(it.assoc.shape) != (H, W):
            raise ValueError("integrate_tsdf: (Z, Y, X) volumes of one "
                             "shape and an (H, W) association image")
        Z, Y, X = it.tsdf.shape
        if not 0 <= it.z0 <= it.depth_Z - Z:
            raise ValueError(f"integrate_tsdf: slab [{it.z0}, {it.z0 + Z}) "
                             f"outside a volume of {it.depth_Z} planes")
        align = 4 * it.tsdf.element_size()     # 4 voxels a lane
        vec = X % 4 == 0 and it.tsdf.data_ptr() % align == 0 \
            and it.weights.data_ptr() % align == 0
        carve, has_cap, cap, has_margin, margin = _carve_flags(
            it.truncdist, it.carve_dist, it.carve_weight_cap,
            it.carve_margin, it.tsdf.dtype)
        table.append(kernels.FuseArgs(
            it.tsdf.data_ptr(), it.weights.data_ptr(), it.assoc.data_ptr(),
            Z, Y, X, it.z0, it.depth_Z, int(vec), dt, kernels.pose_array(it.rot, it.trans),
            float(it.voxel_size),
            float(it.truncdist), float(it.max_weight), carve, int(has_cap),
            int(has_margin), cap, margin))
    kernels.launch_table("fusion", table, depth.data_ptr(), H, W, fx, fy,
                         cx, cy, device=dev)


def integrate_tsdf(tsdf: torch.Tensor, weights: torch.Tensor,
                   depth: torch.Tensor, assoc_weights: torch.Tensor,
                   rel_rot_oc, rel_trans_oc, intr, voxel_size, truncdist,
                   max_weight: float, carve_dist=None,
                   carve_weight_cap=None, carve_margin=None):
    """:func:`integrate_tsdf_batched` of one volume; updates ``tsdf`` and
    ``weights`` in place and returns them."""
    integrate_tsdf_batched([FusionItem(
        tsdf, weights, assoc_weights, rel_rot_oc, rel_trans_oc, voxel_size,
        truncdist, max_weight, carve_dist, carve_weight_cap, carve_margin)],
        depth, intr)
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


def compute_gradients(tsdf: torch.Tensor) -> torch.Tensor:
    """Forward-difference gradient volume, channel-first (3, Z, Y, X) with
    channels (gx, gy, gz) in voxel units; the last slice along each axis
    is zero (``kernel_computeTSDFGrads``, ``TSDF.cu:429-464``). The raycast
    computes these on the fly; this is for tests and exports."""
    Z, Y, X = tsdf.shape
    g = torch.zeros((3, Z, Y, X), dtype=tsdf.dtype, device=tsdf.device)
    inner = tsdf[:-1, :-1, :-1]
    g[0, :-1, :-1, :-1] = tsdf[:-1, :-1, 1:] - inner
    g[1, :-1, :-1, :-1] = tsdf[:-1, 1:, :-1] - inner
    g[2, :-1, :-1, :-1] = tsdf[1:, :-1, :-1] - inner
    return g
