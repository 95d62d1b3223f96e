"""EM-Fusion pipeline.

Port of ``emfusion_tpu/pipeline.py``'s ``EMFusionPipeline``: the frame step
of ``EMFusion::processFrame`` (``EMFusion.cpp:70-129``) in its order,

    preprocess -> E-step -> camera LM -> E-step -> object LMs -> E-step
    -> raycast composite -> store poses -> (mask frame: match / spawn /
    resize) -> integrate depth -> integrate masks -> cleanup,

where frame 0 only preprocesses, runs the mask step and fuses. (The JAX
package defers a frame's cleanup to the next frame's start, to overlap
its host work with the device; nothing touches the state in between, so
the port runs it at the frame's end, with the same results.)

Objects live in an :class:`ObjectPool` of ``max_objects`` fixed slots:
stacked (K, Z, Y, X) volumes. An E-step samples the background and every
active slot in one K2 launch, and the fusion fuses the background and
every active, visible slot in one K1 launch (as the JAX package maps its
E-step and fusion over the pool). The object LMs run as the resolved
``capture_backend`` asks (:func:`~emfusion_tpu_torch.config.
resolve_params`): one LM per slot over every tracking point, one after
the other, as the JAX package's reference-exact serial path does; or,
under ``band``, one batched LM over every live slot's top
``obj_track_points`` points, with one K3 launch per LM stage for all
slots and the stage's LM iterations on the device, one ``lm_cluster``
launch over the slots' window caches (a thread-block cluster a slot) and
one read a stage (``pipeline.py:513-539``;
:func:`~emfusion_tpu_torch.tracking.track_volumes_batched`). Each slot
runs its own raycast (K4). The
lifecycle (match, spawn, resize, delete) runs on the host at the mask
cadence, as in the reference (``EMFusion.cpp:329-558``).

The camera LM and the serial object LMs run the pipeline's ``sampler``
(``EMF_TRACK_SAMPLER`` or the constructor's argument, as the JAX pipeline
reads it; :func:`~emfusion_tpu_torch.config.resolve_params` resolves
``auto``): the exact gather sampler on every device, or ``capture``, the
JAX package's accelerator sampler. Both samplers' LMs run on the
device (:func:`~emfusion_tpu_torch.tracking.run_lm_items` and
:func:`~emfusion_tpu_torch.tracking.track_volumes_capture`, the JAX
package's ``lax.while_loop``): the camera's as one LM, a frame's serial
object LMs as one table of every slot, read by the host once a table
(the capture sampler's once more for each round of re-captures). The
JAX package's accelerator configuration is run by asking for its knobs:
``tracking_stride=3``, ``estep_scale=2`` (the association weights on the
``[::2, ::2]`` pixel grid, upsampled), ``motion_model="constvel"`` (the
camera LM starts at a constant-velocity prediction from the last two
recorded poses) and ``capture_backend="band"`` (the batched object LM,
and the capture sampler for the camera LM).

With ``save_output`` the frame keeps the images of the export tree in
:attr:`EMFusionPipeline.outputs` (``io.writers.write_results`` writes
them); :meth:`EMFusionPipeline.prefetch_depth` uploads the next frame's
depth ahead, and :meth:`EMFusionPipeline.lm_counts` reports the last
frame's LM iterations, re-captures and dropped points.

The volumes and images live on the compute device and the kernels update
the volumes in place, so :meth:`EMFusionPipeline.process_frame` holds the
pipeline's :attr:`~EMFusionPipeline.lock` for the whole frame: a reader on
another thread (the live viewer) takes it too, and so sees one whole
frame's state, never a half-fused volume; the 4x4 poses, voxel sizes and slot flags live on
the host as float32 / bool tensors, so no step waits for the device to
report a pose. The device is read once per frame for the raycast's
visibility and association counts (:func:`frame_summary`), and on mask
frames for the lifecycle's masks, IoUs and percentiles.

With a ``mesh`` of more than one rank (:mod:`~emfusion_tpu_torch.
distributed.mesh`), the pipeline is one rank of an SPMD program that
gives the one-card frames, poses and volumes: it holds the volumes of its
block of slots and fuses only its z-slab of the background, whose whole
pair it keeps as a read copy, refreshed by an all-gather after each
fusion. Every rank preprocesses, runs the camera LM and the background
raycast and the host lifecycle on replicated inputs; the E-step samples,
object LMs, object raycasts and fusion of a slot run on its owner, whose
results (weight images, poses, raycast partials, percentiles) are
gathered or broadcast over the ``obj`` group in slot order, so every
rank holds the one-card images bit for bit.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from emfusion_tpu_torch import segmentation as seg_mod
from emfusion_tpu_torch.config import Params, resolve_params
from emfusion_tpu_torch.device import resolve_device
from emfusion_tpu_torch.distributed import comm
from emfusion_tpu_torch.distributed.mesh import shard_state
from emfusion_tpu_torch.distributed.sharded_ops import (
    integrate_tsdf_zsharded,
)
from emfusion_tpu_torch.geometry.camera import (
    backproject_depth, preprocess_depth,
)
from emfusion_tpu_torch.geometry.sampling import (
    SampleItem, sample_items, trilinear_sample, trilinear_sample_channels,
)
from emfusion_tpu_torch.geometry.se3 import pose_inverse, reorthonormalize
from emfusion_tpu_torch.ops.association import (
    normalize_associations, weights_from_samples,
)
from emfusion_tpu_torch.ops.fusion import (
    FusionItem, integrate_fg_mask, integrate_tsdf_batched,
)
from emfusion_tpu_torch.ops.raycast import raycast_object, raycast_volume
from emfusion_tpu_torch.ops.render import make_colormap, render_phong
from emfusion_tpu_torch.profiling import PhaseTimer
from emfusion_tpu_torch.tracking import (
    LMItem, TrackConfig, track_volume, track_volumes_batched,
    track_volumes_capture, track_volumes_gather,
)
from emfusion_tpu_torch.viz import visualize_detections
from emfusion_tpu_torch.volume import VOLUME_DTYPES, fg_probs, make_volume

logger = logging.getLogger("emfusion_tpu_torch")


@dataclasses.dataclass
class ObjectPool:
    """K object slots (``pipeline.py:63-76``). Volumes and association
    images on the compute device; poses, voxel sizes and flags on the
    host. (The JAX pool's gradient volumes are not kept: the raycast
    takes normals from TSDF differences.)"""
    tsdf: torch.Tensor        # (K, Z, Y, X)
    weights: torch.Tensor     # (K, Z, Y, X)
    fg_counts: torch.Tensor   # (K, 2, Z, Y, X) foreground / background
    assoc: torch.Tensor       # (K, H, W) association weights
    pose: torch.Tensor        # (K, 4, 4) object-to-world, host
    voxel_size: torch.Tensor  # (K,) host
    truncdist: torch.Tensor   # (K,) host
    active: torch.Tensor      # (K,) bool, host
    visible: torch.Tensor     # (K,) bool, host: this frame's raycast
    object_id: torch.Tensor   # (K,) int32 global ids (0 = none), host


@dataclasses.dataclass
class PipelineState:
    """Volumes and association images on the device, poses on the host
    (float32). The background pair is in the resolved ``volume_dtype``
    (float32 or bf16), everything else float32."""
    bg_tsdf: torch.Tensor      # (Z, Y, X)
    bg_weights: torch.Tensor   # (Z, Y, X)
    bg_pose: torch.Tensor      # (4, 4) volume-to-world, constant
    bg_assoc: torch.Tensor     # (H, W)
    cam_pose: torch.Tensor     # (4, 4) camera-to-world
    objs: Optional[ObjectPool] = None


@dataclasses.dataclass
class ObjectMeta:
    """Host-side per-object bookkeeping (reference ``ObjTSDF`` counters,
    ``ObjTSDF.h:209-210``: both start at 0)."""
    ex_count: int = 0
    nonex_count: int = 0
    class_probs: Optional[np.ndarray] = None
    pose_offsets: Dict[int, np.ndarray] = dataclasses.field(
        default_factory=dict)

    @property
    def ex_prob(self) -> float:
        return self.ex_count / max(self.ex_count + self.nonex_count, 1)


def _translate(t: np.ndarray) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = t
    return m


def empty_pool(K: int, res: int, H: int, W: int, device,
               held: Optional[int] = None) -> ObjectPool:
    """K inactive slots of res^3 volumes (``pipeline.py:227-239``); on a
    rank of a mesh, the volumes of the ``held`` slots it holds only."""
    f32 = torch.float32
    n = K if held is None else held
    return ObjectPool(
        tsdf=torch.zeros((n, res, res, res), dtype=f32, device=device),
        weights=torch.zeros((n, res, res, res), dtype=f32, device=device),
        fg_counts=torch.zeros((n, 2, res, res, res), dtype=f32,
                              device=device),
        assoc=torch.zeros((K, H, W), dtype=f32, device=device),
        pose=torch.eye(4, dtype=f32).repeat(K, 1, 1),
        voxel_size=torch.ones(K, dtype=f32),
        truncdist=torch.ones(K, dtype=f32),
        active=torch.zeros(K, dtype=torch.bool),
        visible=torch.zeros(K, dtype=torch.bool),
        object_id=torch.zeros(K, dtype=torch.int32))


_DEVICE_OBJ_KEYS = ("tsdf", "weights", "fg_counts", "assoc")
_HOST_OBJ_KEYS = {"pose": torch.float32, "voxel_size": torch.float32,
                  "truncdist": torch.float32, "active": torch.bool,
                  "visible": torch.bool, "object_id": torch.int32}


def state_from_numpy(arrays: Dict, device=None,
                     vol_dtype: torch.dtype = torch.float32
                     ) -> PipelineState:
    """Build the port's state from the JAX ``PipelineState`` as numpy:
    ``bg_tsdf``, ``bg_weights``, ``bg_pose``, ``bg_assoc``, ``cam_pose``
    and, optionally, ``objs``: a dict of the JAX ``ObjectPool``'s arrays
    (``tsdf``, ``weights``, ``fg_counts``, ``pose``, ``voxel_size``,
    ``truncdist``, ``active``, ``visible``, ``object_id``, ``assoc``; its
    ``grads`` are not needed). Without ``objs`` the pipeline that loads
    the state gives it an empty pool. The arrays are copied: the kernels
    update the port's volumes in place. The background pair is stored in
    ``vol_dtype``: a JAX bf16 state (or its float32 checkpoint) carries
    across exactly, since bf16 -> float32 -> bf16 is lossless."""
    dev = resolve_device(device)

    def dev_t(a, dtype=torch.float32):
        return torch.tensor(np.asarray(a, np.float32), device=dev).to(dtype)

    def host_t(a, dtype=torch.float32):
        return torch.as_tensor(np.array(a)).to(dtype)

    objs = None
    if arrays.get("objs") is not None:
        o = arrays["objs"]
        objs = ObjectPool(
            **{k: dev_t(o[k]).contiguous() for k in _DEVICE_OBJ_KEYS},
            **{k: host_t(o[k], dt) for k, dt in _HOST_OBJ_KEYS.items()})
    return PipelineState(bg_tsdf=dev_t(arrays["bg_tsdf"], vol_dtype),
                         bg_weights=dev_t(arrays["bg_weights"], vol_dtype),
                         bg_pose=host_t(arrays["bg_pose"]),
                         bg_assoc=dev_t(arrays["bg_assoc"]),
                         cam_pose=host_t(arrays["cam_pose"]), objs=objs)


# ----------------------------------------------------------------------
# device functions of the frame step and the lifecycle
# ----------------------------------------------------------------------
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


def cleanup_stats(obj_masks: torch.Tensor, assoc: torch.Tensor,
                  match_masks: Optional[torch.Tensor] = None):
    """Per slot (``pipeline.py:994-1019``): the pixels of its mask (its
    raycast mask, or'd with its matched segmentation mask where given) and
    the sum of its association weight over them (``EMFusion.cpp:
    936-949``). Returns two (K,) device tensors."""
    m = obj_masks if match_masks is None else obj_masks | match_masks
    return (m.sum(dim=(1, 2)),
            torch.where(m, assoc, 0.0).sum(dim=(1, 2)))


def frame_summary(rc: dict, assoc: torch.Tensor) -> np.ndarray:
    """What the host needs at the end of a frame, in ONE device->host
    copy (``pipeline.py:1029-1039``): [vis_counts (K), association pixel
    counts (K), association weight sums (K)] as float32."""
    cnt, asum = cleanup_stats(rc["obj_masks"], assoc)
    return torch.cat([rc["vis_counts"].to(torch.float32),
                      cnt.to(torch.float32), asum]).cpu().numpy()


def mask_iou_matrix(masks: torch.Tensor, seg: torch.Tensor,
                    ids: torch.Tensor) -> torch.Tensor:
    """(n, K) IoU of every detection mask (n, H, W) against every slot's
    reprojected model mask ``seg == id`` (``pipeline.py:877-890``)."""
    obj = seg[None] == ids.to(seg.device)[:, None, None]       # (K, H, W)
    a = masks[:, None]
    inter = (a & obj[None]).sum(dim=(2, 3))
    union = (a | obj[None]).sum(dim=(2, 3))
    return inter.to(torch.float32) / torch.clamp(union, min=1).to(
        torch.float32)


def masked_percentiles(pts: torch.Tensor, valid: torch.Tensor):
    """Per-axis 10th / 90th percentiles of the valid rows of ``pts``
    (P, 3) (``computePercentiles``, ``EMFusion.cu:77-98``): each axis
    sorted on its own, the entries at ``int(n * 0.1)`` and ``int(n *
    0.9)`` with the products in float32, as ``pipeline.py:895-906``
    (float64 would move the index for some ``n``). Returns (p10, p90, n)
    device tensors; ``inf`` where fewer rows are valid than the index."""
    n = valid.sum()
    big = torch.where(valid[:, None], pts, torch.inf)
    srt = torch.sort(big, dim=0).values
    nf = n.to(torch.float32)
    f32 = torch.float32
    i10 = (nf * torch.tensor(0.1, dtype=f32, device=pts.device)).to(
        torch.int32)
    i90 = (nf * torch.tensor(0.9, dtype=f32, device=pts.device)).to(
        torch.int32)
    last = pts.shape[0] - 1
    return (srt[torch.clamp(i10, 0, last).long()],
            srt[torch.clamp(i90, 0, last).long()], n)


def spawn_percentiles(pts_w: torch.Tensor, valid: torch.Tensor,
                      poses: torch.Tensor) -> np.ndarray:
    """The device math of initNewObjVolume's checks in one host copy
    (``pipeline.py:910-926``): [world p10 (3), p90 (3), n, then per slot
    the object-frame p10 (K x 3) and p90 (K x 3)] of the masked points."""
    p10w, p90w, nv = masked_percentiles(pts_w, valid)
    T = pose_inverse(poses.to(pts_w.device))
    p10o, p90o = [], []
    for k in range(T.shape[0]):
        pts_o = pts_w @ T[k, :3, :3].T + T[k, :3, 3]
        lo, hi, _ = masked_percentiles(pts_o, valid)
        p10o.append(lo)
        p90o.append(hi)
    return torch.cat([p10w, p90w, nv[None].to(torch.float32),
                      torch.stack(p10o).reshape(-1),
                      torch.stack(p90o).reshape(-1)]).cpu().numpy()


def _voxel_centres(shape, voxel_size: torch.Tensor) -> torch.Tensor:
    """(Z*Y*X, 3) object-frame (x, y, z) of every voxel centre."""
    Z, Y, X = shape
    dev = voxel_size.device
    zi, yi, xi = torch.meshgrid(
        *[torch.arange(n, dtype=torch.float32, device=dev)
          for n in (Z, Y, X)], indexing="ij")
    return torch.stack([(xi - (X - 1) / 2) * voxel_size,
                        (yi - (Y - 1) / 2) * voxel_size,
                        (zi - (Z - 1) / 2) * voxel_size], -1).reshape(-1, 3)


def surface_and_new_percentiles(tsdf, weights, fg_counts, voxel_size,
                                new_pts, new_valid):
    """Percentiles over the near-surface foreground voxels and the new
    points, both in the object frame (``pipeline.py:930-951``): the stand-
    in for the reference's mesh-vertex + filtered-point input
    (``EMFusion.cpp:838-855``); the zero-crossing shell ``|tsdf| < 0.1``
    approximates the mesh vertices."""
    near = (weights > 0) & (fg_probs(fg_counts) > 0.5) \
        & (torch.abs(tsdf) < 0.1)
    vox = _voxel_centres(tsdf.shape, voxel_size)
    pts = torch.cat([vox, new_pts], dim=0)
    valid = torch.cat([near.reshape(-1), new_valid], dim=0)
    return masked_percentiles(pts, valid)


def resample_slot(tsdf, weights, fg_counts, old_vs, new_vs, center):
    """Rescale and recentre an object volume in its fixed grid
    (``pipeline.py:955-990``, replacing ``ObjTSDF::resize``'s grow-and-
    copy, ``ObjTSDF.cpp:96-165``): each new voxel samples the old grid
    trilinearly. Stored TSDF values are rescaled by old/new voxel size
    (the truncation distance is not changed by a resize), except where
    ``|t| >= 0.999``, which keeps its sign. ``old_vs``/``new_vs`` are
    float32 scalars, ``center`` the (3,) float32 new centre. Returns
    (tsdf, weights, fg_counts)."""
    Z, Y, X = tsdf.shape
    dev = tsdf.device
    ov = torch.as_tensor(old_vs, dtype=torch.float32).to(dev)
    nv = torch.as_tensor(new_vs, dtype=torch.float32).to(dev)
    c = torch.as_tensor(center, dtype=torch.float32).to(dev)
    p = _voxel_centres((Z, Y, X), nv).reshape(Z, Y, X, 3)
    vx = (p[..., 0] + c[0]) / ov + (X - 1.0) / 2.0
    vy = (p[..., 1] + c[1]) / ov + (Y - 1.0) / 2.0
    vz = (p[..., 2] + c[2]) / ov + (Z - 1.0) / 2.0
    ok = (vx >= 0) & (vy >= 0) & (vz >= 0) \
        & (vx + 1 < X) & (vy + 1 < Y) & (vz + 1 < Z)
    t2 = trilinear_sample(tsdf, vx, vy, vz, ok)
    w2 = trilinear_sample(weights, vx, vy, vz, ok)
    f2 = trilinear_sample_channels(fg_counts, vx, vy, vz, ok)
    ratio = ov / nv
    t2 = torch.where(torch.abs(t2) < 0.999, t2 * ratio, torch.sign(t2))
    return t2, w2, f2


def volume_iou(p10, p90, voxel, obj_res: int, vol_pad: float) -> float:
    """volumeIOU (``EMFusion.cpp:560-612``, ``pipeline.py:1487-1504``):
    the IoU of a new object's padded box, from the percentiles of its
    points in an existing object's frame, with that object's volume."""
    center = (p10 + p90) / 2
    vol_size = vol_pad * float(np.max(p90 - p10))
    low_new = center - vol_size / 2
    high_new = center + vol_size / 2
    half = (obj_res - 1) * voxel / 2
    low, high = -np.full(3, half), np.full(3, half)
    vol_old = float(np.prod(np.full(3, obj_res * voxel)))
    vol_new = vol_size ** 3
    low_i = np.maximum(low_new, low)
    high_i = np.minimum(high_new, high)
    dims = high_i - low_i
    if np.any(dims < 0):
        return 0.0
    vol_int = float(np.prod(dims))
    return vol_int / (vol_new + vol_old - vol_int)


# ----------------------------------------------------------------------
class EMFusionPipeline:
    """Host-facing pipeline (the ``EMFusion`` class equivalent)."""

    def __init__(self, params: Params,
                 mask_provider: Optional[seg_mod.MaskProvider] = None,
                 device=None, sampler: Optional[str] = None,
                 save_output: bool = False, mesh=None):
        """``sampler``: the LM sampler of the camera and the serial object
        LMs; None reads ``EMF_TRACK_SAMPLER``, default ``auto``, as the
        JAX pipeline does (``pipeline.py:147-155``), and
        :func:`~emfusion_tpu_torch.config.resolve_params` resolves it
        with the other knobs. ``save_output`` keeps the per-
        frame images of the export tree in :attr:`outputs` (on rank 0 of
        a mesh). ``mesh``: this rank's
        :class:`~emfusion_tpu_torch.distributed.mesh.Mesh` (its device is
        the pipeline's); one of a single rank is no mesh."""
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        if mesh is not None:
            device = mesh.device
        self.device = resolve_device(device)
        self.params = params
        self.mask_provider = mask_provider
        self.save_output = save_output
        resolved = resolve_params(params, sampler)
        self.vol_dtype = VOLUME_DTYPES[resolved.volume_dtype]
        self.stride = resolved.tracking_stride
        self.escale = resolved.estep_scale
        self.motion_model = resolved.motion_model
        self.object_lm = resolved.object_lm
        self.obj_track_points = resolved.obj_track_points
        self.frame = 0
        self.H, self.W = params.height, params.width
        self.K = params.max_objects
        # the slots whose volumes this rank holds, and its background slab
        self._s0, self._s1 = (0, self.K) if self.mesh is None \
            else self.mesh.slots(self.K)
        Zbg = params.globalVolumeDims[2]
        self._z0, self._z1 = (0, Zbg) if self.mesh is None \
            else self.mesh.slab(Zbg)
        self.obj_res = params.objVolumeDims[0]
        self.intr = torch.as_tensor(params.intr)
        tp = params.tsdfParams
        self.track_cfg = TrackConfig(
            tau=tp.tau, eps1=tp.eps1, eps2=tp.eps2, nu_init=tp.nu_init,
            huber_thresh=tp.huberThresh, max_tsdf_weight=tp.maxTSDFWeight,
            max_iter=params.maxTrackingIter, sampler=resolved.sampler)
        self.sampler = resolved.sampler
        self.voxel = params.globalVoxelSize
        self.trunc = params.global_truncdist
        self.colormap = make_colormap()
        self.state = self._init_state()
        self._next_id = 1
        self.meta: Dict[int, ObjectMeta] = {}
        # the lifecycle's view of visibility (pipeline.py:184-196): the
        # pool's flags as of the previous frame's end, which the mask step
        # reads before this frame's end updates them
        self._h_visible = np.zeros(self.K, bool)
        self._poses: Dict[int, np.ndarray] = {}
        self._obj_poses: Dict[int, Dict[int, np.ndarray]] = {}
        self.timestamps: Dict[int, float] = {}
        self._last_raycast = None
        self._frame_spawned: List[int] = []
        self.last_track_stats = None          # the camera LM's
        self.last_obj_track_stats: Dict[int, dict] = {}   # by object id
        # by object id: the (track, huber) weight images, (H/stride,
        # W/stride), of each object LM's last gradient evaluation
        self.last_obj_track_weights: Dict[int, tuple] = {}
        # the batched object LM's device reads and loop passes
        self.last_batched_lm: Optional[dict] = None
        self.timer = PhaseTimer(self.device)
        # per-frame images of the export tree (pipeline.py:204-211 of the
        # JAX package), host numpy, filled when save_output is set; the
        # caller puts its renderings under "renderings"
        self.outputs: Dict[str, dict] = {
            "bg_assoc_pre": {}, "bg_assoc_post": {},
            "obj_assoc_pre": {}, "obj_assoc_post": {},
            "renderings": {}, "masks": {}, "mask_vis": {},
            "track_weights_bg": {}, "huber_weights_bg": {},
            "obj_track_weights": {}, "obj_huber_weights": {},
            "fg_probs": {},
        }
        # the next frame's raw depth, uploaded ahead (prefetch_depth)
        self._prefetched = None
        # held by process_frame for the whole frame, and by every reader
        # on another thread (viz_server) for its render or extraction
        self.lock = threading.RLock()

    def _init_state(self) -> PipelineState:
        p = self.params
        tsdf, weights = make_volume(p.globalVolumeDims, self.device,
                                    self.vol_dtype)
        return PipelineState(
            bg_tsdf=tsdf, bg_weights=weights,
            bg_pose=torch.as_tensor(p.volume_pose_matrix()),
            bg_assoc=torch.ones((self.H, self.W), dtype=torch.float32,
                                device=self.device),   # EMFusion.cpp:55
            cam_pose=torch.eye(4, dtype=torch.float32),
            objs=empty_pool(self.K, self.obj_res, self.H, self.W,
                            self.device, self._s1 - self._s0))

    def _owns(self, k: int) -> bool:
        """Whether this rank holds slot ``k``'s volumes."""
        return self._s0 <= k < self._s1

    def _lv(self, k: int) -> int:
        """Slot ``k``'s row in this rank's volume tensors."""
        return k - self._s0

    @property
    def is_writer(self) -> bool:
        """Whether this process writes files and prints (rank 0)."""
        return self.mesh is None or self.mesh.rank == 0

    def _gather_slots(self, t: torch.Tensor) -> torch.Tensor:
        """A (K, ...) tensor of per-slot rows, this rank's own rows filled:
        every rank's rows, in place, over the ``obj`` group."""
        if self.mesh is not None:
            comm.all_gather_into(self.mesh.obj, t, t[self._s0:self._s1])
        return t

    def _from_owner(self, k: int, t: torch.Tensor) -> torch.Tensor:
        """``t`` as slot ``k``'s owner computed it, on every rank."""
        if self.mesh is not None:
            comm.broadcast(self.mesh.obj, t, self.mesh.owner(k, self.K))
        return t

    def load_state(self, state: PipelineState, frame: int,
                   meta: Optional[Dict[int, ObjectMeta]] = None,
                   next_id: Optional[int] = None,
                   poses: Optional[Dict[int, np.ndarray]] = None) -> None:
        """Continue from ``state`` as frame ``frame`` (e.g. a state from
        :func:`state_from_numpy`), with the objects' host bookkeeping
        ``meta``, the next object id ``next_id`` (default: one past the
        largest id in the pool) and the camera poses recorded so far,
        ``poses`` (frame -> 4x4; the constant-velocity model reads the
        last two). A state without objects gets an empty pool, and a
        background pair of another dtype is stored in the pipeline's."""
        state.bg_tsdf = state.bg_tsdf.to(self.vol_dtype).contiguous()
        state.bg_weights = state.bg_weights.to(self.vol_dtype).contiguous()
        if state.objs is None:
            state.objs = empty_pool(self.K, self.obj_res, self.H, self.W,
                                    self.device, self._s1 - self._s0)
        elif self.mesh is not None:
            state = shard_state(state, self.mesh, self.K)
        self.state = state
        self.frame = int(frame)
        self._last_raycast = None
        self._h_visible = state.objs.visible.numpy().copy()
        self.meta = dict(meta or {})
        self._next_id = (int(next_id) if next_id is not None
                         else int(self._h_ids.max(initial=0)) + 1)
        if poses is not None:
            self._poses = {int(f): np.array(q, np.float32)
                           for f, q in poses.items()}

    @property
    def _h_active(self) -> np.ndarray:
        """The pool's active flags as a numpy view (host memory: writes
        go to the pool)."""
        return self.state.objs.active.numpy()

    @property
    def _h_ids(self) -> np.ndarray:
        """The pool's object ids as a numpy view."""
        return self.state.objs.object_id.numpy()

    # ------------------------------------------------------------------
    def prefetch_depth(self, depth_raw: np.ndarray) -> None:
        """Start the upload of the next frame's raw depth now, from a
        pinned host buffer with a non-blocking copy, so it overlaps this
        frame's device work (``pipeline.py:1047-1059``). The next
        :meth:`process_frame` takes it when its depth is this array; every
        frame clears the buffer, used or not, so a stale upload is never
        taken for another frame. The CLI calls it right after a frame,
        before that frame's rendering and exports."""
        host = torch.from_numpy(np.ascontiguousarray(depth_raw, np.float32))
        if self.device.type == "cuda":
            host = host.pin_memory()
        self._prefetched = (depth_raw,
                            host.to(self.device, non_blocking=True), host)

    def _upload_depth(self, depth_raw) -> torch.Tensor:
        pf, self._prefetched = self._prefetched, None
        if pf is not None and pf[0] is depth_raw:
            return pf[1]
        return torch.as_tensor(np.asarray(depth_raw, np.float32)).to(
            self.device)

    def preprocess(self, depth_raw):
        """Bilateral filter + patching, then the point map
        (``pipeline.py:817-831``)."""
        p = self.params
        raw = self._upload_depth(depth_raw)
        depth = preprocess_depth(raw, p.bilateral_kernel_size,
                                 p.bilateral_sigma_depth,
                                 p.bilateral_sigma_spatial)
        return depth, backproject_depth(depth, self.intr)

    def _rel_bg(self, cam_pose=None) -> torch.Tensor:
        """Camera-to-volume transform (of the state's camera, or of the
        camera-to-world ``cam_pose``)."""
        cam = self.state.cam_pose if cam_pose is None else cam_pose
        return pose_inverse(self.state.bg_pose) @ cam

    def _rel_obj(self, k: int, cam_pose=None) -> torch.Tensor:
        """Camera-to-object transform of slot ``k``."""
        cam = self.state.cam_pose if cam_pose is None else cam_pose
        return pose_inverse(self.state.objs.pose[k]) @ cam

    def estep(self, points: torch.Tensor, slots: List[int],
              fg_out: bool = False) -> Optional[Dict[int, torch.Tensor]]:
        """computeAssociationWeights (``EMFusion.cpp:635-670``,
        ``pipeline.py:276-380``) for the background and the object slots
        ``slots`` (the others keep weight 0): the normalised association
        images. One K2 launch samples every model. With ``estep_scale`` s
        > 1 the weights are computed and normalised on the ``[::s, ::s]``
        pixel grid, then each is repeated s x s times and cropped to
        (H, W). With ``fg_out``, also returns per slot its sampled
        foreground probability as an (H, W) image (0 at the points it did
        not evaluate), the JAX E-step's ``fg_out``. On a mesh each rank
        samples its own slots, and their images are gathered."""
        tp = self.params.tsdfParams
        s, o = self.state, self.state.objs
        own = [k for k in slots if self._owns(k)]
        items, culls = self.estep_items(points, own)
        grid = tuple(items[0].points.shape[1:])
        samples = sample_items(items)
        bg_w = weights_from_samples(samples[0][0], self.trunc,
                                    tp.assocSigma, tp.alpha, tp.uniPrior)
        # per slot its weight image (and its fg image), gathered at once
        per_slot = torch.zeros((self.K, 1 + fg_out) + grid,
                               dtype=torch.float32, device=self.device)
        for k, (psi, fg), cull in zip(own, samples[1:], culls):
            per_slot[k, 0] = self._object_weights(k, psi, fg, cull, grid)
            if fg_out:
                per_slot[k, 1] = self._uncull(fg, cull, grid)
        self._gather_slots(per_slot)
        obj_w = per_slot[:, 0]
        fg_imgs = {k: self._upsample(per_slot[k, 1]) for k in slots} \
            if fg_out else {}
        bg_n, obj_n = normalize_associations(bg_w, obj_w,
                                             o.active.to(self.device))
        s.bg_assoc, o.assoc = self._upsample(bg_n), self._upsample(obj_n)
        return fg_imgs if fg_out else None

    def _upsample(self, img: torch.Tensor) -> torch.Tensor:
        """An E-step image of the ``[::s, ::s]`` grid at (H, W): each value
        repeated s x s times, cropped (``pipeline.py:369-372``)."""
        e = self.escale
        if e == 1:
            return img
        img = img.repeat_interleave(e, dim=-2).repeat_interleave(e, dim=-1)
        return img[..., :self.H, :self.W].contiguous()

    def estep_items(self, points: torch.Tensor, slots: List[int]):
        """The E-step's K2 work table: the background's TSDF at the point
        of every pixel of the E-step's grid (every ``estep_scale``-th
        pixel of ``points``' rows and columns), then per slot of
        ``slots`` its :meth:`_object_item` on that grid; and per slot its
        culling."""
        e = self.escale
        if e > 1:
            points = points[:, ::e, ::e].contiguous()
        rel = self._rel_bg()
        items = [SampleItem(self.state.bg_tsdf, points, rel[:3, :3],
                            rel[:3, 3], self.voxel)]
        culls = []
        for k in slots:
            item, cull = self._object_item(k, points)
            items.append(item)
            culls.append(cull)
        return items, culls

    def _object_item(self, k: int, points: torch.Tensor):
        """Slot ``k``'s E-step sample: its TSDF and fg/bg counts at the
        points it evaluates, and the culling (None, or the flat indices
        and inside flags of :meth:`culled_points`). With
        ``estep_obj_subset`` = M below the pixel count, only the M points
        nearest the volume's centre among those inside its box are
        evaluated (``pipeline.py:326-355``)."""
        o = self.state.objs
        rel = self._rel_obj(k)
        pts, cull = points, None
        if 0 < self.params.estep_obj_subset < points[0].numel():
            ptsf, idx, inside = self.culled_points(k, points)
            pts, cull = ptsf[:, idx], (idx, inside)
        lk = self._lv(k)
        return SampleItem(o.tsdf[lk], pts, rel[:3, :3], rel[:3, 3],
                          float(o.voxel_size[k]),
                          counts=o.fg_counts[lk]), cull

    def _object_weights(self, k: int, psi: torch.Tensor, fg: torch.Tensor,
                        cull, grid) -> torch.Tensor:
        """Slot ``k``'s unnormalised association image on the E-step's
        ``grid`` (rows, columns) from its samples (:meth:`_object_item`).
        Under culling, the points outside the box (which sample the
        reference's 0 sentinel) and the overflow of a footprint larger
        than the budget get weight 0."""
        tp = self.params.tsdfParams
        w_s = weights_from_samples(psi, float(self.state.objs.truncdist[k]),
                                   tp.assocSigma, tp.alpha, tp.uniPrior,
                                   fg)
        return self._uncull(w_s, cull, grid)

    @staticmethod
    def _uncull(vals: torch.Tensor, cull, grid) -> torch.Tensor:
        """Values at a slot's evaluated points as an image of ``grid``:
        as they are without culling; else 0 except at the culled points
        inside the box."""
        if cull is None:
            return vals
        idx, inside = cull
        out = torch.zeros(grid[0] * grid[1], dtype=torch.float32,
                          device=vals.device)
        out[idx] = torch.where(inside[idx], vals, 0.0)
        return out.reshape(grid)

    def culled_points(self, k: int, points: torch.Tensor):
        """The object E-step's point budget for slot ``k``: the flat
        points (3, P), the indices of the ``estep_obj_subset`` points with
        the highest score (minus the squared distance to the volume's
        centre inside its box, -inf outside), and the inside flags (P,)."""
        rel = self._rel_obj(k)
        vs = float(self.state.objs.voxel_size[k])
        ptsf = points.reshape(3, -1)
        po = rel[:3, :3].to(ptsf.device) @ ptsf \
            + rel[:3, 3].to(ptsf.device)[:, None]
        half = float(np.float32((self.obj_res - 1) / 2.0) * np.float32(vs))
        inside = torch.all(torch.abs(po) <= half, dim=0) & (ptsf[2] > 0)
        score = torch.where(inside, -torch.sum(po * po, dim=0), -torch.inf)
        # jax.lax.top_k keeps the lower index among equal scores; a stable
        # descending sort does the same
        idx = torch.sort(score, descending=True, stable=True).indices[
            :self.params.estep_obj_subset]
        return ptsf, idx, inside

    def _track_points(self, points: torch.Tensor, assoc: torch.Tensor):
        k = self.stride
        return (points[:, ::k, ::k].reshape(3, -1),
                assoc[::k, ::k].reshape(-1))

    def motion_delta(self) -> Optional[torch.Tensor]:
        """The constant-velocity model's predicted motion (``pipeline.py:
        1243-1254``): ``P[-2]^-1 P[-1]`` of the last two recorded camera
        poses, or None under the static model or with fewer than two."""
        if self.motion_model != "constvel" or len(self._poses) < 2:
            return None
        f1, f2 = sorted(self._poses)[-2:]
        return torch.from_numpy(
            np.linalg.inv(self._poses[f1]) @ self._poses[f2])

    def track_camera(self, points: torch.Tensor) -> None:
        """Camera-vs-background LM (performTracking, first half), started
        at the previous pose (``EMFusion.cpp:675``) or, under the
        constant-velocity model, started and captured at ``cam_pose @
        delta`` (:meth:`motion_delta`, ``pipeline.py:430-459``)."""
        s = self.state
        it = self.camera_lm_item(points)
        rel, stats = track_volume(it.tsdf, it.weights, it.voxel_size,
                                  it.points, it.assoc, it.rel_pose,
                                  self.track_cfg)
        s.cam_pose = s.bg_pose @ rel
        self.last_track_stats = stats

    def camera_lm_item(self, points: torch.Tensor) -> LMItem:
        """The camera LM (:meth:`track_camera`): the background volumes,
        the tracking points with the background's association image, and
        the re-orthonormalised camera-to-volume start."""
        s = self.state
        pts, asc = self._track_points(points, s.bg_assoc)
        delta = self.motion_delta()
        pred = s.cam_pose if delta is None else s.cam_pose @ delta
        return LMItem(s.bg_tsdf, s.bg_weights, self.voxel, pts, asc,
                      reorthonormalize(pose_inverse(s.bg_pose) @ pred))

    def track_objects(self, points: torch.Tensor, slots: List[int]) -> None:
        """Object LMs (``EMFusion.cpp:692-720``), each started at the
        slot's camera-to-object transform, then ``pose = cam_pose rel^-1``
        (``ObjTSDF::syncTrack``). Serially (``pipeline.py:494-551``): each
        slot's LM over all tracking points with the slot's association
        image, as one device-resident table of every slot (the gather
        sampler's :func:`~emfusion_tpu_torch.tracking.track_volumes_gather`,
        the capture sampler's :func:`~emfusion_tpu_torch.tracking.
        track_volumes_capture`; the JAX pipeline's ``lax.scan``; each
        slot's LM is the one it would run alone); or batched
        (:meth:`_track_objects_batched`). On a mesh each rank tracks its
        own slots (:meth:`_gather_tracks` shares the results)."""
        s, o = self.state, self.state.objs
        self.last_obj_track_stats = {}
        self.last_obj_track_weights = {}
        self.last_batched_lm = None
        own = [k for k in slots if self._owns(k)]
        if self.object_lm == "batched":
            if own:
                self._track_objects_batched(points, own)
        else:
            grid = self._track_grid()
            items = self.object_lm_items(points, own)
            cfg = self.track_cfg
            results = (track_volumes_gather if cfg.sampler == "gather"
                       else track_volumes_capture)(items, cfg)
            for k, (rel, stats) in zip(own, results):
                o.pose[k] = s.cam_pose @ pose_inverse(rel)
                oid = int(o.object_id[k])
                # the weight images go apart; the capture sampler's
                # dropped points stay on the device until lm_counts()
                self.last_obj_track_stats[oid] = {
                    key: v for key, v in stats.items()
                    if key not in ("track_weights", "huber_weights")}
                self.last_obj_track_weights[oid] = (
                    stats["track_weights"].reshape(grid),
                    stats["huber_weights"].reshape(grid))
        if self.mesh is not None:
            self._gather_tracks(slots)

    def object_lm_items(self, points: torch.Tensor, slots: List[int]):
        """The serial object LMs of ``slots`` (slots this rank holds): per
        slot its volumes and voxel size, the tracking points with its
        association image, and its re-orthonormalised camera-to-object
        start, as :class:`~emfusion_tpu_torch.tracking.LMItem` s."""
        o = self.state.objs
        items = []
        for k in slots:
            lk = self._lv(k)
            pts, asc = self._track_points(points, o.assoc[k])
            items.append(LMItem(o.tsdf[lk], o.weights[lk],
                                float(o.voxel_size[k]), pts, asc,
                                reorthonormalize(self._rel_obj(k))))
        return items

    _STAT_KEYS = ("iterations", "converged", "recaptures", "dropped_points")

    def _gather_tracks(self, slots: List[int]) -> None:
        """The object LMs' results of every rank on every rank: the poses
        and LM counts of the slots, and (with ``save_output``) their weight
        images, each slot's from its owner."""
        o = self.state.objs
        self._gather_slots(o.pose)
        st = torch.zeros((self.K, len(self._STAT_KEYS)), dtype=torch.float64)
        for k in slots:
            mine = self.last_obj_track_stats.get(int(o.object_id[k]))
            if self._owns(k) and mine is not None:
                st[k] = torch.tensor([float(mine[key])
                                      for key in self._STAT_KEYS])
        self._gather_slots(st)
        for k in slots:
            self.last_obj_track_stats[int(o.object_id[k])] = {
                key: (bool(v) if key == "converged" else int(v))
                for key, v in zip(self._STAT_KEYS, st[k].tolist())}
        if not self.save_output:
            return
        imgs = torch.zeros((self.K, 2) + self._track_grid(),
                           dtype=torch.float32, device=self.device)
        for k in slots:
            w = self.last_obj_track_weights.get(int(o.object_id[k]))
            if self._owns(k) and w is not None:
                imgs[k, 0], imgs[k, 1] = w
        self._gather_slots(imgs)
        self.last_obj_track_weights = {
            int(o.object_id[k]): (imgs[k, 0], imgs[k, 1]) for k in slots}

    def _track_grid(self):
        """(rows, columns) of the tracking points' stride grid."""
        k = self.stride
        return (-(-self.H // k), -(-self.W // k))

    def _track_objects_batched(self, points: torch.Tensor,
                               slots: List[int]) -> None:
        """The batched object LM (``pipeline.py:513-539``): all slots of
        ``slots`` in one :func:`~emfusion_tpu_torch.tracking.
        track_volumes_batched` over their :meth:`batched_lm_inputs`; the
        weights come back scattered into zero images of the stride
        grid."""
        s, o = self.state, self.state.objs
        tsdfs, wts, vs, pts, asc, rel_init, idx, asc_all = \
            self.batched_lm_inputs(points, slots)
        rel, st = track_volumes_batched(
            tsdfs, wts, vs, pts, asc, rel_init, self.track_cfg,
            torch.ones(len(slots), dtype=torch.bool))
        grid = self._track_grid()
        imgs = [torch.zeros_like(asc_all).scatter_(1, idx, st[key])
                for key in ("track_weights", "huber_weights")]
        for i, j in enumerate(slots):
            o.pose[j] = s.cam_pose @ pose_inverse(rel[i])
            oid = int(o.object_id[j])
            self.last_obj_track_stats[oid] = {
                key: st[key][i].item() for key in (
                    "iterations", "converged", "recaptures")}
            # left on the device: lm_counts() reads it when asked
            self.last_obj_track_stats[oid]["dropped_points"] = \
                st["dropped_points"][i]
            self.last_obj_track_weights[oid] = (imgs[0][i].reshape(grid),
                                                imgs[1][i].reshape(grid))
        self.last_batched_lm = dict(
            slots=len(slots), points=pts.shape[2],
            host_reads=st["host_reads"],
            loop_iterations=st["loop_iterations"])

    def batched_lm_inputs(self, points: torch.Tensor, slots: List[int]):
        """What the batched object LM tracks: the slots' volumes and voxel
        sizes; per slot the ``obj_track_points`` tracking points (of the
        stride grid) with the highest association, by a stable descending
        sort (``top_k``'s lower index among equal weights), as (S, 3, M)
        points, (S, M) weights and their (S, M) indices; the re-
        orthonormalised ``pose^-1 cam_pose`` starts (S, 4, 4, host); and
        the (S, stride-grid size) association of every tracking point."""
        s, o = self.state, self.state.objs
        k = self.stride
        pts_full = points[:, ::k, ::k].reshape(3, -1)
        n_full = pts_full.shape[1]
        M = min(self.obj_track_points or n_full, n_full)
        sl = torch.tensor(slots, dtype=torch.long, device=self.device)
        asc_all = o.assoc[sl][:, ::k, ::k].reshape(len(slots), -1)
        idx = torch.sort(asc_all, dim=1, descending=True,
                         stable=True).indices[:, :M]
        pts = pts_full[:, idx].permute(1, 0, 2).contiguous()   # (S, 3, M)
        rel_init = reorthonormalize(pose_inverse(o.pose[slots])
                                    @ s.cam_pose)
        return ([o.tsdf[self._lv(j)] for j in slots],
                [o.weights[self._lv(j)] for j in slots],
                o.voxel_size[slots], pts, torch.gather(asc_all, 1, idx),
                rel_init, idx, asc_all)

    def raycast(self, slots: List[int], cam_pose=None) -> dict:
        """``EMFusion::raycast`` (``EMFusion.cpp:726-795``): the background
        and each slot of ``slots`` (its weights masked to its foreground),
        composited (:func:`composite_raycasts`), from the state's camera
        or from the camera-to-world ``cam_pose`` (a host (4, 4) float32
        tensor: the viewers' virtual cameras). On a mesh every rank casts
        the background from its read copy and its own slots; the nearest
        object surface of each rank is gathered and combined in rank
        order (:meth:`_gather_nearest`), the composite then computed on
        every rank."""
        p = self.params
        s, o = self.state, self.state.objs
        rel = self._rel_bg(cam_pose)
        bg_rc = raycast_volume(s.bg_tsdf, s.bg_weights, rel[:3, :3],
                               rel[:3, 3], self.intr, self.voxel, self.trunc,
                               self.H, self.W,
                               max_steps=p.raycast_max_steps)
        own = [k for k in slots if self._owns(k)]
        obj_rcs = []
        for k in own:
            rk = self._rel_obj(k, cam_pose)
            lk = self._lv(k)
            obj_rcs.append(raycast_object(
                o.tsdf[lk], o.weights[lk], o.fg_counts[lk], rk[:3, :3],
                rk[:3, 3], self.intr, float(o.voxel_size[k]),
                float(o.truncdist[k]), self.H, self.W, p.raycast_max_steps))
        near = None
        if self.mesh is not None:
            near = self._gather_nearest(nearest_object(
                obj_rcs, own, o.active, self.H, self.W, self.device,
                self._s1 - self._s0, self._s0))
        return composite_raycasts(bg_rc, obj_rcs, slots, o.object_id,
                                  o.active, p.boundary, near)

    def _gather_nearest(self, mine: dict) -> dict:
        """The nearest object surface over every rank's slots from each
        rank's over its own (:func:`nearest_object`): the ranks' partials
        gathered over ``obj`` and the nearest taken, the lowest rank (so
        the lowest slot) among equal raylengths, as the one-card
        ``torch.min`` over all slots takes it; the hit masks of every
        slot gathered in slot order."""
        n = self.mesh.shape[0]
        H, W = self.H, self.W
        part = torch.cat([mine["ray"][None], mine["best"][None].to(
            torch.float32), mine["vertices"], mine["normals"]])  # (8, H, W)
        allp = torch.empty((n,) + tuple(part.shape), dtype=torch.float32,
                           device=self.device)
        comm.all_gather_into(self.mesh.obj, allp, part[None])
        ray, r = torch.min(allp[:, 0], dim=0)
        pick = torch.gather(allp, 0, r[None, None].expand(1, 8, H, W))[0]
        masks = torch.empty((self.K, H, W), dtype=torch.bool,
                            device=self.device)
        comm.all_gather_into(self.mesh.obj, masks, mine["obj_masks"])
        return dict(ray=ray, best=pick[1].to(torch.int64),
                    vertices=pick[2:5], normals=pick[5:8], obj_masks=masks)

    def integrate(self, depth: torch.Tensor) -> None:
        """integrateDepth (``EMFusion.cpp:865-889``): the background, with
        its carve rules (``Params.bg_carve_*``), and each active object
        the raycast saw (``pipeline.py:774-792``), in place, in one K1
        launch (:meth:`fusion_items`). On a mesh the rank fuses its
        background slab and its slots (``distributed.sharded_ops.
        integrate_tsdf_zsharded``), then its ``z`` group all-gathers the
        slabs into every rank's read copy, in place."""
        if self.mesh is None:
            integrate_tsdf_batched(self.fusion_items(), depth, self.intr)
            return
        integrate_tsdf_zsharded(self.fusion_items(), depth, self.intr)
        s, (z0, z1) = self.state, (self._z0, self._z1)
        for vol in (s.bg_tsdf, s.bg_weights):
            comm.all_gather_into(self.mesh.z, vol, vol[z0:z1])

    def fusion_items(self) -> List[FusionItem]:
        """The fusion's K1 work table: the background (this rank's slab of
        it on a mesh), then each active object the raycast saw (of this
        rank's slots). Another slot is not in it, so its volume is
        untouched."""
        s, o = self.state, self.state.objs
        max_w = self.params.tsdfParams.maxTSDFWeight
        cam_inv = pose_inverse(s.cam_pose)
        rel_oc = cam_inv @ s.bg_pose
        z0, z1 = self._z0, self._z1
        items = [FusionItem(s.bg_tsdf[z0:z1], s.bg_weights[z0:z1],
                            s.bg_assoc, rel_oc[:3, :3], rel_oc[:3, 3],
                            self.voxel, self.trunc, max_w,
                            *self.carve_args(), z0=z0,
                            Z=s.bg_tsdf.shape[0])]
        for k in np.nonzero((o.active & o.visible).numpy())[0]:
            if not self._owns(k):
                continue
            rk = cam_inv @ o.pose[k]
            lk = self._lv(k)
            items.append(FusionItem(o.tsdf[lk], o.weights[lk], o.assoc[k],
                                    rk[:3, :3], rk[:3, 3],
                                    float(o.voxel_size[k]),
                                    float(o.truncdist[k]), max_w))
        return items

    def carve_args(self):
        """(carve_dist, carve_weight_cap, carve_margin) of the background
        fusion from ``Params.bg_carve_*`` (``pipeline.py:724-734``); None
        switches a rule off."""
        p = self.params
        carve = (min(p.bg_carve_dist, self.trunc)
                 if p.bg_carve_dist > 0 else None)
        cap = (p.bg_carve_weight_cap
               if carve is not None
               and p.bg_carve_weight_cap < p.tsdfParams.maxTSDFWeight
               else None)
        margin = (p.bg_carve_margin
                  if cap is not None and p.bg_carve_margin > -2.0 else None)
        return carve, cap, margin

    def integrate_masks(self, matches: Dict[int, np.ndarray],
                        rc: Optional[dict]) -> None:
        """integrateMasks (``EMFusion.cpp:891-906``,
        ``pipeline.py:1574-1597``): each matched active object counts its
        segmentation mask as fg/bg evidence, except where another model
        occludes its own raycast mask. On a mesh, by each slot's owner."""
        s, o = self.state, self.state.objs
        for k in range(self.K):
            oid = int(self._h_ids[k])
            if not self._h_active[k] or oid not in matches \
                    or not self._owns(k):
                continue
            mask = torch.as_tensor(matches[oid]).to(self.device)
            if rc is None:
                occl = torch.zeros_like(mask)
            else:
                occl = rc["obj_masks"][k] & (rc["seg"] != oid)
            rk = pose_inverse(s.cam_pose) @ o.pose[k]
            lk = self._lv(k)
            o.fg_counts[lk] = integrate_fg_mask(
                o.tsdf[lk], o.weights[lk], o.fg_counts[lk], mask, occl,
                rk[:3, :3], rk[:3, 3], self.intr, float(o.voxel_size[k]))

    # ------------------------------------------------------------------
    def process_frame(self, rgb: Optional[np.ndarray], depth_raw,
                      timestamp: Optional[float] = None) -> None:
        """One frame of ``EMFusion::processFrame`` (``pipeline.py:
        1061-1199``), under :attr:`lock`. ``rgb`` is only read by the mask
        provider."""
        with self.lock:
            self._process_frame(rgb, depth_raw, timestamp)

    def _process_frame(self, rgb, depth_raw, timestamp) -> None:
        p = self.params
        if timestamp is not None:
            self.timestamps[self.frame] = float(timestamp)
        timer = self.timer
        with timer.phase("preprocess"):
            depth, points = self.preprocess(depth_raw)
        rc = summary = None
        self._frame_spawned = []
        if self.frame > 0:
            slots = [int(k) for k in np.nonzero(self._h_active)[0]]
            with timer.phase("estep_pre"):
                self.estep(points, slots)
            pre = (self.state.bg_assoc, self.state.objs.assoc)
            with timer.phase("track_camera"):
                self.track_camera(points)
            with timer.phase("estep_mid"):
                self.estep(points, slots)        # EMFusion.cpp:687
            if slots:
                with timer.phase("track_objects"):
                    self.track_objects(points, slots)
            with timer.phase("estep_post"):
                fg_imgs = self.estep(points, slots,      # post-track, :87
                                     fg_out=self.save_output)
            with timer.phase("raycast"):
                rc = self.raycast(slots)
            if self.save_output:
                self._save_frame_outputs(pre, fg_imgs)
            with timer.phase("summary"):
                summary = frame_summary(rc, self.state.objs.assoc)
            o = self.state.objs
            o.visible = o.active & torch.from_numpy(
                summary[:self.K] > p.visibilityThresh)
            self._last_raycast = rc

        matches: Dict[int, np.ndarray] = {}
        num_instances = -1
        mask_frame = self.frame % p.maskRCNNFrames == 0
        if mask_frame:
            # poses are recorded BEFORE updateObj applies resize offsets
            # (EMFusion.cpp:96, before initOrMatchObjs)
            with timer.phase("store_poses"):
                self._apply_store_poses()
            with timer.phase("masks"):
                num_instances = self._init_or_match_objs(rgb, points, rc,
                                                         matches)
        with timer.phase("integrate"):
            self.integrate(depth)
        if num_instances > 0:
            with timer.phase("integrate_masks"):
                self.integrate_masks(matches, rc)
        self._end_frame(summary, rc, mask_frame, num_instances, matches)
        self.frame += 1

    def _save_frame_outputs(self, pre, fg_imgs) -> None:
        """The tracked part of a frame's export images, as host numpy
        (``pipeline.py:1098-1150``): the association images before the
        camera LM and after the last E-step, the LMs' track and Huber
        weights on the stride grid, and the objects' sampled foreground
        probabilities, each object's keyed by its id (rank 0 of a mesh
        keeps them)."""
        if not self.is_writer:
            return
        out, f = self.outputs, self.frame
        o = self.state.objs
        live = [int(k) for k in np.nonzero(self._h_active)[0]]
        ids = {k: int(self._h_ids[k]) for k in live}
        st = self.last_track_stats
        grid = self._track_grid()
        out["track_weights_bg"][f] = st["track_weights"].reshape(
            grid).cpu().numpy()
        out["huber_weights_bg"][f] = st["huber_weights"].reshape(
            grid).cpu().numpy()
        if self.last_obj_track_weights:
            out["obj_track_weights"][f] = {
                oid: tw.cpu().numpy()
                for oid, (tw, _) in self.last_obj_track_weights.items()}
            out["obj_huber_weights"][f] = {
                oid: hw.cpu().numpy()
                for oid, (_, hw) in self.last_obj_track_weights.items()}
        if fg_imgs:
            out["fg_probs"][f] = {ids[k]: img.cpu().numpy()
                                  for k, img in fg_imgs.items()}
        pre_bg, pre_obj = pre
        out["bg_assoc_pre"][f] = pre_bg.cpu().numpy()
        out["bg_assoc_post"][f] = self.state.bg_assoc.cpu().numpy()
        pre_o, post_o = pre_obj.cpu().numpy(), o.assoc.cpu().numpy()
        out["obj_assoc_pre"][f] = {ids[k]: pre_o[k] for k in live}
        out["obj_assoc_post"][f] = {ids[k]: post_o[k] for k in live}

    def flush(self) -> None:
        """Nothing to wait for: the port ends each frame inside
        :meth:`process_frame`. Kept so callers of the JAX pipeline's
        ``flush()`` (before reading poses, state or meshes) run
        unchanged."""

    def lm_counts(self) -> dict:
        """The last frame's LM counts as host numbers: ``camera`` and, per
        tracked object id, ``objects``, each with ``iterations``,
        ``recaptures`` and ``dropped_points`` (0 under the gather
        sampler)."""
        keys = ("iterations", "recaptures", "dropped_points")

        def host(st):
            return {k: None if st.get(k) is None else int(st[k])
                    for k in keys}
        return {"camera": host(self.last_track_stats or {}),
                "objects": {oid: host(v) for oid, v
                            in self.last_obj_track_stats.items()}}

    def _end_frame(self, summary, rc, mask_frame, num_instances,
                   matches) -> None:
        """The frame's end (``pipeline.py:1202-1234``): the lifecycle's
        visibility mirror, pose recording (storePoses, ``EMFusion.cpp:96``;
        a mask frame recorded them before its lifecycle step) and object
        cleanup (cleanUpObjs ends processFrame, ``EMFusion.cpp:922-980``)."""
        cnt = asum = None
        if summary is not None:
            K = self.K
            vis, cnt, asum = summary[:K], summary[K:2 * K], summary[2 * K:]
            vis_h = self._h_active & (vis > self.params.visibilityThresh)
            for k in self._frame_spawned:
                vis_h[k] = True      # spawned after this frame's raycast
            self._h_visible = vis_h
        if not mask_frame:
            self._apply_store_poses()
        with self.timer.phase("cleanup"):
            self._clean_up_objs(num_instances, matches, rc, cnt, asum)

    def _apply_store_poses(self) -> None:
        """storePoses (``EMFusion.cpp:96``)."""
        o = self.state.objs
        self._poses[self.frame] = self.state.cam_pose.numpy().copy()
        for k in np.nonzero(self._h_active)[0]:
            self._obj_poses.setdefault(int(self._h_ids[k]), {})[
                self.frame] = o.pose[k].numpy().copy()

    def _slot_of(self, obj_id: int) -> int:
        for k in range(self.K):
            if self._h_active[k] and self._h_ids[k] == obj_id:
                return k
        return -1

    # ------------------------------------------------------------------
    def _init_or_match_objs(self, rgb, points, rc, matches) -> int:
        """initOrMatchObjs (``EMFusion.cpp:329-373``,
        ``pipeline.py:1300-1411``)."""
        p = self.params
        if self.mask_provider is None:
            return -1
        dets = self.mask_provider.detect(rgb, self.frame)
        if dets is None:
            return -1
        dets = seg_mod.filter_detections(dets, p.FILTER_CLASSES,
                                         p.STATIC_OBJECTS,
                                         min_pixels=p.mask_min_pixels)
        if self.save_output and self.is_writer:
            self.outputs["masks"][self.frame] = [d.mask for d in dets]
            self.outputs["mask_vis"][self.frame] = visualize_detections(
                rgb, dets)                       # MaskRCNN::visualize
        n = len(dets)
        if n == 0:
            return 0

        pts = points.cpu().numpy()
        valid_points = pts[2] > 0
        cam = self.state.cam_pose.numpy()
        pts_w = (pts.reshape(3, -1).T @ cam[:3, :3].T
                 + cam[:3, 3]).astype(np.float32)
        seg_map = (rc["seg"].cpu().numpy() if rc is not None
                   else np.zeros((self.H, self.W), np.int32))

        score_matches: Dict[int, np.ndarray] = {}
        unmatched: List[int] = []
        masks = [d.mask.copy() for d in dets]
        ids, active, visible = self._h_ids, self._h_active, self._h_visible

        # matchSegmentation (EMFusion.cpp:418-455, 797-825): one (n, K)
        # IoU matrix and one copy
        iou_mat = None
        if self.frame > 0 and np.any(active & visible):
            iou_mat = mask_iou_matrix(
                torch.as_tensor(np.stack(masks)).to(self.device),
                torch.as_tensor(seg_map).to(self.device),
                torch.as_tensor(ids.astype(np.int32))).cpu().numpy()
            iou_mat = np.where((active & visible)[None, :], iou_mat, 0.0)
        match_det: Dict[int, int] = {}   # object id -> matched det index
        for i in range(n):
            matched_id = -1
            if iou_mat is not None:
                k_best = int(np.argmax(iou_mat[i]))
                best_iou = float(iou_mat[i, k_best])
                if best_iou > 0:
                    matched_id = int(ids[k_best])
                if best_iou <= p.matchIOUThresh:
                    matched_id = -1
                if matched_id >= 0 and matched_id in matches:
                    # conflict: keep the mask with the better IoU; the
                    # other goes the unmatched way (EMFusion.cpp:430-454)
                    prev_iou = float(iou_mat[match_det[matched_id], k_best])
                    if best_iou > prev_iou:
                        matches[matched_id] = masks[i].copy()
                        score_matches[matched_id] = dets[i].scores
                        match_det[matched_id] = i
                    matched_id = -1
            if matched_id >= 0:
                matches[matched_id] = masks[i]
                score_matches[matched_id] = dets[i].scores
                match_det[matched_id] = i
            else:
                unmatched.append(i)

        # initObjsFromUnmatched (EMFusion.cpp:457-493)
        for i in unmatched:
            for k in range(self.K):
                if not active[k]:
                    continue
                oid = int(ids[k])
                obj_mask = seg_map == oid
                if oid in matches:
                    obj_mask = obj_mask | matches[oid]
                pre = np.count_nonzero(masks[i])
                masks[i] = masks[i] & ~obj_mask
                if pre > 0 and np.count_nonzero(masks[i]) / pre < 0.5:
                    masks[i][:] = False
            mask = valid_points & masks[i]
            new_id = self._init_new_obj_volume(mask, pts_w, cam)
            if new_id >= 0:
                matches[new_id] = masks[i]
                score_matches[new_id] = dets[i].scores

        # update matched objects (EMFusion.cpp:359-369)
        for k in range(self.K):
            if not active[k]:
                continue
            oid = int(ids[k])
            meta = self.meta[oid]
            if oid in matches:
                offset = self._update_obj(k, oid, pts_w,
                                          valid_points & matches[oid],
                                          score_matches.get(oid))
                if np.any(offset != 0):
                    meta.pose_offsets[self.frame] = offset
                meta.ex_count += 1
            else:
                meta.nonex_count += 1
        return n

    def _init_new_obj_volume(self, mask, pts_w, cam) -> int:
        """initNewObjVolume (``EMFusion.cpp:495-558``,
        ``pipeline.py:1414-1485``)."""
        p = self.params
        if np.count_nonzero(mask) < p.visibilityThresh:
            return -1
        o = self.state.objs
        s = spawn_percentiles(
            torch.as_tensor(pts_w).to(self.device),
            torch.as_tensor(mask.reshape(-1)).to(self.device), o.pose)
        K = self.K
        p10, p90 = s[0:3], s[3:6]
        p10o = s[7:7 + 3 * K].reshape(K, 3)
        p90o = s[7 + 3 * K:7 + 6 * K].reshape(K, 3)
        vsizes = o.voxel_size.numpy()
        for k in np.nonzero(self._h_active)[0]:
            if volume_iou(p10o[k], p90o[k], vsizes[k], self.obj_res,
                          p.volPad) > p.volIOUThresh:
                return -1

        center = (p10 + p90) / 2
        if np.linalg.norm(center - cam[:3, 3]) > p.distanceThresh:
            return -1
        vol_size = p.volPad * float(np.max(p90 - p10))
        if vol_size <= 0:
            return -1
        slot = int(np.argmin(self._h_active))  # first free slot
        if self._h_active[slot]:
            logger.warning("frame %d: object pool full (%d slots), not "
                           "spawning a new object", self.frame, K)
            return -1
        voxel = vol_size / self.obj_res
        trunc = p.objRelTruncDist * voxel
        pose = _translate(center.astype(np.float32))

        new_id = self._next_id
        self._next_id += 1
        if self._owns(slot):
            ls = self._lv(slot)
            o.tsdf[ls] = 0.0
            o.weights[ls] = 0.0
            o.fg_counts[ls] = 0.0
        o.assoc[slot] = 1.0                  # createObj: assoc = 1
        o.pose[slot] = torch.from_numpy(pose)
        o.voxel_size[slot] = voxel
        o.truncdist[slot] = trunc
        o.active[slot] = True
        o.visible[slot] = True
        o.object_id[slot] = new_id
        self._h_visible[slot] = True
        self._frame_spawned.append(slot)
        # exCount starts at 0; the creation frame's match loop raises it
        # to 1 (EMFusion.cpp:359-365: new objects are in `matches`)
        self.meta[new_id] = ObjectMeta()
        self._obj_poses.setdefault(new_id, {})[self.frame] = pose
        logger.info("frame %d: created object %d (slot %d, voxel %.4f m, "
                    "center %s)", self.frame, new_id, slot, voxel,
                    np.round(center, 3).tolist())
        return new_id

    def _update_obj(self, slot, oid, pts_w, mask, scores) -> np.ndarray:
        """updateObj (``EMFusion.cpp:827-863``): class probabilities and
        resize."""
        meta = self.meta[oid]
        if scores is not None:
            if meta.class_probs is None:
                meta.class_probs = np.asarray(scores, np.float64).copy()
            else:
                meta.class_probs += np.asarray(scores)
        valid = mask.reshape(-1)
        if valid.sum() == 0:
            return np.zeros(3, np.float32)
        o = self.state.objs
        dev = self.device
        p = torch.zeros(6, dtype=torch.float32, device=dev)
        if self._owns(slot):
            T = np.linalg.inv(o.pose[slot].numpy())
            pts_o = (pts_w @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
            ls = self._lv(slot)
            p10, p90, _ = surface_and_new_percentiles(
                o.tsdf[ls], o.weights[ls], o.fg_counts[ls],
                o.voxel_size[slot].to(dev), torch.as_tensor(pts_o).to(dev),
                torch.as_tensor(valid).to(dev))
            p = torch.cat([p10, p90])
        p = self._from_owner(slot, p).cpu().numpy()
        return self._resize_obj(slot, p[:3], p[3:])

    def _resize_obj(self, slot, p10, p90) -> np.ndarray:
        """Recentre / rescale (``pipeline.py:1529-1571``, replacing
        ``ObjTSDF::resize``, ``ObjTSDF.cpp:80-165``): the grid resolution
        stays fixed and the voxel size grows so the grid covers the
        reference's grown extent; ``truncdist`` stays. Returns the voxel-
        aligned recentre offset (for pose-offset logging)."""
        p = self.params
        o = self.state.objs
        voxel = float(o.voxel_size[slot])
        half = (self.obj_res - 1) * voxel / 2
        contained = np.all(p10 >= -half) and np.all(p90 <= half)
        if contained or not np.all(np.isfinite(p10)) \
                or not np.all(np.isfinite(p90)):
            return np.zeros(3, np.float32)

        new_center = (p10 + p90) / 2
        pix_offset = (new_center / voxel).astype(np.int32)  # trunc, Vec3i
        new_center = pix_offset.astype(np.float32) * voxel
        new_dims = p90 - p10
        new_vol_vox = p.volPad * float(np.max(new_dims)) / voxel
        new_res = (int(np.ceil(new_vol_vox)) + 1) // 2 * 2
        new_voxel = new_res * voxel / self.obj_res
        pose = o.pose[slot].numpy() @ _translate(new_center)

        if self._owns(slot):
            ls = self._lv(slot)
            t2, w2, f2 = resample_slot(
                o.tsdf[ls], o.weights[ls], o.fg_counts[ls],
                np.float32(voxel), np.float32(new_voxel),
                torch.as_tensor(new_center))
            o.tsdf[ls] = t2
            o.weights[ls] = w2
            o.fg_counts[ls] = f2
        o.pose[slot] = torch.from_numpy(pose)
        o.voxel_size[slot] = new_voxel
        self._obj_poses.setdefault(int(o.object_id[slot]), {})[
            self.frame] = pose
        return new_center.astype(np.float32)

    def _clean_up_objs(self, num_instances, matches, rc, cnt=None,
                       asum=None) -> None:
        """cleanUpObjs (``EMFusion.cpp:922-980``, ``pipeline.py:
        1600-1673``): delete objects whose existence probability fell
        below its threshold (on mask frames), whose association over their
        mask is too low (tracking likely failed), or that are not
        visible. ``cnt``/``asum``: the frame summary's association stats;
        where a matched segmentation exists they are recomputed with its
        mask or'd in (reference :940-943)."""
        p = self.params
        frame = self.frame
        ids, active, visible = self._h_ids, self._h_active, self._h_visible
        spurious = set()
        if num_instances > 0:
            for k in np.nonzero(active)[0]:
                oid = int(ids[k])
                if self.meta[oid].ex_prob < p.existenceThresh:
                    spurious.add(oid)
                    logger.info("frame %d: object %d existence prob %.3f < "
                                "%.3f -> delete", frame, oid,
                                self.meta[oid].ex_prob, p.existenceThresh)

        check = [k for k in range(self.K) if active[k] and visible[k]]
        if check and rc is not None:
            o = self.state.objs
            if any(int(ids[k]) in matches for k in check):
                match_masks = torch.zeros((self.K, self.H, self.W),
                                          dtype=torch.bool,
                                          device=self.device)
                for k in check:
                    if int(ids[k]) in matches:
                        match_masks[k] = torch.as_tensor(
                            matches[int(ids[k])]).to(self.device)
                c, a = cleanup_stats(rc["obj_masks"], o.assoc, match_masks)
                cnt, asum = c.cpu().numpy(), a.cpu().numpy()
            elif cnt is None:
                c, a = cleanup_stats(rc["obj_masks"], o.assoc)
                cnt, asum = c.cpu().numpy(), a.cpu().numpy()
            for k in check:
                if p.assocThresh * float(cnt[k]) > float(asum[k]):
                    spurious.add(int(ids[k]))
                    logger.info("frame %d: object %d association below "
                                "threshold -> delete", frame, int(ids[k]))

        o = self.state.objs
        for k in np.nonzero(active)[0]:
            oid = int(ids[k])
            if oid in spurious or not visible[k]:
                if oid not in spurious:
                    logger.info("frame %d: object %d not visible -> "
                                "delete", frame, oid)   # :951-960
                o.active[k] = False
                o.visible[k] = False
                o.assoc[k] = 0.0
                self._h_visible[k] = False

    # ------------------------------------------------------------------
    def render(self) -> np.ndarray:
        """Phong-rendered composited model view (``EMFusion::render``),
        (H, W, 3) uint8. With ``ignore_person``, the pixels of person-class
        objects are removed before shading (``EMFusion.cpp:139-150``)."""
        rc = self._last_raycast
        if rc is None:
            return np.zeros((self.H, self.W, 3), np.uint8)
        seg, verts, norms = rc["seg"], rc["vertices"], rc["normals"]
        if self.params.ignore_person:
            person = seg_mod.CLASS_NAMES.index("person")
            person_ids = [oid for oid, m in self.meta.items()
                          if m.class_probs is not None
                          and int(np.argmax(m.class_probs)) == person]
            if person_ids:
                drop = torch.isin(seg, torch.tensor(person_ids,
                                                    device=seg.device))
                seg = torch.where(drop, 0, seg)
                verts = torch.where(drop[None], 0.0, verts)
                norms = torch.where(drop[None], 0.0, norms)
        return render_phong(verts, norms, seg % 256,
                            self.colormap).cpu().numpy()

    @property
    def poses(self) -> Dict[int, np.ndarray]:
        """Per-frame camera poses (camera-to-world, float32 4x4)."""
        return self._poses

    @property
    def obj_poses(self) -> Dict[int, Dict[int, np.ndarray]]:
        """Per object id, its per-frame poses (object-to-world)."""
        return self._obj_poses

    @property
    def active_object_ids(self) -> List[int]:
        return [int(self._h_ids[k]) for k in np.nonzero(self._h_active)[0]]

    @property
    def cam_pose(self) -> np.ndarray:
        return self.state.cam_pose.numpy()

    @property
    def last_raycast(self) -> Optional[dict]:
        return self._last_raycast
