"""EM-Fusion pipeline, background only.

Port of ``emfusion_tpu/pipeline.py``'s ``EMFusionPipeline`` for scenes
without objects: the frame step of ``EMFusion::processFrame``
(``EMFusion.cpp:70-129``) with no object model,

    preprocess -> E-step -> camera LM -> E-step -> E-step -> raycast
    -> fuse into the background volume,

where frame 0 only preprocesses and fuses. Objects (a ``mask_provider``,
object spawn, their E-step, LM, raycast and fusion) are still to be
ported: ROADMAP queue 1 item 9.

The volumes live on the compute device and the fusion kernel updates them
in place; the 4x4 poses live on the host as float32 tensors, so no step
waits for the device to report a pose.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from emfusion_tpu_torch.config import Params, resolve_params
from emfusion_tpu_torch.device import resolve_device
from emfusion_tpu_torch.geometry.camera import (
    backproject_depth, preprocess_depth,
)
from emfusion_tpu_torch.geometry.se3 import pose_inverse, reorthonormalize
from emfusion_tpu_torch.ops.association import (
    association_weights, normalize_associations,
)
from emfusion_tpu_torch.ops.fusion import integrate_tsdf
from emfusion_tpu_torch.ops.raycast import raycast_volume
from emfusion_tpu_torch.profiling import PhaseTimer
from emfusion_tpu_torch.tracking import TrackConfig, track_volume
from emfusion_tpu_torch.volume import make_volume

_OBJECTS_TODO = ("objects are not ported yet (ROADMAP queue 1 item 9); "
                 "this pipeline runs the background-only frame step")


@dataclasses.dataclass
class PipelineState:
    """Background state: volumes and association image on the device,
    poses on the host (float32)."""
    bg_tsdf: torch.Tensor      # (Z, Y, X)
    bg_weights: torch.Tensor   # (Z, Y, X)
    bg_pose: torch.Tensor      # (4, 4) volume-to-world, constant
    bg_assoc: torch.Tensor     # (H, W)
    cam_pose: torch.Tensor     # (4, 4) camera-to-world


def state_from_numpy(arrays: Dict[str, np.ndarray], device=None
                     ) -> PipelineState:
    """Build the port's state from the JAX ``PipelineState``'s background
    arrays as numpy (``bg_tsdf``, ``bg_weights``, ``bg_pose``,
    ``bg_assoc``, ``cam_pose``), so both packages can continue from the
    same fused volume. The arrays are copied: the fusion updates the
    port's volumes in place."""
    dev = resolve_device(device)

    def dev_t(name):
        return torch.tensor(np.asarray(arrays[name], np.float32), device=dev)

    def host_t(name):
        return torch.as_tensor(np.array(arrays[name], np.float32))

    return PipelineState(bg_tsdf=dev_t("bg_tsdf").contiguous(),
                         bg_weights=dev_t("bg_weights").contiguous(),
                         bg_pose=host_t("bg_pose"),
                         bg_assoc=dev_t("bg_assoc"),
                         cam_pose=host_t("cam_pose"))


class EMFusionPipeline:
    """Host-facing pipeline (the ``EMFusion`` class equivalent)."""

    def __init__(self, params: Params, mask_provider=None, device=None):
        if mask_provider is not None:
            raise NotImplementedError(_OBJECTS_TODO)
        self.device = resolve_device(device)
        self.params = params
        resolved = resolve_params(params)
        self.stride = resolved.tracking_stride
        self.frame = 0
        self.H, self.W = params.height, params.width
        self.intr = torch.as_tensor(params.intr)
        tp = params.tsdfParams
        self.track_cfg = TrackConfig(
            tau=tp.tau, eps1=tp.eps1, eps2=tp.eps2, nu_init=tp.nu_init,
            huber_thresh=tp.huberThresh, max_tsdf_weight=tp.maxTSDFWeight,
            max_iter=params.maxTrackingIter)
        self.voxel = params.globalVoxelSize
        self.trunc = params.global_truncdist
        self.state = self._init_state()
        self._poses: Dict[int, np.ndarray] = {}
        self.timestamps: Dict[int, float] = {}
        self._pending = None
        self._last_raycast = None
        self.last_track_stats = None
        self.timer = PhaseTimer(self.device)

    def _init_state(self) -> PipelineState:
        p = self.params
        tsdf, weights = make_volume(p.globalVolumeDims, self.device)
        return PipelineState(
            bg_tsdf=tsdf, bg_weights=weights,
            bg_pose=torch.as_tensor(p.volume_pose_matrix()),
            bg_assoc=torch.ones((self.H, self.W), dtype=torch.float32,
                                device=self.device),   # EMFusion.cpp:55
            cam_pose=torch.eye(4, dtype=torch.float32))

    def load_state(self, state: PipelineState, frame: int) -> None:
        """Continue from ``state`` as frame ``frame`` (e.g. a state from
        :func:`state_from_numpy`)."""
        self.state = state
        self.frame = int(frame)
        self._pending = None
        self._last_raycast = None

    # ------------------------------------------------------------------
    def preprocess(self, depth_raw):
        """Bilateral filter + patching, then the point map
        (``pipeline.py:817-831``)."""
        p = self.params
        raw = torch.as_tensor(np.asarray(depth_raw, np.float32)).to(
            self.device)
        depth = preprocess_depth(raw, p.bilateral_kernel_size,
                                 p.bilateral_sigma_depth,
                                 p.bilateral_sigma_spatial)
        return depth, backproject_depth(depth, self.intr)

    def _rel_bg(self) -> torch.Tensor:
        """Camera-to-volume transform."""
        return pose_inverse(self.state.bg_pose) @ self.state.cam_pose

    def estep(self, points: torch.Tensor) -> None:
        """computeAssociationWeights (``EMFusion.cpp:635-670``) for the
        background: its normalised association image."""
        tp = self.params.tsdfParams
        s = self.state
        rel = self._rel_bg()
        bg_w = association_weights(s.bg_tsdf, points, rel[:3, :3],
                                   rel[:3, 3], self.voxel, self.trunc,
                                   tp.assocSigma, tp.alpha, tp.uniPrior)
        none = torch.zeros((0, self.H, self.W), dtype=torch.float32,
                           device=self.device)
        s.bg_assoc, _ = normalize_associations(
            bg_w, none, torch.zeros(0, dtype=torch.bool, device=self.device))

    def track_camera(self, points: torch.Tensor) -> None:
        """Camera-vs-background LM (performTracking, first half), started
        at the previous pose (``EMFusion.cpp:675``)."""
        s, k = self.state, self.stride
        pts = points[:, ::k, ::k].reshape(3, -1)
        asc = s.bg_assoc[::k, ::k].reshape(-1)
        rel_init = reorthonormalize(self._rel_bg())
        rel, stats = track_volume(s.bg_tsdf, s.bg_weights, self.voxel, pts,
                                  asc, rel_init, self.track_cfg)
        s.cam_pose = s.bg_pose @ rel
        self.last_track_stats = stats

    def raycast(self) -> dict:
        """The background part of ``EMFusion::raycast``
        (``EMFusion.cpp:726-795``)."""
        s = self.state
        rel = self._rel_bg()
        return raycast_volume(s.bg_tsdf, s.bg_weights, rel[:3, :3],
                              rel[:3, 3], self.intr, self.voxel, self.trunc,
                              self.H, self.W,
                              max_steps=self.params.raycast_max_steps)

    def integrate(self, depth: torch.Tensor) -> None:
        """The background part of integrateDepth
        (``EMFusion.cpp:865-889``), with the background carve rules
        (``Params.bg_carve_*``); updates the volume in place."""
        s = self.state
        rel_oc = pose_inverse(s.cam_pose) @ s.bg_pose
        integrate_tsdf(s.bg_tsdf, s.bg_weights, depth, s.bg_assoc,
                       rel_oc[:3, :3], rel_oc[:3, 3], self.intr, self.voxel,
                       self.trunc, self.params.tsdfParams.maxTSDFWeight,
                       *self.carve_args())

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

    # ------------------------------------------------------------------
    def process_frame(self, rgb: Optional[np.ndarray], depth_raw,
                      timestamp: Optional[float] = None) -> None:
        """One frame of ``EMFusion::processFrame`` without objects. ``rgb``
        is only read by the mask provider, which is not ported."""
        del rgb
        self._consume_pending()
        if timestamp is not None:
            self.timestamps[self.frame] = float(timestamp)
        timer = self.timer
        with timer.phase("preprocess"):
            depth, points = self.preprocess(depth_raw)
        if self.frame > 0:
            with timer.phase("estep_pre"):
                self.estep(points)
            with timer.phase("track_camera"):
                self.track_camera(points)
            with timer.phase("estep_mid"):
                self.estep(points)               # EMFusion.cpp:687
            with timer.phase("estep_post"):
                self.estep(points)               # post-track, :87
            with timer.phase("raycast"):
                self._last_raycast = self.raycast()
        with timer.phase("integrate"):
            self.integrate(depth)
        # end-of-frame summary, consumed at the next frame or flush()
        self._pending = (self.frame, self.state.cam_pose.clone())
        self.frame += 1

    def _consume_pending(self) -> None:
        """Record the previous frame's pose (storePoses,
        ``EMFusion.cpp:96``)."""
        if self._pending is not None:
            frame, cam = self._pending
            self._pending = None
            self._poses[frame] = cam.numpy().copy()

    def flush(self) -> None:
        """Consume the deferred end-of-frame summary; call before reading
        poses or state after the last frame."""
        self._consume_pending()

    @property
    def poses(self) -> Dict[int, np.ndarray]:
        """Per-frame camera poses (camera-to-world, float32 4x4)."""
        self._consume_pending()
        return self._poses

    @property
    def last_raycast(self) -> Optional[dict]:
        return self._last_raycast
