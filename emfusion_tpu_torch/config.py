"""Parameter structs + INI config parsing.

A copy of ``emfusion_tpu/config.py`` (the port imports nothing of the JAX
package), so both packages parse the reference's ``config/*.cfg`` files
into the same :class:`Params`. Defaults equal the paper values
(``data.h:37-122``).

The knobs grouped at the bottom of :class:`Params` were added for the TPU
build. :func:`resolve_params` says what each of them means in this port.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class TSDFParams:
    """TSDF tracking/mapping parameters (reference ``data.h:32-71``)."""

    tau: float = 1e3            # LM identity-prior factor
    eps1: float = 1e-8          # convergence: gradient of energy small
    eps2: float = 1e-8          # convergence: small step
    nu_init: float = 2.0        # LM damping rescale factor
    huberThresh: float = 0.2    # Huber delta (relative to truncation dist)
    maxTSDFWeight: float = 64.0 # integration weight cap
    assocSigma: float = 0.02    # Laplace sigma for association likelihood
    alpha: float = 0.8          # mixture weight: alpha*laplace+(1-alpha)*uni
    uniPrior: float = 1.0       # uniform prior value


# Classes never treated as dynamic objects (reference ``data.h:116-120``).
DEFAULT_STATIC_OBJECTS = [
    "traffic light", "fire hydrant", "stop sign", "parking meter", "bench",
    "couch", "potted plant", "bed", "dining table", "toilet", "oven", "sink",
    "refrigerator",
]


@dataclass
class Params:
    """Processing parameters (reference ``data.h:76-199``).

    Field names intentionally match the reference so its INI config files
    parse 1:1.
    """

    frameSize: Tuple[int, int] = (640, 480)  # (width, height)

    # Intrinsics: fx, fy, cx, cy (reference stores a 3x3; same content)
    fx: float = 525.0
    fy: float = 525.0
    cx: float = 319.5
    cy: float = 239.5

    bilateral_sigma_depth: float = 0.04   # meters
    bilateral_sigma_spatial: float = 4.5  # pixels
    bilateral_kernel_size: int = 7

    globalVolumeDims: Tuple[int, int, int] = (512, 512, 512)
    globalVoxelSize: float = 0.01
    globalRelTruncDist: float = 10.0
    objVolumeDims: Tuple[int, int, int] = (64, 64, 64)
    objRelTruncDist: float = 10.0

    # Initial background volume pose: translation of volume center in camera
    # frame (reference ``data.h:103``; config key ``volumePose`` = 3 floats).
    volumePose: Tuple[float, float, float] = (0.0, 0.0, 2.56)

    volPad: float = 2.0
    maxTrackingIter: int = 100
    maskRCNNFrames: int = 30
    existenceThresh: float = 0.1
    volIOUThresh: float = 0.5
    matchIOUThresh: float = 0.2
    distanceThresh: float = 5.0
    visibilityThresh: int = 1600
    assocThresh: float = 0.1
    boundary: int = 20

    tsdfParams: TSDFParams = field(default_factory=TSDFParams)

    FILTER_CLASSES: List[str] = field(default_factory=list)
    STATIC_OBJECTS: List[str] = field(
        default_factory=lambda: list(DEFAULT_STATIC_OBJECTS))
    ignore_person: bool = False

    # ---- TPU-native additions (static shapes for XLA) ----
    # Maximum number of live object volumes in the batched object pool.
    max_objects: int = 16
    # Object volumes keep a FIXED grid resolution; "resize" rescales the
    # voxel size and resamples (design deviation from reference
    # ``ObjTSDF.cpp:80-165`` which grows the grid; documented in README).
    # Per-ray iteration budget for the vectorized raycast while-loop.
    raycast_max_steps: int = 2048
    # Minimum mask size in pixels for a detection to be considered
    # (reference hardcodes 50*50 in apps/maskrcnn.in.py:181).
    mask_min_pixels: int = 50 * 50
    # Maximum vertices/triangles emitted by marching cubes (static output).
    mc_max_verts: int = 3_000_000
    # TSDF fusion backend: "auto" picks the MXU pencil-warp path on TPU
    # (XLA's gather is a ~0.11 G elem/s scalar loop there) and the direct
    # gather formulation elsewhere; "pencil"/"gather" force one.
    fusion_backend: str = "auto"
    # Raycast backend: "auto" = Pallas B-space plane-sweep kernel on TPU
    # for the background volume (the lock-step per-ray march would do
    # ~50M scalar gathers/frame there; the XLA sweep re-materializes the
    # volume in f32), XLA sweep for the vmapped object volumes, lock-step
    # march elsewhere; "sweep_pallas"/"sweep"/"march" force one.
    raycast_backend: str = "auto"
    # Background E-step sampling backend: "sweep" (auto on TPU) samples
    # the per-pixel TSDF value with the Pallas plane-sweep kernel (one
    # streaming volume pass; along-ray piecewise-linear interpolation,
    # same deviation class as the sweep raycast) instead of the XLA
    # per-point gather ("gather", exact trilinear, auto on CPU).
    estep_backend: str = "auto"
    # LM tracking pixel stride (points are subsampled stride x stride).
    # 0 = auto: 1 on CPU (exact reference behavior), 3 on TPU where the
    # per-iteration trilinear gathers run on XLA's scalar gather path.
    tracking_stride: int = 0
    # E-step association resolution divisor: weights are computed on an
    # (H/s, W/s) grid and nearest-upsampled. 1 = exact reference behavior
    # (default); 2 quarters the per-frame trilinear gather volume on TPU
    # at the cost of 1-px association blockiness at model boundaries.
    estep_scale: int = 0
    # Run the pencil/sweep interpolation matmuls in hi/lo-split bf16
    # (exact for fusion's 0/1 matrices, ~1e-3 relative on the sweep's
    # bilinear blends; uses the MXU's higher bf16 rate).
    matmul_bf16: bool = False
    # LM capture backend: "band" (auto on TPU) = banded sweep-capture
    # (one streaming volume pass + in-plane resampled caches,
    # geometry/band_capture.py); "gather" (auto on CPU) = per-point
    # HBM neighborhood gather (exact voxel reads).
    capture_backend: str = "auto"
    # Bilateral filter backend: "auto" uses the VMEM-resident Pallas
    # stencil kernel on TPU (zero-pad borders), "xla" the 49-tap fused
    # XLA graph (reflect-101 borders, exact reference semantics).
    bilateral_backend: str = "auto"
    # Background-volume storage dtype. The fused update streams
    # 4 x res^3 elements through HBM every frame (read+write tsdf and
    # weights) and is bandwidth-bound; "bfloat16" halves that traffic.
    # Quantization: tsdf values are trunc-normalized in [-1, 1], so bf16
    # costs <= 2^-9 relative (~0.2 mm at the default 10 cm trunc dist);
    # weights lose sub-ULP increments near the 64 cap (slightly
    # recency-weighted averaging). The JAX package's "auto" is bfloat16
    # on a TPU; the port's is float32 on every device, and "bfloat16" is
    # honoured when asked for (resolve_params).
    volume_dtype: str = "auto"
    # Background free-space carving distance (meters): free-space depth
    # evidence with sdf >= this integrates into the BACKGROUND at full
    # weight 1.0 instead of the (near-zero at object pixels) background
    # association weight. The reference uses weight 1 only beyond
    # +truncdist (TSDF.cu:382-397), which lets a pre-spawn imprint of a
    # departing object linger in the background: its raycast hit is
    # >5 cm nearer than the object's, the compositor's bg override
    # (EMFusion.cpp:773-776) blanks the object's segmentation, and the
    # visibility check deletes a well-tracked object. The default sits
    # 1 cm INSIDE the 5 cm override distance so the interpolated
    # crossing between the last carved (positive) voxel and the first
    # still-stale negative one lands safely under the override. Set
    # <= 0 to disable (exact reference semantics). Background only.
    bg_carve_dist: float = 0.04
    # On carve votes the STORED background weight entering the running
    # average is clamped to this value. 0.0 = the free-space
    # measurement REPLACES the contradicted stored value outright: any
    # averaging lags the sign flip by ~cap frames, and against a
    # receding object that lag keeps the stale crossing permanently
    # ~cap cm ahead of the carve boundary (measured: the 512^3 bench
    # object still died with cap=1). Static free space is
    # value-unaffected (measurements there already agree; the voxel's
    # weight pins at ~1). Set >= maxTSDFWeight to disable the clamp.
    bg_carve_weight_cap: float = 0.0
    # r5 (ADVICE r4): the weight cap applies only where the free-space
    # measurement CONTRADICTS the stored value by more than this margin
    # (tsdf units): tsdf_meas - stored > margin. In the agreeing shell
    # carve_dist <= sdf < truncdist in front of ordinary surfaces the
    # running average (and its depth-noise suppression) is preserved —
    # at cap=0 an ungated carve vote would replace those values with
    # the single latest (noisy) measurement every frame. Genuinely
    # contradicted voxels (a stale surface the camera now sees through,
    # measurement near +1 vs stored near/below 0) still flip
    # immediately. Gated under sensor noise + outlier tests
    # (tests/test_object_survival.py). Set <= -2 to cap every carve
    # vote (the r4 behavior).
    bg_carve_margin: float = 0.25
    # Camera LM initialization: "static" starts at the previous pose
    # (reference, EMFusion.cpp:675); "constvel" starts AND captures at
    # a constant-velocity prediction from the last two poses, keeping
    # frame-scale motion inside the capture windows (each avoided
    # re-capture saves a banded volume sweep). "auto": constvel on
    # TPU, static on CPU.
    motion_model: str = "auto"
    # Object E-step point budget: each object's association weights are
    # evaluated only at the top-M points inside its volume's bounding
    # box (EXACT culling — outside points sample the reference's 0
    # sentinel and get weight 0 anyway; ObjTSDF.cpp:189-200). Bounds
    # the per-object trilinear gathers, the dominant E-step cost at 16
    # objects. An object footprint larger than M points drops the
    # overflow (weight 0 there); 8192 covers a 180x180-px object at the
    # production escale-2 grid. 0 = evaluate all points (exact path).
    estep_obj_subset: int = 8192
    # Static per-object LM point budget: each object tracks on its
    # top-K association-weighted stride-subsampled pixels (pipeline
    # track_obj subset mode). A near-camera object at 640x480 can
    # exceed this; the truncation keeps the batched pool LM's shapes
    # static. Drift vs the full-point LM is gated in
    # tests/test_accuracy_gate_objects.py. 0 = use every point.
    obj_track_points: int = 4096
    # Camera-LM exact-refinement subset (TrackConfig.refine_points):
    # after the banded capture LM converges, re-run a few iterations on
    # the top-K points with exact gathered voxel values (~10-30
    # ms/frame on TPU at 512^3). Default OFF: measured r5, the
    # subset-LM optimum scatters with K (gate ATE ratio vs the exact
    # path: 0.81x at K=512, 1.77x at 1536, 2.67x at 256) — a few
    # hundred exact points do not pin the 6-DoF optimum more
    # reproducibly than 34k band-resampled ones. Kept as an option for
    # full-point exact refinement on small scenes.
    camera_refine_points: int = 0

    @property
    def intr(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0.0, self.cx],
             [0.0, self.fy, self.cy],
             [0.0, 0.0, 1.0]], dtype=np.float32)

    @property
    def width(self) -> int:
        return self.frameSize[0]

    @property
    def height(self) -> int:
        return self.frameSize[1]

    @property
    def global_truncdist(self) -> float:
        return self.globalRelTruncDist * self.globalVoxelSize

    def volume_pose_matrix(self) -> np.ndarray:
        m = np.eye(4, dtype=np.float32)
        m[:3, 3] = np.asarray(self.volumePose, dtype=np.float32)
        return m


def _parse_value(params: Params, tsdf: TSDFParams, section: str, key: str,
                 values: List[str]) -> None:
    """Apply one INI entry onto the param structs.

    Section/key naming follows the reference config format
    (``apps/EM-Fusion.cpp:269-371``): sections ``[Params]``,
    ``[Params.intr]``, ``[Params.tsdfParams]``, ``[Params.MaskRCNNParams]``.
    """
    v = values[-1]  # scalar keys: last assignment wins
    if section == "Params.intr":
        if key in ("fx", "fy", "cx", "cy"):
            setattr(params, key, float(v))
        return
    if section == "Params.tsdfParams":
        if hasattr(tsdf, key):
            setattr(tsdf, key, float(v))
        return
    if section == "Params.MaskRCNNParams":
        if key == "FILTER_CLASSES":
            params.FILTER_CLASSES = list(values)
        elif key == "STATIC_OBJECTS":
            params.STATIC_OBJECTS = list(values)
        return
    if section != "Params":
        return

    if key == "frameSize":
        w, h = v.split()
        params.frameSize = (int(w), int(h))
    elif key in ("globalVolumeDims", "objVolumeDims"):
        setattr(params, key, tuple(int(x) for x in v.split()))
    elif key == "volumePose":
        parts = [float(x) for x in v.split()]
        if len(parts) == 3:
            params.volumePose = tuple(parts)
        else:
            raise ValueError("volumePose expects 3 floats (translation)")
    elif key == "fusion_backend":
        params.fusion_backend = v.strip()
    elif key in ("raycast_backend", "bilateral_backend", "volume_dtype",
                 "estep_backend", "capture_backend", "motion_model"):
        setattr(params, key, v.strip())
    elif key in ("ignore_person", "matmul_bf16"):
        setattr(params, key,
                v.strip().lower() in ("yes", "true", "1", "on"))
    elif key in ("bilateral_kernel_size", "maxTrackingIter", "maskRCNNFrames",
                 "visibilityThresh", "boundary", "max_objects",
                 "raycast_max_steps", "mc_max_verts", "tracking_stride",
                 "estep_scale", "mask_min_pixels", "estep_obj_subset",
                 "obj_track_points", "camera_refine_points"):
        setattr(params, key, int(v))
    elif hasattr(params, key):
        setattr(params, key, float(v))


def load_config(path: str, base: Optional[Params] = None) -> Params:
    """Parse a reference-format INI config file into :class:`Params`.

    Supports repeated keys (STATIC_OBJECTS lists), ``#`` comments, and the
    multi-token values used by the reference configs. Values not present keep
    their defaults (or the values from ``base``).
    """
    params = dataclasses.replace(base) if base is not None else Params()
    tsdf = dataclasses.replace(params.tsdfParams)
    section = "Params"
    pending: dict = {}

    with open(path, "r") as f:
        for raw in f:
            line = raw.split("#", 1)[0].split(";", 1)[0].strip()
            if not line:
                continue
            if line.startswith("[") and line.endswith("]"):
                for (sec, key), vals in pending.items():
                    _parse_value(params, tsdf, sec, key, vals)
                pending = {}
                section = line[1:-1].strip()
                continue
            if "=" not in line:
                continue
            key, _, val = line.partition("=")
            key, val = key.strip(), val.strip()
            pending.setdefault((section, key), []).append(val)

    for (sec, key), vals in pending.items():
        _parse_value(params, tsdf, sec, key, vals)

    params.tsdfParams = tsdf
    return params


def load_calibration(path: str, params: Params) -> Params:
    """Override intrinsics from a dataset ``calibration.txt`` (fx fy cx cy),
    mirroring ``apps/EM-Fusion.cpp:401-411``."""
    with open(path) as f:
        vals = f.read().split()
    fx, fy, cx, cy = (float(x) for x in vals[:4])
    return dataclasses.replace(params, fx=fx, fy=fy, cx=cx, cy=cy)


def fit_frame_size(params: Params, width: int, height: int) -> Params:
    """``params`` for frames of ``width`` x ``height``: the frame size and
    the intrinsics scaled with it, per axis by the ratio of the sizes
    (``f * s``; ``(c + 0.5) * s - 0.5`` for the principal point, pixel
    centres at integers). The JAX CLI takes the frame size from the data
    but keeps the intrinsics (``apps/run_emfusion.py:123-130``), which
    then describe another image; a ``calibration.txt`` given for the
    data's own size is read after this and wins."""
    if (width, height) == tuple(params.frameSize):
        return params
    sx = width / params.frameSize[0]
    sy = height / params.frameSize[1]
    return dataclasses.replace(
        params, frameSize=(width, height), fx=params.fx * sx,
        cx=(params.cx + 0.5) * sx - 0.5, fy=params.fy * sy,
        cy=(params.cy + 0.5) * sy - 0.5)


@dataclass(frozen=True)
class Resolved:
    """The port's reading of the ``auto`` knobs of :class:`Params`."""
    volume_dtype: str
    tracking_stride: int
    estep_scale: int
    motion_model: str
    # "serial": one LM per object slot over every tracking point;
    # "batched": one LM over every live slot's top-``obj_track_points``
    # points (0: every point)
    object_lm: str
    obj_track_points: int
    # the LM sampler of the camera and the serial object LMs:
    # "gather" (exact) or "capture"
    sampler: str


SAMPLERS = ("auto", "gather", "capture")


def resolve_params(params: Params, sampler: Optional[str] = None) -> Resolved:
    """Resolve the ``auto`` knobs: ``auto`` gives the JAX package's exact
    reference path (what it picks on the CPU, ``pipeline.py:158-176,
    261-264, 387-411``); the knobs of its accelerator configuration are
    honoured when asked for explicitly.

    * ``volume_dtype``: ``auto``/``float32`` -> float32, the exact path;
      ``bfloat16``, the JAX package's accelerator storage, is honoured
      when asked for: the background's tsdf and weights are stored in
      bf16 (objects, counts and association images stay float32), every
      kernel and plain version loads them as float32, computes in
      float32 and rounds once, to nearest even, where it stores (the
      JAX pipeline's jitted arithmetic on the CPU). Any other dtype
      raises ``NotImplementedError``.
    * ``tracking_stride``: 0 -> 1 (every pixel); any positive stride is
      honoured.
    * ``estep_scale``: 0 -> 1; a scale ``s`` > 1 computes the association
      weights on the ``[::s, ::s]`` pixel grid and upsamples them.
    * ``motion_model``: ``auto`` -> ``static`` (the camera LM starts at the
      previous pose); ``constvel`` starts and captures at a constant-
      velocity prediction from the last two recorded poses.
    * ``capture_backend`` chooses the object LM's form, as
      ``pipeline.py:407-411, 1107-1112`` does: ``band`` runs one batched
      LM over every live slot, each on its top ``obj_track_points``
      association-weighted points (0: every point); ``auto`` and
      ``gather`` run one LM per slot over every tracking point.

    * ``sampler``, the LM sampler of the camera and the serial object
      LMs (``TrackConfig.sampler``): None reads ``EMF_TRACK_SAMPLER``,
      default ``auto``, as the JAX pipeline does (``pipeline.py:147-155``);
      ``gather`` and ``capture`` are honoured. ``auto`` is ``capture``
      under ``capture_backend="band"``, the accelerator configuration
      (where the JAX package's ``auto`` captures too), and ``gather``, the
      exact path, otherwise, on every device. The band capture (and
      ``camera_refine_points``, which refines it) is a TPU formulation
      that the port does not have: its capture is K3's exact window
      gather.

    The other backend knobs (``fusion_backend``, ``raycast_backend``,
    ``estep_backend``, ``bilateral_backend``) only choose between TPU
    formulations of one function. The port has one direct CUDA kernel for
    each function and ignores them, and so it ignores ``matmul_bf16``.
    ``estep_obj_subset`` is honoured.
    """
    vd = params.volume_dtype
    if vd == "auto":
        vd = "float32"
    if vd not in ("float32", "bfloat16"):
        raise NotImplementedError(
            f"volume_dtype={vd!r}: the port stores volumes in float32 or "
            "bfloat16")
    mm = "static" if params.motion_model == "auto" else params.motion_model
    if mm not in ("static", "constvel"):
        raise ValueError(f"motion_model={mm!r}: 'auto', 'static' or "
                         "'constvel'")
    batched = params.capture_backend == "band"
    if sampler is None:
        sampler = os.environ.get("EMF_TRACK_SAMPLER", "auto")
    if sampler not in SAMPLERS:
        raise ValueError(f"sampler={sampler!r}: one of {SAMPLERS}")
    if sampler == "auto":
        sampler = "capture" if batched else "gather"
    return Resolved(volume_dtype=vd,
                    tracking_stride=params.tracking_stride or 1,
                    estep_scale=max(params.estep_scale or 1, 1),
                    motion_model=mm,
                    object_lm="batched" if batched else "serial",
                    obj_track_points=(max(params.obj_track_points, 0)
                                      if batched else 0),
                    sampler=sampler)
