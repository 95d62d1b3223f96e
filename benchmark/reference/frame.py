"""The plain reference of one EM-Fusion frame, stage by stage.

Each function works out one stage of ``EMFusion::processFrame``
(``EMFusion.cpp:70-129``) from the frame's raw depth and the state that
the stage starts from, with the frozen plain operations of
:mod:`benchmark.reference.ops` and :mod:`benchmark.reference.lm`:

    preprocess -> E-step -> camera LM -> E-step -> object LMs -> E-step
    -> raycast composite -> (mask frame: lifecycle) -> fusion -> masks

A state is a dict of tensors (:func:`snapshot` in ``benchmark/check.py``
takes it from the run): ``bg_tsdf``, ``bg_weights``, ``bg_pose``,
``cam_pose``, ``bg_assoc`` and the pool's ``tsdf``, ``weights``,
``fg_counts``, ``assoc``, ``pose``, ``voxel_size``, ``truncdist``,
``active``, ``visible``, ``object_id``. The configuration is the
configuration file (``configs/<name>.json``), read here by
:class:`RefConfig` with the
reference's own reading of each knob, so nothing of the program's
parameter code is used.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.reference import lm, ops


@dataclasses.dataclass(frozen=True)
class RefConfig:
    """The sizes and knobs a frame's reference needs, as the
    configuration states them (``auto`` read as the exact path)."""
    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float
    kernel_size: int
    sigma_depth: float
    sigma_spatial: float
    voxel: float
    trunc: float
    obj_rel_trunc: float
    obj_res: int
    max_objects: int
    tau: float
    eps1: float
    eps2: float
    nu_init: float
    huber: float
    max_weight: float
    assoc_sigma: float
    alpha: float
    uni_prior: float
    max_iter: int
    max_recaptures: int
    stride: int
    escale: int
    constvel: bool
    sampler: str             # camera and serial object LMs: gather/capture
    batched: bool            # the objects' batched LM
    obj_track_points: int
    estep_obj_subset: int
    raycast_max_steps: int
    boundary: int
    visibility: int
    existence: float
    assoc_thresh: float
    match_iou: float
    mask_min_pixels: int
    carve_dist: Optional[float]
    carve_cap: Optional[float]
    carve_margin: Optional[float]
    volume_dtype: torch.dtype

    @classmethod
    def from_config(cls, config: dict, **overrides) -> "RefConfig":
        """From a configuration file's ``params``, ``assumed`` and
        ``lm_max_recaptures``; ``overrides`` replace keys of the first
        two."""
        p = dict(config["params"], **config["assumed"])
        p.update(overrides)
        tp = p["tsdfParams"]
        band = p["capture_backend"] == "band"
        voxel = float(p["globalVoxelSize"])
        trunc = float(p["globalRelTruncDist"]) * voxel
        carve = (min(p["bg_carve_dist"], trunc) if p["bg_carve_dist"] > 0
                 else None)
        cap = (p["bg_carve_weight_cap"] if carve is not None
               and p["bg_carve_weight_cap"] < tp["maxTSDFWeight"] else None)
        margin = (p["bg_carve_margin"] if cap is not None
                  and p["bg_carve_margin"] > -2.0 else None)
        dt = {"auto": torch.float32, "float32": torch.float32,
              "bfloat16": torch.bfloat16}[p["volume_dtype"]]
        return cls(
            width=int(p["frameSize"][0]), height=int(p["frameSize"][1]),
            fx=p["fx"], fy=p["fy"], cx=p["cx"], cy=p["cy"],
            kernel_size=int(p["bilateral_kernel_size"]),
            sigma_depth=p["bilateral_sigma_depth"],
            sigma_spatial=p["bilateral_sigma_spatial"],
            voxel=voxel, trunc=trunc,
            obj_rel_trunc=float(p["objRelTruncDist"]),
            obj_res=int(p["objVolumeDims"][0]),
            max_objects=int(p["max_objects"]),
            tau=tp["tau"], eps1=tp["eps1"], eps2=tp["eps2"],
            nu_init=tp["nu_init"], huber=tp["huberThresh"],
            max_weight=tp["maxTSDFWeight"], assoc_sigma=tp["assocSigma"],
            alpha=tp["alpha"], uni_prior=tp["uniPrior"],
            max_iter=int(p["maxTrackingIter"]),
            max_recaptures=int(config["lm_max_recaptures"]),
            stride=int(p["tracking_stride"]) or 1,
            escale=max(int(p["estep_scale"]) or 1, 1),
            constvel=p["motion_model"] == "constvel",
            sampler="capture" if band else "gather", batched=band,
            obj_track_points=(max(int(p["obj_track_points"]), 0)
                              if band else 0),
            estep_obj_subset=int(p["estep_obj_subset"]),
            raycast_max_steps=int(p["raycast_max_steps"]),
            boundary=int(p["boundary"]),
            visibility=int(p["visibilityThresh"]),
            existence=float(p["existenceThresh"]),
            assoc_thresh=float(p["assocThresh"]),
            match_iou=float(p["matchIOUThresh"]),
            mask_min_pixels=int(p["mask_min_pixels"]),
            carve_dist=carve, carve_cap=cap,
            carve_margin=margin, volume_dtype=dt)

    @property
    def intr(self) -> torch.Tensor:
        return torch.tensor([[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy],
                             [0.0, 0.0, 1.0]], dtype=torch.float32)

    def lm_config(self) -> lm.LMConfig:
        return lm.LMConfig(self.tau, self.eps1, self.eps2, self.nu_init,
                           self.huber, self.max_weight, self.max_iter,
                           self.max_recaptures)


def preprocess(raw: torch.Tensor, cfg: RefConfig):
    """Bilateral filter, patching and the point map: (depth, points)."""
    d = ops.bilateral_filter_plain(raw, cfg.kernel_size, cfg.sigma_depth,
                                   cfg.sigma_spatial)
    d = torch.where(torch.isnan(d), 0.0, d)
    d = torch.where(raw == 0.0, 0.0, d)
    return d, ops.backproject_depth(d, cfg.intr)


def _rel(pose_vol: torch.Tensor, cam: torch.Tensor) -> torch.Tensor:
    return ops.pose_inverse(pose_vol) @ cam


def _culled(points, rel, vs, cfg: RefConfig):
    """An object's E-step point budget: the flat points, the indices of
    the ``estep_obj_subset`` points nearest its centre inside its box
    (a stable descending sort), and the inside flags."""
    ptsf = points.reshape(3, -1)
    po = rel[:3, :3].to(ptsf.device) @ ptsf \
        + rel[:3, 3].to(ptsf.device)[:, None]
    half = float(torch.tensor((cfg.obj_res - 1) / 2.0, dtype=torch.float32)
                 * torch.tensor(vs, dtype=torch.float32))
    inside = torch.all(torch.abs(po) <= half, dim=0) & (ptsf[2] > 0)
    score = torch.where(inside, -torch.sum(po * po, dim=0), -torch.inf)
    idx = torch.sort(score, descending=True, stable=True).indices[
        :cfg.estep_obj_subset]
    return ptsf, idx, inside


def _upsample(img, cfg: RefConfig):
    e = cfg.escale
    if e == 1:
        return img
    img = img.repeat_interleave(e, dim=-2).repeat_interleave(e, dim=-1)
    return img[..., :cfg.height, :cfg.width].contiguous()


def estep(points, st: dict, slots: List[int], cfg: RefConfig):
    """The association images (bg (H, W), objects (K, H, W)) of the
    background and the slots ``slots``, normalised per pixel."""
    e = cfg.escale
    pts = points[:, ::e, ::e].contiguous() if e > 1 else points
    grid = tuple(pts.shape[1:])
    rel = _rel(st["bg_pose"], st["cam_pose"])
    vx, vy, vz, valid = ops._grid_and_valid(pts, rel[:3, :3], rel[:3, 3],
                                            cfg.voxel, st["bg_tsdf"].shape, 1)
    psi = ops.trilinear_sample(st["bg_tsdf"], vx, vy, vz, valid)
    bg_w = ops.weights_from_samples(psi, cfg.trunc, cfg.assoc_sigma,
                                    cfg.alpha, cfg.uni_prior)
    K = cfg.max_objects
    obj_w = torch.zeros((K,) + grid, dtype=torch.float32, device=pts.device)
    for k in slots:
        rk = _rel(st["pose"][k], st["cam_pose"])
        vs = float(st["voxel_size"][k])
        sp, cull = pts, None
        if 0 < cfg.estep_obj_subset < pts[0].numel():
            ptsf, idx, inside = _culled(pts, rk, vs, cfg)
            sp, cull = ptsf[:, idx], (idx, inside)
        vol = st["tsdf"][k]
        vx, vy, vz, valid = ops._grid_and_valid(sp, rk[:3, :3], rk[:3, 3],
                                                vs, vol.shape, 1)
        psi = ops.trilinear_sample(vol, vx, vy, vz, valid)
        fg = ops.trilinear_fg_probs(st["fg_counts"][k], vx, vy, vz, valid)
        w = ops.weights_from_samples(psi, float(st["truncdist"][k]),
                                     cfg.assoc_sigma, cfg.alpha,
                                     cfg.uni_prior, fg)
        if cull is not None:
            idx, inside = cull
            out = torch.zeros(grid[0] * grid[1], dtype=torch.float32,
                              device=w.device)
            out[idx] = torch.where(inside[idx], w, 0.0)
            w = out.reshape(grid)
        obj_w[k] = w
    bg_n, obj_n = ops.normalize_associations(
        bg_w, obj_w, st["active"].to(pts.device))
    return _upsample(bg_n, cfg), _upsample(obj_n, cfg)


def _track_points(points, assoc, cfg: RefConfig):
    k = cfg.stride
    return points[:, ::k, ::k].reshape(3, -1), assoc[::k, ::k].reshape(-1)


def camera_start(st: dict, recorded: Dict[int, torch.Tensor],
                 cfg: RefConfig) -> torch.Tensor:
    """The camera LM's camera-to-volume start: the previous pose or, under
    the constant-velocity model, ``P[-2]^-1 P[-1]`` of the last two
    ``recorded`` poses after it."""
    pred = st["cam_pose"]
    if cfg.constvel and len(recorded) >= 2:
        f1, f2 = sorted(recorded)[-2:]
        # in NumPy, as the port's motion model computes it: a capture LM's
        # end can move by a tenth of a millimetre on a last-bit change of
        # its start (PERF.md, the camera look)
        delta = np.linalg.inv(recorded[f1].numpy()) @ recorded[f2].numpy()
        pred = pred @ torch.from_numpy(delta)
    return ops.reorthonormalize(ops.pose_inverse(st["bg_pose"]) @ pred)


def camera_lm(points, st: dict, recorded: Dict[int, torch.Tensor],
              cfg: RefConfig, start: Optional[torch.Tensor] = None):
    """(The camera pose (camera-to-world, host (4, 4)) after the camera LM,
    and ``fit(pose)``: how much worse a camera-to-world ``pose`` fits the
    LM's points than the reference's, :func:`~benchmark.reference.lm.
    excess` with the LM's last weights.) The LM starts at
    :func:`camera_start`, or at ``start`` where one is given."""
    pts, asc = _track_points(points, st["bg_assoc"], cfg)
    if start is None:
        start = camera_start(st, recorded, cfg)
    capture = cfg.sampler == "capture"
    rel, _, _, w = lm.track(st["bg_tsdf"], st["bg_weights"], cfg.voxel, pts,
                            asc, start, cfg.lm_config(), window=capture,
                            budget=cfg.max_recaptures if capture else 0)

    def fit(pose):
        return lm.excess(st["bg_tsdf"], cfg.voxel, pts, w, rel,
                         _rel(st["bg_pose"], pose.float()))
    return st["bg_pose"] @ rel, fit


# a slot's LM is taken as settled where, run again on its points scaled by
# 1 + SETTLE_SCALE, it ends within SETTLE_VOXELS of an object voxel
SETTLE_SCALE = 1e-6
SETTLE_VOXELS = 0.1


def object_lms(points, st: dict, slots: List[int], cfg: RefConfig):
    """Per slot (its object-to-world pose (host (4, 4)) after its LM, and
    ``fit(pose)``: how much worse an object-to-world ``pose`` fits the
    slot's LM points than the reference's, :func:`~benchmark.reference.lm.
    excess` with the LM's last weights; ``fit`` is None where the slot's
    LM is not settled: run again on its points scaled by 1 + 1e-6, it ends
    more than a tenth of an object voxel away, so that its pose is not
    determined to rounding). One LM per slot over every tracking point,
    or the batched LM's two fixed-window stages over the slot's
    ``obj_track_points`` points of highest association (a stable
    descending sort)."""
    out = {}
    k = cfg.stride
    ptsf = points[:, ::k, ::k].reshape(3, -1)
    cfgl = cfg.lm_config()
    cam = st["cam_pose"]
    for j in slots:
        start = ops.reorthonormalize(_rel(st["pose"][j], cam))
        asc = st["assoc"][j][::k, ::k].reshape(-1)
        vs = float(st["voxel_size"][j])
        pts = ptsf
        if cfg.batched:
            M = min(cfg.obj_track_points or ptsf.shape[1], ptsf.shape[1])
            idx = torch.sort(asc, descending=True, stable=True).indices[:M]
            pts, asc = ptsf[:, idx].contiguous(), asc[idx]

            def run(p):
                return lm.track_batched_slot(st["tsdf"][j], st["weights"][j],
                                             vs, p, asc, start, cfgl)
        else:
            capture = cfg.sampler == "capture"

            def run(p):
                rel, _, _, w = lm.track(
                    st["tsdf"][j], st["weights"][j], vs, p, asc, start, cfgl,
                    window=capture,
                    budget=cfg.max_recaptures if capture else 0)
                return rel, w
        rel, w = run(pts)
        again, _ = run(pts * (1.0 + SETTLE_SCALE))
        moved = float(torch.linalg.norm(ops.pose_inverse(rel)[:3, 3]
                                        - ops.pose_inverse(again)[:3, 3]))

        def fit(pose, j=j, pts=pts, w=w, rel=rel, vs=vs):
            return lm.excess(st["tsdf"][j], vs, pts, w, rel,
                             _rel(pose.float(), cam))
        out[j] = (cam @ ops.pose_inverse(rel),
                  fit if moved <= SETTLE_VOXELS * vs else None)
    return out


def raycast(st: dict, slots: List[int], cfg: RefConfig,
            rows: torch.Tensor) -> dict:
    """The raycast composite at the image rows ``rows``: the background and
    each slot (its weights masked to its foreground), the nearest object
    surface per pixel, the background where it is more than 5 cm nearer.
    (The per-slot pixel counts need the whole image and are left out.)"""
    W = cfg.width
    rel = _rel(st["bg_pose"], st["cam_pose"])
    bg = ops.raycast_volume_plain(
        st["bg_tsdf"], st["bg_weights"], rel[:3, :3], rel[:3, 3], cfg.intr,
        cfg.voxel, cfg.trunc, cfg.height, W, cfg.raycast_max_steps,
        rows=rows)
    obj_rcs = []
    for k in slots:
        rk = _rel(st["pose"][k], st["cam_pose"])
        masked = torch.where(ops.fg_probs(st["fg_counts"][k]) > 0.5,
                             st["weights"][k], 0.0)
        obj_rcs.append(ops.raycast_volume_plain(
            st["tsdf"][k], masked, rk[:3, :3], rk[:3, 3], cfg.intr,
            float(st["voxel_size"][k]), float(st["truncdist"][k]),
            cfg.height, W, cfg.raycast_max_steps, rows=rows))
    dev = bg["mask"].device
    h = bg["mask"].shape[0]
    near = ops.nearest_object(obj_rcs, slots, st["active"], h, W, dev)
    return ops.composite_raycasts(bg, obj_rcs, slots, st["object_id"],
                                  st["active"], 0, near)


def integrate(depth, st: dict, cfg: RefConfig):
    """The fused volumes: the background (with its carve rules) and every
    active, visible slot, from ``st``'s volumes (which are not changed).
    Returns {"bg": (tsdf, weights), k: (tsdf, weights)}."""
    cam_inv = ops.pose_inverse(st["cam_pose"])
    rel = cam_inv @ st["bg_pose"]
    out = {}
    t, w = st["bg_tsdf"].clone(), st["bg_weights"].clone()
    ops.integrate_tsdf_plain(t, w, depth, st["bg_assoc"], rel[:3, :3],
                             rel[:3, 3], cfg.intr, cfg.voxel, cfg.trunc,
                             cfg.max_weight, cfg.carve_dist, cfg.carve_cap,
                             cfg.carve_margin)
    out["bg"] = (t, w)
    for k in torch.nonzero(st["active"] & st["visible"]).flatten().tolist():
        rk = cam_inv @ st["pose"][k]
        t, w = st["tsdf"][k].clone(), st["weights"][k].clone()
        ops.integrate_tsdf_plain(t, w, depth, st["assoc"][k], rk[:3, :3],
                                 rk[:3, 3], cfg.intr,
                                 float(st["voxel_size"][k]),
                                 float(st["truncdist"][k]), cfg.max_weight)
        out[k] = (t, w)
    return out


def integrate_masks(st: dict, masks: Dict[int, torch.Tensor],
                    obj_masks: torch.Tensor, seg: torch.Tensor,
                    cfg: RefConfig) -> Dict[int, torch.Tensor]:
    """Each active slot's fg/bg counts after adding its object's mask
    (``masks``: object id -> (H, W) bool), except where another model
    occludes its own raycast mask (``obj_masks`` (K, H, W), ``seg``)."""
    out = {}
    cam_inv = ops.pose_inverse(st["cam_pose"])
    for k in range(cfg.max_objects):
        oid = int(st["object_id"][k])
        if not bool(st["active"][k]) or oid not in masks:
            continue
        mask = masks[oid]
        occl = obj_masks[k] & (seg != oid)
        rk = cam_inv @ st["pose"][k]
        out[k] = ops.integrate_fg_mask(
            st["tsdf"][k], st["weights"][k], st["fg_counts"][k], mask, occl,
            rk[:3, :3], rk[:3, 3], cfg.intr, float(st["voxel_size"][k]))
    return out


def cleanup(c: dict, cfg: RefConfig) -> Dict[int, bool]:
    """cleanUpObjs (``EMFusion.cpp:922-980``): per slot live at the frame's
    end, whether it is kept. ``c``: the frame's ``num_instances``,
    composite ``rc`` (None on the first frame), ``matches`` (object id ->
    mask), the slots' ``active``, ``object_id``, association images
    ``assoc``, the slots ``spawned`` this frame and each id's existence
    probability ``ex_prob``. A slot goes when its existence probability is
    under ``existenceThresh`` on a mask frame with detections, when it is
    visible and its association over its mask (its raycast mask, or'd
    with its matched mask where any visible slot was matched) is under
    ``assocThresh`` of the mask's pixels, or when it is not visible: at
    most ``visibilityThresh`` of its segment's pixels inside the image
    less a ``boundary`` margin."""
    rc = c["rc"]
    ids, active = c["object_id"], c["active"]
    live = [k for k in range(len(active)) if bool(active[k])]
    if rc is None:
        return {k: True for k in live}
    seg = rc["seg"]
    H, W = seg.shape
    b = cfg.boundary
    inner = torch.zeros((H, W), dtype=torch.bool, device=seg.device)
    inner[b:H - b, b:W - b] = True
    vis = {k: k in c["spawned"] or int(((seg == int(ids[k])) & inner).sum())
           > cfg.visibility for k in live}
    masks = rc["obj_masks"]
    if any(vis[k] and int(ids[k]) in c["matches"] for k in live):
        masks = masks.clone()
        for k in live:
            if vis[k] and int(ids[k]) in c["matches"]:
                masks[k] |= torch.as_tensor(
                    c["matches"][int(ids[k])]).to(masks.device)
    keep = {}
    for k in live:
        oid = int(ids[k])
        gone = c["num_instances"] > 0 and c["ex_prob"][oid] < cfg.existence
        if vis[k]:
            m = masks[k]
            cnt = float(m.sum())
            asum = float(torch.where(m, c["assoc"][k].to(m.device), 0.0)
                         .sum())
            gone = gone or cfg.assoc_thresh * cnt > asum
        keep[k] = vis[k] and not gone
    return keep

def match(c: dict, cfg: RefConfig) -> Dict[int, int]:
    """matchSegmentation (``EMFusion.cpp:418-455``): per object id, the
    index (in ``dets``) of the detection matched to it. ``c``: the frame's detection
    masks ``dets`` (the benchmark's own; their class is in neither class
    list, so only the size filter drops one), and at the step's start the
    composite's ``seg`` (None on the first frame), the slots' ``ids``,
    ``active`` and ``visible``, and ``frame``. A detection goes to the
    visible slot of highest IoU with the slot's segment, where that IoU
    exceeds ``matchIOUThresh``; where a second detection picks the same
    object, the better IoU keeps it and the detection that came second is
    left unmatched, as upstream has it."""
    dets = [i for i, m in enumerate(c["dets"])
            if int(m.sum()) >= cfg.mask_min_pixels]
    live = c["active"] & c["visible"]
    out: Dict[int, int] = {}
    if c["frame"] == 0 or c["seg"] is None or not live.any() or not dets:
        return out
    seg = c["seg"]
    iou = {}
    for i in dets:
        m = torch.as_tensor(c["dets"][i]).to(seg.device)
        row = []
        for k in range(len(live)):
            if not live[k]:
                row.append(0.0)
                continue
            obj = seg == int(c["ids"][k])
            inter = int((m & obj).sum())
            union = max(int((m | obj).sum()), 1)
            row.append(inter / union)
        iou[i] = row
    for i in dets:
        row = iou[i]
        k = max(range(len(row)), key=lambda j: (row[j], -j))
        if row[k] <= cfg.match_iou:
            continue
        oid = int(c["ids"][k])
        if oid in out:
            if row[k] > iou[out[oid]][k]:
                out[oid] = i
            continue
        out[oid] = i
    return out
