"""A look at the camera LM of a checked frame, for ``readings.py --look``
(the benchmark's own runs do not run it).

Witnesses of the frame's camera pose beside the program's on the card:
the reference (``reference.frame.camera_lm``), the reference again on its
points scaled by 1 + ``SETTLE_SCALE`` (how far the LM's end moves on a
last-bit change of its input), the reference from the program's own start
pose (``item_start``; ``start_gap`` is the largest difference of the two
starts' entries), and the port's own plain path on the CPU (``tracking.
track_volume`` on a host copy of the program's LM item).
Each is given as its excess fit over the reference's pose (the check's
``cam_pose`` measure) and as the distance (mm) of its camera centre from
the reference's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference import frame as ref


class CameraItems:
    """Wraps ``pipe.camera_lm_item`` for one frame and keeps a host copy of
    the item the program's camera LM ran on. Use as a context manager."""

    def __init__(self, pipe):
        self.pipe, self.items = pipe, []

    def __enter__(self):
        orig = self.pipe.camera_lm_item

        def wrapped(points):
            it = orig(points)
            self.items.append(dataclasses.replace(it, **{
                f.name: getattr(it, f.name).detach().cpu().clone()
                for f in dataclasses.fields(it)
                if isinstance(getattr(it, f.name), torch.Tensor)}))
            return it
        self.pipe.camera_lm_item = wrapped
        return self

    def __exit__(self, *exc):
        del self.pipe.camera_lm_item        # the class's method again
        return False


def camera(rec, cfg: ref.RefConfig, item, track_cfg, frame: int) -> dict:
    """The look at the camera LM of frame ``frame``, which ``rec``
    recorded."""
    from emfusion_tpu_torch.tracking import track_volume
    raw, _, _ = rec.rec["preprocess"][0]
    dev = rec.start["bg_tsdf"].device
    _, pts = ref.preprocess(torch.as_tensor(np.asarray(raw, np.float32))
                            .to(dev), cfg)
    (st_c, card), = rec.rec["track_camera"]
    st = dict(rec.start)
    st.update(st_c)
    pose_r, fit = ref.camera_lm(pts, st, rec.recorded, cfg)
    pose_s, _ = ref.camera_lm(pts * (1.0 + ref.SETTLE_SCALE), st,
                              rec.recorded, cfg)
    start = ref.camera_start(st, rec.recorded, cfg)
    pose_i, _ = ref.camera_lm(pts, st, rec.recorded, cfg,
                              start=item.rel_pose)
    rel, stats = track_volume(item.tsdf, item.weights, item.voxel_size,
                              item.points, item.assoc, item.rel_pose,
                              track_cfg)
    pose_c = st["bg_pose"].cpu().float() @ rel.float()

    def mm(pose):
        return 1e3 * float(torch.linalg.norm(
            pose.float().cpu()[:3, 3] - pose_r.float().cpu()[:3, 3]))

    def deg(pose):
        r = pose.float().cpu()[:3, :3] @ pose_r.float().cpu()[:3, :3].T
        c = float(torch.clamp((torch.trace(r) - 1.0) / 2.0, -1.0, 1.0))
        return float(np.degrees(np.arccos(c)))
    return dict(frame=int(frame), card=fit(card), scaled=fit(pose_s),
                cpu=fit(pose_c), item_start=fit(pose_i), card_mm=mm(card),
                scaled_mm=mm(pose_s), cpu_mm=mm(pose_c),
                item_start_mm=mm(pose_i), card_deg=deg(card),
                scaled_deg=deg(pose_s), cpu_deg=deg(pose_c),
                start_gap=float(torch.max(torch.abs(
                    start.float().cpu() - item.rel_pose.float()))),
                cpu_card_mm=1e3 * float(torch.linalg.norm(
                    pose_c[:3, 3] - card.float().cpu()[:3, 3])),
                cpu_iterations=int(stats["iterations"]),
                voxel_mm=1e3 * cfg.voxel)

