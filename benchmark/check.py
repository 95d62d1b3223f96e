"""How ``correct`` is decided: the run's frames against the plain reference.

Once the window has closed and the peak memory has been read, the run
goes on with the next frames of its stream through the same pipeline
object and the same entry (``process_frame`` and ``prefetch_depth``), and
follows ``check_frames`` of them (the next mask frame, the frame after
it, and one more drawn from the seed). :class:`Recorder` wraps the
pipeline object's stage methods for those frames only, and keeps, at each
stage's start, the state that stage reads (volumes, poses, association
images) and, at its end, what it produced. The reference
(``reference/frame.py``) works each stage out again from the frame's raw
depth and that state: the pipeline is followed stage by stage from its
own state, since a SLAM run left to itself drifts apart from any second
run within a few frames.

The numbers compared, each the largest over the checked frames:

* ``points``: the point map (m), after the bilateral filter (K5);
* ``assoc``: the three E-steps' background and object association
  images (K2 and the normalisation);
* ``cam_pose``: the camera LM's pose, as the excess of its fit over the
  reference pose's (``reference.lm.excess``: the RMS of ψ in TSDF units
  over the LM's points, with the reference LM's last weights). An LM
  that ends at the float32 noise floor may stop some iterations apart on
  a last-bit change (F3) and drift along a direction the points barely
  constrain; that costs no fit;
* ``obj_pose``: each live object's pose after its LM, as ``cam_pose``: a
  sphere turned about its centre fits as well, so its pose matrix may
  move along that turn on both sides. A slot whose reference LM is not
  settled (``reference.frame.object_lms``: run again on its points scaled
  by 1 + 1e-6 it ends more than a tenth of an object voxel away) is left
  out and counted in ``obj_unsettled``: there the LM's end depends on the
  last bits of its arithmetic, and the reference against itself reads as
  far off as the program does;
* ``obj_unsettled``: the most slots left out of ``obj_pose`` in one
  checked frame, so that a frame cannot pass ``obj_pose`` by leaving out
  every slot;
* ``raycast``: the composite's vertices (m) and normals at rows drawn from
  the seed, a pixel whose hit or segment differs counting 1 (K4);
* ``fused``: the fused background and object volumes (tsdf, weight over
  its cap) and the objects' foreground counts (K1 and the masks);
* ``lifecycle``: on a mask frame, the detections that the match step
  (``matchSegmentation``, ``EMFusion.cpp:418-455``) gave to another object
  than the reference does, and at each frame's end the objects that the
  cleanup kept or deleted against the rules of ``cleanUpObjs``
  (``EMFusion.cpp:922-980``) applied to the frame's composite,
  association images, matches and existence counts: an exact count of
  the pairs and slots decided otherwise. (The spawn and resize steps on
  a mask frame are followed, not checked: the stages after them start
  from the state they leave.)

The control (``frame_numbers(..., control=True)``) puts in the program's
place, stage by stage, the reference with its volumes stored in and its
result rounded to bfloat16, the nearest precision below the float32 that
the configurations state.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.reference import frame as ref

NUMBERS = ("points", "assoc", "cam_pose", "obj_pose", "obj_unsettled",
           "raycast", "fused", "lifecycle")


def bf16(x):
    """``x`` rounded to bfloat16 and read back as float32 (tensors, and the
    tensors of dicts and tuples)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.bfloat16).to(torch.float32) \
            if x.is_floating_point() else x
    if isinstance(x, dict):
        return {k: bf16(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(bf16(v) for v in x)
    return x


_VOLUMES = ("bg_tsdf", "bg_weights", "tsdf", "weights", "fg_counts")


def lower(st: dict) -> dict:
    """A state with its volumes stored in bfloat16 (the control's input)."""
    return {k: bf16(v) if k in _VOLUMES else v for k, v in st.items()}


def snapshot(pipe, volumes: bool = True) -> dict:
    """The pipeline's state as the reference reads it: copies, so that the
    frame's later stages do not change them. Volumes as float32."""
    s, o = pipe.state, pipe.state.objs
    st = dict(bg_pose=s.bg_pose.clone(), cam_pose=s.cam_pose.clone(),
              bg_assoc=s.bg_assoc.clone(), assoc=o.assoc.clone(),
              pose=o.pose.clone(), voxel_size=o.voxel_size.clone(),
              truncdist=o.truncdist.clone(), active=o.active.clone(),
              visible=o.visible.clone(), object_id=o.object_id.clone())
    if volumes:
        st.update(bg_tsdf=s.bg_tsdf.float().clone(),
                  bg_weights=s.bg_weights.float().clone(),
                  tsdf=o.tsdf.clone(), weights=o.weights.clone(),
                  fg_counts=o.fg_counts.clone())
    return st


class Recorder:
    """Wraps a pipeline object's stage methods for one frame and keeps each
    stage's input state and output. Use as a context manager."""

    def __init__(self, pipe):
        self.pipe = pipe
        self.rec: Dict[str, list] = {}
        self._saved = {}

    def _wrap(self, name, before, after):
        orig = getattr(self.pipe, name)

        def wrapped(*args, **kwargs):
            ctx = before(*args, **kwargs)
            out = orig(*args, **kwargs)
            self.rec.setdefault(name, []).append(after(ctx, out))
            return out
        self._saved[name] = orig
        setattr(self.pipe, name, wrapped)

    def __enter__(self):
        p = self.pipe
        self.start = snapshot(p)
        self.recorded = {f: torch.as_tensor(q) for f, q in p._poses.items()}
        self._wrap("preprocess", lambda raw: raw,
                   lambda raw, out: (raw, out[0].clone(), out[1].clone()))
        self._wrap("estep",
                   lambda pts, slots, fg_out=False: (snapshot(p, False),
                                                     list(slots)),
                   lambda c, out: (c[0], c[1], p.state.bg_assoc.clone(),
                                   p.state.objs.assoc.clone()))
        self._wrap("track_camera", lambda pts: snapshot(p, False),
                   lambda c, out: (c, p.state.cam_pose.clone()))
        self._wrap("track_objects",
                   lambda pts, slots: (snapshot(p, False), list(slots)),
                   lambda c, out: (c[0], c[1],
                                   p.state.objs.pose.clone()))
        self._wrap("raycast",
                   lambda slots, cam_pose=None: (snapshot(p, False),
                                                 list(slots)),
                   lambda c, out: (c[0], c[1],
                                   {k: v.clone() for k, v in out.items()}))
        self._wrap("integrate", lambda depth: snapshot(p),
                   lambda c, out: (c, snapshot(p)))
        self._wrap("integrate_masks",
                   lambda matches, rc: (snapshot(p), rc,
                                        {k: np.array(m) for k, m
                                         in matches.items()}),
                   lambda c, out: (c[0], c[1], c[2],
                                   p.state.objs.fg_counts.clone()))
        self._wrap("_clean_up_objs", self._cleanup_inputs,
                   lambda c, out: (c, p.state.objs.active.clone()))
        self._wrap("_init_or_match_objs", self._match_inputs,
                   self._match_outputs)
        return self

    def _match_inputs(self, rgb, points, rc, matches):
        p = self.pipe
        dets = p.mask_provider.detect(rgb, p.frame) or []
        return dict(frame=p.frame, dets=[np.array(d.mask) for d in dets],
                    seg=None if rc is None else rc["seg"].clone(),
                    ids=p._h_ids.copy(), active=p._h_active.copy(),
                    visible=p._h_visible.copy(), matches=matches)

    @staticmethod
    def _match_outputs(c, out):
        """The program's matches: per object id live before the step, the
        index of the detection whose mask it took."""
        before = {int(i) for i, a in zip(c["ids"], c["active"]) if a}
        matches = c.pop("matches")
        c["matched"] = {
            oid: next((j for j, d in enumerate(c["dets"])
                       if np.array_equal(d, np.asarray(m))), -1)
            for oid, m in matches.items() if oid in before}
        return c

    def _cleanup_inputs(self, num_instances, matches, rc, cnt=None,
                        asum=None):
        p = self.pipe
        o = p.state.objs
        return dict(num_instances=num_instances, rc=rc,
                    matches={k: np.array(m) for k, m in matches.items()},
                    active=o.active.clone(), object_id=o.object_id.clone(),
                    assoc=o.assoc.clone(), spawned=list(p._frame_spawned),
                    ex_prob={oid: m.ex_prob for oid, m in p.meta.items()})

    def __exit__(self, *exc):
        for name in self._saved:
            delattr(self.pipe, name)        # the class's method again
        return False


def _gap(a, b) -> float:
    if a.numel() == 0:
        return 0.0
    return float(torch.max(torch.abs(a.float() - b.float().to(a.device))))


def _state_with(base: dict, extra: dict) -> dict:
    out = dict(base)
    out.update(extra)
    return out


def frame_numbers(rec: Recorder, cfg: ref.RefConfig, rows: torch.Tensor,
                  control: bool = False) -> Dict[str, float]:
    """The numbers of one recorded frame: the program's outputs against the
    reference's, or with ``control`` the control's against the
    reference's (the lifecycle's decisions are the program's in both)."""
    vols = {k: rec.start[k] for k in _VOLUMES}
    lo = lower if control else (lambda s: s)
    cut = bf16 if control else (lambda x: x)
    dev = rec.start["bg_tsdf"].device
    n = dict.fromkeys(NUMBERS, 0.0)

    raw, depth_p, pts_p = rec.rec["preprocess"][0]
    raw_t = torch.as_tensor(np.asarray(raw, np.float32)).to(dev)
    depth_r, pts_r = ref.preprocess(raw_t, cfg)
    prog = cut(pts_r) if control else pts_p
    n["points"] = _gap(prog, pts_r)

    for st_e, slots, bg_p, obj_p in rec.rec.get("estep", []):
        st = _state_with(vols, st_e)
        bg_r, obj_r = ref.estep(pts_r, st, slots, cfg)
        if control:
            bg_p, obj_p = cut(ref.estep(pts_r, lo(st), slots, cfg))
        n["assoc"] = max(n["assoc"], _gap(bg_p, bg_r), _gap(obj_p, obj_r))

    for st_c, cam_p in rec.rec.get("track_camera", []):
        st = _state_with(vols, st_c)
        _, fit = ref.camera_lm(pts_r, st, rec.recorded, cfg)
        if control:
            cam_p = cut(ref.camera_lm(pts_r, lo(st), rec.recorded, cfg)[0])
        n["cam_pose"] = max(n["cam_pose"], fit(cam_p))

    for st_o, slots, pose_p in rec.rec.get("track_objects", []):
        st = _state_with(vols, st_o)
        got = ref.object_lms(pts_r, st, slots, cfg)
        if control:
            ctl = ref.object_lms(pts_r, lo(st), slots, cfg)
        for k, (pose_r, fit) in got.items():
            if fit is None:
                n["obj_unsettled"] += 1.0
                continue
            prog = cut(ctl[k][0]) if control else pose_p[k]
            n["obj_pose"] = max(n["obj_pose"], fit(prog))

    for st_r, slots, rc_p in rec.rec.get("raycast", []):
        st = _state_with(vols, st_r)
        rc_r = ref.raycast(st, slots, cfg, rows)
        if control:
            rc_c = cut(ref.raycast(lo(st), slots, cfg, rows))
        else:
            rc_c = {k: rc_p[k][..., rows.to(dev), :]
                    for k in ("vertices", "normals", "mask", "seg")}
        diff = max(_gap(rc_c["vertices"], rc_r["vertices"]),
                   _gap(rc_c["normals"], rc_r["normals"]))
        miss = bool(torch.any(rc_c["mask"] != rc_r["mask"])
                    or torch.any(rc_c["seg"] != rc_r["seg"]))
        n["raycast"] = max(n["raycast"], diff, float(miss))

    for st_b, st_a in rec.rec.get("integrate", []):
        st = lo(st_b) if control else st_b
        got = ref.integrate(depth_r, st_b, cfg)
        if control:
            low = ref.integrate(depth_r, st, cfg)
        for k, (t_r, w_r) in got.items():
            if control:
                t_p, w_p = bf16(low[k])
            elif k == "bg":
                t_p, w_p = st_a["bg_tsdf"], st_a["bg_weights"]
            else:
                t_p, w_p = st_a["tsdf"][k], st_a["weights"][k]
            n["fused"] = max(n["fused"], _gap(t_p, t_r),
                             _gap(w_p, w_r) / cfg.max_weight)

    for st_m, rc, matches, fg_p in rec.rec.get("integrate_masks", []):
        got_m = {k: torch.as_tensor(m).to(dev) for k, m in matches.items()}
        got = ref.integrate_masks(st_m, got_m, rc["obj_masks"], rc["seg"],
                                  cfg)
        if control:
            ctl = ref.integrate_masks(lo(st_m), got_m, rc["obj_masks"],
                                      rc["seg"], cfg)
        for k, fg_r in got.items():
            prog = bf16(ctl[k]) if control else fg_p[k]
            n["fused"] = max(n["fused"], _gap(prog, fg_r))

    for c in rec.rec.get("_init_or_match_objs", []):
        got = ref.match(c, cfg)
        n["lifecycle"] += float(len(set(got.items())
                                    ^ set(c["matched"].items())))

    for c, active_p in rec.rec.get("_clean_up_objs", []):
        keep = ref.cleanup(c, cfg)
        n["lifecycle"] += float(sum(
            bool(active_p[k]) != keep.get(k, bool(active_p[k]))
            for k in range(len(active_p))))
    return n


def judge(numbers: Dict[str, float], limits: dict) -> List[dict]:
    """Each number that the cell's limits name beside its limit, in
    :data:`NUMBERS`' order (a cell without objects has no object pose)."""
    out = []
    for name in (n for n in NUMBERS if n in limits):
        lim = limits[name]
        out.append(dict(name=name, value=float(numbers[name]),
                        limit=float(lim), ok=bool(numbers[name] <= lim)))
    return out


def merge(total: Optional[dict], one: dict) -> dict:
    if total is None:
        return dict(one)
    return {k: max(total[k], one[k]) for k in total}
