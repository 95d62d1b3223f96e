#!/usr/bin/env python3
"""The batched object LM against another checkout's, call by call, on the
accelerator path's own inputs, on one card, each traced iteration by
iteration.

    python3 scripts/batched_lm_vs_host_loop.py OTHER_TREE [--follow other]
    python3 scripts/batched_lm_vs_host_loop.py --alone
    python3 scripts/batched_lm_vs_host_loop.py --compare A.json B.json

Drives ``chip_smoke.accel_path`` of this checkout (float32, then bf16
backgrounds). Every call of ``tracking.track_volumes_batched`` that the
pipeline makes runs on its inputs twice: in this checkout, and in
``OTHER_TREE``'s own package, in a helper process that imports that
tree's ``emfusion_tpu_torch`` and builds its kernels there (the inputs
and results pass through files). Each side also traces the call
(:func:`trace`): the function's two fixed-cache stages rebuilt from its
module's ``stage_items`` and ``LMRun``, each stage's ``lm_run`` replayed
one launch an iteration with the state read after each (a chain of
launches ends on one launch's bits), which must end on the function's
poses. Per slot the trace counts the trials, the accepted ones, the
escapes (accepted trials at whose pose no point with ``w > 0`` has a
valid ψ, inside its window and the volume, so that the error there,
``err_new``, is the 0 of an empty sum; counted by :func:`window_count`,
the same on both sides), the trials that the empty-window guard rejected
(state word ``SI_NIN`` 0; only where the module has the guard), the
smallest share of the weighted points with a valid ψ at an accepted
trial and the largest accepted step in object voxels.

The pipeline goes on with ``--follow``'s result (this checkout's by
default, or the other's), so each call's comparison is on one set of
inputs. Prints per call each side's move of each slot from its start
(object voxels) and the two results' gap, then per path the slots moved
more than ``FAR_VOX`` object voxels in a call and, among them, those
with an escape, on each side (a gate of the path that fails is printed,
and the run goes on: two LMs run a frame, so the path's launch and read
limits do not hold); writes everything to
``chiprun_out/batched_vs_other_<follow>.json``. Needs a card; imports
nothing of JAX.

``--alone`` runs no other checkout: the accelerator paths of this
checkout alone, on the frames that ``scripts/ab_trees.py`` gives them
(its random draws taken in its order: the object path's frames, one
more depth, then these), each batched LM call traced as above and each
camera LM call's counts (iterations, re-captures, converged) kept beside
its pose (and, where the camera LM runs on the device, those of the host
loop ``tracking._track_volume_host`` on the same inputs), frame by frame,
into ``chiprun_out/traced_alone.json``. Run so in two
checkouts (each with this script), two such files hold each checkout's
own trajectory; ``--compare`` reads them (no card needed) and prints,
per path, the first frame where the camera poses or an object's moved
apart by more than ``SPLIT_M`` metres, with both sides' camera counts
and traces of that frame and of the frame before.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAR_VOX = 10.0
SPLIT_M = 1e-4


def window_count(it, w, R, t):
    """The points of cache item ``it`` with weight ``w > 0`` whose ψ is
    valid at the pose (R, t): in front of the camera, inside the volume at
    margin 1 and inside their window (local coordinates in [0, 4])."""
    import torch
    p = it.points
    Z, Y, X = it.tsdf.shape
    v = (R.to(p.device) @ p + t.to(p.device)[:, None]) / it.voxel_size \
        + torch.tensor([(X - 1) / 2, (Y - 1) / 2, (Z - 1) / 2],
                       device=p.device)[:, None]
    loc = v - it.anchor.to(torch.float32)
    ok = ((p[2] > 0) & (v >= 0).all(0) & (v[0] + 1 < X) & (v[1] + 1 < Y)
          & (v[2] + 1 < Z) & ((loc >= 0) & (loc <= 4)).all(0))
    return int((ok & (w > 0)).sum()), int((w > 0).sum())


def trace(tr, tsdfs, weights, vs, points, assoc, rel, cfg, active):
    """``tr.track_volumes_batched``'s stages, each ``lm_run`` replayed a
    launch an iteration (see the module's docstring). Returns (poses
    (S, 4, 4) host float32, per slot a dict of counts)."""
    import torch
    f32 = torch.float32
    vs = torch.as_tensor(vs, dtype=f32).cpu()
    rel = torch.as_tensor(rel, dtype=f32).cpu()
    active = torch.as_tensor(active, dtype=torch.bool).cpu()
    S = points.shape[0]
    R, t = rel[:, :3, :3].clone(), rel[:, :3, 3].clone()
    nin = getattr(tr, "SI_NIN", None)
    out = [dict(trials=0, accepted=0, escapes=0, guard_rejects=0,
                min_share=None, max_step_vox=0.0) for _ in range(S)]
    half = max(cfg.max_iter // 2, 1)
    cap = (tr.kernels.library("lm_run").emf_max_items() if points.is_cuda
           else tr.LM_MAX_ITEMS)
    converged = ~active
    todo = torch.nonzero(active).flatten()
    for budget in (half, cfg.max_iter - half):
        if not len(todo):
            break
        scfg = dataclasses.replace(cfg, max_iter=budget)
        for part in torch.split(todo, cap):
            slots = part.tolist()
            items = tr.stage_items(tsdfs, weights, vs, points, assoc, R, t,
                                   slots)
            run = tr.LMRun(items, scfg)
            si0, sf0 = run.read()
            for _ in range(budget):
                if not bool(run.running(si0, scfg).any()):
                    break
                tr.lm_run(run, scfg, 1)
                si, sf = run.read()
                for j, k in enumerate(slots):
                    ran = int(si[j, tr.SI_IT]) > int(si0[j, tr.SI_IT])
                    if not ran or si[j, tr.SI_CONV]:
                        continue                 # no trial this iteration
                    o = out[k]
                    o["trials"] += 1
                    ok = bool(si[j, tr.SI_EVAL])
                    if nin is not None and int(si[j, nin]) == 0:
                        o["guard_rejects"] += 1
                    if not ok:
                        continue
                    o["accepted"] += 1
                    n_in, n_w = window_count(
                        items[j], run.w[run.point_slice(j)],
                        sf[j, tr.SF_R:tr.SF_R + 9].reshape(3, 3),
                        sf[j, tr.SF_T:tr.SF_T + 3])
                    o["escapes"] += n_in == 0
                    share = n_in / max(n_w, 1)
                    o["min_share"] = share if o["min_share"] is None \
                        else min(o["min_share"], share)
                    step = float((sf[j, tr.SF_T:tr.SF_T + 3]
                                  - sf0[j, tr.SF_T:tr.SF_T + 3]).norm()
                                 / vs[k])
                    o["max_step_vox"] = max(o["max_step_vox"], step)
                si0, sf0 = si, sf
            R[part] = sf0[:, tr.SF_R:tr.SF_R + 9].reshape(-1, 3, 3)
            t[part] = sf0[:, tr.SF_T:tr.SF_T + 3]
            converged[part] = si0[:, tr.SI_CONV] != 0
        todo = todo[~converged[todo]]
    return tr._pose_mat(R, t), out


def summary(tr, args, pose, stats):
    """A side's result of a call: poses, counts and the trace."""
    traced, per_slot = trace(tr, *args)
    if not bool((traced == pose).all()):
        raise RuntimeError("batched_lm_vs_host_loop: the trace left the "
                           "function's poses")
    return dict(pose=pose, trace=per_slot,
                **{k: stats[k].tolist() for k in (
                    "iterations", "converged", "recaptures",
                    "dropped_points")})


def serve(tree):
    """The helper process: ``OTHER_TREE``'s package; per request line (a
    file of the call's inputs) its ``track_volumes_batched`` and trace,
    written beside it; "done" on its standard output."""
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch

    from emfusion_tpu_torch import kernels, tracking
    if torch.cuda.is_available():
        kernels.build()
    print("ready", flush=True)
    for line in sys.stdin:
        req = line.strip()
        args = torch.load(req, weights_only=False)
        cfg = tracking.TrackConfig(**args[6])
        call = tuple(args[:6]) + (cfg, args[7])
        pose, st = tracking.track_volumes_batched(*call)
        torch.save(summary(tracking, call, pose, st), req + ".out")
        print("done", flush=True)


def alone(torch, cs, tracking, pipeline, params, frames, masks):
    """``--alone``: this checkout's accelerator paths, traced frame by
    frame (see the module's docstring); returns what the file holds."""
    out = {}

    def counts(pose, st):
        return dict(pose=pose, **{k: int(st[k]) for k in (
            "iterations", "recaptures", "converged")})

    def camera(*args):
        pose, st = tracking.track_volume(*args)
        rec[-1]["camera"] = counts(pose, st)
        if hasattr(tracking, "track_volumes_capture"):   # a device form
            rec[-1]["camera"]["host_loop"] = counts(
                *tracking._track_volume_host(*args))
        return pose, st

    def batched(*call):
        pose, st = tracking.track_volumes_batched(*call)
        rec[-1]["objects"] = dict(
            start=torch.as_tensor(call[5], dtype=torch.float32).cpu(),
            vs=torch.as_tensor(call[2], dtype=torch.float32).cpu(),
            **summary(tracking, call, pose, st))
        return pose, st

    def frame(self, *a, **k):
        rec.append({})
        return process(self, *a, **k)

    process = pipeline.EMFusionPipeline.process_frame
    pipeline.track_volume = camera
    pipeline.track_volumes_batched = batched
    pipeline.EMFusionPipeline.process_frame = frame
    report = {}
    for key, dtype in (("accel_path", "auto"),
                       ("accel_path_bf16", "bfloat16")):
        rec = []
        try:
            cs.accel_path(torch, params, frames, masks, report, key=key,
                          volume_dtype=dtype)
        except RuntimeError as e:           # a gate of the path
            print(f"{key}: gate failed: {e}", flush=True)
        out[key] = rec
        print(f"{key}: {len(rec)} frames traced", flush=True)
    return out


def compare(a_path, b_path):
    """``--compare``: the first frame where two ``--alone`` files'
    trajectories split, per path (see the module's docstring)."""
    import numpy as np
    runs = [json.load(open(p)) for p in (a_path, b_path)]
    print(f"A {a_path}: {runs[0]['card']}; B {b_path}: {runs[1]['card']}")

    def world(fr):
        """The camera pose and each slot's object pose (camera pose times
        the inverse of its camera-to-object pose) of a frame."""
        cam = np.asarray(fr["camera"]["pose"], dtype=np.float64) \
            if "camera" in fr else np.eye(4)
        objs = [cam @ np.linalg.inv(np.asarray(r, dtype=np.float64))
                for r in fr.get("objects", {}).get("pose", [])]
        return cam, objs

    def counts(fr):
        c = fr.get("camera", {})
        o = fr.get("objects", {})
        host = c.get("host_loop")
        if host is not None:
            gap = float(np.abs(np.asarray(host["pose"])
                               - np.asarray(c["pose"])).max())
            host = dict({k: host[k] for k in (
                "iterations", "recaptures", "converged")}, pose_gap=gap)
        return dict(camera=dict({k: c.get(k) for k in (
            "iterations", "recaptures", "converged")}, host_loop=host),
            objects=dict(iterations=o.get("iterations"),
                         recaptures=o.get("recaptures"),
                         dropped_points=o.get("dropped_points"),
                         trace=o.get("trace")))

    for key in runs[0]["runs"]:
        fa, fb = runs[0]["runs"][key], runs[1]["runs"][key]
        split = None
        for f, (ra, rb) in enumerate(zip(fa, fb)):
            (ca, oa), (cb, ob) = world(ra), world(rb)
            gaps = dict(camera=float(np.abs(ca - cb)[:3, 3].max()),
                        objects=[float(np.linalg.norm(x[:3, 3] - y[:3, 3]))
                                 for x, y in zip(oa, ob)])
            least = [[None if t["min_share"] is None
                      else round(t["min_share"], 4) for t in
                      r.get("objects", {}).get("trace", [])]
                     for r in (ra, rb)]
            print(f"{key} frame {f}: camera gap {gaps['camera']:.3e} m, "
                  f"object gaps {[f'{g:.3e}' for g in gaps['objects']]} m; "
                  f"least share A {least[0]} B {least[1]}", flush=True)
            if split is None and max([gaps["camera"]] + gaps["objects"]) \
                    > SPLIT_M:
                split = f
        if split is None:
            print(f"{key}: no split past {SPLIT_M} m")
            continue
        print(f"{key}: first split past {SPLIT_M} m at frame {split}")
        for f in (split - 1, split):
            for who, fr in (("A", fa[f]), ("B", fb[f])):
                print(f"  frame {f} {who}: {json.dumps(counts(fr))}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", nargs="?")
    ap.add_argument("--follow", choices=["this", "other"], default="this")
    ap.add_argument("--alone", action="store_true")
    ap.add_argument("--compare", nargs=2, metavar="JSON")
    ap.add_argument("--serve", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.compare:
        return compare(*args.compare)
    if args.serve:
        return serve(os.path.abspath(args.other))
    if not args.alone and not args.other:
        ap.error("OTHER_TREE, --alone or --compare")
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    import chip_smoke as cs
    from emfusion_tpu_torch import kernels, pipeline, tracking
    from emfusion_tpu_torch.config import load_config

    if not torch.cuda.is_available():
        raise SystemExit("batched_lm_vs_host_loop: no CUDA device")
    params = load_config(os.path.join(HERE, "configs", "default.cfg"))
    scene = cs.make_scene(params.height, params.width, params.fx)
    rng = np.random.default_rng(0)
    if args.alone:
        cs.object_scene(scene, params, cs.OBJ_FRAMES, rng)
        f = cs.OBJ_FRAMES
        cs.sensor_depth(scene.render(cs.gt_pose(f), cs.movers_at(f))[0],
                        rng)
    frames, masks = cs.object_scene(scene, params, cs.ACCEL_FRAMES, rng)
    if args.alone:
        kernels.build()
        runs = alone(torch, cs, tracking, pipeline, params, frames, masks)
        os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
        with open(os.path.join(HERE, "chiprun_out", "traced_alone.json"),
                  "w") as f:
            json.dump(dict(tree=HERE, card=cs.card_line(), runs=runs), f,
                      default=lambda x: x.tolist())
        return 0
    helper = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), args.other, "--serve"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    if helper.stdout.readline().strip() != "ready":
        raise RuntimeError("batched_lm_vs_host_loop: the helper failed")
    tmp = tempfile.TemporaryDirectory(prefix="batched_vs_other_")
    calls = []

    def angle(a, b):
        d = a[:3, :3].double().T @ b[:3, :3].double()
        v = torch.stack([d[2, 1] - d[1, 2], d[0, 2] - d[2, 0],
                         d[1, 0] - d[0, 1]])
        return float(torch.arcsin(torch.clamp(v.norm() / 2.0, max=1.0)))

    def both(tsdfs, weights, vs, points, assoc, rel, cfg, active):
        call = ([x.clone() for x in tsdfs], [x.clone() for x in weights],
                vs, points, assoc, rel, cfg, active)
        pose, st = tracking.track_volumes_batched(*call)
        mine = summary(tracking, call, pose, st)
        req = os.path.join(tmp.name, f"call{len(calls)}.pt")
        torch.save(call[:6] + (dataclasses.asdict(cfg), active), req)
        helper.stdin.write(req + "\n")
        helper.stdin.flush()
        if helper.stdout.readline().strip() != "done":
            raise RuntimeError("batched_lm_vs_host_loop: the helper failed")
        theirs = torch.load(req + ".out", weights_only=False)
        os.remove(req)
        os.remove(req + ".out")
        vsh = torch.as_tensor(vs, dtype=torch.float32).cpu()
        start = torch.as_tensor(rel, dtype=torch.float32).cpu()
        S = len(pose)
        rec = dict(
            trans_gap_vox=[float((mine["pose"][k, :3, 3]
                                  - theirs["pose"][k, :3, 3]).norm()
                                 / vsh[k]) for k in range(S)],
            rot_gap=[angle(mine["pose"][k], theirs["pose"][k])
                     for k in range(S)])
        for who, r in (("this", mine), ("other", theirs)):
            rec[f"moved_{who}_vox"] = [
                float((r["pose"][k, :3, 3] - start[k, :3, 3]).norm()
                      / vsh[k]) for k in range(S)]
            for key in ("iterations", "converged", "recaptures",
                        "dropped_points", "trace"):
                rec[f"{key}_{who}"] = r[key]
        calls.append(rec)
        moved = [[round(v, 3) for v in rec[f"moved_{who}_vox"]]
                 for who in ("this", "other")]
        print(f"call {len(calls)}: moved {moved[0]} / {moved[1]} voxels "
              f"(this / other), gap {max(rec['trans_gap_vox']):.3e} voxel, "
              f"{max(rec['rot_gap']):.3e} rad; escapes "
              f"{[s['escapes'] for s in rec['trace_this']]} / "
              f"{[s['escapes'] for s in rec['trace_other']]}; guard "
              f"rejections {[s['guard_rejects'] for s in rec['trace_this']]}"
              f"; iterations {rec['iterations_this']} / "
              f"{rec['iterations_other']}", flush=True)
        if args.follow == "this":
            return pose, st
        return (theirs["pose"], dict(
            st, **{k: torch.tensor(theirs[k]) for k in (
                "iterations", "converged", "recaptures")}))

    pipeline.track_volumes_batched = both
    kernels.build()
    report, out = {}, {}
    try:
        for key, dtype in (("accel_path", "auto"),
                           ("accel_path_bf16", "bfloat16")):
            calls.clear()
            print(f"{key}: following {args.follow}", flush=True)
            failed = None
            try:
                cs.accel_path(torch, params, frames, masks, report, key=key,
                              volume_dtype=dtype)
            except RuntimeError as e:       # a gate of the path
                failed = str(e)
                print(f"{key}: gate failed: {failed}", flush=True)
            far = {}
            for who in ("this", "other"):
                slots = [(c[f"moved_{who}_vox"][k],
                          c[f"trace_{who}"][k]["escapes"])
                         for c in calls for k in range(len(c["trace_this"]))]
                far[who] = dict(
                    moved=sum(m > FAR_VOX for m, _ in slots),
                    with_escape=sum(m > FAR_VOX and e > 0 for m, e in slots),
                    escapes=sum(e for _, e in slots))
            guard = sum(s["guard_rejects"] for c in calls
                        for s in c["trace_this"])
            print(f"{key}: {len(calls)} calls; slots moved more than "
                  f"{FAR_VOX} object voxels in a call (with an escape): "
                  f"this {far['this']['moved']} "
                  f"({far['this']['with_escape']}), other "
                  f"{far['other']['moved']} ({far['other']['with_escape']});"
                  f" escapes in all: this {far['this']['escapes']}, other "
                  f"{far['other']['escapes']}; this checkout's guard "
                  f"rejections {guard}", flush=True)
            out[key] = dict(calls=list(calls), gate_failed=failed, far=far,
                            guard_rejects=guard,
                            live=report.get(key, {}).get("live_objects"),
                            recovery={o: v["recovery"] for o, v in
                                      report.get(key, {}).get(
                                          "recovery", {}).items()})
    finally:
        helper.stdin.close()
        helper.wait(timeout=60)
        tmp.cleanup()
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out",
                           f"batched_vs_other_{args.follow}.json"),
              "w") as f:
        json.dump(dict(follow=args.follow, card=cs.card_line(), runs=out), f,
                  default=lambda x: x.tolist())
    return 0


if __name__ == "__main__":
    sys.exit(main())
