#!/usr/bin/env python3
"""Two checkouts of the port on one card, in turns: the frame loops whose
LMs run on the device, and the holds of the gather LM's ``lm_run``.

    python3 scripts/ab_trees.py TREE [TREE ...]

Runs each TREE (a checkout's root, e.g. ``git archive`` unpacked under
``archive_tree/``) in its own process, in the order given (parent,
change, change, parent compares two versions within one call). Each
process imports that tree's ``chip_smoke.py`` and package, builds the
kernels there and, on one seed's scene, drives:

  * the object path (``chip_smoke.object_path``, 40 frames, the gather
    sampler's LMs as ``lm_run`` tables), then holds ``lm_run`` over the
    next frame's camera LM and its serial object LMs' table
    (``chip_smoke.hold_lm_run``: ms an iteration within a launch run to
    the LMs' stop);
  * the accelerator path, float32 then with bf16 backgrounds
    (``chip_smoke.accel_path``, 40 frames each; its gates as that
    tree's script sets them), then its cache LMs on the next frame
    (:func:`cache_lm_times`: the camera's capture LM and the batched
    LM's first stage, device ms an iteration).

Prints one line per tree, ``ab {json}``: the e2e ms a frame (frames 1..)
and ``track_camera`` / ``track_objects`` ms a call of each path, the
``lm_run`` holds' ms an iteration, the batched LM's and the camera LM's
reads a call where the tree reports them, the accelerator paths' camera
ATE, and the card's name and power limit; and writes
the same with each accelerator path's camera and object poses frame by
frame to ``chiprun_out/ab_<run>.json``, where two trees' trajectories
can be compared. Needs a card; imports nothing of JAX.
"""

import argparse
import json
import os
import subprocess
import sys
import time


def cache_lm_times(torch, cs, pipe, scene, reps=15):
    """Device ms an iteration (CUDA events, median of ``reps`` runs from
    a fresh state) of the accelerator path's cache LMs on the next
    frame's points: the camera's capture LM from ``CAPTURE_HOLD_OFFSET``
    voxels off its start (``tracking.capture_table``: its launches, K3
    and reads) and the batched LM's first-stage table of the live slots
    (one ``lm_run`` of ``max_iter`` iterations)."""
    import dataclasses

    import numpy as np

    from emfusion_tpu_torch import tracking as tr
    f = pipe.frame
    rng = np.random.default_rng(f)
    _, points = pipe.preprocess(cs.sensor_depth(scene.render(
        cs.gt_pose(f), cs.movers_at(f))[0], rng))
    it = pipe.camera_lm_item(points)
    start = torch.as_tensor(it.rel_pose, dtype=torch.float32).clone()
    start[0, 3] += cs.CAPTURE_HOLD_OFFSET * pipe.voxel
    cam = tr.capture_items([dataclasses.replace(it, rel_pose=start)])
    cfg = pipe.track_cfg
    live = [int(k) for k in np.nonzero(pipe._h_active)[0]]
    items, stage_cfg = cs.stage_table(torch, pipe, points, live)

    def timed(fn):
        times, iters = [], 0
        for _ in range(reps + 1):        # the first run loads the kernel
            run = fn()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run = run()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
            iters = int(run.si[:, tr.SI_IT].max())
        return float(np.median(times[1:])) / max(iters, 1), iters

    def camera():
        fresh = [dataclasses.replace(c, cache=c.cache.clone(),
                                     anchor=c.anchor.clone()) for c in cam]
        return lambda: tr.capture_table(fresh, cfg)[0]

    def stage():
        run = tr.LMRun(items, stage_cfg)

        def go():
            tr.lm_run(run, stage_cfg, stage_cfg.max_iter)
            return run
        return go
    cam_ms, cam_it = timed(camera)
    stage_ms, stage_it = timed(stage)
    return dict(camera_lm_ms=cam_ms, camera_lm_iterations=cam_it,
                stage_lm_ms=stage_ms, stage_lm_iterations=stage_it)


def one(tree):
    """The runs of one tree; returns its numbers."""
    sys.path.insert(0, tree)
    os.chdir(tree)
    import numpy as np
    import torch

    import chip_smoke as cs
    from emfusion_tpu_torch import kernels
    from emfusion_tpu_torch.config import load_config

    if not torch.cuda.is_available():
        raise SystemExit("ab_trees: no CUDA device")
    kernels.build()
    params = load_config(os.path.join(tree, "configs", "default.cfg"))
    scene = cs.make_scene(params.height, params.width, params.fx)
    rng = np.random.default_rng(0)
    report = {}
    out = dict(tree=tree, card=cs.card_line())
    _, pipe, _, _ = cs.object_path(torch, params, scene, cs.OBJ_FRAMES, rng,
                                   report)
    r = report["object_path"]
    ph = r["phase_ms_per_call"]
    out.update(object_e2e=r["e2e_ms_per_frame"],
               object_track_camera=ph["track_camera"],
               object_track_objects=ph["track_objects"],
               object_phases=ph, object_e2e_frames=r["e2e_ms"],
               object_lm_iterations=r["lm_iterations"])
    f = cs.OBJ_FRAMES
    depth = cs.sensor_depth(scene.render(cs.gt_pose(f), cs.movers_at(f))[0],
                            rng)
    _, points = pipe.preprocess(depth)
    live = [int(k) for k in np.nonzero(pipe._h_active)[0]]
    for name, items in (("camera", [pipe.camera_lm_item(points)]),
                        ("objects", pipe.object_lm_items(points, live))):
        row = cs.hold_lm_run(torch, items, pipe.track_cfg)
        out[f"lm_run_{name}_ms"] = row["ms"]
        out[f"lm_run_{name}_iterations"] = row["run_iterations"]
        out[f"lm_run_{name}_exact"] = row["max_abs_err"] <= row["tol"]
    del pipe
    torch.cuda.empty_cache()
    frames, masks = cs.object_scene(scene, params, cs.ACCEL_FRAMES, rng)
    poses = {}
    for key, dtype in (("accel_path", "auto"),
                       ("accel_path_bf16", "bfloat16")):
        _, pipe = cs.accel_path(torch, params, frames, masks, report,
                                key=key, volume_dtype=dtype)
        r = report[key]
        ph = r["phase_ms_per_call"]
        out.update({f"{key}_e2e": r["e2e_ms_per_frame"],
                    f"{key}_track_camera": ph["track_camera"],
                    f"{key}_track_objects": ph["track_objects"],
                    f"{key}_reads_a_call": r.get(
                        "host_reads_per_batched_call_mean"),
                    f"{key}_camera_reads_a_call": r.get(
                        "camera_lm_host_reads_mean"),
                    f"{key}_ate": r["ate"]["rmse"],
                    f"{key}_live": r["live_objects"],
                    f"{key}_phases": ph,
                    f"{key}_recovery": {o: v["recovery"] for o, v in
                                        r["recovery"].items()}})
        out.update({f"{key}_{k}": v for k, v in
                    cache_lm_times(torch, cs, pipe, scene).items()})
        poses[key] = dict(
            camera={int(f): np.asarray(q).tolist()
                    for f, q in pipe.poses.items()},
            objects={int(o): {int(f): np.asarray(q).tolist()
                              for f, q in t.items()}
                     for o, t in pipe.obj_poses.items()})
        del pipe
        torch.cuda.empty_cache()
    return out, poses


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--one", metavar="JSON",
                    help="run the first tree in this process and write "
                         "its numbers and poses to JSON")
    args = ap.parse_args()
    if args.one:
        out, poses = one(os.path.abspath(args.trees[0]))
        with open(args.one, "w") as f:
            json.dump(dict(out, poses=poses), f)
        print("ab " + json.dumps(out), flush=True)
        return 0
    os.makedirs("chiprun_out", exist_ok=True)
    rc = 0
    for i, tree in enumerate(args.trees):
        t0 = time.perf_counter()
        dump = os.path.abspath(os.path.join("chiprun_out",
                                            f"ab_{i + 1}.json"))
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", dump,
             tree], capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("ab ")]
        print(f"run {i + 1} {tree} rc={proc.returncode} "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        print("\n".join(lines) if lines else proc.stdout[-3000:]
              + proc.stderr[-3000:], flush=True)
        rc = rc or proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
