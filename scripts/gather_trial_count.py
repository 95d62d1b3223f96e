#!/usr/bin/env python3
"""How often a gather LM's trial step leaves no weighted point in the
volume, on the background path and the object path, on one card.

    python3 scripts/gather_trial_count.py

The gather sampler's trial reads ψ = 0 where a point falls outside
``[0, res - 1)`` of the volume (margin 1, ``geometry/sampling.py``), so
a step that carries every weighted point out of the volume would score
the error 0 of an empty sum and be accepted, as the fixed-cache LM's
escape from its windows was (fault F2, which ``lm.cu``'s guard repairs
for cache items only). This script counts how near the gather LMs come
to that. It drives ``chip_smoke.main_path`` (24 frames, the camera LM)
and ``chip_smoke.object_path`` (40 frames, the camera LM and the serial
object LMs); every call of ``tracking.run_lm_items`` that they make runs
as the path runs it (``lm_run``, whose result the pipeline keeps), then
once more on the same items as the split kernels, an iteration at a
time, and before each trial the script counts, per LM with a trial, its
points with ``w > 0`` whose ψ is valid at the trial pose (in front of
the camera, inside the volume at margin 1), and the weighted points.
The replay's launches are taken out of the launch counts again, so the
paths' own checks see only theirs; the replay's largest pose gap to the
path's LM and its iteration mismatches are reported (the split kernels
and ``lm_run`` end on the same bits).

Prints per path and LM kind (camera, objects) the trials, the trials
with no weighted point in the volume, the smallest share of the weighted
points in the volume at a trial, and the trials under 10% of them;
writes them to ``chiprun_out/gather_trial_count.json``. Needs a card;
imports nothing of JAX.
"""

import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    import chip_smoke as cs
    from emfusion_tpu_torch import kernels, tracking
    from emfusion_tpu_torch.config import load_config
    from emfusion_tpu_torch.geometry.sampling import transform_to_grid

    if not torch.cuda.is_available():
        raise SystemExit("gather_trial_count: no CUDA device")
    real = tracking.run_lm_items
    counts = []                      # per trial: (kind, weighted, in volume)
    replay = dict(gap=0.0, mismatches=0)

    def in_volume(it, R, t):
        vx, vy, vz, pz = transform_to_grid(it.points, R, t, it.voxel_size,
                                           tuple(it.tsdf.shape))
        Z, Y, X = it.tsdf.shape
        return ((pz > 0) & (vx >= 0) & (vy >= 0) & (vz >= 0)
                & (vx + 1 < X) & (vy + 1 < Y) & (vz + 1 < Z))

    def counted(items, cfg, group=None):
        res = real(items, cfg, group)
        if group is not None:
            return res
        seen = (dict(kernels.launches), kernels.launches_by_shape.copy())
        run = tracking.LMRun(items, cfg)
        for _ in range(cfg.max_iter):
            if not bool(run.running(run.si.cpu(), cfg).any()):
                break
            tracking.lm_system(run, cfg)
            tracking.lm_step(run, cfg, 0)
            si = run.si.cpu()
            for k in np.nonzero(si[:, tracking.SI_TRIAL].numpy())[0]:
                R, t = tracking._pose_of(run, int(k), tracking.SF_RN)
                w = run.w[run.point_slice(int(k))]
                inv = in_volume(items[k], R, t)
                counts.append((
                    "camera" if items[k].tsdf.numel() > 64 ** 3
                    else "objects",
                    int((w > 0).sum()), int(((w > 0) & inv).sum())))
            tracking.lm_trial(run, cfg)
            tracking.lm_step(run, cfg, 1)
        si, sf = run.read()
        for k, r in enumerate(res):
            pose = tracking._pose_mat(sf[k, :9].reshape(3, 3), sf[k, 9:12])
            replay["gap"] = max(replay["gap"],
                                float((pose - r["pose"]).abs().max()))
            replay["mismatches"] += int(si[k, tracking.SI_IT]) != \
                r["iterations"]
        kernels.launches.update(seen[0])
        kernels.launches_by_shape.clear()
        kernels.launches_by_shape.update(seen[1])
        return res

    tracking.run_lm_items = counted
    kernels.build()
    params = load_config(os.path.join(HERE, "configs", "default.cfg"))
    scene = cs.make_scene(params.height, params.width, params.fx)
    rng = np.random.default_rng(0)
    report, out = {}, dict(card=cs.card_line())
    frames = [cs.sensor_depth(scene.render(cs.gt_pose(i)), rng)
              for i in range(cs.N_FRAMES)]
    for path in ("background", "objects"):
        counts.clear()
        if path == "background":
            cs.main_path(torch, params, frames, report)
        else:
            cs.object_path(torch, params, scene, cs.OBJ_FRAMES, rng, report)
        res = {}
        for kind in ("camera", "objects"):
            c = [(w, v) for k, w, v in counts if k == kind and w > 0]
            if not c:
                continue
            share = [v / w for w, v in c]
            res[kind] = dict(trials=len(c),
                             empty=sum(1 for _, v in c if v == 0),
                             min_share=float(min(share)),
                             under_10pct=sum(1 for s in share if s < 0.1))
            print(f"{path} path, {kind} LMs: {res[kind]['trials']} trials, "
                  f"{res[kind]['empty']} with no weighted point in the "
                  f"volume, smallest share in the volume "
                  f"{res[kind]['min_share']:.4f}, "
                  f"{res[kind]['under_10pct']} under 10%", flush=True)
        out[path] = res
    out["replay"] = replay
    print(f"replay against the paths' LMs: largest pose gap "
          f"{replay['gap']:.3e}, iteration mismatches "
          f"{replay['mismatches']}", flush=True)
    print(out["card"], flush=True)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "gather_trial_count.json"),
              "w") as f:
        json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
