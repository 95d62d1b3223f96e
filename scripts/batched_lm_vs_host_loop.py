#!/usr/bin/env python3
"""The batched object LM against another checkout's, call by call, on the
accelerator path's own inputs, on one card.

    python3 scripts/batched_lm_vs_host_loop.py OTHER_TREE [--follow other]

Drives ``chip_smoke.accel_path`` of this checkout (float32, then bf16
backgrounds). Every call of ``tracking.track_volumes_batched`` that the
pipeline makes runs twice on the same inputs: this checkout's, and the
function of ``OTHER_TREE/emfusion_tpu_torch/tracking.py`` (loaded as a
module of its own; its imports resolve to this checkout's package, whose
capture, sampling and SE(3) code it shares). The pipeline goes on with
``--follow``'s result (this checkout's by default, or the other's), so
each frame's comparison is on one set of inputs. Prints per call the
largest translation gap in object voxels and rotation gap in radians
between the two results, how far each result moved each slot from its
start (object voxels), and each slot's iterations, converged flag,
re-captures and dropped points from both, then the path's usual lines (a gate of the
path that fails is printed, and the run goes on: following the other
checkout, its reads are its own); writes the calls to
``chiprun_out/batched_vs_other_<follow>.json``. Needs a card; imports
nothing of JAX.
"""

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other")
    ap.add_argument("--follow", choices=["this", "other"], default="this")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    import chip_smoke as cs
    from emfusion_tpu_torch import kernels, pipeline, tracking
    from emfusion_tpu_torch.config import load_config

    if not torch.cuda.is_available():
        raise SystemExit("batched_lm_vs_host_loop: no CUDA device")
    spec = importlib.util.spec_from_file_location(
        "other_tracking", os.path.join(args.other, "emfusion_tpu_torch",
                                       "tracking.py"))
    other = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = other       # its dataclasses look it up
    spec.loader.exec_module(other)
    calls = []

    def angle(a, b):
        d = a[:3, :3].double().T @ b[:3, :3].double()
        v = torch.stack([d[2, 1] - d[1, 2], d[0, 2] - d[2, 0],
                         d[1, 0] - d[0, 1]])
        return float(torch.arcsin(torch.clamp(v.norm() / 2.0, max=1.0)))

    def both(tsdfs, weights, vs, points, assoc, rel, cfg, active):
        mine = tracking.track_volumes_batched(tsdfs, weights, vs, points,
                                              assoc, rel, cfg, active)
        theirs = other.track_volumes_batched(tsdfs, weights, vs, points,
                                             assoc, rel, cfg, active)
        (p, s), (q, t) = mine, theirs
        vsh = torch.as_tensor(vs, dtype=torch.float32).cpu()
        start = torch.as_tensor(rel, dtype=torch.float32).cpu()
        call = dict(
            moved_this_vox=[float((p[k, :3, 3] - start[k, :3, 3]).norm()
                                  / vsh[k]) for k in range(len(p))],
            moved_other_vox=[float((q[k, :3, 3] - start[k, :3, 3]).norm()
                                   / vsh[k]) for k in range(len(p))],
            trans_gap_vox=[float((p[k, :3, 3] - q[k, :3, 3]).norm() / vsh[k])
                           for k in range(len(p))],
            rot_gap=[angle(p[k], q[k]) for k in range(len(p))],
            **{f"{key}_{who}": st[key].tolist()
               for key in ("iterations", "converged", "recaptures")
               for who, st in (("this", s), ("other", t))},
            dropped_this=s["dropped_points"].tolist(),
            dropped_other=t["dropped_points"].tolist())
        calls.append(call)
        print(f"call {len(calls)}: gap {max(call['trans_gap_vox']):.3e} "
              f"voxel, {max(call['rot_gap']):.3e} rad; moved from the "
              f"start {[round(v, 3) for v in call['moved_this_vox']]} / "
              f"{[round(v, 3) for v in call['moved_other_vox']]} voxels; "
              f"iterations "
              f"{call['iterations_this']} / {call['iterations_other']}, "
              f"converged {call['converged_this']} / "
              f"{call['converged_other']}, re-captures "
              f"{call['recaptures_this']} / {call['recaptures_other']}, "
              f"dropped {call['dropped_this']} / {call['dropped_other']}",
              flush=True)
        return mine if args.follow == "this" else theirs

    pipeline.track_volumes_batched = both
    kernels.build()
    params = load_config(os.path.join(HERE, "configs", "default.cfg"))
    scene = cs.make_scene(params.height, params.width, params.fx)
    rng = np.random.default_rng(0)
    frames, masks = cs.object_scene(scene, params, cs.ACCEL_FRAMES, rng)
    report, out = {}, {}
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
        out[key] = dict(calls=list(calls), gate_failed=failed,
                        live=report[key]["live_objects"],
                        recovery={o: v["recovery"] for o, v in
                                  report[key]["recovery"].items()})
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out",
                           f"batched_vs_other_{args.follow}.json"),
              "w") as f:
        json.dump(dict(follow=args.follow, card=cs.card_line(), runs=out), f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
