"""Trajectory evaluation CLI — in-repo equivalent of the reference's eval
harness (``eval_tum.sh:29-39``, ``eval_co-fusion.sh:30-76``): computes ATE
RMSE and RPE from an export directory against a ground-truth trajectory.

Usage:
  python -m emfusion_tpu_torch.apps.evaluate EXPORTDIR GROUNDTRUTH.txt \
      [--obj ID GT_OBJ.txt]... [--max-difference 0.02] [--rpe-delta 1]

Prints one line per trajectory: name, ATE RMSE (m), RPE trans (m), RPE
rot (deg), matched pose count.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def evaluate_pair(est_path: str, gt_path: str, max_difference: float,
                  rpe_delta: int):
    from emfusion_tpu_torch.eval.ate import (evaluate_ate, evaluate_rpe,
                                       load_trajectory)
    est = load_trajectory(est_path)
    gt = load_trajectory(gt_path)
    out = {}
    try:
        ate = evaluate_ate(est, gt, max_difference=max_difference)
        out["ate_rmse"] = float(ate["rmse"])
        out["pairs"] = int(ate["pairs"])
    except ValueError as e:
        out["ate_error"] = str(e)
    try:
        rpe = evaluate_rpe(est, gt, delta=rpe_delta,
                           max_difference=max_difference)
        out["rpe_trans_rmse"] = float(rpe["trans_rmse"])
        out["rpe_rot_rmse_deg"] = float(rpe["rot_rmse_deg"])
    except (ValueError, KeyError) as e:
        out["rpe_error"] = str(e)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser("emfusion-evaluate")
    ap.add_argument("exportdir")
    ap.add_argument("groundtruth", help="camera ground-truth (TUM format)")
    ap.add_argument("--obj", nargs=2, action="append", default=[],
                    metavar=("ID", "GT"),
                    help="evaluate object ID against its ground truth")
    ap.add_argument("--max-difference", type=float, default=0.02,
                    help="timestamp association window (s)")
    ap.add_argument("--rpe-delta", type=int, default=1)
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    results = {}
    cam = os.path.join(args.exportdir, "poses-cam.txt")
    if os.path.exists(cam):
        results["camera"] = evaluate_pair(cam, args.groundtruth,
                                          args.max_difference,
                                          args.rpe_delta)
    for oid, gt in args.obj:
        p = os.path.join(args.exportdir, f"poses-{oid}-corrected.txt")
        if not os.path.exists(p):
            p = os.path.join(args.exportdir, f"poses-{oid}.txt")
        results[f"object-{oid}"] = evaluate_pair(p, gt, args.max_difference,
                                                 args.rpe_delta)

    if args.json:
        print(json.dumps(results))
    else:
        for name, r in results.items():
            if "ate_rmse" in r:
                line = (f"{name}: ATE RMSE {r['ate_rmse']*100:.2f} cm "
                        f"({r['pairs']} pairs)")
                if "rpe_trans_rmse" in r:
                    line += (f", RPE {r['rpe_trans_rmse']*100:.2f} cm / "
                             f"{r['rpe_rot_rmse_deg']:.3f} deg")
                print(line)
            else:
                print(f"{name}: {r}")
    return 0 if results else 1


if __name__ == "__main__":
    sys.exit(main())
