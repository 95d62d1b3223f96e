#!/usr/bin/env python3
"""Readings for the correctness limits, on the card (not run by the
benchmark's own runs).

    python3 benchmark/readings.py --workload CELL --seeds 1,2,3 \\
        --seconds 3 [--out FILE]

runs the cell once a seed in one process, each with a short window at the
cell's own size and load, and prints one JSON line a seed: the program's
numbers against the reference (``checks``: the lower readings) and the
control's on the same frames (``control_checks``: the upper readings),
with the window's frames/s. ``--out`` also writes the lines to FILE.
``--look`` adds each checked frame's camera LM looked at by the reference,
the reference on rescaled points and the port's CPU path (``look.py``);
``--frame-size W,H`` runs the cell at another frame size, and
``--window-frames N`` ends the window after N frames (so that a run
follows the same frames again).
"""

import time

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("benchmark/readings.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out")
    ap.add_argument("--look", action="store_true",
                    help="look at each checked frame's camera LM")
    ap.add_argument("--window-frames", type=int, default=0,
                    help="end the window after N frames instead")
    ap.add_argument("--frame-size",
                    help="W,H: another frame size, the intrinsics kept")
    args = ap.parse_args(argv)
    overrides = {}
    if args.frame_size:
        overrides["frameSize"] = [int(v) for v in args.frame_size.split(",")]
    os.environ.pop("EMF_TRACK_SAMPLER", None)
    import torch
    if not torch.cuda.is_available():
        print("readings: no card", file=sys.stderr)
        return 2
    from benchmark import harness
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = harness.run_cell(args.workload, seed, args.seconds, False,
                               t0, also_control=True, look=args.look,
                               overrides=overrides,
                               window_frames=args.window_frames, log=print)
        line = dict(workload=args.workload, seed=seed,
                    correct=out["correct"],
                    checks={k: v["value"] for k, v in out["checks"].items()},
                    control_checks=out["control_checks"],
                    metrics={k: v["value"] for k, v in out["metrics"].items()},
                    look=out.get("look"), overrides=overrides,
                    seconds=time.perf_counter() - t0)
        print(json.dumps(line), flush=True)
        lines.append(line)
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
