#!/usr/bin/env python3
"""The port against itself on ``chip_smoke.py``'s small respawn scene.

    python3 scripts/respawn_spread.py [--seed N] [--scales S ...]

Runs step 13's scene (``chip_smoke.respawn_scene`` at
``chip_smoke.RESPAWN_SMALL``, every ``RESPAWN_SMALL_STEP``-th frame)
through the port's pipeline on the CPU (plain versions), once as drawn
and once with every depth scaled by each of ``--scales`` (default 1 +
2e-7: a change of one or two float32 ulps), all free-running. Prints for
each scale whether the live ids and slots equal the unscaled run's at
every frame, and per object the largest distance of its origin from the
unscaled run's, in object voxels, and per frame. This is the spread that
a free-running comparison of two implementations meets on this scene;
``chip_smoke.py`` step 13 holds the card frame by frame from its own
states instead. Needs no card (~40 s a run on 4 threads).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(torch, params, frames, masks, scale):
    """The free-running CPU pipeline over ``frames`` scaled by ``scale``:
    its per-frame lifecycle (``chip_smoke.respawn_frames``) and object
    poses."""
    import chip_smoke as cs
    from emfusion_tpu_torch.pipeline import EMFusionPipeline

    pipe = EMFusionPipeline(params, cs.mask_provider(masks), device="cpu")
    life, _, _ = cs.respawn_frames(
        torch, pipe, [(d * np.float32(scale)).astype(np.float32)
                      for d in frames], cs.RESPAWN_C // cs.RESPAWN_SMALL_STEP)
    return life, {o: dict(t) for o, t in pipe.obj_poses.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=4,
                    help="seed of the depth noise (step 13 draws with "
                         "chip_smoke's --seed + 4)")
    ap.add_argument("--scales", type=float, nargs="+", default=[1 + 2e-7])
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch

    import chip_smoke as cs
    from emfusion_tpu_torch.config import Params

    torch.set_num_threads(4)
    params = Params(**cs.RESPAWN_SMALL)
    scene = cs.make_scene(120, 160, 120.0)
    frames, masks, _ = cs.respawn_scene(
        scene, params, cs.RESPAWN_SMALL_FRAMES,
        np.random.default_rng(args.seed), step=cs.RESPAWN_SMALL_STEP)
    base_life, base = run(torch, params, frames, masks, 1.0)
    vs = {}
    for r in base_life:
        for o, v in r["vs"].items():
            vs.setdefault(o, v)
    for scale in args.scales:
        life, poses = run(torch, params, frames, masks, scale)
        same = [r["slots"] for r in life] == [r["slots"] for r in base_life]
        gaps = {o: [float(np.linalg.norm(q[:3, 3] - base[o][f][:3, 3]))
                    / vs[o] for f, q in sorted(t.items())]
                for o, t in poses.items() if o in base}
        print(f"depth x {scale!r}: lifecycle equal at every frame: {same}; "
              "largest origin distance in object voxels " + ", ".join(
                  f"object {o} {max(g):.3f}" for o, g in gaps.items())
              + "; per frame " + "; ".join(
                  f"object {o} " + " ".join(f"{x:.3f}" for x in g)
                  for o, g in gaps.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
