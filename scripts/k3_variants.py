#!/usr/bin/env python3
"""K3 (``emfusion_tpu_torch/csrc/capture.cu``) at other layouts, on one GPU.

    python3 scripts/k3_variants.py [--seed N] [--tree DIR]

Builds the checkout's ``capture.cu`` (``product``: a thread a point, a
block a (dz, dy) window row) and this script's own variant source,
``scripts/k3_variants.cu``, as ``capture.cu`` beside the checkout's other
sources, once for each ``EMF_CAPTURE_RPT`` (the window rows a thread
copies) it defines: 1 (``pairs``: the product's rows, a bf16 item's
thread copying two neighbouring points with 32-bit stores), 6 (``rpt6``:
a block a dz, each anchor computed 6 times, not 36) and 36 (``rpt36``: a
thread a point, all its rows, each anchor once), each in a build
directory of its own under a temporary directory; with ``--tree``, also
that checkout's ``capture.cu`` (e.g. a parent unpacked with ``git
archive``). Runs the accelerator path (``chip_smoke.ACCEL``) for
``FRAMES`` frames, then holds each build against the plain capture
(``chip_smoke.hold_capture``, ``hold_capture_batched``; exact) on the
camera's stride-3 points (float32 volumes, and the same volumes cast to
bf16: a bf16 cache) and on the batched LM stage's table of the live
slots, in turns (each build twice, in mirrored order). Prints each
build's ms (device time from a CUDA graph of back-to-back calls) beside
the bound, its ptxas line, the card's name and power limit and one JSON
line; needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 6
# the variant builds of k3_variants.cu: name -> EMF_CAPTURE_RPT
VARIANTS = {"pairs": 1, "rpt6": 6, "rpt36": 36}


def variants(tmp, tree):
    """name -> csrc directory: the checkout's, a copy of it per
    ``VARIANTS`` entry whose ``capture.cu`` is ``k3_variants.cu`` at that
    ``EMF_CAPTURE_RPT``, and ``tree``'s."""
    csrc = os.path.join(HERE, "emfusion_tpu_torch", "csrc")
    out = {"product": csrc}
    with open(os.path.join(HERE, "scripts", "k3_variants.cu")) as f:
        src = f.read()
    for name, rpt in VARIANTS.items():
        d = os.path.join(tmp, name)
        shutil.copytree(csrc, d)
        with open(os.path.join(d, "capture.cu"), "w") as f:
            f.write(f"#define EMF_CAPTURE_RPT {rpt}\n" + src)
        out[name] = d
    if tree:
        out["tree"] = os.path.join(os.path.abspath(tree), "emfusion_tpu_torch",
                                   "csrc")
    return out


def inputs(torch, seed):
    """K3's inputs on the accelerator path after ``FRAMES`` frames: the
    camera's (volumes, points, rotation, translation, voxel size), its
    volumes as bf16, and the batched stage's (tsdfs, weights, points,
    poses, voxel sizes)."""
    import chip_smoke as cs
    from emfusion_tpu_torch.config import load_config
    from emfusion_tpu_torch.geometry.se3 import pose_inverse, reorthonormalize
    from emfusion_tpu_torch.pipeline import EMFusionPipeline

    params = dataclasses.replace(
        load_config(os.path.join(HERE, "configs", "default.cfg")), **cs.ACCEL)
    scene = cs.make_scene(params.height, params.width, params.fx)
    rng = np.random.default_rng(seed)
    frames, masks = cs.object_scene(scene, params, FRAMES, rng)
    pipe = EMFusionPipeline(params, cs.mask_provider(masks))
    for i, depth in enumerate(frames):
        pipe.process_frame(None, depth, timestamp=float(i))
    f = pipe.frame
    _, points = pipe.preprocess(cs.sensor_depth(
        scene.render(cs.gt_pose(f), cs.movers_at(f))[0], rng))
    s, k = pipe.state, pipe.stride
    rel = reorthonormalize(pose_inverse(s.bg_pose) @ s.cam_pose
                           @ pipe.motion_delta())
    live = [int(j) for j in np.nonzero(pipe._h_active)[0]]
    tsdfs, wts, vs, pts, _, rel_o, _, _ = pipe.batched_lm_inputs(points,
                                                                 live)
    cam = (points[:, ::k, ::k].reshape(3, -1), rel[:3, :3], rel[:3, 3],
           pipe.voxel)
    vols = (s.bg_tsdf, s.bg_weights)
    bf16 = tuple(v.to(torch.bfloat16) for v in vols)
    return dict(camera=(vols,) + cam, camera_bf16=(bf16,) + cam,
                objects=(tsdfs, wts, pts, rel_o, vs))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tree", help="another checkout whose capture.cu "
                                   "runs beside these")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k3_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from emfusion_tpu_torch import kernels

    card = cs.card_line()
    data = inputs(torch, args.seed)
    report = {"card": card, "runs": []}
    with tempfile.TemporaryDirectory() as tmp:
        builds = variants(tmp, args.tree)
        names = list(builds)
        for name in names + names[::-1]:
            kernels.CSRC = builds[name]
            kernels.BUILD_DIR = os.path.join(tmp, "build-" + name)
            kernels._libs.clear()
            kernels._fns.clear()
            fresh = kernels.build(["capture"]) > 0
            ptxas = [ln for ln in cs.ptxas_lines(kernels.build_log)
                     if "capture" in ln] if fresh else []
            rows = {key: (cs.hold_capture(torch, *data[key])
                          if key.startswith("camera") else
                          cs.hold_capture_batched(torch, *data[key]))
                    for key in data}
            report["runs"].append(dict(build=name, ptxas=ptxas, rows={
                key: dict(ms=r["ms"], bound_ms=r["bound"][0],
                          max_abs_err=r["max_abs_err"])
                for key, r in rows.items()}))
            print(f"{name}: " + "; ".join(
                f"{key} {r['ms']:.5f} ms (bound {r['bound'][0]:.5f}, "
                f"err {r['max_abs_err']})" for key, r in rows.items())
                + f"; {ptxas}", flush=True)
            if any(r["max_abs_err"] > 0 for r in rows.values()):
                raise RuntimeError(f"{name}: K3 differs from the plain "
                                   "capture")
    print(card, flush=True)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
