#!/usr/bin/env python3
"""K6 (``emfusion_tpu_torch/csrc/warp.cu``) at other layouts, on one GPU.

    python3 scripts/k6_variants.py [--seed N] [--rounds R] [--builds NAME ...]

Builds the checkout's ``warp.cu`` (``product``) and this script's own
variant source, ``scripts/k6_variants.cu``, as ``warp.cu``, once for each
``EMF_WARP_VARIANT`` it defines (``VARIANTS``: ``cell``, a thread a cell
in 128-thread blocks; ``flat4``, four consecutive cells a thread with
16-byte stores on a 1-D grid; ``tile``, 32 x 8-thread blocks of 128 x 8
cells; ``wave``, ``flat4`` on a grid of one wave; ``pre4``, ``tile`` with
the homography's products with the tile's column and row coordinates
computed once a block in shared memory; ``pre8``, the same with 16 x
16-thread blocks of eight cells a thread; ``split4`` and ``split8``,
``pre4`` and ``pre8`` with a thread's divisions, loads and masks in
three passes; ``int4``, ``pre4`` with the floor taken by a conversion
rounding down and the clamp on the integer; ``int2``, the same with two
cells a thread) and of the probes ``PROBES`` (``store``, ``tile``'s grid
and stores alone; ``copy``, the same copying the image's pixel (s, l):
timed, not held, as they do not compute K6), each in a build
directory of its own under a temporary directory. Fuses three frames of
``chip_smoke.py``'s scene at ``configs/default.cfg`` (640x480, 512^3)
and holds each build both ways at the main path's sizes, 480x640 ->
600x896 and back (``chip_smoke.hold_warp``: exact against
``warp_homography_plain``; device time from a CUDA graph of
back-to-back calls, and the same for ``emf_warp_floor``, an empty kernel
on the build's grid and block), and at ragged sizes (37x53 -> 41x67 with
part of the grid behind the plane, and back; exact), in turns: the
builds in order, then in reverse, ``--rounds`` times (default 1);
``--builds`` runs only the named ones (``product`` and ``VARIANTS``'
names). Prints
each build's ms, floor and bound, its ptxas line, the card's name and
power limit and one JSON line; needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the variant builds of k6_variants.cu: name -> EMF_WARP_VARIANT
VARIANTS = {"cell": 0, "flat4": 1, "tile": 2, "wave": 3, "pre4": 4,
            "pre8": 5, "split4": 6, "split8": 7, "int4": 8, "int2": 9}
# probes of k6_variants.cu, timed and not held (not K6's function):
# tile's grid and stores alone, and with a plain copy of the image
PROBES = {"store": 100, "copy": 101}


def variants(tmp):
    """name -> csrc directory: the checkout's, and a copy of it per
    ``VARIANTS`` entry whose ``warp.cu`` is ``k6_variants.cu`` at that
    ``EMF_WARP_VARIANT``."""
    csrc = os.path.join(HERE, "emfusion_tpu_torch", "csrc")
    out = {"product": csrc}
    with open(os.path.join(HERE, "scripts", "k6_variants.cu")) as f:
        src = f.read()
    for name, v in {**VARIANTS, **PROBES}.items():
        d = os.path.join(tmp, name)
        shutil.copytree(csrc, d)
        with open(os.path.join(d, "warp.cu"), "w") as f:
            f.write(f"#define EMF_WARP_VARIANT {v}\n" + src)
        out[name] = d
    return out


def inputs(torch, seed):
    """K6's inputs at the main path's sizes: three frames of the scene
    fused, the fourth frame filtered, and the centre slice's homography
    and plane (``chip_smoke.warp_inputs``)."""
    import chip_smoke as cs
    from emfusion_tpu_torch.config import load_config
    from emfusion_tpu_torch.pipeline import EMFusionPipeline

    params = load_config(os.path.join(HERE, "configs", "default.cfg"))
    scene = cs.make_scene(params.height, params.width, params.fx)
    rng = np.random.default_rng(seed)
    pipe = EMFusionPipeline(params)
    for i in range(3):
        pipe.process_frame(None, cs.sensor_depth(scene.render(cs.gt_pose(i)),
                                                 rng))
    depth, _ = pipe.preprocess(cs.sensor_depth(scene.render(cs.gt_pose(3)),
                                               rng))
    return cs.warp_inputs(torch, pipe, depth)


def hold_ragged(torch):
    """K6 at ragged sizes against its plain version, both ways: a 37x53
    image onto a 41x67 grid through a homography that sends part of the
    grid behind the plane (those cells read 0), and the grid back onto
    the pixels. Returns the two max abs errors."""
    from emfusion_tpu_torch.ops import warp

    rng = np.random.RandomState(5)
    img = torch.tensor((0.5 + rng.rand(37, 53)).astype(np.float32),
                       device="cuda")
    Bmat = torch.tensor([[53 * 0.12, 2.0, 53 * 0.3],
                         [1.5, 37 * 0.11, 37 * 0.25], [-0.3, 0.007, 1.0]])
    plane = (-2.5, -2.0, 9.0, 8.0)
    k = warp.warp_image_to_grid(img, Bmat, 37, 53, *plane, 41, 67)
    q = warp.warp_homography_plain(img, Bmat, 41, 67, plane)
    Binv = torch.linalg.inv(Bmat)
    k2 = warp.select_grid_at_pixels(k, Binv, *plane, 37, 53)
    q2 = warp.warp_homography_plain(
        k, warp.grid_index_homography(Binv, *plane, 41, 67), 37, 53, None,
        round_half=False, mask_oob=False)
    if not ((q == 0).any() and (q > 0).any()):
        raise RuntimeError("k6_variants: the ragged grid has no cell behind "
                           "the plane, or none in the image")
    return float((k - q).abs().max()), float((k2 - q2).abs().max())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--builds", nargs="+",
                    choices=["product", *VARIANTS, *PROBES],
                    help="the builds to run (default all)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k6_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from emfusion_tpu_torch import kernels

    card = cs.card_line()
    data = inputs(torch, args.seed)
    report = {"card": card, "runs": []}
    with tempfile.TemporaryDirectory() as tmp:
        builds = variants(tmp)
        names = args.builds or list(builds)
        for name in (names + names[::-1]) * args.rounds:
            kernels.CSRC = builds[name]
            kernels.BUILD_DIR = os.path.join(tmp, "build-" + name)
            kernels._libs.clear()
            kernels._fns.clear()
            fresh = kernels.build(["warp"]) > 0
            ptxas = [ln for ln in cs.ptxas_lines(kernels.build_log)
                     if "warp" in ln] if fresh else []
            rows = cs.hold_warp(torch, *data)
            probe = name in PROBES
            ragged = (0.0, 0.0) if probe else hold_ragged(torch)
            report["runs"].append(dict(build=name, ptxas=ptxas, rows={
                key: dict(ms=r["ms"], floor_ms=r["floor_ms"],
                          bound_ms=r["bound"][0],
                          max_abs_err=r["max_abs_err"])
                for key, r in rows.items()}, ragged_max_abs_err=ragged))
            print(f"{name}: " + "; ".join(
                f"{key} {r['ms']:.5f} ms (floor {r['floor_ms']:.5f}, bound "
                f"{r['bound'][0]:.5f}, err {r['max_abs_err']})"
                for key, r in rows.items())
                + f"; ragged err {ragged}; {ptxas}", flush=True)
            if not probe and (any(r["max_abs_err"] > 0
                                  for r in rows.values()) or any(ragged)):
                raise RuntimeError(f"{name}: K6 differs from its plain "
                                   "version")
    print(card, flush=True)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
