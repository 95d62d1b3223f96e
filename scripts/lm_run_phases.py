#!/usr/bin/env python3
"""Where a launch of the cooperative LM kernel ``lm_run``
(``emfusion_tpu_torch/csrc/lm.cu``) spends its time, on one GPU.

    python3 scripts/lm_run_phases.py [--seed N]

Builds ``lm.cu`` as it stands and a timed copy of it (in a temporary
directory, so the product source carries no switch): in the copy, block
0 of ``emf_lm_run_kernel`` reads the global timer (ns) at the kernel's
start and after each ``grid.sync()`` of its loop, and adds the time
since its previous mark to that phase's total (gather, terms, propose,
trial, decide). A barrier waits for every block, so a phase's time is
its slowest block's; the gather's includes the loop-top stop test.

The LM tables are chip_smoke.py's: the camera LM of its warm-up
background (307,200 points on 512^3, after three fused frames), the
object path's table of both objects (after ``OBJECT_FRAMES`` frames with
the masks of frame 0) and that pipeline's pool filled to 16 slots. Per
table and build: ``run_ms``, a launch of ``max_iter`` iterations from a
fresh state, which runs the LMs to their end (CUDA events around the
launch; median of ``REPS``), the longest LM's iterations and ``run_ms``
over them; for the timed copy each phase's ms over the whole run and an
iteration. Both builds must end on the same poses bit for bit. Prints
the card's name and power limit and one JSON line; needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 15
OBJECT_FRAMES = 6
PHASES = ("gather", "terms", "propose", "trial", "decide")
TIMER = '''
__device__ unsigned long long emf_lm_phase_ns[8];
__device__ unsigned long long emf_lm_last_ns;
__device__ __forceinline__ void emf_lm_mark(int i) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    if (i == 0)
      for (int j = 0; j < 8; ++j) emf_lm_phase_ns[j] = 0;
    else
      emf_lm_phase_ns[i] += t - emf_lm_last_ns;
    emf_lm_last_ns = t;
  }
}
extern "C" int emf_lm_phase_times(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, emf_lm_phase_ns,
                                   sizeof(emf_lm_phase_ns));
}
'''


def timed_source(src: str) -> str:
    """``lm.cu`` with the timer: its functions before the kernel, a mark
    at the start of its body and one after each ``grid.sync()``."""
    at = src.index("emf_lm_run_kernel(")
    head = src.rindex("__global__", 0, at)
    body = src.index("{", at) + 1
    end = src.index("\n}\n", body)
    kernel = src[body:end]
    marks = kernel.split("grid.sync();")
    if len(marks) != len(PHASES) + 1:
        raise RuntimeError(f"emf_lm_run_kernel has {len(marks) - 1} grid "
                           f"barriers, not {len(PHASES)}")
    kernel = "".join(m + (f"grid.sync();\n    emf_lm_mark({i + 1});"
                          if i < len(PHASES) else "")
                     for i, m in enumerate(marks))
    return (src[:head] + TIMER + "\n" + src[head:body]
            + "\n  emf_lm_mark(0);" + kernel + src[end:])


def use_build(kernels, timed, tmp):
    """Points ``kernels`` at the checkout's ``csrc/`` or at a timed copy
    of it, each with a build directory of its own; forgets the loaded
    libraries."""
    csrc = os.path.join(HERE, "emfusion_tpu_torch", "csrc")
    if timed:
        copy = os.path.join(tmp, "timed")
        shutil.copytree(csrc, copy)
        path = os.path.join(copy, "lm.cu")
        with open(path) as f:
            src = timed_source(f.read())
        with open(path, "w") as f:
            f.write(src)
        csrc = copy
    kernels.CSRC = csrc
    kernels.BUILD_DIR = os.path.join(tmp, "build-timed" if timed
                                     else "build")
    kernels._libs.clear()
    kernels._fns.clear()
    kernels.build(["lm_run"])


def time_table(torch, tr, kernels, items, cfg, timed):
    """``run_ms``, iterations, the final poses and, timed, the phases'
    ms over the run of ``lm_run`` over ``items`` from a fresh state."""
    run = tr.LMRun(items, cfg)
    si0, sf0 = run.si.clone(), run.sf.clone()
    times = []
    for _ in range(REPS + 1):       # the first launch loads the kernel
        run.si.copy_(si0)
        run.sf.copy_(sf0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        tr.lm_run(run, cfg, cfg.max_iter)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    whole = float(np.median(times[1:]))
    iters = int(run.si[:, tr.SI_IT].max())
    out = dict(run_ms=whole, iterations=iters,
               ms_per_iteration=whole / max(iters, 1), grid=run.grid,
               spans=int(run.part.shape[0]))
    if timed:
        buf = (ctypes.c_ulonglong * 8)()
        err = kernels.library("lm_run").emf_lm_phase_times(buf)
        if err:
            raise RuntimeError(f"emf_lm_phase_times: cudaError {err}")
        out["phase_ms_run"] = {p: buf[i + 1] / 1e6
                               for i, p in enumerate(PHASES)}
        out["phase_ms_iteration"] = {
            p: v / max(iters, 1) for p, v in out["phase_ms_run"].items()}
    return out, run.sf[:, :tr.SF_RN].clone()


def tables(torch, seed):
    """The camera LM's table, the object path's and a 16-slot pool's,
    built as chip_smoke.py builds them, and the LM constants."""
    import chip_smoke as cs
    from emfusion_tpu_torch.config import load_config
    from emfusion_tpu_torch.pipeline import EMFusionPipeline

    params = load_config(os.path.join(HERE, "configs", "default.cfg"))
    scene = cs.make_scene(params.height, params.width, params.fx)
    rng = np.random.default_rng(seed)
    warm = EMFusionPipeline(params)
    for i in range(3):
        warm.process_frame(None, cs.sensor_depth(scene.render(
            cs.gt_pose(i)), rng))
    _, pts = warm.preprocess(cs.sensor_depth(scene.render(cs.gt_pose(3)),
                                             rng))
    out = {"camera": [warm.camera_lm_item(pts)]}
    cfg = warm.track_cfg
    frames, masks = cs.object_scene(scene, params, OBJECT_FRAMES, rng)
    pipe = EMFusionPipeline(params, cs.mask_provider(masks))
    for i, depth in enumerate(frames):
        pipe.process_frame(None, depth, timestamp=float(i))
    f = pipe.frame
    depth = cs.sensor_depth(scene.render(cs.gt_pose(f), cs.movers_at(f))[0],
                            rng)
    _, pts = pipe.preprocess(depth)
    live = [int(k) for k in np.nonzero(pipe._h_active)[0]]
    out["objects"] = pipe.object_lm_items(pts, live)
    cs.fill_pool(torch, pipe)
    out["pool"] = pipe.object_lm_items(pts, list(range(pipe.K)))
    return out, cfg


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("lm_run_phases: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from emfusion_tpu_torch import kernels
    from emfusion_tpu_torch import tracking as tr

    card = cs.card_line()
    tabs, cfg = tables(torch, args.seed)
    report = {"card": card, "tables": {k: dict(items=len(v), points=sum(
        int(it.points.shape[1]) for it in v)) for k, v in tabs.items()}}
    ref = {}
    with tempfile.TemporaryDirectory() as tmp:
        for timed in (False, True):
            name = "timed" if timed else "as built"
            use_build(kernels, timed, tmp)
            rows = {"ptxas": [ln for ln in cs.ptxas_lines(kernels.build_log)
                              if "emf_lm_run_kernel" in ln]}
            for key, items in tabs.items():
                row, poses = time_table(torch, tr, kernels, items, cfg,
                                        timed)
                if key in ref and not torch.equal(poses, ref[key]):
                    raise RuntimeError(f"{name}: {key} poses differ from "
                                       "the as-built kernel's")
                ref.setdefault(key, poses)
                rows[key] = row
            report[name] = rows
            print(f"{name}: {rows['ptxas']}", flush=True)
            for key in tabs:
                r = rows[key]
                extra = ""
                if timed:
                    extra = "; phases over the run (an iteration) " + \
                        ", ".join(f"{p} {v:.4f} ({r['phase_ms_iteration'][p]:.4f})"
                                  for p, v in r["phase_ms_run"].items())
                print(f"  {key}: whole LM {r['run_ms']:.4f} ms over "
                      f"{r['iterations']} iterations = "
                      f"{r['ms_per_iteration']:.4f} ms an iteration; "
                      f"{r['grid']} blocks over {r['spans']} spans{extra}",
                      flush=True)
    print(card, flush=True)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
