#!/usr/bin/env python3
"""Where a launch of the device LM's kernels (``emfusion_tpu_torch/csrc/
lm.cu``) spends its time, on one GPU: the cooperative ``lm_run`` over
gather tables, and over cache tables the kernel each takes (``lm_cluster``
for the batched stages, ``lm_run`` for the capture camera LM's 34 spans).

    python3 scripts/lm_run_phases.py [--seed N] [--only gather|cache]

Builds ``lm.cu`` as it stands and a timed copy of it (in a temporary
directory, so the product source carries no switch): in the copy, block
0 of each LM kernel (``emf_lm_run_kernel``, and ``emf_lm_cluster_kernel``
where the source has it) reads the global timer (ns) at the kernel's
start and after each barrier of its loop (``grid.sync()``, or
``cluster.sync()``), and adds the time since its previous mark to that
phase's total (gather, terms, propose, trial, decide); the totals add up
over the launches of a run until the host clears them. A barrier waits
for every block it spans (the grid, or block 0's cluster: the table's
first LM), so a phase's time is its slowest block's there; the gather's
includes the loop-top stop test.

The gather tables are chip_smoke.py's: the camera LM of its warm-up
background (307,200 points on 512^3, after three fused frames), the
object path's table of both objects (after ``OBJECT_FRAMES`` frames with
the masks of frame 0) and that pipeline's pool filled to 16 slots. The
cache tables are the accelerator path's (``chip_smoke.ACCEL``, after
``OBJECT_FRAMES`` frames): the batched object LM's first-stage table of
both objects (2 x 4096 points) and of the pool filled to 16 slots (16 x
4096), and the capture sampler's camera LM (its stride-3 points, ~34,240,
from ``chip_smoke.CAPTURE_HOLD_OFFSET`` voxels off its start, so that it
re-captures: ``tracking.capture_table``, K3 and a read between its
launches). Per table and build: ``run_ms``, a run from a fresh state to
the LMs' end (CUDA events around it; median of ``REPS``), the longest
LM's iterations and ``run_ms`` over them; for the timed copy each
phase's ms over the whole run and an iteration. Both builds must end on
the same poses bit for bit. Prints the card's name and power limit and
one JSON line; needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
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
# the LM kernels of lm.cu and the barrier each repeats once a phase
BARRIERS = {"emf_lm_run_kernel(": "grid.sync();",
            "emf_lm_cluster_kernel(": "cluster.sync();"}
TIMER = '''
__device__ unsigned long long emf_lm_phase_ns[8];
__device__ unsigned long long emf_lm_last_ns;
__device__ __forceinline__ void emf_lm_mark(int i) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    if (i) emf_lm_phase_ns[i] += t - emf_lm_last_ns;
    emf_lm_last_ns = t;
  }
}
extern "C" int emf_lm_phase_times(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, emf_lm_phase_ns,
                                   sizeof(emf_lm_phase_ns));
}
extern "C" int emf_lm_phase_clear() {
  const unsigned long long z[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  return (int)cudaMemcpyToSymbol(emf_lm_phase_ns, z, sizeof(z));
}
'''


def timed_kernel(src: str, name: str, barrier: str) -> str:
    """``src`` with a mark at the start of kernel ``name``'s body and one
    after each ``barrier`` in it."""
    at = src.index(name)
    body = src.index("{", at) + 1
    end = src.index("\n}\n", body)
    kernel = src[body:end]
    marks = kernel.split(barrier)
    if len(marks) != len(PHASES) + 1:
        raise RuntimeError(f"{name} has {len(marks) - 1} barriers, not "
                           f"{len(PHASES)}")
    kernel = "".join(m + (f"{barrier}\n    emf_lm_mark({i + 1});"
                          if i < len(PHASES) else "")
                     for i, m in enumerate(marks))
    return src[:body] + "\n  emf_lm_mark(0);" + kernel + src[end:]


def timed_source(src: str) -> str:
    """``lm.cu`` with the timer: its functions after the source's
    includes, and each LM kernel marked (:func:`timed_kernel`)."""
    inc = '#include "common.cuh"\n'
    head = src.index(inc) + len(inc)
    src = src[:head] + TIMER + src[head:]
    for name in [n for n in BARRIERS if n in src]:
        src = timed_kernel(src, name, BARRIERS[name])
    return src


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
    kernels.build(["lm_run", "capture"])


def fresh_items(items):
    """Copies of cache items' windows and anchors (a re-capture writes
    into an item's own)."""
    return [dataclasses.replace(it, cache=it.cache.clone(),
                                anchor=it.anchor.clone()) for it in items]


def time_table(torch, tr, kernels, table, timed):
    """``run_ms``, iterations, the final poses and, timed, the phases'
    ms over the run of ``table`` (items, LM constants, re-capture
    budget) from a fresh state: ``lm_run`` of ``max_iter`` iterations,
    or with a budget ``tracking.capture_table``."""
    items, cfg, recaps = table
    lib = kernels.library("lm_run")
    times = []
    for _ in range(REPS + 1):       # the first run loads the kernel
        if recaps:
            fresh = fresh_items(items)
        else:
            run = tr.LMRun(items, cfg)
        torch.cuda.synchronize()
        if timed:
            lib.emf_lm_phase_clear()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        if recaps:
            run, _ = tr.capture_table(fresh, cfg)
        else:
            tr.lm_run(run, cfg, cfg.max_iter)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    whole = float(np.median(times[1:]))
    iters = int(run.si[:, tr.SI_IT].max())
    out = dict(run_ms=whole, iterations=iters,
               ms_per_iteration=whole / max(iters, 1),
               kernel=run.kernel, grid=run.grid, reads=run.reads,
               recaptures=int(run.si[:, tr.SI_RECAP].sum()),
               spans=int(run.part.shape[0]))
    if timed:
        buf = (ctypes.c_ulonglong * 8)()
        err = lib.emf_lm_phase_times(buf)
        if err:
            raise RuntimeError(f"emf_lm_phase_times: cudaError {err}")
        out["phase_ms_run"] = {p: buf[i + 1] / 1e6
                               for i, p in enumerate(PHASES)}
        out["phase_ms_iteration"] = {
            p: v / max(iters, 1) for p, v in out["phase_ms_run"].items()}
    return out, run.sf[:, :tr.SF_RN].clone()


def gather_tables(torch, seed):
    """The camera LM's gather table, the object path's and a 16-slot
    pool's, built as chip_smoke.py builds them."""
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
    cfg = warm.track_cfg
    out = {"camera": ([warm.camera_lm_item(pts)], cfg, 0)}
    del warm
    frames, masks = cs.object_scene(scene, params, OBJECT_FRAMES, rng)
    pipe = EMFusionPipeline(params, cs.mask_provider(masks))
    for i, depth in enumerate(frames):
        pipe.process_frame(None, depth, timestamp=float(i))
    _, pts = pipe.preprocess(next_depth(cs, scene, pipe, rng))
    live = [int(k) for k in np.nonzero(pipe._h_active)[0]]
    out["objects"] = (pipe.object_lm_items(pts, live), cfg, 0)
    cs.fill_pool(torch, pipe)
    out["pool"] = (pipe.object_lm_items(pts, list(range(pipe.K))), cfg, 0)
    return out


def next_depth(cs, scene, pipe, rng):
    f = pipe.frame
    return cs.sensor_depth(scene.render(cs.gt_pose(f), cs.movers_at(f))[0],
                           rng)


def cache_tables(torch, seed):
    """The accelerator path's cache tables: the batched object LM's
    first-stage tables of both objects and of a 16-slot pool, and the
    capture sampler's camera LM from ``CAPTURE_HOLD_OFFSET`` voxels off
    its start, built as chip_smoke.py's holds build them."""
    import chip_smoke as cs
    from emfusion_tpu_torch import tracking as tr
    from emfusion_tpu_torch.config import load_config
    from emfusion_tpu_torch.pipeline import EMFusionPipeline

    params = load_config(os.path.join(HERE, "configs", "default.cfg"))
    params = dataclasses.replace(params, **cs.ACCEL)
    scene = cs.make_scene(params.height, params.width, params.fx)
    rng = np.random.default_rng(seed)
    frames, masks = cs.object_scene(scene, params, OBJECT_FRAMES, rng)
    pipe = EMFusionPipeline(params, cs.mask_provider(masks))
    for i, depth in enumerate(frames):
        pipe.process_frame(None, depth, timestamp=float(i))
    _, pts = pipe.preprocess(next_depth(cs, scene, pipe, rng))
    live = [int(k) for k in np.nonzero(pipe._h_active)[0]]
    out = {"cache": cs.stage_table(torch, pipe, pts, live) + (0,)}
    it = pipe.camera_lm_item(pts)
    start = torch.as_tensor(it.rel_pose, dtype=torch.float32).clone()
    start[0, 3] += cs.CAPTURE_HOLD_OFFSET * pipe.voxel
    cam = tr.capture_items([dataclasses.replace(it, rel_pose=start)])
    cfg = pipe.track_cfg
    out["capture_camera"] = (cam, cfg, cfg.max_recaptures)
    cs.fill_pool(torch, pipe)
    out["cache_pool"] = cs.stage_table(torch, pipe, pts,
                                       list(range(pipe.K))) + (0,)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", choices=("gather", "cache"))
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
    tabs = {}
    if args.only != "cache":
        tabs.update(gather_tables(torch, args.seed))
    if args.only != "gather":
        tabs.update(cache_tables(torch, args.seed))
    report = {"card": card, "tables": {k: dict(items=len(v[0]), points=sum(
        int(it.points.shape[1]) for it in v[0])) for k, v in tabs.items()}}
    ref = {}
    with tempfile.TemporaryDirectory() as tmp:
        for timed in (False, True):
            name = "timed" if timed else "as built"
            use_build(kernels, timed, tmp)
            rows = {"ptxas": [ln for ln in cs.ptxas_lines(kernels.build_log)
                              if "emf_lm_" in ln and "_kernel" in ln]}
            for key, table in tabs.items():
                row, poses = time_table(torch, tr, kernels, table, timed)
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
                        ", ".join(f"{p} {v:.4f} ({r['phase_ms_iteration'][p]:.5f})"
                                  for p, v in r["phase_ms_run"].items())
                print(f"  {key}: whole LM {r['run_ms']:.4f} ms over "
                      f"{r['iterations']} iterations = "
                      f"{r['ms_per_iteration']:.5f} ms an iteration; "
                      f"{r['kernel']}, {r['grid']} blocks over "
                      f"{r['spans']} spans, "
                      f"{r['reads']} reads, {r['recaptures']} "
                      f"re-captures{extra}", flush=True)
    print(card, flush=True)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
