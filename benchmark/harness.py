"""One run of one cell: set-up, the measured window, the trace, the check.

The cell names a configuration (``configs/<name>.json``) and a traffic mix
(``traffic/<name>.json``); its limits are ``limits/<cell>.json`` and each
metric is read by ``metrics/<name>.py`` (dots and dashes of the name as
underscores), so that a later cell, configuration or metric is a new file
and a new manifest entry.

The run, as ``apps/run_emfusion.py`` drives the port (``:150-219``):

1. set-up: the kernels from the port's own build directory inside the
   checkout (``nvcc`` only where they are not built yet); one loop of the
   mix's frames rendered on the card from the seed and handed over as host
   float32 depth; ``EMFusionPipeline(params, mask_provider)`` with
   ``PhaseTimer(mode="events")``; ``warmup_cycles`` mask cycles of frames;
2. the window, with the port's own thread settings (the CLI sets none):
   for ``seconds`` seconds, ``process_frame(None, depth_i, timestamp)``
   then ``prefetch_depth(depth_{i+1})``, the loop replayed, each frame
   timed on the host clock from its call to its completion (a synchronise
   after it);
3. with ``trace``, the per-layer metrics: the phases of the window's
   frames, and a device trace over ``trace_cycles`` whole mask cycles of
   it; then the check (``check.py``), each checked frame's K1 launch
   traced too.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
MANIFEST = os.path.join(ROOT, "BENCHMARK.json")
FORBIDDEN = ("jax", "jaxlib", "flax", "emfusion_tpu")
CAMERA_HZ = 30.0
# the kernels whose device time is the LMs' (lm_device_ms)
LM_KERNELS = ("emf_lm_run_kernel", "emf_lm_cluster_kernel",
              "emf_capture_kernel")
K1_KERNEL = "emf_fusion_kernel"
# share of the image rows the raycast check follows
CHECK_ROW_SHARE = 0.2


def forbidden_modules(modules=None) -> List[str]:
    """The loaded modules whose top-level name (before the first dot) is
    JAX's, its libraries' or the JAX package's, compared whole."""
    mods = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in mods
                   if m.split(".")[0] in FORBIDDEN})


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict              # the manifest's workload entry
    config: dict             # configs/<name>.json
    mix: object              # traffic.Mix
    limits: dict             # limits/<cell>.json
    end_to_end: list         # the manifest's metrics of this cell
    per_layer: list


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, manifest_path: str = MANIFEST) -> Cell:
    from benchmark import traffic
    with open(manifest_path) as f:
        man = json.load(f)
    entry = next((w for w in man["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in {manifest_path}")
    conf = next(c for c in man["configs"] if c["name"] == entry["config"])
    with open(os.path.join(ROOT, conf["file"])) as f:
        config = json.load(f)
    mix = traffic.Mix.load(os.path.join(HERE, "traffic",
                                        f"{entry['traffic']}.json"))
    with open(os.path.join(HERE, "limits", f"{name}.json")) as f:
        limits = json.load(f)
    return Cell(name, entry, config, mix, limits,
                [m for m in man["end_to_end"] if _reports(m, name)],
                [m for m in man["per_layer"] if _reports(m, name)])


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py`` (dots and dashes of
    the name as underscores). A name ``<base>.<cell>`` with no file of its
    own is the per-layer form of ``<base>`` in one cell: the
    ``read_untraced`` function of ``metrics/<base>.py``."""
    mod = metric.replace(".", "_").replace("-", "_")
    if os.path.exists(os.path.join(HERE, "metrics", f"{mod}.py")):
        return importlib.import_module(f"benchmark.metrics.{mod}").read
    base = metric.split(".", 1)[0].replace("-", "_")
    return importlib.import_module(
        f"benchmark.metrics.{base}").read_untraced


def program_params(config: dict, **overrides):
    """The port's ``Params`` of a configuration file: its ``params`` and
    ``assumed`` knobs, and ``overrides``."""
    from emfusion_tpu_torch.config import Params, TSDFParams
    p = dict(config["params"], **config["assumed"])
    p.update(overrides)
    tp = TSDFParams(**p.pop("tsdfParams"))
    for k in ("frameSize", "globalVolumeDims", "objVolumeDims",
              "volumePose"):
        p[k] = tuple(p[k])
    return Params(tsdfParams=tp, **p)


@dataclasses.dataclass
class Window:
    """What a run measured; the metrics' readers read it."""
    frames: int = 0
    wall_s: float = 0.0
    latencies_s: List[float] = dataclasses.field(default_factory=list)
    setup_s: float = 0.0
    peak_bytes: int = 0
    phases: Dict[str, tuple] = dataclasses.field(default_factory=dict)
    mask_frames: int = 0
    phase_frames: int = 0              # frames the phases were read over
    span: Optional[object] = None      # trace.Span over whole mask cycles
    span_frames: int = 0
    traced: tuple = (0, 0)             # latencies_s[a:b] ran under the span
    k1: List[tuple] = dataclasses.field(default_factory=list)


def mask_provider(frames, period: int, mask_every: int):
    """The port's ``CallableMaskProvider``: at a mask frame, one detection
    (class 'car', score 0.9) per mover with its ground-truth mask; none
    where the mix has no movers."""
    from emfusion_tpu_torch.segmentation import (
        CallableMaskProvider, Detection, make_score_vector,
    )

    def detect(rgb, frame):
        if frame % mask_every:
            return None
        return [Detection(mask=m, scores=make_score_vector(3, 0.9))
                for m in frames.masks.get(frame % period, [])]
    return CallableMaskProvider(detect)


def card_info(torch) -> dict:
    info = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                count=1)
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30)
        info["power_limit_w"] = float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        info["power_limit_w"] = None
    return info


def run_cell(name: str, seed: int, seconds: float, trace: bool, t_start,
             device: str = "cuda", overrides: Optional[dict] = None,
             faults=None, control: bool = False,
             also_control: bool = False, limits: Optional[dict] = None,
             manifest_path: str = MANIFEST, look: bool = False,
             window_frames: int = 0, log=print) -> dict:
    """One run of cell ``name``; returns the result line's dict (with its
    checks' numbers under ``checks``). ``device="cpu"`` (the tests' tiny
    configurations; ``overrides`` replaces configuration keys) runs the
    plain versions and reports no device numbers. ``faults``: a callable
    given the pipeline after set-up, which may break it (the tests).
    ``control``: the checks read the control's outputs instead of the
    program's; ``also_control``: the result also has the control's numbers
    on the same frames (``control_checks``), for setting the limits;
    ``limits`` replaces the cell's (the tests' small size has its own);
    ``look``: each checked frame's camera LM is also looked at
    (``look.py``), under ``look`` in the result; ``window_frames``: the
    window ends after that many frames instead (which fixes the frames
    that the check follows)."""
    import torch

    from benchmark import check, traffic
    from benchmark.reference.frame import RefConfig

    cell = load_cell(name, manifest_path)
    overrides = dict(overrides or {})
    mix = cell.mix
    params = program_params(cell.config, **overrides)
    cuda = device == "cuda"
    dev = torch.device(device)

    from emfusion_tpu_torch import kernels
    from emfusion_tpu_torch.pipeline import EMFusionPipeline
    from emfusion_tpu_torch.profiling import PhaseTimer

    sync = torch.cuda.synchronize if cuda else (lambda: None)
    parts = Parts(t_start)
    parts.mark("imports")
    if cuda:
        torch.zeros(1, device=dev)
        sync()
        parts.mark("cuda")
        kernels.build()
        parts.mark("kernels")
    parts.host_probe_s = host_probe()
    mask_every = params.maskRCNNFrames
    period = mix.period
    frames = traffic.render_loop(mix, seed, params.width, params.height,
                                 params.fx, params.fy, params.cx, params.cy,
                                 mask_every, dev)
    if cuda:
        sync()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    parts.mark("render")
    provider = mask_provider(frames, period, mask_every)
    pipe = EMFusionPipeline(params, provider, device=dev)
    pipe.timer = PhaseTimer(dev, mode="events")
    if faults is not None:
        faults(pipe)
    depth = frames.depth
    sync()
    parts.mark("pipeline")

    def step(i):
        pipe.process_frame(None, depth[i % period], timestamp=i / CAMERA_HZ)
        pipe.prefetch_depth(depth[(i + 1) % period])

    i = 0
    for _ in range(mix.warmup_cycles * mask_every):
        step(i)
        i += 1
    sync()
    parts.mark("warmup")
    log(parts.line(torch), file=sys.stderr)

    w = Window()
    pipe.timer = PhaseTimer(dev, mode="events")
    span = None
    span_start = (-(-i // mask_every)) * mask_every
    span_end = span_start + mix.trace_cycles * mask_every
    tracing = trace and cuda
    t0 = time.perf_counter()
    w.setup_s = t0 - t_start
    cpu0 = (time.thread_time(), time.process_time())
    while True:
        if tracing and i == span_start:
            from benchmark.trace import Span
            span = Span(torch).__enter__()
            span.watch(pipe.timer)
            first = len(w.latencies_s)
        ts = time.perf_counter()
        step(i)
        sync()
        te = time.perf_counter()
        w.latencies_s.append(te - ts)
        w.mask_frames += i % mask_every == 0
        i += 1
        if span is not None and i == span_end:
            span.__exit__(None, None, None)
            span.unwatch(pipe.timer)
            w.span, w.span_frames = span, span_end - span_start
            w.traced = (first, len(w.latencies_s))
            span = None
            # the phases are read from the frames after the traced span
            pipe.timer = PhaseTimer(dev, mode="events")
        done = (len(w.latencies_s) >= window_frames if window_frames
                else te - t0 >= seconds)
        if done and (not tracing or i > span_end):
            break
    w.wall_s = time.perf_counter() - t0
    w.frames = len(w.latencies_s)
    cpu1 = (time.thread_time(), time.process_time())
    if cuda:
        w.peak_bytes = int(torch.cuda.max_memory_allocated())
    per_call = pipe.timer.ms_per_call()
    w.phases = {k: (per_call[k] * n, n) for k, n in pipe.timer.counts.items()}
    w.phase_frames = pipe.timer.counts.get("preprocess", 0)
    if w.span is not None:
        w.span.read()
        log(f"trace: {dict(w.span.cats)}; phases on host clock "
            f"{w.span.clock}", file=sys.stderr)
    log(f"window: {w.frames} frames in {w.wall_s:.3f} s; host CPU over it: "
        f"main thread {cpu1[0] - cpu0[0]:.3f} s, process "
        f"{cpu1[1] - cpu0[1]:.3f} s; load average {load_average()}",
        file=sys.stderr)

    # the check: the next mask frame, the one after it, one more from the
    # seed, each followed stage by stage
    cfg_ref = RefConfig.from_config(cell.config, **overrides)
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 2]))
    m = (-(-i // mask_every)) * mask_every
    picks = [m, m + 1, m + 2 + int(rng.integers(0, max(mask_every - 3, 1)))]
    picks = picks[:mix.check_frames]
    n_rows = max(1, int(CHECK_ROW_SHARE * params.height))
    rows = torch.as_tensor(np.sort(rng.choice(params.height, n_rows,
                                              replace=False)))
    numbers = ctl_numbers = ctl_one = None
    looks = []
    t_check = time.perf_counter()
    while i <= picks[-1]:
        if i not in picks:
            step(i)
            i += 1
            continue
        with check.Recorder(pipe) as rec, contextlib.ExitStack() as extra:
            if look:
                from benchmark.look import CameraItems
                items = extra.enter_context(CameraItems(pipe))
            if trace and cuda:
                from benchmark.trace import Span
                with Span(torch) as sp:
                    step(i)
                sp.read()
            else:
                step(i)
        sync()
        one = check.frame_numbers(rec, cfg_ref, rows, control)
        if also_control:
            ctl_one = check.frame_numbers(rec, cfg_ref, rows, True)
            ctl_numbers = check.merge(ctl_numbers, ctl_one)
        if look:
            from benchmark import look as lk
            looks.append(dict(lk.camera(rec, cfg_ref, items.items[0],
                                        pipe.track_cfg, i),
                              numbers=one, control=ctl_one))
            log("look: " + json.dumps(looks[-1]), file=sys.stderr)
        if trace and cuda:
            w.k1.append(_k1_sample(rec, sp, cfg_ref))
        del rec
        if cuda:
            torch.cuda.empty_cache()
        numbers = check.merge(numbers, one)
        i += 1
    log(f"check: {len(picks)} frames followed in "
        f"{time.perf_counter() - t_check:.1f} s; object LMs not settled "
        f"in the reference: {numbers['obj_unsettled']:.0f} at most a frame",
        file=sys.stderr)
    checks = check.judge(numbers, cell.limits if limits is None else limits)
    correct = all(c["ok"] for c in checks)

    metrics = {}
    for m_ in (cell.per_layer if trace else cell.end_to_end):
        val = reader(m_["name"])(w)
        if val is not None:
            metrics[m_["name"]] = dict(value=val, unit=m_["unit"])
    out = dict(correct=correct, attempted=w.frames, failed=0,
               metrics=metrics)
    if cuda:
        out["device"] = card_info(torch)
        out["device"]["memory_peak_bytes"] = w.peak_bytes
        if trace and w.span is not None:
            from benchmark import trace as tr
            out["device"]["busy_s"] = tr.busy_seconds(w.span.events)
            out["device"]["window_s"] = w.span.wall_s
            out["breakdown"] = dict(
                device_ops=tr.top_ops(w.span.events),
                idle_gaps=tr.idle_gaps(w.span.events, w.span.notes))
    if also_control:
        out["control_checks"] = ctl_numbers
    if look:
        out["look"] = looks
    out["checks"] = {c["name"]: dict(value=c["value"], limit=c["limit"])
                     for c in checks}
    return out


def _k1_sample(rec, span, cfg_ref) -> tuple:
    """(least seconds, device seconds) of a checked frame's K1 launch."""
    from benchmark import roofline
    from benchmark import trace as tr
    from benchmark.reference import ops
    (st_b, st_a), = rec.rec["integrate"]
    depth = rec.rec["preprocess"][0][1]
    cam_inv = ops.pose_inverse(st_b["cam_pose"])
    rel = cam_inv @ st_b["bg_pose"]
    items = [((st_b["bg_tsdf"], st_b["bg_weights"]),
              (st_a["bg_tsdf"], st_a["bg_weights"]), rel[:3, :3],
              rel[:3, 3], cfg_ref.voxel, cfg_ref.trunc)]
    vis = (st_b["active"] & st_b["visible"]).nonzero().flatten().tolist()
    for k in vis:
        rk = cam_inv @ st_b["pose"][k]
        items.append(((st_b["tsdf"][k], st_b["weights"][k]),
                      (st_a["tsdf"][k], st_a["weights"][k]), rk[:3, :3],
                      rk[:3, 3], float(st_b["voxel_size"][k]),
                      float(st_b["truncdist"][k])))
    nbytes, nops = roofline.fusion_work(items, depth, cfg_ref.intr)
    dev_s = tr.kernel_seconds(span.events, (K1_KERNEL,))
    return roofline.least_seconds(nbytes, nops), dev_s


class Parts:
    """Set-up's parts on the host clock, each from the end of the one
    before (the first from the process's start)."""

    def __init__(self, t_start):
        self.last = t_start
        self.s: Dict[str, float] = {}
        self.host_probe_s = 0.0

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.s[name] = now - self.last
        self.last = now

    def line(self, torch) -> str:
        return ("setup: " + ", ".join(f"{k} {v:.3f} s"
                                      for k, v in self.s.items())
                + f"; host probe {self.host_probe_s:.4f} s; intra-op "
                f"threads {torch.get_num_threads()}")


def host_probe() -> float:
    """Seconds of a fixed piece of single-threaded Python work: the host's
    own speed, logged beside each run's numbers."""
    t = time.perf_counter()
    acc = 0
    for k in range(1_000_000):
        acc += k * k % 7
    return time.perf_counter() - t


def load_average() -> str:
    try:
        with open("/proc/loadavg") as f:
            return " ".join(f.read().split()[:3])
    except OSError:
        return "unknown"


def percentile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, np.float64), q))
