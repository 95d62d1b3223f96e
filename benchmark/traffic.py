"""The traffic generator: one general generator that reads a mix's data file.

A mix (``traffic/<name>.json``) describes an analytic room (spheres and
planes), the depth sensor's noise, a closed handheld camera loop and the
moving spheres with their ground-truth masks. Frames are rendered on the
device in torch, once per run, and handed to the port as host float32
depth in metres, as a reader hands them over. ``--seed`` draws the sensor
noise and the movers' phases; every seed renders the same loop, the same
number of movers and the same sizes.

The camera loop (camera-to-world, world = the first frame's camera)::

    theta = 2 pi i / period
    x = x_amp sin(theta), y = y_amp sin(2 theta), z = z_amp (1 - cos theta)
    yaw = atan2(-x, look_at_z - z)    (the camera turns towards a point
                                        on the first frame's axis)

A mover ``k`` with phase ``phi_k``::

    centre + (amp_x sin(theta + phi), amp_y sin(2 (theta + phi)),
              amp_z cos(theta + phi))

Both close after one period. Masks are each mover's pixels where it is
the nearest surface, handed in at ``mask_every`` frames as one detection
each.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class Mix:
    """A traffic mix as read from its data file."""
    name: str
    spheres: list            # [[x, y, z, r], ...] static
    planes: list             # [[nx, ny, nz, px, py, pz], ...]
    max_depth: float
    noise: dict              # sigma0, sigma2, z0, dropout
    loop: dict               # period, x_amp, y_amp, z_amp, look_at_z
    movers: list             # [{"centre": [...], "radius": r, "amp": [...]}]
    masks: bool              # a detector runs at the mask cadence
    warmup_cycles: int       # mask cycles of warm-up
    trace_cycles: int        # mask cycles in the traced span
    check_frames: int        # frames the correctness check follows

    @classmethod
    def load(cls, path: str) -> "Mix":
        with open(path) as f:
            d = json.load(f)
        return cls(name=d["name"], spheres=d["scene"]["spheres"],
                   planes=d["scene"]["planes"],
                   max_depth=float(d["scene"]["max_depth"]),
                   noise=d["noise"], loop=d["camera_loop"],
                   movers=d["movers"], masks=bool(d["masks"]),
                   warmup_cycles=int(d["warmup_cycles"]),
                   trace_cycles=int(d["trace_cycles"]),
                   check_frames=int(d["check_frames"]))

    @property
    def period(self) -> int:
        return int(self.loop["period"])


def camera_pose(mix: Mix, i) -> np.ndarray:
    """The camera-to-world pose (4, 4) float64 of loop frame ``i``."""
    lp = mix.loop
    th = 2.0 * math.pi * (i % mix.period) / mix.period
    x = lp["x_amp"] * math.sin(th)
    y = lp["y_amp"] * math.sin(2.0 * th)
    z = lp["z_amp"] * (1.0 - math.cos(th))
    yaw = math.atan2(-x, lp["look_at_z"] - z)
    c, s = math.cos(yaw), math.sin(yaw)
    return np.array([[c, 0, s, x], [0, 1, 0, y], [-s, 0, c, z],
                     [0, 0, 0, 1]], np.float64)


def mover_phases(mix: Mix, seed: int) -> np.ndarray:
    """Each mover's phase, drawn from the seed."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 1]))
    return rng.uniform(0.0, 2.0 * math.pi, len(mix.movers))


def mover_centres(mix: Mix, phases, i) -> List[tuple]:
    """(centre (3,) float64, radius) of every mover at loop frame ``i``."""
    th = 2.0 * math.pi * (i % mix.period) / mix.period
    out = []
    for m, ph in zip(mix.movers, phases):
        a = m["amp"]
        off = np.array([a[0] * math.sin(th + ph),
                        a[1] * math.sin(2.0 * (th + ph)),
                        a[2] * math.cos(th + ph)])
        out.append((np.asarray(m["centre"], np.float64) + off,
                    float(m["radius"])))
    return out


class Renderer:
    """Depth of the mix's room, and the movers' masks, seen through a
    pinhole camera of the configuration's size and intrinsics, on
    ``device`` in float64."""

    def __init__(self, mix: Mix, width: int, height: int, fx, fy, cx, cy,
                 device):
        self.mix, self.H, self.W = mix, height, width
        self.dev = torch.device(device)
        f64 = torch.float64
        ys, xs = torch.meshgrid(torch.arange(height, dtype=f64,
                                             device=self.dev),
                                torch.arange(width, dtype=f64,
                                             device=self.dev),
                                indexing="ij")
        d = torch.stack([(xs - cx) / fx, (ys - cy) / fy,
                         torch.ones_like(xs)], -1)
        self.dirs = d / torch.linalg.norm(d, dim=-1, keepdim=True)

    def _sphere_t(self, c_cam, r):
        b = -2.0 * (self.dirs @ c_cam)
        disc = b * b - 4.0 * (c_cam @ c_cam - r * r)
        ts = torch.where(disc > 0, (-b - torch.sqrt(torch.clamp(disc, min=0)))
                         / 2.0, torch.inf)
        return torch.where(ts > 0, ts, torch.inf)

    def render(self, cam_pose: np.ndarray, objects=()):
        """(depth (H, W) float64 on the device, 0 where nothing is hit
        within ``max_depth``; per object its bool mask)."""
        T = torch.as_tensor(np.linalg.inv(cam_pose), device=self.dev)
        R, t = T[:3, :3], T[:3, 3]
        best = torch.full((self.H, self.W), torch.inf, dtype=torch.float64,
                          device=self.dev)
        for x, y, z, r in self.mix.spheres:
            c = R @ torch.tensor([x, y, z], dtype=torch.float64,
                                 device=self.dev) + t
            best = torch.minimum(best, self._sphere_t(c, r))
        for nx, ny, nz, px, py, pz in self.mix.planes:
            n = R @ torch.tensor([nx, ny, nz], dtype=torch.float64,
                                 device=self.dev)
            p = R @ torch.tensor([px, py, pz], dtype=torch.float64,
                                 device=self.dev) + t
            den = self.dirs @ n
            tp = torch.where(torch.abs(den) > 1e-9, (p @ n) / den,
                             torch.inf)
            best = torch.minimum(best, torch.where(tp > 0, tp, torch.inf))
        t_obj = []
        for c_w, r in objects:
            c = R @ torch.as_tensor(c_w, device=self.dev) + t
            t_obj.append(self._sphere_t(c, r))
            best = torch.minimum(best, t_obj[-1])
        depth = torch.where(torch.isfinite(best), best * self.dirs[..., 2],
                            0.0)
        depth = torch.where(depth > self.mix.max_depth, 0.0, depth)
        masks = [torch.isfinite(to) & (to <= best) for to in t_obj]
        return depth, masks


def sensor_noise(mix: Mix, depth: torch.Tensor, gen: torch.Generator):
    """Depth as a structured-light sensor gives it: axial noise growing
    with range (sigma = sigma0 + sigma2 (z - z0)^2, Nguyen et al.,
    3DIMPVT 2012) and a share ``dropout`` of the pixels dropped; float32."""
    nz = mix.noise
    sigma = nz["sigma0"] + nz["sigma2"] * (depth - nz["z0"]) ** 2
    noise = torch.randn(depth.shape, generator=gen, dtype=torch.float64,
                        device=depth.device)
    drop = torch.rand(depth.shape, generator=gen, dtype=torch.float64,
                      device=depth.device)
    keep = (depth > 0) & (drop >= nz["dropout"])
    return torch.where(keep, depth + sigma * noise, 0.0).to(torch.float32)


@dataclasses.dataclass
class Frames:
    """One loop of rendered frames: host float32 depth per loop frame, the
    ground-truth camera poses, and per mask frame the movers' masks."""
    depth: List[np.ndarray]
    poses: List[np.ndarray]
    masks: dict              # loop frame -> [bool (H, W) per mover]
    phases: np.ndarray


def render_loop(mix: Mix, seed: int, width: int, height: int, fx, fy, cx,
                cy, mask_every: int, device) -> Frames:
    """Render the loop's ``period`` frames on ``device`` with noise drawn
    from ``seed``; masks at the frames that are multiples of
    ``mask_every``."""
    ren = Renderer(mix, width, height, fx, fy, cx, cy, device)
    gen = torch.Generator(device=ren.dev)
    gen.manual_seed(int(seed) % (1 << 63))
    phases = mover_phases(mix, seed)
    depth, poses, masks = [], [], {}
    for i in range(mix.period):
        pose = camera_pose(mix, i)
        objs = mover_centres(mix, phases, i)
        d, m = ren.render(pose, objs)
        depth.append(sensor_noise(mix, d, gen))
        poses.append(pose)
        if mix.masks and i % mask_every == 0:
            masks[i] = m
    # one copy to the host for the loop, and one for the masks
    depth = list(torch.stack(depth).cpu().numpy())
    if masks:
        keys = sorted(masks)
        flat = [mk for k in keys for mk in masks[k]]
        host = list(torch.stack(flat).cpu().numpy()) if flat else []
        n = len(mix.movers)
        masks = {k: host[j * n:(j + 1) * n] for j, k in enumerate(keys)}
    return Frames(depth, poses, masks, phases)


def clearance(mix: Mix, phases, n_steps: Optional[int] = None) -> float:
    """The smallest gap (m) over the loop between two movers' surfaces, and
    between a mover and a static sphere."""
    n_steps = n_steps or mix.period
    gap = math.inf
    for i in range(n_steps):
        ms = mover_centres(mix, phases, i)
        for a in range(len(ms)):
            for b in range(a + 1, len(ms)):
                gap = min(gap, float(np.linalg.norm(ms[a][0] - ms[b][0]))
                          - ms[a][1] - ms[b][1])
            for x, y, z, r in mix.spheres:
                gap = min(gap, float(np.linalg.norm(
                    ms[a][0] - np.array([x, y, z]))) - ms[a][1] - r)
    return gap
