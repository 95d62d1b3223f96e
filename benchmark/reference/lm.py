"""The plain reference's Levenberg-Marquardt pose tracking.

The LM state machine of the port's host loop (``tracking.
_track_volume_host``, a frozen copy; reference ``TSDF.cpp:170-344``), with
its two samplers written from their definitions:

* ``gather``: ψ and its gradient from the trilinear samples of the volume
  at every evaluation (:func:`~benchmark.reference.ops.
  sample_system_at_points`), the trial error at margin 1;
* ``window``: the same samples, valid only while the point stays inside
  the 6^3 voxel window captured around it at the capture pose (a window
  anchored at ``floor(v) - 2``, the local coordinate within ``[0, 4]`` on
  every axis, as ``geometry/capture.py`` defines it). A trial whose
  relevant points left their windows by more than 1% re-captures at the
  trial pose while the budget lasts; a step that leaves no weighted point
  with a valid ψ is rejected.

:func:`track` runs one LM; :func:`track_batched_slot` one slot of the
batched object LM: two fixed-window stages (no re-capture), the second
from the first's pose with a fresh LM, as ``tracking.
track_volumes_batched`` defines them.
"""

from __future__ import annotations

import dataclasses

import torch

from benchmark.reference import ops

_ANCHOR_OFF = 2


@dataclasses.dataclass(frozen=True)
class LMConfig:
    tau: float
    eps1: float
    eps2: float
    nu_init: float
    huber_thresh: float
    max_tsdf_weight: float
    max_iter: int
    max_recaptures: int


def _pose_mat(R, t):
    top = torch.cat([R, t[..., None]], dim=-1)
    row = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=top.dtype)
    return torch.cat([top, row.expand(top.shape[:-2] + (1, 4))], dim=-2)


class _Sampler:
    """What the LM reads at a pose: ψ, its gradient and the integration
    weight; with a window, only inside the captured windows."""

    def __init__(self, tsdf, weights, voxel_size, points, window: bool,
                 budget: int):
        self.tsdf, self.weights, self.vs = tsdf, weights, voxel_size
        self.points = points
        self.shape = tuple(tsdf.shape)
        self.dev = points.device
        self.window = window
        self.budget = budget
        self.recaps = 0
        self.anchor = None

    def dev_pose(self, R, t):
        return R.to(self.dev), t.to(self.dev)

    def capture(self, Rd, td):
        vx, vy, vz, _ = ops.transform_to_grid(self.points, Rd, td, self.vs,
                                              self.shape)
        self.anchor = torch.stack([torch.floor(v).to(torch.int32)
                                   - _ANCHOR_OFF for v in (vx, vy, vz)])

    def in_window(self, Rd, td):
        if not self.window:
            return None
        _, local = ops._local_coords(self.anchor, self.points, Rd, td,
                                     self.vs, self.shape)
        return ops._window_ok(*local)

    def system(self, Rd, td):
        psi, g3 = ops.sample_system_at_points(self.tsdf, self.points, Rd, td,
                                              self.vs)
        intw = ops.sample_volume_at_points_plain(self.weights, self.points,
                                                 Rd, td, self.vs, margin=1)
        ok = self.in_window(Rd, td)
        if ok is not None:
            psi = torch.where(ok, psi, 0.0)
            intw = torch.where(ok, intw, 0.0)
        return psi, g3, intw

    def error(self, w, Rd, td):
        """(sum(w psi^2), the weighted points with a valid ψ)."""
        psi = ops.sample_volume_at_points_plain(self.tsdf, self.points, Rd,
                                                td, self.vs, margin=1)
        vx, vy, vz, valid = ops._grid_and_valid(self.points, Rd, td,
                                                self.vs, self.shape, 1)
        ok = self.in_window(Rd, td)
        if ok is not None:
            psi = torch.where(ok, psi, 0.0)
            valid = valid & ok
        return (float(torch.sum(w * psi * psi)),
                int(torch.sum(valid & (w > 0))))

    def trial(self, w, R, t):
        Rd, td = self.dev_pose(R, t)
        err, nin = self.error(w, Rd, td)
        if not self.window or self.recaps >= self.budget:
            return err, nin
        nbad, nrel = ops.drift_counts(self.anchor, self.points, Rd, td,
                                      self.vs, self.shape)
        if bool(ops.drift_within(nbad, nrel)):
            return err, nin
        self.capture(Rd, td)
        self.recaps += 1
        return self.error(w, Rd, td)


def track(tsdf, weights, voxel_size, points, assoc, rel_pose, cfg: LMConfig,
          window: bool = False, budget: int = 0):
    """One LM from ``rel_pose`` (camera-to-volume, host float32 (4, 4)) over
    ``points`` (3, N) with association weights ``assoc`` (N,). Returns
    (the final pose (4, 4) host float32, iterations, converged, the (N,)
    weights of its last evaluation)."""
    f32 = torch.float32
    rel_pose = torch.as_tensor(rel_pose, dtype=f32).cpu()
    R, t = rel_pose[:3, :3].clone(), rel_pose[:3, 3].clone()
    win = _Sampler(tsdf, weights, voxel_size, points, window, budget)
    if window:
        win.capture(*win.dev_pose(R, t))

    def eval_system(R, t):
        Rd, td = win.dev_pose(R, t)
        psi, g3, intw = win.system(Rd, td)
        p = Rd @ points + td[:, None]
        J = torch.cat([g3, torch.linalg.cross(p, g3, dim=0)], dim=0)
        abs_psi = torch.abs(psi)
        huber = torch.where(
            abs_psi > 0,
            torch.clamp(cfg.huber_thresh / torch.clamp(abs_psi, min=1e-30),
                        max=1.0), 0.0)
        intw = torch.clamp(intw, max=cfg.max_tsdf_weight)
        wmax = torch.max(intw)
        intw = torch.where(wmax > 0, intw / wmax, 0.0)
        w = huber * intw * assoc
        Jw = J * w[None, :]
        A = Jw @ J.T
        b = Jw @ psi
        err = torch.sum(w * psi * psi)
        host = torch.cat([A.reshape(-1), b, err[None]]).cpu()
        return w, host[:36].reshape(6, 6), host[36:42], host[42]

    mu = torch.tensor(0.0, dtype=f32)
    nu = torch.tensor(cfg.nu_init, dtype=f32)
    first, eval_grad, converged = True, True, False
    w = None
    A, b = torch.eye(6, dtype=f32), torch.zeros(6, dtype=f32)
    err = torch.tensor(0.0, dtype=f32)
    it = 0
    while it < cfg.max_iter and not converged:
        if eval_grad:
            w, A, b, err = eval_system(R, t)
            converged = bool(torch.max(torch.abs(b)) < cfg.eps1)
        if not converged:
            mu0 = cfg.tau * torch.max(torch.diag(A)) if first else mu
            x = torch.linalg.solve(A + mu0 * torch.eye(6, dtype=f32), b)
            rel_vec = ops.se3_log(_pose_mat(R, t))
            step_conv = bool(torch.linalg.norm(x) < cfg.eps2 * (
                torch.linalg.norm(rel_vec) + cfg.eps2))
            first = False
            if step_conv:
                mu = mu0
                converged = True
            else:
                dT = ops.se3_exp(-x)
                R_new = dT[:3, :3] @ R
                t_new = dT[:3, :3] @ t + dT[:3, 3]
                err_new, nin = win.trial(w, R_new, t_new)
                if not window:
                    nin = 1
                gain = 0.5 * torch.dot(x, mu0 * x + b)
                rho = (err - err_new) / torch.where(
                    torch.abs(gain) > 1e-30, gain, 1e-30)
                accept = bool(rho > 0) and nin > 0
                if accept:
                    R, t = R_new, t_new
                    mu = mu0 * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3,
                                           min=1.0 / 3.0)
                    nu = torch.tensor(cfg.nu_init, dtype=f32)
                else:
                    mu = mu0 * nu
                    nu = nu * cfg.nu_init
                eval_grad = accept
        it += 1
    return _pose_mat(R, t), it, converged, w


def track_batched_slot(tsdf, weights, voxel_size, points, assoc, rel_pose,
                       cfg: LMConfig):
    """One slot of the batched object LM: a fixed-window LM of
    ``max(max_iter // 2, 1)`` iterations from ``rel_pose``, then, if it did
    not converge, a fixed-window LM captured at that pose for the rest of
    ``max_iter``. Returns (the final pose (4, 4) host float32, the weights
    of the last evaluation)."""
    half = max(cfg.max_iter // 2, 1)
    pose, _, conv, w = track(tsdf, weights, voxel_size, points, assoc,
                             rel_pose, dataclasses.replace(cfg, max_iter=half),
                             window=True, budget=0)
    if conv or cfg.max_iter - half <= 0:
        return pose, w
    pose, _, _, w = track(
        tsdf, weights, voxel_size, points, assoc, pose,
        dataclasses.replace(cfg, max_iter=cfg.max_iter - half), window=True,
        budget=0)
    return pose, w


def excess(tsdf, voxel_size, points, w, rel_a, rel_b) -> float:
    """How much worse pose ``rel_b`` fits than ``rel_a`` (camera-to-volume):
    ``sqrt(max(E(b) - E(a), 0) / sum(w))`` with ``E(T) = sum(w psi(T)^2)``,
    ψ sampled at margin 1 (TSDF units), the weights ``w`` held fixed. A move
    along a direction the points do not observe (a sphere's turn about its
    centre) costs nothing; any other move does."""
    def energy(rel):
        rel = rel.to(points.device)
        psi = ops.sample_volume_at_points_plain(tsdf, points, rel[:3, :3],
                                                rel[:3, 3], voxel_size, 1)
        return torch.sum(w.double() * psi.double() ** 2)
    tot = float(torch.sum(w.double()))
    if tot <= 0:
        return 0.0
    d = float(energy(rel_b) - energy(rel_a))
    return (max(d, 0.0) / tot) ** 0.5
