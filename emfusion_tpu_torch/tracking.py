"""Direct SDF-gradient Levenberg-Marquardt pose tracking.

Port of ``emfusion_tpu/tracking.py`` (``TrackConfig``, ``track_volume``
with the capture sampler; reference ``TSDF.cpp:170-344`` and
``EMFusion::performTracking``, ``EMFusion.cpp:672-724``).

The per-point work runs on the volume's device: the window capture
(kernel K3), the tent-product residuals and Jacobians, the weights and
the 6x6 normal equations (one (6,N)x(N,6) product). The LM state machine
runs on the host in float32, as the reference does (it downloads the 6x6
system every iteration, ``TSDF.cpp:274-282``). An iteration that
evaluates the system reads it back once; every step then reads back the
trial error and the drift flag at the new pose together, so an iteration
waits for the device at most twice (a third time when the windows are
re-captured, at most ``max_recaptures`` times per call).

LM semantics as ``tracking.py:16-23`` of the JAX package:
  * ``mu = tau * max(diag(A))`` on the first iteration;
  * gradient convergence ``max|b| < eps1``;
  * step convergence ``|x| < eps2 (|log(rel_pose)| + eps2)``;
  * gain ratio ``rho = (err - err_new) / (0.5 x^T (mu x + b))`` with
    ``mu *= max(1/3, 1-(2 rho-1)^3)`` on accept, ``mu *= nu; nu *= nu_init``
    and reuse of the gradient on reject;
  * a re-capture of the windows when the pose drifts out of them, at most
    ``max_recaptures`` times per call (also after a step that is then
    rejected, as in the JAX loop).
"""

from __future__ import annotations

import dataclasses

import torch

from emfusion_tpu_torch.geometry.capture import (
    capture_neighborhoods, drift_ok, out_of_window_count,
    sample_system_from_cache, sample_value_from_cache,
)
from emfusion_tpu_torch.geometry.se3 import se3_exp, se3_log


@dataclasses.dataclass(frozen=True)
class TrackConfig:
    """Static LM parameters (reference ``TSDFParams``, ``data.h:32-71``).
    The LM always runs the capture sampler; the JAX package's per-
    iteration gather sampler and its banded-capture options are not
    ported (ROADMAP queue 1 item 7b)."""
    tau: float = 1e3
    eps1: float = 1e-8
    eps2: float = 1e-8
    nu_init: float = 2.0
    huber_thresh: float = 0.2
    max_tsdf_weight: float = 64.0
    max_iter: int = 100
    max_recaptures: int = 3


def _pose_mat(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    top = torch.cat([R, t[:, None]], dim=1)
    return torch.cat([top, torch.tensor([[0.0, 0.0, 0.0, 1.0]])], dim=0)


class _Window:
    """The captured windows and the pose helpers of one track call."""

    def __init__(self, tsdf, weights, voxel_size, points, cfg):
        self.vols = (tsdf, weights)
        self.vs = voxel_size
        self.points = points
        self.shape = tuple(tsdf.shape)
        self.cfg = cfg
        self.dev = points.device
        self.recaps = 0
        self.cache = self.anchor = None

    def dev_pose(self, R, t):
        return R.to(self.dev), t.to(self.dev)

    def capture(self, R, t):
        self.cache, self.anchor = capture_neighborhoods(
            self.vols, self.points, R, t, self.vs)

    def trial(self, w, R, t):
        """The error ``sum(w psi^2)`` at a trial pose, after re-centring
        the windows there if relevant points drifted out and the
        re-capture budget allows it (the JAX loop's ``maybe_recapture``
        before ``psi_new``). The drift flag and the error on the current
        windows come back in one read; a re-capture costs a second."""
        Rd, td = self.dev_pose(R, t)
        err = self.error(w, Rd, td)
        if self.recaps >= self.cfg.max_recaptures:
            return err.cpu()
        ok = drift_ok(self.anchor, self.points, Rd, td, self.vs, self.shape)
        host = torch.stack([err, ok.to(err.dtype)]).cpu()
        if bool(host[1]):
            return host[0]
        self.capture(Rd, td)
        self.recaps += 1
        return self.error(w, Rd, td).cpu()

    def error(self, w, Rd, td):
        psi = sample_value_from_cache(self.cache[0:1], self.anchor,
                                      self.points, Rd, td, self.vs,
                                      self.shape, margin=1)[0]
        return torch.sum(w * psi * psi)


def track_volume(tsdf: torch.Tensor, weights: torch.Tensor, voxel_size,
                 points: torch.Tensor, assoc: torch.Tensor,
                 rel_pose_co: torch.Tensor, cfg: TrackConfig):
    """Run the LM loop for one volume.

    Args:
      tsdf/weights: (Z, Y, X) float32 on the compute device.
      points: component-first (3, N) camera-space points on that device
        (invalid ones have z <= 0).
      assoc: (N,) association weights.
      rel_pose_co: (4, 4) initial camera-to-volume transform (host
        float32; the caller re-orthonormalises it).

    Returns (rel_pose_co_final (4, 4) host float32, stats dict with
    ``iterations``, ``converged``, ``grad_norm``, ``recaptures``,
    ``dropped_points`` (host numbers) and the per-point
    ``track_weights`` / ``huber_weights`` of the last gradient
    evaluation (device tensors)).
    """
    f32 = torch.float32
    shape = tuple(tsdf.shape)
    rel_pose_co = torch.as_tensor(rel_pose_co, dtype=f32).cpu()
    R, t = rel_pose_co[:3, :3].clone(), rel_pose_co[:3, 3].clone()
    win = _Window(tsdf, weights, voxel_size, points, cfg)
    win.capture(*win.dev_pose(R, t))

    def eval_system(R, t):
        """Residuals, Jacobian rows and combined weights at a pose (on the
        device), and the host copy of (A, b, err)."""
        Rd, td = win.dev_pose(R, t)
        psi, g3 = sample_system_from_cache(win.cache[0], win.anchor, points,
                                           Rd, td, voxel_size, shape)
        intw = sample_value_from_cache(win.cache[1:2], win.anchor, points,
                                       Rd, td, voxel_size, shape,
                                       margin=1)[0]
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
        return w, huber, host[:36].reshape(6, 6), host[36:42], host[42]

    mu = torch.tensor(0.0, dtype=f32)
    nu = torch.tensor(cfg.nu_init, dtype=f32)
    first, eval_grad, converged = True, True, False
    w = hub = None
    A, b = torch.eye(6, dtype=f32), torch.zeros(6, dtype=f32)
    err = torch.tensor(0.0, dtype=f32)
    it = 0
    while it < cfg.max_iter and not converged:
        if eval_grad:
            # The JAX loop checks the drift here too, but that check never
            # re-captures: the windows were captured at this pose, or the
            # step that reached it checked the drift at it already.
            w, hub, A, b, err = eval_system(R, t)
            converged = bool(torch.max(torch.abs(b)) < cfg.eps1)
        if not converged:
            mu0 = cfg.tau * torch.max(torch.diag(A)) if first else mu
            x = torch.linalg.solve(A + mu0 * torch.eye(6, dtype=f32), b)
            rel_vec = se3_log(_pose_mat(R, t))
            step_conv = bool(torch.linalg.norm(x) < cfg.eps2 * (
                torch.linalg.norm(rel_vec) + cfg.eps2))
            first = False
            if step_conv:
                mu = mu0
                converged = True
            else:
                dT = se3_exp(-x)
                R_new = dT[:3, :3] @ R
                t_new = dT[:3, :3] @ t + dT[:3, 3]
                err_new = win.trial(w, R_new, t_new)
                gain = 0.5 * torch.dot(x, mu0 * x + b)
                rho = (err - err_new) / torch.where(
                    torch.abs(gain) > 1e-30, gain, 1e-30)
                accept = bool(rho > 0)
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

    Rd, td = win.dev_pose(R, t)
    stats = {"iterations": it, "converged": converged,
             "grad_norm": float(torch.max(torch.abs(b))),
             "track_weights": w, "huber_weights": hub,
             "recaptures": win.recaps,
             "dropped_points": int(out_of_window_count(
                 win.anchor, points, Rd, td, voxel_size, shape))}
    return _pose_mat(R, t), stats
