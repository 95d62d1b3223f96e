"""Direct SDF-gradient Levenberg-Marquardt pose tracking.

Port of ``emfusion_tpu/tracking.py`` (``TrackConfig``, ``track_volume``
with its two samplers, and ``track_volumes_batched``; reference
``TSDF.cpp:170-344`` and ``EMFusion::performTracking``,
``EMFusion.cpp:672-724``).

The per-point work runs on the volume's device: the residuals, Jacobian
rows, weights and the 6x6 normal equations (one (6,N)x(N,6) product).
The LM state machine runs on the host in float32, as the reference does
(it downloads the 6x6 system every iteration, ``TSDF.cpp:274-282``). An
iteration that evaluates the system reads it back once and every step
reads back its trial error once, so an iteration waits for the device at
most twice.

``TrackConfig.sampler`` picks how the volume is read, as in the JAX
package:

  * ``gather`` re-samples the volume at every evaluation, as the
    reference's kernels do: :func:`~emfusion_tpu_torch.geometry.sampling.
    sample_system_at_points` gives ψ and its gradient from one 27-corner
    gather per point, and the trial error samples ψ at margin 1. Nothing
    is captured: ``recaptures`` and ``dropped_points`` are 0. This is the
    exact path, and the default (:func:`~emfusion_tpu_torch.config.
    resolve_params` resolves the pipeline's ``auto`` to it outside the
    accelerator configuration).
  * ``capture`` gathers each point's 6^3 window once (kernel K3) and
    evaluates the iterations from the cache, re-capturing when the pose
    drifts out of the windows, at most ``max_recaptures`` times per call
    (also after a step that is then rejected, as in the JAX loop); past
    that budget, points that left their windows drop out of the system.
    The drift flag is read with the trial error, so a re-capture costs a
    third read. The JAX package runs it on its accelerators, and the port
    under ``capture_backend="band"``.

LM semantics as ``tracking.py:16-23`` of the JAX package:
  * ``mu = tau * max(diag(A))`` on the first iteration;
  * gradient convergence ``max|b| < eps1``;
  * step convergence ``|x| < eps2 (|log(rel_pose)| + eps2)``;
  * gain ratio ``rho = (err - err_new) / (0.5 x^T (mu x + b))`` with
    ``mu *= max(1/3, 1-(2 rho-1)^3)`` on accept, ``mu *= nu; nu *= nu_init``
    and reuse of the gradient on reject.

With a ``group`` (:mod:`~emfusion_tpu_torch.distributed.comm`), each rank
of it holds its block of the tracking points and :func:`track_volume` is
the pixel-sharded LM of the JAX package's ``test_pixel_sharded_gn_
tracking_matches`` (``reduceAb``, ``TSDF.cpp:375-389``): the weight
maximum is an all-reduce MAX, the 43 floats of (A, b, err) an all-reduce
SUM before the host reads them, and every trial error (with the capture
sampler's drift flag) an all-reduce SUM too, so every rank takes the same
decisions and ends on the same pose bits.

:func:`track_volumes_batched` runs the same LM for S object slots at once,
against caches that stay fixed within each of its two stages (one K3
launch for all slots before each stage), whatever ``sampler`` says, as in
the JAX package: every device computation of an iteration is one set of
batched tensor ops over the slot axis, and the device is read once for
all slots' systems and once for all slots' trial errors.
"""

from __future__ import annotations

import dataclasses

import torch

from emfusion_tpu_torch.distributed import comm
from emfusion_tpu_torch.geometry.capture import (
    capture_neighborhoods, capture_neighborhoods_batched, drift_counts,
    drift_within,
    out_of_window_count, sample_system_from_cache, sample_value_from_cache,
)
from emfusion_tpu_torch.geometry.sampling import (
    sample_system_at_points, sample_volume_at_points_plain,
)
from emfusion_tpu_torch.geometry.se3 import se3_exp, se3_log

@dataclasses.dataclass(frozen=True)
class TrackConfig:
    """Static LM parameters (reference ``TSDFParams``, ``data.h:32-71``).

    ``sampler``: ``gather`` or ``capture``, see the module's docstring;
    :func:`track_volumes_batched` ignores it. The
    JAX package's banded-capture options are not ported (the port's K3
    gathers each window exactly)."""
    tau: float = 1e3
    eps1: float = 1e-8
    eps2: float = 1e-8
    nu_init: float = 2.0
    huber_thresh: float = 0.2
    max_tsdf_weight: float = 64.0
    max_iter: int = 100
    max_recaptures: int = 3
    sampler: str = "gather"

    def __post_init__(self):
        if self.sampler not in ("gather", "capture"):
            raise ValueError(f"sampler={self.sampler!r}: 'gather' or "
                             "'capture'")


def _pose_mat(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) poses from (..., 3, 3) rotations and (..., 3)
    translations."""
    top = torch.cat([R, t[..., None]], dim=-1)
    row = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=top.dtype)
    return torch.cat([top, row.expand(top.shape[:-2] + (1, 4))], dim=-2)


class _Sampler:
    """What a track call's sampler reads: the volumes, the points, and the
    poses moved to the points' device."""

    def __init__(self, tsdf, weights, voxel_size, points, cfg, group=None):
        self.tsdf, self.weights = tsdf, weights
        self.group = group
        self.vs = voxel_size
        self.points = points
        self.shape = tuple(tsdf.shape)
        self.cfg = cfg
        self.dev = points.device
        self.recaps = 0

    def dev_pose(self, R, t):
        return R.to(self.dev), t.to(self.dev)

    def reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` reduced over the group's ranks (itself without one)."""
        return t if self.group is None else comm.all_reduce(self.group, t,
                                                            op)


class _Gather(_Sampler):
    """The gather sampler: every evaluation samples the volumes at the
    points (``tracking.py:197-201, 283-286`` of the JAX package)."""

    def system(self, Rd, td):
        """(psi, g3, integration weight) at a pose."""
        psi, g3 = sample_system_at_points(self.tsdf, self.points, Rd, td,
                                          self.vs)
        intw = sample_volume_at_points_plain(self.weights, self.points, Rd,
                                             td, self.vs, margin=1)
        return psi, g3, intw

    def trial(self, w, R, t):
        """The error ``sum(w psi^2)`` at a trial pose, read back."""
        Rd, td = self.dev_pose(R, t)
        psi = sample_volume_at_points_plain(self.tsdf, self.points, Rd, td,
                                            self.vs, margin=1)
        return self.reduce(torch.sum(w * psi * psi)[None]).cpu()[0]

    def dropped(self, Rd, td) -> int:
        return 0


class _Window(_Sampler):
    """The capture sampler: the captured windows and their re-capture
    budget."""

    def capture(self, R, t):
        self.cache, self.anchor = capture_neighborhoods(
            (self.tsdf, self.weights), self.points, R, t, self.vs)

    def system(self, Rd, td):
        """(psi, g3, integration weight) at a pose, from the cache."""
        psi, g3 = sample_system_from_cache(self.cache[0], self.anchor,
                                           self.points, Rd, td, self.vs,
                                           self.shape)
        intw = sample_value_from_cache(self.cache[1:2], self.anchor,
                                       self.points, Rd, td, self.vs,
                                       self.shape, margin=1)[0]
        return psi, g3, intw

    def trial(self, w, R, t):
        """The error ``sum(w psi^2)`` at a trial pose, after re-centring
        the windows there if relevant points drifted out and the
        re-capture budget allows it (the JAX loop's ``maybe_recapture``
        before ``psi_new``). The drift flag and the error on the current
        windows come back in one read; a re-capture costs a second."""
        Rd, td = self.dev_pose(R, t)
        err = self.error(w, Rd, td)
        if self.recaps >= self.cfg.max_recaptures:
            return self.reduce(err[None]).cpu()[0]
        nbad, nrel = drift_counts(self.anchor, self.points, Rd, td, self.vs,
                                  self.shape)
        # the error and the drift counts in one read (and one reduction)
        host = self.reduce(torch.stack([err, nbad, nrel])).cpu()
        if bool(drift_within(host[1], host[2])):
            return host[0]
        self.capture(Rd, td)
        self.recaps += 1
        return self.reduce(self.error(w, Rd, td)[None]).cpu()[0]

    def error(self, w, Rd, td):
        psi = sample_value_from_cache(self.cache[0:1], self.anchor,
                                      self.points, Rd, td, self.vs,
                                      self.shape, margin=1)[0]
        return torch.sum(w * psi * psi)

    def dropped(self, Rd, td) -> int:
        """Relevant points outside their windows at the final pose: they
        contributed nothing since the last capture."""
        n = out_of_window_count(self.anchor, self.points, Rd, td, self.vs,
                                self.shape)
        return int(self.reduce(n.reshape(1).to(torch.int64))[0])


def track_volume(tsdf: torch.Tensor, weights: torch.Tensor, voxel_size,
                 points: torch.Tensor, assoc: torch.Tensor,
                 rel_pose_co: torch.Tensor, cfg: TrackConfig, group=None):
    """Run the LM loop for one volume with ``cfg``'s sampler; with a
    ``group``, over this rank's block of the points (the pixel-sharded LM
    of the module's docstring).

    Args:
      tsdf/weights: (Z, Y, X) float32 on the compute device.
      points: component-first (3, N) camera-space points on that device
        (invalid ones have z <= 0).
      assoc: (N,) association weights.
      rel_pose_co: (4, 4) initial camera-to-volume transform (host
        float32; the caller re-orthonormalises it).

    Returns (rel_pose_co_final (4, 4) host float32, stats dict with
    ``iterations``, ``converged``, ``grad_norm``, ``recaptures``,
    ``dropped_points`` (host numbers; the last two are 0 under
    ``gather``) and the per-point ``track_weights`` / ``huber_weights``
    of the last gradient evaluation (device tensors)).
    """
    f32 = torch.float32
    rel_pose_co = torch.as_tensor(rel_pose_co, dtype=f32).cpu()
    R, t = rel_pose_co[:3, :3].clone(), rel_pose_co[:3, 3].clone()
    if cfg.sampler == "gather":
        win = _Gather(tsdf, weights, voxel_size, points, cfg, group)
    else:
        win = _Window(tsdf, weights, voxel_size, points, cfg, group)
        win.capture(*win.dev_pose(R, t))

    def eval_system(R, t):
        """Residuals, Jacobian rows and combined weights at a pose (on the
        device), and the host copy of (A, b, err)."""
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
        wmax = win.reduce(torch.max(intw)[None], "max")[0]
        intw = torch.where(wmax > 0, intw / wmax, 0.0)
        w = huber * intw * assoc
        Jw = J * w[None, :]
        A = Jw @ J.T
        b = Jw @ psi
        err = torch.sum(w * psi * psi)
        host = win.reduce(torch.cat([A.reshape(-1), b, err[None]])).cpu()
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
            # The JAX capture loop checks the drift here too, but that
            # check never re-captures: the windows were captured at this
            # pose, or the step that reached it checked the drift there.
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
             "dropped_points": win.dropped(Rd, td)}
    return _pose_mat(R, t), stats


def _system(cache, anchor, points, assoc, Rd, td, vs, shape,
            cfg: TrackConfig):
    """The LM system of S slots at their poses, on the device: residuals
    from the fixed caches, Jacobian rows, combined weights, and the (S, 6,
    6) normal equations. Returns (w, huber (S, M), A, b, err)."""
    psi, g3 = sample_system_from_cache(cache[:, 0], anchor, points, Rd, td,
                                       vs, shape)
    intw = sample_value_from_cache(cache[:, 1:2], anchor, points, Rd, td,
                                   vs, shape, margin=1)[:, 0]
    p = Rd @ points + td[..., None]
    J = torch.cat([g3, torch.linalg.cross(p, g3, dim=-2)], dim=-2)
    abs_psi = torch.abs(psi)
    huber = torch.where(
        abs_psi > 0,
        torch.clamp(cfg.huber_thresh / torch.clamp(abs_psi, min=1e-30),
                    max=1.0), 0.0)
    intw = torch.clamp(intw, max=cfg.max_tsdf_weight)
    wmax = torch.amax(intw, dim=-1, keepdim=True)
    intw = torch.where(wmax > 0, intw / wmax, 0.0)
    w = huber * intw * assoc
    Jw = J * w[:, None, :]
    A = Jw @ J.transpose(-1, -2)
    b = (Jw @ psi[..., None])[..., 0]
    err = torch.sum(w * psi * psi, dim=-1)
    return w, huber, A, b, err


@dataclasses.dataclass
class _Stage:
    """One fixed-cache LM stage of S slots: poses, flags and counts on
    the host, the last gradient evaluation's weights on the device."""
    R: torch.Tensor           # (S, 3, 3)
    t: torch.Tensor           # (S, 3)
    converged: torch.Tensor   # (S,) bool
    it: torch.Tensor          # (S,) int64
    w: torch.Tensor           # (S, M)
    hub: torch.Tensor         # (S, M)
    reads: int                # device -> host reads
    loops: int                # passes of the batched loop


def _lm_fixed_cache(cache, anchor, points, assoc, R, t, vs, shape,
                    cfg: TrackConfig, active, max_iter: int) -> _Stage:
    """The LM of ``tracking.py:394-498`` of the JAX package for S slots
    against fixed caches (S, 2, 6, 6, 6, M): no re-capture inside, so
    points that drift out of their windows drop out through the window
    mask. Every slot starts afresh (``mu`` 0, ``nu`` ``nu_init``, a first
    iteration, a gradient to evaluate; converged where not ``active``)
    and iterates until it converges or reaches ``max_iter``, as the JAX
    loop under ``vmap`` does: the loop runs while any slot runs, and a
    slot that has stopped keeps its state exactly. Per pass the device is
    read once for the systems of the slots that evaluate a gradient and
    once for the trial errors of the slots that take a step; the 6x6
    solves and the accept / reject logic run on the host in float32."""
    f32 = torch.float32
    dev = points.device
    S = points.shape[0]
    R, t = R.clone(), t.clone()
    vs_d = vs.to(dev)
    eye = torch.eye(6, dtype=f32)
    mu = torch.zeros(S, dtype=f32)
    nu = torch.full((S,), cfg.nu_init, dtype=f32)
    first = torch.ones(S, dtype=torch.bool)
    eval_grad = torch.ones(S, dtype=torch.bool)
    converged = ~active
    A = eye.repeat(S, 1, 1)
    b = torch.zeros((S, 6), dtype=f32)
    err = torch.zeros(S, dtype=f32)
    it = torch.zeros(S, dtype=torch.int64)
    w = torch.zeros(points[:, 0].shape, dtype=f32, device=dev)
    hub = torch.zeros_like(w)
    reads = loops = 0
    while True:
        run = (it < max_iter) & ~converged
        if not bool(run.any()):
            break
        loops += 1
        ev = run & eval_grad
        if bool(ev.any()):
            w_e, hub_e, A_e, b_e, err_e = _system(
                cache, anchor, points, assoc, R.to(dev), t.to(dev), vs_d,
                shape, cfg)
            host = torch.cat([A_e.reshape(S, 36), b_e, err_e[:, None]],
                             dim=1).cpu()
            reads += 1
            ev_d = ev.to(dev)[:, None]
            w = torch.where(ev_d, w_e, w)
            hub = torch.where(ev_d, hub_e, hub)
            A = torch.where(ev[:, None, None], host[:, :36].reshape(S, 6, 6),
                            A)
            b = torch.where(ev[:, None], host[:, 36:42], b)
            err = torch.where(ev, host[:, 42], err)
            converged = converged | (
                ev & (torch.amax(torch.abs(b), dim=-1) < cfg.eps1))
        ii = torch.nonzero(run & ~converged).flatten()
        if len(ii):
            Ai, bi, Ri, ti = A[ii], b[ii], R[ii], t[ii]
            mu0 = torch.where(first[ii], cfg.tau * torch.amax(
                torch.diagonal(Ai, dim1=-2, dim2=-1), dim=-1), mu[ii])
            x = torch.linalg.solve(Ai + mu0[:, None, None] * eye, bi)
            rel_vec = se3_log(_pose_mat(Ri, ti))
            step_conv = torch.linalg.norm(x, dim=-1) < cfg.eps2 * (
                torch.linalg.norm(rel_vec, dim=-1) + cfg.eps2)
            dT = se3_exp(-x)
            R_new = dT[:, :3, :3] @ Ri
            t_new = (dT[:, :3, :3] @ ti[..., None])[..., 0] + dT[:, :3, 3]
            trial = ~step_conv
            err_new = err[ii]
            if bool(trial.any()):
                R_try, t_try = R.clone(), t.clone()
                R_try[ii], t_try[ii] = R_new, t_new
                psi = sample_value_from_cache(
                    cache[:, 0:1], anchor, points, R_try.to(dev),
                    t_try.to(dev), vs_d, shape, margin=1)[:, 0]
                err_new = torch.sum(w * psi * psi, dim=-1).cpu()[ii]
                reads += 1
            gain = 0.5 * torch.sum(x * (mu0[:, None] * x + bi), dim=-1)
            rho = (err[ii] - err_new) / torch.where(
                torch.abs(gain) > 1e-30, gain, 1e-30)
            accept = rho > 0
            step = trial & accept
            R[ii] = torch.where(step[:, None, None], R_new, Ri)
            t[ii] = torch.where(step[:, None], t_new, ti)
            mu_acc = mu0 * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3,
                                       min=1.0 / 3.0)
            mu[ii] = torch.where(trial, torch.where(accept, mu_acc,
                                                    mu0 * nu[ii]), mu0)
            nu[ii] = torch.where(trial, torch.where(
                accept, torch.tensor(cfg.nu_init, dtype=f32),
                nu[ii] * cfg.nu_init), nu[ii])
            first[ii] = False
            eval_grad[ii] = torch.where(trial, accept, eval_grad[ii])
            converged[ii] = converged[ii] | step_conv
        it = it + run.to(torch.int64)
    return _Stage(R=R, t=t, converged=converged, it=it, w=w, hub=hub,
                  reads=reads, loops=loops)


def track_volumes_batched(tsdfs, weights, voxel_sizes, points: torch.Tensor,
                          assoc: torch.Tensor, rel_poses, cfg: TrackConfig,
                          active):
    """The batched object LM (``tracking.py:501-571`` of the JAX package):
    S slots tracked together in two fixed-cache stages,

      1. one capture of every slot's windows at its initial pose (one K3
         launch), then the LM for ``max(max_iter // 2, 1)`` iterations;
      2. for the slots that are active and not converged, a capture at
         their stage-1 poses (one K3 launch) and a fresh LM for the rest of
         ``max_iter``.

    Args: ``tsdfs``/``weights`` S (Z, Y, X) volumes of one shape on the
    compute device (a sequence or a stacked tensor), ``voxel_sizes`` (S,),
    ``points`` (S, 3, M) camera points and ``assoc`` (S, M) association
    weights on the device, ``rel_poses`` (S, 4, 4) initial camera-to-
    volume transforms and ``active`` (S,) bool, on the host (float32; the
    caller re-orthonormalises the poses).

    Returns (poses (S, 4, 4) host float32, stats): ``iterations``,
    ``converged`` and ``recaptures`` (S,) on the host; ``dropped_points``
    (S,) on the device, each slot's relevant points outside its last
    stage's windows at its final pose (computed once per slot, and not
    read here: a caller that reads it pays that read);
    ``track_weights`` and ``huber_weights`` (S, M) of each slot's last
    gradient evaluation on the device; and ``host_reads`` and
    ``loop_iterations``, the device reads and the passes of the batched
    loops over both stages.
    An inactive slot keeps its pose, with 0 iterations and zero weights,
    and counts as converged (as in the JAX package)."""
    f32 = torch.float32
    shape = tuple(tsdfs[0].shape)
    vs = torch.as_tensor(voxel_sizes, dtype=f32).cpu()
    rel = torch.as_tensor(rel_poses, dtype=f32).cpu()
    active = torch.as_tensor(active, dtype=torch.bool).cpu()
    R0, t0 = rel[:, :3, :3], rel[:, :3, 3]
    half = max(cfg.max_iter // 2, 1)
    cache, anchor = capture_neighborhoods_batched(tsdfs, weights, points, R0,
                                                  t0, vs)
    s1 = _lm_fixed_cache(cache, anchor, points, assoc, R0, t0, vs, shape,
                         cfg, active, half)
    del cache
    dev = points.device
    R, t, w, hub, it, converged = s1.R, s1.t, s1.w, s1.hub, s1.it, \
        s1.converged
    reads, loops = s1.reads, s1.loops
    dropped = torch.zeros(len(active), dtype=torch.int64, device=dev)
    final = torch.nonzero(active & s1.converged).flatten()
    if len(final):
        idx = final.to(dev)
        dropped[idx] = out_of_window_count(
            anchor[idx], points[idx], R[final].to(dev), t[final].to(dev),
            vs[final].to(dev), shape)
    recaps = torch.zeros_like(it)
    again = torch.nonzero(active & ~s1.converged).flatten()
    if len(again):
        sel = again.tolist()
        idx = again.to(dev)
        cache, anchor = capture_neighborhoods_batched(
            [tsdfs[k] for k in sel], [weights[k] for k in sel], points[idx],
            R[again], t[again], vs[again])
        s2 = _lm_fixed_cache(cache, anchor, points[idx], assoc[idx],
                             R[again], t[again], vs[again], shape, cfg,
                             torch.ones(len(sel), dtype=torch.bool),
                             cfg.max_iter - half)
        R[again], t[again] = s2.R, s2.t
        it[again] += s2.it
        converged[again] = s2.converged
        recaps[again] = 1
        w[idx], hub[idx] = s2.w, s2.hub
        reads, loops = reads + s2.reads, loops + s2.loops
        dropped[idx] = out_of_window_count(anchor, points[idx],
                                           s2.R.to(dev), s2.t.to(dev),
                                           vs[again].to(dev), shape)
    stats = {"iterations": it, "converged": converged, "recaptures": recaps,
             "dropped_points": dropped,
             "track_weights": w, "huber_weights": hub,
             "host_reads": reads, "loop_iterations": loops}
    return _pose_mat(R, t), stats
