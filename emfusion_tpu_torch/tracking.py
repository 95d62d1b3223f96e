"""Direct SDF-gradient Levenberg-Marquardt pose tracking.

Port of ``emfusion_tpu/tracking.py`` (``TrackConfig``, ``track_volume``
with its two samplers, and ``track_volumes_batched``; reference
``TSDF.cpp:170-344`` and ``EMFusion::performTracking``,
``EMFusion.cpp:672-724``).

``TrackConfig.sampler`` picks how the volume is read, as in the JAX
package:

  * ``gather`` re-samples the volume at every evaluation, as the
    reference's kernels do: ψ and its gradient from one 27-corner gather
    per point (:func:`~emfusion_tpu_torch.geometry.sampling.
    sample_system_at_points`), and the trial error samples ψ at margin 1.
    Nothing is captured: ``recaptures`` and ``dropped_points`` are 0. This
    is the exact path, and the default (:func:`~emfusion_tpu_torch.config.
    resolve_params` resolves the pipeline's ``auto`` to it outside the
    accelerator configuration). The whole loop stays on the device, as
    the JAX package's ``lax.while_loop`` does (``tracking.py:242-352``
    there): see "The device-resident LM" below. The per-iteration host
    loop that the port ran before (:func:`_track_volume_host`, which the
    pixel-sharded capture sampler still runs) is kept as its reference.
  * ``capture`` gathers each point's 6^3 window once (kernel K3) and
    evaluates the iterations from the cache, re-capturing at the trial
    pose when the points drift out of the windows, at most
    ``max_recaptures`` times per call (also before a step that is then
    rejected, as in the JAX loop); past that budget, points that left
    their windows drop out of the system. The JAX package runs it on its
    accelerators, and the port under ``capture_backend="band"``. A trial
    step that leaves no point with weight a valid ψ (in its window and
    the volume) is rejected: its error, an empty sum, is 0 (the
    empty-window guard below). Its LM runs on the device as a table of
    cache items with a re-capture budget (:func:`track_volumes_capture`,
    "Re-capturing cache items" below): the camera's, or every serial
    object LM of a frame. With a ``group`` (the pixel-sharded LM) it runs
    on the host in float32 (:func:`_track_volume_host`), as the reference
    does (it downloads the 6x6 system every iteration,
    ``TSDF.cpp:274-282``): an iteration that evaluates the system reads
    it back once and every step reads back its trial error once (and the
    drift counts; a re-capture costs another read); the tests and
    ``chip_smoke.py`` hold the device form against that loop.

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
the JAX package: each stage is one table of cache items (:class:`LMItem`
with its window cache) run by :func:`lm_run`, whose phases read the
windows in place of the volume, and one read of the state after it.

The empty-window guard (a repair of the JAX package's ``_lm_fixed_cache``
and capture loop, ``tracking.py:452-459`` and ``:230`` there): ψ is 0
outside a point's captured window, so a trial step that carries every
weighted point out of its window scores the error 0 and ``rho > 0``
would accept it, moving a slot by more than a window. A cache item's
trial therefore also counts its points with ``w > 0`` whose ψ is valid
at the trial pose (state word ``SI_NIN``), and a count of 0 rejects the
step as ``rho <= 0`` does; the capture sampler's host loop does the same
with the count read beside the trial error. A gather item's trial is not
guarded.

Re-capturing cache items (the capture sampler's LM): the JAX package
runs its capture loop's re-capture as a ``lax.cond`` inside its
``while_loop``, at the trial pose (``tracking.py:224-240, 277-282``
there). :func:`track_volumes_capture` captures every item's windows at
its start (one K3 launch) and runs the table in :func:`lm_run` with a
re-capture budget of ``max_recaptures`` (:class:`LMRun`'s ``recaps``):
while a cache item has re-captures left, its trial also counts its
relevant points and those outside their windows at the trial pose
(:func:`~emfusion_tpu_torch.geometry.capture.drift_counts`, words
``SI_NREL`` and ``SI_NBAD``); if more than ``DRIFT_TOL`` of them left,
decide flags it (``SI_PEND``), counts the re-capture (``SI_RECAP``) and
leaves its iteration undecided, and that LM leaves the launch after
that iteration (the others run on to their stop or their own flag). The
host reads the state once the launch has ended, captures the flagged
items' windows at their trial poses (one K3 launch, into the items' own
cache tensors) and launches again; a flagged item then skips to its trial on the new
windows, with no second drift test, and decides. So a call reads the
device at most 1 + its table's re-captures times. With a budget of 0 (the
batched object LM's stages) an item is the fixed-cache item above.

The device-resident LM (the gather sampler, and the cache items):
:func:`run_lm_items` runs a
table of independent LMs (the camera's, or every serial object LM of a
frame: :func:`track_volumes_gather`, the counterpart of the JAX
pipeline's ``lax.scan`` over the slots) on a state record per LM
(:class:`LMRun`) that only the device reads and writes. An iteration is
:func:`lm_system` (per point ψ, its gradient, the weights and the 28
terms of the system, summed in float64), :func:`lm_step` phase 0 (the
gradient test, the 6x6 solve, the step test and the trial pose),
:func:`lm_trial` (the trial error) and :func:`lm_step` phase 1 (accept
or reject, the damping, ``it += 1``); an LM that has stopped ignores
them. :func:`lm_run` runs up to ``max_iter`` iterations of the table
and stops early once every LM has stopped: on a CUDA tensor one launch
of ``csrc/lm.cu``, which runs the four steps as phases with barriers
between them (the cooperative ``emf_lm_run``, grid-wide barriers; or,
for a table of cache items of at most 16 spans of points each,
``emf_lm_cluster``, one thread-block cluster an LM, the cluster's
barriers); on the CPU
:func:`lm_iteration` over the plain versions (:func:`lm_system_plain`,
:func:`lm_trial_plain`, :func:`lm_step_plain`), which compute every
per-point value and every scalar step with the kernel's float32
operations, so the two agree bit for bit except where a float64 sum,
rounded to float32, lands on a tie. A table takes one call of
:func:`lm_run`, after which the host reads the state once (a
non-blocking copy into pinned memory and one event): ``host_reads`` is
1 a call. With a ``group`` (the pixel-sharded LM) the weight maximum and
the float64 sums are all-reduced between the steps, so the iteration
runs as the split launches of :func:`lm_system`, :func:`lm_step` and
:func:`lm_trial` (:func:`_run_lm_split`), and the state is read after
every iteration, so that no collective is started for an iteration no
rank runs.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Sequence

import torch

from emfusion_tpu_torch import kernels
from emfusion_tpu_torch.distributed import comm
from emfusion_tpu_torch.geometry.capture import (
    WIN, capture_buffers, capture_into, capture_neighborhoods,
    capture_neighborhoods_batched, drift_counts, drift_within,
    out_of_window_count, sample_system_from_cache, sample_value_from_cache,
    valid_in_cache,
)
from emfusion_tpu_torch.geometry.sampling import (
    sample_system_at_points, sample_volume_at_points_plain, scalar,
    transform_to_grid,
)
from emfusion_tpu_torch.geometry.se3 import se3_exp, se3_log

@dataclasses.dataclass(frozen=True)
class TrackConfig:
    """Static LM parameters (reference ``TSDFParams``, ``data.h:32-71``).

    ``sampler``: ``gather`` or ``capture``, see the module's docstring;
    :func:`track_volumes_batched` ignores it. The JAX package's
    banded-capture options are not ported (the port's K3 gathers each
    window exactly)."""
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
        self.reads = 0    # device -> host reads

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
        self.reads += 1
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
        """The error ``sum(w psi^2)`` at a trial pose and the count of the
        points with ``w > 0`` whose ψ is valid there (inside the volume
        and the window; the empty-window guard of
        :func:`_track_volume_host` rejects a step that leaves none), after
        re-centring the windows there if relevant points drifted out and
        the re-capture budget allows it (the JAX loop's
        ``maybe_recapture`` before ``psi_new``). The drift counts, the
        error and the count on the current windows come back in one read
        (one reduction over a group); a re-capture costs a second."""
        Rd, td = self.dev_pose(R, t)
        err = self.error(w, Rd, td)
        self.reads += 1
        if self.recaps >= self.cfg.max_recaptures:
            host = self.reduce(torch.stack(err)).cpu()
            return host[0], host[1]
        nbad, nrel = drift_counts(self.anchor, self.points, Rd, td, self.vs,
                                  self.shape)
        host = self.reduce(torch.stack([*err, nbad, nrel])).cpu()
        if bool(drift_within(host[2], host[3])):
            return host[0], host[1]
        self.capture(Rd, td)
        self.recaps += 1
        self.reads += 1
        host = self.reduce(torch.stack(self.error(w, Rd, td))).cpu()
        return host[0], host[1]

    def error(self, w, Rd, td):
        """(``sum(w psi^2)``, the points with ``w > 0`` and a valid ψ as a
        float32 count) on the current windows."""
        psi = sample_value_from_cache(self.cache[0:1], self.anchor,
                                      self.points, Rd, td, self.vs,
                                      self.shape, margin=1)[0]
        valid = valid_in_cache(self.anchor, self.points, Rd, td, self.vs,
                               self.shape)
        return (torch.sum(w * psi * psi),
                torch.sum((valid & (w > 0)).to(torch.float32)))

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
    of the module's docstring). The gather sampler runs on the device
    (:func:`track_volumes_gather`), and so does the capture sampler
    (:func:`track_volumes_capture`); with a ``group`` the capture sampler
    runs in :func:`_track_volume_host`.

    Args:
      tsdf/weights: (Z, Y, X) float32 on the compute device.
      points: component-first (3, N) camera-space points on that device
        (invalid ones have z <= 0).
      assoc: (N,) association weights.
      rel_pose_co: (4, 4) initial camera-to-volume transform (host
        float32; the caller re-orthonormalises it).

    Returns (rel_pose_co_final (4, 4) host float32, stats dict with
    ``iterations``, ``converged``, ``grad_norm``, ``recaptures``,
    ``dropped_points`` (0 under ``gather``; the capture sampler's
    dropped points a 0-d device tensor, unread, but in the host loop),
    ``host_reads`` (the call's reads of the device) and the
    per-point ``track_weights`` / ``huber_weights`` of the last gradient
    evaluation (device tensors)).
    """
    item = LMItem(tsdf, weights, voxel_size, points, assoc, rel_pose_co)
    if cfg.sampler == "gather":
        (pose, stats), = track_volumes_gather([item], cfg, group)
        return pose, stats
    if group is None:
        (pose, stats), = track_volumes_capture([item], cfg)
        return pose, stats
    return _track_volume_host(tsdf, weights, voxel_size, points, assoc,
                              rel_pose_co, cfg, group)


def _track_volume_host(tsdf, weights, voxel_size, points, assoc,
                       rel_pose_co, cfg: TrackConfig, group=None):
    """:func:`track_volume` with the LM state machine on the host: the
    pixel-sharded capture sampler's loop, and for both samplers the
    reference that the device-resident LM is held against (the tests and
    ``chip_smoke.py``'s comparisons call it directly). An iteration that
    evaluates the system reads (A, b, err)
    back once and every step reads back its trial error once (the
    capture sampler's drift check may add a read); ``host_reads`` counts
    them, not the final reads of the stats."""
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
        win.reads += 1
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
                # the capture sampler's trial also counts the weighted
                # points whose ψ is valid there: a step that leaves none
                # (error 0, an empty sum) is rejected
                got = win.trial(w, R_new, t_new)
                err_new, nin = got if cfg.sampler == "capture" else (got, 1)
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

    Rd, td = win.dev_pose(R, t)
    stats = {"iterations": it, "converged": converged,
             "grad_norm": float(torch.max(torch.abs(b))),
             "track_weights": w, "huber_weights": hub,
             "recaptures": win.recaps,
             "dropped_points": win.dropped(Rd, td),
             "host_reads": win.reads}
    return _pose_mat(R, t), stats


def stage_items(tsdfs, weights, voxel_sizes, points: torch.Tensor,
                assoc: torch.Tensor, R: torch.Tensor, t: torch.Tensor,
                slots: Sequence[int]) -> List["LMItem"]:
    """The cache items of a fixed-cache stage of the batched object LM:
    one capture of the windows of every slot of ``slots`` at its pose
    ``(R[k], t[k])`` (host float32; on the card one K3 launch), and per
    slot an :class:`LMItem` over its volumes, voxel size, ``points[k]``
    (3, M) and ``assoc[k]`` (M,), starting from that pose, with its
    (2, 6, 6, 6, M) cache and (3, M) anchors."""
    sel = list(slots)
    idx = torch.tensor(sel, dtype=torch.long)
    pts = points[idx.to(points.device)].contiguous()
    asc = assoc[idx.to(assoc.device)].contiguous()
    cache, anchor = capture_neighborhoods_batched(
        [tsdfs[k] for k in sel], [weights[k] for k in sel], pts, R[idx],
        t[idx], voxel_sizes[idx])
    return [LMItem(tsdfs[k], weights[k], float(voxel_sizes[k]), pts[j],
                   asc[j], _pose_mat(R[k], t[k]), cache=cache[j],
                   anchor=anchor[j])
            for j, k in enumerate(sel)]


def track_volumes_batched(tsdfs, weights, voxel_sizes, points: torch.Tensor,
                          assoc: torch.Tensor, rel_poses, cfg: TrackConfig,
                          active):
    """The batched object LM (``tracking.py:501-571`` of the JAX package):
    S slots tracked together in two fixed-cache stages,

      1. one capture of the active slots' windows at their initial poses
         (one K3 launch), then the LM of those slots (one table of cache
         items, :func:`stage_items`) for ``max(max_iter // 2, 1)``
         iterations (one :func:`lm_run`), and one read of the state;
      2. for the slots that are active and not converged, a capture at
         their stage-1 poses (one K3 launch) and a fresh LM of them for
         the rest of ``max_iter`` (one :func:`lm_run`), and one read.

    No re-capture runs inside a stage (the JAX package's
    ``_lm_fixed_cache``, ``tracking.py:394-498``): points that drift out
    of their windows drop out through the window test. On a CUDA device
    each stage is one launch over cache items (:func:`lm_run`: at
    ``obj_track_points`` 4096, ``lm.cu``'s ``emf_lm_cluster``, a cluster a
    slot); on the CPU the plain iteration. Each LM starts
    afresh at a stage (``mu`` 0, ``nu`` ``nu_init``, a first iteration).

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
    gradient evaluation on the device; ``host_reads``, the reads of the
    device (one a stage's table: at most 2 while the slots fit one table,
    ``lm.cu``'s ``emf_max_items()``; 0 without an active slot), and
    ``loop_iterations``, the iterations the stages' tables ran (each its
    longest LM's), summed.
    An inactive slot stays out of the tables: it keeps its pose, with 0
    iterations and zero weights, and counts as converged (as the JAX
    package's ``converged = ~active`` start gives)."""
    f32 = torch.float32
    dev = points.device
    shape = tuple(tsdfs[0].shape)
    vs = torch.as_tensor(voxel_sizes, dtype=f32).cpu()
    rel = torch.as_tensor(rel_poses, dtype=f32).cpu()
    active = torch.as_tensor(active, dtype=torch.bool).cpu()
    S, M = points.shape[0], points.shape[2]
    R, t = rel[:, :3, :3].clone(), rel[:, :3, 3].clone()
    it = torch.zeros(S, dtype=torch.int64)
    converged = ~active
    recaps = torch.zeros(S, dtype=torch.int64)
    w = torch.zeros((S, M), dtype=f32, device=dev)
    hub = torch.zeros_like(w)
    dropped = torch.zeros(S, dtype=torch.int64, device=dev)
    reads = loops = 0
    half = max(cfg.max_iter // 2, 1)
    cap = (kernels.library("lm_run").emf_max_items() if dev.type == "cuda"
           else LM_MAX_ITEMS)
    todo = torch.nonzero(active).flatten()
    for stage, budget in enumerate((half, cfg.max_iter - half)):
        if not len(todo):
            break
        stage_cfg = dataclasses.replace(cfg, max_iter=budget)
        tables = []      # as many slots a table as a launch takes
        for part in torch.split(todo, cap):
            items = stage_items(tsdfs, weights, vs, points, assoc, R, t,
                                part.tolist())
            tables.append((part, items, LMRun(items, stage_cfg)))
            lm_run(tables[-1][2], stage_cfg, budget)
        for part, items, run in tables:
            si, sf = run.read()
            reads += run.reads
            loops += int(si[:, SI_IT].max())
            R[part] = sf[:, SF_R:SF_R + 9].reshape(-1, 3, 3)
            t[part] = sf[:, SF_T:SF_T + 3]
            it[part] += si[:, SI_IT].to(torch.int64)
            converged[part] = si[:, SI_CONV] != 0
            recaps[part] = stage
            idx = part.to(dev)
            w[idx] = run.w.view(len(items), M)
            hub[idx] = run.hub.view(len(items), M)
            # a slot's last stage: its points outside the windows at its
            # final pose
            out = out_of_window_count(
                torch.stack([x.anchor for x in items]),
                torch.stack([x.points for x in items]), R[part].to(dev),
                t[part].to(dev), vs[part].to(dev), shape)
            last = converged[part] | (stage == 1)
            dropped[part[last].to(dev)] = out[last.to(dev)]
        todo = todo[~converged[todo]]
    stats = {"iterations": it, "converged": converged, "recaptures": recaps,
             "dropped_points": dropped,
             "track_weights": w, "huber_weights": hub,
             "host_reads": reads, "loop_iterations": loops}
    return _pose_mat(R, t), stats


# ---------------------------------------------------------------------
# The device-resident LM of the gather sampler (csrc/lm.cu)

LM_NSUM = 28      # the system's float64 sums: A's 21 unique terms, b, err
LM_PART = 31      # a span's partials (lm.cu's EMF_LM_PART): sums, trial,
#                   max, the trial's weighted points with a valid ψ
LM_MAX_ITEMS = 17  # LMs a plain table takes (lm.cu's EMF_MAX_ITEMS)
# the words of an LM's state record (lm.cu's SI_* and SF_*); a cache
# item's: SI_NIN, its last trial's weighted points with a valid ψ;
# SI_PEND, a trial that waits for a re-capture at its trial pose;
# SI_RECAP, its re-captures; SI_NBAD and SI_NREL, its last drift test's
# points outside their windows and relevant points
(SI_IT, SI_CONV, SI_EVAL, SI_FIRST, SI_TRIAL, SI_RAN, SI_NIN, SI_PEND,
 SI_RECAP, SI_NBAD, SI_NREL, SI_N) = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 12)
SF_R, SF_T, SF_RN, SF_TN, SF_X = 0, 9, 12, 21, 24
SF_MU, SF_NU, SF_MU0, SF_ERR, SF_ERRN = 30, 31, 32, 33, 34
SF_A, SF_B, SF_N = 35, 71, 80
_UPPER = [(a, c) for a in range(6) for c in range(a, 6)]   # A's sums


@dataclasses.dataclass
class LMItem:
    """One LM of a table: its (Z, Y, X) volumes (float32, or a bf16 pair),
    voxel size, (3, N) camera points and (N,) association weights on the
    compute device, and its (4, 4) initial camera-to-volume transform
    (host float32; the caller re-orthonormalises it).

    A cache item also has its points' windows, captured by K3 at the
    start pose (``geometry.capture``): ``cache`` (2, 6, 6, 6, N), float32
    or bf16, and ``anchor`` (3, N) int32. Its LM reads them, not the
    volumes (which give the shape), as the batched object LM's fixed-
    cache stages do; a gather item has neither. A table holds one kind."""
    tsdf: torch.Tensor
    weights: torch.Tensor
    voxel_size: float
    points: torch.Tensor
    assoc: torch.Tensor
    rel_pose: torch.Tensor
    cache: Optional[torch.Tensor] = None
    anchor: Optional[torch.Tensor] = None


def _upload(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """A host tensor on ``dev``, without a wait on a CUDA device (a non-
    blocking copy from pinned memory)."""
    if dev.type != "cuda":
        return t.to(dev)
    return t.pin_memory().to(dev, non_blocking=True)


class LMRun:
    """The state of a table of LMs on their device: per LM an int32
    record ``si`` (S, SI_N) and a float32 record ``sf`` (S, SF_N), the
    last evaluation's float64 sums ``sys`` (S, 28), the trial errors
    ``trial`` (S,) and the weight maxima ``wmax`` (S,); the packed per-
    point buffers ``w``, ``hub`` and ``scratch`` (5, total), LM ``k``'s
    points at ``p0[k]``; on a CUDA device also the kernels' span
    partials, the split kernels' tickets, the ctypes arguments and
    ``kernel``, the entry point that runs the table (``lm_cluster`` for
    cache items whose largest has at most 16 spans, else ``lm_run``), and
    ``grid``, the blocks of its launch: ``lm_run``'s min(spans, the
    blocks the card holds at once), ``lm_cluster``'s S clusters of
    ``cluster`` blocks (the most spans of an item). ``held`` (S,) host
    bool: the LMs that have left
    the launch :func:`lm_run` is running (the plain loop's mark). Every
    LM starts afresh (``mu`` 0, ``nu`` ``nu_init``, a first iteration, a gradient
    to evaluate), as the JAX loop's ``init`` (``tracking.py:392-401``).
    ``recaps``: a table of cache items' re-capture budget (each item's;
    see "Re-capturing cache items" in the module's docstring), 0 for
    windows that stay fixed."""

    def __init__(self, items: Sequence[LMItem], cfg: TrackConfig,
                 recaps: int = 0):
        f32 = torch.float32
        self.items = list(items)
        self.recaps = int(recaps)
        S = len(self.items)
        kinds = {it.cache is not None for it in self.items}
        if len(kinds) != 1:
            raise ValueError("an LM table holds cache items only or gather "
                             "items only")
        self.cached = kinds.pop()
        self.dev = self.items[0].points.device
        self.n = [int(it.points.shape[1]) for it in self.items]
        self.p0 = [sum(self.n[:k]) for k in range(S)]
        total = sum(self.n)
        si = torch.zeros((S, SI_N), dtype=torch.int32)
        si[:, SI_EVAL] = 1
        si[:, SI_FIRST] = 1
        sf = torch.zeros((S, SF_N), dtype=f32)
        for k, it in enumerate(self.items):
            pose = torch.as_tensor(it.rel_pose, dtype=f32).cpu()
            sf[k, SF_R:SF_R + 9] = pose[:3, :3].reshape(9)
            sf[k, SF_T:SF_T + 3] = pose[:3, 3]
        sf[:, SF_NU] = cfg.nu_init
        sf[:, SF_A:SF_A + 36] = torch.eye(6, dtype=f32).reshape(36)
        self.si, self.sf = _upload(si, self.dev), _upload(sf, self.dev)
        z = dict(device=self.dev)
        self.sys = torch.zeros((S, LM_NSUM), dtype=torch.float64, **z)
        self.trial = torch.zeros(S, dtype=torch.float64, **z)
        self.wmax = torch.zeros(S, dtype=f32, **z)
        self.w = torch.zeros(total, dtype=f32, **z)
        self.hub = torch.zeros(total, dtype=f32, **z)
        self.scratch = torch.zeros((5, total), dtype=f32, **z)
        self.reads = 0
        self.held = torch.zeros(S, dtype=torch.bool)
        self.cuda = self.dev.type == "cuda"
        if self.cuda:
            self._bind(cfg)

    def point_slice(self, k: int) -> slice:
        return slice(self.p0[k], self.p0[k] + self.n[k])

    def _bind(self, cfg: TrackConfig) -> None:
        """The kernels' buffers and ctypes arguments; raises on what they
        do not take."""
        S = len(self.items)
        lib = kernels.library("lm_run")
        spans = sum(lib.emf_lm_spans(n) for n in self.n)
        self.cluster = lib.emf_lm_cluster_size(
            max(lib.emf_lm_spans(n) for n in self.n)) if self.cached else 0
        if self.cluster:
            self.kernel = "lm_cluster"
            self.grid = S * self.cluster
        else:
            self.kernel = "lm_run"
            resident = kernels.lm_run_blocks(self.dev, self.cached)
            if resident < 1:
                raise RuntimeError("lm_run: the device's occupancy query "
                                   "failed")
            self.grid = min(spans, resident)
        self.part = torch.empty((spans, LM_PART), dtype=torch.float64,
                                device=self.dev)
        self.count = torch.zeros(S, dtype=torch.int32, device=self.dev)
        args = []
        for it, n, p0 in zip(self.items, self.n, self.p0):
            code = kernels.volume_dtype_code("lm_run", it.tsdf, it.weights)
            kernels.check_cuda("lm_run", it.tsdf, it.weights, it.assoc,
                               allow_bf16=True, device=self.dev)
            cache = anchor = None
            if self.cached:
                code = kernels.volume_dtype_code("lm_run", it.cache)
                kernels.check_cuda("lm_run", it.cache, it.anchor,
                                   allow_bf16=True, device=self.dev)
                if (it.cache.shape != (2, WIN, WIN, WIN, n)
                        or it.anchor.shape != (3, n)
                        or it.anchor.dtype != torch.int32):
                    raise ValueError("lm_run: a cache item takes a (2, 6, 6, "
                                     "6, N) cache and (3, N) int32 anchors")
                cache, anchor = it.cache.data_ptr(), it.anchor.data_ptr()
            pts = it.points
            if (it.tsdf.dim() != 3 or it.weights.shape != it.tsdf.shape
                    or pts.dtype != torch.float32 or pts.shape[0] != 3
                    or (n > 1 and pts.stride(1) != 1)
                    or it.assoc.dtype != torch.float32
                    or it.assoc.shape != (n,)):
                raise ValueError("lm_run: (Z, Y, X) volumes, float32 "
                                 "(3, N) points with contiguous rows and "
                                 "float32 (N,) weights")
            if pts.device != self.dev or it.tsdf.device != self.dev:
                raise ValueError("lm_run: all tensors must be on one "
                                 "CUDA device")
            Z, Y, X = it.tsdf.shape
            args.append(kernels.LmItemArgs(
                it.tsdf.data_ptr(), it.weights.data_ptr(), pts.data_ptr(),
                it.assoc.data_ptr(), cache, anchor, pts.stride(0), n, Z, Y,
                X, code, float(it.voxel_size), p0, n, int(self.cached)))
        self.table = (kernels.LmItemArgs * S)(*args)
        self.bufs = kernels.LmBufsArgs(
            self.si.data_ptr(), self.sf.data_ptr(), self.sys.data_ptr(),
            self.trial.data_ptr(), self.wmax.data_ptr(), self.w.data_ptr(),
            self.hub.data_ptr(), self.scratch.data_ptr(),
            self.part.data_ptr(), self.count.data_ptr(), sum(self.n))
        self.cfg_args = kernels.LmCfgArgs(
            cfg.tau, cfg.eps1, cfg.eps2, cfg.nu_init, cfg.huber_thresh,
            cfg.max_tsdf_weight, cfg.max_iter, self.recaps)
        self.shapes = [tuple(it.tsdf.shape) for it in self.items]
        self.host_si = torch.empty((S, SI_N), dtype=torch.int32,
                                   pin_memory=True)
        self.host_sf = torch.empty((S, SF_N), dtype=torch.float32,
                                   pin_memory=True)
        self.event = torch.cuda.Event()

    def read(self):
        """The state records on the host, (si, sf): on a CUDA device one
        non-blocking copy of each into pinned memory and a wait on one
        event, counted in ``reads``."""
        self.reads += 1
        if not self.cuda:
            return self.si.clone(), self.sf.clone()
        self.host_si.copy_(self.si, non_blocking=True)
        self.host_sf.copy_(self.sf, non_blocking=True)
        self.event.record(torch.cuda.current_stream(self.dev))
        self.event.synchronize()
        return self.host_si.clone(), self.host_sf.clone()

    def running(self, si: torch.Tensor, cfg: TrackConfig) -> torch.Tensor:
        """(S,) bool: the LMs that have not stopped, from a read ``si``."""
        return (si[:, SI_IT] < cfg.max_iter) & (si[:, SI_CONV] == 0)


def _items_with(run: LMRun, cfg: TrackConfig, word: int) -> List[int]:
    """The LMs whose state word ``word`` is set (with SI_EVAL: those that
    also run), read from the state (a plain version's host read), but
    those that have left the launch (``run.held``)."""
    si = run.si.cpu()
    on = (si[:, word] != 0) & ~run.held
    if word == SI_EVAL:
        on &= run.running(si, cfg)
    return [int(k) for k in torch.nonzero(on).flatten()]


def _pose_of(run: LMRun, k: int, at: int):
    """LM ``k``'s rotation (3, 3) and translation (3,) at state word
    ``at`` (SF_R, or SF_RN for the trial pose)."""
    f = run.sf[k]
    return f[at:at + 9].reshape(3, 3), f[at + 9:at + 12]


def _rigid(R, t, pts):
    """``R p + t`` per point, each row summed left to right (as
    ``sampling.transform_to_grid`` and the kernels' ``emf_apply``)."""
    px, py, pz = pts[0], pts[1], pts[2]
    return [R[i, 0] * px + R[i, 1] * py + R[i, 2] * pz + t[i]
            for i in range(3)]


def _lsum(terms):
    """The terms summed left to right."""
    s = terms[0]
    for x in terms[1:]:
        s = s + x
    return s


def _tents(v: torch.Tensor) -> List[torch.Tensor]:
    """``tent(v - d) = max(0, 1 - |v - d|)``, the weight of window tap
    ``d``, for d = 0 .. WIN - 1."""
    return [torch.clamp(1.0 - torch.abs(v - float(d)), min=0.0)
            for d in range(WIN)]


def _cache_grid(it: LMItem, R, t):
    """A cache item's points at the pose: their grid coordinates (vx, vy,
    vz), camera z, local window coordinates (lx, ly, lz) and the window
    test (``geometry.capture._window_ok``)."""
    vx, vy, vz, pz = transform_to_grid(it.points, R, t, it.voxel_size,
                                       tuple(it.tsdf.shape))
    a = it.anchor.to(torch.float32)
    lx, ly, lz = vx - a[0], vy - a[1], vz - a[2]
    hi = WIN - 2.0
    win = ((lx >= 0) & (lx <= hi) & (ly >= 0) & (ly <= hi) & (lz >= 0)
           & (lz <= hi))
    return (vx, vy, vz), pz, (lx, ly, lz), win


def _cache_system(it: LMItem, R, t, cfg: TrackConfig):
    """Per point of a cache item at the pose: ψ and its gradient
    (``geometry.capture.sample_system_from_cache``) and the clamped
    margin-1 weight (``sample_value_from_cache`` of channel 1), each tent
    sum over the window spelled out left to right, x, then y, then z (the
    kernel's order; ``torch.sum``'s order on the CPU is not fixed)."""
    Z, Y, X = it.tsdf.shape
    (vx, vy, vz), pz, (lx, ly, lz), win = _cache_grid(it, R, t)
    c = it.cache.to(torch.float32)
    tx, ty, tz = _tents(lx), _tents(ly), _tents(lz)
    tx1, ty1, tz1 = _tents(lx + 1.0), _tents(ly + 1.0), _tents(lz + 1.0)
    cx = _lsum([c[0, :, :, d] * tx[d] for d in range(WIN)])    # (z, y, N)
    cx1 = _lsum([c[0, :, :, d] * tx1[d] for d in range(WIN)])
    cy = _lsum([cx[:, d] * ty[d] for d in range(WIN)])         # (z, N)
    cy1 = _lsum([cx[:, d] * ty1[d] for d in range(WIN)])
    cyx1 = _lsum([cx1[:, d] * ty[d] for d in range(WIN)])
    base_val = _lsum([cy[d] * tz[d] for d in range(WIN)])
    sx = _lsum([cyx1[d] * tz[d] for d in range(WIN)])
    sy = _lsum([cy1[d] * tz[d] for d in range(WIN)])
    sz = _lsum([cy[d] * tz1[d] for d in range(WIN)])
    front = pz > 0
    ahead = front & (vx >= 0.0) & (vy >= 0.0) & (vz >= 0.0) & win
    valid1 = ahead & (vx + 1.0 < X) & (vy + 1.0 < Y) & (vz + 1.0 < Z)
    valid2 = ahead & (vx + 2.0 < X) & (vy + 2.0 < Y) & (vz + 2.0 < Z)

    def shifted(ex, ey, ez):
        return (front & (vx + ex >= 0.0) & (vy + ey >= 0.0)
                & (vz + ez >= 0.0) & (vx + ex + 2.0 < X)
                & (vy + ey + 2.0 < Y) & (vz + ez + 2.0 < Z))

    psi = torch.where(valid1, base_val, 0.0)
    base = torch.where(valid2, base_val, 0.0)
    vs = scalar(it.voxel_size, psi)
    g3 = [(torch.where(shifted(*e), s_, 0.0) - base) / vs
          for s_, e in ((sx, (1.0, 0.0, 0.0)), (sy, (0.0, 1.0, 0.0)),
                        (sz, (0.0, 0.0, 1.0)))]
    intw = torch.where(valid1, _window_value(c[1], tx, ty, tz), 0.0)
    return psi, g3, torch.clamp(intw, max=cfg.max_tsdf_weight)


def _window_value(ch, tx, ty, tz):
    """The tent sum of a (6, 6, 6, N) window channel: x, then y, then z,
    each left to right."""
    cx = _lsum([ch[:, :, d] * tx[d] for d in range(WIN)])
    cy = _lsum([cx[:, d] * ty[d] for d in range(WIN)])
    return _lsum([cy[d] * tz[d] for d in range(WIN)])


def _cache_psi(it: LMItem, R, t):
    """ψ at margin 1 of a cache item's points at the pose
    (``sample_value_from_cache`` of channel 0, the tent sums left to
    right), and where it is valid (inside the volume and the window)."""
    Z, Y, X = it.tsdf.shape
    (vx, vy, vz), pz, (lx, ly, lz), win = _cache_grid(it, R, t)
    valid = ((pz > 0) & (vx >= 0.0) & (vy >= 0.0) & (vz >= 0.0)
             & (vx + 1.0 < X) & (vy + 1.0 < Y) & (vz + 1.0 < Z) & win)
    psi = _window_value(it.cache[0].to(torch.float32), _tents(lx),
                        _tents(ly), _tents(lz))
    return torch.where(valid, psi, 0.0), valid


def lm_system_plain(run: LMRun, cfg: TrackConfig, group=None) -> None:
    """Plain version of ``lm_system`` (``eval_system`` and
    ``build_normal_eqs``, ``tracking.py:183-240`` of the JAX package) for
    the LMs that run and evaluate a gradient. First per point ψ and its
    gradient (:func:`sample_system_at_points`), the margin-1 integration
    weight clamped to ``max_tsdf_weight`` and the Huber weight (``x/0 =
    0``), stored in ``scratch`` and ``hub``, and ``wmax`` =
    ``max(0, max intw)`` (all-reduced with MAX over a ``group``), from
    the item's window cache for a cache item (:func:`_cache_system`); then
    ``w = huber * (intw / wmax) * assoc`` (0 where ``wmax`` is 0) into
    ``w``, ``J = [g3, p x g3]``, and the float32 terms ``J_a w J_c`` (a <=
    c), ``J_a w psi`` and ``w psi^2`` summed in float64 into ``sys``
    (all-reduced with SUM over a ``group``)."""
    ev = _items_with(run, cfg, SI_EVAL)
    for k in ev:
        it, sl = run.items[k], run.point_slice(k)
        if run.n[k] == 0:
            run.wmax[k] = 0.0
            continue
        R, t = _pose_of(run, k, SF_R)
        if it.cache is not None:
            psi, g3, intw = _cache_system(it, R, t, cfg)
        else:
            psi, g3 = sample_system_at_points(it.tsdf, it.points, R, t,
                                              it.voxel_size)
            intw = torch.clamp(sample_volume_at_points_plain(
                it.weights, it.points, R, t, it.voxel_size, margin=1),
                max=cfg.max_tsdf_weight)
        a = torch.abs(psi)
        hub = torch.where(a > 0, torch.clamp(
            scalar(cfg.huber_thresh, a) / torch.clamp(a, min=1e-30),
            max=1.0), 0.0)
        run.scratch[:, sl] = torch.stack([psi, g3[0], g3[1], g3[2], intw])
        run.hub[sl] = hub
        run.wmax[k] = torch.clamp(torch.max(intw), min=0.0)
    if group is not None:
        comm.all_reduce(group, run.wmax, "max")
    for k in ev:
        it, sl = run.items[k], run.point_slice(k)
        if run.n[k] == 0:
            run.sys[k] = 0.0
            continue
        psi, gx, gy, gz, intw = run.scratch[:, sl]
        wm = run.wmax[k]
        w = run.hub[sl] * torch.where(wm > 0, intw / wm, 0.0) * it.assoc
        run.w[sl] = w
        px, py, pz = _rigid(*_pose_of(run, k, SF_R), it.points)
        J = [gx, gy, gz, py * gz - pz * gy, pz * gx - px * gz,
             px * gy - py * gx]
        Jw = [j * w for j in J]
        terms = ([Jw[a] * J[c] for a, c in _UPPER]
                 + [Jw[a] * psi for a in range(6)] + [w * psi * psi])
        run.sys[k] = torch.stack(terms).double().sum(dim=1)
    if group is not None:
        comm.all_reduce(group, run.sys)


def _drifts(run: LMRun, k: int) -> bool:
    """Whether cache item ``k``'s trial tests its drift: it has re-captures
    left and is not a trial on windows just re-captured (lm.cu's
    ``emf_lm_drifts``)."""
    si = run.si[k].tolist()
    return not si[SI_PEND] and si[SI_RECAP] < run.recaps


def lm_trial_plain(run: LMRun, cfg: TrackConfig, group=None) -> None:
    """Plain version of ``lm_trial`` (the trial error, ``tracking.py:
    272-287`` of the JAX package): for the LMs with a trial step, ``sum(w
    psi^2)`` in float64 into ``trial``, ψ sampled at margin 1 at the trial
    pose (from the window cache for a cache item, :func:`_cache_psi`),
    ``w`` of the last evaluation (all-reduced with SUM over a
    ``group``). A cache item's state word ``SI_NIN`` gets the count of its
    points with ``w > 0`` whose ψ is valid there (the empty-window guard of
    :func:`lm_step_plain`); while it tests its drift (:func:`_drifts`),
    ``SI_NBAD`` and ``SI_NREL`` get :func:`~emfusion_tpu_torch.geometry.
    capture.drift_counts` at the trial pose."""
    for k in _items_with(run, cfg, SI_TRIAL):
        it, sl = run.items[k], run.point_slice(k)
        Rn, tn = _pose_of(run, k, SF_RN)
        if it.cache is not None:
            psi, valid = _cache_psi(it, Rn, tn)
            run.si[k, SI_NIN] = int(torch.sum(valid & (run.w[sl] > 0)))
            if _drifts(run, k):
                nbad, nrel = drift_counts(it.anchor, it.points, Rn, tn,
                                          it.voxel_size, tuple(it.tsdf.shape))
                run.si[k, SI_NBAD] = int(nbad)
                run.si[k, SI_NREL] = int(nrel)
        else:
            psi = sample_volume_at_points_plain(it.tsdf, it.points, Rn, tn,
                                                it.voxel_size, margin=1)
        run.trial[k] = (run.w[sl] * psi * psi).double().sum()
    if group is not None:
        comm.all_reduce(group, run.trial)


# SE(3) and the 6x6 solve on per-LM components ((S,) tensors), spelled out
# as lm.cu computes them: the formulas of geometry/se3.py, a 3x3 product's
# entries summed left to right, every division by a tensor on the
# components' device (the card's division by a Python scalar is a
# product with its reciprocal).
def _mm3(a, b):
    return [a[3 * i] * b[j] + a[3 * i + 1] * b[3 + j]
            + a[3 * i + 2] * b[6 + j] for i in range(3) for j in range(3)]


def _skew(w):
    z = torch.zeros_like(w[0])
    K = [z, -w[2], w[1], w[2], z, -w[0], -w[1], w[0], z]
    return K, _mm3(K, K)


def _poly(a, K, b, K2):
    """``(I + a K) + b K2`` entry by entry."""
    return [((1.0 if q % 4 == 0 else 0.0) + a * K[q]) + b * K2[q]
            for q in range(9)]


def _div(x, c):
    return x / scalar(c, x)


def _each(fn, x):
    """``fn`` (sin, cos, arccos) of each component on its own on the CPU:
    PyTorch's CPU kernels evaluate them with a vectorised approximation
    over whole SIMD widths and the C library's on the rest, so a batch
    would round by its size; one at a time, an LM's bits in a table are
    those it has alone."""
    if x.device.type != "cpu" or x.numel() == 1:
        return fn(x)
    return torch.cat([fn(x[i:i + 1]) for i in range(x.numel())])


def _se3_exp_rows(xi):
    """``geometry.se3.se3_exp`` of the twists ``xi`` (6 components):
    (R as 9 components, t as 3)."""
    ups, om = xi[:3], xi[3:]
    th2 = om[0] * om[0] + om[1] * om[1] + om[2] * om[2]
    th = torch.sqrt(th2 + 1e-16)
    K, K2 = _skew(om)
    small = th2 > 1e-8
    sin, cos = _each(torch.sin, th), _each(torch.cos, th)
    a = torch.where(small, sin / th, 1.0 - _div(th2, 6.0))
    b = torch.where(small, (1.0 - cos) / th2,
                    0.5 - _div(th2, 24.0))
    c = torch.where(small, (th - sin) / (th2 * th),
                    1.0 / 6.0 - _div(th2, 120.0))
    R = _poly(a, K, b, K2)
    V = _poly(b, K, c, K2)
    t = [V[3 * i] * ups[0] + V[3 * i + 1] * ups[1] + V[3 * i + 2] * ups[2]
         for i in range(3)]
    return R, t


def _so3_log_rows(R):
    trace = R[0] + R[4] + R[8]
    th = _each(torch.arccos, torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0))
    v = [R[7] - R[5], R[2] - R[6], R[3] - R[1]]
    st = _each(torch.sin, th)
    small = torch.abs(st) < 1e-6
    scale = torch.where(small, 0.5 + _div(th * th, 12.0),
                        th / (2.0 * torch.where(small, 1.0, st)))
    near_pi = th > 3.0
    w = []
    for i, d in enumerate((R[0], R[4], R[8])):
        axis = torch.sqrt(torch.clamp((d + 1.0) * 0.5, 0.0, 1.0))
        u = torch.where(torch.abs(v[i]) > 1e-12, v[i], 1.0)
        w.append(torch.where(near_pi, axis * torch.sign(u) * th,
                             v[i] * scale))
    return w


def _se3_log_rows(R, t):
    """``geometry.se3.se3_log`` of the poses (R as 9 components, t as 3):
    the twist's 6 components."""
    om = _so3_log_rows(R)
    th2 = om[0] * om[0] + om[1] * om[1] + om[2] * om[2]
    th = torch.sqrt(th2 + 1e-16)
    K, K2 = _skew(om)
    ct, st = _each(torch.cos, th), _each(torch.sin, th)
    denom = 2.0 * (1.0 - ct)
    coef = torch.where(
        th2 > 1e-8,
        (1.0 - th * st / torch.where(torch.abs(denom) > 1e-12, denom, 1.0))
        / th2, 1.0 / 12.0 + _div(th2, 720.0))
    Vi = _poly(-0.5, K, coef, K2)
    ups = [Vi[3 * i] * t[0] + Vi[3 * i + 1] * t[1] + Vi[3 * i + 2] * t[2]
           for i in range(3)]
    return ups + om


def _norm6(x):
    s = x[0] * x[0]
    for i in range(1, 6):
        s = s + x[i] * x[i]
    return torch.sqrt(s)


def _solve6(A: torch.Tensor, mu0: torch.Tensor, b: torch.Tensor):
    """``(A + mu0 I) x = b`` for (S, 6, 6) ``A``: Gaussian elimination with
    partial pivoting (the first largest pivot), then back substitution,
    as lm.cu's ``emf_solve6``. Returns x as 6 components."""
    S = A.shape[0]
    d = torch.arange(6, device=A.device)
    M = torch.cat([A, b[:, :, None]], dim=2)
    M[:, d, d] = A[:, d, d] + mu0[:, None]
    rows = torch.arange(S, device=A.device)
    for c in range(6):
        p = c + torch.argmax(torch.abs(M[:, c:, c]), dim=1)
        rc, rp = M[rows, c].clone(), M[rows, p].clone()
        M[rows, c] = rp
        M[rows, p] = rc
        f = M[:, c + 1:, c] / M[:, c:c + 1, c]
        M[:, c + 1:, c + 1:] = M[:, c + 1:, c + 1:] \
            - f[:, :, None] * M[:, c:c + 1, c + 1:]
    x = [None] * 6
    for r in range(5, -1, -1):
        s = M[:, r, 6]
        for j in range(r + 1, 6):
            s = s - M[:, r, j] * x[j]
        x[r] = s / M[:, r, r]
    return x


def lm_step_plain(run: LMRun, cfg: TrackConfig, phase: int) -> None:
    """Plain version of ``lm_step`` (the rest of the JAX loop's ``body``,
    ``tracking.py:242-322``), for every LM at once on its state.

    Phase 0, for the LMs that run (``it < max_iter`` and not converged;
    their ``ran`` flag) but a trial that waits for a re-capture
    (``SI_PEND``: left as it is), after an evaluation, (A, b, err)
    rounded from the float64 sums and the gradient test ``max|b| <
    eps1``; then ``mu0`` (``tau max(diag A)`` on the first pass), ``x``
    solving ``(A + mu0 I) x = b`` (:func:`_solve6`), the step test ``|x|
    < eps2 (|se3_log(pose)| + eps2)`` (which converges with ``mu =
    mu0``), else ``x``, ``mu0`` and the trial pose ``se3_exp(-x) pose``
    with the trial flag.

    Phase 1: ``it += 1`` where the LM ran; for a trial, ``rho = (err -
    err_new) / (0.5 x.(mu0 x + b))``, and on ``rho > 0`` the trial pose,
    ``mu = mu0 max(1 - (2 rho - 1)^3, 1/3)`` and ``nu = nu_init``, else
    ``mu = mu0 nu`` and ``nu *= nu_init``; ``eval_grad`` = accepted.
    A cache item's trial with no weighted point whose ψ is valid at the
    trial pose (``SI_NIN`` 0) is rejected as ``rho <= 0`` is: its error is
    the 0 of an empty sum, which the JAX package's ``_lm_fixed_cache``
    accepts (``tracking.py:452-459`` there), so a slot could jump out of
    its windows. A cache item's trial that tested its drift and failed it
    (:func:`~emfusion_tpu_torch.geometry.capture.drift_within` on
    ``SI_NBAD`` and ``SI_NREL``) is not decided: it is flagged for a
    re-capture at its trial pose (``SI_PEND``, ``SI_RECAP`` += 1, no
    gradient to evaluate), its ``it`` and trial kept; a flagged trial's
    next decide clears the flag and decides. A cache item that stopped
    in this iteration has its ``ran`` flag cleared (``lm.cu``'s cluster
    leaves its loop before a later phase 0 would clear it). An LM that
    has left the launch (``run.held``) is left as it is in both phases."""
    si, sf = run.si, run.sf
    f32 = torch.float32
    if phase == 0:
        wait = si[:, SI_PEND] != 0
        runs = run.running(si, cfg) & ~wait
        si[:, SI_TRIAL] = torch.where(wait, si[:, SI_TRIAL], 0)
        si[:, SI_RAN] = torch.where(wait, si[:, SI_RAN],
                                    runs.to(torch.int32))
        ev = runs & (si[:, SI_EVAL] != 0)
        q = run.sys.to(f32)
        A_new = torch.zeros((len(run.items), 6, 6), dtype=f32,
                            device=sf.device)
        for m, (a, c) in enumerate(_UPPER):
            A_new[:, a, c] = q[:, m]
            A_new[:, c, a] = q[:, m]
        sf[:, SF_A:SF_A + 36] = torch.where(
            ev[:, None], A_new.reshape(-1, 36), sf[:, SF_A:SF_A + 36])
        sf[:, SF_B:SF_B + 6] = torch.where(ev[:, None], q[:, 21:27],
                                           sf[:, SF_B:SF_B + 6])
        sf[:, SF_ERR] = torch.where(ev, q[:, 27], sf[:, SF_ERR])
        gmax = torch.amax(torch.abs(sf[:, SF_B:SF_B + 6]), dim=1)
        conv = (si[:, SI_CONV] != 0) | (ev & (gmax < cfg.eps1))
        go = runs & ~conv
        A = sf[:, SF_A:SF_A + 36].reshape(-1, 6, 6)
        first = si[:, SI_FIRST] != 0
        mu0 = torch.where(first, torch.amax(torch.diagonal(
            A, dim1=1, dim2=2), dim=1) * cfg.tau, sf[:, SF_MU])
        x = _solve6(A, mu0, sf[:, SF_B:SF_B + 6])
        R = [sf[:, SF_R + q_] for q_ in range(9)]
        t = [sf[:, SF_T + i] for i in range(3)]
        step_conv = _norm6(x) < cfg.eps2 * (
            _norm6(_se3_log_rows(R, t)) + cfg.eps2)
        si[:, SI_FIRST] = torch.where(go, 0, si[:, SI_FIRST])
        stop = go & step_conv
        sf[:, SF_MU] = torch.where(stop, mu0, sf[:, SF_MU])
        si[:, SI_CONV] = (conv | stop).to(torch.int32)
        trial = go & ~step_conv
        dR, dt = _se3_exp_rows([-v for v in x])
        Rn = _mm3(dR, R)
        tn = [dR[3 * i] * t[0] + dR[3 * i + 1] * t[1] + dR[3 * i + 2] * t[2]
              + dt[i] for i in range(3)]
        new = torch.stack(x + Rn + tn, dim=1)     # SF_X, then SF_RN, SF_TN
        tr = trial[:, None]
        sf[:, SF_X:SF_X + 6] = torch.where(tr, new[:, :6],
                                           sf[:, SF_X:SF_X + 6])
        sf[:, SF_RN:SF_RN + 12] = torch.where(tr, new[:, 6:],
                                              sf[:, SF_RN:SF_RN + 12])
        sf[:, SF_MU0] = torch.where(trial, mu0, sf[:, SF_MU0])
        si[:, SI_TRIAL] = torch.where(wait, si[:, SI_TRIAL],
                                      trial.to(torch.int32))
        return
    held = run.held.to(si.device)
    ran = (si[:, SI_RAN] != 0) & ~held
    trial = (si[:, SI_TRIAL] != 0) & ~held
    flag = torch.zeros_like(ran)
    if run.cached:
        flag = (ran & trial & (si[:, SI_PEND] == 0)
                & (si[:, SI_RECAP] < run.recaps)
                & ~drift_within(si[:, SI_NBAD].to(f32),
                                si[:, SI_NREL].to(f32)))
        si[:, SI_PEND] = torch.where(ran, flag.to(torch.int32),
                                     si[:, SI_PEND])
        si[:, SI_RECAP] += flag.to(torch.int32)
        si[:, SI_EVAL] = torch.where(flag, 0, si[:, SI_EVAL])
        ran = ran & ~flag
        trial = trial & ~flag
    si[:, SI_IT] += ran.to(torch.int32)
    si[:, SI_TRIAL] = torch.where(flag | held, si[:, SI_TRIAL], 0)
    err_new = run.trial.to(f32)
    sf[:, SF_ERRN] = torch.where(trial, err_new, sf[:, SF_ERRN])
    mu0, mu, nu = sf[:, SF_MU0], sf[:, SF_MU], sf[:, SF_NU]
    dot = None
    for a in range(6):
        xa = sf[:, SF_X + a]
        v = xa * (mu0 * xa + sf[:, SF_B + a])
        dot = v if dot is None else dot + v
    gain = 0.5 * dot
    rho = (sf[:, SF_ERR] - err_new) / torch.where(
        torch.abs(gain) > 1e-30, gain, 1e-30)
    ok = rho > 0
    if run.cached:
        ok = ok & (si[:, SI_NIN] > 0)
    accept = trial & ok
    reject = trial & ~ok
    u = 2.0 * rho - 1.0
    mu_acc = mu0 * torch.clamp(1.0 - u * u * u, min=1.0 / 3.0)
    sf[:, SF_R:SF_R + 12] = torch.where(accept[:, None],
                                        sf[:, SF_RN:SF_RN + 12],
                                        sf[:, SF_R:SF_R + 12])
    sf[:, SF_MU] = torch.where(accept, mu_acc,
                               torch.where(reject, mu0 * nu, mu))
    sf[:, SF_NU] = torch.where(accept, torch.full_like(nu, cfg.nu_init),
                               torch.where(reject, nu * cfg.nu_init, nu))
    si[:, SI_EVAL] = torch.where(trial, accept.to(torch.int32),
                                 si[:, SI_EVAL])
    if run.cached:   # a cache LM that stopped here: its last run is over
        si[:, SI_RAN] = torch.where(run.running(si, cfg), si[:, SI_RAN], 0)


def _split_only_gathers(run: LMRun, name: str) -> None:
    if run.cached:
        raise ValueError(f"{name}: the split kernels take gather items "
                         "only; a table of cache items runs in lm_run")


def lm_system(run: LMRun, cfg: TrackConfig, group=None) -> None:
    """The LM system of every LM of ``run`` that runs and evaluates a
    gradient: on a CUDA device ``lm.cu``'s two phases (and the group's
    all-reduces between them; gather items only), else
    :func:`lm_system_plain`."""
    if not run.cuda:
        return lm_system_plain(run, cfg, group)
    _split_only_gathers(run, "lm_system")
    S = len(run.items)
    for phase, (buf, op) in enumerate(((run.wmax, "max"), (run.sys, "sum"))):
        kernels.launch("lm_system", ctypes.addressof(run.table), S, phase,
                       ctypes.addressof(run.bufs),
                       ctypes.addressof(run.cfg_args), device=run.dev,
                       shapes=run.shapes)
        if group is not None:
            comm.all_reduce(group, buf, op)


def lm_trial(run: LMRun, cfg: TrackConfig, group=None) -> None:
    """The trial error of every LM of ``run`` with a trial step: on a CUDA
    device ``lm.cu``'s ``emf_lm_trial`` (and the group's all-reduce; gather
    items only), else :func:`lm_trial_plain`."""
    if not run.cuda:
        return lm_trial_plain(run, cfg, group)
    _split_only_gathers(run, "lm_trial")
    kernels.launch("lm_trial", ctypes.addressof(run.table), len(run.items),
                   ctypes.addressof(run.bufs),
                   ctypes.addressof(run.cfg_args), device=run.dev,
                   shapes=run.shapes)
    if group is not None:
        comm.all_reduce(group, run.trial)


def lm_step(run: LMRun, cfg: TrackConfig, phase: int) -> None:
    """Phase ``phase`` of the LM step of every LM of ``run``: on a CUDA
    device ``lm.cu``'s ``emf_lm_step`` (one block an LM), else
    :func:`lm_step_plain`."""
    if not run.cuda:
        return lm_step_plain(run, cfg, phase)
    kernels.launch("lm_step", len(run.items), phase,
                   ctypes.addressof(run.bufs),
                   ctypes.addressof(run.cfg_args), device=run.dev,
                   shapes=run.shapes)


def lm_iteration(run: LMRun, cfg: TrackConfig, group=None) -> None:
    """One LM iteration of every LM of ``run`` as the split steps,
    enqueued."""
    lm_system(run, cfg, group)
    lm_step(run, cfg, 0)
    lm_trial(run, cfg, group)
    lm_step(run, cfg, 1)


def lm_run(run: LMRun, cfg: TrackConfig, iters: int) -> None:
    """Up to ``iters`` LM iterations of every LM of ``run``, each LM
    leaving once it has stopped or, after the launch's first iteration,
    once it is flagged for a re-capture (``SI_PEND``: a cache item); the
    others run on, and the launch ends once none runs. On a CUDA device
    one launch of ``run.kernel``, enqueued: the cooperative ``lm.cu``
    ``emf_lm_run`` over ``run.grid`` blocks, or for cache items that fit
    a cluster ``emf_lm_cluster``, one thread-block cluster an LM. Else
    :func:`lm_iteration` over the plain versions, ``iters`` times at most,
    the LMs that left marked in ``run.held`` (the stop read from the
    state, a plain version's host read)."""
    if not run.cuda:
        run.held[:] = False
        for i in range(iters):
            si = run.si.cpu()
            if i and run.cached:
                run.held |= si[:, SI_PEND] != 0
            if not bool((run.running(si, cfg) & ~run.held).any()):
                break
            lm_iteration(run, cfg)
        run.held[:] = False
        return
    grid = (run.grid,) if run.kernel == "lm_run" else ()
    kernels.launch(run.kernel, ctypes.addressof(run.table), len(run.items),
                   iters, ctypes.addressof(run.bufs),
                   ctypes.addressof(run.cfg_args), *grid, device=run.dev,
                   shapes=run.shapes)


def _run_tables(items: Sequence[LMItem], cfg: TrackConfig, chunk: int,
                iterate) -> List[dict]:
    """The loop of :func:`run_lm_items` and :func:`_run_lm_split`: per
    table of as many items as a launch takes, ``iterate(run, n)`` enqueues
    ``n`` = ``chunk`` iterations (fewer at ``max_iter``), then the state is
    read once, until every LM has stopped or ``max_iter`` iterations were
    enqueued."""
    out = []
    cap = (kernels.library("lm_run").emf_max_items()
           if items and items[0].tsdf.is_cuda else LM_MAX_ITEMS)
    for g0 in range(0, len(items), cap):
        run = LMRun(items[g0:g0 + cap], cfg)
        done = 0
        while True:
            n = min(chunk, cfg.max_iter - done)
            iterate(run, n)
            done += n
            si, sf = run.read()
            if done >= cfg.max_iter or not bool(run.running(si, cfg).any()):
                break
        for k in range(len(run.items)):
            sl = run.point_slice(k)
            out.append(dict(
                pose=_pose_mat(sf[k, SF_R:SF_R + 9].reshape(3, 3),
                               sf[k, SF_T:SF_T + 3]),
                iterations=int(si[k, SI_IT]),
                converged=bool(si[k, SI_CONV]),
                grad_norm=float(torch.max(torch.abs(
                    sf[k, SF_B:SF_B + 6]))),
                recaptures=0, dropped_points=0, host_reads=run.reads,
                track_weights=run.w[sl], huber_weights=run.hub[sl]))
    return out


def run_lm_items(items: Sequence[LMItem], cfg: TrackConfig,
                 group=None) -> List[dict]:
    """The gather sampler's LM of every item on the items' device, each as
    it would run alone: one :func:`lm_run` of ``max_iter`` iterations a
    table (it stops once every LM has stopped), the state read once after
    it; with a ``group``, :func:`_run_lm_split` (one iteration a read).
    Items take one table (:class:`LMRun`) per as many as a launch takes
    (``lm.cu``'s ``emf_max_items()`` on a CUDA device, ``LM_MAX_ITEMS``,
    its value, on the CPU), one after another.

    Returns per item a dict: ``pose`` (4, 4) host float32, ``iterations``,
    ``converged``, ``grad_norm`` (max|b| of the last evaluation),
    ``recaptures`` and ``dropped_points`` (0), ``host_reads`` (its
    table's reads of the state), and ``track_weights`` /
    ``huber_weights``, the (N,) weights of its last evaluation on the
    device."""
    if group is not None:
        return _run_lm_split(items, cfg, group)
    return _run_tables(items, cfg, cfg.max_iter,
                       lambda run, n: lm_run(run, cfg, n))


def _run_lm_split(items: Sequence[LMItem], cfg: TrackConfig, group=None,
                  chunk: int = 1) -> List[dict]:
    """:func:`run_lm_items` with each iteration enqueued as the split steps
    (:func:`lm_iteration`: on a CUDA device five launches of ``lm.cu``'s
    ``lm_system``, ``lm_step`` and ``lm_trial``, with a ``group``'s
    all-reduces between them), ``chunk`` iterations between two reads of
    the state: the pixel-sharded LM's loop, and on one card the
    comparison that ``lm_run`` is held against."""
    def iterate(run, n):
        for _ in range(n):
            lm_iteration(run, cfg, group)
    return _run_tables(items, cfg, chunk, iterate)


def track_volumes_gather(items: Sequence[LMItem], cfg: TrackConfig,
                         group=None):
    """S independent gather-sampler LMs in one table (the JAX pipeline's
    ``lax.scan`` of its serial object LMs, ``pipeline.py:540-545``; each
    item's LM is the one it would run alone): per item ``(pose (4, 4)
    host float32, stats)`` with :func:`track_volume`'s stats and
    ``host_reads`` (:func:`run_lm_items`)."""
    res = run_lm_items(items, cfg, group)
    return [(r.pop("pose"), r) for r in res]


def capture_items(items: Sequence[LMItem]) -> List[LMItem]:
    """Cache items of ``items`` (their volumes, points made contiguous,
    weights and start poses): each point's windows captured at its item's
    start pose, on a CUDA device in one K3 launch for every item
    (:func:`~emfusion_tpu_torch.geometry.capture.capture_into`)."""
    out, jobs = [], []
    for it in items:
        pts = it.points.contiguous()
        cache, anchor = capture_buffers(it.tsdf, pts.shape[1],
                                        device=pts.device)
        pose = torch.as_tensor(it.rel_pose, dtype=torch.float32).cpu()
        jobs.append((it.tsdf, it.weights, pts, pose[:3, :3], pose[:3, 3],
                     it.voxel_size, cache, anchor))
        out.append(dataclasses.replace(it, points=pts, cache=cache,
                                       anchor=anchor))
    capture_into(jobs)
    return out


def capture_table(items: Sequence[LMItem], cfg: TrackConfig):
    """One table of cache items (as many as a launch takes) run to their
    stop with up to ``max_recaptures`` re-captures each: :func:`lm_run` of
    ``max_iter`` iterations and one read of the state; while an item is
    flagged for a re-capture, its windows captured at its trial pose into
    its own cache and anchors (one K3 launch for every flagged item), then
    :func:`lm_run` and a read again. Returns (the :class:`LMRun`, its last
    read (si, sf))."""
    run = LMRun(items, cfg, recaps=cfg.max_recaptures)
    while True:
        lm_run(run, cfg, cfg.max_iter)
        si, sf = run.read()
        flagged = torch.nonzero(si[:, SI_PEND]).flatten().tolist()
        if not flagged:
            return run, (si, sf)
        jobs = []
        for k in flagged:
            it = run.items[k]
            jobs.append((it.tsdf, it.weights, it.points,
                         sf[k, SF_RN:SF_RN + 9].reshape(3, 3),
                         sf[k, SF_TN:SF_TN + 3], it.voxel_size, it.cache,
                         it.anchor))
        capture_into(jobs)


def track_volumes_capture(items: Sequence[LMItem], cfg: TrackConfig):
    """The capture sampler's LMs of ``items`` (gather items: volumes,
    points, weights, start poses), each as it would run alone: their
    windows captured at the starts (:func:`capture_items`), then one
    :func:`capture_table` per as many as a launch takes (``lm.cu``'s
    ``emf_max_items()`` on a CUDA device, ``LM_MAX_ITEMS`` on the CPU).
    The JAX package's capture loop (``tracking.py:224-352`` there): the
    camera's LM, or every serial object LM of a frame (its ``lax.scan``
    over the slots). On a CUDA device :func:`lm_run` launches (the
    accelerator camera's 34,240 points: ``lm_run``), K3 launches and at
    most 1 + the table's re-captures reads; on the CPU the plain
    versions.

    Returns per item ``(pose (4, 4) host float32, stats)``:
    ``iterations``, ``converged``, ``grad_norm`` (max|b| of the last
    evaluation), ``recaptures``, ``host_reads`` (its table's reads of the
    state), ``dropped_points`` (its relevant points outside its last
    windows at its final pose: a 0-d int64 tensor on the device, not
    read), and ``track_weights`` / ``huber_weights``, the (N,) weights of
    its last evaluation on the device."""
    items = capture_items(items)
    cap = (kernels.library("lm_run").emf_max_items()
           if items and items[0].tsdf.is_cuda else LM_MAX_ITEMS)
    out = []
    for g0 in range(0, len(items), cap):
        run, (si, sf) = capture_table(items[g0:g0 + cap], cfg)
        for k, it in enumerate(run.items):
            R, t = sf[k, SF_R:SF_R + 9].reshape(3, 3), sf[k, SF_T:SF_T + 3]
            sl = run.point_slice(k)
            dropped = out_of_window_count(
                it.anchor, it.points, *(_upload(x, run.dev) for x in (
                    R, t, torch.tensor(float(it.voxel_size)))),
                tuple(it.tsdf.shape))
            out.append((_pose_mat(R, t), dict(
                iterations=int(si[k, SI_IT]),
                converged=bool(si[k, SI_CONV]),
                grad_norm=float(torch.max(torch.abs(sf[k, SF_B:SF_B + 6]))),
                recaptures=int(si[k, SI_RECAP]), dropped_points=dropped,
                host_reads=run.reads, track_weights=run.w[sl],
                huber_weights=run.hub[sl])))
    return out
