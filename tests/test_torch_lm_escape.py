"""Fault F2: the fixed-cache LM's escape from its windows, and the port's
guard against it.

A cache item's LM (the batched object LM's fixed-cache stages, the JAX
package's ``_lm_fixed_cache``; and the capture sampler's LM once its
re-capture budget is spent) samples ψ from each point's captured 6^3
window, and ψ is 0 outside it. A trial step that carries every weighted
point out of its window therefore scores the error 0 of an empty sum,
``rho > 0`` accepts it, and the slot jumps by more than a window: the
JAX package takes that step (``emfusion_tpu/tracking.py:452-459``, and
``:230`` in the capture loop past ``max_recaptures``). The port rejects a
trial at which no point with ``w > 0`` samples a valid ψ (inside its
window and the volume), as it rejects ``rho <= 0``: on the card in
``lm.cu``'s decide, on the CPU in ``tracking.lm_step_plain`` and in
``_track_volume_host``'s capture sampler.

The scene: a 16^3 volume at 1 cm whose tsdf rises by 0.1 a voxel along x
from 0.6 at the points' plane (x = 10.5 voxels) down to the plane x = 8,
and is 1 (free space) below it; 24 points on that plane with unit
weights. The LM's first step with ``tau`` 1e-6 (its damping negligible)
is the Gauss-Newton step to the slope's zero crossing, 7 voxels along
-x, out of every window (a point's local coordinate lies in [2, 3) after
a capture and must stay in [0, 4]) and into free space.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emfusion_tpu import tracking as jtr
from emfusion_tpu.geometry.capture import (
    capture_neighborhoods as jax_capture,
)
from emfusion_tpu.geometry.capture import (
    out_of_window_count as jax_out_of_window,
)
from emfusion_tpu.geometry.capture import (
    sample_value_from_cache as jax_value_from_cache,
)
from emfusion_tpu_torch import kernels
from emfusion_tpu_torch import tracking as tr
from emfusion_tpu_torch.geometry.capture import capture_neighborhoods_plain

torch.set_num_threads(2)

RES, VS, N = 16, 0.01, 24
PLANE = 10.5        # the points' x, in voxels
TAU = 1e-6          # an undamped first step
STEP = 7.0          # the Gauss-Newton step along -x, in voxels
WIN = 6             # a window's voxels an axis


def volumes(zero_at=PLANE - STEP, floor=8):
    """(tsdf, weights) (Z, Y, X) float32: the slope 0.1 a voxel along x
    with its zero crossing at ``zero_at``, 1 below x = ``floor``."""
    x = np.arange(RES, dtype=np.float32)
    row = np.where(x >= floor, 0.1 * (x - zero_at), 1.0).astype(np.float32)
    tsdf = np.ascontiguousarray(np.broadcast_to(row, (RES, RES, RES)))
    return tsdf, np.ones_like(tsdf)


def points():
    """(3, N) camera points on the plane x = ``PLANE`` voxels in front of
    the camera (the camera-to-volume transform is the identity)."""
    rng = np.random.RandomState(0)
    v = np.stack([np.full(N, PLANE), rng.uniform(4.3, 11.7, N),
                  rng.uniform(8.3, 12.7, N)])
    return np.ascontiguousarray((v - (RES - 1) / 2) * VS, np.float32)


def jax_cfg(**kw):
    return jtr.TrackConfig(tau=TAU, sampler="capture", **kw)


def port_cfg(**kw):
    return tr.TrackConfig(tau=TAU, **kw)


def cache_item(tsdf, wts, pts):
    """A port cache item captured at the identity."""
    vols = [torch.tensor(tsdf), torch.tensor(wts)]
    p = torch.tensor(pts)
    cache, anchor = capture_neighborhoods_plain(vols, p, torch.eye(3),
                                                torch.zeros(3), VS)
    return tr.LMItem(vols[0], vols[1], VS, p, torch.ones(N), torch.eye(4),
                     cache=cache, anchor=anchor)


@pytest.fixture(scope="module")
def jax_first_step():
    """The JAX package's ``_lm_fixed_cache`` for one iteration from the
    identity, its windows captured there."""
    tsdf, wts = volumes()
    pts = jnp.asarray(points())
    cache, anchor = jax_capture(jnp.stack([jnp.asarray(tsdf),
                                           jnp.asarray(wts)]), pts,
                                jnp.eye(3), jnp.zeros(3), VS)
    st = jtr._lm_fixed_cache(cache, anchor, pts, jnp.ones(N), jnp.eye(3),
                             jnp.zeros(3), VS, tsdf.shape, jax_cfg(), True,
                             max_iter=1)
    psi_new = jax_value_from_cache(cache[0:1], anchor, pts, st.R, st.t, VS,
                                   tsdf.shape, margin=1)[0]
    out = jax_out_of_window(anchor, pts, st.R, st.t, VS, tsdf.shape)
    return dict(st=st, err_new=float(jnp.sum(st.w * psi_new * psi_new)),
                out=int(out))


def test_jax_fixed_cache_accepts_the_empty_window_step(jax_first_step):
    """JAX's first iteration: the trial pose leaves all 24 weighted points
    outside their windows, its error is 0, and the step is accepted (the
    gradient is evaluated again): the slot moves by more than a window,
    into free space, where the volume's error is larger than at the
    start."""
    st = jax_first_step["st"]
    assert int(st.it) == 1 and bool(st.eval_grad)     # accepted
    assert float(st.err) > 1.0 and jax_first_step["err_new"] == 0.0
    assert jax_first_step["out"] == N
    assert np.count_nonzero(np.asarray(st.w)) == N
    t = np.asarray(st.t) / VS
    assert t[0] < -WIN and abs(t[0] + STEP) < 1e-3, t
    # the tsdf at the landing plane (x = 3.5 voxels) is 1: every point's
    # residual there is 1, against 0.6 at the start
    tsdf, _ = volumes()
    assert tsdf[0, 0, int(PLANE + t[0])] == 1.0


def test_jax_batched_lm_lands_in_free_space():
    """JAX ``track_volumes_batched`` (stages of one iteration): stage 1
    takes the escape, stage 2 re-captures in free space (ψ 1, no
    gradient) and stops there, 7 voxels off."""
    tsdf, wts = volumes()
    pose, st = jtr.track_volumes_batched(
        jnp.asarray(tsdf)[None], jnp.asarray(wts)[None], jnp.full(1, VS),
        jnp.asarray(points())[None], jnp.ones((1, N)),
        jnp.eye(4)[None], jax_cfg(max_iter=2), jnp.ones(1, bool))
    t = np.asarray(pose)[0, :3, 3] / VS
    assert abs(t[0] + STEP) < 1e-3, t
    assert bool(np.asarray(st["converged"])[0])


def test_port_cache_lm_rejects_the_step(jax_first_step):
    """The port's plain cache-item LM, one iteration: it proposes the
    step JAX takes (the trial pose within 1e-5 m of JAX's new pose), finds
    no weighted point with a valid ψ there (``SI_NIN`` 0, error 0) and
    rejects it as ``rho <= 0`` is rejected: the pose keeps its bits,
    ``mu = mu0 nu``, ``nu`` doubles, and no gradient is evaluated
    next."""
    cfg = port_cfg()
    run = tr.LMRun([cache_item(*volumes(), points())], cfg)
    before = run.sf.clone()
    launches = dict(kernels.launches)
    tr.lm_iteration(run, cfg)
    assert kernels.launches == launches            # the plain versions
    si, sf = run.si[0], run.sf[0]
    assert int(si[tr.SI_IT]) == 1 and int(si[tr.SI_NIN]) == 0
    assert float(run.trial[0]) == 0.0 and float(sf[tr.SF_ERR]) > 1.0
    assert int(si[tr.SI_EVAL]) == 0 and int(si[tr.SI_CONV]) == 0
    assert torch.equal(sf[tr.SF_R:tr.SF_R + 12], before[0, :12])
    mu0 = sf[tr.SF_MU0]
    assert float(mu0) > 0
    assert torch.equal(sf[tr.SF_MU], mu0 * 2.0)
    assert float(sf[tr.SF_NU]) == 4.0
    jst = jax_first_step["st"]
    np.testing.assert_allclose(sf[tr.SF_TN:tr.SF_TN + 3].numpy(),
                               np.asarray(jst.t), rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        sf[tr.SF_RN:tr.SF_RN + 9].numpy().reshape(3, 3), np.asarray(jst.R),
        rtol=0, atol=1e-5)


def test_port_lm_stays_within_its_windows():
    """The port's LM through ``run_lm_items`` (plain on the CPU): one
    iteration keeps the start pose; with 30 it raises the damping until a
    step stays inside the windows, and then descends the slope by less
    than a window, lowering the error, never landing in free space."""
    item = cache_item(*volumes(), points())
    (one,) = tr.run_lm_items([item], port_cfg(max_iter=1))
    assert torch.equal(one["pose"], torch.eye(4))
    (run,) = tr.run_lm_items([item], port_cfg(max_iter=30))
    dx = float(run["pose"][0, 3]) / VS
    assert -(WIN - 2) < dx < -0.5, dx
    assert PLANE + dx > 8.0                  # still on the slope


def test_port_batched_lm_keeps_the_slot():
    """The port's ``track_volumes_batched`` on the JAX test's input: both
    one-iteration stages reject the step, so the slot keeps its pose
    where JAX's moved it 7 voxels."""
    tsdf, wts = volumes()
    pose, st = tr.track_volumes_batched(
        torch.tensor(tsdf)[None], torch.tensor(wts)[None],
        torch.full((1,), VS), torch.tensor(points())[None],
        torch.ones((1, N)), torch.eye(4)[None], port_cfg(max_iter=2),
        torch.ones(1, dtype=torch.bool))
    assert torch.equal(pose[0], torch.eye(4))
    assert st["iterations"].tolist() == [2]
    assert st["recaptures"].tolist() == [1]


def test_a_table_decides_each_lm_alone():
    """A table of the escaping item and one whose first step (1.5 voxels)
    stays inside its windows: the first is rejected, the second accepted
    with all 24 points counted, and each ends on the bits it has
    alone."""
    pts = points()
    items = [cache_item(*volumes(), pts),
             cache_item(*volumes(zero_at=PLANE - 1.5), pts)]
    cfg = port_cfg()
    both = tr.LMRun(items, cfg)
    tr.lm_iteration(both, cfg)
    assert both.si[:, tr.SI_NIN].tolist() == [0, N]
    assert both.si[:, tr.SI_EVAL].tolist() == [0, 1]
    for k, it in enumerate(items):
        alone = tr.LMRun([it], cfg)
        tr.lm_iteration(alone, cfg)
        assert torch.equal(alone.si[0], both.si[k]), k
        assert torch.equal(alone.sf[0], both.sf[k]), k


def test_capture_loop_past_its_budget_rejects_the_step():
    """The capture sampler's LM with no re-capture budget
    (``max_recaptures`` 0): the JAX loop takes the escape (7 voxels, no
    re-capture); the port's host loop (``_track_volume_host``) reads the
    trial's count with its error in the one read it already made (2 reads
    for an evaluation and a trial) and rejects the step."""
    tsdf, wts = volumes()
    pts = points()
    jpose, jst = jtr.track_volume(
        jnp.asarray(tsdf), jnp.asarray(wts), VS, jnp.asarray(pts),
        jnp.ones(N), jnp.eye(4), jax_cfg(max_iter=1, max_recaptures=0))
    assert abs(float(jpose[0, 3]) / VS + STEP) < 1e-3
    assert int(jst["recaptures"]) == 0
    pose, st = tr._track_volume_host(
        torch.tensor(tsdf), torch.tensor(wts), VS, torch.tensor(pts),
        torch.ones(N), torch.eye(4),
        port_cfg(max_iter=1, max_recaptures=0, sampler="capture"))
    assert torch.equal(pose, torch.eye(4))
    assert st["host_reads"] == 2 and st["recaptures"] == 0
    assert st["dropped_points"] == 0


def test_capture_loop_within_its_budget_matches_jax():
    """With its budget (3), the capture loop re-captures at the trial pose
    (every point drifted) and finds free space there: both packages
    reject the step by its error, with one re-capture; the port reads the
    drift, the error and the count at once, then the re-captured error
    and count (3 reads)."""
    tsdf, wts = volumes()
    pts = points()
    jpose, jst = jtr.track_volume(
        jnp.asarray(tsdf), jnp.asarray(wts), VS, jnp.asarray(pts),
        jnp.ones(N), jnp.eye(4), jax_cfg(max_iter=1))
    pose, st = tr._track_volume_host(
        torch.tensor(tsdf), torch.tensor(wts), VS, torch.tensor(pts),
        torch.ones(N), torch.eye(4), port_cfg(max_iter=1, sampler="capture"))
    np.testing.assert_array_equal(np.asarray(jpose), np.eye(4))
    assert torch.equal(pose, torch.eye(4))
    assert int(jst["recaptures"]) == st["recaptures"] == 1
    assert st["host_reads"] == 3
