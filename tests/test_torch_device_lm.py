"""The device-resident LM of the gather sampler (``tracking.run_lm_items``
and its plain versions ``lm_system_plain``, ``lm_trial_plain`` and
``lm_step_plain``, which run on the CPU) against the JAX package's
``track_volume`` with its default sampler (the gather sampler on the CPU,
``tracking.py:148-150``; no sampler override on either side), against the
port's per-iteration host loop (``tracking._track_volume_host``), and along
every control path of the loop: convergence at the first evaluation, the
step test, a rejected step whose gradient is reused, the ``max_iter``
stop, a stop at a chunk's last iteration, an LM with no valid point, a
table of LMs, and the pixel-sharded LM over two gloo ranks.

Tolerances: the JAX package sums the system in float32 (XLA's order), the
port in float64, so the two may stop a few iterations apart; their poses
agree to 0.01 voxel (measured ~1e-6 m at 0.05 m voxels). Runs that take
the same decisions on the same state agree bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emfusion_tpu.geometry import se3_exp as jax_se3_exp
from emfusion_tpu.tracking import TrackConfig as JaxTrackConfig
from emfusion_tpu.tracking import track_volume as jax_track
from emfusion_tpu_torch import kernels
from emfusion_tpu_torch.distributed.mesh import launch
from emfusion_tpu_torch.tracking import (
    SF_MU, SF_R, SI_CONV, SI_EVAL, SI_IT, SI_TRIAL, LMItem, LMRun,
    TrackConfig, _run_lm_split, _track_volume_host, lm_iteration,
    run_lm_items, track_volume, track_volumes_gather,
)
from test_raycast import sphere_volume
from test_torch_fusion import VOXEL as JUMP_VOXEL
from test_torch_gather_lm import camera_jump

torch.set_num_threads(2)

SPHERE_VOXEL = 0.05


def sphere_case(n=400, seed=1, xi=(0.02, -0.03, 0.04, 0.02, -0.01, 0.015),
                res=64):
    """``tests/test_tracking.py``'s sphere (radius 0.5 m in a 64^3 volume at
    5 cm, the camera 1.2 m away) and its camera-facing surface points,
    started at ``se3_exp(xi)`` from the truth: (tsdf, weights, voxel,
    points (3, N), assoc, init)."""
    tsdf, weights = sphere_volume(res, SPHERE_VOXEL, 0.5, 0.25)
    gt = np.eye(4, dtype=np.float32)
    gt[2, 3] = -1.2
    rng = np.random.RandomState(seed)
    v = rng.randn(n, 3)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    v[:, 2] = -np.abs(v[:, 2])
    T = np.linalg.inv(gt)
    pc = (v * 0.5) @ T[:3, :3].T + T[:3, 3]
    pts = np.ascontiguousarray(pc[pc[:, 2] > 0.1].astype(np.float32).T)
    init = (np.asarray(jax_se3_exp(jnp.asarray(xi, jnp.float32))) @ gt
            ).astype(np.float32)
    return (tsdf, weights, SPHERE_VOXEL, pts,
            np.ones(pts.shape[1], np.float32), init)


@pytest.fixture(scope="module")
def cases():
    """The sphere and the 5- and 6-voxel camera jumps of
    ``test_torch_gather_lm`` (frame 2 of the fused two-frame scene)."""
    out = {"sphere": sphere_case()}
    for off in (5, 6):
        t, w, p, a, i = camera_jump(off)
        out[f"jump{off}"] = (t, w, JUMP_VOXEL, p, a, i)
    return out


def torch_args(case):
    t, w, vs, p, a, i = case
    return [torch.tensor(t), torch.tensor(w), vs, torch.tensor(p),
            torch.tensor(a), torch.tensor(i)]


def run_port(case, cfg):
    return track_volume(*torch_args(case), cfg)


def run_host(case, cfg):
    """The port's per-iteration host loop, the device LM's reference."""
    return _track_volume_host(*torch_args(case), cfg)


def assert_pose_close(out, ref, voxel, frac=0.01):
    out, ref = np.asarray(out), np.asarray(ref)
    assert np.abs(out[:3, 3] - ref[:3, 3]).max() < frac * voxel
    assert np.abs(out[:3, :3] - ref[:3, :3]).max() < frac * voxel


@pytest.mark.parametrize("name", ["sphere", "jump5", "jump6"])
def test_device_lm_matches_jax_default(cases, name):
    """The plain device LM against the JAX package's default LM (the gather
    sampler): poses within 0.01 voxel, iterations within 3, and on the
    CPU no kernel launched."""
    case = cases[name]
    t, w, vs, p, a, i = case
    ref, ref_st = jax_track(jnp.asarray(t), jnp.asarray(w), vs,
                            jnp.asarray(p), jnp.asarray(a), jnp.asarray(i),
                            JaxTrackConfig(max_iter=50))
    before = dict(kernels.launches)
    out, st = run_port(case, TrackConfig(max_iter=50))
    assert kernels.launches == before
    assert_pose_close(out.numpy(), ref, vs)
    assert abs(st["iterations"] - int(ref_st["iterations"])) <= 3
    assert st["converged"] == bool(ref_st["converged"])
    assert st["recaptures"] == 0 and st["dropped_points"] == 0
    assert st["host_reads"] == 1
    np.testing.assert_allclose(st["track_weights"].numpy(),
                               np.asarray(ref_st["track_weights"]),
                               rtol=0, atol=1e-3)


@pytest.mark.parametrize("name", ["sphere", "jump5", "jump6"])
def test_device_lm_matches_host_loop(cases, name):
    """Against the port's per-iteration host loop on the same inputs
    (float32 sums there): poses within 0.01 voxel, iterations within 3;
    from the same start both evaluate the same per-point weights (to
    float32 rounding: the host loop's Huber weight multiplies by a
    reciprocal)."""
    case = cases[name]
    vs = case[2]
    out, st = run_port(case, TrackConfig(max_iter=50))
    host, host_st = run_host(case, TrackConfig(max_iter=50))
    assert host_st["host_reads"] >= host_st["iterations"]
    assert_pose_close(out.numpy(), host.numpy(), vs)
    assert abs(st["iterations"] - host_st["iterations"]) <= 3
    _, one = run_port(case, TrackConfig(max_iter=1))
    _, host_one = run_host(case, TrackConfig(max_iter=1))
    for key in ("track_weights", "huber_weights"):
        np.testing.assert_allclose(one[key].numpy(), host_one[key].numpy(),
                                   rtol=1e-6, atol=1e-7)


def iterate(case, cfg, n):
    """One LM stepped an iteration at a time: per iteration the state
    records and the float64 sums after it."""
    t, w, vs, p, a, i = torch_args(case)
    run = LMRun([LMItem(t, w, vs, p, a, i)], cfg)
    hist = []
    for _ in range(n):
        lm_iteration(run, cfg)
        hist.append((run.si[0].clone(), run.sf[0].clone(),
                     run.sys[0].clone()))
    return run, hist


def test_converges_at_first_evaluation(cases):
    """Association weights of 0: b = 0 at the first evaluation, so the LM
    converges there (one iteration, the start pose, ``grad_norm`` 0), as
    the host loop does."""
    case = list(cases["sphere"])
    case[4] = np.zeros_like(case[4])
    out, st = run_port(case, TrackConfig(max_iter=50))
    host, host_st = run_host(case, TrackConfig(max_iter=50))
    assert (st["iterations"], st["converged"], st["grad_norm"]) == (
        1, True, 0.0)
    assert host_st["iterations"] == 1 and host_st["converged"]
    assert torch.equal(out, torch.tensor(case[5]))
    assert torch.equal(host, out)
    assert not st["track_weights"].any()


def test_step_convergence(cases):
    """A step test that the first step passes (``eps2`` 1e3): converged
    after one iteration at the start pose, with ``mu`` = ``tau
    max(diag A)``, the trial skipped; the host loop stops there too."""
    cfg = TrackConfig(max_iter=50, eps2=1e3)
    case = cases["sphere"]
    out, st = run_port(case, cfg)
    host, host_st = run_host(case, TrackConfig(max_iter=50, eps2=1e3))
    assert (st["iterations"], st["converged"]) == (1, True)
    assert st["grad_norm"] > cfg.eps1
    assert torch.equal(out, torch.tensor(case[5])) and torch.equal(host, out)
    run, hist = iterate(case, cfg, 2)
    si, sf, sums = hist[0]
    A_diag = max(np.float32(float(sums[i])) for i in (0, 6, 11, 15, 18, 20))
    assert float(sf[SF_MU]) == np.float32(cfg.tau) * A_diag
    assert torch.equal(hist[1][0][:SI_TRIAL], si[:SI_TRIAL])
    assert torch.equal(hist[1][1], sf)


def test_reject_then_accept_reuses_gradient(cases):
    """With a small damping (``tau`` 1e-3) the sphere's third step is
    rejected: the pose stays, ``mu`` grows by ``nu``, and the next
    iteration solves again from the same system without re-evaluating it
    (the sums keep their bits), then accepts. The LM ends where the host
    loop ends."""
    cfg = TrackConfig(max_iter=50, tau=1e-3)
    run, hist = iterate(cfg=cfg, case=cases["sphere"], n=8)
    evals = [int(si[SI_EVAL]) for si, _, _ in hist]
    r = evals.index(0)                     # the first rejected step
    assert r > 0 and evals[r + 1] == 1     # then an accepted one
    (_, sf0, _), (_, sf1, sums1), (_, sf2, sums2) = hist[r - 1:r + 2]
    assert torch.equal(sf1[SF_R:SF_R + 12], sf0[SF_R:SF_R + 12])
    assert float(sf1[SF_MU]) > float(sf0[SF_MU])
    assert torch.equal(sums2, sums1)       # the gradient reused
    assert not torch.equal(sf2[SF_R:SF_R + 12], sf1[SF_R:SF_R + 12])
    out, st = run_port(cases["sphere"], cfg)
    host, host_st = run_host(cases["sphere"], TrackConfig(
        max_iter=50, tau=1e-3))
    assert_pose_close(out.numpy(), host.numpy(), SPHERE_VOXEL)


def test_max_iter_stop(cases):
    """``max_iter`` 3 stops a converging LM at 3 iterations, unconverged,
    after one read of the state; the host loop ends on the same pose to
    float32 summation (1e-6)."""
    case = cases["jump6"]
    out, st = run_port(case, TrackConfig(max_iter=3))
    host, host_st = run_host(case, TrackConfig(max_iter=3))
    assert (st["iterations"], st["converged"], st["host_reads"]) == (
        3, False, 1)
    assert host_st["iterations"] == 3 and not host_st["converged"]
    np.testing.assert_allclose(out.numpy(), host.numpy(), rtol=0, atol=1e-6)
    assert not torch.equal(out, torch.tensor(case[5]))


def still_sphere():
    """A smaller sphere whose association weights are 0: its LM stops at
    its first evaluation."""
    still = list(sphere_case(n=300, seed=5, res=48))
    still[4] = np.zeros_like(still[4])
    return tuple(still)


@pytest.mark.parametrize("name", ["sphere", "jump5", "table"])
def test_chunks_and_a_stop_at_a_chunk_end(cases, name):
    """The chunk only sets when the host reads: a table whose longest LM
    runs n iterations gives the same bits in the split loop
    (``_run_lm_split``) with chunks of 1, 4, n - 1, n and ``max_iter``,
    reading the state n, ceil(n / 4), 2, 1 and 1 times (a stop at the
    last iteration of a chunk, and one iteration into the next), and in
    ``run_lm_items`` (one ``lm_run`` of ``max_iter`` iterations, which
    stops once every LM has stopped; one read). The table holds the
    sphere, the 5-voxel jump and :func:`still_sphere`, which stops at its
    first evaluation while the others run on. A stopped LM ignores the
    rest of its chunk, and any later iteration (its state keeps its bits,
    but for the flags of the iteration in flight)."""
    scene = {"sphere": [cases["sphere"]], "jump5": [cases["jump5"]],
             "table": [cases["sphere"], cases["jump5"], still_sphere()]}
    cfg = TrackConfig(max_iter=50)
    items = [LMItem(*torch_args(c)) for c in scene[name]]
    ref = _run_lm_split(items, cfg, chunk=1)
    n = max(r["iterations"] for r in ref)
    assert 4 < n < 50 and ref[0]["host_reads"] == n
    runs = [(_run_lm_split(items, cfg, chunk=chunk), reads)
            for chunk, reads in ((4, -(-n // 4)), (n - 1, 2), (n, 1),
                                 (50, 1))]
    before = dict(kernels.launches)
    runs.append((run_lm_items(items, cfg), 1))
    assert kernels.launches == before
    for got, reads in runs:
        for a, b in zip(got, ref):
            assert a["host_reads"] == reads
            assert torch.equal(a["pose"], b["pose"])
            for key in ("iterations", "converged", "grad_norm"):
                assert a[key] == b[key], key
            for key in ("track_weights", "huber_weights"):
                assert torch.equal(a[key], b[key]), key
    if name == "table":
        assert ref[2]["iterations"] == 1 and ref[2]["converged"]
        assert min(r["iterations"] for r in ref[:2]) > 1
    n0 = ref[0]["iterations"]
    run, hist = iterate(scene[name][0], cfg, n0 + 3)
    assert int(hist[n0 - 1][0][SI_CONV]) == 1
    for si, sf, sums in hist[n0:]:
        assert torch.equal(si[:SI_TRIAL], hist[n0 - 1][0][:SI_TRIAL])
        assert torch.equal(sf, hist[n0 - 1][1])
        assert torch.equal(sums, hist[n0 - 1][2])
    assert int(run.si[0, SI_IT]) == n0


def test_no_valid_point(cases):
    """Every point behind the camera: ψ and the weights are 0, ``wmax`` is
    0 (no division by it), b = 0, so the LM converges at its first
    evaluation on the start pose."""
    case = list(cases["sphere"])
    pts = case[3].copy()
    pts[2] = -np.abs(pts[2])
    case[3] = pts
    out, st = run_port(case, TrackConfig(max_iter=50))
    assert (st["iterations"], st["converged"], st["grad_norm"]) == (
        1, True, 0.0)
    assert torch.equal(out, torch.tensor(case[5]))
    assert not st["track_weights"].any() and not st["huber_weights"].any()
    run, _ = iterate(case, TrackConfig(max_iter=50), 1)
    assert float(run.wmax[0]) == 0.0 and not run.w.any()


def test_table_of_three_equals_each_alone(cases):
    """Three LMs of different volumes, point counts, weights and starts in
    one table: each equals its own one-LM run bit for bit (pose,
    iterations, weights), though they stop at different iterations; the
    table reads the state as often as its longest LM needs."""
    sph2 = list(sphere_case(n=300, seed=5, xi=(-0.03, 0.02, 0.01, -0.02,
                                                0.02, 0.01), res=48))
    sph2[4] = np.random.RandomState(2).uniform(
        0.2, 1.0, sph2[3].shape[1]).astype(np.float32)
    items = [LMItem(*torch_args(c))
             for c in (cases["sphere"], cases["jump5"], sph2)]
    cfg = TrackConfig(max_iter=50)
    table = track_volumes_gather(items, cfg)
    alone = [track_volumes_gather([it], cfg)[0] for it in items]
    iters = []
    for (pose, st), (pose1, st1) in zip(table, alone):
        assert torch.equal(pose, pose1)
        assert st["iterations"] == st1["iterations"]
        assert st["converged"] == st1["converged"]
        for key in ("track_weights", "huber_weights"):
            assert torch.equal(st[key], st1[key])
        iters.append(st["iterations"])
    assert len(set(iters)) > 1
    assert table[0][1]["host_reads"] == max(s["host_reads"]
                                            for _, s in alone)


def test_pixel_sharded_two_ranks():
    """The pixel-sharded LM (``group=``) over 2 gloo ranks, each with its
    block of the distributed test's 48^3 sphere's 4,096 points: every rank
    ends on the same pose bits, within 1e-5 of one rank (the ranks' float64
    partial sums, rounded once, take the one rank's decisions)."""
    res, voxel, trunc = 48, 0.05, 0.25
    idx = np.arange(res, dtype=np.float32) - (res - 1) / 2
    zz, yy, xx = np.meshgrid(idx, idx, idx, indexing="ij")
    r = np.sqrt(xx ** 2 + yy ** 2 + zz ** 2) * voxel
    tsdf = np.clip((r - 0.5) / trunc, -1, 1).astype(np.float32)
    weights = np.ones_like(tsdf)
    rng = np.random.RandomState(7)
    n = 4096
    v = rng.randn(n, 3)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    v[:, 2] = -np.abs(v[:, 2])
    gt = np.eye(4, dtype=np.float32)
    gt[2, 3] = -1.2
    T = np.linalg.inv(gt)
    pts = ((v * 0.5) @ T[:3, :3].T + T[:3, 3]).astype(np.float32).T
    init = (np.asarray(jax_se3_exp(jnp.array(
        [0.02, -0.03, 0.04, 0.02, -0.01, 0.015]))) @ gt).astype(np.float32)
    assoc = np.ones(n, np.float32)
    one, st = track_volume(torch.tensor(tsdf), torch.tensor(weights), voxel,
                           torch.tensor(np.ascontiguousarray(pts)),
                           torch.tensor(assoc), torch.tensor(init),
                           TrackConfig(max_iter=30))
    res2 = launch("torch_dist_workers:track_rank", 2,
                  args=(tsdf, weights, voxel, pts, assoc, init,
                        dict(max_iter=30)), device="cpu", threads=1,
                  timeout_s=120)
    pose = res2[0]["pose"]
    assert np.array_equal(res2[1]["pose"], pose)
    np.testing.assert_allclose(pose, one.numpy(), rtol=0, atol=1e-5)
    assert res2[0]["iterations"] == st["iterations"]
    # per iteration the weight maximum, the system and the trial error
    assert res2[0]["comm"]["all_reduce"]["calls"] == 3 * st["iterations"]
