"""The capture sampler's LM as a table of re-capturing cache items
(``tracking.track_volumes_capture``, which ``track_volume`` with
``sampler="capture"`` runs without a ``group``) against the per-iteration
host loop it replaced (``tracking._track_volume_host``, which stays the
reference), on the CPU, where ``lm_run`` runs the plain iteration and K3
its plain capture.

The new form runs the JAX package's capture loop (``emfusion_tpu/
tracking.py:224-352``) as the card does: an ``lm_run`` of ``max_iter``
iterations which an item leaves after the iteration in which its trial
found its points drifted out of their windows (flagged, undecided), the
others running on to their stop, one read after it,
the flagged items' windows captured at their trial poses, and the table
run on from their trials; so a call reads the device at most 1 + its
table's re-captures times. The host loop reads every evaluation and every
trial.

The scene is ``test_torch_batched_device_lm``'s analytic sphere joined to
a box (32^3 at 1 cm, 1,000 surface points), with starts that take no
re-capture, one, two, and the whole budget of three and beyond it (points
left their last windows: dropped). The two forms do the same float32
operations in other orders (the host loop's ``linalg.solve`` and matrix
products against the kernels' spelled-out solve and sums in float64), so
their iterates differ in the last bits; ``eps2`` is 1e-6, as in
``test_torch_batched_device_lm``: at the default 1e-8 the step test is
met only at the float32 noise floor, where the two forms may stop an
iteration or a few apart.
"""

import dataclasses

import numpy as np
import pytest
import torch

from emfusion_tpu_torch import kernels
from emfusion_tpu_torch import tracking as tr
from emfusion_tpu_torch.geometry.capture import capture_into
from emfusion_tpu_torch.tracking import TrackConfig
from test_torch_batched_device_lm import VS, make_scene, moved
from test_torch_lm_escape import N as ESCAPE_N
from test_torch_lm_escape import VS as ESCAPE_VS
from test_torch_lm_escape import points as escape_points
from test_torch_lm_escape import volumes as escape_volumes

torch.set_num_threads(2)

CFG = TrackConfig(max_iter=40, eps2=1e-6, sampler="capture")
# (start twist: translation in voxels, rotation in radians; the
# re-captures the host loop takes from it)
STARTS = {
    "none": ([1.0, 0.4, -0.3, 0.01, -0.01, 0.005], 0),
    "one": ([2.0, 0.8, -0.6, 0.01, -0.01, 0.005], 1),
    "two": ([0.0, 5.0, 0.0, 0.01, -0.01, 0.005], 2),
    "beyond": ([5.0, 0.0, 0.0, 0.01, -0.01, 0.005], 3),
}


@pytest.fixture(scope="module")
def scene():
    return make_scene()


def lm_args(scene, start):
    """``track_volume``'s arguments but the config, from ``start``."""
    return ([torch.tensor(scene[k]) for k in ("tsdf", "wts")] + [VS]
            + [torch.tensor(scene[k]) for k in ("pts", "assoc")]
            + [torch.tensor(moved(scene, start))])


def item(scene, start):
    a = lm_args(scene, start)
    return tr.LMItem(a[0], a[1], a[2], a[3], a[4], a[5])


@pytest.fixture(scope="module")
def runs(scene):
    """Per start: (the new form's pose and stats, the host loop's)."""
    out = {}
    for name, (start, _) in STARTS.items():
        before = dict(kernels.launches)
        new = tr.track_volume(*lm_args(scene, start), CFG)
        assert kernels.launches == before          # the plain versions
        out[name] = (new, tr._track_volume_host(*lm_args(scene, start), CFG))
    return out


@pytest.mark.parametrize("name", list(STARTS))
def test_capture_lm_matches_the_host_loop(runs, name):
    """The same re-captures, iterations, convergence and dropped points as
    the host loop, the final poses within 1e-5, and the last weights
    within 1e-5; one read, and one more for each re-capture (the host
    loop reads every evaluation and trial)."""
    (pose, st), (hpose, hst) = runs[name]
    assert st["recaptures"] == hst["recaptures"] == STARTS[name][1]
    assert st["iterations"] == hst["iterations"]
    assert st["converged"] == hst["converged"]
    assert float((pose - hpose).abs().max()) <= 1e-5
    assert torch.is_tensor(st["dropped_points"])   # left unread
    assert int(st["dropped_points"]) == hst["dropped_points"]
    assert st["host_reads"] == 1 + st["recaptures"]
    assert hst["host_reads"] > st["iterations"]
    for key in ("track_weights", "huber_weights"):
        assert float((st[key] - hst[key]).abs().max()) <= 1e-5, key


def test_starts_span_the_budget(runs, scene):
    """The starts take 0, 1, 2 and 3 re-captures; the last one converges
    past its budget with points outside its last windows (dropped), and
    every LM ends within a voxel of the truth."""
    assert [runs[n][0][1]["recaptures"] for n in STARTS] == [0, 1, 2, 3]
    assert int(runs["beyond"][0][1]["dropped_points"]) > 100
    assert all(int(runs[n][0][1]["dropped_points"]) == 0
               for n in ("none", "one", "two"))
    for name in STARTS:
        pose, st = runs[name][0]
        assert st["converged"], name
        gap = np.linalg.norm(pose[:3, 3].numpy() - scene["truth"][:3, 3])
        assert gap < VS, (name, gap)


def test_a_table_runs_each_lm_as_alone(scene, runs):
    """One table of three capture items (0, 2 and 3 re-captures): each
    ends on the bits it has alone (pose, counts, weights); the table
    reads at most 1 + its re-captures times, once more for each round in
    which an item was flagged."""
    names = ("none", "two", "beyond")
    table = tr.track_volumes_capture(
        [item(scene, STARTS[n][0]) for n in names], CFG)
    reads = {st["host_reads"] for _, st in table}
    assert len(reads) == 1
    recaps = [st["recaptures"] for _, st in table]
    assert recaps == [0, 2, 3]
    assert max(recaps) < reads.pop() <= 1 + sum(recaps)
    for name, (pose, st) in zip(names, table):
        alone_pose, alone = runs[name][0]
        assert torch.equal(pose, alone_pose), name
        for key in ("iterations", "converged", "recaptures", "grad_norm"):
            assert st[key] == alone[key], (name, key)
        assert int(st["dropped_points"]) == int(alone["dropped_points"])
        for key in ("track_weights", "huber_weights"):
            assert torch.equal(st[key], alone[key]), (name, key)


def test_a_launch_ends_for_each_lm_on_its_own(scene, runs):
    """``lm_run`` (the plain iteration) over a table of the start that
    re-captures once and the one that takes none: in the first launch the
    first LM is flagged and leaves it, while the second runs on and
    reaches its stop in that same launch, at the iterations it takes
    alone; the launch ends then, not after the flag. Through
    ``track_volumes_capture`` each LM ends on the bits it has alone
    (pose, counts, weights), in at most 1 + its re-captures reads."""
    names = ("one", "none")
    run = tr.LMRun(tr.capture_items([item(scene, STARTS[n][0])
                                     for n in names]),
                   CFG, recaps=CFG.max_recaptures)
    tr.lm_run(run, CFG, CFG.max_iter)
    si = run.si
    alone = runs["none"][0][1]
    assert int(si[0, tr.SI_PEND]) == 1 and int(si[0, tr.SI_RECAP]) == 1
    assert int(si[1, tr.SI_CONV]) == 1 and not run.held.any()
    assert int(si[1, tr.SI_IT]) == alone["iterations"]
    assert int(si[1, tr.SI_IT]) > int(si[0, tr.SI_IT]) + 1
    table = tr.track_volumes_capture(
        [item(scene, STARTS[n][0]) for n in names], CFG)
    for name, (pose, st) in zip(names, table):
        alone_pose, alone = runs[name][0]
        assert torch.equal(pose, alone_pose), name
        for key in ("iterations", "converged", "recaptures", "grad_norm"):
            assert st[key] == alone[key], (name, key)
        for key in ("track_weights", "huber_weights"):
            assert torch.equal(st[key], alone[key]), (name, key)
        assert st["host_reads"] == 2 <= 1 + sum(
            s["recaptures"] for _, s in table)


def test_budget_zero_is_the_fixed_cache_run(scene):
    """A table with no re-capture budget is the batched object LM's
    fixed-cache table (``run_lm_items`` over cache items, one ``lm_run``,
    as ``track_volumes_batched``'s stages run it) bit for bit: the same
    state records, sums and weights, one read, no drift word written; on
    the start that re-captures three times with a budget."""
    start = STARTS["beyond"][0]
    cfg = dataclasses.replace(CFG, max_recaptures=0)
    run, (si, sf) = tr.capture_table(tr.capture_items([item(scene, start)]),
                                     cfg)
    fixed = tr.LMRun(tr.capture_items([item(scene, start)]), cfg)
    tr.lm_run(fixed, cfg, cfg.max_iter)
    for key in ("si", "sf", "sys", "trial", "w", "hub", "scratch", "wmax"):
        assert torch.equal(getattr(run, key), getattr(fixed, key)), key
    assert run.reads == 1 and run.recaps == 0
    words = [tr.SI_PEND, tr.SI_RECAP, tr.SI_NBAD, tr.SI_NREL]
    assert not si[:, words].any()
    (res,) = tr.run_lm_items(tr.capture_items([item(scene, start)]), cfg)
    assert torch.equal(res["pose"], tr._pose_mat(
        sf[0, tr.SF_R:tr.SF_R + 9].reshape(3, 3), sf[0, tr.SF_T:tr.SF_T + 3]))


def test_flagged_trial_waits_and_resumes(scene):
    """The state machine on the plain iteration, from the start that
    re-captures twice: ``lm_run`` stops after the iteration whose trial
    left the windows; decide flagged it (``SI_PEND``, ``SI_RECAP`` 1),
    kept ``it`` and the trial, and asks for no gradient. After the
    windows are captured at the trial pose, the next iteration skips to
    the trial (no evaluation: the weights stay) and decides it without a
    second drift test: ``it`` one more, the flag cleared, the trial pose
    taken where the step is accepted."""
    (it,) = tr.capture_items([item(scene, STARTS["two"][0])])
    run = tr.LMRun([it], CFG, recaps=CFG.max_recaptures)
    tr.lm_run(run, CFG, CFG.max_iter)
    si = run.si[0].clone()
    assert int(si[tr.SI_PEND]) == 1 and int(si[tr.SI_RECAP]) == 1
    assert 0 < int(si[tr.SI_IT]) < CFG.max_iter
    assert int(si[tr.SI_TRIAL]) == 1 and int(si[tr.SI_EVAL]) == 0
    assert int(si[tr.SI_NBAD]) > 0.01 * int(si[tr.SI_NREL]) > 0
    trial_pose = run.sf[0, tr.SF_RN:tr.SF_RN + 12].clone()
    pose = run.sf[0, tr.SF_R:tr.SF_R + 12].clone()
    w = run.w.clone()
    old_anchor = it.anchor.clone()
    capture_into([(it.tsdf, it.weights, it.points,
                   trial_pose[:9].reshape(3, 3), trial_pose[9:],
                   it.voxel_size, it.cache, it.anchor)])
    assert not torch.equal(it.anchor, old_anchor)
    tr.lm_iteration(run, CFG)
    after = run.si[0]
    assert int(after[tr.SI_PEND]) == 0 and int(after[tr.SI_RECAP]) == 1
    assert int(after[tr.SI_IT]) == int(si[tr.SI_IT]) + 1
    assert int(after[tr.SI_TRIAL]) == 0
    assert torch.equal(run.w, w)
    accepted = bool(after[tr.SI_EVAL])
    assert torch.equal(run.sf[0, tr.SF_R:tr.SF_R + 12],
                       trial_pose if accepted else pose)


def escape_lm(max_recaptures):
    tsdf, wts = escape_volumes()
    return tr.track_volume(
        torch.tensor(tsdf), torch.tensor(wts), ESCAPE_VS,
        torch.tensor(escape_points()), torch.ones(ESCAPE_N), torch.eye(4),
        TrackConfig(tau=1e-6, max_iter=1, sampler="capture",
                    max_recaptures=max_recaptures))


def test_past_its_budget_rejects_the_empty_window_step():
    """Fault F2's scene (``test_torch_lm_escape``): with no re-capture
    budget the first step carries every weighted point 7 voxels out of
    its windows (the JAX capture loop takes it); the new form counts no
    weighted point with a valid ψ there and rejects it, in one read."""
    pose, st = escape_lm(0)
    assert torch.equal(pose, torch.eye(4))
    assert st["recaptures"] == 0 and st["host_reads"] == 1
    assert st["iterations"] == 1 and int(st["dropped_points"]) == 0


def test_within_its_budget_recaptures_and_rejects():
    """With its budget the step is flagged, the windows captured at the
    trial pose (free space there), and the step rejected by its error, as
    the JAX loop and the host loop do: one re-capture, two reads."""
    pose, st = escape_lm(3)
    assert torch.equal(pose, torch.eye(4))
    assert st["recaptures"] == 1 and st["host_reads"] == 2
    assert st["iterations"] == 1
