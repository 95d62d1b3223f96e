"""The port's live viewer on a sharded run: ``apps.run_emfusion --serve``
on two gloo ranks (a (1, 2) mesh: each rank fuses half of the
background's planes and holds every slot), against the one-process CLI,
on the 8-frame TUM sequence of ``tests/test_torch_cli.py``.

Rank 0 holds the viewer; an orbit view and the meshes need every rank
(the view's raycast gathers the ranks' nearest object surfaces, the
background's marching cubes runs over the z-slabs), so their requests
wait for the service step that all ranks run between frames. The test
pins a frame: a ``ViewerProbe`` (``tests/torch_dist_workers.py``) wraps
that step, GETs every endpoint at the frame, waits until the requests
are queued and then lets the step answer them, so every answer is of
that frame in both runs. The two-rank run goes through the CLI's
``torchrun`` entry (``WORLD_SIZE`` > 1) and through ``--nprocs``'s rank
body; ``tests/test_torch_distributed_cli.py`` runs ``--nprocs 2
--turntable 3`` itself.

Both runs take one intra-op thread per process (``OMP_NUM_THREADS=1``):
PyTorch's CPU reductions split their sums by thread.
"""

import glob
import json
import os
import pickle
import subprocess
import sys

import pytest
import torch

import torch_dist_workers as W
from emfusion_tpu_torch.apps import run_emfusion
from emfusion_tpu_torch.distributed.mesh import free_port, launch
from test_torch_cli import write_sequence

AT = 2          # the pinned frame, the last (frames 0-1 run; object 1 live)
TIMEOUT_S = 300


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("viewer_dist")
    seq = str(root / "seq")
    write_sequence(seq)

    def argv(name):
        return ["-t", seq, "-m", os.path.join(seq, "masks"), "-c",
                os.path.join(seq, "config.cfg"), "--device", "cpu",
                "--frames", str(AT), "--serve", str(free_port())]

    out = {}
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    probe = W.ViewerProbe(AT)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("OMP_NUM_THREADS", "1")
            out["one"] = probe.result(run_emfusion.main(argv("one")))
            probe.restore()
            out["nprocs"] = launch("torch_dist_workers:viewer_rank", 2,
                                   args=(argv("nprocs"), AT), device="cpu",
                                   threads=1, timeout_s=TIMEOUT_S)
            res = str(root / "torchrun")
            env = dict(os.environ, PYTHONPATH=os.pathsep.join(
                [p for p in sys.path if p]))
            subprocess.run(
                [sys.executable, "-m", "torch.distributed.run",
                 "--standalone", "--nproc-per-node", "2",
                 W.__file__, res, str(AT)] + argv("torchrun"),
                env=env, check=True, timeout=TIMEOUT_S,
                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
            out["torchrun"] = []
            for f in sorted(glob.glob(res + ".rank*")):
                with open(f, "rb") as fh:
                    out["torchrun"].append(pickle.load(fh))
    finally:
        probe.restore()
        torch.set_num_threads(n)
    return out


@pytest.mark.parametrize("how", ["nprocs", "torchrun"])
def test_endpoints_are_the_one_process_answers(runs, how):
    """At the pinned frame, ``/frame.png``, ``/status``, ``/view.png``,
    ``/mesh.bin`` and ``/mesh.ply`` of rank 0 are byte-equal to the
    one-process viewer's; the status shows the live object and the frame,
    so the ids and the camera pose on rank 0 are the whole run's."""
    one = runs["one"]["answers"]
    rank0 = runs[how][0]["answers"]
    assert sorted(one) == sorted(rank0) == sorted(W.VIEW_PATHS)
    for path in W.VIEW_PATHS:
        assert one[path][0] == 200, path
        assert rank0[path] == one[path], path
    status = json.loads(one["/status"][1])
    assert status["frame"] == AT and status["objects"] == [1]
    assert len(one["/mesh.bin"][1]) > 10000


@pytest.mark.parametrize("how", ["nprocs", "torchrun"])
def test_a_live_slot_is_held_beyond_rank_0(runs, how):
    """The pinned frame's live object's slot is held by rank 1 too, so
    its raycast and mesh are the sharded run's; both ranks exited 0."""
    ranks = runs[how]
    assert len(ranks) == 2 and [r["code"] for r in ranks] == [0, 0]
    assert ranks[1]["owned"], ranks[1]
    assert ranks[0]["owned"] == ranks[1]["owned"] == runs["one"]["owned"]


def test_a_request_after_the_last_frame_gets_an_answer(runs):
    """A view asked for after the run's last service step: the one-process
    viewer answers it; a sharded run's waits for no further step, and its
    viewer's closing answers it with a 503; every run exited 0 within the
    test's time limit (the launcher's and ``subprocess``'s)."""
    assert runs["one"]["late"][0] == 200
    assert runs["one"]["code"] == 0
    for how in ("nprocs", "torchrun"):
        assert runs[how][0]["late"] == (503, b"viewer closed"), how
        assert runs[how][1]["late"] is None
