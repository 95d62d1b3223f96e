"""The port's CLI with ``--nprocs 2 --device cpu`` (the sharded pipeline
on a (1, 2) mesh of gloo ranks: each fuses half of the background's
planes, rank 0 writes) against the one-process CLI, on the 8-frame TUM
sequence of ``tests/test_torch_cli.py`` (the rigid object scene with
``.plk`` masks at frames 0, 3 and 6): the same export tree, byte for
byte (pose files, the sharded background mesh, the object mesh, every
image, the three ``--turntable`` views, which every rank renders
together), and the same checkpoint arrays.

Both runs take one intra-op thread per process (``OMP_NUM_THREADS=1``
for the ranks): PyTorch's CPU reductions split their sums by thread.
"""

import os

import numpy as np
import pytest
import torch

from emfusion_tpu_torch.apps import run_emfusion
from test_torch_cli import write_sequence


def tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_dist")
    seq = str(root / "seq")
    write_sequence(seq)
    out = {}
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for name, extra in (("one", []), ("two", ["--nprocs", "2"])):
            o = str(root / name)
            argv = ["-t", seq, "-e", o, "-m", os.path.join(seq, "masks"),
                    "-c", os.path.join(seq, "config.cfg"), "--device",
                    "cpu", "--checkpoint", str(root / f"{name}.npz"),
                    "--checkpoint-every", "8", "--turntable", "3"] + extra
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("OMP_NUM_THREADS", "1")
                assert run_emfusion.main(argv) == 0
            out[name] = (o, str(root / f"{name}.npz"))
    finally:
        torch.set_num_threads(n)
    return out


def test_export_tree_is_the_one_process_tree(runs):
    a, b = tree(runs["one"][0]), tree(runs["two"][0])
    assert sorted(a) == sorted(b)
    assert "mesh_bg.ply" in a and "mesh_1.ply" in a and "poses-1.txt" in a
    assert [k for k in sorted(a) if k.startswith("turntable")] == [
        os.path.join("turntable", f"view{i:03d}.png") for i in range(3)]
    assert len(a["mesh_bg.ply"]) > 10000
    differ = [k for k in a if a[k] != b[k]]
    assert not differ, differ


def test_checkpoint_is_the_one_process_checkpoint(runs):
    with np.load(runs["one"][1]) as x, np.load(runs["two"][1]) as y:
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            assert np.array_equal(x[k], y[k]), k

