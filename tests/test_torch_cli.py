"""The port's CLI path against the JAX package's, on the CPU: a TUM-format
sequence generated here (the rigid object scene of
``tests/test_accuracy_gate_objects.py``: 8 frames, 160x120, 16-bit depth
PNGs, replayed ``.plk`` masks on the mask frames 0, 3 and 6) through both
packages' ``apps.run_emfusion.main`` with the same config; their export
trees, pose files, meshes and ``apps.evaluate`` outputs; checkpoints
loaded across the packages; and ``--resume``.

The JAX CLI builds a device mesh when JAX sees more than one device; the
tests' JAX has eight virtual CPU devices, so it is shown one, and runs its
single-device path, as it would on a machine with one CPU device. Both
packages run their default LM sampler (gather on the CPU)."""

import contextlib
import io
import json
import os

import jax
import numpy as np
import pytest
import torch

from emfusion_tpu.apps import evaluate as jax_evaluate
from emfusion_tpu.apps import run_emfusion as jax_cli
from emfusion_tpu.checkpoint import load_checkpoint as jax_load
from emfusion_tpu.config import Params as JaxParams
from emfusion_tpu.config import load_calibration as jax_calibration
from emfusion_tpu.config import load_config as jax_config
from emfusion_tpu.io.readers import TUMReader as JaxTUMReader
from emfusion_tpu.pipeline import EMFusionPipeline as JaxPipeline
from emfusion_tpu.segmentation import ReplayMaskProvider as JaxReplay
from emfusion_tpu_torch.apps import evaluate, preprocess_masks
from emfusion_tpu_torch.apps import run_emfusion
from emfusion_tpu_torch.checkpoint import load_checkpoint
from emfusion_tpu_torch.config import load_calibration, load_config
from emfusion_tpu_torch.eval.ate import load_trajectory
from emfusion_tpu_torch.io.codecs import write_png
from emfusion_tpu_torch.io.readers import TUMReader
from emfusion_tpu_torch.pipeline import EMFusionPipeline
from emfusion_tpu_torch.segmentation import (
    Detection, ReplayMaskProvider, make_score_vector, save_detections,
)
from test_accuracy_gate_objects import _make_sequence

torch.set_num_threads(2)

VOXEL = 2.56 / 128
N = 8
CKPT = 5
CONFIG = """\
[Params]
frameSize = 160 120
globalVolumeDims = 128 128 128
globalVoxelSize = 0.02
volumePose = 0.0 0.0 1.28
objVolumeDims = 32 32 32
maxTrackingIter = 50
raycast_max_steps = 256
max_objects = 4
maskRCNNFrames = 3
visibilityThresh = 60
mask_min_pixels = 60
volPad = 1.0
matchIOUThresh = 0.05
"""
# the export tree of tests/test_pipeline.py::test_export_tree
TREE = ("output", "masks", "assoc_weights/bg/preTrack",
        "assoc_weights/bg/postTrack", "assoc_weights/{oid}/preTrack",
        "assoc_weights/{oid}/postTrack", "track_weights/bg",
        "track_weights/{oid}", "huber_weights/bg", "huber_weights/{oid}",
        "fg_probs/{oid}")


def cam_pose(i):
    th = 0.008 * i
    c, s = np.cos(th), np.sin(th)
    return np.array([[c, 0, s, 0.014 * i], [0, 1, 0, -0.008 * i],
                     [-s, 0, c, 0.004 * i], [0, 0, 0, 1]])


def quat(R):
    from emfusion_tpu_torch.io.writers import _rot_to_quat
    return _rot_to_quat(R)


def write_sequence(root):
    """The rigid scene as a TUM-format directory: rgb/ (depth shaded to
    grey), depth/ (x5000 uint16), associations.txt, groundtruth.txt,
    calibration.txt, a config, and masks/Mask%04d.plk on the mask
    frames."""
    _, frames, masks, _ = _make_sequence(grow=False)
    for sub in ("rgb", "depth", "masks"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    assoc, gt = [], []
    for i, depth in enumerate(frames[:N]):
        ts = f"{1000 + i / 30:.6f}"
        grey = np.clip(255 - depth * 60, 0, 255).astype(np.uint8)
        write_png(os.path.join(root, "rgb", f"{ts}.png"),
                  np.stack([grey] * 3, -1))
        write_png(os.path.join(root, "depth", f"{ts}.png"),
                  np.round(depth * 5000).astype(np.uint16))
        assoc.append(f"{ts} rgb/{ts}.png {ts} depth/{ts}.png\n")
        T = cam_pose(i)
        q = quat(T[:3, :3])
        gt.append(f"{ts} {T[0, 3]} {T[1, 3]} {T[2, 3]} "
                  f"{q[0]} {q[1]} {q[2]} {q[3]}\n")
        if i % 3 == 0:
            save_detections(os.path.join(root, "masks", f"Mask{i:04d}.plk"),
                            [Detection(mask=masks[i],
                                       scores=make_score_vector(3, 0.9))])
    for name, lines in (("associations.txt", assoc),
                        ("groundtruth.txt", gt),
                        ("calibration.txt", ["130.0 130.0 79.5 59.5\n"]),
                        ("config.cfg", [CONFIG])):
        with open(os.path.join(root, name), "w") as f:
            f.writelines(lines)
    return frames[:N]


def args(seq, out, *more):
    return ["-t", seq, "-e", out, "-m", os.path.join(seq, "masks"),
            "-c", os.path.join(seq, "config.cfg"), *more]


@contextlib.contextmanager
def one_jax_device():
    real = jax.devices
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "devices", lambda *a, **k: real(*a, **k)[:1])
        mp.delenv("EMF_TRACK_SAMPLER", raising=False)
        yield


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both CLIs over the sequence, each writing a checkpoint after frame
    4 (``--checkpoint-every 5``) and per-frame meshes every 4 frames
    (``frame_meshes/``); the port's run resumed from its checkpoint into
    another export directory."""
    root = tmp_path_factory.mktemp("cli")
    seq = str(root / "seq")
    frames = write_sequence(seq)
    out = {k: str(root / k) for k in ("jax", "port", "resumed")}
    ck = {k: str(root / f"{k}.npz") for k in ("jax", "port")}
    with one_jax_device():
        assert jax_cli.main(args(seq, out["jax"], "--platform", "cpu",
                                 "--checkpoint", ck["jax"],
                                 "--checkpoint-every", str(CKPT),
                                 "--frame-meshes", "4")) == 0
    assert run_emfusion.main(args(seq, out["port"], "--device", "cpu",
                                  "--checkpoint", ck["port"],
                                  "--checkpoint-every", str(CKPT),
                                  "--frame-meshes", "4")) == 0
    resumed_ck = str(root / "resumed.npz")
    with open(ck["port"], "rb") as a, open(resumed_ck, "wb") as b:
        b.write(a.read())
    assert run_emfusion.main(args(seq, out["resumed"], "--device", "cpu",
                                  "--checkpoint", resumed_ck,
                                  "--resume")) == 0
    return dict(seq=seq, out=out, ck=ck, frames=frames)


def tree(path):
    return sorted(os.path.relpath(os.path.join(d, s), path)
                  for d, subs, _ in os.walk(path) for s in subs)


def object_ids(path):
    return sorted(int(f[len("poses-"):-len(".txt")]) for f in os.listdir(path)
                  if f.startswith("poses-") and f[6:-4].isdigit())


def test_export_tree_matches_jax(runs):
    """The same directories (the tree of ``test_export_tree``, each with
    files, and ``frame_meshes/``) and the same object ids and files in
    each."""
    jax_out, port_out = runs["out"]["jax"], runs["out"]["port"]
    assert tree(port_out) == tree(jax_out)
    ids = object_ids(port_out)
    assert ids == object_ids(jax_out) == [1]
    for sub in TREE + ("frame_meshes",):
        d = os.path.join(port_out, sub.format(oid=ids[0]))
        assert os.path.isdir(d) and os.listdir(d), sub
    assert sorted(os.listdir(os.path.join(port_out, "frame_meshes"))) == [
        "mesh_1_0004.ply", "mesh_1_0008.ply", "mesh_bg_0004.ply",
        "mesh_bg_0008.ply"]
    assert sorted(os.listdir(port_out)) == sorted(os.listdir(jax_out))
    for sub in tree(jax_out):
        assert sorted(os.listdir(os.path.join(port_out, sub))) == \
            sorted(os.listdir(os.path.join(jax_out, sub))), sub


@pytest.mark.parametrize("name", ["poses-cam.txt", "poses-1.txt",
                                  "poses-1-corrected.txt"])
def test_pose_files_match_jax(runs, name):
    """The same timestamps; positions within 0.1 voxel (background voxel
    for the camera, the object's own for the object)."""
    a = load_trajectory(os.path.join(runs["out"]["port"], name))
    b = load_trajectory(os.path.join(runs["out"]["jax"], name))
    assert sorted(a) == sorted(b) and len(a) >= 3
    vs = VOXEL
    if name != "poses-cam.txt":
        with np.load(runs["ck"]["jax"]) as z:
            vs = float(z["objs.voxel_size"][z["objs.active"]][0])
    for s in b:
        assert np.linalg.norm(a[s][:3, 3] - b[s][:3, 3]) < 0.1 * vs, s


def run_evaluate(module, out, seq):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert module.main([out, os.path.join(seq, "groundtruth.txt"),
                            "--json"]) == 0
    return json.loads(buf.getvalue())


def test_evaluate_matches_jax(runs):
    """Both evaluators on both export trees: on the same files they print
    the same numbers; the two trees' camera ATE agree within 0.1 voxel and
    lie under a voxel."""
    seq = runs["seq"]
    for out in runs["out"]["port"], runs["out"]["jax"]:
        assert run_evaluate(evaluate, out, seq) == \
            run_evaluate(jax_evaluate, out, seq)
    a = run_evaluate(evaluate, runs["out"]["port"], seq)["camera"]
    b = run_evaluate(evaluate, runs["out"]["jax"], seq)["camera"]
    assert a["pairs"] == b["pairs"] == N
    assert abs(a["ate_rmse"] - b["ate_rmse"]) < 0.1 * VOXEL
    assert a["ate_rmse"] < VOXEL


def read_ply(path):
    with open(path) as f:
        head = []
        while True:
            line = f.readline()
            head.append(line)
            if line.startswith("end_header"):
                break
        nv = int([h for h in head if h.startswith("element vertex")][0]
                 .split()[-1])
        data = np.loadtxt(f, max_rows=nv, ndmin=2) if nv else \
            np.zeros((0, 6))
    return data


def test_background_mesh_matches_jax(runs):
    """``mesh_bg.ply`` of both CLIs. The two packages' volumes agree to
    ~3e-5 except at ~0.1% of the voxels, those whose centre projects
    within rounding of a pixel boundary, where the poses' last bits pick
    the neighbouring pixel (``test_torch_pipeline``'s carry-over test);
    there they differ by up to ~0.1 (measured at frame 5 of this run:
    212 of 206782 observed voxels above 1e-3). Every cube with such a
    corner moves its vertices by up to a third of a voxel, and a sign
    flip adds or drops its vertices: ~1-2% of the vertices. So: vertex
    counts within 0.2% of each other, 97% of each mesh's vertices within
    1e-4 m of the other's nearest one, and every vertex within one voxel
    of it. (On one volume the two packages' meshes are equal:
    ``test_torch_mesh``.)"""
    from scipy.spatial import cKDTree
    a = read_ply(os.path.join(runs["out"]["port"], "mesh_bg.ply"))[:, :3]
    b = read_ply(os.path.join(runs["out"]["jax"], "mesh_bg.ply"))[:, :3]
    assert len(b) > 1000
    assert abs(len(a) - len(b)) <= 0.002 * len(b)
    for x, y in ((a, b), (b, a)):
        d, _ = cKDTree(y).query(x)
        assert np.mean(d <= 1e-4) >= 0.97
        assert d.max() < VOXEL


def jax_params(seq):
    p = jax_config(os.path.join(seq, "config.cfg"), JaxParams())
    return jax_calibration(os.path.join(seq, "calibration.txt"), p)


def port_params(seq):
    p = load_config(os.path.join(seq, "config.cfg"))
    return load_calibration(os.path.join(seq, "calibration.txt"), p)


def next_frame(seq):
    """The frame after the checkpoint, as the readers give it."""
    r = TUMReader(seq)
    r.init()
    try:
        return r._read_frame(CKPT)
    finally:
        r.close()


def check_frame(a_cam, b_cam, a_obj, b_obj, vs):
    assert np.linalg.norm(a_cam[:3, 3] - b_cam[:3, 3]) < 0.1 * VOXEL
    assert np.linalg.norm(a_obj[:3, 3] - b_obj[:3, 3]) < 0.1 * vs


def test_jax_checkpoint_continues_in_the_port(runs):
    """The JAX CLI's checkpoint after frame 4, loaded into the port: the
    port's frame 5 gives the JAX run's frame 5 camera and object poses
    within 0.1 voxel, and the trajectories up to it."""
    seq = runs["seq"]
    pipe = EMFusionPipeline(port_params(seq),
                            ReplayMaskProvider(os.path.join(seq, "masks")),
                            device="cpu")
    load_checkpoint(pipe, runs["ck"]["jax"])
    assert pipe.frame == CKPT and pipe.active_object_ids == [1]
    f = next_frame(seq)
    pipe.process_frame(f.rgb, f.depth, timestamp=f.timestamp)
    cam = load_trajectory(os.path.join(runs["out"]["jax"], "poses-cam.txt"))
    obj = load_trajectory(os.path.join(runs["out"]["jax"], "poses-1.txt"))
    vs = float(pipe.state.objs.voxel_size[pipe._slot_of(1)])
    check_frame(pipe.poses[CKPT], cam[f.timestamp],
                pipe.obj_poses[1][CKPT], obj[f.timestamp], vs)
    assert sorted(pipe.poses) == list(range(CKPT + 1))


def test_port_checkpoint_continues_in_jax(runs):
    """The port CLI's checkpoint after frame 4, loaded into the JAX
    pipeline (its object gradients and arrays in the JAX shapes): the JAX
    frame 5 gives the port run's frame 5 poses within 0.1 voxel."""
    seq = runs["seq"]
    with one_jax_device():
        jpipe = JaxPipeline(jax_params(seq),
                            JaxReplay(os.path.join(seq, "masks")))
    jax_load(jpipe, runs["ck"]["port"])
    assert jpipe.frame == CKPT and jpipe.active_object_ids == [1]
    r = JaxTUMReader(seq)
    r.init()
    try:
        f = r._read_frame(CKPT)
    finally:
        r.close()
    jpipe.process_frame(f.rgb, f.depth, timestamp=f.timestamp)
    jpipe.flush()
    cam = load_trajectory(os.path.join(runs["out"]["port"], "poses-cam.txt"))
    obj = load_trajectory(os.path.join(runs["out"]["port"], "poses-1.txt"))
    vs = float(np.asarray(jpipe.state.objs.voxel_size)[jpipe._slot_of(1)])
    check_frame(jpipe.poses[CKPT], cam[f.timestamp],
                jpipe.obj_poses[1][CKPT], obj[f.timestamp], vs)


def test_resume_reproduces_the_uninterrupted_run(runs):
    """``--resume`` from the checkpoint after frame 4 runs frames 5-7:
    every pose file equals the uninterrupted run's to 1e-5 m, and so does
    the background mesh."""
    for name in ("poses-cam.txt", "poses-1.txt", "poses-1-corrected.txt"):
        a = load_trajectory(os.path.join(runs["out"]["resumed"], name))
        b = load_trajectory(os.path.join(runs["out"]["port"], name))
        assert sorted(a) == sorted(b)
        for s in b:
            assert np.abs(a[s][:3, 3] - b[s][:3, 3]).max() <= 1e-5, (name, s)
    a = read_ply(os.path.join(runs["out"]["resumed"], "mesh_bg.ply"))
    b = read_ply(os.path.join(runs["out"]["port"], "mesh_bg.ply"))
    assert a.shape == b.shape
    assert np.abs(a[:, :3] - b[:, :3]).max() <= 1e-5


def test_device_defaults_to_cuda(tmp_path):
    """Without ``--device`` the CLIs ask for the card and raise here, the
    viewer's flag too; ``--turntable`` on the CPU runs (an empty sequence
    without ``--exportdir`` renders nothing)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    seq = str(tmp_path / "seq")
    os.makedirs(seq)
    with open(os.path.join(seq, "associations.txt"), "w"):
        pass
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_emfusion.main(["-t", seq])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        preprocess_masks.main(["-t", seq, "-o", str(tmp_path / "m"),
                               "--model", str(tmp_path / "det.pt")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_emfusion.main(["-t", seq, "--serve", "8000"])
    assert run_emfusion.main(["-t", seq, "--turntable", "4",
                              "--device", "cpu"]) == 0


def test_preprocess_masks_matches_jax(runs, tmp_path):
    """The port's mask preprocessing with ``--device cpu`` writes the
    JAX CLI's ``.plk`` files: the same frames, masks and score rows."""
    from emfusion_tpu.apps.preprocess_masks import main as jax_main
    from test_segmentation_providers import FakeDetector
    model = str(tmp_path / "det.pt")
    torch.jit.script(FakeDetector()).save(model)
    out = {k: str(tmp_path / k) for k in ("jax", "port")}
    common = ["-t", runs["seq"], "--model", model, "--every", "4",
              "--score-thresh", "0.5"]
    assert jax_main(common + ["-o", out["jax"]]) == 0
    assert preprocess_masks.main(common + ["-o", out["port"],
                                           "--device", "cpu"]) == 0
    assert sorted(os.listdir(out["port"])) == sorted(os.listdir(out["jax"])) \
        == ["Mask0000.plk", "Mask0004.plk"]
    for i in (0, 4):
        got = ReplayMaskProvider(out["port"]).detect(None, i)
        want = ReplayMaskProvider(out["jax"]).detect(None, i)
        assert len(got) == len(want) == 1
        np.testing.assert_array_equal(got[0].mask, want[0].mask)
        np.testing.assert_array_equal(got[0].scores, want[0].scores)


def test_fit_frame_size_scales_the_intrinsics():
    """The data's frame size (half the config's) scales fx, fy by 0.5 and
    moves the principal point with the pixel centres; the same size
    keeps the params. (The JAX CLI keeps the config's intrinsics.)"""
    from emfusion_tpu_torch.config import Params, fit_frame_size
    p = Params()                                   # 640x480, 525, 319.5
    q = fit_frame_size(p, 320, 240)
    assert q.frameSize == (320, 240)
    assert (q.fx, q.fy, q.cx, q.cy) == (262.5, 262.5, 159.5, 119.5)
    assert fit_frame_size(p, 640, 480) is p


def test_prefetch_depth_is_taken_only_by_its_frame():
    """A prefetched depth is used by the frame that passes the same array
    and by no other; every frame clears the buffer, used or not (the JAX
    pipeline keeps a missed upload, ``pipeline.py:1068-1073``). Both runs
    give the poses of a run without prefetching."""
    from emfusion_tpu_torch.config import Params
    from test_torch_package import SMALL
    from test_torch_pipeline import sequence
    frames, _ = sequence()
    frames = [f[::2, ::2].copy() for f in frames[:3]]
    params = Params(**SMALL, volumePose=(0.0, 0.0, 1.28))
    plain = EMFusionPipeline(params, device="cpu")
    for d in frames:
        plain.process_frame(None, d)
    pipe = EMFusionPipeline(params, device="cpu")
    pipe.prefetch_depth(frames[1])
    pipe.process_frame(None, frames[0])        # a miss: dropped
    assert pipe._prefetched is None
    for d in frames[1:]:
        pipe.prefetch_depth(d)
        pipe.process_frame(None, d)            # a hit
        assert pipe._prefetched is None
    for f in plain.poses:
        np.testing.assert_array_equal(pipe.poses[f], plain.poses[f])


def test_phase_timer_summary_matches_jax():
    """``PhaseTimer.summary()`` prints the JAX timer's lines; the event
    mode on a CPU device times by the host clock."""
    from emfusion_tpu.profiling import PhaseTimer as JaxTimer
    from emfusion_tpu_torch.profiling import PhaseTimer
    a, b = PhaseTimer("cpu", mode="events"), JaxTimer(fence=False)
    for t in (a, b):
        t.totals.update(track_camera=1.5, integrate=0.25)
        t.counts.update(track_camera=10, integrate=11)
    assert a.summary() == b.summary()
    with a.phase("raycast"):
        pass
    assert a.counts["raycast"] == 1 and a.totals["raycast"] >= 0
    with pytest.raises(ValueError):
        PhaseTimer("cpu", mode="fenced")
