"""The port's viewers on the CPU: the orbit view (``viz.render_orbit_view``:
the pipeline's raycast composite from a virtual camera outside the
volume, and its Phong shading) against the JAX package's on a carried
state, the widget lines against PIL's, the JPEG encoder against PIL's
decoder, every endpoint of ``viz_server.LiveViewer`` (mirroring
``tests/test_viz_server.py``), a render running concurrently with the
frame loop, and ``apps.run_emfusion --turntable``."""

import dataclasses
import io
import json
import os
import struct
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from emfusion_tpu.config import Params as JaxParams
from emfusion_tpu.pipeline import EMFusionPipeline as JaxPipeline
from emfusion_tpu.segmentation import CallableMaskProvider as JaxProvider
from emfusion_tpu.segmentation import Detection as JaxDetection
from emfusion_tpu.viz import render_orbit_view as jax_orbit_view
from emfusion_tpu_torch.apps import run_emfusion
from emfusion_tpu_torch.config import Params
from emfusion_tpu_torch.io.codecs import decode_png, encode_jpeg
from emfusion_tpu_torch.ops.raycast import _gradient_sample
from emfusion_tpu_torch.pipeline import (
    EMFusionPipeline, ObjectMeta, state_from_numpy,
)
from emfusion_tpu_torch.segmentation import make_score_vector
from emfusion_tpu_torch.viz import draw_line, orbit_pose, render_orbit_view
from emfusion_tpu_torch.viz_server import LiveViewer
from synthetic import SyntheticScene
from test_torch_accel_config import rigid_provider
from test_torch_cli import write_sequence
from test_torch_pipeline import EXACT
from test_torch_pipeline_objects import jax_arrays

torch.set_num_threads(2)

H, W, RES = 48, 64, 48
VOXEL = 2.56 / RES
# the JAX exact path at 64x48 and 48^3, one object slot of 16^3 in use
CFG = dict(frameSize=(W, H), fx=52.0, fy=52.0, cx=31.5, cy=23.5,
           globalVolumeDims=(RES,) * 3, globalVoxelSize=VOXEL,
           volumePose=(0.0, 0.0, 1.28), objVolumeDims=(16, 16, 16),
           maxTrackingIter=30, raycast_max_steps=256, max_objects=2,
           maskRCNNFrames=3, visibilityThresh=15, mask_min_pixels=15,
           boundary=4, volPad=1.0, matchIOUThresh=0.05, **EXACT)
# (yaw, pitch, radius) of orbit cameras on the side the scene was seen
# from, outside the volume: at the default radius (1.1 x its extent) and
# closer
VIEWS = ((2.6, -0.25, None), (3.5, -0.3, 1.8))


def sequence(n=4):
    """The rigid scene of ``tests/test_accuracy_gate_objects.py`` at 64x48
    (a sphere moving 5 mm a frame), its masks."""
    scene = SyntheticScene(
        H=H, W=W, f=52.0, floor_y=0.75,
        bg_spheres=((np.array([-0.45, 0.05, 1.3]), 0.35),
                    (np.array([0.5, -0.3, 1.5]), 0.3)),
        obj_sphere_r=0.12)
    frames, masks = [], {}
    for i in range(n):
        th = 0.008 * i
        c, s = np.cos(th), np.sin(th)
        cam = np.array([[c, 0, s, 0.014 * i], [0, 1, 0, -0.008 * i],
                        [-s, 0, c, 0.004 * i], [0, 0, 0, 1]], np.float32)
        depth, masks[i] = scene.render(cam, np.array([0.08 + 0.005 * i,
                                                      0.12, 1.05]))
        frames.append(depth)
    return frames, masks


@pytest.fixture(scope="module")
def carried():
    """The JAX pipeline after frames 0-2 (an object spawned at frame 0),
    and the port pipeline continuing from its state."""
    frames, masks = sequence()

    def provider(rgb, f):
        return [JaxDetection(mask=masks[f], scores=make_score_vector(3, 0.9))
                ] if f % 3 == 0 else []

    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("EMF_TRACK_SAMPLER", raising=False)
        jpipe = JaxPipeline(JaxParams(**CFG), JaxProvider(provider))
    for f in range(3):
        jpipe.process_frame(None, frames[f], timestamp=float(f))
    jpipe.flush()
    assert len(jpipe.active_object_ids) == 1
    pipe = EMFusionPipeline(Params(**CFG), rigid_provider(masks),
                            device="cpu")
    pipe.load_state(state_from_numpy(jax_arrays(jpipe), device="cpu"),
                    frame=3,
                    meta={i: ObjectMeta(**dataclasses.asdict(m))
                          for i, m in jpipe.meta.items()},
                    next_id=jpipe._next_id, poses=dict(jpipe.poses))
    return dict(jax=jpipe, port=pipe, frames=frames)


@pytest.mark.parametrize("view", VIEWS)
def test_orbit_view_matches_jax(carried, view):
    """From an orbit camera outside the volume (rays enter through the
    slab test, many miss the box):
    * the background raycast (K4's plain version) against the JAX
      ``raycast_volume`` at that pose, with ``tests/test_torch_raycast.py``'s
      tolerances and reasons: hit masks exactly, raylengths and vertices
      within 1e-5, normals within 1e-4, and 3e-6 / |∇ψ| where the TSDF
      changes by less than 0.03 a voxel (its reason: a 1e-6 shift of t*
      turns a normal by ~1e-4 at 0.03);
    * the composite (background and the object) against the JAX
      pipeline's jitted ``_raycast_subset`` at the same virtual pose:
      segmentation and object masks exactly, vertices and background
      raylengths within 1e-5;
    * the Phong image of ``render_orbit_view(..., with_widgets=False)``
      against the JAX ``render_orbit_view``'s within one grey level on at
      least 99% of the pixels."""
    import jax.numpy as jnp
    from emfusion_tpu.ops.fusion import compute_gradients
    from emfusion_tpu.ops.raycast import raycast_volume as jax_raycast
    from emfusion_tpu_torch.ops.raycast import raycast_volume
    jpipe, pipe = carried["jax"], carried["port"]
    yaw, pitch, radius = view
    pose = orbit_pose(pipe, yaw, pitch, radius)
    s = pipe.state
    rel = (np.linalg.inv(s.bg_pose.numpy()) @ pose).astype(np.float32)
    R, t = rel[:3, :3].copy(), rel[:3, 3].copy()
    intr = np.asarray(pipe.params.intr, np.float32)
    trunc = pipe.params.global_truncdist
    tsdf = s.bg_tsdf.numpy()
    bref = jax_raycast(jnp.asarray(tsdf), compute_gradients(jnp.asarray(tsdf)),
                       jnp.asarray(s.bg_weights.numpy()), jnp.asarray(R),
                       jnp.asarray(t), jnp.asarray(intr), VOXEL, trunc, H, W,
                       max_steps=256)
    bg = raycast_volume(s.bg_tsdf, s.bg_weights, torch.from_numpy(R),
                        torch.from_numpy(t), torch.from_numpy(intr), VOXEL,
                        trunc, H, W, max_steps=256)
    mask = np.asarray(bref["mask"])
    np.testing.assert_array_equal(bg["mask"].numpy(), mask)
    assert 0.1 < mask.mean() < 0.9                     # hits and misses
    for key in ("raylengths", "vertices"):
        np.testing.assert_allclose(bg[key].numpy(), np.asarray(bref[key]),
                                   rtol=0, atol=1e-5, err_msg=key)
    v = (torch.from_numpy(R) @ bg["vertices"].reshape(3, -1)
         + torch.from_numpy(t)[:, None]) / VOXEL + (RES - 1) / 2.0
    g = _gradient_sample(s.bg_tsdf, v[0], v[1], v[2],
                         bg["mask"].reshape(-1))
    gn = torch.linalg.vector_norm(g, dim=0).reshape(H, W).numpy()
    tol = np.maximum(1e-4, 3e-6 / np.maximum(gn, 1e-12))
    err = np.abs(bg["normals"].numpy() - np.asarray(bref["normals"])).max(0)
    assert (err <= tol).all(), err.max()

    slots = [int(k) for k in np.nonzero(pipe._h_active)[0]]
    rc = pipe.raycast(slots, cam_pose=torch.from_numpy(pose))
    _, ref = jpipe._raycast_subset(
        jpipe.state.replace(cam_pose=jnp.asarray(pose)),
        jnp.asarray(slots, jnp.int32), bg_axis=jpipe._bg_scan_axis())
    ref = {k: np.asarray(val) for k, val in ref.items()}
    seg = rc["seg"].numpy()
    np.testing.assert_array_equal(seg, ref["seg"])
    np.testing.assert_array_equal(rc["obj_masks"].numpy(), ref["obj_masks"])
    assert (seg > 0).sum() >= 4                      # the object is seen
    for key in ("vertices", "bg_raylengths"):
        np.testing.assert_allclose(rc[key].numpy(), ref[key], rtol=0,
                                   atol=1e-5, err_msg=key)
    img = render_orbit_view(pipe, yaw, pitch, radius, with_widgets=False)
    jimg = jax_orbit_view(jpipe, yaw, pitch, radius, with_widgets=False)
    assert img.shape == jimg.shape == (H, W, 3) and img.dtype == np.uint8
    off = np.abs(img.astype(int) - jimg.astype(int)).max(-1)
    assert (off <= 1).mean() >= 0.99, (off > 1).sum()
    assert (img.max(-1) > 0).mean() > 0.1


def near(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Where mask ``a`` lies within one pixel (8-neighbourhood) of mask
    ``b``."""
    bb = np.pad(b, 1)
    grown = np.zeros_like(b)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            grown |= bb[1 + dy:1 + dy + b.shape[0], 1 + dx:1 + dx + b.shape[1]]
    return ~a | grown


def test_lines_match_pil():
    """``draw_line`` against PIL's ``ImageDraw.line`` (width 1) on random
    segments, many reaching far beyond the image: every pixel the port
    draws lies within one pixel of one that PIL draws, and PIL's too of
    the port's. Then the widgets of an orbit view: every pixel the port's
    box and frustum lines change lies within one pixel of one that PIL's
    lines of the JAX render change."""
    Image = pytest.importorskip("PIL.Image")
    ImageDraw = pytest.importorskip("PIL.ImageDraw")
    rng = np.random.RandomState(0)
    for _ in range(200):
        p0 = rng.uniform(-60, 120, 2)
        p1 = rng.uniform(-60, 120, 2) if rng.rand() < 0.8 else \
            rng.uniform(-5e4, 5e4, 2)
        mine = np.zeros((H, W, 3), np.uint8)
        draw_line(mine, p0, p1, (255, 255, 0))
        pil = Image.new("RGB", (W, H))
        ImageDraw.Draw(pil).line([tuple(p0), tuple(p1)], fill=(255, 255, 0),
                                 width=1)
        a, b = mine.any(-1), np.asarray(pil).any(-1)
        assert near(a, b).all() and near(b, a).all(), (p0, p1)


def test_widgets_match_jax(carried):
    """The box and frustum widgets of an orbit view against the JAX
    render's (PIL's lines): every pixel that the port's widgets change
    lies within one pixel of one that the JAX widgets change."""
    pytest.importorskip("PIL.ImageDraw")
    jpipe, pipe = carried["jax"], carried["port"]
    yaw, pitch, radius = VIEWS[1]
    port = [render_orbit_view(pipe, yaw, pitch, radius, with_widgets=w)
            for w in (False, True)]
    ref = [jax_orbit_view(jpipe, yaw, pitch, radius, with_widgets=w)
           for w in (False, True)]
    mine = (port[0] != port[1]).any(-1)
    theirs = (ref[0] != ref[1]).any(-1)
    assert mine.sum() > 20
    assert near(mine, theirs).all()


def test_encode_jpeg_decodes_in_pil(carried):
    """``encode_jpeg`` (quality 85) of an orbit view, of a smooth colour
    field of a size that is no multiple of 8, and of a grey image,
    decoded by PIL: the same size and at least 30 dB PSNR."""
    Image = pytest.importorskip("PIL.Image")
    yy, xx = np.mgrid[0:61, 0:77]
    field = np.stack([(xx * 3) % 256, (yy * 4) % 256,
                      128 + 100 * np.sin(xx / 9.0) * np.cos(yy / 7.0)],
                     -1).astype(np.uint8)
    view = render_orbit_view(carried["port"], *VIEWS[0])
    for img in (view, field, field[..., 1]):
        dec = np.asarray(Image.open(io.BytesIO(encode_jpeg(img))))
        assert dec.shape == img.shape
        mse = np.mean((dec.astype(np.float64) - img) ** 2)
        assert 10 * np.log10(255.0 ** 2 / max(mse, 1e-12)) >= 30.0


def _get(port, path, timeout=60):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=timeout) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def read_part(stream) -> bytes:
    """One part of the MJPEG multipart stream."""
    assert stream.readline() == b"--emf\r\n"
    assert stream.readline() == b"Content-Type: image/jpeg\r\n"
    n = int(stream.readline().split(b":")[1])
    assert stream.readline() == b"\r\n"
    data = stream.read(n)
    assert stream.readline() == b"\r\n"
    return data


def test_live_viewer_endpoints(carried):
    """``LiveViewer`` on 127.0.0.1 and a free port over a CPU pipeline:
    every endpoint answers (``tests/test_viz_server.py``'s checks):
    the page, ``/frame.png`` (decoded by the port's decoder), a lit
    ``/view.png``, two parts of ``/stream`` (JPEG), ``/scene``, a
    ``/mesh.bin`` that parses (the background in the world frame, and the
    object), a ``/mesh.ply``, ``/status`` as JSON, and 404 elsewhere."""
    pipe = carried["port"]
    viewer = LiveViewer(pipe, port=0, host="127.0.0.1")
    try:
        frame = render_orbit_view(pipe, *VIEWS[0])
        viewer.publish(frame)
        st, ct, body = _get(viewer.port, "/")
        assert st == 200 and "text/html" in ct
        assert b"emfusion-tpu live" in body
        st, ct, body = _get(viewer.port, "/frame.png")
        assert st == 200 and ct == "image/png"
        np.testing.assert_array_equal(decode_png(body), frame)
        st, ct, body = _get(viewer.port,
                            "/view.png?yaw=2.6&pitch=-0.3&dist=0.9")
        assert st == 200 and ct == "image/png"
        img = decode_png(body)
        assert img.shape == (H, W, 3)
        assert (img > 0).any(), "orbit view rendered nothing"
        with urllib.request.urlopen(
                f"http://127.0.0.1:{viewer.port}/stream", timeout=60) as r:
            assert r.headers.get("Content-Type").startswith(
                "multipart/x-mixed-replace")
            first = read_part(r)
            viewer.publish()
            second = read_part(r)
        for part in (first, second):
            assert part[:2] == b"\xff\xd8" and part[-2:] == b"\xff\xd9"
        st, ct, body = _get(viewer.port, "/scene")
        assert st == 200 and b"webgl" in body.lower()
        st, ct, body = _get(viewer.port, "/mesh.bin")
        assert st == 200
        nm = struct.unpack_from("<I", body, 0)[0]
        assert nm == 2                          # background + the object
        off, sizes = 4, []
        for _ in range(nm):
            nv, nt = struct.unpack_from("<II", body, off)
            verts = np.frombuffer(body, "<f4", nv * 3, off + 8).reshape(-1, 3)
            tris = np.frombuffer(body, "<u4", nt * 3,
                                 off + 8 + nv * 24).reshape(-1, 3)
            assert nv > 10 and nt > 10 and tris.max() < nv
            sizes.append((nv, float(np.median(verts[:, 2]))))
            off += 8 + nv * 24 + nt * 12
        assert off == len(body)
        assert 0.0 < sizes[0][1] < 3.0            # world frame, in front
        st, ct, body = _get(viewer.port, "/mesh.ply")
        assert st == 200 and body.startswith(b"ply")
        assert f"element vertex {sizes[0][0]}".encode() in body
        st, ct, body = _get(viewer.port, "/status")
        s = json.loads(body)
        assert s["frame"] == 3 and s["objects"] == pipe.active_object_ids
        assert len(s["cam_pose"]) == 4
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(viewer.port, "/nope")
        assert e.value.code == 404
    finally:
        viewer.close()


def test_render_concurrent_with_frames():
    """A thread renders orbit views while the frame loop runs three
    frames: every render equals the render of one frame's whole state
    (before the frames or after one of them), and none raises."""
    frames, masks = sequence(5)
    pipe = EMFusionPipeline(Params(**CFG), rigid_provider(masks),
                            device="cpu")
    pipe.process_frame(None, frames[0], timestamp=0.0)
    refs = [render_orbit_view(pipe, *VIEWS[0], with_widgets=False)]
    got, errors, stop = [], [], threading.Event()

    def renderer():
        while not stop.is_set():
            try:
                got.append(render_orbit_view(pipe, *VIEWS[0],
                                             with_widgets=False))
            except Exception as e:          # recorded, then failed below
                errors.append(e)
                return

    t = threading.Thread(target=renderer)
    t.start()
    try:
        for f in range(1, 4):
            pipe.process_frame(None, frames[f], timestamp=float(f))
            refs.append(render_orbit_view(pipe, *VIEWS[0],
                                          with_widgets=False))
    finally:
        stop.set()
        t.join()
    assert not errors, errors
    assert len(got) >= 2
    assert any(not np.array_equal(refs[0], r) for r in refs[1:])
    for img in got:
        assert any(np.array_equal(img, r) for r in refs)


def test_cli_turntable(tmp_path):
    """``apps.run_emfusion --turntable 3`` on a 4-frame TUM-format
    sequence of the rigid scene writes turntable/view000-002.png under
    the export directory, each readable by the port's decoder, lit, and
    each from another viewpoint."""
    seq = str(tmp_path / "seq")
    write_sequence(seq)
    out = str(tmp_path / "out")
    assert run_emfusion.main(["-t", seq, "-e", out, "-c",
                              os.path.join(seq, "config.cfg"), "--frames",
                              "4", "--turntable", "3", "--device",
                              "cpu"]) == 0
    names = sorted(os.listdir(os.path.join(out, "turntable")))
    assert names == ["view000.png", "view001.png", "view002.png"]
    views = [decode_png(open(os.path.join(out, "turntable", n), "rb").read())
             for n in names]
    for v in views:
        assert v.shape == (120, 160, 3) and (v.max(-1) > 0).mean() > 0.05
    assert not np.array_equal(views[0], views[1])
