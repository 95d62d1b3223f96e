"""Port parity: ``emfusion_tpu_torch.native`` (the C unfilter and EXR
un-predictor, the codecs, ``NativePrefetcher``, ``AsyncWriter``) and
``io.writers.write_frame_meshes(objects_only=...)`` against the numpy
twins in ``io/codecs.py`` and the JAX package's native runtime
(``emfusion_tpu/native/``, libpng and zlib) on the CPU. Pixels, floats,
frame indices and file bytes are compared exactly."""

import ctypes
import os
import threading
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emfusion_tpu import native as jax_native
from emfusion_tpu.io import writers as jax_writers
from emfusion_tpu.ops.fusion import compute_gradients
from emfusion_tpu_torch import native
from emfusion_tpu_torch.config import Params
from emfusion_tpu_torch import kernels
from emfusion_tpu_torch.io import clib, codecs, writers
from emfusion_tpu_torch.pipeline import EMFusionPipeline, state_from_numpy
from test_torch_io import png_filters

torch.set_num_threads(2)


def rows_of(rng, h, stride, types):
    """``h`` rows of random filtered bytes, each with a filter type drawn
    from ``types``, as an inflated PNG stream."""
    ftype = rng.choice(types, h).astype(np.uint8)
    filt = rng.randint(0, 256, (h, stride)).astype(np.uint8)
    return ftype, filt, np.concatenate([ftype[:, None], filt], 1).ravel()


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
def test_c_unfilter_matches_plain(bpp):
    """Random rows of all five filter types (and of None, Sub and Up
    only) at every bytes-per-pixel value, a one-pixel row and a one-row
    image among them: the C loop equals the anti-diagonal and the row
    twins byte for byte."""
    rng = np.random.RandomState(bpp)
    for h, w in ((1, 1), (1, 9), (7, 1), (29, 23)):
        ftype, filt, raw = rows_of(rng, h, w * bpp, [0, 1, 2, 3, 4])
        np.testing.assert_array_equal(
            clib.unfilter_png(raw, h, w * bpp, bpp),
            codecs._unfilter_wavefront(ftype, filt, bpp))
        ftype, filt, raw = rows_of(rng, h, w * bpp, [0, 1, 2])
        np.testing.assert_array_equal(
            clib.unfilter_png(raw, h, w * bpp, bpp),
            codecs._unfilter_rows(ftype, filt, bpp))


def test_c_unfilter_refuses_bad_rows():
    """A filter type above 4 and short data raise; so does the plain
    twin."""
    rng = np.random.RandomState(0)
    ftype, filt, raw = rows_of(rng, 5, 12, [0, 4])
    raw[3 * 13] = 5
    with pytest.raises(ValueError, match="row 3"):
        clib.unfilter_png(raw, 5, 12, 3)
    with pytest.raises(ValueError):
        codecs.unfilter_plain(np.array([0, 5], np.uint8), filt[:2], 3)
    with pytest.raises(ValueError):
        clib.unfilter_png(raw[:-1], 5, 12, 3)


def test_shared_build_raises_and_rehashes(tmp_path):
    """``kernels.compile_shared``, which builds the codecs' C library as
    it builds the CUDA sources: a source that does not compile raises
    with the compiler's output and leaves no library; one that compiles
    lands at its path, no temporary file left; the library's name moves
    with the source and with the flags."""
    cc = clib._compiler()
    bad, good = tmp_path / "bad.c", tmp_path / "good.c"
    bad.write_text("int f(void) { return undeclared; }\n")
    good.write_text("int f(void) { return 7; }\n")
    so_bad, so = str(tmp_path / "bad.so"), str(tmp_path / "good.so")
    with pytest.raises(RuntimeError, match="(?s)--- bad ---.*undeclared"):
        kernels.compile_shared(
            [("bad", [cc, *clib.CFLAGS, "-x", "c", str(bad)], so_bad)])
    assert not os.path.exists(so_bad)
    logs = kernels.compile_shared(
        [("good", [cc, *clib.CFLAGS, "-x", "c", str(good)], so)])
    assert set(logs) == {"good"}
    assert ctypes.CDLL(so).f() == 7
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    path = kernels.library_path("good", [str(good)], clib.CFLAGS)
    assert os.path.dirname(path) == kernels.BUILD_DIR
    assert path != kernels.library_path("good", [str(good)], clib.CFLAGS[1:])
    good.write_text("int f(void) { return 8; }\n")
    assert path != kernels.library_path("good", [str(good)], clib.CFLAGS)


@pytest.mark.parametrize("n", [1, 2, 1001, 40960])
def test_exr_unpredict_matches_plain(n):
    d = np.random.RandomState(n).randint(0, 256, n).astype(np.uint8)
    np.testing.assert_array_equal(clib.exr_unpredict(d),
                                  codecs._zip_reconstruct(d))


def smooth_rgb(h=480, w=640, seed=0):
    """An image with gradients, a sine band and mild noise: libpng's
    adaptive filters pick Paeth and Average rows for it."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx * 255 // w, yy * 255 // h,
                    (np.sin(xx / 9.0 + yy / 13.0) * 90 + 128)], -1)
    img = img + rng.randint(0, 3, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def smooth_depth(h=480, w=640, seed=1):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    d = 6000 + 4 * yy + 3 * xx + 800 * np.sin(xx / 40.0)
    return (d + rng.randint(0, 4, (h, w))).astype(np.uint16)


@pytest.mark.parametrize("kind", ["rgb8", "gray16"])
def test_read_png_matches_native_on_libpng_files(kind, tmp_path):
    """640x480 files the JAX native writer makes (libpng, Paeth rows
    among its choices) read to the JAX native reader's pixels; the C
    unfilter and the numpy twin decode them alike."""
    img = smooth_rgb() if kind == "rgb8" else smooth_depth()
    path = str(tmp_path / "a.png")
    write = (jax_native.write_png_rgb if kind == "rgb8"
             else jax_native.write_png_gray16)
    assert write(path, img)
    with open(path, "rb") as f:
        data = f.read()
    assert 4 in png_filters(data, img.shape[0])
    read = native.read_png_rgb if kind == "rgb8" else native.read_png_gray16
    ref = (jax_native.read_png_rgb if kind == "rgb8"
           else jax_native.read_png_gray16)
    out = read(path)
    np.testing.assert_array_equal(out, ref(path))
    np.testing.assert_array_equal(out, img)
    assert out.dtype == img.dtype
    np.testing.assert_array_equal(codecs.decode_png_plain(data), img)
    if kind == "rgb8":
        assert native.read_png_gray16(path) is None
        assert jax_native.read_png_gray16(path) is None


@pytest.mark.parametrize("kind", ["gray8", "gray_alpha8", "rgba8", "rgb16"])
def test_read_png_rgb_converts_as_native(kind, tmp_path):
    """Gray, gray + alpha, RGBA and 16-bit RGB files read as RGB uint8 as
    the JAX native reader's libpng transformations give them."""
    import cv2
    rng = np.random.RandomState(3)
    h, w = 21, 34
    img = {"gray8": rng.randint(0, 256, (h, w)),
           "gray_alpha8": rng.randint(0, 256, (h, w, 2)),
           "rgba8": rng.randint(0, 256, (h, w, 4)),
           "rgb16": rng.randint(0, 65536, (h, w, 3))}[kind]
    img = img.astype(np.uint16 if kind == "rgb16" else np.uint8)
    path = str(tmp_path / "c.png")
    if kind == "gray_alpha8":           # cv2 writes no gray + alpha
        with open(path, "wb") as f:
            f.write(gray_alpha_png(img))
    else:
        cv2.imwrite(path, img if img.ndim == 2 else img[
            ..., [2, 1, 0, 3][:img.shape[2]]])
    np.testing.assert_array_equal(native.read_png_rgb(path),
                                  jax_native.read_png_rgb(path))


def gray_alpha_png(img):
    """A gray + alpha PNG (colour type 4), every row unfiltered."""
    import struct
    import zlib
    h, w, _ = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, w * 2)], 1)
    return (codecs.PNG_SIGNATURE
            + codecs._chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 4, 0,
                                                 0, 0))
            + codecs._chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + codecs._chunk(b"IEND", b""))


def test_png_writers_read_back_through_native(tmp_path):
    """``write_png_rgb`` and ``write_png_gray16`` (the port's encoder)
    read back through the JAX native reader to the pixels written."""
    rgb, d = smooth_rgb(48, 64), smooth_depth(48, 64)
    a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    assert native.write_png_rgb(a, rgb) and native.write_png_gray16(b, d)
    np.testing.assert_array_equal(jax_native.read_png_rgb(a), rgb)
    np.testing.assert_array_equal(jax_native.read_png_gray16(b), d)
    assert not native.write_png_rgb(str(tmp_path / "no" / "c.png"), rgb)


@pytest.mark.parametrize("compression", [0, 3])
@pytest.mark.parametrize("as_half", [False, True])
def test_write_exr_matches_native(compression, as_half, tmp_path):
    """``write_exr`` in all four forms (NONE and ZIP, FLOAT and HALF;
    37 rows: a short last ZIP block; HALF subnormals, values beyond its
    range, NaN): the JAX native reader reads the same floats as from the
    JAX native writer's file, and the files are the same bytes."""
    rng = np.random.RandomState(10 * compression + as_half)
    img = (rng.rand(37, 53) * 8).astype(np.float32)
    img[:, :6] = 0.0
    img[1, 1], img[2, 2], img[3, 3] = 1e-6, -3e-5, 7e4
    img[4, 4], img[5, 5] = np.nan, -np.inf
    a, b = str(tmp_path / "port.exr"), str(tmp_path / "jax.exr")
    assert native.write_exr(a, img, compression=compression,
                            as_half=as_half)
    assert jax_native.write_exr(b, img, compression=compression,
                                as_half=as_half)
    ra, rb = jax_native.read_exr(a), jax_native.read_exr(b)
    np.testing.assert_array_equal(ra, rb)
    np.testing.assert_array_equal(native.read_exr(a), rb)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def png_sequence(root, n=8, h=30, w=44):
    """``n`` frames: libpng-written RGB and 16-bit depth PNGs."""
    rng = np.random.RandomState(7)
    rgbs, depths = [], []
    for i in range(n):
        r, d = os.path.join(root, f"rgb{i}.png"), os.path.join(
            root, f"depth{i}.png")
        jax_native.write_png_rgb(r, smooth_rgb(h, w, seed=i))
        jax_native.write_png_gray16(d, rng.randint(0, 40000, (h, w)).astype(
            np.uint16))
        rgbs.append(r)
        depths.append(d)
    return rgbs, depths


def exr_sequence(root, n=8, h=26, w=35):
    """``n`` frames of RGB PNGs and ZIP EXR depths with values beyond the
    100 m clamp and NaNs; frame 2 has no RGB path."""
    rng = np.random.RandomState(8)
    rgbs, depths = [], []
    for i in range(n):
        r, d = os.path.join(root, f"c{i}.png"), os.path.join(root,
                                                             f"d{i}.exr")
        jax_native.write_png_rgb(r, smooth_rgb(h, w, seed=i))
        z = (rng.rand(h, w) * 6).astype(np.float32)
        z[0, :4] = 250.0
        z[1, :3] = np.nan
        jax_native.write_exr(d, z, compression=3)
        rgbs.append("" if i == 2 else r)
        depths.append(d)
    return rgbs, depths


@pytest.mark.parametrize("kind", ["png", "exr"])
def test_prefetcher_matches_native(kind, tmp_path):
    """8-frame sequences through ``NativePrefetcher`` and the JAX one,
    3 workers and 3 slots each: the same indices in order, RGB and depth
    arrays equal (TUM's 1/5000 scale; the EXR depths clamped at 100 m,
    NaN cleared; a zero RGB image where there is no RGB path), then None
    at the end."""
    make = png_sequence if kind == "png" else exr_sequence
    rgbs, depths = make(str(tmp_path))
    kw = dict(n_workers=3, capacity=3,
              depth_scale=1 / 5000 if kind == "png" else 1.0,
              depth_clamp=100.0)
    port = native.NativePrefetcher(rgbs, depths, **kw)
    ref = jax_native.NativePrefetcher(rgbs, depths, **kw)
    try:
        assert (port.width, port.height, port.num_frames) == (
            ref.width, ref.height, ref.num_frames)
        got = 0
        while True:
            a, b = port.next(), ref.next()
            if b is None:
                assert a is None
                break
            assert a[2] == b[2] == got
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
            assert a[1].dtype == np.float32 and a[0].dtype == np.uint8
            if kind == "exr":
                assert (a[1][:2, :3] == 0).all()
                if got == 2:
                    assert not a[0].any()
            got += 1
        assert got == 8
    finally:
        port.close()
        ref.close()


def test_prefetcher_failures(tmp_path):
    """A missing RGB file raises at its frame, naming the file, after the
    frames before it; a depth of another size raises naming its file; a
    missing first depth raises at construction."""
    rgbs, depths = png_sequence(str(tmp_path), n=5)
    rgbs[3] = str(tmp_path / "gone.png")
    pf = native.NativePrefetcher(rgbs, depths, n_workers=2, capacity=2)
    try:
        assert [pf.next()[2] for _ in range(3)] == [0, 1, 2]
        with pytest.raises(RuntimeError, match="gone.png"):
            pf.next()
    finally:
        pf.close()
    small = str(tmp_path / "small.png")
    native.write_png_gray16(small, np.ones((5, 7), np.uint16))
    pf = native.NativePrefetcher([""] * 2, [depths[0], small],
                                 n_workers=1, capacity=2)
    try:
        pf.next()
        with pytest.raises(RuntimeError, match="small.png"):
            pf.next()
    finally:
        pf.close()
    with pytest.raises(RuntimeError, match="gone.png"):
        native.NativePrefetcher([""], [str(tmp_path / "gone.png")])


def test_prefetcher_close_part_way(tmp_path):
    """``close()`` after 2 of 200 frames (3 workers, 3 slots, the workers
    blocked on full slots) returns within 15 s and leaves no worker
    running."""
    rgbs, depths = png_sequence(str(tmp_path), n=4)
    pf = native.NativePrefetcher(rgbs * 50, depths * 50, n_workers=3,
                                 capacity=3)
    pf.next()
    pf.next()
    pool = pf._pool
    done = threading.Event()
    t = threading.Thread(target=lambda: (pf.close(), done.set()),
                         daemon=True)
    t0 = time.perf_counter()
    t.start()
    t.join(timeout=15)
    assert done.is_set(), f"close() still running after " \
        f"{time.perf_counter() - t0:.1f} s"
    alive = [w.is_alive() for w in pool._workers]
    assert alive and not any(alive)
    assert pf.next() is None


def test_prefetcher_stress_threads(tmp_path):
    """More worker threads than cores over a tiny ring, the interpreter
    switching threads every 10 us: every frame arrives once, in order,
    with its own pixels."""
    import sys
    rgbs, depths = png_sequence(str(tmp_path), n=6)
    want = [jax_native.read_png_rgb(p) for p in rgbs]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        pf = native.NativePrefetcher(rgbs * 10, depths * 10,
                                     n_workers=4 * (os.cpu_count() or 2),
                                     capacity=2)
        try:
            for i in range(60):
                rgb, _, idx = pf.next()
                assert idx == i
                np.testing.assert_array_equal(rgb, want[i % 6])
            assert pf.next() is None
        finally:
            pf.close()
    finally:
        sys.setswitchinterval(old)


def test_async_writer_matches_native(tmp_path):
    """``AsyncWriter`` against the JAX one: volume files the same bytes,
    PNG files the same pixels (read back by the JAX native reader), PLY
    files the bytes of the port's ``write_ply``; ``wait()`` counts a write
    into a missing directory as one error in both."""
    rng = np.random.RandomState(9)
    vol = rng.normal(0, 1, (5, 6, 7)).astype(np.float32)
    d16 = smooth_depth(40, 50)
    rgb = smooth_rgb(40, 50)
    verts = rng.normal(0, 1, (300, 3)).astype(np.float32)
    norms = rng.normal(0, 1, (300, 3)).astype(np.float32)
    tris = rng.randint(0, 300, (400, 3)).astype(np.int32)
    out = {}
    for name, w in (("port", native.AsyncWriter()),
                    ("jax", jax_native.AsyncWriter())):
        root = tmp_path / name
        root.mkdir()
        w.submit_volume(str(root / "v.bin"), vol, 0.0125)
        w.submit_png16(str(root / "d.png"), d16)
        w.submit_png8(str(root / "c.png"), rgb)
        w.submit_ply(str(root / "m.ply"), verts, norms, tris)
        w.submit_volume(str(root / "missing" / "v.bin"), vol, 0.0125)
        verts[0] += 1.0                # the writer copied the arrays
        assert w.wait() == 1
        w.close()
        verts[0] -= 1.0
        out[name] = root
    port, ref = out["port"], out["jax"]
    assert (port / "v.bin").read_bytes() == (ref / "v.bin").read_bytes()
    for f, read in (("d.png", jax_native.read_png_gray16),
                    ("c.png", jax_native.read_png_rgb)):
        np.testing.assert_array_equal(read(str(port / f)),
                                      read(str(ref / f)))
    writers.write_ply(str(tmp_path / "sync.ply"), verts, norms, tris)
    assert (port / "m.ply").read_bytes() == \
        (tmp_path / "sync.ply").read_bytes()


def sphere_sdf(R, centre, radius):
    zz, yy, xx = np.mgrid[0:R, 0:R, 0:R].astype(np.float32)
    d = np.sqrt((xx - centre[0]) ** 2 + (yy - centre[1]) ** 2
                + (zz - centre[2]) ** 2) - radius
    return np.clip(d / 3.0, -1.0, 1.0).astype(np.float32)


def mesh_state(K=3, R=16, B=24, H=12, W=16):
    """A background with a sphere and a pool of K slots, the first and
    last live (ids 1 and 3), as the JAX pool's numpy arrays."""
    bg = sphere_sdf(B, (11.5, 12.0, 12.5), 6.0)
    tsdf = np.stack([sphere_sdf(R, (7.5, 8.0, 7.0), 4.0 + k)
                     for k in range(K)])
    fg = np.zeros((K, 2, R, R, R), np.float32)
    fg[:, 0] = 5.0
    return dict(
        bg_tsdf=bg, bg_weights=np.ones_like(bg), bg_pose=np.eye(4),
        bg_assoc=np.ones((H, W), np.float32), cam_pose=np.eye(4),
        objs=dict(tsdf=tsdf, weights=np.ones_like(tsdf), fg_counts=fg,
                  pose=np.tile(np.eye(4, dtype=np.float32), (K, 1, 1)),
                  voxel_size=np.full(K, 0.01, np.float32),
                  truncdist=np.full(K, 0.05, np.float32),
                  active=np.array([True, False, True]),
                  visible=np.array([True, False, True]),
                  object_id=np.array([1, 2, 3], np.int32),
                  assoc=np.zeros((K, H, W), np.float32)))


@pytest.mark.parametrize("objects_only", [False, True])
def test_write_frame_meshes_file_set_matches_jax(objects_only, tmp_path):
    """``write_frame_meshes`` on a state with two live slots of three
    (through an ``AsyncWriter`` and synchronously) writes the file set of
    the JAX function on the same arrays: the object meshes, and the
    background's unless ``objects_only``; both writes give the same
    bytes."""
    a = mesh_state()
    o = a["objs"]
    jax_pipe = SimpleNamespace(
        state=SimpleNamespace(
            bg_tsdf=jnp.asarray(a["bg_tsdf"]),
            bg_weights=jnp.asarray(a["bg_weights"]),
            objs=SimpleNamespace(
                tsdf=jnp.asarray(o["tsdf"]),
                grads=jax.vmap(compute_gradients)(jnp.asarray(o["tsdf"])),
                weights=jnp.asarray(o["weights"]),
                fg_counts=jnp.asarray(o["fg_counts"]),
                active=jnp.asarray(o["active"]),
                voxel_size=jnp.asarray(o["voxel_size"]))),
        active_object_ids=[1, 3], _slot_of={1: 0, 3: 2}.get,
        params=SimpleNamespace(globalVoxelSize=0.02, mc_max_verts=1 << 16),
        mesh=None)
    jax_writers.write_frame_meshes(jax_pipe, str(tmp_path / "jax"), 7,
                                   objects_only=objects_only)
    pipe = EMFusionPipeline(
        Params(frameSize=(16, 12), fx=14.0, fy=14.0, cx=7.5, cy=5.5,
               globalVolumeDims=(24, 24, 24), globalVoxelSize=0.02,
               objVolumeDims=(16, 16, 16), max_objects=3), device="cpu")
    pipe.load_state(state_from_numpy(a, device="cpu"), frame=7)
    assert pipe.active_object_ids == [1, 3]
    w = native.AsyncWriter()
    bg, objs = writers.write_frame_meshes(pipe, str(tmp_path / "async"), 7,
                                          objects_only=objects_only,
                                          writer=w)
    assert w.close() == 0
    writers.write_frame_meshes(pipe, str(tmp_path / "sync"), 7,
                               objects_only=objects_only)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "async")) == sorted(
        os.listdir(tmp_path / "sync"))
    assert ("mesh_bg_0007.ply" in names) == (not objects_only)
    assert (bg is None) == objects_only and sorted(objs) == [1, 3]
    assert {"mesh_1_0007.ply", "mesh_3_0007.ply"} <= set(names)
    for n in names:
        assert (tmp_path / "async" / n).read_bytes() == \
            (tmp_path / "sync" / n).read_bytes()
        assert b"element vertex 0\n" not in (tmp_path / "sync" / n
                                             ).read_bytes()
