"""Port parity: the codecs, readers and writers of ``emfusion_tpu_torch.io``
and the trajectory evaluation of ``eval/ate.py`` against ``cv2``, the JAX
package's native runtime (``native/runtime.py``), its readers, writers and
``eval/ate.py`` on the CPU. All comparisons are exact: pixels, depths,
timestamps and file bytes equal."""

import os
import struct
import zlib

import cv2
import numpy as np
import pytest

from emfusion_tpu import native
from emfusion_tpu.eval import ate as jax_ate
from emfusion_tpu.io import readers as jax_readers
from emfusion_tpu.io import writers as jax_writers
from emfusion_tpu_torch.eval import ate
from emfusion_tpu_torch.io import codecs, readers, writers


def scene_image(h=64, w=80, seed=0):
    """An RGB image with noise, flat rows, ramps and a sine band: libpng's
    adaptive filter choice gives it rows of every filter type."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.zeros((h, w, 3), np.uint8)
    img[..., 0] = (xx * 3) % 256
    img[..., 1] = (yy * 2 + xx) % 256
    img[..., 2] = rng.randint(0, 256, (h, w))
    img[:16] = rng.randint(0, 256, (16, w, 3))
    img[16:24] = 77
    img[40:50] = (np.sin(xx / 5.0) * 100 + 120).astype(np.uint8)[40:50, :,
                                                                  None]
    return img


def depth16(h=64, w=80, seed=1):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    d = (rng.rand(h, w) * 2000 + 500).astype(np.uint16)
    d[:, :40] = (yy * 300 + xx * 70)[:, :40]
    d[:, -3:] = 65535
    return d


def png_filters(data: bytes, h: int) -> set:
    pos, idat = 8, []
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IDAT":
            idat.append(data[pos + 8:pos + 8 + n])
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    return set(rows.reshape(h, -1)[:, 0].tolist())


def cv2_read(path):
    """``cv2``'s pixels in RGB(A) order."""
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    return img[..., [2, 1, 0, 3][:img.shape[2]]] if img.ndim == 3 else img


@pytest.mark.parametrize("kind", ["rgb8", "gray16"])
def test_png_decode_matches_cv2_on_cv2_files(kind, tmp_path):
    """Files ``cv2`` writes at compression level 3 (libpng's adaptive
    filters: every type in the 8-bit image, Sub and Paeth among them in
    the 16-bit one) decode to ``cv2``'s pixels."""
    img = scene_image() if kind == "rgb8" else depth16()
    path = str(tmp_path / "a.png")
    cv2.imwrite(path, img[..., ::-1] if img.ndim == 3 else img,
                [cv2.IMWRITE_PNG_COMPRESSION, 3])
    with open(path, "rb") as f:
        data = f.read()
    want = {0, 1, 2, 3, 4} if kind == "rgb8" else {1, 4}
    assert png_filters(data, img.shape[0]) >= want
    out = codecs.decode_png(data)
    np.testing.assert_array_equal(out, cv2_read(path))
    np.testing.assert_array_equal(out, img)
    assert out.dtype == img.dtype


@pytest.mark.parametrize("kind", ["rgb8", "rgba8", "gray8", "gray16",
                                  "one_pixel"])
def test_png_encoder_round_trip(kind, tmp_path):
    """The encoder (Up-filtered rows) for 8-bit RGB, RGBA and gray, 16-bit
    gray and a 1x1 image: ``cv2`` and the decoder read back the pixels
    written."""
    rng = np.random.RandomState(5)
    img = {"rgb8": scene_image(),
           "rgba8": rng.randint(0, 256, (33, 47, 4)).astype(np.uint8),
           "gray8": scene_image()[..., 1], "gray16": depth16(),
           "one_pixel": np.array([[65000]], np.uint16)}[kind]
    path = str(tmp_path / "b.png")
    codecs.write_png(path, img)
    with open(path, "rb") as f:
        data = f.read()
    assert png_filters(data, img.shape[0]) == {2}
    np.testing.assert_array_equal(codecs.decode_png(data), img)
    np.testing.assert_array_equal(cv2_read(path), img)
    np.testing.assert_array_equal(codecs.read_png(path), img)


def exr_zips(img, as_half):
    """A one-channel OpenEXR file with ZIPS compression (one scanline a
    zlib block), which the native writer does not make: the header of
    ``native/src/exr.cc``'s writer, each line's bytes split into even and
    odd halves and delta-coded (+128) before deflating."""
    H, W = img.shape

    def attr(name, kind, body):
        return (name.encode() + b"\0" + kind.encode() + b"\0"
                + struct.pack("<i", len(body)) + body)

    box = struct.pack("<4i", 0, 0, W - 1, H - 1)
    head = (struct.pack("<II", 20000630, 2)
            + attr("channels", "chlist", b"Z\0" + struct.pack(
                "<iiii", 1 if as_half else 2, 0, 1, 1) + b"\0")
            + attr("compression", "compression", b"\2")
            + attr("dataWindow", "box2i", box)
            + attr("displayWindow", "box2i", box)
            + attr("lineOrder", "lineOrder", b"\0") + b"\0")
    pix = img.astype("<f2" if as_half else "<f4")
    blocks, offsets, pos = [], [], len(head) + 8 * H
    for y in range(H):
        raw = np.frombuffer(pix[y].tobytes(), np.uint8)
        d = np.concatenate([raw[0::2], raw[1::2]]).astype(np.int64)
        d[1:] = (d[1:] - d[:-1] + 128) & 255
        z = zlib.compress(d.astype(np.uint8).tobytes())
        payload = z if len(z) < len(raw) else raw.tobytes()
        blk = struct.pack("<ii", y, len(payload)) + payload
        offsets.append(pos)
        pos += len(blk)
        blocks.append(blk)
    return head + np.asarray(offsets, "<u8").tobytes() + b"".join(blocks)


@pytest.mark.parametrize("compression", [0, 3])
@pytest.mark.parametrize("as_half", [False, True])
def test_exr_decode_matches_native(compression, as_half, tmp_path):
    """Files the JAX package's native writer makes (NONE and ZIP, FLOAT and
    HALF; 37 rows: a short last ZIP block of 16 rows) decode to the native
    reader's values; so does a ZIPS file of the same image."""
    rng = np.random.RandomState(compression + as_half)
    d = (rng.rand(37, 53) * 8).astype(np.float32)
    d[:, :10] = 0.0
    d[5, 5] = 1e-6                     # a half subnormal
    path = str(tmp_path / "d.exr")
    assert native.write_exr(path, d, compression=compression,
                            as_half=as_half)
    ref = native.read_exr(path)
    np.testing.assert_array_equal(codecs.read_exr(path), ref)
    if not as_half:
        np.testing.assert_array_equal(ref, d)
    zips = str(tmp_path / "zips.exr")
    with open(zips, "wb") as f:
        f.write(exr_zips(d, as_half))
    np.testing.assert_array_equal(codecs.read_exr(zips), native.read_exr(zips))
    np.testing.assert_array_equal(
        codecs.read_exr(zips), d.astype(np.float16).astype(np.float32)
        if as_half else d)


def write_tum(root, n=5, h=24, w=32, libpng=False):
    """A TUM sequence of random images written by ``cv2``; with
    ``libpng``, of smooth images (Paeth and Average rows among libpng's
    adaptive choices) written by the JAX native runtime's libpng
    writer."""
    rng = np.random.RandomState(3)
    os.makedirs(os.path.join(root, "rgb"))
    os.makedirs(os.path.join(root, "depth"))
    lines = ["# rgb depth\n"]           # not 4 fields: skipped
    for i in range(n):
        ts = f"{1305031102.175304 + i * 0.0333:.6f}"
        dts = f"{1305031102.160407 + i * 0.0333:.6f}"
        rgb_f = os.path.join(root, "rgb", f"{ts}.png")
        depth_f = os.path.join(root, "depth", f"{dts}.png")
        if libpng:
            yy, xx = np.mgrid[0:h, 0:w]
            native.write_png_rgb(rgb_f, np.stack(
                [xx * 7 + i, yy * 9, (xx + yy) * 4], -1).astype(np.uint8)
                + rng.randint(0, 3, (h, w, 3)).astype(np.uint8))
            native.write_png_gray16(depth_f, (5000 + 40 * xx + 30 * yy + i
                                              + rng.randint(0, 5, (h, w))
                                              ).astype(np.uint16))
            assert 4 in png_filters(open(rgb_f, "rb").read(), h)
        else:
            cv2.imwrite(rgb_f,
                        rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
            cv2.imwrite(depth_f,
                        rng.randint(0, 30000, (h, w)).astype(np.uint16))
        # TUM's associate.py writes either order
        lines.append(f"{ts} rgb/{ts}.png {dts} depth/{dts}.png\n" if i % 2
                     else f"{dts} depth/{dts}.png {ts} rgb/{ts}.png\n")
    with open(os.path.join(root, "associations.txt"), "w") as f:
        f.writelines(lines)


def write_cofusion(root, start=3, n=4, h=20, w=24):
    rng = np.random.RandomState(4)
    os.makedirs(os.path.join(root, "colour"))
    os.makedirs(os.path.join(root, "depth_noise"))
    for i in range(start, start + n):
        cv2.imwrite(os.path.join(root, "colour", f"Color{i:04d}.png"),
                    rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
        d = (rng.rand(h, w) * 6).astype(np.float32)
        d[0, :5] = 250.0                # beyond the 100 m clamp
        native.write_exr(os.path.join(root, "depth_noise",
                                      f"Depth{i:04d}.exr"), d, compression=3)


def frames_of(reader):
    reader.init()
    try:
        return list(reader.frames())
    finally:
        reader.close()


@pytest.mark.parametrize("kind", ["tum", "tum_libpng", "cofusion"])
def test_readers_match_jax(kind, tmp_path):
    """``make_reader`` picks the same reader; every frame's RGB, depth
    (TUM: x 1/5000; Co-Fusion: > 100 m cleared), index and timestamp
    equal the JAX reader's, and so do the frame rate and the
    Co-Fusion start index; a TUM sequence written by libpng's adaptive
    filters (the JAX native writer) too."""
    root = str(tmp_path / kind)
    if kind == "cofusion":
        write_cofusion(root)
    else:
        write_tum(root, libpng=kind == "tum_libpng")
    port = readers.make_reader(root)
    ref = jax_readers.make_reader(root)
    assert type(port).__name__ == type(ref).__name__
    a, b = frames_of(port), frames_of(ref)
    assert len(a) == len(b) == (4 if kind == "cofusion" else 5)
    assert port.frame_rate == ref.frame_rate
    for fa, fb in zip(a, b):
        assert (fa.index, fa.timestamp) == (fb.index, fb.timestamp)
        np.testing.assert_array_equal(fa.rgb, fb.rgb)
        np.testing.assert_array_equal(fa.depth, fb.depth)
        assert fa.depth.dtype == np.float32
    if kind == "cofusion":
        assert [f.index for f in a] == [3, 4, 5, 6]
        assert (a[0].depth[0, :5] == 0).all()
    else:
        assert a[1].timestamp == 1305031102.208604


def poses(n=6, seed=5):
    """Rigid poses with rotations through every branch of the quaternion
    conversion (trace > 0, and each diagonal entry the largest)."""
    rng = np.random.RandomState(seed)
    out = {}
    axes = [np.array([0.0, 0, 1]), np.array([1.0, 0, 0]),
            np.array([0.0, 1, 0]), np.array([0.0, 0, 1])]
    for i in range(n):
        ax = axes[i % 4] + rng.normal(0, 0.05, 3)
        ax /= np.linalg.norm(ax)
        th = 0.3 if i % 4 == 0 else 3.0
        K = np.array([[0, -ax[2], ax[1]], [ax[2], 0, -ax[0]],
                      [-ax[1], ax[0], 0]])
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K
        T[:3, 3] = rng.normal(0, 1, 3)
        out[i] = T
    return out


def test_writers_byte_identical_to_jax(tmp_path):
    """Pose files (with and without timestamps, and with resize offsets
    undone), PLY meshes and binary volumes: the same bytes as the JAX
    writers' for the same arrays."""
    rng = np.random.RandomState(6)
    P = poses()
    stamps = {i: 1000.0 + i / 30 for i in P}
    offsets = {2: np.array([0.01, -0.02, 0.0], np.float32),
               4: np.array([0.0, 0.03, 0.01], np.float32)}
    verts = rng.normal(0, 1, (500, 3)).astype(np.float32)
    verts[0] = [-0.0, 1e-7, -1e-7]
    norms = rng.normal(0, 1, (500, 3)).astype(np.float32)
    tris = rng.randint(0, 500, (700, 3)).astype(np.int32)
    vol = rng.normal(0, 1, (5, 6, 7)).astype(np.float32)
    cases = [
        ("pose", lambda m, p: m.write_pose_file(p, P)),
        ("pose_ts", lambda m, p: m.write_pose_file(p, P, stamps)),
        ("pose_off", lambda m, p: m.write_pose_file(
            p, m.add_pose_offsets(P, offsets), stamps)),
        ("ply", lambda m, p: m.write_ply(p, verts, norms, tris)),
        ("ply_empty", lambda m, p: m.write_ply(
            p, np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32),
            np.zeros((0, 3), np.int32))),
        ("bin", lambda m, p: m.write_volume_bin(p, vol, (7, 6, 5), 0.0125)),
    ]
    for name, fn in cases:
        a, b = str(tmp_path / f"{name}.port"), str(tmp_path / f"{name}.jax")
        fn(writers, a)
        fn(jax_writers, b)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), name
    data, res, voxel = writers.read_volume_bin(str(tmp_path / "bin.jax"))
    np.testing.assert_array_equal(data, vol)
    assert res == (7, 6, 5) and voxel == np.float32(0.0125)


def test_trajectory_and_rpe_match_jax(tmp_path):
    """``load_trajectory`` of a written pose file and ``evaluate_rpe`` (deltas
    1 and 2) and ``evaluate_ate`` of a noisy copy: equal to the JAX
    package's."""
    P = poses(12, seed=7)
    stamps = {i: 50.0 + i * 0.04 for i in P}
    path = str(tmp_path / "traj.txt")
    writers.write_pose_file(path, P, stamps)
    a, b = ate.load_trajectory(path), jax_ate.load_trajectory(path)
    assert sorted(a) == sorted(b) and len(a) == 12
    for s in a:
        np.testing.assert_array_equal(a[s], b[s])
        np.testing.assert_allclose(a[s], P[round((s - 50.0) / 0.04)],
                                   atol=1e-6)
    rng = np.random.RandomState(8)
    noisy = {s + 0.003: T @ np.diag([1, 1, 1, 1.0]) for s, T in a.items()}
    for T in noisy.values():
        T[:3, 3] += rng.normal(0, 0.01, 3)
    for delta in (1, 2):
        assert ate.evaluate_rpe(noisy, a, delta=delta) == \
            jax_ate.evaluate_rpe(noisy, b, delta=delta)
    assert ate.evaluate_ate(noisy, a) == jax_ate.evaluate_ate(noisy, b)
    with pytest.raises(ValueError):
        ate.evaluate_rpe(noisy, a, delta=20)
