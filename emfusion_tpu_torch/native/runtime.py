"""The native tier: codecs, the multi-worker frame decoder and the export
writer.

Port of ``emfusion_tpu/native/runtime.py``, whose C++ library
(``native/src/emf_runtime.cc``) links libpng and zlib. The GPU machine
the port runs on has no libpng headers it can count on, nor ``cv2`` or
PIL, so the port keeps the roles and the names and builds them on its
own codecs (:mod:`emfusion_tpu_torch.io.codecs`): ``zlib`` inflates and
deflates (releasing the interpreter lock), a small C library
(``io/unfilter.c``, :mod:`~emfusion_tpu_torch.io.clib`) reconstructs
PNG rows and EXR blocks (a ``ctypes`` call releases it too), and numpy
converts. So decode workers on threads run in parallel.

  * :func:`read_png_rgb`, :func:`read_png_gray16`, :func:`read_exr`,
    :func:`write_png_rgb`, :func:`write_png_gray16`, :func:`write_exr`:
    the native codecs' calls, None / False where the JAX ones return
    them (a missing file, a PNG of another kind, a failed write).
  * :class:`NativePrefetcher`: ``n_workers`` decode workers ahead of the
    consumer, at most ``capacity`` frames decoded or in flight, frames
    delivered in order (the reference's reader thread,
    ``src/utils/RGBDReader.cpp:72-117``, with a pool of worker threads).
  * :class:`AsyncWriter`: PLY meshes, binary volumes and PNGs written on
    one background thread, in submission order, off the frame loop (the
    reference writes everything at exit, ``src/core/EMFusion.cpp:
    991-1313``). The files are those of :mod:`emfusion_tpu_torch.io.
    writers` and :func:`~emfusion_tpu_torch.io.codecs.write_png`, byte
    for byte.
"""

from __future__ import annotations

import queue
import struct
import threading
import zlib
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

from emfusion_tpu_torch.io import clib, codecs

_DECODE_ERRORS = (ValueError, zlib.error, struct.error, IndexError)


def available() -> bool:
    """Whether the C library builds and loads here (it raises where it
    is needed and does not)."""
    try:
        clib.library()
    except (RuntimeError, OSError):
        return False
    return True


# ------------------------------------------------------------------ codecs

def _rgb8(img: np.ndarray) -> np.ndarray:
    """A decoded PNG as (H, W, 3) uint8, as the native reader's libpng
    transformations give it: 16-bit samples keep their high byte, gray is
    repeated, alpha is dropped."""
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[2] in (1, 2):
        img = img[..., :1].repeat(3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def read_png_rgb(path: str) -> Optional[np.ndarray]:
    """A PNG as (H, W, 3) uint8 (:func:`_rgb8`); None if it is missing."""
    img = codecs.read_png(path)
    return None if img is None else _rgb8(img)


def read_png_gray16(path: str) -> Optional[np.ndarray]:
    """A 16-bit gray PNG (TUM depth) as (H, W) uint16; None if it is
    missing or of another kind."""
    img = codecs.read_png(path)
    if img is None or img.dtype != np.uint16 or img.ndim != 2:
        return None
    return img


def read_exr(path: str) -> Optional[np.ndarray]:
    """An OpenEXR file as (H, W) or (H, W, C) float32; None if it is
    missing."""
    return codecs.read_exr(path)


def _write(path: str, data: bytes) -> bool:
    try:
        with open(path, "wb") as f:
            f.write(data)
    except OSError:
        return False
    return True


def write_exr(path: str, img: np.ndarray, compression: int = 3,
              as_half: bool = False) -> bool:
    """A single-channel float32 EXR (compression 0 = NONE, 3 = ZIP; HALF
    samples with ``as_half``); False if the file cannot be written."""
    return _write(path, codecs.encode_exr(img, compression, as_half))


def write_png_rgb(path: str, img: np.ndarray) -> bool:
    img = np.ascontiguousarray(img, np.uint8)
    return _write(path, codecs.encode_png(img.reshape(img.shape[:2] + (3,))))


def write_png_gray16(path: str, img: np.ndarray) -> bool:
    return _write(path, codecs.encode_png(np.ascontiguousarray(img,
                                                              np.uint16)))


def decode_frame(rgb_path: Optional[str], depth_path: str,
                 depth_scale: float = 1.0, depth_clamp: float = 100.0,
                 size: Optional[Tuple[int, int]] = None):
    """One frame pair as the native prefetcher decodes it (``emf_runtime.
    cc``'s ``decode_frame``): rgb (H, W, 3) uint8, zero without an rgb
    path; depth (H, W) float32 in metres, 0 where invalid: a 16-bit PNG's
    values times ``depth_scale``, or an EXR's first channel with values
    above ``depth_clamp`` and NaN set to 0 (``ImageReader.cpp:116``).
    ``size`` (H, W): what both images must measure. Raises RuntimeError
    naming the file that is missing, undecodable or of another size."""
    def fail(path, why):
        raise RuntimeError(f"frame decode failed: {path}: {why}")

    try:
        if depth_path.endswith(".exr"):
            d = codecs.read_exr(depth_path)
            if d is not None:
                d = (d[..., 0] if d.ndim == 3 else d).astype(np.float32)
                d[~(d <= depth_clamp)] = 0.0
        else:
            raw = read_png_gray16(depth_path)
            d = None if raw is None else (raw.astype(np.float32)
                                          * np.float32(depth_scale))
    except _DECODE_ERRORS as e:
        fail(depth_path, e)
    if d is None:
        fail(depth_path, "missing, or not a 16-bit gray PNG or an EXR")
    if size is not None and d.shape != tuple(size):
        fail(depth_path, f"size {d.shape}, the first frame's {size}")
    if not rgb_path:
        return np.zeros(d.shape + (3,), np.uint8), d
    try:
        rgb = read_png_rgb(rgb_path)
    except _DECODE_ERRORS as e:
        fail(rgb_path, e)
    if rgb is None:
        fail(rgb_path, "missing")
    if rgb.shape[:2] != d.shape:
        fail(rgb_path, f"size {rgb.shape[:2]}, the depth's {d.shape}")
    return rgb, d


# -------------------------------------------------------------- prefetcher

class _Threads:
    """Decode workers on threads: each takes the next frame index once
    fewer than ``capacity`` frames are decoded or in flight, decodes it
    and hands the result (or its exception) to :meth:`get`."""

    def __init__(self, decode: Callable, n: int, n_workers: int,
                 capacity: int):
        self._decode, self._n, self._capacity = decode, n, capacity
        self._cv = threading.Condition()
        self._done: dict = {}
        self._next_job = 0
        self._next_out = 0
        self._stop = False
        self._workers = [threading.Thread(target=self._work, daemon=True)
                         for _ in range(n_workers)]
        for t in self._workers:
            t.start()

    def _work(self):
        while True:
            with self._cv:
                while not self._stop and self._next_job < self._n and \
                        self._next_job >= self._next_out + self._capacity:
                    self._cv.wait()
                if self._stop or self._next_job >= self._n:
                    return
                i = self._next_job
                self._next_job += 1
            try:
                res = self._decode(i)
            except Exception as e:         # handed to the consumer
                res = e
            with self._cv:
                self._done[i] = res
                self._cv.notify_all()

    def get(self, i: int):
        with self._cv:
            while i not in self._done:
                self._cv.wait()
            res = self._done.pop(i)
            self._next_out = i + 1
            self._cv.notify_all()
        if isinstance(res, Exception):
            raise res
        return res

    def close(self):
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        for t in self._workers:
            t.join()


class NativePrefetcher:
    """Multi-worker frame decoder with in-order delivery (the JAX
    ``NativePrefetcher``, ``native/runtime.py:205-256``): frame ``i`` is
    ``rgb_paths[i]`` (None or "" for none: a zero image) and
    ``depth_paths[i]`` (a 16-bit PNG times ``depth_scale``, or an EXR
    clamped at ``depth_clamp``; :func:`decode_frame`). Frame 0's depth is
    read at construction to fix the size (``width``, ``height``); every
    frame must have it. The workers are threads (:class:`_Threads`)."""

    def __init__(self, rgb_paths: Sequence[Optional[str]],
                 depth_paths: Sequence[str], n_workers: int = 4,
                 capacity: int = 30, depth_scale: float = 1.0,
                 depth_clamp: float = 100.0):
        if len(rgb_paths) != len(depth_paths):
            raise ValueError("NativePrefetcher: one rgb path a depth path")
        self.num_frames = len(depth_paths)
        self.width = self.height = 0
        self._next = 0
        self._pool = None
        if not self.num_frames:
            return
        clib.library()        # build before the workers need it
        jobs = [(r or "", d) for r, d in zip(rgb_paths, depth_paths)]
        _, d0 = decode_frame("", jobs[0][1], depth_scale, depth_clamp)
        self.height, self.width = size = d0.shape
        n_workers, capacity = max(int(n_workers), 1), max(int(capacity), 2)
        self._pool = _Threads(
            lambda i: decode_frame(*jobs[i], depth_scale, depth_clamp, size),
            self.num_frames, n_workers, capacity)

    def next(self) -> Optional[Tuple[np.ndarray, np.ndarray, int]]:
        """(rgb (H, W, 3) uint8, depth (H, W) float32, index), or None at
        the end; raises (naming the file) where a frame failed."""
        if self._next >= self.num_frames or self._pool is None:
            return None
        i = self._next
        self._next += 1
        rgb, depth = self._pool.get(i)
        return rgb, depth, i

    def close(self):
        """Ends the workers, part-way through or not (a thread finishes
        the frame it decodes)."""
        if self._pool is not None:
            self._pool.close()
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


# ------------------------------------------------------------ async writer

class AsyncWriter:
    """Writes meshes, volumes and images on one background thread, in
    submission order (the JAX ``AsyncWriter``, ``native/runtime.py:
    258-312``). Each ``submit_*`` copies its arrays and returns; a write
    that fails counts an error (:meth:`wait`), its message kept in
    ``last_error``."""

    def __init__(self):
        self._jobs: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self.errors = 0
        self.last_error: Optional[str] = None
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while True:
            job = self._jobs.get()
            try:
                if job is None:
                    return
                job()
            except Exception as e:         # counted; the writer runs on
                with self._lock:
                    self.errors += 1
                    self.last_error = f"{type(e).__name__}: {e}"
            finally:
                self._jobs.task_done()

    def _submit(self, job: Callable) -> None:
        if self._thread is None:
            raise RuntimeError("AsyncWriter: closed")
        self._jobs.put(job)

    def submit_ply(self, path: str, vertices: np.ndarray,
                   normals: np.ndarray, triangles: np.ndarray) -> None:
        """:func:`~emfusion_tpu_torch.io.writers.write_ply`'s file."""
        from emfusion_tpu_torch.io.writers import write_ply
        v = np.array(vertices, np.float32)
        n = np.array(normals, np.float32)
        t = np.array(triangles, np.int64)
        self._submit(lambda: write_ply(path, v, n, t))

    def submit_volume(self, path: str, vol: np.ndarray,
                      voxel_size: float) -> None:
        """A (Z, Y, X) volume in the reference's binary format
        (:func:`~emfusion_tpu_torch.io.writers.write_volume_bin`)."""
        from emfusion_tpu_torch.io.writers import write_volume_bin
        v = np.array(vol, np.float32)
        rz, ry, rx = v.shape
        self._submit(lambda: write_volume_bin(path, v, (rx, ry, rz),
                                              voxel_size))

    def submit_png16(self, path: str, img: np.ndarray) -> None:
        im = np.array(img, np.uint16)
        self._submit(lambda: codecs.write_png(path, im))

    def submit_png8(self, path: str, img: np.ndarray) -> None:
        """An RGB image (H, W, 3) uint8."""
        im = np.array(img, np.uint8)
        im = im.reshape(im.shape[:2] + (3,))
        self._submit(lambda: codecs.write_png(path, im))

    def wait(self) -> int:
        """Blocks until every submitted write has landed; returns the
        errors so far."""
        if self._thread is not None:
            self._jobs.join()
        return self.errors

    def close(self) -> int:
        """Waits for the writes, ends the thread; returns the errors."""
        if self._thread is not None:
            self._jobs.put(None)
            self._thread.join()
            self._thread = None
        return self.errors

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
