"""RGB-D dataset readers with background prefetching.

Port of ``emfusion_tpu/io/readers.py`` (the reference's
``src/utils/RGBDReader.cpp``, ``TUMRGBDReader.cpp``, ``ImageReader.cpp``):
a producer thread keeps a bounded queue of decoded frames (about a second
of them) ahead of the consumer, so disk reads and the PNG / EXR decoding
(:mod:`emfusion_tpu_torch.io.codecs`, on zlib and numpy)
stay off the frame loop.

  * :class:`TUMReader` parses ``associations.txt`` and scales 16-bit depth
    by 1/5000 (``TUMRGBDReader.cpp:95-104``), deriving the frame rate from
    the timestamps (``:91-92``).
  * :class:`CoFusionReader` reads ``Color%04d.png`` / ``Depth%04d.exr``
    with the >100 m clamp and the start-index scan
    (``ImageReader.cpp:41-117``).
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
from typing import Iterator, Optional

import numpy as np

from emfusion_tpu_torch.io.codecs import read_exr, read_png


@dataclasses.dataclass
class RGBDFrame:
    rgb: Optional[np.ndarray]      # (H, W, 3) uint8 or None
    depth: np.ndarray              # (H, W) float32, metres, 0 = invalid
    index: int = 0
    timestamp: Optional[float] = None


def _rgb(path: str) -> Optional[np.ndarray]:
    img = read_png(path)
    if img is not None and img.ndim == 3:
        img = img[..., :3]
    return img


class _BufferedReader:
    """Producer-thread frame buffer (``RGBDReader::readerLoop``): the
    queue holds at most ``min_buffer`` decoded frames."""

    def __init__(self):
        self._queue: "queue.Queue[RGBDFrame]" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        self.num_frames = 0
        self.frame_rate = 30.0
        self.min_buffer = 30
        self._consumed = 0

    def _read_frame(self, index: int) -> RGBDFrame:
        raise NotImplementedError

    def init(self) -> None:
        raise NotImplementedError

    def _start(self, start_index: int = 0):
        self._next = start_index
        self._consumed = start_index
        self._stop = False

        def loop():
            while not self._stop and self._next < self.num_frames:
                if self._queue.qsize() >= self.min_buffer:
                    threading.Event().wait(0.005)
                    continue
                try:
                    frame = self._read_frame(self._next)
                except Exception as e:        # handed to the consumer
                    frame = e
                self._queue.put(frame)
                self._next += 1

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def peek(self) -> Optional[RGBDFrame]:
        """The first frame, read directly (not through the queue), to
        probe the frame size."""
        try:
            return self._read_frame(getattr(self, "start_index", 0))
        except Exception:
            return None

    def more_frames(self) -> bool:
        return self._consumed < self.num_frames

    def get_next_frame(self) -> RGBDFrame:
        frame = self._queue.get()
        self._consumed += 1
        if isinstance(frame, Exception):
            raise frame
        return frame

    def frames(self) -> Iterator[RGBDFrame]:
        while self.more_frames():
            yield self.get_next_frame()

    def close(self):
        self._stop = True
        if self._thread is not None:
            try:                      # drain, so the producer can exit
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=2.0)
            self._thread = None


class TUMReader(_BufferedReader):
    """TUM RGB-D benchmark sequences via ``associations.txt``."""

    DEPTH_SCALE = 1.0 / 5000.0

    def __init__(self, path: str):
        super().__init__()
        self.path = path.rstrip("/") + "/"
        self.pairs = []       # (timestamp, rgb_file, depth_file)

    def init(self):
        with open(os.path.join(self.path, "associations.txt")) as f:
            for line in f:
                parts = line.split()
                if len(parts) != 4:
                    continue
                ts = float(parts[0])
                if parts[1].startswith("rgb/"):
                    self.pairs.append((ts, parts[1], parts[3]))
                else:
                    self.pairs.append((ts, parts[3], parts[1]))
        self.num_frames = len(self.pairs)
        if self.num_frames > 1:
            span = self.pairs[-1][0] - self.pairs[0][0]
            if span > 0:
                self.frame_rate = self.num_frames / span
        self.min_buffer = max(int(round(self.frame_rate)), 1)
        self._start()

    def _read_frame(self, index):
        ts, rgb_f, depth_f = self.pairs[index]
        rgb = _rgb(os.path.join(self.path, rgb_f))
        raw = read_png(os.path.join(self.path, depth_f))
        if raw is None:
            raise RuntimeError(f"missing depth {depth_f}")
        depth = raw.astype(np.float32) * self.DEPTH_SCALE
        return RGBDFrame(rgb=rgb, depth=depth, index=index, timestamp=ts)


class CoFusionReader(_BufferedReader):
    """Co-Fusion sequences: ``colour_dir/Color%04d.png`` +
    ``depth_*/Depth%04d.exr``."""

    def __init__(self, path: str, colordir: str = "colour",
                 depthdir: str = "depth_noise"):
        super().__init__()
        self.colorpath = os.path.join(path, colordir)
        self.depthpath = os.path.join(path, depthdir)
        self.start_index = 0

    def init(self):
        rgbs = len([f for f in os.listdir(self.colorpath)
                    if f.endswith(".png")])
        depths = len([f for f in os.listdir(self.depthpath)
                      if f.endswith(".exr")])
        if rgbs != depths:
            raise RuntimeError("Different number of rgb and depth files!")
        idx = 0                       # the start index (ImageReader.cpp:66-95)
        while not (os.path.exists(self._rgb_path(idx))
                   and os.path.exists(self._depth_path(idx))):
            idx += 1
            if idx >= rgbs + 1000:
                raise RuntimeError("Could not find starting index!")
        self.start_index = idx
        self.num_frames = idx + rgbs
        self.min_buffer = int(self.frame_rate)
        self._start(start_index=idx)

    def _rgb_path(self, i):
        return os.path.join(self.colorpath, f"Color{i:04d}.png")

    def _depth_path(self, i):
        return os.path.join(self.depthpath, f"Depth{i:04d}.exr")

    def _read_frame(self, index):
        rgb = _rgb(self._rgb_path(index))
        depth = read_exr(self._depth_path(index))
        if depth is None:
            raise RuntimeError(f"missing depth {index}")
        if depth.ndim == 3:
            depth = depth[..., 0]
        depth = depth.astype(np.float32)
        depth[depth > 100.0] = 0.0     # ImageReader.cpp:116
        return RGBDFrame(rgb=rgb, depth=depth, index=index)


def make_reader(path: str, kind: Optional[str] = None,
                colordir: str = "colour", depthdir: str = "depth_noise"):
    """TUM when ``kind`` says so or the directory has an
    ``associations.txt``, else Co-Fusion (the reference app's -t / -d)."""
    if kind == "tum" or (kind is None and os.path.exists(
            os.path.join(path, "associations.txt"))):
        return TUMReader(path)
    return CoFusionReader(path, colordir, depthdir)
