"""RGB-D dataset readers with multi-worker prefetching.

Port of ``emfusion_tpu/io/readers.py`` (the reference's
``src/utils/RGBDReader.cpp``, ``TUMRGBDReader.cpp``, ``ImageReader.cpp``):
a :class:`~emfusion_tpu_torch.native.NativePrefetcher` keeps decode
workers (4) about a second of frames ahead of the consumer, delivered in
order, so disk reads and the PNG / EXR decoding stay off the frame loop,
as the JAX readers' native prefetcher does
(``emfusion_tpu/io/readers.py:101-110``).

  * :class:`TUMReader` parses ``associations.txt`` and scales 16-bit depth
    by 1/5000 (``TUMRGBDReader.cpp:95-104``), deriving the frame rate from
    the timestamps (``:91-92``).
  * :class:`CoFusionReader` reads ``Color%04d.png`` / ``Depth%04d.exr``
    with the >100 m clamp (NaN cleared too) and the start-index scan
    (``ImageReader.cpp:41-117``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, List, Optional

import numpy as np

from emfusion_tpu_torch.native import NativePrefetcher, decode_frame


@dataclasses.dataclass
class RGBDFrame:
    rgb: Optional[np.ndarray]      # (H, W, 3) uint8
    depth: np.ndarray              # (H, W) float32, metres, 0 = invalid
    index: int = 0
    timestamp: Optional[float] = None


class _BufferedReader:
    """Frames from a :class:`NativePrefetcher` over the sequence's files
    from ``start_index`` on (``RGBDReader::readerLoop``'s role), with a
    capacity of ``min_buffer`` frames (at least 4)."""

    DEPTH_SCALE = 1.0
    DEPTH_CLAMP = 1e30

    def __init__(self):
        self._pf: Optional[NativePrefetcher] = None
        self.num_frames = 0
        self.frame_rate = 30.0
        self.min_buffer = 30
        self.start_index = 0
        self._consumed = 0

    def _paths(self, index: int):
        """(rgb path, depth path) of frame ``index``."""
        raise NotImplementedError

    def _timestamp(self, index: int) -> Optional[float]:
        return None

    def init(self) -> None:
        raise NotImplementedError

    def _start(self):
        frames = range(self.start_index, self.num_frames)
        paths = [self._paths(i) for i in frames]
        self._pf = NativePrefetcher(
            [p[0] for p in paths], [p[1] for p in paths], n_workers=4,
            capacity=max(self.min_buffer, 4), depth_scale=self.DEPTH_SCALE,
            depth_clamp=self.DEPTH_CLAMP)
        self._consumed = self.start_index

    def _read_frame(self, index: int) -> RGBDFrame:
        """Frame ``index`` decoded here, not through the workers."""
        rgb, depth = decode_frame(*self._paths(index), self.DEPTH_SCALE,
                                  self.DEPTH_CLAMP)
        return RGBDFrame(rgb=rgb, depth=depth, index=index,
                         timestamp=self._timestamp(index))

    def peek(self) -> Optional[RGBDFrame]:
        """The first frame, read directly (not through the workers), to
        probe the frame size."""
        try:
            return self._read_frame(self.start_index)
        except (RuntimeError, IndexError):
            return None

    def more_frames(self) -> bool:
        return self._consumed < self.num_frames

    def get_next_frame(self) -> RGBDFrame:
        out = self._pf.next() if self._pf is not None else None
        if out is None:
            raise RuntimeError("get_next_frame: no frame left")
        rgb, depth, i = out
        idx = self.start_index + i
        self._consumed += 1
        return RGBDFrame(rgb=rgb, depth=depth, index=idx,
                         timestamp=self._timestamp(idx))

    def frames(self) -> Iterator[RGBDFrame]:
        while self.more_frames():
            yield self.get_next_frame()

    def close(self):
        if self._pf is not None:
            self._pf.close()
            self._pf = None


class TUMReader(_BufferedReader):
    """TUM RGB-D benchmark sequences via ``associations.txt``."""

    DEPTH_SCALE = 1.0 / 5000.0

    def __init__(self, path: str):
        super().__init__()
        self.path = path.rstrip("/") + "/"
        self.pairs: List[tuple] = []    # (timestamp, rgb_file, depth_file)

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

    def _paths(self, index):
        _, rgb_f, depth_f = self.pairs[index]
        return (os.path.join(self.path, rgb_f),
                os.path.join(self.path, depth_f))

    def _timestamp(self, index):
        return self.pairs[index][0]


class CoFusionReader(_BufferedReader):
    """Co-Fusion sequences: ``colour_dir/Color%04d.png`` +
    ``depth_*/Depth%04d.exr``."""

    DEPTH_CLAMP = 100.0                 # ImageReader.cpp:116

    def __init__(self, path: str, colordir: str = "colour",
                 depthdir: str = "depth_noise"):
        super().__init__()
        self.colorpath = os.path.join(path, colordir)
        self.depthpath = os.path.join(path, depthdir)

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
        self._start()

    def _rgb_path(self, i):
        return os.path.join(self.colorpath, f"Color{i:04d}.png")

    def _depth_path(self, i):
        return os.path.join(self.depthpath, f"Depth{i:04d}.exr")

    def _paths(self, index):
        return self._rgb_path(index), self._depth_path(index)


def make_reader(path: str, kind: Optional[str] = None,
                colordir: str = "colour", depthdir: str = "depth_noise"):
    """TUM when ``kind`` says so or the directory has an
    ``associations.txt``, else Co-Fusion (the reference app's -t / -d)."""
    if kind == "tum" or (kind is None and os.path.exists(
            os.path.join(path, "associations.txt"))):
        return TUMReader(path)
    return CoFusionReader(path, colordir, depthdir)
