"""Image codecs of the readers and writers: PNG and OpenEXR on numpy.

The decode and encode half of ``emfusion_tpu/native/runtime.py``, whose
native library links libpng, and of the ``cv2`` / ``imageio`` calls of the
JAX readers and writers. The port cannot count on any of those: the GPU
machine it runs on has neither ``cv2``, ``imageio`` nor PIL. So it carries
its own codecs, on ``zlib`` and numpy:

  * PNG decode: 8-bit gray, gray + alpha, RGB and RGBA, 16-bit gray and
    RGB, non-interlaced, every filter type. An image whose rows use only
    None, Sub and Up is reconstructed row by row, each row (and each run
    of Up rows) one vector operation; one with Average or Paeth rows is
    reconstructed along its anti-diagonals, each one vector operation
    over the rows (every filter reads only the left, upper and upper-left
    bytes).
  * PNG encode: 8-bit gray, RGB and RGBA and 16-bit gray, every row
    Up-filtered (a difference with the row above: one vector operation).
  * OpenEXR decode (the Co-Fusion depth, ``native/src/exr.cc``): single-
    part scanline files, NONE, ZIPS and ZIP compression, HALF, FLOAT and
    UINT channels, increasing line order.

:func:`read_png` and :func:`read_exr` always take this module's decoders,
on every machine; ``tests/test_torch_io.py`` holds the PNG decoder to
``cv2``'s pixels and the EXR decoder to the native runtime's.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


# ------------------------------------------------------------------ PNG
def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_rows(ftype, filt, bpp):
    """Rows filtered with None (0), Sub (1) or Up (2) only: a run of Up
    rows is one cumulative sum down the run (uint8 sums wrap as the
    filter's do)."""
    h, stride = filt.shape
    out = np.empty_like(filt)
    prev = np.zeros(stride, np.uint8)
    y = 0
    while y < h:
        t = ftype[y]
        if t == 2:
            end = y + 1
            while end < h and ftype[end] == 2:
                end += 1
            out[y:end] = np.cumsum(filt[y:end], axis=0, dtype=np.uint8) \
                + prev
            y = end
        else:
            f = filt[y]
            out[y] = f if t == 0 else np.cumsum(
                f.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
            y += 1
        prev = out[y - 1]
    return out


def _unfilter_wavefront(ftype, filt, bpp):
    """Any filters: pixel (y, x) needs only (y, x-1), (y-1, x) and
    (y-1, x-1), all on earlier anti-diagonals, so each anti-diagonal is
    one vector step over the rows."""
    h, stride = filt.shape
    w = stride // bpp
    f = filt.reshape(h, w, bpp).astype(np.int32)
    rec = np.zeros((h + 1, w + 1, bpp), np.int32)    # zero row and column
    t = ftype.astype(np.int32)
    for d in range(h + w - 1):
        ys = np.arange(max(0, d - w + 1), min(h, d + 1))
        xs = d - ys
        a = rec[ys + 1, xs]          # left
        b = rec[ys, xs + 1]          # up
        c = rec[ys, xs]              # up-left
        ty = t[ys][:, None]
        pred = np.where(ty == 1, a, np.where(ty == 2, b, np.where(
            ty == 3, (a + b) >> 1, np.where(ty == 4, _paeth(a, b, c), 0))))
        rec[ys + 1, xs + 1] = (f[ys, xs] + pred) & 255
    return rec[1:, 1:].astype(np.uint8).reshape(h, stride)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W) or (H, W, C) uint8 / uint16 (RGB order)."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    if ctype not in _PNG_CHANNELS or depth not in (8, 16) or interlace:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type "
                         f"{ctype}, interlace {interlace}")
    ch = _PNG_CHANNELS[ctype]
    bpp = ch * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = raw[:h * (w * bpp + 1)].reshape(h, w * bpp + 1)
    ftype, filt = rows[:, 0], rows[:, 1:]
    if ftype.max(initial=0) > 4:
        raise ValueError("PNG: bad filter type")
    if ftype.max(initial=0) <= 2:
        px = _unfilter_rows(ftype, filt, bpp)
    else:
        px = _unfilter_wavefront(ftype, filt, bpp)
    if depth == 16:
        px = px.view(">u2").astype(np.uint16)
    px = px.reshape(h, w, ch)
    return px[..., 0] if ch == 1 else px


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """(H, W) uint8 / uint16 or (H, W, 3|4) uint8 (RGB order) -> PNG
    bytes, every row Up-filtered."""
    img = np.ascontiguousarray(img)
    if img.dtype == np.uint16 and img.ndim == 2:
        depth, ctype = 16, 0
    elif img.dtype == np.uint8 and img.ndim == 2:
        depth, ctype = 8, 0
    elif img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] in (3, 4):
        depth, ctype = 8, 2 if img.shape[2] == 3 else 6
    else:
        raise ValueError(f"encode_png: {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    ch = _PNG_CHANNELS[ctype]
    bpp = ch * depth // 8
    if depth == 16:
        x = img.astype(">u2").view(np.uint8).reshape(h, w * bpp)
    else:
        x = img.reshape(h, w * bpp)
    filt = x.copy()
    filt[1:] -= x[:-1]                      # uint8 differences wrap
    rows = np.concatenate([np.full((h, 1), 2, np.uint8), filt], 1)
    return (PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                          0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def read_png(path: str) -> Optional[np.ndarray]:
    """A PNG file as (H, W) or (H, W, C) uint8 / uint16, RGB order; None
    if it does not exist."""
    try:
        with open(path, "rb") as f:
            return decode_png(f.read())
    except FileNotFoundError:
        return None


def write_png(path: str, img: np.ndarray) -> None:
    """Write (H, W) uint8 / uint16 or (H, W, 3|4) uint8 RGB(A) as PNG."""
    with open(path, "wb") as f:
        f.write(encode_png(img))


# ------------------------------------------------------------------ EXR
EXR_MAGIC = 20000630
_EXR_NONE, _EXR_ZIPS, _EXR_ZIP = 0, 2, 3
_EXR_TYPES = {0: np.dtype("<u4"), 1: np.dtype("<f2"), 2: np.dtype("<f4")}


def _exr_lines(compression: int) -> int:
    return 16 if compression == _EXR_ZIP else 1


def _zip_reconstruct(d: np.ndarray) -> np.ndarray:
    """Undo EXR's ZIP predictor (bytes as deltas + 128) and its split of
    the even and odd bytes into two halves."""
    d = d.astype(np.int64)
    d[1:] -= 128
    d = (np.cumsum(d) & 255).astype(np.uint8)
    out = np.empty_like(d)
    half = (len(d) + 1) // 2
    out[0::2] = d[:half]
    out[1::2] = d[half:]
    return out


def decode_exr(data: bytes) -> np.ndarray:
    """OpenEXR bytes -> (H, W) float32, or (H, W, C) with the channels in
    file (name) order."""
    magic, version = struct.unpack("<II", data[:8])
    if magic != EXR_MAGIC or version & 0x200:
        raise ValueError("not a scanline OpenEXR file")
    pos, channels, comp, box, order = 8, [], 0, None, 0

    def cstr(p):
        end = data.index(b"\0", p)
        return data[p:end].decode(), end + 1

    while True:
        name, pos = cstr(pos)
        if not name:
            break
        _, pos = cstr(pos)                           # attribute type
        size, = struct.unpack("<i", data[pos:pos + 4])
        body, pos = data[pos + 4:pos + 4 + size], pos + 4 + size
        if name == "channels":
            q = 0
            while body[q] != 0:
                end = body.index(b"\0", q)
                ptype, = struct.unpack("<i", body[end + 1:end + 5])
                channels.append(ptype)
                q = end + 17
        elif name == "compression":
            comp = body[0]
        elif name == "dataWindow":
            box = struct.unpack("<4i", body)
        elif name == "lineOrder":
            order = body[0]
    if not channels or box is None or order != 0 or comp not in (
            _EXR_NONE, _EXR_ZIPS, _EXR_ZIP):
        raise ValueError(f"unsupported OpenEXR: compression {comp}, line "
                         f"order {order}")
    xmin, ymin, xmax, ymax = box
    W, H, C = xmax - xmin + 1, ymax - ymin + 1, len(channels)
    lines = _exr_lines(comp)
    nblocks = -(-H // lines)
    offsets = np.frombuffer(data, "<u8", nblocks, pos)
    row_bytes = sum(W * _EXR_TYPES[t].itemsize for t in channels)
    out = np.empty((H, W, C), np.float32)
    for off in offsets:
        y, size = struct.unpack("<ii", data[int(off):int(off) + 8])
        y0 = y - ymin
        n = min(lines, H - y0)
        packed = np.frombuffer(data, np.uint8, size, int(off) + 8)
        raw_size = row_bytes * n
        if comp == _EXR_NONE or size >= raw_size:
            raw = packed[:raw_size]
        else:
            raw = _zip_reconstruct(np.frombuffer(
                zlib.decompress(packed.tobytes()), np.uint8))
        p = 0
        for line in range(n):
            for c, t in enumerate(channels):
                dt = _EXR_TYPES[t]
                nb = W * dt.itemsize
                out[y0 + line, :, c] = raw[p:p + nb].view(dt)
                p += nb
    return out[..., 0] if C == 1 else out


def read_exr(path: str) -> Optional[np.ndarray]:
    """An OpenEXR file as float32 (:func:`decode_exr`); None if it does
    not exist."""
    try:
        with open(path, "rb") as f:
            return decode_exr(f.read())
    except FileNotFoundError:
        return None
