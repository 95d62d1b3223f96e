"""Image codecs of the readers and writers: PNG and OpenEXR on numpy.

The decode and encode half of ``emfusion_tpu/native/runtime.py``, whose
native library links libpng, and of the ``cv2`` / ``imageio`` calls of the
JAX readers and writers. The port cannot count on any of those: the GPU
machine it runs on has neither ``cv2``, ``imageio`` nor PIL. So it carries
its own codecs, on ``zlib`` and numpy:

  * PNG decode: 8-bit gray, gray + alpha, RGB and RGBA, 16-bit gray and
    RGB, non-interlaced, every filter type: ``zlib`` inflates, and the
    rows are reconstructed by a C loop (``io/unfilter.c``, built at first
    use by :mod:`~emfusion_tpu_torch.io.clib`; :func:`decode_png`).
    :func:`decode_png_plain` is its numpy twin, which the tests hold it
    to: an image whose rows use only None, Sub and Up row by row, each
    row (and each run of Up rows) one vector operation; one with Average
    or Paeth rows (as libpng's adaptive filters write) along its
    anti-diagonals, each one vector operation over the rows (every
    filter reads only the left, upper and upper-left bytes) -- a Python
    loop over ~1,100 anti-diagonals at 640x480.
  * PNG encode: 8-bit gray, RGB and RGBA and 16-bit gray, every row
    Up-filtered (a difference with the row above: one vector operation).
  * OpenEXR decode (the Co-Fusion depth, ``native/src/exr.cc``): single-
    part scanline files, NONE, ZIPS and ZIP compression, HALF, FLOAT and
    UINT channels, increasing line order; ZIP blocks un-predicted by the
    same C library (:func:`_zip_reconstruct` is the numpy twin).
  * OpenEXR encode (the native writer's ``write_exr``): one float channel
    ``Z``, NONE or ZIP, FLOAT or HALF, the header and blocks of
    ``native/src/exr.cc``'s writer.
  * JPEG encode (the live viewer's MJPEG stream, which the JAX viewer
    encodes with PIL at quality 85): baseline, 8-bit gray or YCbCr 4:4:4,
    the IJG quality scaling of the Annex K tables, one 8x8 DCT matrix
    product for all blocks, and the Huffman bits of every block packed in
    a few vector operations.

:func:`read_png` and :func:`read_exr` always take this module's decoders,
on every machine; ``tests/test_torch_io.py`` holds the PNG decoder to
``cv2``'s pixels and the EXR decoder to the JAX native runtime's, and
``tests/test_torch_native.py`` the C loops to their numpy twins.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np

from emfusion_tpu_torch.io import clib

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


def unfilter_plain(ftype: np.ndarray, filt: np.ndarray,
                   bpp: int) -> np.ndarray:
    """The numpy twin of the C unfilter: (h,) filter types and (h,
    stride) filtered bytes -> the image bytes."""
    if ftype.max(initial=0) > 4:
        raise ValueError("PNG: bad filter type")
    if ftype.max(initial=0) <= 2:
        return _unfilter_rows(ftype, filt, bpp)
    return _unfilter_wavefront(ftype, filt, bpp)


def _png_rows(data: bytes):
    """PNG bytes -> (the inflated rows, h, w, bit depth, channels)."""
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
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    return raw, h, w, depth, _PNG_CHANNELS[ctype]


def _png_pixels(px: np.ndarray, h: int, w: int, depth: int, ch: int):
    if depth == 16:
        px = px.view(">u2").astype(np.uint16)
    px = px.reshape(h, w, ch)
    return px[..., 0] if ch == 1 else px


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W) or (H, W, C) uint8 / uint16 (RGB order); the
    rows reconstructed by the C loop (:func:`clib.unfilter_png`)."""
    raw, h, w, depth, ch = _png_rows(data)
    bpp = ch * depth // 8
    return _png_pixels(clib.unfilter_png(raw, h, w * bpp, bpp), h, w, depth,
                       ch)


def decode_png_plain(data: bytes) -> np.ndarray:
    """:func:`decode_png` with the rows reconstructed by numpy
    (:func:`unfilter_plain`): the tests' reference."""
    raw, h, w, depth, ch = _png_rows(data)
    bpp = ch * depth // 8
    if raw.size < h * (w * bpp + 1):
        raise ValueError("PNG: short image data")
    rows = raw[:h * (w * bpp + 1)].reshape(h, w * bpp + 1)
    return _png_pixels(unfilter_plain(rows[:, 0], rows[:, 1:], bpp), h, w,
                       depth, ch)


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


# ------------------------------------------------------------------ JPEG
# Annex K.1 quantisation tables, raster order
_Q_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_Q_CHROMA = np.full(64, 99)
_Q_CHROMA[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]
# Annex K.3 / K.5 luminance Huffman tables (code counts by length 1-16,
# then the symbols by code): the AC symbols after the first 37 are the
# remaining ones in increasing order. Every component uses them.
_DC_BITS = (0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0)
_DC_VALS = tuple(range(12))
_AC_BITS = (0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125)
_AC_HEAD = (0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31,
            0x41, 0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32,
            0x81, 0x91, 0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52,
            0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72, 0x82)
_AC_VALS = _AC_HEAD + tuple(sorted(
    ({0x00, 0xF0} | {(r << 4) | z for r in range(16) for z in range(1, 11)})
    - set(_AC_HEAD)))
_EOB, _ZRL = 0x00, 0xF0


def _zigzag() -> np.ndarray:
    """The raster index (row * 8 + column) of each zigzag position."""
    cells = sorted(((r, c) for r in range(8) for c in range(8)),
                   key=lambda rc: (rc[0] + rc[1],
                                   rc[0] if (rc[0] + rc[1]) % 2 else -rc[0]))
    return np.array([r * 8 + c for r, c in cells])


def _dct_matrix() -> np.ndarray:
    """The orthonormal 8-point DCT-II ``D``: ``D @ block @ D.T`` is the
    JPEG forward DCT of an 8x8 block."""
    k = np.arange(8)
    d = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16)
    d *= np.where(k == 0, np.sqrt(1 / 8), np.sqrt(2 / 8))[:, None]
    return d


def _huffman(bits, vals):
    """Canonical codes and lengths of a table, indexed by symbol."""
    codes = np.zeros(256, np.int64)
    lens = np.zeros(256, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            codes[vals[k]], lens[vals[k]] = code, length
            code, k = code + 1, k + 1
        code <<= 1
    return codes, lens


_ZZ = _zigzag()
_DCT2 = np.ascontiguousarray(np.kron(_dct_matrix(), _dct_matrix()).T)
_DC_CODES = _huffman(_DC_BITS, _DC_VALS)
_AC_CODES = _huffman(_AC_BITS, _AC_VALS)


def _quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """IJG scaling of a base table to ``quality`` (1-100)."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return np.clip((base * scale + 50) // 100, 1, 255)


def _magnitude(v: np.ndarray):
    """(size category, value bits) of JPEG coefficients: the bit length
    of |v|, and v, or v + 2^size - 1 where it is negative."""
    size = np.frexp(np.abs(v).astype(np.float64))[1].astype(np.int64)
    return size, np.where(v < 0, v + (1 << size) - 1, v)


def _pack_bits(codes: np.ndarray, lens: np.ndarray) -> bytes:
    """Concatenate the codes (most significant bit first), pad the last
    byte with 1 bits and stuff a 0 after every 0xFF byte."""
    total = int(lens.sum())
    item = np.repeat(np.arange(len(lens)), lens)
    pos = np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens)
    bits = (codes[item] >> (lens[item] - 1 - pos)) & 1
    bits = np.concatenate([bits, np.ones((-total) % 8, np.int64)])
    data = np.packbits(bits.astype(np.uint8))
    return np.insert(data, np.nonzero(data == 0xFF)[0] + 1, 0).tobytes()


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">HH", marker, len(body) + 2) + body


def encode_jpeg(img: np.ndarray, quality: int = 85) -> bytes:
    """(H, W) gray or (H, W, 3) RGB uint8 -> baseline JPEG bytes (JFIF;
    YCbCr without chroma subsampling)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (
            img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"encode_jpeg: {img.dtype} {img.shape}")
    H, W = img.shape[:2]
    x = img.astype(np.float64)
    if img.ndim == 2:
        planes = x[None]
    else:
        r, g, b = x[..., 0], x[..., 1], x[..., 2]
        planes = np.stack([
            0.299 * r + 0.587 * g + 0.114 * b,
            -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0,
            0.5 * r - 0.418688 * g - 0.081312 * b + 128.0])
    C = planes.shape[0]
    Hp, Wp = -(-H // 8) * 8, -(-W // 8) * 8
    planes = np.pad(planes, ((0, 0), (0, Hp - H), (0, Wp - W)), mode="edge")
    # (blocks in raster order, component, 64): the MCUs of a 4:4:4 scan;
    # the DCT of a row-major flattened block is one product with
    # kron(D, D)^T
    blocks = (planes - 128.0).reshape(C, Hp // 8, 8, Wp // 8, 8) \
        .transpose(1, 3, 0, 2, 4).reshape(-1, 64)
    coef = (blocks @ _DCT2).reshape(-1, C, 64)
    tables = [_quant_table(_Q_LUMA, quality),
              _quant_table(_Q_CHROMA, quality)]
    qt = np.stack([tables[min(c, 1)] for c in range(C)])       # (C, 64)
    zz = np.rint(coef / qt[None]).astype(np.int64)
    zz = zz[..., _ZZ]                          # (blocks, C, 64) zigzag
    dc = zz[..., 0]
    diff = (dc - np.concatenate([np.zeros((1, C), np.int64), dc[:-1]]))
    zz = zz.reshape(-1, 64)                    # blocks in scan order
    B = zz.shape[0]
    # DC items
    size, vbits = _magnitude(diff.reshape(-1))
    dc_code = (_DC_CODES[0][size] << size) | vbits
    dc_len = _DC_CODES[1][size] + size
    dc_key = np.arange(B) * 1024
    # AC items: each nonzero coefficient after its run of zeros (a ZRL
    # item per 16 zeros), then EOB where the block ends in zeros
    blk, k = np.nonzero(zz[:, 1:])
    pos = k + 1
    first = np.concatenate([[True], blk[1:] != blk[:-1]])
    prev = np.where(first, 0, np.concatenate([[0], pos[:-1]]))
    run = pos - prev - 1
    nzrl = run >> 4
    size, vbits = _magnitude(zz[blk, pos])
    sym = ((run & 15) << 4) | size
    ac_code = (_AC_CODES[0][sym] << size) | vbits
    ac_len = _AC_CODES[1][sym] + size
    ac_key = blk * 1024 + pos * 4 + nzrl
    zrl_of = np.repeat(np.arange(len(pos)), nzrl)
    zrl_j = np.arange(len(zrl_of)) - np.repeat(np.cumsum(nzrl) - nzrl, nzrl)
    zrl_key = blk[zrl_of] * 1024 + pos[zrl_of] * 4 + zrl_j
    eob_blk = np.nonzero(zz[:, 63] == 0)[0]
    eob_key = eob_blk * 1024 + 256
    n_zrl, n_eob = len(zrl_key), len(eob_key)
    keys = np.concatenate([dc_key, ac_key, zrl_key, eob_key])
    codes = np.concatenate([dc_code, ac_code,
                            np.full(n_zrl, _AC_CODES[0][_ZRL]),
                            np.full(n_eob, _AC_CODES[0][_EOB])])
    lens = np.concatenate([dc_len, ac_len,
                           np.full(n_zrl, _AC_CODES[1][_ZRL]),
                           np.full(n_eob, _AC_CODES[1][_EOB])])
    order = np.argsort(keys, kind="stable")
    scan = _pack_bits(codes[order], lens[order])

    dqt = b"".join(bytes([i]) + tables[i][_ZZ].astype(np.uint8).tobytes()
                   for i in range(min(C, 2)))
    sof = struct.pack(">BHHB", 8, H, W, C) + b"".join(
        bytes([c + 1, 0x11, min(c, 1)]) for c in range(C))
    dht = (bytes([0x00]) + bytes(_DC_BITS) + bytes(_DC_VALS)
           + bytes([0x10]) + bytes(_AC_BITS) + bytes(_AC_VALS))
    sos = bytes([C]) + b"".join(bytes([c + 1, 0x00]) for c in range(C)) \
        + bytes([0, 63, 0])
    return (b"\xff\xd8"
            + _segment(0xFFE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01"
                       b"\x00\x00")
            + _segment(0xFFDB, dqt) + _segment(0xFFC0, sof)
            + _segment(0xFFC4, dht) + _segment(0xFFDA, sos)
            + scan + b"\xff\xd9")


# ------------------------------------------------------------------ EXR
EXR_MAGIC = 20000630
_EXR_NONE, _EXR_ZIPS, _EXR_ZIP = 0, 2, 3
_EXR_TYPES = {0: np.dtype("<u4"), 1: np.dtype("<f2"), 2: np.dtype("<f4")}


def _exr_lines(compression: int) -> int:
    return 16 if compression == _EXR_ZIP else 1


def _zip_reconstruct(d: np.ndarray) -> np.ndarray:
    """Undo EXR's ZIP predictor (bytes as deltas + 128) and its split of
    the even and odd bytes into two halves: the numpy twin of the C
    ``emf_exr_unpredict`` that :func:`decode_exr` calls."""
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
            raw = clib.exr_unpredict(np.frombuffer(
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


def _half_bits(img: np.ndarray) -> np.ndarray:
    """float32 -> IEEE half bits as the native writer converts them
    (``exr.cc``'s ``float_to_half``): the mantissa truncated, a result
    below the normal range flushed to zero (signed), anything beyond it
    (NaN too) to infinity."""
    bits = img.view(np.uint32)
    sign = (bits >> 16) & 0x8000
    exp = ((bits >> 23) & 0xFF).astype(np.int32) - 112
    man = (bits & 0x7FFFFF) >> 13
    half = np.where(exp <= 0, sign, np.where(
        exp >= 31, sign | 0x7C00,
        sign | (np.clip(exp, 0, 31).astype(np.uint32) << 10) | man))
    return half.astype("<u2")


def encode_exr(img: np.ndarray, compression: int = _EXR_ZIP,
               as_half: bool = False) -> bytes:
    """(H, W) float32 -> a scanline OpenEXR file with one channel ``Z``,
    NONE (0) or ZIP (3, 16 lines a block, deflate level 6) compression,
    FLOAT or HALF samples: the header, block order and payload choice of
    the native writer (``native/src/exr.cc``)."""
    if compression not in (_EXR_NONE, _EXR_ZIP):
        raise ValueError(f"encode_exr: compression {compression} (NONE 0 "
                         f"or ZIP 3)")
    img = np.ascontiguousarray(img, np.float32)
    if img.ndim != 2:
        raise ValueError(f"encode_exr: an (H, W) image, got {img.shape}")
    H, W = img.shape

    def attr(name, kind, body):
        return (name.encode() + b"\0" + kind.encode() + b"\0"
                + struct.pack("<i", len(body)) + body)

    box = struct.pack("<4i", 0, 0, W - 1, H - 1)
    head = (struct.pack("<II", EXR_MAGIC, 2)
            + attr("channels", "chlist", b"Z\0" + struct.pack(
                "<iiii", 1 if as_half else 2, 0, 1, 1) + b"\0")
            + attr("compression", "compression", bytes([compression]))
            + attr("dataWindow", "box2i", box)
            + attr("displayWindow", "box2i", box)
            + attr("lineOrder", "lineOrder", b"\0")
            + attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
            + attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0))
            + attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
            + b"\0")
    pix = _half_bits(img) if as_half else img.astype("<f4")
    lines = _exr_lines(compression)
    nblocks = -(-H // lines)
    blocks, offsets = [], []
    pos = len(head) + 8 * nblocks
    for y0 in range(0, H, lines):
        raw = pix[y0:y0 + lines].tobytes()
        payload = raw
        if compression == _EXR_ZIP:
            d = np.frombuffer(raw, np.uint8)
            d = np.concatenate([d[0::2], d[1::2]]).astype(np.int64)
            d[1:] = (d[1:] - d[:-1] + 128) & 255
            packed = zlib.compress(d.astype(np.uint8).tobytes(), 6)
            if len(packed) < len(raw):
                payload = packed
        blk = struct.pack("<ii", y0, len(payload)) + payload
        offsets.append(pos)
        pos += len(blk)
        blocks.append(blk)
    return head + np.asarray(offsets, "<u8").tobytes() + b"".join(blocks)
