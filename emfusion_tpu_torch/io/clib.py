"""Build and bind the codecs' C library (``io/unfilter.c``).

The byte loops of the image decoders that numpy cannot vectorise: PNG's
row filters (Average and Paeth rows depend on the byte just
reconstructed) and OpenEXR's ZIP predictor. At first use the host C
compiler (``$CC``, else ``cc``, ``gcc``, ``clang`` or ``g++``: the one
``nvcc`` itself needs) builds the source into a shared library under
``emfusion_tpu_torch/build/`` (listed in ``.gitignore``), as
:func:`emfusion_tpu_torch.kernels.compile_shared` builds the CUDA
sources. It is loaded with ``ctypes``, whose calls release the
interpreter lock, so decode workers on threads run it in parallel. A
failed build raises: there is no numpy fallback (the numpy versions in
:mod:`~emfusion_tpu_torch.io.codecs` are the tests' reference).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading

import numpy as np

from emfusion_tpu_torch import kernels

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "unfilter.c")
CFLAGS = ("-O3", "-std=c99", "-fPIC", "-shared", "-Wall")

_lib = None
_lock = threading.Lock()


def _compiler() -> str:
    for name in (os.environ.get("CC"), "cc", "gcc", "clang", "g++"):
        path = name and shutil.which(name)
        if path:
            return path
    raise RuntimeError("no C compiler found (tried $CC, cc, gcc, clang, "
                       "g++): the codecs' C library cannot be built")


def build() -> str:
    """Compile the library unless it is built; returns its path. Raises
    with the compiler's output if the build fails."""
    so = kernels.library_path("unfilter", [SOURCE], CFLAGS)
    if not os.path.exists(so):
        kernels.compile_shared(
            [("unfilter", [_compiler(), *CFLAGS, "-x", "c", SOURCE], so)])
    return so


def library() -> ctypes.CDLL:
    """The loaded library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            p, n = ctypes.c_void_p, ctypes.c_long
            lib.emf_png_unfilter.argtypes = [p, n, n, ctypes.c_int, p]
            lib.emf_png_unfilter.restype = ctypes.c_int
            lib.emf_exr_unpredict.argtypes = [p, n, p]
            lib.emf_exr_unpredict.restype = None
            _lib = lib
        return _lib


def unfilter_png(raw: np.ndarray, h: int, stride: int,
                 bpp: int) -> np.ndarray:
    """PNG rows ``raw`` (uint8, ``h`` rows of a filter type byte and
    ``stride`` filtered bytes, as inflated) -> the (h, stride) image
    bytes. Raises on short data or a filter type above 4."""
    raw = np.ascontiguousarray(raw, np.uint8)
    if raw.size < h * (stride + 1):
        raise ValueError(f"PNG: {raw.size} bytes of image data, "
                         f"{h * (stride + 1)} needed")
    out = np.empty((h, stride), np.uint8)
    bad = library().emf_png_unfilter(raw.ctypes.data, h, stride, bpp,
                                     out.ctypes.data)
    if bad:
        raise ValueError(f"PNG: bad filter type in row {bad - 1}")
    return out


def exr_unpredict(d: np.ndarray) -> np.ndarray:
    """An inflated OpenEXR ZIP block -> its bytes (the predictor and the
    even / odd split undone)."""
    d = np.ascontiguousarray(d, np.uint8)
    out = np.empty_like(d)
    library().emf_exr_unpredict(d.ctypes.data, d.size, out.ctypes.data)
    return out
