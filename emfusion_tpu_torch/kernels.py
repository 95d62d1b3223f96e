"""Build and bind the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/*.cu`` file holds kernels for Hopper (``sm_90a``) with plain
C entry points (``lm.cu`` five: ``lm_run``, ``lm_cluster``, and the
split ``lm_system``, ``lm_trial`` and ``lm_step``). At first use every
source is compiled by its own ``nvcc`` process, all started together, into a shared library under ``build/``
(listed in ``.gitignore``); the file name carries a hash of the sources
and flags, so an edit rebuilds. The libraries are loaded with ``ctypes``.
No PyTorch header is compiled, which keeps a cold build to seconds.

Volumes are float32 or bf16: K1-K3 take each work-table item's element
type in its ``bf16`` field, and K4 a ``bf16`` argument, so one K1 or K2
launch may mix the bf16 background with float32 object slots. A kernel
loads bf16 as float32, computes in float32 and rounds once, to nearest
even, where it stores a volume (K1) or copies the values as they are
(K3's cache); :func:`volume_dtype_code` checks the tensors' dtype.

The kernels are built with ``--fmad=false``: each product and sum rounds
on its own, as in the plain PyTorch versions beside the wrappers, so a
kernel and its plain version agree bit for bit on the same inputs (pixel
rounding and window anchors would otherwise move at boundaries).

``launches`` counts, per kernel, the launches that reached the card, and
``launches_by_shape`` the same launches per kernel and volume shape (for
the kernels that take volumes: a launch counts once under each shape it
touched, so the background's and an object's are apart);
:func:`launch` is the only place that adds to them. A launch runs
under the card that holds its tensors and on that card's current
stream, whatever card is current: :func:`check_cuda` checks that the
tensors share one card and returns it, and the wrapper hands it on.

K1 (fusion), K2 (sample) and K3 (capture) take a work table: a host
array of :class:`FuseArgs` / :class:`SampleArgs` / :class:`CaptureArgs`,
one per volume, which the C entry copies into the kernel's parameters, so
the background and every object slot take one launch
(:func:`launch_table`; more volumes than the sources' ``EMF_MAX_ITEMS``
take one launch per that many). The device-resident LM's kernels
(``lm.cu``) take a table of :class:`LmItemArgs`, one per LM, with the
state and buffers of :class:`LmBufsArgs` and the constants of
:class:`LmCfgArgs` (``tracking.LMRun`` builds them). ``lm_run`` is one
cooperative launch (``cudaLaunchCooperativeKernel``) for up to
``max_iter`` LM iterations of a table, its grid at most the blocks the
card holds at once (:func:`lm_run_blocks`); ``lm_cluster`` the same for
a table of cache items (they read K3's windows: the batched object LM's
stages, and the capture sampler's LMs, each of which leaves the launch
when its windows must be captured again) whose items fit a cluster
(``emf_lm_cluster_size`` above 0: at most 16 spans an item), one
thread-block cluster an LM (``cudaLaunchKernelEx``). A table of cache
items with a larger item (the capture camera LM's 34 spans) takes
``lm_run``; each kernel refuses the other's tables. The split kernels,
which the pixel-sharded LM
launches, count per phase: ``lm_system`` and ``lm_step`` two launches
an iteration, ``lm_trial`` one.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from collections import Counter

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler",
              "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_POSE = [_F] * 12   # r00 .. r22, t0, t1, t2

# kernel name -> (source, C entry, argument types without the stream)
KERNELS = {
    "fusion": ("fusion.cu", "emf_fusion",
               [_P, _I, _P, _I, _I] + [_F] * 4),
    "sample": ("sample.cu", "emf_sample", [_P, _I]),
    "capture": ("capture.cu", "emf_capture", [_P, _I]),
    "raycast": ("raycast.cu", "emf_raycast",
                [_P] * 6 + [_I] * 5 + _POSE + [_F] * 6 + [_I] * 2),
    "bilateral": ("bilateral.cu", "emf_bilateral",
                  [_P, _P, _P, _I, _I, _I, _F]),
    "warp": ("warp.cu", "emf_warp", [_P, _P] + [_I] * 4 + [_F] * 13
             + [_I] * 3),
    "lm_run": ("lm.cu", "emf_lm_run", [_P, _I, _I, _P, _P, _I]),
    "lm_cluster": ("lm.cu", "emf_lm_cluster", [_P, _I, _I, _P, _P]),
    "lm_system": ("lm.cu", "emf_lm_system", [_P, _I, _I, _P, _P]),
    "lm_trial": ("lm.cu", "emf_lm_trial", [_P, _I, _P, _P]),
    "lm_step": ("lm.cu", "emf_lm_step", [_I, _I, _P, _P]),
}

# a source's C helpers besides its kernels' entries and ``emf_max_items``
# (which takes nothing): source stem -> {entry: argument types}; each
# returns an int
HELPERS = {"lm": {"emf_lm_run_blocks": [_I, _I], "emf_lm_spans": [_I],
                  "emf_lm_cluster_size": [_I]},
           # K6's grid launched empty, for timing only (no path calls it)
           "warp": {"emf_warp_floor": KERNELS["warp"][2] + [_P]}}


class FuseArgs(ctypes.Structure):
    """One volume of a K1 launch (``EmfFuseItem`` in ``csrc/fusion.cu``)."""
    _fields_ = [("tsdf", _P), ("wts", _P), ("assoc", _P), ("Z", _I),
                ("Y", _I), ("X", _I), ("z0", _I), ("Zg", _I), ("vec", _I),
                ("bf16", _I),
                ("pose", _F * 12),
                ("vs", _F), ("trunc", _F), ("max_w", _F),
                ("carve_dist", _F), ("has_cap", _I), ("has_margin", _I),
                ("cap", _F), ("margin", _F)]


class SampleArgs(ctypes.Structure):
    """One volume of a K2 launch (``EmfSampleItem`` in ``csrc/sample.cu``).
    """
    _fields_ = [("vol", _P), ("counts", _P), ("pts", _P), ("out", _P),
                ("out_fg", _P), ("stride", _I), ("n", _I), ("Z", _I),
                ("Y", _I), ("X", _I), ("bf16", _I), ("pose", _F * 12),
                ("vs", _F), ("margin", _F)]


class CaptureArgs(ctypes.Structure):
    """One volume of a K3 launch (``EmfCaptureItem`` in
    ``csrc/capture.cu``)."""
    _fields_ = [("tsdf", _P), ("wts", _P), ("pts", _P), ("cache", _P),
                ("anchor", _P), ("n", _I), ("Z", _I), ("Y", _I), ("X", _I),
                ("bf16", _I), ("pose", _F * 12), ("vs", _F)]


class LmItemArgs(ctypes.Structure):
    """One LM of an ``lm.cu`` launch (``EmfLmItem``): a gather item, or
    with ``cached`` 1 a cache item that reads ``cache`` and ``anchor``
    (``bf16`` then the cache's type, ``cs`` its point stride)."""
    _fields_ = [("tsdf", _P), ("wts", _P), ("pts", _P), ("assoc", _P),
                ("cache", _P), ("anchor", _P),
                ("stride", _I), ("n", _I), ("Z", _I), ("Y", _I), ("X", _I),
                ("bf16", _I), ("vs", _F), ("p0", _I), ("cs", _I),
                ("cached", _I)]


class LmBufsArgs(ctypes.Structure):
    """The state and per-point buffers of an LM table (``EmfLmBufs``)."""
    _fields_ = [("si", _P), ("sf", _P), ("sys", _P), ("trial", _P),
                ("wmax", _P), ("w", _P), ("hub", _P), ("scratch", _P),
                ("part", _P), ("count", _P), ("total", _I)]


class LmCfgArgs(ctypes.Structure):
    """The LM's constants (``EmfLmCfg``); ``recaps``: a table of cache
    items' re-capture budget (0: the windows stay fixed)."""
    _fields_ = [("tau", _F), ("eps1", _F), ("eps2", _F), ("nu_init", _F),
                ("huber", _F), ("max_w", _F), ("max_iter", _I),
                ("recaps", _I)]


launches = {name: 0 for name in KERNELS}
launches_by_shape: Counter = Counter()   # (name, (Z, Y, X)) -> launches
build_log: dict = {}
_libs: dict = {}
_fns: dict = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
    launches_by_shape.clear()


def _nvcc() -> str:
    cands = [shutil.which("nvcc"),
             os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc")]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _source(name: str) -> str:
    """The stem of kernel ``name``'s source, which names its library."""
    return os.path.splitext(KERNELS[name][0])[0]


def library_path(stem: str, sources, flags) -> str:
    """Where the shared library ``stem``, built from ``sources`` with
    ``flags``, lives: under ``build/``, its name carrying a hash of both,
    so an edit rebuilds."""
    h = hashlib.sha1(" ".join(flags).encode())
    for path in sources:
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:16]}.so")


def compile_shared(jobs) -> dict:
    """Compile each ``(stem, command, so)`` of ``jobs`` (``command``: the
    compiler, its flags and the source) into the shared library ``so``,
    one process each, all started together. Each lands under a temporary
    name and is renamed into place, so no process loads half a file.
    Returns each stem's compiler output; raises with the output of those
    that failed."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for stem, cmd, so in jobs:
        tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
        procs.append((stem, so, tmp, subprocess.Popen(
            [*cmd, "-o", tmp], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    logs, failed = {}, []
    for stem, so, tmp, proc in procs:
        out, _ = proc.communicate()
        logs[stem] = out
        if proc.returncode != 0:
            failed.append(f"--- {stem} ---\n{out}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError(f"{os.path.basename(jobs[0][1][0])} failed:\n"
                           + "\n".join(failed))
    return logs


def _library_path(src: str) -> str:
    return library_path(src, [os.path.join(CSRC, f"{src}.cu")] + sorted(
        glob.glob(os.path.join(CSRC, "*.cuh"))), NVCC_FLAGS)


def build(names=None) -> float:
    """Compile the sources of the kernels ``names`` (default all) that are
    not built yet, one ``nvcc`` each, all at once; ``build_log`` keeps
    each source's compiler output under its stem. Returns the seconds it
    took; raises with the compiler's output if one fails."""
    names = list(KERNELS) if names is None else list(names)
    srcs = sorted({_source(n) for n in names})
    todo = [(src, _library_path(src)) for src in srcs]
    todo = [(src, so) for src, so in todo if not os.path.exists(so)]
    t0 = time.perf_counter()
    if not todo:
        return 0.0
    nvcc = _nvcc()
    build_log.update(compile_shared(
        [(src, [nvcc, *NVCC_FLAGS, os.path.join(CSRC, f"{src}.cu")], so)
         for src, so in todo]))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``'s source (built at first
    use); besides the kernels' entries it has helpers such as
    ``emf_max_items``."""
    src = _source(name)
    lib = _libs.get(src)
    if lib is None:
        so = _library_path(src)
        if not os.path.exists(so):
            build([name])
        lib = ctypes.CDLL(so)
        for entry, argtypes in HELPERS.get(src, {}).items():
            fn = getattr(lib, entry)
            fn.argtypes, fn.restype = argtypes, _I
        _libs[src] = lib
    return lib


def lm_run_blocks(device: torch.device, cache: bool = False) -> int:
    """The blocks of ``lm_run`` that ``device`` holds at once, the most
    its cooperative grid may have (``emf_lm_run_blocks``), for a table of
    gather items or, with ``cache``, of cache items."""
    dev = torch.device(device)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    return library("lm_run").emf_lm_run_blocks(index, int(cache))


def _fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(library(name), KERNELS[name][1])
        fn.argtypes = list(KERNELS[name][2]) + [_P]
        fn.restype = _I
        _fns[name] = fn
    return fn


def launch(name: str, *args, device: torch.device, shapes=()) -> None:
    """Launch kernel ``name`` on ``device``, the card that holds its
    tensors (:func:`check_cuda` returns it), under that card and on its
    current PyTorch stream, whatever card is current; count it, once
    under each distinct volume shape in ``shapes`` too (the shapes of the
    volumes the launch touched). Pointers are passed as
    ``tensor.data_ptr()``; raises if the launch was refused."""
    fn = _fn(name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name!r} failed to launch "
                           f"(cudaError {err})")
    launches[name] += 1
    for shape in {tuple(s) for s in shapes}:
        launches_by_shape[(name, shape)] += 1


def launch_table(name: str, table, *args, device: torch.device) -> None:
    """Launch work-table kernel ``name`` (K1, K2 or K3) over ``table``, a
    list of its ctypes items, followed by ``args``, on ``device``: one
    launch for as many items as the kernel's source takes
    (``emf_max_items``), each counted under the shapes of its items'
    volumes."""
    cap = library(name).emf_max_items()
    for i0 in range(0, len(table), cap):
        part = table[i0:i0 + cap]
        arr = (type(part[0]) * len(part))(*part)
        launch(name, ctypes.addressof(arr), len(part), *args,
               device=device, shapes=[(p.Z, p.Y, p.X) for p in part])


def check_cuda(name: str, *tensors: torch.Tensor, allow_bf16: bool = False,
               device=None) -> torch.device:
    """A kernel takes contiguous float32 (or int32/bool outputs) tensors
    on one CUDA device (``device`` where given, else the first tensor's),
    and bf16 ones where ``allow_bf16`` (volumes whose dtype
    :func:`volume_dtype_code` checked); anything else raises. Returns the
    device, on which the kernel launches (:func:`launch`)."""
    dev = tensors[0].device if device is None else torch.device(device)
    for t in tensors:
        if t.device != dev or not t.is_cuda:
            raise ValueError(f"{name}: all tensors must be on one CUDA "
                             f"device ({dev}), got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if t.dtype not in (torch.float32, torch.int32, torch.bool) and not (
                allow_bf16 and t.dtype == torch.bfloat16):
            raise ValueError(f"{name}: unsupported dtype {t.dtype}")
    return dev


def volume_dtype_code(name: str, *vols: torch.Tensor) -> int:
    """The ``bf16`` field of a kernel's volume item: 0 for float32
    volumes, 1 for bf16; the volumes must share one of the two dtypes,
    else this raises."""
    dt = vols[0].dtype
    if dt not in (torch.float32, torch.bfloat16) or any(
            v.dtype != dt for v in vols):
        raise ValueError(f"{name}: the kernel takes float32 or bf16 "
                         f"volumes of one dtype, got "
                         f"{[v.dtype for v in vols]}")
    return int(dt == torch.bfloat16)


def pose_args(rot, trans) -> list:
    """The 12 floats of a rigid transform as the kernels take them."""
    r = torch.as_tensor(rot, dtype=torch.float32).detach().cpu().reshape(9)
    t = torch.as_tensor(trans, dtype=torch.float32).detach().cpu().reshape(3)
    return [float(v) for v in r.tolist()] + [float(v) for v in t.tolist()]


def pose_array(rot, trans) -> ctypes.Array:
    """:func:`pose_args` as the ``pose`` field of a work-table item."""
    return (_F * 12)(*pose_args(rot, trans))
