"""The (obj, z) rank mesh of the sharded frame step.

Port of ``emfusion_tpu/distributed/mesh.py``. The JAX package places one
program's arrays on a 2-D device mesh and lets GSPMD partition it; here
the mesh is N processes, one SPMD program each, on a ``torch.distributed``
process group, and :mod:`~emfusion_tpu_torch.distributed.comm` states
every collective. Rank ``r`` sits at ``(i, j) = (r // nz, r % nz)`` of an
``(no, nz)`` mesh (:func:`mesh_shape`: z gets 2 when N is even, objects
the rest, as ``make_mesh`` there does):

  * **obj** (``i``): rank ``(i, j)`` holds the volumes (tsdf, weights,
    fg/bg counts) of the object slots ``[i K/no, (i+1) K/no)`` only, and
    runs their E-step samples, LMs, raycasts, fusion and lifecycle work;
    the slots' association images, poses, voxel sizes, flags and ids are
    replicated, and every per-slot result is all-gathered over the ``obj``
    group in slot order.
  * **z** (``j``): fusion writes only the background's planes
    ``[j Z/nz, (j+1) Z/nz)`` (K1's slab form). Reads go to a replicated
    read copy of the whole (Z, Y, X) pair, whose slab is a view; one
    in-place all-gather over the ``z`` group refreshes it after each
    fusion. So the E-step (K2), the camera LM and the raycast (K4) read
    what the one-card port reads, as GSPMD gathers the shards for
    sampling and raycasting in the JAX program.

Contiguous equal blocks, as ``NamedSharding`` cuts them: a Z or K that
does not divide raises. :data:`STATE_SHARDING` lists which fields are
sharded; :func:`shard_state` and :func:`gather_state` take a one-card
state apart and put it back together.

The processes: :func:`launch` starts N ranks on this host, each on its
own card under NCCL (``cuda:{LOCAL_RANK}``) or, by name, under gloo (all
on one card, or on the CPU); :func:`initialize_multihost` joins a group
from arguments or ``torchrun``'s variables. Nothing falls back: a failed
init raises, a rank that raises ends the launch.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from emfusion_tpu_torch.distributed import comm

DEFAULT_TIMEOUT_S = 600.0

# which PipelineState fields are sharded, on which mesh axis and dim
# (``state_shardings`` of the JAX package); everything else is replicated.
# The background pair is written by slab but kept whole on every rank as
# the read copy.
STATE_SHARDING = {
    "bg_tsdf": ("z", 0), "bg_weights": ("z", 0),
    "objs.tsdf": ("obj", 0), "objs.weights": ("obj", 0),
    "objs.fg_counts": ("obj", 0),
}


def mesh_shape(n: int) -> Tuple[int, int]:
    """(no, nz) of ``n`` ranks: z gets 2 when n is even, objects the rest
    (1 -> 1x1, 2 -> 1x2, 4 -> 2x2, 8 -> 4x2)."""
    if n < 1:
        raise ValueError(f"mesh_shape: {n} ranks")
    nz = 2 if n % 2 == 0 else 1
    return n // nz, nz


def _block(n: int, parts: int, idx: int, what: str) -> Tuple[int, int]:
    if n % parts:
        raise ValueError(f"{what} = {n} does not divide into {parts} equal "
                         "blocks over the mesh; choose a multiple")
    b = n // parts
    return idx * b, (idx + 1) * b


@dataclasses.dataclass
class Mesh:
    """This rank's place in the (obj, z) mesh and its groups."""
    shape: Tuple[int, int]          # (no, nz)
    rank: int
    device: torch.device
    backend: str
    obj: comm.Group                 # the ranks (., j): slot blocks
    z: comm.Group                   # the ranks (i, .): z-slabs
    world: comm.Group
    stats: comm.CommStats

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def coords(self) -> Tuple[int, int]:
        return self.rank // self.shape[1], self.rank % self.shape[1]

    def slab(self, Z: int) -> Tuple[int, int]:
        """This rank's background planes [z0, z1)."""
        return _block(Z, self.shape[1], self.coords[1], "the volume's Z")

    def slots(self, K: int) -> Tuple[int, int]:
        """The object slots [s0, s1) whose volumes this rank holds."""
        return _block(K, self.shape[0], self.coords[0], "max_objects")

    def owner(self, k: int, K: int) -> int:
        """The ``obj`` group rank that holds slot ``k``."""
        return k // (K // self.shape[0])


def initialize_multihost(coordinator: Optional[str] = None,
                         world_size: Optional[int] = None,
                         rank: Optional[int] = None,
                         backend: str = "nccl",
                         timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join a process group: ``coordinator`` ("host:port"), ``world_size``
    and ``rank``, or ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/
    ``RANK`` as ``torchrun`` sets them. Returns True when more than one
    rank takes part. Unlike the JAX function, which returns False on any
    error, a failed init raises: it is not a one-process run."""
    env = os.environ
    world_size = int(env.get("WORLD_SIZE", 1)) if world_size is None \
        else int(world_size)
    rank = int(env.get("RANK", 0)) if rank is None else int(rank)
    if coordinator is not None:
        init = f"tcp://{coordinator}"
    elif "MASTER_ADDR" in env:
        init = "env://"          # torchrun's store, or launch()'s address
    else:
        raise ValueError("initialize_multihost: no coordinator address "
                         "(pass one or set MASTER_ADDR/MASTER_PORT)")
    dist.init_process_group(
        backend, init_method=init, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    return world_size > 1


def rank_device(device=None, backend: Optional[str] = None) -> torch.device:
    """The device of this rank: the CPU when asked; under NCCL
    ``cuda:{LOCAL_RANK}`` (more ranks than cards raises); under gloo on a
    CUDA run, card ``LOCAL_RANK`` modulo the cards (ranks share them)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("emfusion_tpu_torch: no CUDA device is "
                           "available; pass device='cpu'")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()
                               if dist.is_initialized() else 0))
    n = torch.cuda.device_count()
    if (backend or "nccl") == "nccl" and local >= n:
        raise RuntimeError(f"rank {local} under NCCL needs card {local}, "
                           f"but {n} are visible (NCCL takes one rank a "
                           "card; name backend='gloo' to share one)")
    dev = torch.device("cuda", local % n)
    torch.cuda.set_device(dev)
    return dev


def make_mesh(n: Optional[int] = None, device=None,
              backend: Optional[str] = None) -> Mesh:
    """The (obj, z) mesh over the initialised process group (all of its
    ranks; ``n`` checks their number). ``device``/``backend`` as
    :func:`launch` takes them: the backend must be the group's."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group (launch() or "
                           "initialize_multihost() first)")
    world = dist.get_world_size()
    if n is not None and n != world:
        raise ValueError(f"make_mesh({n}) in a group of {world} ranks")
    dev = rank_device(device, backend)
    want = backend or ("gloo" if dev.type == "cpu" else "nccl")
    got = str(dist.get_backend())
    if got != want:
        raise RuntimeError(f"make_mesh: the group runs {got}, asked {want}")
    staged = dev.type == "cuda" and got == "gloo"
    shape = mesh_shape(world)
    from torch.distributed.device_mesh import init_device_mesh
    dm = init_device_mesh("cuda" if got == "nccl" else "cpu", shape,
                          mesh_dim_names=("obj", "z"))
    stats = comm.CommStats()
    return Mesh(shape=shape, rank=dist.get_rank(), device=dev, backend=got,
                obj=comm.make_group(dm.get_group("obj"), dev, staged, stats),
                z=comm.make_group(dm.get_group("z"), dev, staged, stats),
                world=comm.make_group(None, dev, staged, stats),
                stats=stats)


# ----------------------------------------------------------------------
# the state
def _pool_keys():
    """The pool fields :data:`STATE_SHARDING` shards over ``obj``."""
    return [k[len("objs."):] for k, (axis, _) in STATE_SHARDING.items()
            if axis == "obj"]


def shard_state(state, mesh: Mesh, K: int):
    """This rank's part of a one-card ``PipelineState`` with a ``K``-slot
    pool: the volumes of its slots (copies, so the rest can be freed);
    the background pair whole (the read copy) and the rest as they
    are."""
    s0, s1 = mesh.slots(K)
    o = state.objs
    for key in _pool_keys():
        t = getattr(o, key)
        if t.shape[0] == K:
            setattr(o, key, t[s0:s1].clone())
    return state


def gather_pool(pipe):
    """The whole pool of a sharded pipeline on every rank (an all-gather
    of the slot blocks over ``obj``); the pipeline's own pool without a
    mesh."""
    o = pipe.state.objs
    mesh = pipe.mesh
    if mesh is None:
        return o
    full = {}
    for key in _pool_keys():
        t = getattr(o, key)
        out = torch.empty((pipe.K,) + tuple(t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        full[key] = comm.all_gather_into(mesh.obj, out, t)
    return dataclasses.replace(o, **full)


def gather_state(pipe):
    """The whole ``PipelineState`` of a sharded pipeline (the background
    is whole on every rank already), on every rank."""
    return dataclasses.replace(pipe.state, objs=gather_pool(pipe))


# ----------------------------------------------------------------------
# the processes
def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(target: str, nprocs: int, args: Sequence = (), device=None,
           backend: Optional[str] = None, timeout_s: Optional[float] = 900.0,
           threads: Optional[int] = None, rank0_output: bool = False):
    """Run ``target`` ("module:function", called as ``fn(mesh, *args)``)
    on ``nprocs`` ranks of this host, each a new Python process joined on
    a free loopback port with :func:`make_mesh`. ``device``/``backend``:
    CUDA under NCCL (the default: one card a rank), CUDA under gloo (by
    name: the ranks share the cards, tensors staged through host memory)
    or the CPU under gloo. ``threads``: the intra-op threads of each rank.
    Returns every rank's return value, in rank order. If a rank fails,
    the others are ended and this raises with the rank's error output;
    past ``timeout_s`` (None: no limit) every rank is ended and it raises
    too. A collective that waits longer than ``DEFAULT_TIMEOUT_S`` (or
    ``timeout_s``, if shorter) raises in its rank. The ranks' output goes
    to files (``rank0_output``: rank 0 writes to this process's)."""
    dev = torch.device("cuda" if device is None else device)
    backend = backend or ("gloo" if dev.type == "cpu" else "nccl")
    port = free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [p for p in sys.path if p] + [env.get("PYTHONPATH", "")])
    with tempfile.TemporaryDirectory(prefix="emf_launch_") as tmp:
        spec = os.path.join(tmp, "spec.pkl")
        with open(spec, "wb") as f:
            pickle.dump(dict(target=target, args=tuple(args),
                             device=str(dev), backend=backend,
                             timeout_s=min(timeout_s or DEFAULT_TIMEOUT_S,
                                           DEFAULT_TIMEOUT_S),
                             threads=threads), f)
        procs, logs = [], []
        try:
            for r in range(nprocs):
                renv = dict(env, RANK=str(r), LOCAL_RANK=str(r),
                            WORLD_SIZE=str(nprocs), MASTER_ADDR="127.0.0.1",
                            MASTER_PORT=str(port))
                log = os.path.join(tmp, f"rank{r}.log")
                out = None if (rank0_output and r == 0) else open(log, "w")
                logs.append(log if out is not None else None)
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", __name__, spec, tmp],
                    env=renv, stdout=out, stderr=subprocess.STDOUT
                    if out is not None else None))
                if out is not None:
                    out.close()
            deadline = time.monotonic() + (timeout_s or float("inf"))
            while True:
                codes = [p.poll() for p in procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    r = _first_failure(tmp, nprocs, bad[0])
                    try:
                        code = procs[r].wait(timeout=10)
                    except subprocess.TimeoutExpired:
                        code = None
                    raise RuntimeError(
                        f"rank {r} of {nprocs} failed (exit {code}); "
                        f"the others were ended:\n{_tail(logs[r])}")
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"launch({target}): {nprocs} ranks still running "
                        f"after {timeout_s} s; ended")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
        results = []
        for r in range(nprocs):
            with open(os.path.join(tmp, f"result{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results


def _first_failure(tmp: str, nprocs: int, default: int) -> int:
    """The rank whose target raised first (the failure stamps that
    :func:`_rank_main` writes before it leaves the group, whose closing
    then fails the others' collectives), or ``default`` where no rank
    left one (a rank that died without raising)."""
    stamps = {}
    for r in range(nprocs):
        try:
            with open(os.path.join(tmp, f"failed{r}"), "r") as f:
                stamps[r] = float(f.read())
        except (OSError, ValueError):
            pass
    return min(stamps, key=stamps.get) if stamps else default


def _tail(log: Optional[str], n: int = 6000) -> str:
    if log is None:
        return "(its output went to this process's)"
    with open(log, errors="replace") as f:
        return f.read()[-n:]


def _rank_main(spec_path: str, tmp: str) -> None:
    """A rank's process: init the group, build the mesh, run the target,
    write its result."""
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    if spec["threads"]:
        torch.set_num_threads(spec["threads"])
    initialize_multihost(backend=spec["backend"],
                         timeout_s=spec["timeout_s"])
    try:
        mesh = make_mesh(device=spec["device"], backend=spec["backend"])
        module, name = spec["target"].split(":")
        import importlib
        fn = getattr(importlib.import_module(module), name)
        result = fn(mesh, *spec["args"])
        with open(os.path.join(tmp, f"result{mesh.rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
        dist.barrier()
    except BaseException:
        # stamped before the group closes: the launcher reports the rank
        # that failed first, not one whose collective its leaving broke
        with open(os.path.join(tmp, f"failed{dist.get_rank()}"), "w") as f:
            f.write(repr(time.time()))
        raise
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    # run the imported module's copy, so the rank's Mesh is the one its
    # target's imports see
    from emfusion_tpu_torch.distributed.mesh import _rank_main as _main
    _main(sys.argv[1], sys.argv[2])
