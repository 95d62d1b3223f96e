"""The collectives of the sharded frame step, on ``torch.distributed``.

The JAX package has no counterpart: it annotates shardings and lets
GSPMD insert the collectives (``distributed/mesh.py`` there). PyTorch has
no partitioner, so the port states every collective it needs, on one
process group each (:class:`Group`):

  * :func:`all_gather_into`: every rank's block of rows into one tensor,
    in group-rank order (the z-slabs of the background's read copy, the
    object slots' E-step images, poses and raycast partials);
  * :func:`all_reduce`: SUM or MAX in place (the pixel-sharded LM's
    normal equations, trial errors and weight maximum);
  * :func:`broadcast`: from one group rank (a slot's owner sends what it
    computed on the slot's volume);
  * :func:`send` / :func:`recv`: point to point (the marching cubes' halo
    planes, the gathered mesh rows).

NCCL keeps CUDA tensors on the card; a host tensor is copied to the
rank's card for the call and back. Gloo reduces host tensors. CUDA
tensors go through gloo only when the caller named ``gloo`` for a CUDA
run (several ranks on one card: NCCL refuses two ranks on one device):
then each call stages them through host memory, in the open. A CUDA
tensor on a gloo group that was not asked for that raises. Bool tensors
travel as uint8.

Each group counts its calls per kind: calls, bytes received by this rank
(the bytes a collective brings in from the others, which is what its
link carries), and ms (CUDA events around the call on a CUDA device, the
host clock on the CPU), in :class:`CommStats`.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

KINDS = ("all_gather", "all_reduce", "broadcast", "send", "recv")
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


class CommStats:
    """Per kind of collective: calls, bytes received and ms, summed since
    the last :meth:`reset`. CUDA-event times are resolved when read."""

    def __init__(self):
        self.calls: Dict[str, int] = collections.Counter()
        self.bytes: Dict[str, int] = collections.Counter()
        self._ms: Dict[str, float] = collections.defaultdict(float)
        self._pending: List[tuple] = []

    def reset(self) -> None:
        self.calls.clear()
        self.bytes.clear()
        self._ms.clear()
        self._pending.clear()

    def add(self, kind: str, nbytes: int, start, end=None) -> None:
        """One call of ``kind``; ``start``/``end`` two recorded CUDA
        events, or ``start`` the host ms it took."""
        self.calls[kind] += 1
        self.bytes[kind] += int(nbytes)
        if end is None:
            self._ms[kind] += start
        else:
            self._pending.append((kind, start, end))

    def summary(self) -> Dict[str, dict]:
        """{kind: {calls, bytes, ms}} of the kinds that ran."""
        if self._pending:
            self._pending[-1][2].synchronize()
            for kind, s, e in self._pending:
                self._ms[kind] += s.elapsed_time(e)
            self._pending.clear()
        return {k: dict(calls=self.calls[k], bytes=self.bytes[k],
                        ms=self._ms[k]) for k in KINDS if self.calls[k]}


@dataclasses.dataclass
class Group:
    """One process group and how this rank talks on it. ``pg``: the group
    (None: the default group); ``size``/``rank``: the group's size and
    this rank's place in it; ``device``: the rank's compute device;
    ``staged``: gloo was named for CUDA tensors, which then go through
    host memory; ``stats``: where the calls are counted."""
    pg: Optional[object]
    size: int
    rank: int
    device: torch.device
    staged: bool
    stats: CommStats

    @property
    def backend(self) -> str:
        return str(dist.get_backend(self.pg))

    def global_rank(self, group_rank: int) -> int:
        return (group_rank if self.pg is None
                else dist.get_global_rank(self.pg, group_rank))


def make_group(pg, device: torch.device, staged: bool,
               stats: CommStats) -> Group:
    return Group(pg, dist.get_world_size(pg), dist.get_rank(pg), device,
                 staged, stats)


class _Transport:
    """The tensor a collective runs on, for ``t`` on this group: ``t``
    itself where the backend takes it; a copy on the rank's card (NCCL,
    host ``t``) or in host memory (gloo staged, CUDA ``t``) otherwise, of
    ``t``'s contents unless it is only an output (``load=False``);
    :meth:`back` copies a result into ``t``."""

    def __init__(self, g: Group, t: torch.Tensor, load: bool = True):
        self.t = t
        nccl = g.backend == "nccl"
        if nccl and not t.is_cuda:
            self.wire = t.to(g.device) if load else torch.empty_like(
                t, device=g.device)
        elif not nccl and t.is_cuda:
            if not g.staged:
                raise ValueError(
                    "CUDA tensor on a gloo group: name backend='gloo' for "
                    "a CUDA run to stage it through host memory, or run "
                    "NCCL")
            self.wire = t.cpu() if load else torch.empty_like(
                t, device="cpu")
        else:
            self.wire = t
        if self.wire.dtype == torch.bool:
            self.wire = self.wire.view(torch.uint8)

    def back(self) -> torch.Tensor:
        if self.wire.data_ptr() != self.t.data_ptr() or \
                self.wire.device != self.t.device:
            w = self.wire.view(torch.bool) if self.t.dtype == torch.bool \
                else self.wire
            self.t.copy_(w)
        return self.t


class _Timed:
    """Counts one call of ``kind`` on ``g`` with ``nbytes`` received."""

    def __init__(self, g: Group, kind: str, nbytes: int):
        self.g, self.kind, self.nbytes = g, kind, nbytes

    def __enter__(self):
        if self.g.device.type == "cuda":
            self.s = torch.cuda.Event(enable_timing=True)
            self.s.record(torch.cuda.current_stream(self.g.device))
        else:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is not None:
            return False
        if self.g.device.type == "cuda":
            e = torch.cuda.Event(enable_timing=True)
            e.record(torch.cuda.current_stream(self.g.device))
            self.g.stats.add(self.kind, self.nbytes, self.s, e)
        else:
            self.g.stats.add(self.kind, self.nbytes,
                             1e3 * (time.perf_counter() - self.t0))
        return False


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def all_gather_into(g: Group, out: torch.Tensor,
                    block: torch.Tensor) -> torch.Tensor:
    """Rows ``[r n, (r + 1) n)`` of ``out`` from group rank r's ``block``
    (n rows each); ``block`` may be this rank's rows of ``out`` itself
    (in place). Returns ``out``."""
    if out.shape[0] != g.size * block.shape[0] or \
            out.shape[1:] != block.shape[1:]:
        raise ValueError(f"all_gather_into: {tuple(block.shape)} blocks of "
                         f"{g.size} ranks into {tuple(out.shape)}")
    if g.size == 1:
        if block.data_ptr() != out.data_ptr():
            out.copy_(block)
        return out
    with _Timed(g, "all_gather", _nbytes(out) - _nbytes(block)):
        o, b = _Transport(g, out, load=False), _Transport(g, block)
        gather = getattr(dist, "all_gather_single", None) or \
            dist.all_gather_into_tensor
        gather(o.wire, b.wire.contiguous(), group=g.pg)
        o.back()
    return out


def all_reduce(g: Group, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """``t`` reduced over the group (``sum``, ``max`` or ``min``), in
    place on every rank; returns ``t``."""
    if g.size == 1:
        return t
    with _Timed(g, "all_reduce", (g.size - 1) * _nbytes(t)):
        w = _Transport(g, t)
        dist.all_reduce(w.wire, op=_OPS[op], group=g.pg)
        w.back()
    return t


def broadcast(g: Group, t: torch.Tensor, src: int) -> torch.Tensor:
    """Group rank ``src``'s ``t`` into ``t`` on every rank; returns it."""
    if g.size == 1:
        return t
    with _Timed(g, "broadcast", 0 if g.rank == src else _nbytes(t)):
        w = _Transport(g, t)
        dist.broadcast(w.wire, g.global_rank(src), group=g.pg)
        w.back()
    return t


def send(g: Group, t: torch.Tensor, dst: int) -> None:
    """``t`` to group rank ``dst`` (which calls :func:`recv`)."""
    with _Timed(g, "send", 0):
        w = _Transport(g, t.contiguous())
        dist.send(w.wire, g.global_rank(dst), group=g.pg)


def recv(g: Group, t: torch.Tensor, src: int) -> torch.Tensor:
    """Group rank ``src``'s :func:`send` into ``t``; returns ``t``."""
    with _Timed(g, "recv", _nbytes(t)):
        w = _Transport(g, t)
        dist.recv(w.wire, g.global_rank(src), group=g.pg)
        w.back()
    return t


def gather_rows(g: Group, t: torch.Tensor, dst: int = 0):
    """Every rank's ``t`` (rows of one width and dtype, their number free)
    at group rank ``dst``, as a list in group-rank order; None
    elsewhere. One all-gather of the row counts, then point to point."""
    n = torch.tensor([t.shape[0]], dtype=torch.int64)
    counts = all_gather_into(g, torch.zeros(g.size, dtype=torch.int64), n)
    if g.rank != dst:
        if t.shape[0]:
            send(g, t, dst)
        return None
    out = []
    for r in range(g.size):
        if r == dst:
            out.append(t)
            continue
        part = torch.empty((int(counts[r]),) + tuple(t.shape[1:]),
                           dtype=t.dtype, device=t.device)
        if part.shape[0]:
            recv(g, part, r)
        out.append(part)
    return out
