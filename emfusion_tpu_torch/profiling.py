"""Per-phase timing of the pipeline.

Port of ``emfusion_tpu/profiling.py``'s :class:`PhaseTimer`, with the same
phase names and its ``summary()``. PyTorch queues GPU work and returns,
so a host clock alone would time the enqueue. Two modes:

  * ``sync`` (the default): on a CUDA device every phase synchronises the
    device before its clock starts and before it stops, so each phase's
    time is its work, device included (and the frame is serialised while
    timing);
  * ``events``: each phase records a CUDA event on the stream at its
    start and end, and the times are read when asked for, so timing does
    not serialise the run. A phase's time is then the stream's time
    between its two events: its device work and any wait of the stream
    for the host inside the phase. (The CLI reports in this mode.)

On a CPU device both modes use the host clock, which then times the
work itself. Each phase is also a ``record_function`` range, so a
``torch.profiler`` trace groups the device work by phase.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Dict, List, Tuple

import torch

from emfusion_tpu_torch.device import resolve_device

_MODES = ("sync", "events")


class PhaseTimer:
    """Accumulates the time of each named phase."""

    def __init__(self, device=None, mode: str = "sync"):
        """``device`` as the entry points take it: ``None`` means the GPU
        (and raises without one). ``mode``: ``sync`` or ``events``."""
        if mode not in _MODES:
            raise ValueError(f"PhaseTimer mode {mode!r}: one of {_MODES}")
        self.device = resolve_device(device)
        self.events = mode == "events" and self.device.type == "cuda"
        self.totals: Dict[str, float] = collections.defaultdict(float)
        self.counts: Dict[str, int] = collections.defaultdict(int)
        self._pending: List[Tuple[str, object, object]] = []

    def _sync(self):
        if self.device.type == "cuda" and not self.events:
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, name: str):
        """Time the block; it also shows as a range named ``name`` in a
        ``torch.profiler`` trace."""
        if self.events:
            stream = torch.cuda.current_stream(self.device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            try:
                with torch.profiler.record_function(name):
                    yield
            finally:
                end.record(stream)
                self.counts[name] += 1
                self._pending.append((name, start, end))
                if len(self._pending) >= 4096:
                    self._resolve()
            return
        self._sync()
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(name):
                yield
        finally:
            self._sync()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def _resolve(self):
        """Add the recorded event pairs to the totals (waits for the last
        one)."""
        if not self._pending:
            return
        self._pending[-1][2].synchronize()
        for name, start, end in self._pending:
            self.totals[name] += start.elapsed_time(end) / 1e3
        self._pending = []

    def ms_per_call(self) -> Dict[str, float]:
        self._resolve()
        return {k: 1e3 * v / max(self.counts[k], 1)
                for k, v in self.totals.items()}

    def summary(self) -> str:
        """One line per phase, the costliest first: total seconds, ms per
        call and calls (the JAX timer's format)."""
        self._resolve()
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            n = self.counts[name]
            tot = self.totals[name]
            lines.append(f"{name:>18}: {tot:7.2f}s total, "
                         f"{1e3 * tot / max(n, 1):8.2f} ms/call x{n}")
        return "\n".join(lines)
