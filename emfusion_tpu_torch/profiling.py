"""Per-phase timing of the pipeline.

Port of ``emfusion_tpu/profiling.py``'s :class:`PhaseTimer`, with the same
phase names. PyTorch queues GPU work and returns, so a host clock alone
would time the enqueue: on a CUDA device every phase synchronises the
device before its clock starts and before it stops, so each phase's time
is its device work (and the frame is serialised while timing). Each
phase is also a ``record_function`` range, so a ``torch.profiler`` trace
groups the device work by phase.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Dict

import torch

from emfusion_tpu_torch.device import resolve_device


class PhaseTimer:
    """Accumulates the time of each named phase."""

    def __init__(self, device=None):
        """``device`` as the entry points take it: ``None`` means the GPU
        (and raises without one); on a CPU device nothing is queued, so
        the host clock times the work itself."""
        self.device = resolve_device(device)
        self.totals: Dict[str, float] = collections.defaultdict(float)
        self.counts: Dict[str, int] = collections.defaultdict(int)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, name: str):
        """Time the block; it also shows as a range named ``name`` in a
        ``torch.profiler`` trace."""
        self._sync()
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(name):
                yield
        finally:
            self._sync()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def ms_per_call(self) -> Dict[str, float]:
        return {k: 1e3 * v / max(self.counts[k], 1)
                for k, v in self.totals.items()}
