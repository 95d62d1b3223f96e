"""The device's trace: what ran on the card, and when it sat idle.

A span of whole frames runs under ``torch.profiler`` with the device's
activity only (tracing the host's ops too costs minutes a span and says
nothing about the card). The profiler's Chrome trace is written to a
temporary file under ``TMPDIR``, read back and deleted. From it:

* the device's operations: kernels, copies and sets, each an interval;
* ``busy_s``: the union of those intervals (overlaps counted once);
* the idle gaps between them, each named by what the host was doing at
  the gap's middle: the pipeline phase whose span (the host clock at the
  phase's start and end, :meth:`Span.watch`) holds it, or ``a->b``
  between two phases. The profiler gives device and host events one
  clock; the host clock that matches it (``time.time_ns`` or
  ``time.monotonic_ns``, the one within a second of the trace's first
  host event at the span's start) places the phases on it;
* the operations that took most time, by name.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import tempfile
import time
from typing import List, Tuple

_WORK = ("kernel", "gpu_memcpy", "gpu_memset")


class Span:
    """Profile the device over the frames run inside ``with``; the host's
    wall clock of the span, from a synchronised start to a synchronised
    end, is ``wall_s``."""

    def __init__(self, torch):
        self.torch = torch
        self.events: List[dict] = []
        self.notes: List[dict] = []      # phases: name, ts, dur (us)
        self.marks: List[tuple] = []     # phases: name, (real, mono) ns
        self.clock = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        self.torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.host0 = (time.time_ns(), time.monotonic_ns())
        self.t0 = time.perf_counter()
        return self

    def watch(self, timer):
        """Record the host clock at each phase of ``timer`` (a
        ``PhaseTimer``) until :meth:`unwatch`."""
        inner = timer.phase
        marks = self.marks

        @contextlib.contextmanager
        def phase(name):
            a = (time.time_ns(), time.monotonic_ns())
            with inner(name):
                yield
            marks.append((name, a, (time.time_ns(), time.monotonic_ns())))
        timer.phase = phase

    @staticmethod
    def unwatch(timer):
        del timer.phase

    def __exit__(self, *exc):
        self.torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)
        return False

    def read(self):
        """Read the trace (after the span; it takes seconds)."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
        finally:
            os.unlink(path)
        self.cats = collections.Counter()
        host = []
        for ev in trace.get("traceEvents", []):
            if ev.get("ph") != "X" or "dur" not in ev:
                continue
            cat = ev.get("cat", "")
            self.cats[cat] += 1
            rec = dict(name=ev.get("name", ""), ts=float(ev["ts"]),
                       dur=float(ev["dur"]))
            if cat in _WORK:
                self.events.append(rec)
            elif cat == "cuda_runtime":
                host.append(rec["ts"])
        self.events.sort(key=lambda e: e["ts"])
        base = trace.get("baseTimeNanoseconds")
        if base is not None and host:
            first = float(base) + 1e3 * min(host)
            for c in (0, 1):                       # real, then monotonic
                if abs(first - self.host0[c]) < 1e9:
                    self.clock = c
                    break
        if self.clock is not None:
            c = self.clock
            self.notes = [dict(name=n, ts=(a[c] - float(base)) / 1e3,
                               dur=(b[c] - a[c]) / 1e3)
                          for n, a, b in self.marks]
            self.notes.sort(key=lambda e: e["ts"])
        return self


def union(events) -> List[Tuple[float, float]]:
    """The merged (start, end) intervals (us) of ``events``."""
    out: List[List[float]] = []
    for e in sorted(events, key=lambda e: e["ts"]):
        s, t = e["ts"], e["ts"] + e["dur"]
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return [(s, t) for s, t in out]


def busy_seconds(events) -> float:
    return sum(t - s for s, t in union(events)) / 1e6


def _phase_at(notes, t: float) -> str:
    before = after = None
    for n in notes:
        if n["ts"] <= t <= n["ts"] + n["dur"]:
            return n["name"]
        if n["ts"] + n["dur"] < t:
            before = n["name"]
        elif after is None and n["ts"] > t:
            after = n["name"]
    return f"{before}->{after}"


def idle_gaps(events, notes, top: int = 10):
    """The ``top`` longest gaps between the device's busy intervals, as
    [name, seconds]."""
    iv = union(events)
    gaps = [(iv[i + 1][0] - iv[i][1], (iv[i][1] + iv[i + 1][0]) / 2)
            for i in range(len(iv) - 1)]
    gaps.sort(reverse=True)
    return [[_phase_at(notes, mid), g / 1e6] for g, mid in gaps[:top]]


def top_ops(events, top: int = 10):
    """The ``top`` device operations by their summed time, as
    [name, seconds]."""
    tot = collections.defaultdict(float)
    for e in events:
        tot[e["name"]] += e["dur"]
    best = sorted(tot.items(), key=lambda kv: kv[1], reverse=True)[:top]
    return [[name[:120], us / 1e6] for name, us in best]


def kernel_seconds(events, needles) -> float:
    """Summed device time of the operations whose name holds one of
    ``needles``."""
    return sum(e["dur"] for e in events
               if any(n in e["name"] for n in needles)) / 1e6
