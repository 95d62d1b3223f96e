#!/usr/bin/env python3
"""Run one cell of the port's benchmark on this machine's card.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout. ``CELL`` is a ``workloads`` entry of
``BENCHMARK.json``. The last line on standard output is the result, one
JSON object: ``correct``, ``attempted`` (the window's frames), ``failed``,
``metrics`` (with ``--trace 0`` the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics), ``device`` (and with ``--trace 1``
``breakdown``), and last ``checks``, each number of the correctness check
beside its limit; the same numbers close standard error. Without a card,
or with fewer than the cell asks for, it prints no result and exits 2; if
JAX or the JAX package was loaded, it exits 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def parse(argv=None):
    ap = argparse.ArgumentParser("benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # the run's sampler is the configuration's, never the environment's
    os.environ.pop("EMF_TRACK_SAMPLER", None)
    from benchmark import harness
    chips = harness.load_cell(args.workload).entry["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: the cell asks for {chips} card(s), {n} visible; "
              "no result", file=sys.stderr)
        return 2
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), T_START, log=print)
    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {', '.join(bad)}; no result",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
