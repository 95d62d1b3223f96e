"""A run on the card (skips without one): one short run of each kind
through the command, its last line as the contract has it.

    python -m pytest -q -p no:cacheprovider benchmark/tests/test_bench_card.py
"""

import json
import subprocess
import sys

import pytest

from benchmark import harness

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    """Decided at run time, never at collection: skip without a card."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize("trace", [0, 1])
def test_run_line(cuda, trace):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "default.static",
         "--seed", "3000000019", "--seconds", "4", "--trace", str(trace)],
        capture_output=True, text=True, cwd=harness.ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["count"] == 1
    if trace:
        assert line["device"]["busy_s"] > 0
        assert len(line["breakdown"]["device_ops"]) <= 10
    else:
        assert set(line["metrics"]) >= {"frames_per_s", "setup_s"}
