"""What the benchmark loads: never JAX or the JAX package; the reference
nothing of the port; no result without a card."""

import json
import os
import subprocess
import sys

from benchmark import harness

ENV = dict(os.environ, PYTHONPATH=harness.ROOT)


def _top_names(code):
    out = subprocess.run([sys.executable, "-c", code + (
        "\nimport sys, json; print(json.dumps(sorted({m.split('.')[0] "
        "for m in sys.modules})))")], capture_output=True, text=True,
        env=ENV, cwd=harness.ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_forbidden_compares_whole_top_names():
    mods = {"emfusion_tpu_torch": 1, "emfusion_tpu_torch.pipeline": 1,
            "jaxtyping": 1, "numpy": 1}
    assert harness.forbidden_modules(mods) == []
    mods.update({"emfusion_tpu.ops": 1, "jaxlib.xla": 1, "flax": 1})
    assert harness.forbidden_modules(mods) == ["emfusion_tpu", "flax",
                                               "jaxlib"]


def test_run_loads_no_jax():
    """What a run imports (the entry, the harness, the port's pipeline and
    kernels, the reference, the trace and every reader)."""
    names = _top_names(
        "import benchmark.run, benchmark.harness as h, benchmark.check, "
        "benchmark.trace, benchmark.roofline\n"
        "import emfusion_tpu_torch.pipeline, emfusion_tpu_torch.kernels, "
        "emfusion_tpu_torch.profiling, emfusion_tpu_torch.segmentation\n"
        "import json\n"
        "m = json.load(open(h.MANIFEST))\n"
        "[h.reader(x['name']) for x in m['end_to_end'] + m['per_layer']]\n"
        "h.program_params(h.load_cell('default.movers3').config)")
    assert not names & set(harness.FORBIDDEN)


def test_reference_imports_nothing_of_the_port():
    names = _top_names("import benchmark.reference.frame, "
                       "benchmark.reference.lm, benchmark.reference.ops, "
                       "benchmark.check, benchmark.roofline")
    assert "emfusion_tpu_torch" not in names
    assert not names & set(harness.FORBIDDEN)


def test_no_card_no_result():
    """On a machine without a card the run exits non-zero and prints no
    result line (this sandbox has none)."""
    import torch
    if torch.cuda.is_available():
        import pytest
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "default.static",
         "--seed", "2147483659", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=harness.ROOT, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no result" in out.stderr
