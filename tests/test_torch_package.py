"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, its entry points want a GPU unless told otherwise, and it parses
the reference's configuration files as the JAX package does."""

import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from emfusion_tpu.config import load_config as jax_load_config
from emfusion_tpu.eval.ate import evaluate_ate as jax_ate
from emfusion_tpu.volume import volume_corners as jax_corners
from emfusion_tpu_torch import kernels
from emfusion_tpu_torch.config import Params, load_config, resolve_params
from emfusion_tpu_torch.eval.ate import evaluate_ate
from emfusion_tpu_torch.pipeline import EMFusionPipeline
from emfusion_tpu_torch.profiling import PhaseTimer
from emfusion_tpu_torch.segmentation import CallableMaskProvider
from emfusion_tpu_torch.volume import make_volume, volume_corners

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "emfusion_tpu_torch")
# an import of jax, flax or the JAX package (not of emfusion_tpu_torch)
FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|flax|emfusion_tpu)(?![\w])")

SMALL = dict(frameSize=(80, 60), fx=64.0, fy=64.0, cx=39.5, cy=29.5,
             globalVolumeDims=(32, 32, 32), globalVoxelSize=0.08)


def test_import_leaves_jax_out():
    """A fresh interpreter (conftest has imported JAX in this one)."""
    code = ("import sys, emfusion_tpu_torch.pipeline, "
            "emfusion_tpu_torch.eval.ate, emfusion_tpu_torch.kernels, "
            "emfusion_tpu_torch.segmentation, emfusion_tpu_torch.entry, "
            "emfusion_tpu_torch.detector_post, emfusion_tpu_torch.ops.render, "
            "emfusion_tpu_torch.checkpoint, emfusion_tpu_torch.viz, "
            "emfusion_tpu_torch.io.codecs, emfusion_tpu_torch.io.readers, "
            "emfusion_tpu_torch.io.writers, "
            "emfusion_tpu_torch.ops.marching_cubes, "
            "emfusion_tpu_torch.apps.run_emfusion, "
            "emfusion_tpu_torch.apps.evaluate, "
            "emfusion_tpu_torch.apps.preprocess_masks; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'emfusion_tpu')); print(bad); "
            "sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def _sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PKG):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return files


def test_no_source_imports_jax_or_the_jax_package():
    files = _sources()
    assert len(files) > 15
    bad = []
    for path in files:
        with open(path) as f:
            for no, line in enumerate(f, 1):
                if FORBIDDEN.match(line):
                    bad.append(f"{os.path.relpath(path, ROOT)}:{no}: "
                               f"{line.strip()}")
    assert not bad, bad


def test_pipeline_without_device_wants_the_gpu():
    """``device=None`` means CUDA: without a card it raises instead of
    carrying on on the CPU."""
    params = Params(**SMALL)
    if torch.cuda.is_available():
        assert EMFusionPipeline(params).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            EMFusionPipeline(params)
    assert EMFusionPipeline(params, device="cpu").device.type == "cpu"


def test_phase_timer_without_device_wants_the_gpu():
    """The timer follows the device rule too: ``None`` means CUDA, so a
    phase is never timed by a bare host clock on queued GPU work."""
    if torch.cuda.is_available():
        assert PhaseTimer().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            PhaseTimer()
    timer = PhaseTimer("cpu")
    with timer.phase("integrate"):
        pass
    assert timer.counts == {"integrate": 1}


def test_pipeline_with_objects_without_device_wants_the_gpu():
    """A pipeline with a mask provider (the object slice) follows the same
    rule: ``device=None`` means CUDA and raises without a card."""
    provider = CallableMaskProvider(lambda rgb, frame: [])
    params = Params(**SMALL)
    if torch.cuda.is_available():
        assert EMFusionPipeline(params, provider).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            EMFusionPipeline(params, provider)
    pipe = EMFusionPipeline(params, provider, device="cpu")
    assert pipe.state.objs.tsdf.shape == (params.max_objects, 64, 64, 64)


def test_default_config_parses_as_in_jax():
    path = os.path.join(ROOT, "configs", "default.cfg")
    port, ref = load_config(path), jax_load_config(path)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert (port.width, port.height) == (640, 480)
    assert port.globalVolumeDims == (512, 512, 512)


@pytest.mark.parametrize("knob, value, error", [
    ("volume_dtype", "float64", NotImplementedError),
    ("volume_dtype", "float16", NotImplementedError),
    ("motion_model", "accelerated", ValueError)])
def test_unported_knobs_raise(knob, value, error):
    """Volume storage other than float32 or bf16 is not ported; a motion
    model the JAX package does not have is refused."""
    with pytest.raises(error):
        resolve_params(Params(**{knob: value}))


@pytest.mark.parametrize("over, want", [
    (dict(estep_scale=2), dict(estep_scale=2)),
    (dict(motion_model="constvel"), dict(motion_model="constvel")),
    (dict(capture_backend="band"),
     dict(object_lm="batched", obj_track_points=4096, sampler="capture")),
    (dict(capture_backend="band", obj_track_points=0),
     dict(object_lm="batched", obj_track_points=0, sampler="capture")),
    (dict(capture_backend="gather"),
     dict(object_lm="serial", obj_track_points=0, sampler="gather"))])
def test_accelerator_knobs_resolve(over, want):
    """The JAX package's accelerator knobs, asked for explicitly, resolve
    as it resolves them (``pipeline.py:167-176, 261-264, 387-411``):
    ``band`` capture means the batched object LM over the top
    ``obj_track_points`` points (0: every point)."""
    r = resolve_params(Params(**over))
    assert {k: getattr(r, k) for k in want} == want
    assert r.volume_dtype == "float32"


def test_bf16_volumes_resolve():
    """``volume_dtype="bfloat16"``, the JAX package's accelerator storage,
    resolves, and the pipeline stores only the background pair in bf16:
    objects, counts and association images stay float32."""
    params = Params(volume_dtype="bfloat16", globalVolumeDims=(16, 16, 16),
                    objVolumeDims=(8, 8, 8), max_objects=2,
                    frameSize=(32, 24))
    assert resolve_params(params).volume_dtype == "bfloat16"
    s = EMFusionPipeline(params, device="cpu").state
    assert s.bg_tsdf.dtype == s.bg_weights.dtype == torch.bfloat16
    o = s.objs
    assert {t.dtype for t in (o.tsdf, o.weights, o.fg_counts, o.assoc,
                              s.bg_assoc)} == {torch.float32}


def test_auto_knobs_resolve_to_the_exact_path():
    r = resolve_params(Params())
    assert (r.volume_dtype, r.tracking_stride, r.estep_scale,
            r.motion_model, r.object_lm, r.obj_track_points,
            r.sampler) == ("float32", 1, 1, "static", "serial", 0, "gather")
    assert resolve_params(Params(tracking_stride=3)).tracking_stride == 3


@pytest.mark.parametrize("name", sorted(kernels.KERNELS))
def test_kernel_binding_matches_its_c_entry(name):
    """The ctypes argument list agrees with the C entry point in the
    source, argument by argument (pointer, int or float), plus the
    stream. Building needs nvcc, which only the GPU machine has, so this
    is what the CPU can check of a binding."""
    src, entry, argtypes = kernels.KERNELS[name]
    with open(os.path.join(kernels.CSRC, src)) as f:
        text = f.read()
    assert "Replaces the" in text and "Bound on the card" in text
    sig = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", text)
    assert sig, entry
    params = [p.strip() for p in sig.group(1).split(",")]
    assert params[-1] == "void* stream"
    kinds = ["p" if "*" in p else p.split()[0] for p in params[:-1]]
    want = {kernels.ctypes.c_void_p: "p", kernels.ctypes.c_int: "int",
            kernels.ctypes.c_float: "float"}
    assert kinds == [want[a] for a in argtypes]


def test_evaluate_ate_matches_jax():
    """The port's copy of the evaluator gives the JAX one's numbers on the
    same trajectories, with jittered timestamps to exercise association."""
    rng = np.random.RandomState(3)
    gt, est = {}, {}
    for i in range(20):
        T = np.eye(4)
        T[:3, 3] = [0.05 * i, 0.01 * i * i, -0.02 * i]
        gt[i * 0.1] = T
        E = T.copy()
        E[:3, 3] += rng.normal(0, 0.003, 3)
        est[i * 0.1 + rng.uniform(-0.004, 0.004)] = E
    assert evaluate_ate(est, gt) == jax_ate(est, gt)
    assert evaluate_ate(est, gt)["pairs"] == 20


def test_volume_helpers_match_jax():
    tsdf, weights = make_volume((40, 36, 32), "cpu")
    assert tsdf.shape == weights.shape == (32, 36, 40)
    assert not tsdf.any() and tsdf is not weights
    lo, hi = volume_corners((40, 36, 32), 0.05)
    jlo, jhi = jax_corners((40, 36, 32), 0.05)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
