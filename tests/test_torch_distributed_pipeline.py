"""The port's sharded pipeline on the CPU: ``EMFusionPipeline(...,
mesh=...)`` over a (2, 2) mesh of 4 gloo ranks against the one-process
port, frame by frame, and against the JAX package's unsharded exact
pipeline.

* The frames and parameters of ``tests/test_distributed.py``'s
  ``TestShardedPipeline`` (background only), and the 16-object stress
  state of its ``_fill_pool`` with a z-sharded background mesh and the
  objects' meshes every frame, with the serial (exact) and the batched
  object LM. Every compared array is bit-equal: each rank reads the
  one-card port's read copy, samples, tracks, casts and fuses each slot
  with the same operands in the same order, and the gathers only move
  bits.

The lifecycle under the mesh is ``tests/test_torch_distributed_
lifecycle.py``.

The JAX sharded pipeline runs the pencil and sweep approximations
(``pipeline.py:132-139``), so the yardstick is its unsharded exact one.
"""

import numpy as np
import pytest
import torch

from emfusion_tpu.config import Params as JaxParams
from emfusion_tpu.pipeline import EMFusionPipeline as JaxPipeline
from emfusion_tpu_torch.distributed.mesh import launch
import torch_dist_workers as W
from test_accuracy_gate import EXACT

torch.set_num_threads(2)

STRESS = dict(W.SHARDED_PIPELINE, max_objects=16, visibilityThresh=16,
              boundary=2)


def reference(params_kw, frames, masks=None, state=None, first=0,
              meshes=False):
    """The one-process run, at the ranks' one intra-op thread: PyTorch's
    CPU reductions split their sums by thread, so another thread count
    would sum the LM's systems in another order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return W.run_frames(W.make_pipeline(params_kw, masks, state=state),
                            frames, first, meshes)
    finally:
        torch.set_num_threads(n)


def sharded(params_kw, frames, masks=None, state=None, first=0,
            meshes=False):
    res = launch("torch_dist_workers:pipeline_rank", 4,
                 args=(params_kw, frames, masks, state, first, meshes),
                 device="cpu", threads=1, timeout_s=300)
    assert [r["coords"] for r in res] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    # every rank ends with the same host mirrors, poses and ids
    for r in res[1:]:
        for a, b in zip(r["recs"], res[0]["recs"]):
            for k in a:
                assert np.array_equal(a[k], b[k]) if isinstance(
                    a[k], np.ndarray) else a[k] == b[k], (r["rank"], k)
    return res


def test_background_frames_match_one_process_and_jax():
    """``TestShardedPipeline``'s three frames: bit-equal to the one-process
    port (E-step, composite, poses, the whole read copy on every rank
    equal to the one-card volume); each rank fused only its half of the
    planes, and camera poses within 0.1 voxel of the JAX exact
    pipeline."""
    P = W.SHARDED_PIPELINE
    frames = W.wave_frames(3)
    res = sharded(P, frames)
    ref = reference(P, frames)
    W.assert_same_records(res[0]["recs"], ref)
    assert [r["slab"] for r in res] == [(0, 16), (16, 32)] * 2
    assert [r["slots"] for r in res] == [(0, 2), (0, 2), (2, 4), (2, 4)]
    assert all(r["pool_rows"] == 2 for r in res)
    comm = res[0]["comm"]
    # per frame: the read copy's refresh (2), per E-step a gather of the
    # slots' images; every frame after the first the raycast's partials
    # and hit masks (2)
    assert comm["all_gather"]["calls"] >= 2 * 3 + 3 * 2
    jax_pipe = JaxPipeline(JaxParams(**P, **EXACT), None)
    for i, d in enumerate(frames):
        jax_pipe.process_frame(None, d, timestamp=float(i))
    jax_pipe.flush()
    voxel = P["globalVoxelSize"]
    for f, rec in enumerate(res[0]["recs"]):
        assert np.linalg.norm(rec["cam"][:3, 3]
                              - jax_pipe.poses[f][:3, 3]) < 0.1 * voxel


@pytest.fixture(scope="module")
def stress():
    frames = W.wave_frames(4)
    return frames, W.stress_state(STRESS, frames[0], z=1.0)


@pytest.mark.parametrize("object_lm", ["serial", "batched"])
def test_stress_scene_matches_one_process(stress, object_lm):
    """The 16-object stress state (slots 0-7 on ``obj`` rank 0, 8-15 on
    rank 1), three frames with the sharded background mesh and the
    objects' meshes after each: everything bit-equal to the one-process
    port, the background mesh with the whole volume's vertex set and
    triangle count, most slots alive on both ``obj`` ranks. ``batched``:
    the accelerator configuration's batched object LM, over each rank's
    own slots (its sums are per slot, so a subset gives the same bits)."""
    frames, st = stress
    P = STRESS if object_lm == "serial" else dict(
        STRESS, capture_backend="band")
    res = sharded(P, frames[1:], state=st, first=1, meshes=True)
    ref = reference(P, frames[1:], state=st, first=1, meshes=True)
    W.assert_same_records(res[0]["recs"], ref)
    ids = ref[-1]["ids"]
    assert len(ids) >= 10 and min(ids) <= 8 < max(ids)
    assert all("bg_mesh" not in r["recs"][-1] for r in res[1:])
    assert len(res[0]["recs"][-1]["obj_mesh"]) == len(ids)
