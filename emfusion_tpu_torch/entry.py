"""Entry point of the port: one frame step over a pool with a live object.

Mirrors ``__graft_entry__.entry()`` of the JAX package (a tiny
configuration, a sinusoidal depth image, a volume seeded by one fused
frame): :func:`entry` returns ``(fn, args)``, where ``fn(state,
depth_raw)`` runs one whole frame step of
:class:`~emfusion_tpu_torch.pipeline.EMFusionPipeline` (E-steps, camera
and object LMs, the raycast composite, fusion, cleanup) from ``state``
and returns a new ``(state, seg)``, leaving ``state`` as it was, so
calls with the same arguments give the same result. The state's pool
holds one object, spawned on the seeding frame from a central mask. Like
the other entry points it runs on the GPU unless ``device`` says
otherwise. :func:`dryrun_multichip` runs such a step on n ranks of the
sharded pipeline.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np

from emfusion_tpu_torch.config import Params
from emfusion_tpu_torch.pipeline import (
    EMFusionPipeline, ObjectPool, PipelineState,
)
from emfusion_tpu_torch.segmentation import (
    CallableMaskProvider, Detection, make_score_vector,
)


def tiny_params(max_objects=8, bg_res=16, obj_res=16, H=24, W=32) -> Params:
    """``__graft_entry__._tiny_params``, with the object thresholds
    scaled to the 24x32 image so that its central mask spawns an object."""
    return Params(
        frameSize=(W, H), fx=float(W), fy=float(W),
        cx=W / 2 - 0.5, cy=H / 2 - 0.5,
        globalVolumeDims=(bg_res, bg_res, bg_res),
        globalVoxelSize=2.0 / bg_res, volumePose=(0.0, 0.0, 1.0),
        objVolumeDims=(obj_res, obj_res, obj_res),
        maxTrackingIter=3, raycast_max_steps=64, max_objects=max_objects,
        visibilityThresh=16, mask_min_pixels=16, boundary=2,
        maskRCNNFrames=1000)


def example_depth(params: Params) -> np.ndarray:
    """A smooth depth image around 1 m (``__graft_entry__``'s)."""
    H, W = params.height, params.width
    ys, xs = np.mgrid[0:H, 0:W]
    depth = 1.0 + 0.1 * np.sin(xs / 7.0) * np.cos(ys / 5.0)
    return depth.astype(np.float32)


def entry(device=None):
    """``(fn, (state, depth))``: the frame step and a seeded state with
    one live object."""
    params = tiny_params()
    H, W = params.height, params.width
    mask = np.zeros((H, W), bool)
    mask[H // 4:3 * H // 4, W // 4:3 * W // 4] = True

    def detect(rgb, frame):
        return [Detection(mask=mask, scores=make_score_vector(3, 0.9))]

    pipe = EMFusionPipeline(params, CallableMaskProvider(detect),
                            device=device)
    depth = example_depth(params)
    pipe.process_frame(None, depth)      # seed: fuse, spawn the object
    frame, meta, next_id = pipe.frame, pipe.meta, pipe._next_id

    def fn(state, depth_raw):
        # the kernels update volumes in place and the step changes the
        # poses and the meta counters: work on copies, so ``state`` and
        # the seed stay as they were and every call starts from them
        pipe.load_state(copy_state(state), frame=frame,
                        meta=copy.deepcopy(meta), next_id=next_id)
        pipe.process_frame(None, depth_raw)
        return pipe.state, pipe.last_raycast["seg"]

    return fn, (pipe.state, depth)


def dryrun_multichip(n: int, device=None) -> str:
    """``__graft_entry__.dryrun_multichip`` of the JAX package: ``n`` ranks
    (NCCL, a card each; gloo on the CPU with ``device="cpu"``) shard a
    seeded tiny state over the (obj, z) mesh and run one frame step.
    Returns (and prints) rank 0's line with the mesh's shape."""
    from emfusion_tpu_torch.distributed.mesh import launch
    line = launch("emfusion_tpu_torch.entry:_dryrun_rank", n,
                  device=device)[0]
    print(line)
    return line


def _dryrun_rank(mesh) -> str:
    """One rank of :func:`dryrun_multichip`: the seeded one-card state
    (:func:`entry`'s seeding frame, on this rank's device) loaded into a
    sharded pipeline, one frame step."""
    K = max(8, mesh.size)
    params = tiny_params(max_objects=K)
    H, W = params.height, params.width
    mask = np.zeros((H, W), bool)
    mask[H // 4:3 * H // 4, W // 4:3 * W // 4] = True

    def detect(rgb, frame):
        return [Detection(mask=mask, scores=make_score_vector(3, 0.9))]

    seed = EMFusionPipeline(params, CallableMaskProvider(detect),
                            device=mesh.device)
    depth = example_depth(params)
    seed.process_frame(None, depth)
    pipe = EMFusionPipeline(params, CallableMaskProvider(detect), mesh=mesh)
    pipe.load_state(seed.state, frame=seed.frame, meta=seed.meta,
                    next_id=seed._next_id)
    pipe.process_frame(None, depth)
    no, nz = mesh.shape
    return (f"dryrun_multichip({mesh.size}): OK - mesh {{'obj': {no}, "
            f"'z': {nz}}}, {mesh.backend}, bg slab "
            f"{pipe._z0}:{pipe._z1} of {params.globalVolumeDims[2]}, slots "
            f"{pipe._s0}:{pipe._s1} of {K}, live objects "
            f"{pipe.active_object_ids}")


def copy_state(state: PipelineState) -> PipelineState:
    """A copy of ``state`` that shares no tensor with it."""
    objs = state.objs and ObjectPool(**{
        f.name: getattr(state.objs, f.name).clone()
        for f in dataclasses.fields(ObjectPool)})
    return PipelineState(**{
        f.name: getattr(state, f.name).clone()
        for f in dataclasses.fields(PipelineState) if f.name != "objs"},
        objs=objs)
