"""Checkpoint and resume for the pipeline.

Port of ``emfusion_tpu/checkpoint.py``, in its file layout, so a
checkpoint of either package loads into the other: one ``.npz`` holding
the state's arrays under the JAX ``PipelineState``'s names and shapes
(``bg_*``, ``cam_pose``, ``objs.*``), the trajectories (``traj.*``) and
the host bookkeeping as JSON bytes (``__meta__``), written atomically
(tmp + rename) so a crash mid-write never corrupts the last checkpoint.
The archive is what ``np.savez_compressed`` writes, at deflate level 1
instead of 6: at 512^3 the arrays are 2.7 GB, mostly zeros, and level 1
compresses them about three times as fast for ~15% more bytes; ``np.load``
reads either.

The port keeps no gradient volumes; ``bg_grads`` and ``objs.grads`` are
written from ``ops.fusion.compute_gradients`` (what the JAX package keeps
there: its object fusion stores ``compute_gradients`` of the fused
volume, ``pipeline.py:779-782``, and its checkpoint loader recomputes the
background's), and ignored on load.

A pipeline on a mesh (``distributed/``) writes the one-card file: every
rank calls :func:`save_checkpoint`, the slots' volumes are gathered from
their owners, and rank 0 writes. :func:`load_checkpoint` runs on every
rank, and each keeps its slab and slots, so a checkpoint of any of the
three (JAX, one card, a mesh) loads into the others.

Checkpoints hold float32 whatever the background's storage dtype (bf16
has no portable ``.npz`` dtype, ``checkpoint.py:28-34`` of the JAX
package), and a load casts back to the pipeline's ``vol_dtype``: bf16
values survive the round trip bit for bit, in either package.
"""

from __future__ import annotations

import json
import os
import zipfile

import numpy as np
import torch

from emfusion_tpu_torch.distributed.mesh import gather_pool
from emfusion_tpu_torch.ops.fusion import compute_gradients
from emfusion_tpu_torch.pipeline import ObjectMeta, state_from_numpy

_BG = ("bg_tsdf", "bg_weights", "bg_pose", "bg_assoc", "cam_pose")
_OBJ = ("tsdf", "weights", "fg_counts", "pose", "voxel_size", "truncdist",
        "active", "visible", "object_id", "assoc")


def _np(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def state_arrays(pipe) -> dict:
    """The pipeline state as the JAX checkpoint's flat dict of arrays
    (every rank of a mesh calls it: the pool is gathered)."""
    s, o = pipe.state, gather_pool(pipe)
    out = {name: _np(getattr(s, name)) for name in _BG}
    out["bg_grads"] = _np(compute_gradients(s.bg_tsdf.float()))
    for name in _OBJ:
        out[f"objs.{name}"] = _np(getattr(o, name))
    out["objs.grads"] = np.stack([_np(compute_gradients(t))
                                  for t in o.tsdf])
    return out


def save_checkpoint(pipe, path: str) -> None:
    """Write the pipeline's whole state to ``path`` (.npz), atomically
    (rank 0 of a mesh writes; every rank calls this)."""
    pipe.flush()
    arrays = state_arrays(pipe)
    if not pipe.is_writer:
        return
    meta = {
        "frame": pipe.frame,
        "next_id": pipe._next_id,
        "timestamps": {str(k): v for k, v in pipe.timestamps.items()},
        "objects": {
            str(oid): {
                "ex_count": m.ex_count,
                "nonex_count": m.nonex_count,
                "class_probs": (m.class_probs.tolist()
                                if m.class_probs is not None else None),
                "pose_offsets": {str(f): np.asarray(o).tolist()
                                 for f, o in m.pose_offsets.items()},
            } for oid, m in pipe.meta.items()
        },
    }
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                       dtype=np.uint8)
    if pipe.poses:
        frames = sorted(pipe.poses)
        arrays["traj.frames"] = np.asarray(frames, np.int64)
        arrays["traj.cam"] = np.stack([pipe.poses[f] for f in frames])
    for oid, traj in pipe.obj_poses.items():
        frames = sorted(traj)
        arrays[f"traj.obj{oid}.frames"] = np.asarray(frames, np.int64)
        arrays[f"traj.obj{oid}.poses"] = np.stack([traj[f] for f in frames])
    tmp = path + ".tmp"
    with zipfile.ZipFile(tmp, "w", compression=zipfile.ZIP_DEFLATED,
                         compresslevel=1) as zf:
        for name, arr in arrays.items():
            with zf.open(name + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, np.asanyarray(arr),
                                          allow_pickle=False)
    os.replace(tmp, path)


def load_checkpoint(pipe, path: str) -> None:
    """Restore ``pipe`` in place from ``path`` (written by either
    package). The pipeline must have been built with the same Params:
    the stored shapes are checked against its state."""
    with np.load(path) as z:               # the gradients are not read
        arrays = {k: z[k] for k in z.files if not k.endswith("grads")}
    meta = json.loads(bytes(arrays.pop("__meta__").tobytes()).decode())
    cur = pipe.state
    for name in _BG:
        want = tuple(getattr(cur, name).shape)
        if tuple(arrays[name].shape) != want:
            raise ValueError(f"checkpoint shape mismatch for {name}: "
                             f"{arrays[name].shape} vs {want} — params "
                             "differ")
    for name in _OBJ:
        # the whole pool's shapes (a rank of a mesh holds its slots only)
        want = (pipe.K,) + tuple(getattr(cur.objs, name).shape[1:])
        if tuple(arrays[f"objs.{name}"].shape) != want:
            raise ValueError(f"checkpoint shape mismatch for objs.{name}: "
                             f"{arrays[f'objs.{name}'].shape} vs {want}")
    state = state_from_numpy(
        dict({k: arrays[k] for k in _BG},
             objs={k: arrays[f"objs.{k}"] for k in _OBJ}),
        device=pipe.device, vol_dtype=pipe.vol_dtype)
    objects = {}
    for oid, m in meta["objects"].items():
        objects[int(oid)] = ObjectMeta(
            ex_count=int(m["ex_count"]), nonex_count=int(m["nonex_count"]),
            class_probs=(np.asarray(m["class_probs"])
                         if m["class_probs"] is not None else None),
            pose_offsets={int(f): np.asarray(o)
                          for f, o in m["pose_offsets"].items()})
    poses = {}
    if "traj.frames" in arrays:
        poses = {int(f): p for f, p in zip(arrays["traj.frames"],
                                           arrays["traj.cam"])}
    pipe.load_state(state, frame=int(meta["frame"]), meta=objects,
                    next_id=int(meta["next_id"]), poses=poses)
    pipe.timestamps = {int(k): float(v)
                       for k, v in meta.get("timestamps", {}).items()}
    pipe._obj_poses = {}
    for k in arrays:
        if k.startswith("traj.obj") and k.endswith(".frames"):
            oid = int(k[len("traj.obj"):-len(".frames")])
            pipe._obj_poses[oid] = {
                int(f): np.array(p, np.float32) for f, p in zip(
                    arrays[k], arrays[f"traj.obj{oid}.poses"])}
