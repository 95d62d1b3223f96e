"""Result writers: TUM pose files, PLY meshes, binary volumes, export tree.

Port of ``emfusion_tpu/io/writers.py``. The formats are the reference's,
so its evaluation scripts read them unchanged, and the files are byte for
byte those of the JAX writers for the same arrays:

  * pose files: ``frame tx ty tz qx qy qz qw`` (``EMFusion.cpp:1238-1254``);
  * PLY: ascii, positions + normals + polygon rows
    (``EMFusion.cpp:1263-1300``), formatted by whole blocks of rows
    rather than a Python loop per vertex (a 512^3 mesh has millions);
  * binary volumes: 3x int32 resolution, uint64 element size, float32
    voxel size, raw data (``EMFusion.cpp:1302-1313``);
  * the export directory tree (``README.md:303-321``), its images encoded
    by :mod:`emfusion_tpu_torch.io.codecs` (the JAX writer skips them
    when ``imageio`` is missing; this one writes them on any machine).

A pipeline on a mesh (``distributed/``) writes the same files: every rank
calls the writers, which gather what they need (the background mesh
through ``extract_mesh_zsharded``, the slots' volumes from their owners),
and rank 0 writes.
"""

from __future__ import annotations

import io
import os
import struct as _struct
from typing import Dict, Optional

import numpy as np
import torch

from emfusion_tpu_torch.distributed.mesh import gather_pool
from emfusion_tpu_torch.io.codecs import write_png
from emfusion_tpu_torch.distributed.sharded_ops import (
    extract_mesh_zsharded,
)
from emfusion_tpu_torch.ops.marching_cubes import (
    extract_mesh_sparse, extract_pool_meshes,
)
from emfusion_tpu_torch.volume import fg_probs

_ROWS = 1 << 16                     # rows formatted per string operation


def _rot_to_quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion (x, y, z, w)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    return np.array([x, y, z, w])


def write_pose_file(filename: str, poses: Dict[int, np.ndarray],
                    timestamps: Optional[Dict[int, float]] = None) -> None:
    """TUM-format trajectory: ``idx tx ty tz qx qy qz qw``, the frame
    index replaced by its timestamp where ``timestamps`` has one."""
    with open(filename, "w") as f:
        for idx in sorted(poses):
            T = np.asarray(poses[idx])
            q = _rot_to_quat(T[:3, :3])
            stamp = timestamps.get(idx, idx) if timestamps else idx
            f.write(f"{stamp} {T[0, 3]} {T[1, 3]} {T[2, 3]} "
                    f"{q[0]} {q[1]} {q[2]} {q[3]}\n")


def add_pose_offsets(poses: Dict[int, np.ndarray],
                     offsets: Dict[int, np.ndarray]) -> Dict[int, np.ndarray]:
    """Undo the cumulative resize recentre offsets
    (``EMFusion::addPoseOffsets``, ``EMFusion.cpp:1220-1236``)."""
    out = {}
    cum = np.zeros(3, np.float32)
    for idx in sorted(poses):
        if idx in offsets:
            cum = cum - offsets[idx]
        T = np.asarray(poses[idx]).copy()
        T[:3, 3] = T[:3, 3] + T[:3, :3] @ cum
        out[idx] = T
    return out


def _rows(f, fmt: str, arr: np.ndarray) -> None:
    """Write each row of ``arr`` with ``fmt``, a block of rows per string
    operation (the same text as a loop of ``fmt % row``)."""
    for i in range(0, len(arr), _ROWS):
        block = arr[i:i + _ROWS]
        f.write((fmt * len(block)) % tuple(block.ravel().tolist()))


def _write_ply(f, vertices, normals, triangles) -> None:
    vertices = np.asarray(vertices, np.float32).reshape(-1, 3)
    normals = np.asarray(normals, np.float32).reshape(-1, 3)
    triangles = np.asarray(triangles).reshape(-1, 3)
    f.write("ply\nformat ascii 1.0\n")
    f.write(f"element vertex {len(vertices)}\n")
    f.write("property float x\nproperty float y\nproperty float z\n")
    f.write("property float nx\nproperty float ny\nproperty float nz\n")
    f.write(f"element face {len(triangles)}\n")
    f.write("property list uchar int vertex_index\nend_header\n")
    _rows(f, "%f %f %f %f %f %f\n",
          np.concatenate([vertices, normals], axis=1))
    _rows(f, "3 %d %d %d\n", triangles.astype(np.int64))


def write_ply(filename: str, vertices: np.ndarray, normals: np.ndarray,
              triangles: np.ndarray) -> None:
    """ASCII PLY with normals; triangles as (T, 3) int vertex indices."""
    with open(filename, "w") as f:
        _write_ply(f, vertices, normals, triangles)


def ply_bytes(vertices: np.ndarray, normals: np.ndarray,
              triangles: np.ndarray) -> bytes:
    """:func:`write_ply`'s file, in memory."""
    f = io.StringIO()
    _write_ply(f, vertices, normals, triangles)
    return f.getvalue().encode()


def write_volume_bin(filename: str, vol: np.ndarray, res_xyz, voxel_size,
                     channels: int = 1) -> None:
    """Reference binary volume format (``EMFusion.cpp:1302-1313``):
    int32[3] resolution, uint64 element size, float32 voxel size, raw
    float32 data."""
    vol = np.asarray(vol, dtype=np.float32)
    elem = vol.dtype.itemsize * channels
    with open(filename, "wb") as f:
        f.write(_struct.pack("<3i", *[int(r) for r in res_xyz]))
        f.write(_struct.pack("<Q", elem))
        f.write(_struct.pack("<f", float(voxel_size)))
        f.write(np.ascontiguousarray(vol).tobytes())


def read_volume_bin(filename: str):
    """(data (Z, Y, X[, C]) float32, (X, Y, Z), voxel size)."""
    with open(filename, "rb") as f:
        res = _struct.unpack("<3i", f.read(12))
        elem = _struct.unpack("<Q", f.read(8))[0]
        voxel = _struct.unpack("<f", f.read(4))[0]
        data = np.frombuffer(f.read(), dtype=np.float32)
    channels = elem // 4
    X, Y, Z = res
    data = data.reshape(Z, Y, X, channels) if channels > 1 else \
        data.reshape(Z, Y, X)
    return data, res, voxel


def object_meshes(pipe, pool=None) -> Dict[int, tuple]:
    """Per live object id its mesh, the voxels with weight and a
    foreground probability above 0.5 (``io/writers.py:290-294``), all
    slots in one pooled pass (``pool``: the pipeline's whole pool, which
    a rank of a mesh gathers; the others return {})."""
    o = gather_pool(pipe) if pool is None else pool
    ids = pipe.active_object_ids
    if not ids or not pipe.is_writer:
        return {}
    slots = [pipe._slot_of(oid) for oid in ids]
    sl = torch.tensor(slots, dtype=torch.long, device=o.tsdf.device)
    mask = (o.weights[sl] > 0) & (fg_probs(o.fg_counts[sl].transpose(0, 1))
                                  > 0.5)
    meshes = extract_pool_meshes(o.tsdf[sl], mask, o.voxel_size[slots])
    return dict(zip(ids, meshes))


def background_mesh(pipe):
    """The background volume's mesh (voxels with weight), in bands. On a
    mesh the first ``obj`` row's ranks mesh their z-slabs
    (``extract_mesh_zsharded``) and rank 0 gets the mesh; the others get
    None."""
    s = pipe.state
    vs = float(pipe.params.globalVoxelSize)
    mesh = pipe.mesh
    if mesh is None:
        return extract_mesh_sparse(s.bg_tsdf, s.bg_weights > 0, vs)
    if mesh.coords[0] != 0:
        return None
    z0, z1 = pipe._z0, pipe._z1
    return extract_mesh_zsharded(mesh.z, s.bg_tsdf[z0:z1],
                                 s.bg_weights[z0:z1] > 0, vs, z0,
                                 s.bg_tsdf.shape[0])


def write_frame_meshes(pipe, path: str, frame: int,
                       objects_only: bool = False, writer=None):
    """Per-frame mesh dumps (the reference's ``frame_meshes/`` tree,
    ``EMFusion.cpp:1263-1300``): ``mesh_bg_<frame>.ply`` (not with
    ``objects_only``, as the JAX function's flag skips the background
    volume) and ``mesh_<id>_<frame>.ply`` per live object (rank 0 of a
    mesh writes them; every rank calls this). The meshes are extracted
    here; with ``writer`` (a :class:`~emfusion_tpu_torch.native.
    AsyncWriter`) the files are written on its thread (its ``wait``
    says when they landed), else here. Returns the meshes, (background
    mesh or None, {object id: mesh}), or None where nothing was
    written."""
    bg = None if objects_only else background_mesh(pipe)
    objs = object_meshes(pipe)
    if not pipe.is_writer:
        return None
    os.makedirs(path, exist_ok=True)
    emit = write_ply if writer is None else writer.submit_ply
    if bg is not None:
        emit(os.path.join(path, f"mesh_bg_{frame:04d}.ply"), *bg)
    for oid, mesh in objs.items():
        emit(os.path.join(path, f"mesh_{oid}_{frame:04d}.ply"), *mesh)
    return bg, objs


def _dump(path: str, sub: str, idx: int, im) -> None:
    os.makedirs(os.path.join(path, sub), exist_ok=True)
    arr = np.asarray(im)
    if arr.dtype == bool:
        arr = arr.astype(np.float32)
    if arr.dtype != np.uint8:
        arr = np.clip(arr * 255.0, 0, 255).astype(np.uint8)
    write_png(os.path.join(path, sub, f"{idx:04d}.png"), arr)


def write_results(pipe, path: str, export_volumes: bool = False) -> None:
    """Write the whole export tree (``EMFusion::writeResults``,
    ``EMFusion.cpp:253-292`` and its writers ``:991-1313``): the pose
    files, the image dumps of ``pipe.outputs``, ``mesh_bg.ply`` and
    ``mesh_<id>.ply``, and with ``export_volumes`` the ``tsdfs/``
    volumes. On a mesh every rank calls it and rank 0 writes."""
    pipe.flush()
    pool = gather_pool(pipe)
    bg_mesh, obj_meshes = background_mesh(pipe), object_meshes(pipe, pool)
    if not pipe.is_writer:
        return
    os.makedirs(path, exist_ok=True)

    stamps = getattr(pipe, "timestamps", None) or None
    write_pose_file(os.path.join(path, "poses-cam.txt"), pipe.poses, stamps)
    for oid, traj in pipe.obj_poses.items():
        write_pose_file(os.path.join(path, f"poses-{oid}.txt"), traj, stamps)
        offsets = pipe.meta[oid].pose_offsets if oid in pipe.meta else {}
        write_pose_file(os.path.join(path, f"poses-{oid}-corrected.txt"),
                        add_pose_offsets(traj, offsets), stamps)

    # the image dumps (EMFusion.cpp:1027-1146): output/, masks/,
    # masks_vis/, assoc_weights/{bg,<id>}/{pre,post}Track,
    # track_weights/{bg,<id>}, huber_weights/{bg,<id>}, fg_probs/<id>
    out = pipe.outputs
    for sub, key in (("output", "renderings"),
                     ("assoc_weights/bg/preTrack", "bg_assoc_pre"),
                     ("assoc_weights/bg/postTrack", "bg_assoc_post"),
                     ("track_weights/bg", "track_weights_bg"),
                     ("huber_weights/bg", "huber_weights_bg")):
        for idx, im in out.get(key, {}).items():
            _dump(path, sub, idx, im)
    for idx, mask_list in out.get("masks", {}).items():
        for i, m in enumerate(mask_list):
            _dump(path, "masks", idx * 100 + i, m)
    for idx, im in out.get("mask_vis", {}).items():
        _dump(path, "masks_vis", idx, im)
    for key, sub_fmt in (
            ("obj_assoc_pre", "assoc_weights/{oid}/preTrack"),
            ("obj_assoc_post", "assoc_weights/{oid}/postTrack"),
            ("obj_track_weights", "track_weights/{oid}"),
            ("obj_huber_weights", "huber_weights/{oid}"),
            ("fg_probs", "fg_probs/{oid}")):
        for idx, per_obj in out.get(key, {}).items():
            for oid, im in per_obj.items():
                _dump(path, sub_fmt.format(oid=oid), idx, im)

    write_ply(os.path.join(path, "mesh_bg.ply"), *bg_mesh)
    for oid, mesh in obj_meshes.items():
        write_ply(os.path.join(path, f"mesh_{oid}.ply"), *mesh)

    if export_volumes:
        tdir = os.path.join(path, "tsdfs")
        os.makedirs(tdir, exist_ok=True)
        bg = pipe.state.bg_tsdf.float().cpu().numpy()   # bf16 -> float32
        Z, Y, X = bg.shape
        write_volume_bin(os.path.join(tdir, "bg_tsdf.bin"), bg, (X, Y, Z),
                         pipe.params.globalVoxelSize)
        o = pool
        for oid in pipe.active_object_ids:
            k = pipe._slot_of(oid)
            vol = o.tsdf[k].cpu().numpy()
            Zo, Yo, Xo = vol.shape
            vs = float(o.voxel_size[k])
            for name, arr in (("tsdf", vol),
                              ("weights", o.weights[k].cpu().numpy()),
                              ("fgProbs",
                               fg_probs(o.fg_counts[k]).cpu().numpy())):
                write_volume_bin(os.path.join(tdir, f"{name}_{oid}.bin"),
                                 arr, (Xo, Yo, Zo), vs)
