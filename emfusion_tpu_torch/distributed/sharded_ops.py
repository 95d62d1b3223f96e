"""The z-sharded background fusion and marching cubes.

Port of ``emfusion_tpu/distributed/sharded_ops.py``.

:func:`integrate_tsdf_zsharded` is the rank's one K1 launch over its
z-slab of the background and the visible slots it holds: fusion is
voxel-local, so it needs no collective, as the JAX ``shard_map`` fusion
needs none (``sharded_ops.py:30-67``). K1's slab form forms each voxel
centre from its global plane, so the slab fuses bit for bit as the same
planes of the one-card launch.

:func:`extract_mesh_zsharded` meshes a z-sharded volume
(``sharded_ops.py:70-138``): each rank meshes the cubes whose base plane
it holds, with a halo of planes sent by the next rank (the cubes that
cross a boundary belong to the lower rank), at global positions; the
first rank of the group gathers the vertex rows and concatenates them
with the triangle indices offset by the preceding ranks' vertex counts.
The port keeps no gradient volume (its marching cubes takes the normals'
forward differences on the fly), so its halo is two planes: the corners'
next plane and the one after it for their z difference; the last rank
gets none (the JAX function wraps the halo round and then kills those
cubes). Counts are exact: there are no per-shard caps.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from emfusion_tpu_torch.distributed import comm
from emfusion_tpu_torch.ops.fusion import FusionItem, integrate_tsdf_batched
from emfusion_tpu_torch.ops.marching_cubes import Mesh, extract_mesh_slab

HALO = 2


def integrate_tsdf_zsharded(items: List[FusionItem], depth: torch.Tensor,
                            intr) -> None:
    """One K1 launch over this rank's table: its background slab (an item
    with ``z0``/``Z``) and its slots; no collective."""
    integrate_tsdf_batched(items, depth, intr)


def extract_mesh_zsharded(group: comm.Group, tsdf_slab: torch.Tensor,
                          mask_slab: torch.Tensor, voxel_size, z0: int,
                          Z: int) -> Optional[Mesh]:
    """The mesh of a volume sharded over ``group`` in equal z-slabs (group
    rank r holds planes ``[z0, z0 + n)``, r = z0 / n): this rank's cubes
    with the next rank's first two planes as its halo, gathered at group
    rank 0, which returns (vertices (V, 3), normals (V, 3), triangles
    (T, 3) int32) as numpy; the other ranks return None. The vertex set
    and triangle count are those of ``extract_mesh`` of the whole volume,
    the vertices bit for bit."""
    n = tsdf_slab.shape[0]
    if n < HALO and group.size > 1:
        raise ValueError(f"extract_mesh_zsharded: slabs of {n} planes; the "
                         f"halo needs {HALO}")
    last = group.rank == group.size - 1
    halo = torch.stack([tsdf_slab[:HALO].to(torch.float32),
                        mask_slab[:HALO].to(torch.float32)])
    if group.rank > 0:
        comm.send(group, halo, group.rank - 1)
    t, m = tsdf_slab, mask_slab
    if not last:
        comm.recv(group, halo, group.rank + 1)
        t = torch.cat([t.to(torch.float32), halo[0]])
        m = torch.cat([m, halo[1] > 0.5])
    layers = n if not last else n - 1
    v, nrm, tri = extract_mesh_slab(t, m, voxel_size, z0, Z, layers)
    dev = tsdf_slab.device
    rows = torch.cat([torch.as_tensor(v), torch.as_tensor(nrm)], 1).to(dev)
    parts_v = comm.gather_rows(group, rows)
    parts_t = comm.gather_rows(group, torch.as_tensor(
        tri.astype(np.int64)).to(dev))
    if parts_v is None:
        return None
    counts = [p.shape[0] for p in parts_v]
    offs = np.concatenate([[0], np.cumsum(counts)[:-1]])
    vn = torch.cat(parts_v).cpu().numpy()
    tris = np.concatenate([p.cpu().numpy() + o
                           for p, o in zip(parts_t, offs)])
    return (np.ascontiguousarray(vn[:, :3]), np.ascontiguousarray(vn[:, 3:]),
            tris.astype(np.int32).reshape(-1, 3))
