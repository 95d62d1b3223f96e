"""Marching cubes with exact counts.

Port of ``emfusion_tpu/ops/marching_cubes.py`` (the reference's two-pass
CUDA marching cubes, ``src/core/cuda/TSDF.cu:855-1152``). PyTorch has
dynamic shapes, so each pass produces exactly what the mesh needs and no
buffer has a cap: classify every cube, keep the cubes whose class has
vertices (``nonzero``), count their vertices and triangles, scan the
counts (``cumsum``) and emit. The JAX package's static ``max_verts``
buffers, and the pooled extraction's overflow fault
(``marching_cubes.py:640-661``: triangles could point at vertices cut by
the cap), have no counterpart.

Geometry as the JAX package and the reference:
  * the corner at voxel index ``i`` sits at ``(i - (res-1)/2) * voxel``;
  * vertices interpolate with ``vertexInterp``'s 1e-5 short-cuts
    (``TSDF.cu:909-920``);
  * normals interpolate the normalised corner gradients and are
    normalised again; the gradients are ``ops.fusion.compute_gradients``'
    forward differences (the port keeps no gradient volume);
  * a cube takes part only when all 8 corners pass the mask
    (``kernel_classifyCubes``, ``TSDF.cu:889-892``).

Cubes are emitted in z-major order, each cube's vertices in edge order,
so the output equals the JAX package's vertex for vertex.
:func:`extract_mesh` treats the volume as one band; :func:`extract_mesh_
sparse` walks it in bands of ``z_band`` cube layers, each with a one-plane
halo for the gradients, which bounds the working memory at 512^3 (eight
full corner slices of 511^3 float32 would take 4.3 GB) and gives the same
mesh. :func:`extract_pool_meshes` meshes every object slot of a pool in
one pass. All three run on the volumes' device and return numpy.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from emfusion_tpu_torch.ops.mc_tables import (
    CORNER_OFFSETS, EDGE_CORNERS, EDGE_LOCAL_OFFSET, EDGE_TABLE, NUM_VERTS,
    TRI_TABLE,
)

Mesh = Tuple[np.ndarray, np.ndarray, np.ndarray]


def _tables(device):
    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int64,
                               device=device)
    return dict(nv=t(NUM_VERTS), edges=t(EDGE_TABLE),
                local=t(EDGE_LOCAL_OFFSET), tri=t(TRI_TABLE))


def _plane_gradients(tsdf: torch.Tensor, z0: int, z1: int) -> torch.Tensor:
    """``compute_gradients(tsdf)[:, :, z0:z1]`` for (B, Z, Y, X) volumes,
    from planes z0..z1 (one past, for the z difference) only: (B, 3,
    z1 - z0, Y, X), zero on the last plane of each axis."""
    B, Z, Y, X = tsdf.shape
    g = torch.zeros((B, 3, z1 - z0, Y, X), dtype=tsdf.dtype,
                    device=tsdf.device)
    top = min(z1, Z - 1)              # planes that have a next one
    if top > z0:
        cur = tsdf[:, z0:top, :-1, :-1]
        g[:, 0, :top - z0, :-1, :-1] = tsdf[:, z0:top, :-1, 1:] - cur
        g[:, 1, :top - z0, :-1, :-1] = tsdf[:, z0:top, 1:, :-1] - cur
        g[:, 2, :top - z0, :-1, :-1] = tsdf[:, z0 + 1:top + 1, :-1, :-1] - cur
    return g


def _vertex_interp(p1, p2, v1, v2):
    """``vertexInterp`` (``TSDF.cu:909-920``), (..., 3) points."""
    v1e, v2e = v1[..., None], v2[..., None]
    denom = v2e - v1e
    mu = -v1e / torch.where(torch.abs(denom) > 1e-30, denom,
                            torch.full_like(denom, 1e-30))
    out = p1 + mu * (p2 - p1)
    out = torch.where(torch.abs(denom) < 1e-5, p1, out)
    out = torch.where(torch.abs(v2e) < 1e-5, p2, out)
    return torch.where(torch.abs(v1e) < 1e-5, p1, out)


def _normalize(v):
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return v / torch.where(n > 0, n, torch.ones_like(n))


def _band(tsdf, mask, voxel_size, z0: int, z1: int, tabs, zg0: int = 0,
          Zg=None):
    """The cubes of layers [z0, z1) of (B, Z, Y, X) volumes, which are the
    planes ``[zg0, zg0 + Z)`` of volumes ``Zg`` planes deep (default: the
    whole volumes), so vertices sit where the whole volume's would: returns
    (vertices (V, 3), normals (V, 3), triangles (T, 3) indexing the band's
    vertices, per-volume vertex and triangle counts (B,)), vertices and
    triangles ordered by volume, then cube (z-major), then edge."""
    B, Z, Y, X = tsdf.shape
    dev = tsdf.device
    L = z1 - z0
    t = tsdf[:, z0:z1 + 1]
    m = mask[:, z0:z1 + 1]
    g = _plane_gradients(tsdf, z0, z1 + 1)
    cls = torch.zeros((B, L, Y - 1, X - 1), dtype=torch.int64, device=dev)
    valid = torch.ones((B, L, Y - 1, X - 1), dtype=torch.bool, device=dev)
    for i, (dx, dy, dz) in enumerate(CORNER_OFFSETS.tolist()):
        sl = (slice(None), slice(dz, dz + L), slice(dy, dy + Y - 1),
              slice(dx, dx + X - 1))
        cls |= (t[sl] < 0.0).to(torch.int64) << i
        valid &= m[sl]
    cls = torch.where(valid, cls, 0)
    b, z, y, x = torch.nonzero((cls != 0) & (cls != 255), as_tuple=True)
    c = cls[b, z, y, x]
    del cls, valid
    M = c.shape[0]
    vs = voxel_size.to(dev)[b]                                    # (M,)
    zero = torch.zeros(0, dtype=torch.float32, device=dev)
    if M == 0:
        return (zero.reshape(0, 3), zero.reshape(0, 3),
                torch.zeros((0, 3), dtype=torch.int64, device=dev),
                torch.zeros(B, dtype=torch.int64, device=dev),
                torch.zeros(B, dtype=torch.int64, device=dev))
    xf, yf = x.to(torch.float32), y.to(torch.float32)
    zf = (z + z0 + zg0).to(torch.float32)
    z_origin = -((Z if Zg is None else Zg) - 1) / 2.0 * vs
    corners = CORNER_OFFSETS.tolist()
    val = torch.stack([t[b, z + dz, y + dy, x + dx]
                       for dx, dy, dz in corners])                # (8, M)
    nrm = _normalize(torch.stack([g[b, :, z + dz, y + dy, x + dx]
                                  for dx, dy, dz in corners]))    # (8, M, 3)
    pos = torch.stack([torch.stack([(xf + dx - (X - 1) / 2.0) * vs,
                                    (yf + dy - (Y - 1) / 2.0) * vs,
                                    (zf + dz) * vs + z_origin], -1)
                       for dx, dy, dz in corners])                # (8, M, 3)
    ea, eb = EDGE_CORNERS[:, 0].tolist(), EDGE_CORNERS[:, 1].tolist()
    vpos = _vertex_interp(pos[ea], pos[eb], val[ea], val[eb])     # (12, M, 3)
    vnrm = _normalize(_vertex_interp(nrm[ea], nrm[eb], val[ea], val[eb]))
    bits = torch.arange(12, device=dev)
    on = ((tabs["edges"][c][:, None] >> bits) & 1).bool()         # (M, 12)
    verts = vpos.transpose(0, 1)[on]
    norms = vnrm.transpose(0, 1)[on]
    nv = tabs["nv"][c]
    vbase = torch.cumsum(nv, 0) - nv
    tri_e = tabs["tri"][c]                                        # (M, 15)
    vid = vbase[:, None] + torch.gather(tabs["local"][c], 1,
                                        torch.clamp(tri_e, min=0))
    tri_on = tri_e.reshape(M, 5, 3)[:, :, 0] >= 0                 # (M, 5)
    tris = vid.reshape(M, 5, 3)[tri_on]
    nv_b = torch.zeros(B, dtype=torch.int64, device=dev).index_add_(
        0, b, nv)
    nt_b = torch.zeros(B, dtype=torch.int64, device=dev).index_add_(
        0, b, tri_on.sum(1))
    return verts, norms, tris, nv_b, nt_b


def _mesh(tsdf, mask, voxel_size, z_band: int, zg0: int = 0, Zg=None,
          layers=None) -> List[Mesh]:
    """Meshes of (B, Z, Y, X) volumes in bands of ``z_band`` cube layers;
    one numpy triple per volume, triangles indexing its own vertices.
    ``zg0``/``Zg``/``layers``: see :func:`extract_mesh_slab`."""
    tsdf = tsdf.to(torch.float32)
    B, Z, Y, X = tsdf.shape
    layers = max(Z - 1, 0) if layers is None else layers
    tabs = _tables(tsdf.device)
    parts = [[] for _ in range(B)]
    for z0 in range(0, layers, z_band):
        v, n, t, nv, nt = _band(tsdf, mask, voxel_size, z0,
                                min(z0 + z_band, layers), tabs, zg0, Zg)
        v, n, t = v.cpu().numpy(), n.cpu().numpy(), t.cpu().numpy()
        nv, nt = nv.cpu().numpy(), nt.cpu().numpy()
        ov = np.concatenate([[0], np.cumsum(nv)])
        ot = np.concatenate([[0], np.cumsum(nt)])
        for k in range(B):
            if nv[k]:
                parts[k].append((v[ov[k]:ov[k + 1]], n[ov[k]:ov[k + 1]],
                                 t[ot[k]:ot[k + 1]] - ov[k]))
    out = []
    for p in parts:
        if not p:
            out.append((np.zeros((0, 3), np.float32),
                        np.zeros((0, 3), np.float32),
                        np.zeros((0, 3), np.int32)))
            continue
        offs = np.concatenate([[0], np.cumsum([len(q[0]) for q in p])])
        out.append((np.concatenate([q[0] for q in p]),
                    np.concatenate([q[1] for q in p]),
                    np.concatenate([q[2] + o for q, o in zip(p, offs)]
                                   ).astype(np.int32)))
    return out


def extract_mesh(tsdf: torch.Tensor, mask: torch.Tensor,
                 voxel_size) -> Mesh:
    """The zero isosurface of a (Z, Y, X) volume, cubes whose 8 corners
    pass the bool ``mask``, in one pass: (vertices (V, 3), normals
    (V, 3), triangles (T, 3) int32) as numpy."""
    Z = tsdf.shape[0]
    return extract_mesh_sparse(tsdf, mask, voxel_size, z_band=max(Z - 1, 1))


def extract_mesh_sparse(tsdf: torch.Tensor, mask: torch.Tensor, voxel_size,
                        z_band: int = 32) -> Mesh:
    """:func:`extract_mesh` in bands of ``z_band`` cube layers (the same
    mesh; working memory bounded by the band)."""
    vs = torch.as_tensor([float(voxel_size)], dtype=torch.float32)
    return _mesh(tsdf[None], mask[None], vs, z_band)[0]


def extract_mesh_slab(tsdf: torch.Tensor, mask: torch.Tensor, voxel_size,
                      z0: int, Z: int, layers: int,
                      z_band: int = 32) -> Mesh:
    """The cubes of the first ``layers`` layers of a z-slab: ``tsdf`` and
    ``mask`` hold the planes ``[z0, z0 + n)`` of a (Z, Y, X) volume, with
    ``n >= layers + 2`` where the slab ends before the volume's last plane
    (the corners' next plane, and the one after it for their z
    gradient). The vertices are those of :func:`extract_mesh` of the whole
    volume for those cubes, bit for bit, at their global positions; the
    triangles index the slab's own vertices."""
    n = tsdf.shape[0]
    if layers > n - 1 or (z0 + n < Z and layers > n - 2):
        raise ValueError(f"extract_mesh_slab: {n} planes at z0={z0} of "
                         f"{Z} cannot mesh {layers} cube layers")
    vs = torch.as_tensor([float(voxel_size)], dtype=torch.float32)
    return _mesh(tsdf[None], mask[None], vs, z_band, z0, Z, layers)[0]


def extract_pool_meshes(tsdf_pool: torch.Tensor, mask_pool: torch.Tensor,
                        voxel_sizes) -> List[Mesh]:
    """The meshes of every slot of a (K, R, R, R) pool in one pass (slots
    whose mask is all False give empty meshes); ``voxel_sizes`` (K,)."""
    vs = torch.as_tensor(voxel_sizes, dtype=torch.float32)
    R = tsdf_pool.shape[1]
    return _mesh(tsdf_pool, mask_pool, vs, max(R - 1, 1))
