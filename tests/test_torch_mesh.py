"""Port parity: marching cubes (``ops/marching_cubes.py``) against the JAX
package's dense ``extract_mesh``, banded ``extract_mesh_sparse`` and pooled
``extract_pool_meshes`` on the CPU, on sphere-and-box TSDFs with masks.

Meshes are compared in a canonical form that does not depend on the
emission order (vertices as a multiset of positions, triangles matched by
their corners' positions): the same vertex and triangle counts, vertices
and normals within 1e-5, the same triangles. The JAX sparse path rounds its normals to float16 on the way out
(``marching_cubes.py:461``), so against it the normals are held to
float16's resolution, 2^-10."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emfusion_tpu.ops import marching_cubes as jmc
from emfusion_tpu.ops.fusion import compute_gradients as jax_gradients
from emfusion_tpu_torch.ops import marching_cubes as pmc
from emfusion_tpu_torch.ops.fusion import compute_gradients

torch.set_num_threads(2)


def scene_tsdf(shape, vs, seed=0, size=1.0):
    """A sphere and a box (their union's signed distance, truncated at 5
    voxels), offset from the centre by a seeded amount and scaled by
    ``size``, and a mask with a slab and a corner cut out."""
    rng = np.random.RandomState(seed)
    Z, Y, X = shape
    zi, yi, xi = np.meshgrid(*[np.arange(n) for n in shape], indexing="ij")
    p = np.stack([(xi - (X - 1) / 2) * vs, (yi - (Y - 1) / 2) * vs,
                  (zi - (Z - 1) / 2) * vs], -1)
    u = size * min(shape) * vs
    c = rng.uniform(-0.1, 0.1, 3) * u
    sphere = np.linalg.norm(p - c, axis=-1) - 0.3 * u
    box = np.max(np.abs(p - np.array([0.0, 0.15, -0.1]) * u)
                 - np.array([0.25, 0.15, 0.2]) * u, axis=-1)
    tsdf = np.clip(np.minimum(sphere, box) / (5 * vs), -1, 1)
    mask = np.ones(shape, bool)
    mask[:, :3] = False
    mask[Z * 2 // 3:, :, X * 3 // 4:] = False
    return tsdf.astype(np.float32), mask


def same_vertices(port, ref, normal_tol):
    """The same multiset of vertices within 1e-5 (each cube emits its own
    copy of a vertex on an edge it shares, so positions repeat): every
    vertex of each has as many vertices of the other within 1e-5 as of
    its own, one of them with its normal within ``normal_tol``. This is
    independent of the emission order, and of near-ties that a sort by
    coordinates could break either way."""
    from scipy.spatial import cKDTree
    for (av, an), (bv, bn) in (((port[0], port[1]), (ref[0], ref[1])),
                               ((ref[0], ref[1]), (port[0], port[1]))):
        ta, tb = cKDTree(av), cKDTree(bv)
        np.testing.assert_array_equal(
            ta.query_ball_point(av, 1e-5, return_length=True),
            tb.query_ball_point(av, 1e-5, return_length=True))
        near = tb.query_ball_point(av, 1e-5)
        dn = [np.abs(bn[j] - n).max(axis=1).min() for j, n in zip(near, an)]
        assert max(dn, default=0.0) <= normal_tol


def same_triangles(port, ref):
    """Every triangle of ``port`` is one of ``ref``, and the other way
    round: matched by their centroids (one to one), the same three
    corners within 1e-5 and the same winding. (Each cube emits its own
    copy of a vertex on an edge it shares, so positions repeat and
    vertex indices cannot be matched by position.)"""
    from scipy.spatial import cKDTree
    P = port[0][port[2]]                        # (T, 3, 3) corners
    Q = ref[0][ref[2]]
    d, j = cKDTree(Q.mean(1)).query(P.mean(1))
    assert d.max() <= 1e-5
    assert len(np.unique(j)) == len(j) == len(Q)
    Q = Q[j]
    D = np.linalg.norm(P[:, :, None] - Q[:, None, :], axis=-1)
    assert D.min(2).max() <= 1e-5 and D.min(1).max() <= 1e-5
    area_p = np.cross(P[:, 1] - P[:, 0], P[:, 2] - P[:, 0])
    area_q = np.cross(Q[:, 1] - Q[:, 0], Q[:, 2] - Q[:, 0])
    assert (np.sum(area_p * area_q, -1) >= -1e-12).all()


def check(port, ref, normal_tol=1e-5):
    ref = tuple(np.asarray(a) for a in ref)
    assert len(port[0]) == len(ref[0]) and len(port[2]) == len(ref[2])
    assert port[2].dtype == np.int32
    if len(ref[0]):
        same_vertices(port, ref, normal_tol)
    if len(ref[2]):
        same_triangles(port, ref)


@pytest.mark.parametrize("shape,vs,seed", [((48, 48, 48), 0.02, 0),
                                           ((40, 56, 64), 0.015, 1)])
def test_dense_matches_jax(shape, vs, seed):
    """``extract_mesh`` against the JAX dense extraction with its
    gradients from ``compute_gradients`` (the port computes them itself):
    equal counts, vertices and normals within 1e-5, the same triangles;
    and, unsorted, in the same order."""
    tsdf, mask = scene_tsdf(shape, vs, seed)
    ref = jmc.extract_mesh(jnp.asarray(tsdf),
                           jax_gradients(jnp.asarray(tsdf)),
                           jnp.asarray(mask), vs)
    out = pmc.extract_mesh(torch.tensor(tsdf), torch.tensor(mask), vs)
    assert len(out[0]) > 1000
    check(out, ref)
    np.testing.assert_array_equal(out[2], np.asarray(ref[2]))


@pytest.mark.parametrize("band", [5, 16, 47])
def test_sparse_matches_jax(band):
    """``extract_mesh_sparse`` in bands of 5, 16 and 47 cube layers (ragged
    last band, one band) equals the port's one-pass mesh exactly, and the
    JAX sparse extraction in 8-layer bands (its normals to float16)."""
    tsdf, mask = scene_tsdf((48, 48, 48), 0.02, 2)
    t, m = torch.tensor(tsdf), torch.tensor(mask)
    out = pmc.extract_mesh_sparse(t, m, 0.02, z_band=band)
    whole = pmc.extract_mesh(t, m, 0.02)
    for a, b in zip(out, whole):
        np.testing.assert_array_equal(a, b)
    ref = jmc.extract_mesh_sparse(jnp.asarray(tsdf), jnp.asarray(mask), 0.02,
                                  z_chunk=8)
    check(out, ref, normal_tol=2.0 ** -10)


def test_empty_volumes():
    """An unobserved volume (all zero, mask False), a volume all in front
    of the surface and one with a surface but every cube masked: empty
    meshes of the right dtypes, as the JAX package gives."""
    z = torch.zeros((16, 16, 16))
    for t, m in ((z, z > 0), (z + 1, z == 0), (z - torch.arange(16.0) + 8,
                                               z > 0)):
        v, n, tri = pmc.extract_mesh_sparse(t, m, 0.01, z_band=5)
        ref = jmc.extract_mesh(jnp.asarray(t.numpy()),
                               jax_gradients(jnp.asarray(t.numpy())),
                               jnp.asarray(m.numpy()), 0.01)
        assert v.shape == n.shape == (0, 3) and tri.shape == (0, 3)
        assert len(ref[0]) == len(ref[2]) == 0


def test_gradients_match_jax():
    """``compute_gradients`` as the JAX package's (exact): the JAX
    export's stored object gradients ``o.grads`` are this function of the
    fused tsdf (``pipeline.py:779-782``), so meshing from the tsdf alone
    gives the JAX export's normals."""
    tsdf, _ = scene_tsdf((20, 24, 28), 0.02, 3)
    np.testing.assert_array_equal(
        compute_gradients(torch.tensor(tsdf)).numpy(),
        np.asarray(jax_gradients(jnp.asarray(tsdf))))


def test_pool_matches_jax():
    """``extract_pool_meshes`` over a pool of four 32^3 slots (a half-size
    sphere-and-box, its mirror image, one at another voxel size, one
    masked out) in one pass against the JAX pooled extraction, slot by
    slot (each mesh under the JAX per-slot capacity of 4 R^2 vertices,
    where its meshes are whole)."""
    R = 32
    vols, masks = zip(*[scene_tsdf((R, R, R), 0.01, s, size=0.5)
                        for s in range(4)])
    pool = np.stack([vols[0], -vols[1], vols[2], vols[3]])
    pmask = np.stack(masks)
    pmask[3] = False
    vsz = np.array([0.01, 0.02, 0.005, 0.01], np.float32)
    out = pmc.extract_pool_meshes(torch.tensor(pool), torch.tensor(pmask),
                                  torch.tensor(vsz))
    ref = jmc.extract_pool_meshes(
        jnp.asarray(pool), jnp.stack([jax_gradients(jnp.asarray(v))
                                      for v in pool]),
        jnp.asarray(pmask), jnp.asarray(vsz))
    assert len(out) == 4 and len(out[3][0]) == 0
    for k in range(4):
        assert len(ref[k][0]) < 4 * R * R
        check(out[k], ref[k])
        single = pmc.extract_mesh(torch.tensor(pool[k]),
                                  torch.tensor(pmask[k]), float(vsz[k]))
        for a, b in zip(out[k], single):
            np.testing.assert_array_equal(a, b)
