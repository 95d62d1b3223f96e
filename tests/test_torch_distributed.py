"""The port's ``distributed/`` on the CPU: the mesh's factorisation and
blocks, K1's slab form, the z-sharded marching cubes, the pixel-sharded
LM, sharded checkpoints and the launcher's failure handling, each held
against the one-process port and the JAX package's
``emfusion_tpu/distributed/`` (its 8 virtual CPU devices).

The ranks are gloo processes started by ``distributed.mesh.launch``; their
bodies are in ``tests/torch_dist_workers.py``, which imports nothing of
JAX. Every JAX call stays in this process.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from emfusion_tpu.checkpoint import load_checkpoint as jax_load
from emfusion_tpu.config import Params as JaxParams
from emfusion_tpu.distributed.mesh import make_mesh as jax_make_mesh
from emfusion_tpu.distributed.sharded_ops import (
    extract_mesh_zsharded as jax_extract_zsharded,
)
from emfusion_tpu.geometry import se3_exp as jax_se3_exp
from emfusion_tpu.ops.fusion import compute_gradients as jax_gradients
from emfusion_tpu.ops.fusion import integrate_tsdf as jax_integrate
from emfusion_tpu.pipeline import EMFusionPipeline as JaxPipeline
from emfusion_tpu.tracking import TrackConfig as JaxTrackConfig
from emfusion_tpu.tracking import track_volume as jax_track_volume
from emfusion_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
from emfusion_tpu_torch.distributed import comm
from emfusion_tpu_torch.distributed.mesh import (
    Mesh, initialize_multihost, launch, mesh_shape,
)
from emfusion_tpu_torch.ops.fusion import integrate_tsdf_plain
from emfusion_tpu_torch.ops.marching_cubes import extract_mesh
from emfusion_tpu_torch.tracking import TrackConfig, track_volume
import torch_dist_workers as W
from test_raycast import sphere_volume
from test_torch_fusion import TRUNC, fused_scene, rel_oc
from test_torch_mesh import check as mesh_check

torch.set_num_threads(2)


def jax_devices(n):
    if len(jax.devices()) < n:
        pytest.skip("needs the 8 virtual CPU devices of tests/conftest.py")
    return jax.devices()[:n]


# (a) -------------------------------------------------------------------
@pytest.mark.parametrize("n, shape", [(1, (1, 1)), (2, (1, 2)),
                                      (4, (2, 2)), (8, (4, 2))])
def test_mesh_factorizations(n, shape):
    """JAX's ``test_mesh_factorizations``: z gets 2 when n is even."""
    assert mesh_shape(n) == shape
    assert tuple(jax_make_mesh(len(jax_devices(n))).devices.shape) == shape


def test_mesh_blocks_and_indivisible_shapes():
    """Contiguous equal blocks, as NamedSharding cuts them; a Z or K that
    does not divide raises."""
    m = Mesh(shape=(2, 2), rank=3, device=torch.device("cpu"),
             backend="gloo", obj=None, z=None, world=None, stats=None)
    assert m.coords == (1, 1)
    assert m.slab(32) == (16, 32) and m.slots(16) == (8, 16)
    assert m.owner(7, 16) == 0 and m.owner(8, 16) == 1
    with pytest.raises(ValueError, match="Z"):
        m.slab(33)
    with pytest.raises(ValueError, match="max_objects"):
        m.slots(15)


# (b) -------------------------------------------------------------------
@pytest.mark.parametrize("res", [32, 64])
@pytest.mark.parametrize("n_slabs", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slab_fusion_plain(res, n_slabs, dtype):
    """The plain K1 on ``n_slabs`` z-slabs, each fused alone with its
    global first plane, is bit for bit the unsharded plain fusion; and
    (float32) the JAX ``ops/fusion.integrate_tsdf`` at the tolerance of
    ``tests/test_torch_fusion.py``."""
    tsdf0, w0, depths, intr = fused_scene()
    H, W = depths[2].shape
    assoc = np.random.RandomState(7).uniform(0, 1, (H, W)).astype(
        np.float32)
    R, t = rel_oc(2)
    # the fused scene's 48^3 volume, embedded in a res^3 one
    vol_t = np.zeros((res,) * 3, np.float32)
    vol_w = np.zeros((res,) * 3, np.float32)
    o = (res - 48) // 2 if res >= 48 else 0
    src = (slice(0, min(48, res)),) * 3
    dst = (slice(o, o + min(48, res)),) * 3
    vol_t[dst], vol_w[dst] = tsdf0[src], w0[src]
    vs = 2.56 / res
    args = (torch.tensor(depths[2]), torch.tensor(assoc), torch.tensor(R),
            torch.tensor(t), torch.tensor(intr), vs, TRUNC, 64.0,
            0.8 * TRUNC, 3.0, 0.25)
    whole_t = torch.tensor(vol_t).to(dtype)
    whole_w = torch.tensor(vol_w).to(dtype)
    integrate_tsdf_plain(whole_t, whole_w, *args)
    h = res // n_slabs
    for z0 in range(0, res, h):
        st = torch.tensor(vol_t[z0:z0 + h]).to(dtype)
        sw = torch.tensor(vol_w[z0:z0 + h]).to(dtype)
        integrate_tsdf_plain(st, sw, *args, z0=z0, Z=res)
        assert torch.equal(st, whole_t[z0:z0 + h])
        assert torch.equal(sw, whole_w[z0:z0 + h])
    assert not torch.equal(whole_w, torch.tensor(vol_w).to(dtype))
    if dtype == torch.float32:
        jt, jw = jax_integrate(*[jnp.asarray(np.asarray(a)) for a in (
            vol_t, vol_w, depths[2], assoc, R, t, intr)], vs, TRUNC, 64.0,
            0.8 * TRUNC, 3.0, 0.25)
        for port, ref in ((whole_t.numpy(), np.asarray(jt)),
                          (whole_w.numpy(), np.asarray(jw))):
            assert (np.abs(port - ref) > 1e-5).mean() <= 1e-4


# (c) -------------------------------------------------------------------
@pytest.fixture(scope="module")
def sphere_meshes():
    """JAX's scene (``tests/test_distributed.py:217-219``): the port's
    ``extract_mesh``, and JAX's ``extract_mesh_zsharded`` on 2 and 4 of
    the 8 virtual devices."""
    tsdf, weights = sphere_volume(64, 0.04, 0.8, 0.2)
    mask = weights > 0
    ref = extract_mesh(torch.tensor(tsdf), torch.tensor(mask), 0.04)
    jt = jnp.asarray(tsdf)
    jax_meshes = {
        n: jax_extract_zsharded(
            JaxMesh(np.array(jax_devices(n)).reshape(n), ("z",)), jt,
            jax_gradients(jt), jnp.asarray(mask), 0.04,
            max_verts_per_shard=65536, max_tris_per_shard=131072)
        for n in (2, 4)}
    return tsdf, mask, ref, jax_meshes


@pytest.mark.parametrize("n", [2, 4])
def test_zsharded_marching_cubes(sphere_meshes, n):
    """``extract_mesh_zsharded`` over ``n`` gloo ranks: rank 0 gets the
    port's ``extract_mesh`` vertex set (to 1e-5) and triangle count, the
    vertices bit for bit as a set, the same count as JAX's sharded MC,
    and valid triangle indices; the other ranks get None."""
    tsdf, mask, ref, jax_meshes = sphere_meshes
    res = launch("torch_dist_workers:mc_rank", n, args=(tsdf, mask, 0.04),
                 device="cpu", threads=1, timeout_s=120)
    assert all(r is None for r in res[1:])
    v, nrm, tri = res[0]
    assert len(v) == len(ref[0]) > 1000 and len(tri) == len(ref[2])
    assert np.array_equal(W.vertex_set(v), W.vertex_set(ref[0]))
    assert np.array_equal(np.sort(v.view(np.uint32).reshape(-1, 3), 0),
                          np.sort(ref[0].view(np.uint32).reshape(-1, 3), 0))
    assert tri.dtype == np.int32 and tri.min() >= 0 and tri.max() < len(v)
    # JAX's sharded mesh: the same vertices, normals and triangles within
    # 1e-5, as tests/test_torch_mesh.py holds the one-volume meshes
    mesh_check((v, nrm, tri), jax_meshes[n])
    # every triangle's corners are the same points as in the whole mesh
    assert np.array_equal(triangle_set(v, tri), triangle_set(*ref[::2]))


def triangle_set(v, tri):
    """The triangles as rows of their corners' points (rounded to 1e-5),
    sorted."""
    rows = np.ascontiguousarray(np.round(v[tri], 5).reshape(len(tri), 9))
    return np.sort(rows.view([(f"c{i}", "f4") for i in range(9)]), axis=0)


# (d) -------------------------------------------------------------------
def test_pixel_sharded_track_volume():
    """JAX's ``test_pixel_sharded_gn_tracking_matches`` scene (a 48^3
    sphere, 4,096 points, a perturbed start) tracked over 4 gloo ranks,
    each with its block of the points: every rank ends on the same pose
    bits, within 1e-5 of the one-process port and of JAX's unsharded
    ``track_volume``; the LM reduced 2-3 times an iteration."""
    res, voxel, trunc = 48, 0.05, 0.25
    idx = np.arange(res, dtype=np.float32) - (res - 1) / 2
    zz, yy, xx = np.meshgrid(idx, idx, idx, indexing="ij")
    r = np.sqrt(xx ** 2 + yy ** 2 + zz ** 2) * voxel
    tsdf = np.clip((r - 0.5) / trunc, -1, 1).astype(np.float32)
    weights = np.ones_like(tsdf)
    rng = np.random.RandomState(7)
    n = 4096
    v = rng.randn(n, 3)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    v[:, 2] = -np.abs(v[:, 2])
    gt = np.eye(4, dtype=np.float32)
    gt[2, 3] = -1.2
    T = np.linalg.inv(gt)
    pts = ((v * 0.5) @ T[:3, :3].T + T[:3, 3]).astype(np.float32).T
    init = (np.asarray(jax_se3_exp(jnp.array(
        [0.02, -0.03, 0.04, 0.02, -0.01, 0.015]))) @ gt).astype(np.float32)
    assoc = np.ones(n, np.float32)
    ref_jax = np.asarray(jax.jit(lambda *a: jax_track_volume(
        *a, JaxTrackConfig(max_iter=30))[0])(
        jnp.asarray(tsdf), jnp.asarray(weights), voxel, jnp.asarray(pts),
        jnp.asarray(assoc), jnp.asarray(init)))
    one, _ = track_volume(torch.tensor(tsdf), torch.tensor(weights), voxel,
                          torch.tensor(pts), torch.tensor(assoc),
                          torch.tensor(init), TrackConfig(max_iter=30))
    res4 = launch("torch_dist_workers:track_rank", 4,
                  args=(tsdf, weights, voxel, pts, assoc, init,
                        dict(max_iter=30)), device="cpu", threads=1,
                  timeout_s=120)
    pose = res4[0]["pose"]
    assert all(np.array_equal(r["pose"], pose) for r in res4)
    np.testing.assert_allclose(pose, one.numpy(), atol=1e-5)
    np.testing.assert_allclose(pose, ref_jax, atol=1e-5)
    assert np.abs(pose - init).max() > 0.01        # it moved
    it = res4[0]["iterations"]
    calls = res4[0]["comm"]["all_reduce"]["calls"]
    # per iteration a trial error; with a new gradient also the weight
    # maximum and the system
    assert it >= 3 and it <= calls <= 3 * it + 2


# (g) -------------------------------------------------------------------
CKPT = dict(W.SHARDED_PIPELINE, max_objects=2, visibilityThresh=16,
            mask_min_pixels=16, boundary=2, maskRCNNFrames=2)


def ckpt_masks():
    """A central mask at frames 0 and 2 (spawn, match)."""
    m = np.zeros((48, 64), bool)
    m[14:34, 20:44] = True
    return {0: [m], 2: [m]}


def test_checkpoints_both_ways(tmp_path):
    """A (2, 2) run's checkpoint (rank 0 writes the gathered state) loads
    into the one-card port and into the JAX pipeline with identical
    arrays; the one-card port's checkpoint loads into a (2, 2) mesh,
    where each rank keeps its slots, and saved again gives the same
    arrays."""
    frames = W.wave_frames(3)
    sharded = str(tmp_path / "sharded.npz")
    res = launch("torch_dist_workers:checkpoint_rank", 4,
                 args=(CKPT, frames, ckpt_masks(), sharded), device="cpu",
                 threads=1, timeout_s=120)
    arrays = res[0]["arrays"]
    assert [r["pool_rows"] for r in res] == [1, 1, 1, 1]
    assert res[0]["ids"] == [1] and all(r["arrays"] is None
                                        for r in res[1:])
    with np.load(sharded) as z:
        on_disk = {k: z[k] for k in z.files}
    for k, a in arrays.items():
        assert np.array_equal(on_disk[k], a), k
    # the same run on one process writes the same arrays
    one = W.make_pipeline(CKPT, ckpt_masks())
    for i, d in enumerate(frames):
        one.process_frame(None, d, timestamp=float(i))
    single = str(tmp_path / "single.npz")
    save_checkpoint(one, single)
    with np.load(single) as z:
        for k in z.files:
            if k != "__meta__":
                assert np.array_equal(z[k], on_disk[k]), k
    # sharded -> one card
    port = W.make_pipeline(CKPT, ckpt_masks())
    load_checkpoint(port, sharded)
    assert port.frame == 3 and port.active_object_ids == [1]
    assert np.array_equal(port.state.objs.tsdf.numpy(), on_disk["objs.tsdf"])
    # sharded -> JAX
    jpipe = JaxPipeline(JaxParams(**CKPT), None)
    jax_load(jpipe, sharded)
    assert jpipe.frame == 3
    for k in ("bg_tsdf", "bg_weights", "cam_pose"):
        assert np.array_equal(np.asarray(getattr(jpipe.state, k)),
                              on_disk[k])
    assert np.array_equal(np.asarray(jpipe.state.objs.tsdf),
                          on_disk["objs.tsdf"])
    # one card -> sharded, one more frame on both, the same arrays
    again = str(tmp_path / "again.npz")
    res2 = launch("torch_dist_workers:checkpoint_rank", 4,
                  args=(CKPT, W.wave_frames(4)[3:], ckpt_masks(), again,
                        single), device="cpu", threads=1, timeout_s=120)
    one.process_frame(None, W.wave_frames(4)[3], timestamp=3.0)
    save_checkpoint(one, single)
    with np.load(again) as a, np.load(single) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            if k != "__meta__":
                assert np.array_equal(a[k], b[k]), k
    assert res2[0]["frame"] == 4


# (i) -------------------------------------------------------------------
def test_failing_rank_ends_the_launch():
    """A rank that raises ends every rank; the launcher raises with its
    error, well within the timeout (the others were waiting in a
    collective)."""
    import time
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        launch("torch_dist_workers:failing_rank", 3, device="cpu",
               threads=1, timeout_s=60)
    assert time.monotonic() - t0 < 45


def test_launch_timeout_ends_the_ranks():
    with pytest.raises(TimeoutError):
        launch("torch_dist_workers:sleeping_rank", 2, args=(60.0,),
               device="cpu", timeout_s=3)


def test_initialize_multihost_raises_on_a_dead_address():
    """The JAX function returns False on any error; the port's raises."""
    from emfusion_tpu_torch.distributed.mesh import free_port
    with pytest.raises(Exception):
        initialize_multihost(f"127.0.0.1:{free_port()}", world_size=2,
                             rank=1, backend="gloo", timeout_s=2)
    assert not torch.distributed.is_initialized()


def test_cuda_tensor_on_unnamed_gloo_group_raises():
    res = launch("torch_dist_workers:staged_check_rank", 2, device="cpu",
                 threads=1, timeout_s=60)
    assert all(r is not None and "gloo" in r for r in res)


def test_comm_stats_count_per_kind():
    s = comm.CommStats()
    s.add("all_gather", 100, 1.5)
    s.add("all_gather", 50, 0.5)
    s.add("recv", 8, 0.25)
    assert s.summary() == {"all_gather": dict(calls=2, bytes=150, ms=2.0),
                           "recv": dict(calls=1, bytes=8, ms=0.25)}
    s.reset()
    assert s.summary() == {}
