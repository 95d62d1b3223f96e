"""Port parity: the E-step's ψ sample (kernel K2's plain version) and the
association weights, and the camera LM's window capture (kernel K3's
plain version) with its cache samplers, against
``emfusion_tpu/geometry/sampling.py``, ``ops/association.py`` and
``geometry/capture.py`` on the CPU, on the fused scene of
``test_torch_fusion``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emfusion_tpu.geometry import capture as jcap
from emfusion_tpu.geometry.camera import backproject_depth
from emfusion_tpu.geometry.sampling import (
    sample_volume_at_points as jax_sample,
)
from emfusion_tpu.ops import association as jassoc
from emfusion_tpu_torch import kernels
from emfusion_tpu_torch.geometry import capture as pcap
from emfusion_tpu_torch.geometry.sampling import (
    SampleItem, sample_items, sample_volume_at_points,
)
from emfusion_tpu_torch.ops import association as passoc
from test_torch_fusion import RES, TRUNC, VOXEL, fused_scene, rel_co

torch.set_num_threads(2)

SHAPE = (RES, RES, RES)


def scene_points(i=2, extra=200, seed=1):
    """(3, N) points: frame ``i`` back-projected (holes give z = 0), plus
    random points around and beyond the volume's faces, some behind the
    camera, to exercise the margins and the sentinel."""
    _, _, depths, intr = fused_scene()
    pts = np.asarray(backproject_depth(jnp.asarray(depths[i]),
                                       jnp.asarray(intr))).reshape(3, -1)
    rng = np.random.RandomState(seed)
    far = rng.uniform(-1.6, 1.6, (3, extra)).astype(np.float32)
    far[2] += 1.3
    far[2, :20] = -np.abs(far[2, :20])
    return np.concatenate([pts, far], axis=1)


@pytest.mark.parametrize("margin", [1, 2])
@pytest.mark.parametrize("jitter", [0.0, 0.01])
def test_sample_volume_at_points_matches_jax(margin, jitter):
    """Same float32 arithmetic in the same order: values within 1e-6 (the
    TSDF is in [-1, 1]) and the exact-zero sentinel at the same points."""
    tsdf, _, _, _ = fused_scene()
    pts = scene_points()
    R, t = rel_co(2, jitter)
    ref = np.asarray(jax_sample(jnp.asarray(tsdf), jnp.asarray(pts),
                                jnp.asarray(R), jnp.asarray(t), VOXEL,
                                margin=margin))
    before = dict(kernels.launches)
    out = sample_volume_at_points(torch.tensor(tsdf), torch.tensor(pts),
                                  torch.tensor(R), torch.tensor(t), VOXEL,
                                  margin=margin).numpy()
    assert kernels.launches == before
    np.testing.assert_array_equal(out == 0.0, ref == 0.0)
    assert 0.2 < (ref != 0).mean() < 0.99
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


def test_association_weights_match_jax():
    """Laplace mixture and per-pixel normalisation (no objects), from the
    ψ sample of K2's wrapper (``sample_items``, a one-item table): 1e-6
    relative, with the same invalid pixels."""
    tsdf, _, depths, intr = fused_scene()
    H, W = depths[2].shape
    pts = scene_points(extra=0).reshape(3, H, W)
    R, t = rel_co(2)
    args = (VOXEL, TRUNC, 0.02, 0.8, 1.0)
    ref_w, _ = jassoc.association_weights(jnp.asarray(tsdf),
                                          jnp.asarray(pts), jnp.asarray(R),
                                          jnp.asarray(t), *args)
    ref_lap, ref_inv = jassoc.compute_laplace(
        jnp.asarray(tsdf), jnp.asarray(pts), jnp.asarray(R),
        jnp.asarray(t), *args[:3])
    ref_n, _ = jassoc.normalize_associations(ref_w, jnp.zeros((0, H, W)),
                                             jnp.zeros((0,), bool))
    tt = [torch.tensor(a) for a in (tsdf, pts, R, t)]
    [(psi, _)] = sample_items([SampleItem(*tt, VOXEL)])
    w = passoc.weights_from_samples(psi, *args[1:])
    lap, inv = passoc.laplace_from_psi(psi, *args[1:3])
    n, _ = passoc.normalize_associations(w, torch.zeros((0, H, W)),
                                         torch.zeros(0, dtype=torch.bool))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(ref_inv))
    for port, ref in ((w, ref_w), (lap, ref_lap), (n, ref_n)):
        np.testing.assert_allclose(port.numpy(), np.asarray(ref),
                                   rtol=1e-6, atol=1e-7)
    assert set(np.unique(n.numpy())) <= {0.0, 1.0}


def test_normalize_associations_with_objects_matches_jax():
    rng = np.random.RandomState(5)
    bg = rng.uniform(0, 1, (12, 16)).astype(np.float32)
    bg[0] = 0.0
    obj = rng.uniform(0, 1, (3, 12, 16)).astype(np.float32)
    obj[:, 0, :4] = 0.0
    act = np.array([True, False, True])
    rb, ro = jassoc.normalize_associations(jnp.asarray(bg), jnp.asarray(obj),
                                           jnp.asarray(act))
    pb, po = passoc.normalize_associations(torch.tensor(bg),
                                           torch.tensor(obj),
                                           torch.tensor(act))
    np.testing.assert_allclose(pb.numpy(), np.asarray(rb), rtol=1e-6)
    np.testing.assert_allclose(po.numpy(), np.asarray(ro), rtol=1e-6)


@pytest.fixture(scope="module")
def captured():
    """Both packages' capture at frame 2's pose."""
    tsdf, weights, _, _ = fused_scene()
    pts = scene_points()
    R, t = rel_co(2)
    jc, ja = jcap.capture_neighborhoods(
        jnp.stack([jnp.asarray(tsdf), jnp.asarray(weights)]),
        jnp.asarray(pts), jnp.asarray(R), jnp.asarray(t), VOXEL)
    before = dict(kernels.launches)
    pc, pa = pcap.capture_neighborhoods(
        (torch.tensor(tsdf), torch.tensor(weights)), torch.tensor(pts),
        torch.tensor(R), torch.tensor(t), VOXEL)
    assert kernels.launches == before
    return pts, (np.asarray(jc), np.asarray(ja)), (pc, pa)


def test_capture_neighborhoods_is_exact(captured):
    """The same voxel reads, clipped at the faces, and the same unclipped
    anchors: bit for bit."""
    _, (jc, ja), (pc, pa) = captured
    assert pc.shape == (2, 6, 6, 6, ja.shape[1]) and pa.dtype == torch.int32
    np.testing.assert_array_equal(pa.numpy(), ja)
    np.testing.assert_array_equal(pc.numpy(), jc)
    assert (ja < 0).any() and (ja + 6 > RES).any()   # clipping exercised


@pytest.mark.parametrize("jitter", [0.0, 0.004, 0.03])
def test_cache_samplers_match_jax(captured, jitter):
    """Tent-product samples from the cache at an LM iterate's pose: the
    sums over the window run in the same order, so 1e-6 (values) and
    1e-6 / voxel (gradients); the drift check and the dropped-point count
    agree exactly. The largest jitter moves points out of their windows."""
    pts, (jc, ja), (pc, pa) = captured
    R, t = rel_co(2, jitter, seed=11)
    jargs = (jnp.asarray(ja), jnp.asarray(pts), jnp.asarray(R),
             jnp.asarray(t), VOXEL, SHAPE)
    pargs = (pa, torch.tensor(pts), torch.tensor(R), torch.tensor(t),
             VOXEL, SHAPE)
    for margin in (1, 2):
        ref = jcap.sample_value_from_cache(jnp.asarray(jc), *jargs,
                                           margin=margin)
        out = pcap.sample_value_from_cache(pc, *pargs, margin=margin)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-6)
    jpsi, jg = jcap.sample_system_from_cache(jnp.asarray(jc[0]), *jargs)
    ppsi, pg = pcap.sample_system_from_cache(pc[0], *pargs)
    np.testing.assert_allclose(ppsi.numpy(), np.asarray(jpsi), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(pg.numpy(), np.asarray(jg), rtol=0,
                               atol=1e-6 / VOXEL)
    n_out = int(pcap.out_of_window_count(*pargs))
    assert n_out == int(jcap.out_of_window_count(*jargs))
    assert bool(pcap.drift_ok(*pargs)) == bool(jcap.drift_ok(*jargs))
    if jitter == 0.0:
        assert n_out == 0
    if jitter == 0.03:
        assert n_out > 0 and not bool(pcap.drift_ok(*pargs))
