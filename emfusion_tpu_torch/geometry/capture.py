"""Per-point neighbourhood capture + tent-product resampling for the LM.

Port of ``emfusion_tpu/geometry/capture.py``. Each tracking point's 6^3
voxel window of the tsdf and weight volumes is gathered once
(:func:`capture_neighborhoods`, kernel K3, ``csrc/capture.cu``); every LM
iteration then evaluates its trilinear samples from the cache with
separable tent weights,

    trilerp(vol, v) == sum_d cache[d] * tent(v_local - d),
    tent(t) = max(0, 1 - |t|),

exact while ``v_local`` stays inside the window. A drift check
(:func:`drift_ok`) tells the LM when to re-capture. Caches are
``(C, 6, 6, 6, N)`` with the point index minor; anchors ``(3, N)`` int32
(x, y, z), unclipped.

The batched object LM captures S slots at once
(:func:`capture_neighborhoods_batched`: caches ``(S, 2, 6, 6, 6, M)``,
anchors ``(S, 3, M)``), and the cache samplers below take such leading
slot dimensions too: points ``(..., 3, N)``, rotations ``(..., 3, 3)``,
translations ``(..., 3)`` and voxel sizes ``(...)`` or a scalar.

A cache is stored in its volumes' dtype when that is bf16 (the JAX
package's ``tracking.py:157-165, 529-530``: the values are the bf16
voxels, so nothing is lost), float32 otherwise; the samplers read it as
float32.

On a CUDA tensor the capture launches K3, one launch for the camera or
for all slots of a batch (a work table, :func:`kernels.launch_table`); on
a CPU tensor it takes :func:`capture_neighborhoods_plain`.
"""

from __future__ import annotations

import torch

from emfusion_tpu_torch import kernels
from emfusion_tpu_torch.geometry.sampling import transform_to_grid

WIN = 6          # cached window size per axis
_ANCHOR_OFF = 2  # anchor = floor(v) - _ANCHOR_OFF -> v_local in [2, 3)


def cache_dtype(vol: torch.Tensor) -> torch.dtype:
    """The dtype of a capture cache of ``vol``: bf16 for a bf16 volume,
    else float32."""
    return torch.bfloat16 if vol.dtype == torch.bfloat16 else torch.float32


def capture_neighborhoods_plain(vols, points_cam: torch.Tensor, rel_rot,
                                rel_trans, voxel_size):
    """Plain PyTorch version of K3. ``vols``: the (Z, Y, X) volumes to
    capture, as a sequence or a channel-first stack; ``points_cam`` (3, N).
    Returns ``(cache (C, 6, 6, 6, N), anchor (3, N) int32)``, the cache
    in :func:`cache_dtype`; window reads are clipped to the volume."""
    Z, Y, X = vols[0].shape
    dev = vols[0].device
    vx, vy, vz, _ = transform_to_grid(points_cam, rel_rot, rel_trans,
                                      voxel_size, (Z, Y, X))
    ax = torch.floor(vx).to(torch.int32) - _ANCHOR_OFF
    ay = torch.floor(vy).to(torch.int32) - _ANCHOR_OFF
    az = torch.floor(vz).to(torch.int32) - _ANCHOR_OFF
    anchor = torch.stack([ax, ay, az])
    d = torch.arange(WIN, dtype=torch.int32, device=dev)[:, None]
    zc = torch.clamp(az[None] + d, 0, Z - 1).long()        # (W, N)
    yc = torch.clamp(ay[None] + d, 0, Y - 1).long()
    xc = torch.clamp(ax[None] + d, 0, X - 1).long()
    flat = ((zc[:, None, None] * Y + yc[None, :, None]) * X
            + xc[None, None])                               # (W, W, W, N)
    cache = torch.stack([v.reshape(-1)[flat].to(cache_dtype(vols[0]))
                         for v in vols])
    return cache, anchor


def capture_neighborhoods_batched_plain(tsdfs, weights, points_cam,
                                        rel_rot, rel_trans, voxel_sizes):
    """Plain PyTorch version of :func:`capture_neighborhoods_batched`:
    :func:`capture_neighborhoods_plain` per slot, stacked."""
    out = [capture_neighborhoods_plain((tsdfs[s], weights[s]),
                                       points_cam[s], rel_rot[s],
                                       rel_trans[s], voxel_sizes[s])
           for s in range(len(points_cam))]
    return (torch.stack([c for c, _ in out]),
            torch.stack([a for _, a in out]))


def _launch_capture(jobs) -> None:
    """K3 over ``jobs``: (tsdf, weights, points (3, N), rot, trans,
    voxel size, cache out (2, 6, 6, 6, N), anchor out (3, N)) each, in
    one launch (a work table); jobs without points are not sent. Two
    (Z, Y, X) volumes of float32 or bf16 with a cache of
    :func:`cache_dtype`, float32 (3, N) points, contiguous, on one CUDA
    device; anything else raises."""
    table, dev = [], None
    for tsdf, wts, pts, rot, trans, vs, cache, anchor in jobs:
        dt = kernels.volume_dtype_code("capture_neighborhoods", tsdf, wts)
        if tsdf.dim() != 3 or wts.shape != tsdf.shape or \
                pts.dtype != torch.float32 or \
                cache.dtype != cache_dtype(tsdf):
            raise ValueError("capture_neighborhoods: the CUDA kernel takes "
                             "two (Z, Y, X) volumes (tsdf, weights) of one "
                             "dtype, a cache of that dtype and float32 "
                             "(3, N) points")
        dev = kernels.check_cuda("capture_neighborhoods", tsdf, wts, pts,
                                 cache, anchor, allow_bf16=True, device=dev)
        N = pts.shape[1]
        if N == 0:
            continue
        Z, Y, X = tsdf.shape
        table.append(kernels.CaptureArgs(
            tsdf.data_ptr(), wts.data_ptr(), pts.data_ptr(),
            cache.data_ptr(), anchor.data_ptr(), N, Z, Y, X, dt,
            kernels.pose_array(rot, trans), float(vs)))
    kernels.launch_table("capture", table, device=dev)


def capture_buffers(vol: torch.Tensor, n: int, lead=(), device=None):
    """Empty outputs of a capture of ``n`` points: a (``*lead``, 2, 6, 6,
    6, n) cache in the :func:`cache_dtype` of ``vol`` and (``*lead``, 3,
    n) int32 anchors, on ``device`` (else ``vol``'s)."""
    dev = vol.device if device is None else device
    return (torch.empty((*lead, 2, WIN, WIN, WIN, n), dtype=cache_dtype(vol),
                        device=dev),
            torch.empty((*lead, 3, n), dtype=torch.int32, device=dev))


def capture_into(jobs) -> None:
    """Kernel K3 wrapper writing into given tensors: per job (tsdf,
    weights, points (3, N), rot, trans, voxel size, cache (2, 6, 6, 6, N),
    anchor (3, N)), the windows and anchors of its points at its pose into
    its cache and anchor. On a CUDA device one launch for every job
    (:func:`_launch_capture`), else :func:`capture_neighborhoods_plain`
    per job, copied in."""
    jobs = list(jobs)
    if jobs and jobs[0][0].is_cuda:
        _launch_capture(jobs)
        return
    for tsdf, wts, pts, rot, trans, vs, cache, anchor in jobs:
        c, a = capture_neighborhoods_plain((tsdf, wts), pts, rot, trans, vs)
        cache.copy_(c)
        anchor.copy_(a)


def capture_neighborhoods(vols, points_cam: torch.Tensor, rel_rot,
                          rel_trans, voxel_size):
    """Kernel K3 wrapper (see :func:`capture_neighborhoods_plain`): one
    job of :func:`capture_into`. The kernel takes two volumes, ``(tsdf,
    weights)``, which need not be stacked (a stack of two 512^3 volumes
    would copy 1 GB)."""
    if len(vols) != 2:
        raise ValueError("capture_neighborhoods: the capture takes two "
                         "volumes (tsdf, weights)")
    pts = points_cam.contiguous()
    cache, anchor = capture_buffers(vols[0], pts.shape[1])
    capture_into([(vols[0], vols[1], pts, rel_rot, rel_trans, voxel_size,
                   cache, anchor)])
    return cache, anchor


def capture_neighborhoods_batched(tsdfs, weights, points_cam: torch.Tensor,
                                  rel_rot, rel_trans, voxel_sizes):
    """The capture of S slots (``capture.py:112-176`` of the JAX package):
    ``tsdfs``/``weights`` S (Z, Y, X) volumes each (a sequence, or a
    stacked (S, Z, Y, X) tensor; shapes may differ between slots),
    ``points_cam`` (S, 3, M), ``rel_rot`` (S, 3, 3), ``rel_trans`` (S, 3)
    and ``voxel_sizes`` (S,) on the host. Returns ``(cache (S, 2, 6, 6,
    6, M), anchor (S, 3, M) int32)``, each slot's the clipped voxel
    reads of :func:`capture_neighborhoods_plain`, the cache in the
    :func:`cache_dtype` of the first slot's volume (all slots share one
    dtype): :func:`capture_into` with a job a slot (on the card one K3
    launch for every slot)."""
    S, _, M = points_cam.shape
    pts = points_cam.contiguous()
    cache, anchor = capture_buffers(tsdfs[0], M, (S,), pts.device)
    capture_into([(tsdfs[s], weights[s], pts[s], rel_rot[s], rel_trans[s],
                   voxel_sizes[s], cache[s], anchor[s]) for s in range(S)])
    return cache, anchor


def _tents(vl: torch.Tensor) -> torch.Tensor:
    """(..., WIN, N) hat-function weights: tent(vl - d)."""
    d = torch.arange(WIN, dtype=torch.float32, device=vl.device)[:, None]
    return torch.clamp(1.0 - torch.abs(vl[..., None, :] - d), min=0.0)


def _grid(points_cam, rel_rot, rel_trans, voxel_size, shape):
    """:func:`~emfusion_tpu_torch.geometry.sampling.transform_to_grid`
    over leading slot dimensions (points (..., 3, N)), with the same
    products and sums in the same order."""
    Z, Y, X = shape
    dev = points_cam.device
    R = torch.as_tensor(rel_rot, dtype=torch.float32).to(dev)[..., None]
    t = torch.as_tensor(rel_trans, dtype=torch.float32).to(dev)[..., None]
    vs = torch.as_tensor(voxel_size, dtype=torch.float32).to(dev)[..., None]
    px = points_cam[..., 0, :]
    py = points_cam[..., 1, :]
    pz = points_cam[..., 2, :]
    wx = R[..., 0, 0, :] * px + R[..., 0, 1, :] * py + R[..., 0, 2, :] * pz \
        + t[..., 0, :]
    wy = R[..., 1, 0, :] * px + R[..., 1, 1, :] * py + R[..., 1, 2, :] * pz \
        + t[..., 1, :]
    wz = R[..., 2, 0, :] * px + R[..., 2, 1, :] * py + R[..., 2, 2, :] * pz \
        + t[..., 2, :]
    vx = wx / vs + (X - 1.0) / 2.0
    vy = wy / vs + (Y - 1.0) / 2.0
    vz = wz / vs + (Z - 1.0) / 2.0
    return vx, vy, vz, pz


def _local_coords(anchor, points_cam, rel_rot, rel_trans, voxel_size,
                  shape):
    vx, vy, vz, pz = _grid(points_cam, rel_rot, rel_trans, voxel_size,
                           shape)
    lx = vx - anchor[..., 0, :].to(torch.float32)
    ly = vy - anchor[..., 1, :].to(torch.float32)
    lz = vz - anchor[..., 2, :].to(torch.float32)
    return (vx, vy, vz, pz), (lx, ly, lz)


def _relevant(vx, vy, vz, pz, shape):
    """In front of the camera and within one voxel of the volume."""
    Z, Y, X = shape
    return (pz > 0) & (vx >= -1) & (vy >= -1) & (vz >= -1) \
        & (vx < X) & (vy < Y) & (vz < Z)


def _window_ok(lx, ly, lz):
    """Local coords (incl. the +1-shifted system tents) stay inside the
    cached window; drifted points drop out here."""
    hi = WIN - 2.0
    return ((lx >= 0) & (lx <= hi) & (ly >= 0) & (ly <= hi)
            & (lz >= 0) & (lz <= hi))


def out_of_window_count(anchor, points_cam, rel_rot, rel_trans, voxel_size,
                        shape) -> torch.Tensor:
    """Number of relevant points outside their cached windows at this
    pose (int tensor, one per slot)."""
    (vx, vy, vz, pz), (lx, ly, lz) = _local_coords(
        anchor, points_cam, rel_rot, rel_trans, voxel_size, shape)
    rel = _relevant(vx, vy, vz, pz, shape)
    return torch.sum(rel & ~_window_ok(lx, ly, lz), dim=-1)


DRIFT_TOL = 0.01


def drift_counts(anchor, points_cam, rel_rot, rel_trans, voxel_size,
                 shape):
    """(relevant points that left their windows (``vl`` outside [0, WIN-2]
    on an axis), relevant points), float32, one per slot."""
    (vx, vy, vz, pz), (lx, ly, lz) = _local_coords(
        anchor, points_cam, rel_rot, rel_trans, voxel_size, shape)
    rel = _relevant(vx, vy, vz, pz, shape)
    hi = WIN - 2.0
    bad = (lx < 0) | (lx > hi) | (ly < 0) | (ly > hi) \
        | (lz < 0) | (lz > hi)
    return (torch.sum((rel & bad).to(torch.float32), dim=-1),
            torch.sum(rel.to(torch.float32), dim=-1))


def drift_within(nbad, nrel, tol: float = DRIFT_TOL):
    """The drift test on :func:`drift_counts`' (possibly summed) counts."""
    return nbad <= tol * torch.clamp(nrel, min=1.0)


def drift_ok(anchor, points_cam, rel_rot, rel_trans, voxel_size, shape,
             tol: float = DRIFT_TOL) -> torch.Tensor:
    """True (bool tensor, one per slot) iff at most ``tol`` of the
    relevant points left their windows (``vl`` outside [0, WIN-2] on an
    axis)."""
    return drift_within(*drift_counts(anchor, points_cam, rel_rot,
                                      rel_trans, voxel_size, shape), tol)


def _cache_valid(grid, local, shape, margin: int):
    """Where a cache sample at margin ``margin`` is valid: in front of the
    camera, inside the volume and inside the point's window."""
    Z, Y, X = shape
    vx, vy, vz, pz = grid
    return (pz > 0) & (vx >= 0.0) & (vy >= 0.0) & (vz >= 0.0) \
        & (vx + margin < X) & (vy + margin < Y) & (vz + margin < Z) \
        & _window_ok(*local)


def valid_in_cache(anchor, points_cam, rel_rot, rel_trans, voxel_size,
                   shape, margin: int = 1) -> torch.Tensor:
    """(..., N) bool: where :func:`sample_value_from_cache` samples a valid
    value at this pose (elsewhere it gives 0)."""
    grid, local = _local_coords(anchor, points_cam, rel_rot, rel_trans,
                                voxel_size, shape)
    return _cache_valid(grid, local, shape, margin)


def sample_value_from_cache(cache: torch.Tensor, anchor, points_cam,
                            rel_rot, rel_trans, voxel_size, shape,
                            margin: int = 1) -> torch.Tensor:
    """Cache equivalent of ``sample_volume_at_points`` (same validity,
    :func:`valid_in_cache`). ``cache`` (..., C, W, W, W, N) ->
    (..., C, N)."""
    grid, (lx, ly, lz) = _local_coords(
        anchor, points_cam, rel_rot, rel_trans, voxel_size, shape)
    valid = _cache_valid(grid, (lx, ly, lz), shape, margin)
    cx = torch.sum(cache * _tents(lx)[..., None, None, None, :, :], dim=-2)
    cy = torch.sum(cx * _tents(ly)[..., None, None, :, :], dim=-2)
    out = torch.sum(cy * _tents(lz)[..., None, :, :], dim=-2)
    return torch.where(valid[..., None, :], out, 0.0)


def sample_system_from_cache(cache_t: torch.Tensor, anchor, points_cam,
                             rel_rot, rel_trans, voxel_size, shape):
    """Cache equivalent of ``sample_system_at_points``: residual psi
    (margin-1 validity) and the finite-difference gradient (margin 2, with
    the direct sampler's per-shift validity). ``cache_t`` is the TSDF
    channel (..., W, W, W, N). Returns (psi (..., N), g3 (..., 3, N))."""
    Z, Y, X = shape
    (vx, vy, vz, pz), (lx, ly, lz) = _local_coords(
        anchor, points_cam, rel_rot, rel_trans, voxel_size, shape)
    tx, tx1 = _tents(lx), _tents(lx + 1.0)
    ty, ty1 = _tents(ly), _tents(ly + 1.0)
    tz, tz1 = _tents(lz), _tents(lz + 1.0)

    def over(t, lead):
        return t[(Ellipsis,) + (None,) * lead + (slice(None), slice(None))]

    cx = torch.sum(cache_t * over(tx, 2), dim=-2)            # (W, W, N)
    cx1 = torch.sum(cache_t * over(tx1, 2), dim=-2)
    cy = torch.sum(cx * over(ty, 1), dim=-2)                 # (W, N)
    cy1 = torch.sum(cx * over(ty1, 1), dim=-2)
    cy_x1 = torch.sum(cx1 * over(ty, 1), dim=-2)

    base_val = torch.sum(cy * tz, dim=-2)                    # (N,)
    sx = torch.sum(cy_x1 * tz, dim=-2)
    sy = torch.sum(cy1 * tz, dim=-2)
    sz = torch.sum(cy * tz1, dim=-2)

    inside = (pz > 0) & (vx >= 0.0) & (vy >= 0.0) & (vz >= 0.0) \
        & _window_ok(lx, ly, lz)
    valid1 = inside & (vx + 1 < X) & (vy + 1 < Y) & (vz + 1 < Z)
    valid2 = inside & (vx + 2 < X) & (vy + 2 < Y) & (vz + 2 < Z)
    psi = torch.where(valid1, base_val, 0.0)
    base = torch.where(valid2, base_val, 0.0)

    def vld(ex, ey, ez):
        return ((pz > 0)
                & (vx + ex >= 0.0) & (vy + ey >= 0.0) & (vz + ez >= 0.0)
                & (vx + ex + 2 < X) & (vy + ey + 2 < Y)
                & (vz + ez + 2 < Z))

    sx = torch.where(vld(1, 0, 0), sx, 0.0)
    sy = torch.where(vld(0, 1, 0), sy, 0.0)
    sz = torch.where(vld(0, 0, 1), sz, 0.0)
    vs = torch.as_tensor(voxel_size, dtype=torch.float32).to(cache_t.device)
    g3 = torch.stack([sx - base, sy - base, sz - base], dim=-2) \
        / vs[..., None, None]
    return psi, g3
