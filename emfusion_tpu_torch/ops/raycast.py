"""Volume raycasting.

Port of ``emfusion_tpu/ops/raycast.py`` (reference ``kernel_raycastTSDF``,
``TSDF.cu:466-601``). :func:`raycast_volume` wraps kernel K4
(``csrc/raycast.cu``): a CUDA tensor launches the kernel (one thread per
ray), a CPU tensor takes :func:`raycast_volume_plain`, which marches the
rays in lock-step as the JAX version does, each step over the rays that
are still marching.

Both keep the reference's adaptive steps (truncdist -> voxel -> half a
voxel near the surface), the t* interpolation of the zero crossing with
the weight check at t*, the back-face early-out, the margins and the
per-phase ``max_steps`` budgets. Normals are the trilinear sample at t* of
the forward-difference gradient of ``ops.fusion.compute_gradients``; both
versions compute it at the 8 corners from the TSDF, so no gradient volume
is needed (the JAX function takes one as ``grads_vol``).

The volumes may be bf16 (the background under
``Params.volume_dtype="bfloat16"``): both versions convert every voxel
they read to float32 first, the differences of the normals too, as the
JAX pipeline's ``compute_gradients(bg_tsdf.astype(float32))`` does.
"""

from __future__ import annotations

import torch

from emfusion_tpu_torch import kernels
from emfusion_tpu_torch.geometry.camera import intrinsics
from emfusion_tpu_torch.geometry.sampling import (
    lerp8, scalar, trilinear_cell, trilinear_sample,
)
from emfusion_tpu_torch.volume import fg_probs


def _safe_dir(d):
    return torch.where(torch.abs(d) < 1e-12,
                       torch.where(d < 0, -1e-12, 1e-12), d)


def _gradient_sample(tsdf: torch.Tensor, vx, vy, vz, valid):
    """Trilinear sample of the forward-difference gradient (3, ...) with
    compute_gradients' zero outer slab, from the 8 corners' differences."""
    Z, Y, X = tsdf.shape
    base, fx, fy, fz = trilinear_cell((Z, Y, X), vx, vy, vz)
    flat = tsdf.reshape(-1)
    xc = base % X
    yc = (base // X) % Y
    zc = base // (X * Y)

    def grad(axis_stride):
        def corner(dz, dy, dx):
            idx = base + ((dz * Y + dy) * X + dx)
            inner = (zc + dz < Z - 1) & (yc + dy < Y - 1) & (xc + dx < X - 1)
            nxt = torch.clamp(idx + axis_stride, max=flat.numel() - 1)
            return torch.where(inner, flat[nxt].to(torch.float32)
                               - flat[idx].to(torch.float32), 0.0)
        return lerp8(corner, fx, fy, fz)

    g = torch.stack([grad(1), grad(X), grad(X * Y)])
    return torch.where(valid[None], g, 0.0)


def _zero_corners(vol: torch.Tensor, vx, vy, vz):
    """True where the 8 corners of the trilinear cell are all exactly 0.0
    (coordinates clipped as in ``trilinear_sample``)."""
    Z, Y, X = vol.shape
    base = trilinear_cell((Z, Y, X), vx, vy, vz)[0]
    flat = vol.reshape(-1)
    zero = None
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                c = flat[base + ((dz * Y + dy) * X + dx)] == 0.0
                zero = c if zero is None else zero & c
    return zero


def _rotate_back(R, a):
    """R^T a for a (3, ...) stack, summed left to right."""
    return torch.stack([R[0, i] * a[0] + R[1, i] * a[1] + R[2, i] * a[2]
                        for i in range(3)])


def raycast_volume_plain(tsdf_vol: torch.Tensor, weights_vol: torch.Tensor,
                         rel_rot_co, rel_trans_co, intr, voxel_size,
                         truncdist, height: int, width: int,
                         max_steps: int = 2048, stats: dict | None = None):
    """Plain PyTorch version of K4. ``rel_rot_co``/``rel_trans_co``: the
    camera-to-volume transform. Returns a dict with ``raylengths`` (t*
    where hit, else 0), ``vertices`` and ``normals`` (3, H, W) in camera
    coordinates, and the bool ``mask`` (H, W). ``stats``, if given,
    receives ``steps``: the march steps taken over all rays; per ray,
    ``steps_phase1`` and ``steps_phase2`` (int32 (H, W)); and over all
    phase-2 steps, ``samples`` (TSDF samples taken), ``zero_samples``
    (those whose 8 corners are all exactly 0.0: unobserved voxels) and
    ``weight_samples`` (those where the back-face test needs the weight
    sample: the TSDF went from negative to positive)."""
    Z, Y, X = tsdf_vol.shape
    dev = tsdf_vol.device
    fx, fy, cx, cy = intrinsics(intr)
    vs = scalar(voxel_size, tsdf_vol)
    td = scalar(truncdist, tsdf_vol)
    R = torch.as_tensor(rel_rot_co, dtype=torch.float32).to(dev)
    campos = torch.as_tensor(rel_trans_co, dtype=torch.float32).to(dev)
    res = [float(X), float(Y), float(Z)]

    xs = torch.arange(width, dtype=torch.float32, device=dev)
    ys = torch.arange(height, dtype=torch.float32, device=dev)
    ux = ((xs[None, :] - cx) / scalar(fx, tsdf_vol)).expand(height, width)
    uy = ((ys[:, None] - cy) / scalar(fy, tsdf_vol)).expand(height, width)
    ray = torch.stack([R[i, 0] * ux + R[i, 1] * uy + R[i, 2] * 1.0
                       for i in range(3)])
    norm = torch.sqrt(ray[0] * ray[0] + ray[1] * ray[1] + ray[2] * ray[2])
    dirs = ray / norm

    d = _safe_dir(dirs)
    t_enter = t_exit = None
    for i in range(3):
        box = (res[i] - 1.0) / 2.0 * vs
        lo = torch.where(d[i] > 0, -box, box)
        hi = torch.where(d[i] > 0, box, -box)
        te = (lo - campos[i]) / d[i]
        tx = (hi - campos[i]) / d[i]
        t_enter = te if t_enter is None else torch.maximum(t_enter, te)
        t_exit = tx if t_exit is None else torch.minimum(t_exit, tx)
    raylength = t_enter + vs
    max_raylength = t_exit - vs
    alive = raylength < max_raylength

    def grid_at(t):
        return [(campos[i] + dirs[i] * t) / vs + (res[i] - 1.0) / 2.0
                for i in range(3)]

    def inside(v, margin):
        vx, vy, vz = v
        return ((vx >= 0.0) & (vx + margin < res[0])
                & (vy >= 0.0) & (vy + margin < res[1])
                & (vz >= 0.0) & (vz + margin < res[2]))

    count = stats is not None
    if count:
        steps1 = torch.zeros(raylength.shape, dtype=torch.int32, device=dev)
        steps2 = torch.zeros_like(steps1)
        n_samples = n_zero = n_weight = 0

    # phase 1: skip ahead at truncdist steps until inside (margin 1)
    for _ in range(max_steps):
        need = alive & ~inside(grid_at(raylength), 1.0) \
            & (raylength < max_raylength)
        if not bool(need.any()):
            break
        raylength = torch.where(need, raylength + td, raylength)
        if count:
            steps1 += need

    v0 = grid_at(raylength)
    cur = trilinear_sample(tsdf_vol, *v0, inside(v0, 1.0))
    raystep = torch.full_like(raylength, float(truncdist))
    raystep = torch.where(torch.abs(cur) < 1.0, vs, raystep)
    raystep = torch.where(torch.abs(cur) < 0.8, 0.5 * vs, raystep)

    # phase 2: adaptive march, over the rays still marching only: each
    # ray's arithmetic is elementwise, so this equals the lock-step march
    # of every ray under its mask, step for step and bit for bit
    hit = torch.zeros_like(alive)
    t_star = torch.zeros_like(raylength)
    rl_f, rs_f = raylength.reshape(-1), raystep.reshape(-1)
    cur_f, mrl_f = cur.reshape(-1), max_raylength.reshape(-1)
    hit_f, ts_f = hit.reshape(-1), t_star.reshape(-1)
    d_f = dirs.reshape(3, -1)
    if count:
        steps2_f = steps2.reshape(-1)
    idx = torch.nonzero(alive.reshape(-1)).squeeze(1)
    steps = 0

    def grid_sub(t, dd):
        return [(campos[i] + dd[i] * t) / vs + (res[i] - 1.0) / 2.0
                for i in range(3)]

    for _ in range(max_steps):
        if idx.numel() == 0:
            break
        steps += idx.numel()
        rs, c, dd = rs_f[idx], cur_f[idx], d_f[:, idx]
        t_new = rl_f[idx] + rs
        in_budget = t_new <= mrl_f[idx]
        v = grid_sub(t_new, dd)
        do_sample = in_budget & inside(v, 2.0)
        nxt = trilinear_sample(tsdf_vol, *v, do_sample)
        w = trilinear_sample(weights_vol, *v, do_sample)
        if count:
            steps2_f[idx] += 1
            n_samples = n_samples + do_sample.sum()
            n_zero = n_zero + (do_sample & _zero_corners(tsdf_vol, *v)).sum()
            n_weight = n_weight + (do_sample & (c < 0) & (nxt > 0)).sum()
        backface = do_sample & (c < 0) & (nxt > 0) & (w > 0)
        step_new = torch.where(do_sample & (torch.abs(nxt) < 1.0), vs, rs)
        step_new = torch.where(do_sample & (torch.abs(nxt) < 0.8),
                               0.5 * vs, step_new)
        step_new = torch.where(backface, rs, step_new)
        crossing = do_sample & ~backface & (c > 0) & (nxt < 0)
        denom = nxt - c
        denom = torch.where(torch.abs(denom) > 1e-30, denom, 1e-30)
        ts = t_new - step_new * c / denom
        vstar = grid_sub(ts, dd)
        vstar_inb = inside(vstar, 2.0)
        wstar = trilinear_sample(weights_vol, *vstar, crossing & vstar_inb)
        hit_now = crossing & vstar_inb & (wstar > 0)
        skip_update = crossing & ~vstar_inb
        cur_f[idx] = torch.where(do_sample & ~backface & ~skip_update, nxt,
                                 c)
        rl_f[idx] = t_new
        rs_f[idx] = step_new
        hit_f[idx] = hit_now
        ts_f[idx] = torch.where(hit_now, ts, ts_f[idx])
        idx = idx[in_budget & ~backface & ~hit_now]
    if count:
        stats.update(steps=steps, steps_phase1=steps1, steps_phase2=steps2,
                     samples=int(n_samples), zero_samples=int(n_zero),
                     weight_samples=int(n_weight))

    vstar = grid_at(t_star)
    grad = _gradient_sample(tsdf_vol, *vstar, hit)
    gnorm = torch.sqrt(grad[0] * grad[0] + grad[1] * grad[1]
                       + grad[2] * grad[2])
    grad = grad / torch.where(gnorm > 0, gnorm, 1.0)
    vertices = _rotate_back(R, dirs * t_star[None])
    normals = _rotate_back(R, grad)
    return {
        "raylengths": torch.where(hit, t_star, 0.0),
        "vertices": torch.where(hit[None], vertices, 0.0),
        "normals": torch.where(hit[None], normals, 0.0),
        "mask": hit,
    }


def raycast_object(tsdf_vol: torch.Tensor, weights_vol: torch.Tensor,
                   fg_counts: torch.Tensor, rel_rot_co, rel_trans_co, intr,
                   voxel_size, truncdist, height: int, width: int,
                   max_steps: int = 2048):
    """An object's raycast (``pipeline.py:609-614``): K4 on its volume with
    the weights zeroed wherever the foreground probability is not above
    0.5, so only the object's own surface is hit."""
    masked = torch.where(fg_probs(fg_counts) > 0.5, weights_vol, 0.0)
    return raycast_volume(tsdf_vol, masked, rel_rot_co, rel_trans_co, intr,
                          voxel_size, truncdist, height, width, max_steps)


def raycast_volume(tsdf_vol: torch.Tensor, weights_vol: torch.Tensor,
                   rel_rot_co, rel_trans_co, intr, voxel_size, truncdist,
                   height: int, width: int, max_steps: int = 2048):
    """Kernel K4 wrapper (see :func:`raycast_volume_plain`). The kernel
    takes a tsdf and weights of one dtype, float32 or bf16."""
    if not tsdf_vol.is_cuda:
        return raycast_volume_plain(tsdf_vol, weights_vol, rel_rot_co,
                                    rel_trans_co, intr, voxel_size,
                                    truncdist, height, width, max_steps)
    Z, Y, X = tsdf_vol.shape
    dev = tsdf_vol.device
    f32 = torch.float32
    rl = torch.empty((height, width), dtype=f32, device=dev)
    verts = torch.empty((3, height, width), dtype=f32, device=dev)
    norms = torch.empty((3, height, width), dtype=f32, device=dev)
    mask = torch.empty((height, width), dtype=torch.bool, device=dev)
    tsdf_vol = tsdf_vol.contiguous()
    weights_vol = weights_vol.contiguous()
    bf16 = kernels.volume_dtype_code("raycast_volume", tsdf_vol,
                                     weights_vol)
    dev = kernels.check_cuda("raycast_volume", tsdf_vol, weights_vol, rl,
                             verts, norms, mask, allow_bf16=True)
    fx, fy, cx, cy = intrinsics(intr)
    kernels.launch("raycast", tsdf_vol.data_ptr(), weights_vol.data_ptr(),
                   rl.data_ptr(), verts.data_ptr(), norms.data_ptr(),
                   mask.data_ptr(), Z, Y, X, height, width,
                   *kernels.pose_args(rel_rot_co, rel_trans_co),
                   fx, fy, cx, cy, float(voxel_size), float(truncdist),
                   int(max_steps), bf16, device=dev, shapes=[(Z, Y, X)])
    return {"raylengths": rl, "vertices": verts, "normals": norms,
            "mask": mask}
