"""Camera model + depth preprocessing.

Port of ``emfusion_tpu/geometry/camera.py``. :func:`bilateral_filter`
wraps kernel K5 (``csrc/bilateral.cu``): a CUDA tensor launches the
kernel, a CPU tensor takes :func:`bilateral_filter_plain`.
"""

from __future__ import annotations

import functools

import torch

from emfusion_tpu_torch import kernels


def backproject_depth(depth: torch.Tensor, intr) -> torch.Tensor:
    """Depth image (H, W) -> camera-space point map, component-first
    (3, H, W): p = ((x-cx)/fx*d, (y-cy)/fy*d, d). Pixels with depth 0 map
    to (0, 0, 0), which downstream code treats as invalid (z <= 0)."""
    H, W = depth.shape
    fx, fy, cx, cy = intrinsics(intr)
    xs = torch.arange(W, dtype=depth.dtype, device=depth.device)
    ys = torch.arange(H, dtype=depth.dtype, device=depth.device)
    u = (xs[None, :] - cx) / fx
    v = (ys[:, None] - cy) / fy
    return torch.stack([u * depth, v * depth, depth], dim=0)


def project_points(points: torch.Tensor, intr):
    """Camera-space points (3, ...) -> (px, py int32, z). Rounds half to
    even, like ``__float2int_rn`` in the reference's kernels."""
    fx, fy, cx, cy = intrinsics(intr)
    z = points[2]
    zsafe = torch.where(z > 0, z, 1.0)
    px = torch.round(points[0] * fx / zsafe + cx).to(torch.int32)
    py = torch.round(points[1] * fy / zsafe + cy).to(torch.int32)
    return px, py, z


def intrinsics(intr):
    """(fx, fy, cx, cy) as Python floats of their float32 values."""
    m = torch.as_tensor(intr, dtype=torch.float32).detach().cpu()
    return (float(m[0, 0]), float(m[1, 1]), float(m[0, 2]), float(m[1, 2]))


def _spatial_terms(kernel_size: int, sigma_spatial: float) -> list:
    """-(dx^2 + dy^2) / (2 sigma_s^2) per tap, row-major over (dy, dx)."""
    r = kernel_size // 2
    inv2ss = 1.0 / (2.0 * sigma_spatial * sigma_spatial)
    return [-(dx * dx + dy * dy) * inv2ss
            for dy in range(-r, r + 1) for dx in range(-r, r + 1)]


# the largest window K5 takes (EMF_MAX_R in csrc/bilateral.cu)
MAX_KERNEL_SIZE = 15


@functools.lru_cache(maxsize=None)
def _spatial_table(kernel_size: int, sigma_spatial: float) -> torch.Tensor:
    """The kernel's float32 spatial terms, a host table the launch copies
    into the kernel's parameters."""
    return torch.tensor(_spatial_terms(kernel_size, sigma_spatial),
                        dtype=torch.float32)


def bilateral_filter_plain(depth: torch.Tensor, kernel_size: int = 7,
                           sigma_depth: float = 0.04,
                           sigma_spatial: float = 4.5) -> torch.Tensor:
    """Plain PyTorch version of K5: k x k bilateral filter with a Gaussian
    spatial and range kernel, reflect-101 borders (OpenCV's default), and
    zero-depth taps left out."""
    r = kernel_size // 2
    inv2sd = 1.0 / (2.0 * sigma_depth * sigma_depth)
    H, W = depth.shape
    pad = torch.nn.functional.pad(depth[None, None], (r, r, r, r),
                                  mode="reflect")[0, 0]
    spatial = _spatial_terms(kernel_size, sigma_spatial)
    num = torch.zeros_like(depth)
    den = torch.zeros_like(depth)
    k = 0
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            shifted = pad[r + dy:r + dy + H, r + dx:r + dx + W]
            dv = shifted - depth
            w = torch.exp(spatial[k] - dv * dv * inv2sd)
            w = torch.where(shifted > 0, w, 0.0)
            num = num + w * shifted
            den = den + w
            k += 1
    return torch.where(den > 0, num / den, 0.0)


def bilateral_filter(depth: torch.Tensor, kernel_size: int = 7,
                     sigma_depth: float = 0.04,
                     sigma_spatial: float = 4.5) -> torch.Tensor:
    """Kernel K5 wrapper (see :func:`bilateral_filter_plain`)."""
    if not depth.is_cuda:
        return bilateral_filter_plain(depth, kernel_size, sigma_depth,
                                      sigma_spatial)
    H, W = depth.shape
    r = kernel_size // 2
    if r >= H or r >= W:
        raise ValueError("bilateral_filter: image smaller than the window")
    if kernel_size > MAX_KERNEL_SIZE:
        raise ValueError(f"bilateral_filter: the CUDA kernel takes windows "
                         f"up to {MAX_KERNEL_SIZE}, got {kernel_size}")
    depth = depth.contiguous()
    out = torch.empty_like(depth)
    spatial = _spatial_table(int(kernel_size), float(sigma_spatial))
    dev = kernels.check_cuda("bilateral_filter", depth, out)
    inv2sd = 1.0 / (2.0 * sigma_depth * sigma_depth)
    kernels.launch("bilateral", depth.data_ptr(), out.data_ptr(),
                   spatial.data_ptr(), H, W, r, inv2sd, device=dev)
    return out


def preprocess_depth(depth_raw: torch.Tensor, kernel_size: int = 7,
                     sigma_depth: float = 0.04,
                     sigma_spatial: float = 4.5) -> torch.Tensor:
    """Bilateral filter + invalid-pixel patching
    (``EMFusion::preprocessDepth``): NaN results and pixels whose raw
    depth is 0 are set to 0."""
    depth = bilateral_filter(depth_raw, kernel_size, sigma_depth,
                             sigma_spatial)
    depth = torch.where(torch.isnan(depth), 0.0, depth)
    return torch.where(depth_raw == 0.0, 0.0, depth)
