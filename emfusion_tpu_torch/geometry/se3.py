"""SE(3) Lie-group operations on float32 tensors.

Port of ``emfusion_tpu/geometry/se3.py``. Twist layout matches Sophus:
``xi = [upsilon(3), omega(3)]``, translation first. Poses are 4x4 float32
matrices; every function takes leading batch dimensions.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _skew(w: torch.Tensor) -> torch.Tensor:
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    o = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([o, -wz, wy], dim=-1),
        torch.stack([wz, o, -wx], dim=-1),
        torch.stack([-wy, wx, o], dim=-1),
    ], dim=-2)


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def so3_exp(omega: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula, Taylor-safe near zero."""
    theta2 = torch.sum(omega * omega, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    K = _skew(omega)
    K2 = K @ K
    small = theta2 > _EPS
    a = torch.where(small, torch.sin(theta) / theta, 1.0 - theta2 / 6.0)
    b = torch.where(small, (1.0 - torch.cos(theta)) / theta2,
                    0.5 - theta2 / 24.0)
    return _eye3(omega) + a[..., None, None] * K + b[..., None, None] * K2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> axis-angle vector (robust away from theta=pi)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    w = torch.stack([
        R[..., 2, 1] - R[..., 1, 2],
        R[..., 0, 2] - R[..., 2, 0],
        R[..., 1, 0] - R[..., 0, 1],
    ], dim=-1)
    sin_theta = torch.sin(theta)
    small = torch.abs(sin_theta) < 1e-6
    scale = torch.where(small, 0.5 + theta * theta / 12.0,
                        theta / (2.0 * torch.where(small, 1.0, sin_theta)))
    near_pi = theta > 3.0
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis = torch.sqrt(torch.clamp((diag + 1.0) * 0.5, 0.0, 1.0))
    signs = torch.sign(torch.where(torch.abs(w) > 1e-12, w, 1.0))
    w_pi = axis * signs * theta[..., None]
    return torch.where(near_pi[..., None], w_pi, w * scale[..., None])


def _bottom_row(top: torch.Tensor) -> torch.Tensor:
    row = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=top.dtype,
                       device=top.device)
    return torch.cat([top, row.expand(top.shape[:-2] + (1, 4))], dim=-2)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Twist [upsilon, omega] -> 4x4 pose (Sophus convention)."""
    ups, omega = xi[..., :3], xi[..., 3:]
    theta2 = torch.sum(omega * omega, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    K = _skew(omega)
    K2 = K @ K
    R = so3_exp(omega)
    small = theta2 > _EPS
    b = torch.where(small, (1.0 - torch.cos(theta)) / theta2,
                    0.5 - theta2 / 24.0)
    c = torch.where(small, (theta - torch.sin(theta)) / (theta2 * theta),
                    1.0 / 6.0 - theta2 / 120.0)
    V = _eye3(xi) + b[..., None, None] * K + c[..., None, None] * K2
    t = torch.einsum("...ij,...j->...i", V, ups)
    return _bottom_row(torch.cat([R, t[..., None]], dim=-1))


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """4x4 pose -> twist [upsilon, omega]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    omega = so3_log(R)
    theta2 = torch.sum(omega * omega, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    K = _skew(omega)
    K2 = K @ K
    cos_t = torch.cos(theta)
    sin_t = torch.sin(theta)
    denom = 2.0 * (1.0 - cos_t)
    coef = torch.where(
        theta2 > 1e-8,
        (1.0 - theta * sin_t
         / torch.where(torch.abs(denom) > 1e-12, denom, 1.0)) / theta2,
        1.0 / 12.0 + theta2 / 720.0)
    Vinv = _eye3(T) - 0.5 * K + coef[..., None, None] * K2
    ups = torch.einsum("...ij,...j->...i", Vinv, t)
    return torch.cat([ups, omega], dim=-1)


def pose_inverse(T: torch.Tensor) -> torch.Tensor:
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    ti = -torch.einsum("...ij,...j->...i", Rt, t)
    return _bottom_row(torch.cat([Rt, ti[..., None]], dim=-1))


def reorthonormalize(T: torch.Tensor) -> torch.Tensor:
    """Re-orthonormalize the rotation block via QR with a positive-diagonal
    sign fix (``TSDF::prepareTracking``, ``src/core/TSDF.cpp:174-186``).
    Returns a new tensor."""
    Q, Rm = torch.linalg.qr(T[..., :3, :3])
    signs = torch.sign(torch.diagonal(Rm, dim1=-2, dim2=-1))
    signs = torch.where(signs == 0, 1.0, signs)
    out = T.clone()
    out[..., :3, :3] = Q * signs[..., None, :]
    return out
