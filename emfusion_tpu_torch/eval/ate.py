"""Absolute Trajectory Error / Relative Pose Error evaluation.

In-repo reimplementation of the TUM RGB-D benchmark evaluation math
(Sturm et al., IROS 2012) that the reference drives through external
scripts (``eval_tum.sh:29-39``, ``eval_co-fusion.sh:49-76``):
Horn-alignment of estimated to ground-truth trajectories followed by
RMSE of translational residuals (ATE), and fixed-delta relative pose
errors (RPE). The reference repo does not ship this math; it is the
standard public protocol. A copy of the JAX package's ``eval/ate.py``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def load_trajectory(path: str) -> Dict[float, np.ndarray]:
    """Load a TUM-format trajectory ``stamp tx ty tz qx qy qz qw`` into
    {stamp: 4x4 pose}."""
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(v) for v in line.split()]
            if len(vals) < 8:
                continue
            stamp, tx, ty, tz, qx, qy, qz, qw = vals[:8]
            out[stamp] = _pose_from_quat(tx, ty, tz, qx, qy, qz, qw)
    return out


def _pose_from_quat(tx, ty, tz, qx, qy, qz, qw) -> np.ndarray:
    n = np.sqrt(qx * qx + qy * qy + qz * qz + qw * qw)
    qx, qy, qz, qw = qx / n, qy / n, qz / n, qw / n
    R = np.array([
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw),
         2 * (qx * qz + qy * qw)],
        [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz),
         2 * (qy * qz - qx * qw)],
        [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw),
         1 - 2 * (qx * qx + qy * qy)],
    ])
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = [tx, ty, tz]
    return T


def associate(est: Dict[float, np.ndarray], gt: Dict[float, np.ndarray],
              max_difference: float = 0.02):
    """Greedy timestamp association (TUM associate.py semantics).

    Same greedy-min-difference result as enumerating all stamp pairs, but
    candidates are restricted to each estimate stamp's tolerance window
    via binary search — O(N log N + C log C) instead of O(N^2) pairs
    (~6M tuples for a 2.5k-frame TUM sequence)."""
    est_keys = sorted(est.keys())
    gt_arr = np.asarray(sorted(gt.keys()), dtype=np.float64)
    candidates = []
    for a in est_keys:
        lo = np.searchsorted(gt_arr, a - max_difference, side="left")
        hi = np.searchsorted(gt_arr, a + max_difference, side="right")
        for b in gt_arr[lo:hi]:
            b = float(b)
            if abs(a - b) < max_difference:
                candidates.append((abs(a - b), a, b))
    candidates.sort()
    used_a, used_b, pairs = set(), set(), []
    for diff, a, b in candidates:
        if a not in used_a and b not in used_b:
            used_a.add(a)
            used_b.add(b)
            pairs.append((a, b))
    return sorted(pairs)


def align_horn(model: np.ndarray, data: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Horn closed-form rigid alignment of ``model`` (3, N) onto ``data``
    (3, N). Returns (rot, trans, per-point translational error)."""
    model_mean = model.mean(axis=1, keepdims=True)
    data_mean = data.mean(axis=1, keepdims=True)
    model_zc = model - model_mean
    data_zc = data - data_mean
    W = model_zc @ data_zc.T
    U, _, Vt = np.linalg.svd(W.T)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    rot = U @ S @ Vt
    trans = data_mean - rot @ model_mean
    aligned = rot @ model + trans
    err = np.sqrt(np.sum((aligned - data) ** 2, axis=0))
    return rot, trans, err


def evaluate_ate(est: Dict, gt: Dict, max_difference: float = 0.02) -> dict:
    """ATE RMSE after Horn alignment (evaluate_ate.py semantics)."""
    pairs = associate(est, gt, max_difference)
    if len(pairs) < 2:
        raise ValueError("not enough matched poses for ATE")
    xyz_est = np.stack([est[a][:3, 3] for a, _ in pairs], axis=1)
    xyz_gt = np.stack([gt[b][:3, 3] for _, b in pairs], axis=1)
    _, _, err = align_horn(xyz_est, xyz_gt)
    return {
        "rmse": float(np.sqrt(np.mean(err ** 2))),
        "mean": float(err.mean()),
        "median": float(np.median(err)),
        "std": float(err.std()),
        "min": float(err.min()),
        "max": float(err.max()),
        "pairs": len(pairs),
    }


def evaluate_rpe(est: Dict, gt: Dict, delta: int = 1,
                 max_difference: float = 0.02) -> dict:
    """RPE over fixed index delta (evaluate_rpe.py, fixed_delta frames)."""
    pairs = associate(est, gt, max_difference)
    if len(pairs) < delta + 1:
        raise ValueError("not enough matched poses for RPE")
    trans_errs, rot_errs = [], []
    for i in range(len(pairs) - delta):
        a0, b0 = pairs[i]
        a1, b1 = pairs[i + delta]
        dE = np.linalg.inv(est[a0]) @ est[a1]
        dG = np.linalg.inv(gt[b0]) @ gt[b1]
        E = np.linalg.inv(dG) @ dE
        trans_errs.append(np.linalg.norm(E[:3, 3]))
        ang = np.clip((np.trace(E[:3, :3]) - 1) / 2, -1, 1)
        rot_errs.append(np.arccos(ang))
    trans_errs = np.array(trans_errs)
    rot_errs = np.array(rot_errs)
    return {
        "trans_rmse": float(np.sqrt(np.mean(trans_errs ** 2))),
        "trans_mean": float(trans_errs.mean()),
        "rot_rmse_deg": float(np.degrees(np.sqrt(np.mean(rot_errs ** 2)))),
        "rot_mean_deg": float(np.degrees(rot_errs.mean())),
        "pairs": len(trans_errs),
    }
