"""Absolute Trajectory Error (ATE) evaluation.

In-repo reimplementation of the TUM RGB-D benchmark evaluation math
(Sturm et al., IROS 2012) that the reference drives through external
scripts (``eval_tum.sh:29-39``, ``eval_co-fusion.sh:49-76``):
Horn-alignment of estimated to ground-truth trajectories followed by
RMSE of translational residuals (ATE). The reference repo does not ship
this math; it is the standard public protocol. (A copy of the JAX
package's ``eval/ate.py``, ATE only: RPE and trajectory files come with
the CLI.)
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


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

