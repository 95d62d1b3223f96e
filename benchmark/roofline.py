"""The yardstick's arithmetic: the card's published peaks and the least
time of a kernel's work.

A frozen copy of ``chip_smoke.py``'s ``bound`` and ``fusion_traffic``
(the port's smoke run; the copy stays here so that a change to the
program cannot move it), with the voxel classes from the reference's own
copy of the fusion's projection (:func:`benchmark.reference.ops.
voxel_classes`).
"""

from __future__ import annotations

import torch

from benchmark.reference import ops

# one NVIDIA H100 SXM, NVIDIA's data sheet, at its 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def least_seconds(bytes_moved: float, ops_count: float) -> float:
    """The least time the card needs for the work: the larger of its bytes
    over the memory rate and its float32 operations over the float32
    rate."""
    return max(bytes_moved / HBM_BYTES_PER_S, ops_count / F32_OPS_PER_S)


def fusion_work(items, depth: torch.Tensor, intr):
    """(bytes, float32 operations) that K1's function needs for one launch.

    ``items``: per volume ``(before, after, rot, trans, voxel_size,
    truncdist)``, ``before``/``after`` the (tsdf, weights) pair as the
    launch found and left it, ``rot``/``trans`` the volume-to-camera
    transform. Bytes: the depth image once; per item its association image;
    8 per ``BAND`` voxel (tsdf and weight read), 4 per ``BEHIND``,
    ``HOLE`` or ``NEG`` voxel (the weight) and 4 more where that weight is
    0 (the tsdf), 4 per stored value that changed; nothing for a ``SKIP``
    voxel (half of each for a 2-byte volume). Operations: per voxel 28
    (its centre, the rigid transform, the pixel's two divisions, the
    in-image test), per ``NEG`` or ``BAND`` voxel 18 more (the ray factor,
    the distance, the sdf), per ``BAND`` voxel 12 more (the truncated
    measurement and the weighted average)."""
    HW = depth.numel()
    nbytes, nops = 4 * HW, 0
    for (t0, w0), (t1, w1), rot, trans, vs, td in items:
        cls = ops.voxel_classes(t0.shape, depth, rot, trans, intr, vs, td)
        n = {name: int((cls == code).sum()) for name, code in (
            ("behind", ops.BEHIND), ("hole", ops.HOLE), ("neg", ops.NEG),
            ("band", ops.BAND))}
        rule = (cls == ops.BEHIND) | (cls == ops.HOLE) | (cls == ops.NEG)
        rule_w0 = int((rule & (w0 == 0)).sum())
        del cls, rule
        es = t0.element_size()
        bits = torch.int16 if es == 2 else torch.int32
        changed = int((t1.view(bits) != t0.view(bits)).sum()) \
            + int((w1.view(bits) != w0.view(bits)).sum())
        nbytes += (4 * HW + 2 * es * n["band"]
                   + es * (n["behind"] + n["hole"] + n["neg"])
                   + es * rule_w0 + es * changed)
        nops += 28 * t0.numel() + 18 * (n["neg"] + n["band"]) \
            + 12 * n["band"]
    return nbytes, nops
