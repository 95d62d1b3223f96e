"""The object lifecycle of the port's sharded pipeline on the CPU: a
(2, 2) mesh of 4 gloo ranks against the one-process port, frame by frame,
on the rigid and deletion scenes of ``tests/test_torch_pipeline_objects.
py`` (at their size, fewer frames) and on a scene of two objects, with
``max_objects`` 2: one slot per ``obj`` rank, so a spawn, a match (the
owner's percentiles broadcast), a mask integration and a deletion of a
slot cross its owner and the others, and the two objects of the last
scene live on different ranks. The same ids, slots, spawns, matches and
deletions, and every compared array bit-equal (see
``tests/test_torch_distributed_pipeline.py``)."""

import numpy as np
import pytest
import torch

import torch_dist_workers as W
from synthetic import SyntheticScene
from test_accuracy_gate import EXACT
from test_accuracy_gate_objects import _make_sequence
from test_torch_distributed_pipeline import reference, sharded
from test_torch_pipeline_objects import SMALL, deletion_sequence

torch.set_num_threads(2)


def two_object_sequence(n=4):
    """The rigid scene's camera path with two spheres (r 0.12 m) 0.5 m
    apart, both moving along +x; the depth is the nearest surface and
    each mask where its sphere is that surface; masks every third
    frame."""
    scene = SyntheticScene(H=120, W=160, f=130.0, obj_sphere_r=0.12)
    frames, masks = [], {}
    for i in range(n):
        th = 0.008 * i
        c, s = np.cos(th), np.sin(th)
        cam = np.array([[c, 0, s, 0.014 * i], [0, 1, 0, -0.008 * i],
                        [-s, 0, c, 0.004 * i], [0, 0, 0, 1]], np.float32)
        d0, _ = scene.render(cam, np.array([9.0, 9.0, 9.0]))
        d1, m1 = scene.render(cam, np.array([-0.2 + 0.004 * i, 0.1, 1.05]))
        d2, m2 = scene.render(cam, np.array([0.3 + 0.004 * i, 0.1, 1.1]))
        m1, m2 = m1 & (d1 <= d2), m2 & (d2 < d1)
        frames.append(np.where(m1, d1, np.where(m2, d2, d0)).astype(
            np.float32))
        if i % 3 == 0:
            masks[i] = [m1, m2]
    return frames, masks


def rigid_sequence(n=4):
    _, frames, masks, _ = _make_sequence(grow=False)
    return frames[:n], {f: [m] for f, m in masks.items() if f < n}


def deletion_scene():
    frames, masks = deletion_sequence()
    return frames, {f: [m] for f, m in masks.items()}


GATE = dict(frameSize=(160, 120), fx=130.0, fy=130.0, cx=79.5, cy=59.5,
            globalVolumeDims=(128, 128, 128), globalVoxelSize=2.56 / 128,
            volumePose=(0.0, 0.0, 1.28), objVolumeDims=(32, 32, 32),
            maxTrackingIter=50, raycast_max_steps=256, max_objects=2,
            maskRCNNFrames=3, visibilityThresh=60, mask_min_pixels=60,
            volPad=1.0, matchIOUThresh=0.05, **EXACT)
SCENES = {"rigid": (rigid_sequence, GATE),
          "deletion": (deletion_scene, dict(SMALL, **EXACT, max_objects=2)),
          "two_objects": (two_object_sequence, GATE)}


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_lifecycle_matches_one_process(scene):
    """The same ids, slots, spawns, matches, resizes and deletions as the
    one-process port, and every frame's arrays bit-equal (poses, volumes,
    association images, composite)."""
    make, P = SCENES[scene]
    frames, masks = make()
    res = sharded(P, frames, masks)
    ref = reference(P, frames, masks)
    W.assert_same_records(res[0]["recs"], ref)
    ids = [r["ids"] for r in ref]
    if scene == "deletion":
        assert ids[0] == [1] and ids[-1] == []
    elif scene == "rigid":
        assert all(i == [1] for i in ids)
        assert ref[-1]["meta"][1][0] == 2       # spawned, then matched
    else:
        # one object in each obj rank's slot, both kept
        assert ids[-1] == [1, 2]
        assert [r["active"].tolist() for r in ref][-1] == [True, True]
