"""Instance-segmentation providers (Mask R-CNN bridge equivalent).

A copy of ``emfusion_tpu/segmentation.py`` (the port imports nothing of
the JAX package). Replaces the reference's embedded-CPython Mask R-CNN bridge
(``src/core/MaskRCNN.cpp``, ``apps/maskrcnn.in.py``) with a provider
interface. Ships:

  * :class:`ReplayMaskProvider` — replays preprocessed detections from
    pickle files, compatible with the reference's ``Mask%04d.plk``
    replay mechanism (``src/core/MaskRCNN.cpp:250-282``,
    ``apps/maskrcnn.in.py:258-268``): each file holds
    ``(boxes, masks, scores)`` lists.
  * :class:`CallableMaskProvider` — wraps any function (used by tests and
    synthetic sequences; also the hook for a live detector).

Class filtering semantics follow ``apps/maskrcnn.in.py:189-206``: a
detection is kept iff (FILTER_CLASSES empty or argmax-class in it) and
argmax-class not in STATIC_OBJECTS.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Callable, List, Optional, Sequence

import numpy as np

# 81 COCO classes incl. background, matching the reference's list
# (``apps/maskrcnn.in.py:38-52``, ``src/core/MaskRCNN.cpp:27-43``).
CLASS_NAMES = [
    "BG", "person", "bicycle", "car", "motorcycle", "airplane", "bus",
    "train", "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella",
    "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard",
    "sports ball", "kite", "baseball bat", "baseball glove", "skateboard",
    "surfboard", "tennis racket", "bottle", "wine glass", "cup", "fork",
    "knife", "spoon", "bowl", "banana", "apple", "sandwich", "orange",
    "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair",
    "couch", "potted plant", "bed", "dining table", "toilet", "tv",
    "laptop", "mouse", "remote", "keyboard", "cell phone", "microwave",
    "oven", "toaster", "sink", "refrigerator", "book", "clock", "vase",
    "scissors", "teddy bear", "hair drier", "toothbrush",
]

NUM_CLASSES = len(CLASS_NAMES)


def class_name(class_id: int) -> str:
    return CLASS_NAMES[class_id]


@dataclasses.dataclass
class Detection:
    """One instance detection."""
    mask: np.ndarray          # (H, W) bool
    scores: np.ndarray        # (NUM_CLASSES,) full class-score distribution
    box: Optional[np.ndarray] = None  # (4,) y1,x1,y2,x2 (optional)

    @property
    def class_id(self) -> int:
        return int(np.argmax(self.scores))


def filter_detections(dets: Sequence[Detection],
                      filter_classes: Sequence[str],
                      static_objects: Sequence[str],
                      min_pixels: int = 50 * 50) -> List[Detection]:
    """Apply FILTER_CLASSES / STATIC_OBJECTS / size filtering
    (``apps/maskrcnn.in.py:177-206``)."""
    filter_ids = {CLASS_NAMES.index(c) for c in filter_classes
                  if c in CLASS_NAMES}
    static_ids = {CLASS_NAMES.index(c) for c in static_objects
                  if c in CLASS_NAMES}
    out = []
    for d in dets:
        if np.count_nonzero(d.mask) < min_pixels:
            continue
        cid = d.class_id
        if filter_ids and cid not in filter_ids:
            continue
        if cid in static_ids:
            continue
        out.append(d)
    return out


class MaskProvider:
    """Interface: return detections for a frame, or None if unavailable."""

    def detect(self, rgb: Optional[np.ndarray],
               frame_idx: int) -> Optional[List[Detection]]:
        raise NotImplementedError


class ReplayMaskProvider(MaskProvider):
    """Replays ``Mask%04d.plk`` pickles (reference-compatible format:
    a tuple of (boxes, masks, scores) lists)."""

    def __init__(self, mask_dir: str):
        self.mask_dir = mask_dir

    def detect(self, rgb, frame_idx):
        path = os.path.join(self.mask_dir, f"Mask{frame_idx:04d}.plk")
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            boxes, masks, scores = pickle.load(f)
        dets = []
        for i in range(len(masks)):
            dets.append(Detection(
                mask=np.asarray(masks[i], dtype=bool),
                scores=np.asarray(scores[i], dtype=np.float64),
                box=np.asarray(boxes[i]) if i < len(boxes) else None))
        return dets


def save_detections(path: str, dets: Sequence[Detection]) -> None:
    """Write a reference-compatible pickle (``maskrcnn.in.py:258-263``)."""
    boxes = [d.box.tolist() if d.box is not None else [0, 0, 0, 0]
             for d in dets]
    masks = [np.asarray(d.mask) for d in dets]
    scores = [d.scores.tolist() for d in dets]
    with open(path, "wb") as f:
        pickle.dump((boxes, masks, scores), f, pickle.HIGHEST_PROTOCOL)


class CallableMaskProvider(MaskProvider):
    """Wraps ``fn(rgb, frame_idx) -> list[Detection] | None``."""

    def __init__(self, fn: Callable):
        self.fn = fn

    def detect(self, rgb, frame_idx):
        return self.fn(rgb, frame_idx)


class TorchScriptMaskProvider(MaskProvider):
    """Live detector via a user-supplied TorchScript module.

    The reference embeds CPython + TF1 Mask R-CNN in-process
    (``src/core/MaskRCNN.cpp:57-117``); here the detector is a
    TorchScript instance-segmentation model loaded from a local path
    (the weights must be provided by the user) onto ``device``: ``None``
    means the card, and raises without one.

    Accepted module output shapes (auto-detected per call):

      * ``(boxes (N,4), masks (N,H,W), scores (N,C))`` — per-class score
        rows. C == 81 passes through; C == 91/92 (torchvision COCO
        category layout) or logits are re-derived into full 81-class
        rows (``detector_post.scores_from_logits``; reference semantics
        ``apps/maskrcnn.in.py:209-255``).
      * ``(boxes (N,4), masks (N,H,W), labels (N,), scores (N,))`` —
        torchvision ``maskrcnn_resnet50_fpn``-style outputs; full rows
        built via ``detector_post.scores_from_labels`` (91 -> 81 id
        remap, leftover mass on background).
      * a dict with keys ``boxes``, ``masks``, ``labels``, ``scores``
        (torchvision's native output dict).
      * RAW HEAD: ``(proposals (N,4) normalized, probs (N,C),
        deltas (N,C,4), mask crops (N,h,w) or (N,C,h,w))`` — the full
        reference postprocessing pipeline (class-specific box
        refinement, per-class NMS, box-matched full score rows, mask
        unmolding into refined boxes; ``detector_post.postprocess_raw``,
        reference ``apps/maskrcnn.in.py:118-255``). Detected by
        ``deltas.ndim == 3``.

    Detections then pass through the reference's confidence and
    50x50-pixel mask filters.
    """

    def __init__(self, model_path: str, score_thresh: float = 0.7,
                 mask_thresh: float = 0.5, device=None):
        import torch
        from emfusion_tpu_torch.device import resolve_device
        self._torch = torch
        self.device = resolve_device(device)
        self.model = torch.jit.load(model_path, map_location=self.device)
        self.model.eval()
        self.score_thresh = score_thresh
        self.mask_thresh = mask_thresh

    def detect(self, rgb, frame_idx):
        if rgb is None:
            return []
        torch = self._torch
        with torch.no_grad():
            img = torch.from_numpy(np.ascontiguousarray(rgb)).to(self.device)
            out = self.model(img)
        return self._parse(out, np.asarray(rgb).shape[:2])

    def _parse(self, out, image_shape=None):
        from emfusion_tpu_torch.detector_post import (
            postprocess_raw, scores_from_labels, scores_from_logits)

        def npy(t):
            return t.detach().cpu().numpy() if hasattr(t, "detach") \
                else np.asarray(t)

        if isinstance(out, dict):
            boxes = npy(out["boxes"])
            masks = npy(out["masks"])
            rows = scores_from_labels(npy(out["labels"]),
                                      npy(out["scores"]))
        elif len(out) == 4 and npy(out[2]).ndim == 3:
            # RAW HEAD: (proposals, probs, deltas, mask crops) — full
            # reference postprocessing (maskrcnn.in.py:118-255)
            return postprocess_raw(
                npy(out[0]), npy(out[1]), npy(out[2]), npy(out[3]),
                image_shape, min_confidence=self.score_thresh)
        elif len(out) == 4:
            boxes, masks = npy(out[0]), npy(out[1])
            rows = scores_from_labels(npy(out[2]), npy(out[3]))
        else:
            boxes, masks = npy(out[0]), npy(out[1])
            rows = scores_from_logits(npy(out[2]))
        if masks.ndim == 4:          # torchvision (N, 1, H, W)
            masks = masks[:, 0]
        dets = []
        for i in range(len(masks)):
            s = rows[i]
            if float(np.max(s[1:])) < self.score_thresh:
                continue
            mask = np.asarray(masks[i]) > self.mask_thresh
            if np.count_nonzero(mask) < 50 * 50:
                continue            # filter_fusion, maskrcnn.in.py:177-186
            dets.append(Detection(
                mask=mask, scores=np.asarray(s, np.float64),
                box=np.asarray(boxes[i]) if i < len(boxes) else None))
        return dets


def make_score_vector(class_id: int, score: float = 1.0) -> np.ndarray:
    s = np.zeros(NUM_CLASSES, dtype=np.float64)
    s[class_id] = score
    return s
