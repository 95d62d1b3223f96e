"""Raw-detector postprocessing: the reference's Mask R-CNN result
pipeline as pure NumPy over raw head outputs.

A copy of ``emfusion_tpu/detector_post.py`` (the port imports nothing of
the JAX package), for :class:`~emfusion_tpu_torch.segmentation.
TorchScriptMaskProvider`.

The reference embeds a TF1/Keras Mask R-CNN and re-derives per-detection
FULL 81-class score distributions from the classifier head
(reference ``apps/maskrcnn.in.py:118-255``):

  1. class-specific box refinement of proposals with BBOX_STD_DEV scaling
     and window clipping (``refine_proposals``, ``maskrcnn.in.py:136-146``
     + matterport ``utils.apply_box_deltas``),
  2. keep = not-background AND score >= DETECTION_MIN_CONFIDENCE, then
     per-class NMS at DETECTION_NMS_THRESHOLD (``filter_rois``,
     ``maskrcnn.in.py:149-174``),
  3. full score rows ``probs[keep]`` aligned to the network's final
     detection ordering via box matching (``maskrcnn.in.py:231-243`` —
     the detections come out of ``unmold_detections`` in a different
     order than ``keep``),
  4. mask size filter: < 50x50 nonzero pixels dropped (``filter_fusion``,
     ``maskrcnn.in.py:177-186``),
  5. FILTER_CLASSES / STATIC_OBJECTS argmax-class filtering
     (``generate_result``, ``maskrcnn.in.py:189-206``).

This module reproduces those semantics without TF so that any detector
that can expose (proposals, per-class probs, per-class box deltas,
masks) — or just (boxes, masks, per-class scores) — plugs into the
framework and yields reference-style full-score detections.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from emfusion_tpu_torch.segmentation import (
    Detection, NUM_CLASSES, filter_detections,
)

# matterport Mask_RCNN coco config defaults (mrcnn/config.py), used by the
# reference build unchanged.
BBOX_STD_DEV = np.array([0.1, 0.1, 0.2, 0.2], np.float32)
DETECTION_MIN_CONFIDENCE = 0.7
DETECTION_NMS_THRESHOLD = 0.3
MIN_MASK_PIXELS = 50 * 50


def apply_box_deltas(boxes: np.ndarray, deltas: np.ndarray) -> np.ndarray:
    """matterport ``utils.apply_box_deltas``: boxes (N,4) y1,x1,y2,x2;
    deltas (N,4) dy,dx,log(dh),log(dw)."""
    boxes = boxes.astype(np.float64)
    height = boxes[:, 2] - boxes[:, 0]
    width = boxes[:, 3] - boxes[:, 1]
    center_y = boxes[:, 0] + 0.5 * height
    center_x = boxes[:, 1] + 0.5 * width
    center_y = center_y + deltas[:, 0] * height
    center_x = center_x + deltas[:, 1] * width
    height = height * np.exp(deltas[:, 2])
    width = width * np.exp(deltas[:, 3])
    y1 = center_y - 0.5 * height
    x1 = center_x - 0.5 * width
    return np.stack([y1, x1, y1 + height, x1 + width], axis=1)


def clip_boxes(boxes: np.ndarray, window: np.ndarray) -> np.ndarray:
    """``maskrcnn.in.py:119-133``: clip (N,4) boxes to window
    (y1,x1,y2,x2)."""
    wy1, wx1, wy2, wx2 = window
    out = boxes.copy()
    out[:, 0] = np.clip(boxes[:, 0], wy1, wy2)
    out[:, 1] = np.clip(boxes[:, 1], wx1, wx2)
    out[:, 2] = np.clip(boxes[:, 2], wy1, wy2)
    out[:, 3] = np.clip(boxes[:, 3], wx1, wx2)
    return out


def norm_boxes(boxes: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """matterport ``utils.norm_boxes``: pixel -> normalized coords."""
    h, w = shape[:2]
    scale = np.array([h - 1, w - 1, h - 1, w - 1], np.float64)
    shift = np.array([0, 0, 1, 1], np.float64)
    return (boxes.astype(np.float64) - shift) / scale


def denorm_boxes(boxes: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """matterport ``utils.denorm_boxes``: normalized -> pixel (int32)."""
    h, w = shape[:2]
    scale = np.array([h - 1, w - 1, h - 1, w - 1], np.float64)
    shift = np.array([0, 0, 1, 1], np.float64)
    return np.around(boxes * scale + shift).astype(np.int32)


def non_max_suppression(boxes: np.ndarray, scores: np.ndarray,
                        threshold: float) -> np.ndarray:
    """matterport ``utils.non_max_suppression``: greedy IoU NMS.

    Returns kept indices into ``boxes`` in descending-score pick order.
    """
    if boxes.size == 0:
        return np.zeros((0,), np.int32)
    y1, x1, y2, x2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    area = (y2 - y1) * (x2 - x1)
    ixs = scores.argsort()[::-1]
    pick = []
    while len(ixs) > 0:
        i = ixs[0]
        pick.append(i)
        yy1 = np.maximum(y1[i], y1[ixs[1:]])
        xx1 = np.maximum(x1[i], x1[ixs[1:]])
        yy2 = np.minimum(y2[i], y2[ixs[1:]])
        xx2 = np.minimum(x2[i], x2[ixs[1:]])
        inter = np.maximum(yy2 - yy1, 0) * np.maximum(xx2 - xx1, 0)
        union = area[i] + area[ixs[1:]] - inter
        iou = np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)
        remove = np.where(iou > threshold)[0] + 1
        ixs = np.delete(ixs, np.concatenate([[0], remove]))
    return np.asarray(pick, np.int32)


def refine_proposals(proposals: np.ndarray, class_ids: np.ndarray,
                     deltas: np.ndarray, window: np.ndarray) -> np.ndarray:
    """``maskrcnn.in.py:136-146``: class-specific refinement + clip.

    proposals: (N, 4) normalized; deltas: (N, C, 4); window normalized.
    """
    deltas_specific = deltas[np.arange(class_ids.shape[0]), class_ids]
    refined = apply_box_deltas(proposals,
                               deltas_specific * BBOX_STD_DEV[None, :])
    return clip_boxes(refined, window)


def filter_rois(refined_rois: np.ndarray, class_ids: np.ndarray,
                class_scores: np.ndarray,
                min_confidence: float = DETECTION_MIN_CONFIDENCE,
                nms_threshold: float = DETECTION_NMS_THRESHOLD
                ) -> np.ndarray:
    """``maskrcnn.in.py:149-174``: bg/conf filter + per-class NMS.

    Returns sorted kept indices (np.intersect1d output is sorted —
    matching the reference's ordering exactly).
    """
    keep = np.where(class_ids > 0)[0]
    if min_confidence:
        conf_keep = np.where(class_scores >= min_confidence)[0]
        keep = np.intersect1d(keep, conf_keep)

    pre_nms_class_ids = class_ids[keep]
    pre_nms_scores = class_scores[keep]
    pre_nms_boxes = refined_rois[keep]

    nms_keep = np.array([], np.int64)
    for class_id in np.unique(pre_nms_class_ids):
        ixs = np.where(pre_nms_class_ids == class_id)[0]
        class_keep = non_max_suppression(pre_nms_boxes[ixs],
                                         pre_nms_scores[ixs],
                                         nms_threshold)
        nms_keep = np.union1d(nms_keep, keep[ixs[class_keep]])
    return np.intersect1d(keep, nms_keep).astype(np.int32)


def match_scores_to_detections(detection_boxes: np.ndarray,
                               roi_boxes: np.ndarray,
                               kept_scores: np.ndarray) -> np.ndarray:
    """``maskrcnn.in.py:231-243``: align full score rows to the network's
    final detection ordering by exact box matching.

    The reference's detection head re-sorts kept ROIs internally, so the
    i-th output detection is not the i-th kept ROI; the reference finds,
    for each output detection box, the kept ROI with the identical
    (denormalized, integer) box and takes its score row.

    detection_boxes/roi_boxes: (N, 4) int32 pixel boxes; kept_scores:
    (N, C) rows ordered like roi_boxes. Returns (N, C) rows ordered like
    detection_boxes. Raises ValueError when a detection box has no
    matching ROI (the reference would crash on an IndexError).
    """
    n = detection_boxes.shape[0]
    perm = np.empty(n, np.int64)
    for i in range(n):
        hit = np.where(np.all(roi_boxes == detection_boxes[i], axis=1))[0]
        if hit.size == 0:
            raise ValueError(
                f"detection box {i} has no matching refined ROI")
        perm[i] = hit[0]
    return kept_scores[perm]


def filter_mask_size(masks: np.ndarray,
                     min_pixels: int = MIN_MASK_PIXELS) -> np.ndarray:
    """``filter_fusion`` (``maskrcnn.in.py:177-186``): keep masks with at
    least ``min_pixels`` nonzero pixels. masks: (N, H, W)."""
    if masks.shape[0] == 0:
        return np.zeros((0,), np.int32)
    counts = np.count_nonzero(masks.reshape(masks.shape[0], -1), axis=1)
    return np.where(counts >= min_pixels)[0].astype(np.int32)


def _bilinear_resize(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Plain bilinear resize (align_corners=False convention, matching
    scikit-image's ``resize`` used by matterport ``unmold_mask``)."""
    in_h, in_w = img.shape
    if out_h <= 0 or out_w <= 0:
        return np.zeros((max(out_h, 0), max(out_w, 0)), img.dtype)
    ys = (np.arange(out_h) + 0.5) * in_h / out_h - 0.5
    xs = (np.arange(out_w) + 0.5) * in_w / out_w - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, in_h - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, in_w - 1)
    y1 = np.clip(y0 + 1, 0, in_h - 1)
    x1 = np.clip(x0 + 1, 0, in_w - 1)
    fy = np.clip(ys - y0, 0.0, 1.0)[:, None]
    fx = np.clip(xs - x0, 0.0, 1.0)[None, :]
    a = img[np.ix_(y0, x0)] * (1 - fy) * (1 - fx)
    b = img[np.ix_(y0, x1)] * (1 - fy) * fx
    c = img[np.ix_(y1, x0)] * fy * (1 - fx)
    d = img[np.ix_(y1, x1)] * fy * fx
    return a + b + c + d


def unmold_mini_masks(mini_masks: np.ndarray, boxes_px: np.ndarray,
                      image_shape: Tuple[int, int]) -> np.ndarray:
    """Paste mask-head crops into full-image masks (matterport
    ``utils.unmold_mask`` / reference ``unmold_detections`` semantics,
    ``maskrcnn.in.py`` via ``model.detect``): each (h, w) mini mask is
    bilinearly resized into its pixel box and thresholded at 0.5.

    Args: mini_masks (K, h, w) float; boxes_px (K, 4) y1,x1,y2,x2 pixel
    boxes. Returns (K, H, W) float in {0, 1}.
    """
    H, W = image_shape
    K = mini_masks.shape[0]
    out = np.zeros((K, H, W), np.float32)
    for i in range(K):
        y1, x1, y2, x2 = [int(round(float(v))) for v in boxes_px[i]]
        y1, x1 = max(y1, 0), max(x1, 0)
        y2, x2 = min(y2, H), min(x2, W)
        if y2 <= y1 or x2 <= x1:
            continue
        m = _bilinear_resize(mini_masks[i].astype(np.float64),
                             y2 - y1, x2 - x1)
        out[i, y1:y2, x1:x2] = (m >= 0.5).astype(np.float32)
    return out


def postprocess_raw(proposals: np.ndarray, probs: np.ndarray,
                    deltas: np.ndarray, masks: np.ndarray,
                    image_shape: Tuple[int, int],
                    window: Optional[np.ndarray] = None,
                    min_confidence: float = DETECTION_MIN_CONFIDENCE,
                    nms_threshold: float = DETECTION_NMS_THRESHOLD,
                    min_mask_pixels: int = MIN_MASK_PIXELS,
                    filter_classes: Sequence[str] = (),
                    static_objects: Sequence[str] = (),
                    ) -> List[Detection]:
    """Full reference pipeline over raw detector outputs.

    Args:
      proposals: (N, 4) normalized proposal boxes (y1, x1, y2, x2).
      probs: (N, C) per-proposal class probabilities (C = 81 COCO).
      deltas: (N, C, 4) per-class box deltas (matterport convention).
      masks: per-proposal masks in one of three layouts:
        * (N, H, W) FULL-IMAGE masks (torchvision-style, already
          pasted);
        * (N, h, w) class-agnostic mask-head crops (h, w != image
          size, typically 28x28) — unmolded into the refined boxes
          here (reference ``unmold_detections``);
        * (N, C, h, w) per-class mask-head crops (matterport head
          layout) — the argmax class's channel is unmolded.
      image_shape: (H, W) of the original image.
      window: optional normalized (y1, x1, y2, x2) valid-image window
        (identity window when None).

    Returns filtered :class:`Detection` list with full score rows.
    """
    H, W = image_shape
    if window is None:
        window = np.array([0.0, 0.0, 1.0, 1.0], np.float64)

    class_ids = np.argmax(probs, axis=1)
    class_scores = probs[np.arange(class_ids.shape[0]), class_ids]
    refined = refine_proposals(proposals, class_ids, deltas, window)
    keep = filter_rois(refined, class_ids, class_scores,
                       min_confidence, nms_threshold)

    kept_scores = probs[keep]
    roi_boxes = denorm_boxes(refined[keep], (H, W))
    # The detection head sorts kept detections by descending score
    # (mrcnn DetectionLayer); reproduce that ordering, then exercise the
    # reference's box-matching alignment against it.
    order = np.argsort(-class_scores[keep], kind="stable")
    detection_boxes = roi_boxes[order]
    scores_full = match_scores_to_detections(detection_boxes, roi_boxes,
                                             kept_scores)

    masks = np.asarray(masks)
    boxes_px = detection_boxes
    full_image = masks.ndim == 3 and masks.shape[1:] == (H, W)
    if full_image:
        kept_masks = masks[keep][order]
    else:
        if masks.ndim == 4:    # per-class head: take the argmax class
            kept_ids = class_ids[keep][order]
            mini = masks[keep][order][np.arange(len(order)), kept_ids]
        else:
            mini = masks[keep][order]
        kept_masks = unmold_mini_masks(mini, boxes_px, (H, W))

    size_keep = filter_mask_size(kept_masks > 0.5, min_mask_pixels)
    dets = [Detection(mask=np.asarray(kept_masks[i]) > 0.5,
                      scores=np.asarray(scores_full[i], np.float64),
                      box=np.asarray(boxes_px[i]))
            for i in size_keep]
    return filter_detections(dets, filter_classes, static_objects,
                             min_pixels=0)


# torchvision COCO category ids (91 slots with gaps) -> contiguous 81-id
# list used by the reference (segmentation.CLASS_NAMES). Index = 91-style
# id, value = 81-style id or -1 (the 10 unused COCO slots).
_COCO91_TO_81 = np.full(92, -1, np.int64)
_USED_91 = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17, 18,
            19, 20, 21, 22, 23, 24, 25, 27, 28, 31, 32, 33, 34, 35, 36, 37,
            38, 39, 40, 41, 42, 43, 44, 46, 47, 48, 49, 50, 51, 52, 53,
            54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64, 65, 67, 70, 72,
            73, 74, 75, 76, 77, 78, 79, 80, 81, 82, 84, 85, 86, 87, 88,
            89, 90]
for _i81, _i91 in enumerate(_USED_91):
    _COCO91_TO_81[_i91] = _i81


def scores_from_labels(labels: np.ndarray, scores: np.ndarray,
                       num_classes: int = NUM_CLASSES,
                       coco91: bool = True) -> np.ndarray:
    """Build full score rows from (label, scalar-score) detector outputs
    (e.g. torchvision Mask R-CNN). The leftover probability mass goes to
    background so rows still sum to 1 like the reference's
    re-derived distributions."""
    n = labels.shape[0]
    rows = np.zeros((n, num_classes), np.float64)
    for i in range(n):
        lab = int(labels[i])
        if coco91:
            lab = int(_COCO91_TO_81[lab]) if 0 <= lab < 92 else -1
        if lab < 0 or lab >= num_classes:
            lab = 0
        rows[i, lab] = float(scores[i])
        rows[i, 0] += 1.0 - float(scores[i]) if lab != 0 else 0.0
    return rows


def scores_from_logits(logits: np.ndarray,
                       num_classes: int = NUM_CLASSES,
                       coco91: Optional[bool] = None) -> np.ndarray:
    """Full 81-class score rows from per-class logits or scores of width
    C. Rows whose values all lie in [0, 1] are taken as score rows
    verbatim (they need not sum to 1 — detector score rows often don't);
    anything else is treated as logits and softmaxed. C == 91
    torchvision layouts are remapped onto the 81-class list."""
    logits = np.asarray(logits, np.float64)
    n, C = logits.shape
    is_prob = logits.size == 0 or (np.all(np.isfinite(logits))
                                   and logits.min() >= 0.0
                                   and logits.max() <= 1.0)
    probs = logits if is_prob else _softmax(logits)
    if coco91 is None:
        coco91 = C in (91, 92)
    if not coco91 and C == num_classes:
        return probs
    out = np.zeros((n, num_classes), np.float64)
    for c in range(min(C, 92)):
        t = int(_COCO91_TO_81[c]) if coco91 else (c if c < num_classes
                                                  else -1)
        if t >= 0:
            out[:, t] += probs[:, c]
        else:
            out[:, 0] += probs[:, c]   # unused slots fold into background
    return out


def _softmax(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - x.max(axis=1, keepdims=True))
    return e / e.sum(axis=1, keepdims=True)
