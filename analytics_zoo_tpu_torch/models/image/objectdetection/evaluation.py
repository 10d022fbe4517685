"""Detection evaluation + visualization: the port's copy of
``analytics_zoo_tpu/models/image/objectdetection/evaluation.py`` (host
numpy; PIL is imported only where an image is drawn).

Ref: the reference validates detectors with MeanAveragePrecision
(BigDL ``MeanAveragePrecisionObjectDetection`` used by the zoo SSD
examples) and renders results with
``zoo/.../models/image/objectdetection/Visualizer.scala``. Detections are
``[n, 6]`` rows of ``(label, score, xmin, ymin, xmax, ymax)`` — the layout
``bbox_util.detect_post_process`` emits.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from analytics_zoo_tpu_torch.models.image.objectdetection.bbox_util import (
    iou_matrix,
)


def average_precision(recalls: np.ndarray, precisions: np.ndarray,
                      use_07_metric: bool = False) -> float:
    """AP from a recall/precision curve: PASCAL VOC 11-point (2007) or
    all-points area-under-curve (2010+)."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            mask = recalls >= t
            p = float(precisions[mask].max()) if mask.any() else 0.0
            ap += p / 11.0
        return ap
    r = np.concatenate([[0.0], recalls, [1.0]])
    p = np.concatenate([[0.0], precisions, [0.0]])
    for i in range(len(p) - 2, -1, -1):
        p[i] = max(p[i], p[i + 1])
    changed = np.where(r[1:] != r[:-1])[0]
    return float(np.sum((r[changed + 1] - r[changed]) * p[changed + 1]))


def mean_average_precision(detections: Sequence[np.ndarray],
                           gt_boxes: Sequence[np.ndarray],
                           gt_labels: Sequence[np.ndarray],
                           n_classes: int,
                           iou_threshold: float = 0.5,
                           use_07_metric: bool = False) -> Dict:
    """VOC-style mAP over a dataset.

    ``detections[i]``: [n_i, 6] (label, score, box) for image i;
    ``gt_boxes[i]``: [g_i, 4]; ``gt_labels[i]``: [g_i] 1-based labels.
    Returns {"mAP": float, "ap_per_class": {label: ap}}.
    """
    aps: Dict[int, float] = {}
    for c in range(1, n_classes + 1):
        scores: List[float] = []
        matches: List[int] = []   # 1 = true positive, 0 = false positive
        n_gt = 0
        for det, gb, gl in zip(detections, gt_boxes, gt_labels):
            gb = np.asarray(gb, np.float32).reshape(-1, 4)
            gl = np.asarray(gl).reshape(-1)
            cls_gt = gb[gl == c]
            n_gt += len(cls_gt)
            det = np.asarray(det, np.float32).reshape(-1, 6)
            cls_det = det[det[:, 0] == c]
            cls_det = cls_det[np.argsort(-cls_det[:, 1])]
            taken = np.zeros(len(cls_gt), bool)
            for row in cls_det:
                scores.append(float(row[1]))
                if len(cls_gt) == 0:
                    matches.append(0)
                    continue
                ious = iou_matrix(row[None, 2:6], cls_gt)[0]
                j = int(ious.argmax())
                if ious[j] >= iou_threshold and not taken[j]:
                    taken[j] = True
                    matches.append(1)
                else:
                    matches.append(0)
        if n_gt == 0:
            continue
        if not scores:
            aps[c] = 0.0
            continue
        order = np.argsort(-np.asarray(scores))
        m = np.asarray(matches)[order]
        tp = np.cumsum(m)
        fp = np.cumsum(1 - m)
        recalls = tp / n_gt
        precisions = tp / np.maximum(tp + fp, 1)
        aps[c] = average_precision(recalls, precisions, use_07_metric)
    mAP = float(np.mean(list(aps.values()))) if aps else 0.0
    return {"mAP": mAP, "ap_per_class": aps}


# 20 visually-distinct colors, cycled per label (ref Visualizer.scala)
_PALETTE = [(230, 25, 75), (60, 180, 75), (255, 225, 25), (0, 130, 200),
            (245, 130, 48), (145, 30, 180), (70, 240, 240), (240, 50, 230),
            (210, 245, 60), (250, 190, 190), (0, 128, 128), (230, 190, 255),
            (170, 110, 40), (255, 250, 200), (128, 0, 0), (170, 255, 195),
            (128, 128, 0), (255, 215, 180), (0, 0, 128), (128, 128, 128)]


class Visualizer:
    """Draw detections onto images (ref Visualizer.scala: boxes + label
    text with per-class colors; 'label: score' captions)."""

    def __init__(self, label_map: Optional[Dict[int, str]] = None,
                 score_threshold: float = 0.0):
        self.label_map = label_map or {}
        self.score_threshold = float(score_threshold)

    def draw(self, image: np.ndarray, detections: np.ndarray) -> np.ndarray:
        """image: [H, W, 3] uint8; detections [n, 6] with normalized boxes.
        Returns a copy with boxes and captions drawn."""
        from PIL import Image as PILImage, ImageDraw

        img = PILImage.fromarray(np.asarray(image, np.uint8))
        drawer = ImageDraw.Draw(img)
        h, w = image.shape[:2]
        for row in np.asarray(detections).reshape(-1, 6):
            label, score = int(row[0]), float(row[1])
            if score < self.score_threshold:
                continue
            x1, y1, x2, y2 = row[2] * w, row[3] * h, row[4] * w, row[5] * h
            color = _PALETTE[(label - 1) % len(_PALETTE)]
            drawer.rectangle([x1, y1, x2, y2], outline=color, width=2)
            name = self.label_map.get(label, str(label))
            drawer.text((x1 + 2, max(y1 - 10, 0)), f"{name}: {score:.2f}",
                        fill=color)
        return np.asarray(img)

    def save(self, path: str, image: np.ndarray,
             detections: np.ndarray) -> str:
        from PIL import Image as PILImage
        PILImage.fromarray(self.draw(image, detections)).save(path)
        return path
