"""Bounding-box utilities for SSD-style detection: the port's copy of
``analytics_zoo_tpu/models/image/objectdetection/bbox_util.py`` (host
numpy, the same code, so the same bits on the same inputs).

Ref: Scala ``zoo/.../models/image/objectdetection/common/BboxUtil.scala``
(1,033 LoC: prior generation, encode/decode with variances, jaccard
matching, NMS). Same math, vectorized numpy host-side: anchors are static
per model config, so everything device-side stays fixed-shape.

Boxes are ``[xmin, ymin, xmax, ymax]`` normalized to [0, 1].
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

# SSD center/size variances (ref BboxUtil encode: variance 0.1/0.2)
VARIANCES = (0.1, 0.1, 0.2, 0.2)


def per_layer_ratios(aspect_ratios, n_layers: int):
    """Normalize ``aspect_ratios`` to one plain-float ratio tuple per
    feature map: a flat sequence applies to every layer; a sequence of
    sequences (or a 2-D array) is per-layer (ref: the SSD model configs
    give each prior-box layer its own ratio set — BboxUtil/PriorBox
    per-layer minSizes/maxSizes/ratios)."""
    items = list(aspect_ratios)
    nested = len(items) > 0 and isinstance(items[0],
                                           (list, tuple, np.ndarray))
    if nested:
        if len(items) != n_layers:
            raise ValueError(
                f"per-layer aspect_ratios needs {n_layers} entries, "
                f"got {len(items)}")
        return [tuple(float(r) for r in rs) for rs in items]
    return [tuple(float(r) for r in items)] * n_layers


def generate_anchors(feature_map_sizes: Sequence[int],
                     scales: Sequence[float],
                     aspect_ratios=(1.0, 2.0, 0.5)) -> np.ndarray:
    """[A, 4] anchors over square feature maps.

    Per cell: one anchor per aspect ratio at ``scales[k]`` plus the extra
    sqrt(s_k * s_{k+1}) ratio-1 anchor (standard SSD; ref
    ``PriorBox``/``BboxUtil`` prior generation). ``aspect_ratios`` may be
    flat (same ratios every scale) or per-layer (list of lists, like the
    reference's per-prior-box-layer configs).
    """
    if len(scales) < len(feature_map_sizes) + 1:
        raise ValueError("need len(scales) == len(feature_map_sizes) + 1 "
                         "(the extra scale feeds the sqrt anchor)")
    ratios = per_layer_ratios(aspect_ratios, len(feature_map_sizes))
    boxes: List[np.ndarray] = []
    for k, fm in enumerate(feature_map_sizes):
        s = scales[k]
        s_prime = float(np.sqrt(scales[k] * scales[k + 1]))
        centers = (np.arange(fm, dtype=np.float32) + 0.5) / fm
        cx, cy = np.meshgrid(centers, centers)           # [fm, fm]
        cx, cy = cx.reshape(-1), cy.reshape(-1)
        whs = [(s * np.sqrt(r), s / np.sqrt(r)) for r in ratios[k]]
        whs.append((s_prime, s_prime))
        # cell-major layout (index = cell*A + a) to match the head reshape
        # [b, H, W, A*4] → [b, H*W*A, 4] in object_detector._reshape_head
        w = np.array([w for w, _ in whs], np.float32)       # [A]
        h = np.array([h for _, h in whs], np.float32)
        cx, cy = cx[:, None], cy[:, None]                    # [fm*fm, 1]
        cell = np.stack([cx - w / 2, cy - h / 2,
                         cx + w / 2, cy + h / 2], axis=2)    # [fm*fm, A, 4]
        boxes.append(cell.reshape(-1, 4))
    out = np.concatenate(boxes, axis=0).astype(np.float32)
    return np.clip(out, 0.0, 1.0)


def anchors_per_cell(aspect_ratios: Sequence[float] = (1.0, 2.0, 0.5)) -> int:
    return len(aspect_ratios) + 1


# Canonical anchor-pyramid presets, mirroring the reference's per-model
# prior-box configs (ref objectdetection model configs: VGG SSD 300/512
# minSizes/maxSizes/aspect ratios per layer). "ssd300_vgg" reproduces the
# classic 8,732-anchor pyramid.
ANCHOR_CONFIGS = {
    "ssd300_vgg": dict(
        feature_map_sizes=[38, 19, 10, 5, 3, 1],
        scales=[0.1, 0.2, 0.375, 0.55, 0.725, 0.9, 1.075],
        aspect_ratios=[(1.0, 2.0, 0.5),
                       (1.0, 2.0, 0.5, 3.0, 1.0 / 3.0),
                       (1.0, 2.0, 0.5, 3.0, 1.0 / 3.0),
                       (1.0, 2.0, 0.5, 3.0, 1.0 / 3.0),
                       (1.0, 2.0, 0.5),
                       (1.0, 2.0, 0.5)]),
    "ssd512_vgg": dict(
        feature_map_sizes=[64, 32, 16, 8, 4, 2, 1],
        scales=[0.07, 0.15, 0.30, 0.45, 0.60, 0.75, 0.90, 1.05],
        aspect_ratios=[(1.0, 2.0, 0.5),
                       (1.0, 2.0, 0.5, 3.0, 1.0 / 3.0),
                       (1.0, 2.0, 0.5, 3.0, 1.0 / 3.0),
                       (1.0, 2.0, 0.5, 3.0, 1.0 / 3.0),
                       (1.0, 2.0, 0.5, 3.0, 1.0 / 3.0),
                       (1.0, 2.0, 0.5),
                       (1.0, 2.0, 0.5)]),
    "mobilenet_300": dict(
        feature_map_sizes=[19, 10, 5, 3, 2, 1],
        scales=[0.2, 0.35, 0.5, 0.65, 0.8, 0.95, 1.1],
        aspect_ratios=[(1.0, 2.0, 0.5, 3.0, 1.0 / 3.0)] * 6),
}


def anchors_from_config(name: str) -> np.ndarray:
    """Build the full anchor pyramid for a named preset."""
    if name not in ANCHOR_CONFIGS:
        raise ValueError(f"unknown anchor config {name!r}; "
                         f"have {sorted(ANCHOR_CONFIGS)}")
    cfg = ANCHOR_CONFIGS[name]
    return generate_anchors(cfg["feature_map_sizes"], cfg["scales"],
                            cfg["aspect_ratios"])


def ssd_pytorch_priors() -> np.ndarray:
    """[8732, 4] corner-form priors in the EXACT ssd.pytorch PriorBox
    geometry and per-cell order — required to decode heads TRAINED
    against that prior box (``import_ssd300_from_torch`` checkpoints).

    Differences from ``ANCHOR_CONFIGS["ssd300_vgg"]`` that make this a
    separate generator rather than a preset: steps-based centers
    ((j+0.5)*step/300, not (j+0.5)/fm), min/max pixel sizes
    (30/60/111/162/213/264 + 315), and the per-cell order
    [ratio-1, extra-sqrt, 2, 1/2, (3, 1/3)] — ``generate_anchors``
    appends the extra anchor LAST, so index a in a trained head would
    decode against the wrong prior shape."""
    fms = (38, 19, 10, 5, 3, 1)
    steps = (8, 16, 32, 64, 100, 300)
    mins = (30, 60, 111, 162, 213, 264)
    maxs = (60, 111, 162, 213, 264, 315)
    ars = ((2,), (2, 3), (2, 3), (2, 3), (2,), (2,))
    boxes: List[np.ndarray] = []
    for k, fm in enumerate(fms):
        s = mins[k] / 300.0
        sp = float(np.sqrt(mins[k] * maxs[k])) / 300.0
        f_k = 300.0 / steps[k]
        centers = (np.arange(fm, dtype=np.float32) + 0.5) / f_k
        cy, cx = np.meshgrid(centers, centers, indexing="ij")
        cx, cy = cx.reshape(-1), cy.reshape(-1)
        whs = [(s, s), (sp, sp)]
        for ar in ars[k]:
            r = float(np.sqrt(ar))
            whs += [(s * r, s / r), (s / r, s * r)]
        w = np.array([w for w, _ in whs], np.float32)
        h = np.array([h for _, h in whs], np.float32)
        cx, cy = cx[:, None], cy[:, None]
        cell = np.stack([cx - w / 2, cy - h / 2,
                         cx + w / 2, cy + h / 2], axis=2)
        boxes.append(cell.reshape(-1, 4))
    out = np.concatenate(boxes, axis=0).astype(np.float32)
    return np.clip(out, 0.0, 1.0)


def _center_size(boxes: np.ndarray) -> np.ndarray:
    wh = boxes[..., 2:] - boxes[..., :2]
    c = boxes[..., :2] + wh / 2
    return np.concatenate([c, wh], axis=-1)


def iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[n, m] pairwise IoU (ref BboxUtil.jaccardOverlap)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(br - tl, 0, None), axis=2)
    area_a = np.prod(a[:, 2:] - a[:, :2], axis=1)
    area_b = np.prod(b[:, 2:] - b[:, :2], axis=1)
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / np.maximum(union, 1e-8)


def encode_targets(gt_boxes: np.ndarray, gt_labels: np.ndarray,
                   anchors: np.ndarray, iou_threshold: float = 0.5
                   ) -> np.ndarray:
    """Match ground truth to anchors and encode regression targets.

    Returns [A, 5]: 4 encoded offsets + class label (0 = background,
    object classes are 1-based). Matching = per-anchor best IoU over
    threshold, plus the best anchor for each gt forced positive
    (ref BboxUtil.matchBbox bipartite + per-prediction stages).
    """
    A = len(anchors)
    out = np.zeros((A, 5), np.float32)
    gt_boxes = np.asarray(gt_boxes, np.float32).reshape(-1, 4)
    if len(gt_boxes) == 0:
        return out
    gt_labels = np.asarray(gt_labels).reshape(-1)
    iou = iou_matrix(anchors, gt_boxes)                  # [A, G]
    best_gt = iou.argmax(axis=1)
    best_iou = iou.max(axis=1)
    pos = best_iou >= iou_threshold
    # force-match: every gt claims its best anchor
    forced = iou.argmax(axis=0)                          # [G]
    pos[forced] = True
    best_gt[forced] = np.arange(len(gt_boxes))

    matched = gt_boxes[best_gt]                          # [A, 4]
    a_cs = _center_size(anchors)
    m_cs = _center_size(matched)
    vx, vy, vw, vh = VARIANCES
    enc = np.stack([
        (m_cs[:, 0] - a_cs[:, 0]) / np.maximum(a_cs[:, 2], 1e-8) / vx,
        (m_cs[:, 1] - a_cs[:, 1]) / np.maximum(a_cs[:, 3], 1e-8) / vy,
        np.log(np.maximum(m_cs[:, 2], 1e-8)
               / np.maximum(a_cs[:, 2], 1e-8)) / vw,
        np.log(np.maximum(m_cs[:, 3], 1e-8)
               / np.maximum(a_cs[:, 3], 1e-8)) / vh,
    ], axis=1)
    out[pos, :4] = enc[pos]
    out[pos, 4] = gt_labels[best_gt[pos]]
    return out


def decode_boxes(loc: np.ndarray, anchors: np.ndarray) -> np.ndarray:
    """Invert ``encode_targets`` offsets → [A, 4] corner boxes
    (ref BboxUtil.decodeBoxes)."""
    a_cs = _center_size(np.asarray(anchors, np.float32))
    vx, vy, vw, vh = VARIANCES
    cx = loc[..., 0] * vx * a_cs[:, 2] + a_cs[:, 0]
    cy = loc[..., 1] * vy * a_cs[:, 3] + a_cs[:, 1]
    w = np.exp(np.clip(loc[..., 2] * vw, -10, 10)) * a_cs[:, 2]
    h = np.exp(np.clip(loc[..., 3] * vh, -10, 10)) * a_cs[:, 3]
    boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                     axis=-1)
    return np.clip(boxes, 0.0, 1.0)


def nms(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float = 0.45,
        top_k: int = 200) -> np.ndarray:
    """Indices kept after greedy NMS (ref BboxUtil.nms / Nms.scala)."""
    order = np.argsort(-scores)[:top_k]
    keep: List[int] = []
    while len(order) > 0:
        i = order[0]
        keep.append(int(i))
        if len(order) == 1:
            break
        ious = iou_matrix(boxes[i:i + 1], boxes[order[1:]])[0]
        order = order[1:][ious <= iou_threshold]
    return np.asarray(keep, np.int64)


def detect_post_process(loc: np.ndarray, conf: np.ndarray,
                        anchors: np.ndarray, n_classes: int,
                        conf_threshold: float = 0.3,
                        nms_threshold: float = 0.45,
                        keep_top_k: int = 100) -> np.ndarray:
    """One image's raw head outputs → [n_det, 6] rows of
    ``(label, score, xmin, ymin, xmax, ymax)`` — the reference's detection
    output layout (ref BboxUtil result Tensor)."""
    boxes = decode_boxes(loc, anchors)
    # softmax over classes (background = column 0)
    e = np.exp(conf - conf.max(axis=-1, keepdims=True))
    probs = e / e.sum(axis=-1, keepdims=True)
    results = []
    for c in range(1, n_classes + 1):
        sc = probs[:, c]
        mask = sc > conf_threshold
        if not mask.any():
            continue
        bm, sm = boxes[mask], sc[mask]
        keep = nms(bm, sm, nms_threshold)
        for i in keep:
            results.append([c, sm[i], *bm[i]])
    if not results:
        return np.zeros((0, 6), np.float32)
    res = np.asarray(results, np.float32)
    return res[np.argsort(-res[:, 1])][:keep_top_k]
