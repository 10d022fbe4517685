"""Object detection end-to-end (mirrors ref apps/object-detection: load a
detection model, run it over images, visualize the boxes — plus the
training/evaluation loop the reference delegates to the SSD zoo model,
``zoo/.../models/objectdetection``).

A tiny SSDLite is trained on synthetic one-box images (bright square on
dark background), then detections are decoded (NMS), scored with VOC mAP,
and drawn with the Visualizer.

The counterpart of examples/object_detection.py. Runs on the card by default;
``--device cpu`` runs it on the host:

    python examples_torch/object_detection.py [--device cpu]
"""

import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import tempfile

import numpy as np


def make_box_images(n=64, size=32, seed=0):
    """Images with one axis-aligned bright square; label 1, box in
    normalized [ymin, xmin, ymax, xmax]."""
    rng = np.random.RandomState(seed)
    imgs = rng.rand(n, size, size, 3).astype(np.float32) * 0.2
    boxes, labels = [], []
    for k in range(n):
        s = rng.randint(size // 4, size // 2)
        y0 = rng.randint(0, size - s)
        x0 = rng.randint(0, size - s)
        imgs[k, y0:y0 + s, x0:x0 + s, :] = 1.0
        boxes.append(np.array([[y0 / size, x0 / size,
                                (y0 + s) / size, (x0 + s) / size]],
                              np.float32))
        labels.append(np.array([1]))
    return imgs, boxes, labels


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args(argv).device

    from analytics_zoo_tpu_torch import init_orca_context, stop_orca_context
    from analytics_zoo_tpu_torch.models.image.objectdetection import (
        ObjectDetector, SSDLite, Visualizer, mean_average_precision,
    )

    init_orca_context(cluster_mode="local", device=device)
    try:
        imgs, gt_boxes, gt_labels = make_box_images()

        ssd = SSDLite(class_num=1, image_size=32)
        y = ssd.encode_ground_truth(gt_boxes, gt_labels)
        ssd.compile(optimizer="adam", loss=ssd.loss(), device=device)
        history = ssd.fit(imgs, y, batch_size=16, nb_epoch=6)
        losses = [round(v, 4) for v in history["loss"]]
        print("train loss per epoch:", losses)
        assert losses[-1] < losses[0], "SSD loss did not decrease"

        detector = ObjectDetector(ssd, conf_threshold=0.2, device=device)
        detections = detector.predict(imgs)
        n_boxes = [len(d) for d in detections]
        print("detections per image (first 8):", n_boxes[:8])

        res = mean_average_precision(detections, gt_boxes, gt_labels,
                                     n_classes=1)
        print("VOC mAP@0.5:", round(float(res["mAP"]), 4))

        vis = Visualizer(label_map={1: "square"})
        with tempfile.TemporaryDirectory() as d:
            sel = next((k for k, nb in enumerate(n_boxes) if nb), 0)
            path = vis.save(f"{d}/det.png", imgs[sel], detections[sel])
            print("wrote visualization:", path.split("/")[-1])
    finally:
        stop_orca_context()


if __name__ == "__main__":
    main()
