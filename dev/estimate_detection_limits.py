#!/usr/bin/env python3
"""The basis of chip_smoke.py phase 21(a)'s limits, on the CPU: one
SSD300-VGG(20) training step (batch P21_CHECK_ROWS at 300 px, SGD, the
phase's seeded weights and boxes) in fp32 and under mixed_bfloat16
against the same step in float64, as the distance of the loss and of
the heads' 24 gradients (the loc/conf convolutions) over float64's.

    python3 dev/estimate_detection_limits.py [--rows N] [--threads T]

The phase holds the card's fp32 step within P21_FP32_OVER_CPU of the
CPU's own fp32 distance (or P21_FP32_FLOOR) and its bf16 step at
P21_BF16_*; this prints what the CPU reads for each. About a minute on
8 threads.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from analytics_zoo_tpu_torch.models.image.objectdetection import (
        bbox_util,
    )
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=cs.P21_CHECK_ROWS)
    ap.add_argument("--threads", type=int, default=8)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    ssd = cs.p21_ssd(np)
    state = {k: v.clone() for k, v in ssd.model.module.state_dict().items()}
    x, boxes, labels = cs.p21_images(np, args.rows, seed=cs.SEED + 210)
    anchors = bbox_util.ssd_pytorch_priors()
    y = np.stack([bbox_util.encode_targets(b, lab, anchors)
                  for b, lab in zip(boxes, labels)])
    ref_loss, ref = cs.p21_step(torch, np, state, x, y, "cpu", f64=True)
    out = {"rows": args.rows, "float64_loss": ref_loss}
    for label, dtype in (("fp32", "float32"), ("bf16", "mixed_bfloat16")):
        loss, grads = cs.p21_step(torch, np, state, x, y, "cpu", dtype=dtype)
        out[label] = {"loss_rel": abs(loss - ref_loss) / abs(ref_loss),
                      "heads_rel": cs.p17_norm_rel(grads, ref)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
