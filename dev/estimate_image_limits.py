#!/usr/bin/env python3
"""How far the eval logits of chip_smoke.py's phase 18(a) models sit from
float64 in fp32 and in bf16, on the CPU: the basis of phase 18(a)'s
limits (P18_FP32_RTOL, P18_BF16_RTOL).

    python3 dev/estimate_image_limits.py [--size 224] [--rows 4]
        [--threads 8]

Builds each of ``mobilenet``, ``inception-v1`` and ``mobilenet-v2`` as
phase 18(a) does (``ImageClassifier``, 1000 classes, weights from its
numpy seed; the bf16 one under ``mixed_bfloat16`` from the same state
dict), feeds phase 18(a)'s first ``--rows`` rows, and prints, for fp32
and for bf16, the norm of the logits' difference from the float64
forward over the float64 logits' norm (the logits: the Dense's output
before the softmax). One JSON object on the last line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=chip_smoke.P18_IMAGE)
    ap.add_argument("--rows", type=int, default=chip_smoke.P18_ROWS)
    ap.add_argument("--threads", type=int, default=8)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    chip_smoke.P18_IMAGE = args.size
    x = chip_smoke.p18_images(np, chip_smoke.P18_BATCH,
                              seed=chip_smoke.SEED + 1)[:args.rows]
    out = {}
    for name in chip_smoke.P18_ARCHS:
        clf = chip_smoke.p18_classifier(np, name)
        state = clf.model.module.state_dict()
        bf = chip_smoke.p18_classifier(np, name, "mixed_bfloat16",
                                       state=state)
        _, ref = chip_smoke.p18_forward(torch, clf.model.module, x, "cpu",
                                        f64=True)
        row = {}
        for label, src in (("fp32", clf), ("bf16", bf)):
            _, logits = chip_smoke.p18_forward(torch, src.model.module, x,
                                               "cpu")
            row[label] = chip_smoke.p17_rel(logits, ref)
        out[name] = row
        print(f"{name}: fp32 {row['fp32']:.3g}, bf16 {row['bf16']:.3g} "
              "(of the float64 logits' norm)", flush=True)
    print(json.dumps({"size": args.size, "rows": args.rows,
                      "distances": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
