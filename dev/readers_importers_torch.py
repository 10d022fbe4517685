#!/usr/bin/env python3
"""chip_smoke.py's phase 25 alone, on one GPU: TFRecord, Elasticsearch
and image-parquet feeding fits, autograd and keras2, nnframes, the GAN,
TorchNet's attention on the flash kernel, ONNX and OpenVINO at
ResNet-50.

    python3 dev/readers_importers_torch.py [--parts abcdefgh]

Builds the kernels first, prints its lines and the card's name and power
limit, and writes chiprun_out/readers_importers_torch.json.
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
    from analytics_zoo_tpu_torch.ops import _build

    ap = argparse.ArgumentParser()
    ap.add_argument("--parts", default="abcdefgh")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("readers_importers_torch: CUDA is not available",
              file=sys.stderr)
        return 2
    os.chdir(ROOT)
    card = cs.card_line()
    cs.log(card)
    cs.log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    cs.log(f"build: {_build.build():.1f} s")
    os.environ["ZOO_AUTOTUNE"] = "off"
    kind = torch.cuda.get_device_name(0)
    rep = {"card": card, "phase25": cs.phase_readers_importers(
        torch, np, kind, parts=args.parts)}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "readers_importers_torch.json"),
              "w") as fh:
        json.dump(rep, fh, indent=1, default=str)
    cs.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
