#!/usr/bin/env python3
"""chip_smoke.py's phase 21 alone, on one GPU: object detection (SSD300-VGG
training at batch 32 x 300 px in fp32 and bf16 and its step against the
CPU, ObjectDetector's predict of 32 images from the twin's import, the
fixture overfit), the runtime hooks, int8 recurrent cells and the new
layers, and Arrow and encrypted records.

    python3 dev/detection_path_torch.py

No CUDA kernel of the port is on this path, so nothing is built. TF32 is
off inside the phase. Prints its lines and the card's name and power
limit, and writes chiprun_out/detection_path_torch.json.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from analytics_zoo_tpu_torch.serving import (Broker, ClusterServing,
                                                 InputQueue, OutputQueue)

    if not torch.cuda.is_available():
        print("detection_path_torch: CUDA is not available",
              file=sys.stderr)
        return 2
    os.chdir(ROOT)
    card = cs.card_line()
    cs.log(card)
    cs.log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    rep = cs.phase_detection(
        torch, np, (Broker, ClusterServing, InputQueue, OutputQueue), kind)
    cs.log(f"phase 21: {rep['seconds']:.1f} s; launches {rep['launches']}")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "detection_path_torch.json"),
              "w") as fh:
        json.dump(dict(card=card, **rep), fh, indent=1, default=str)
    cs.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
