#!/usr/bin/env python3
"""chip_smoke.py's phase 18 alone, on one GPU: image classification from
images to answers (the three new architectures, the torchvision-layout
import, the ImageSet path, image records served, int8 mobilenet-v2 and a
snapshot into InferenceModel).

    python3 dev/image_path_torch.py

Needs no kernel build (phase 18 launches none of the port's kernels; the
native broker builds on first use). Runs phase 18 with all its checks,
prints its lines and the card's name and power limit, and writes
chiprun_out/image_path_torch.json.
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
        print("image_path_torch: CUDA is not available", file=sys.stderr)
        return 2
    os.chdir(ROOT)
    card = cs.card_line()
    cs.log(card)
    kind = torch.cuda.get_device_name(0)
    rep = cs.phase_image_path(
        torch, np, (Broker, ClusterServing, InputQueue, OutputQueue), kind)
    cs.log(f"phase 18: {rep['seconds']:.1f} s; launches {rep['launches']}")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "image_path_torch.json"),
              "w") as fh:
        json.dump(dict(card=card, **rep), fh, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
