#!/usr/bin/env python3
"""chip_smoke.py's phase 27 alone, on one GPU: every script of
examples_torch/ with its default device (the card).

    python3 dev/examples_torch_chip.py [--device cuda]

Builds the kernels first, prints each example's line (wall seconds, exit
status, launches of B1, B1b and B3) and the card's name and power limit,
and writes chiprun_out/examples_torch_chip.json.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch

    import chip_smoke as cs
    from analytics_zoo_tpu_torch.ops import _build

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("examples_torch_chip: CUDA is not available", file=sys.stderr)
        return 2
    os.chdir(ROOT)
    card = cs.card_line()
    cs.log(card)
    cs.log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    cs.log(f"build: {_build.build():.1f} s")
    kind = torch.cuda.get_device_name(0)
    rep = {"card": card, "phase27": cs.phase_examples(kind, args.device)}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "examples_torch_chip.json"),
              "w") as fh:
        json.dump(rep, fh, indent=1, default=str)
    cs.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
