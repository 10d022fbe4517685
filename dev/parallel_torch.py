#!/usr/bin/env python3
"""chip_smoke.py's phase 23 alone, on one GPU: the strategies across
ranks (groups of 2 and 4 ranks sharing the card over gloo, a one-rank
NCCL group): the collectives, BERT-Base fine-tuning under dp / fsdp / tp,
NCF at MovieLens-1M width under dp / tp, ring and Ulysses attention at
BERT-Base's heads over a sequence of 8192, MoE at Switch-Base-8's FFN
widths under ep; and with ``--c20`` the cost of cuDNN's deterministic
algorithms (ROADMAP C20) before it.

    python3 dev/parallel_torch.py [--c20] [--parts abcdef]

Builds the kernels first, prints its lines and the card's name and power
limit, and writes chiprun_out/parallel_torch.json.
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
    ap.add_argument("--c20", action="store_true")
    ap.add_argument("--parts", default="abcdef")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("parallel_torch: CUDA is not available", file=sys.stderr)
        return 2
    os.chdir(ROOT)
    card = cs.card_line()
    cs.log(card)
    cs.log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    cs.log(f"build: {_build.build():.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    rep = {"card": card}
    if args.c20:
        rep["c20"] = cs.c20_cost(torch, np, kind)
    rep["parallel"] = cs.phase_parallel(torch, np, kind, parts=args.parts)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "parallel_torch.json"), "w") as fh:
        json.dump(rep, fh, indent=1, default=str)
    cs.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
