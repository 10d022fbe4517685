#!/usr/bin/env python3
"""chip_smoke.py's phase 24 alone, on one GPU: pipeline parallelism (the
pipelined MLP under "pp4" and "dp2,pp2", the LM at BERT-Base's block
widths under "pp4"), sharded serving (bench.py's sharded MLP under "tp4"
and "tp2", BERT-Base and NCF under "tp2" through ClusterServing and the
FrontEnd), sharded generate (the decode Seq2Seq under "tp2") and TCMF at
the electricity panel's width over two ranks; ranks share the card over
gloo.

    python3 dev/pipeline_serving_torch.py [--parts abcd]

Builds the kernels first, prints its lines and the card's name and power
limit, and writes chiprun_out/pipeline_serving_torch.json (every rank's
readings in chiprun_out/phase24.json).
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
    ap.add_argument("--parts", default="abcd")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("pipeline_serving_torch: CUDA is not available",
              file=sys.stderr)
        return 2
    os.chdir(ROOT)
    card = cs.card_line()
    cs.log(card)
    cs.log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    cs.log(f"build: {_build.build():.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    rep = {"card": card, "phase24": cs.phase_pipeline_serving(
        torch, np, kind, parts=args.parts)}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "pipeline_serving_torch.json"),
              "w") as fh:
        json.dump(rep, fh, indent=1, default=str)
    cs.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
