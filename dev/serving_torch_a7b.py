#!/usr/bin/env python3
"""chip_smoke.py's phase 16 alone, on one GPU: the rest of Cluster
Serving (ROADMAP A7b).

    python3 dev/serving_torch_a7b.py

Builds the kernels, then the models phase 16 uses as chip_smoke.py
builds them: NeuralCF at MovieLens-1M width (phase 4), the BERT-Base
classifier's seeded weights (phase 8) and bench.py's NCF training rows
(phase 10); TF32 off. Then runs phase 16 (int8 NCF and BERT-Base, the
profiled fits' MFU, the int8 NCF served with its /trace, the fleet from
config.yaml with a SIGKILLed replica) with all its checks, prints its
lines and the card's name and power limit, and writes
chiprun_out/serving_torch_a7b.json.
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from analytics_zoo_tpu_torch.learn import Estimator
    from analytics_zoo_tpu_torch.models import NeuralCF
    from analytics_zoo_tpu_torch.ops import _build
    from analytics_zoo_tpu_torch.serving import (Broker, ClusterServing,
                                                 InputQueue, OutputQueue)

    if not torch.cuda.is_available():
        print("serving_torch_a7b: CUDA is not available", file=sys.stderr)
        return 2
    os.chdir(ROOT)
    card = cs.card_line()
    kind = torch.cuda.get_device_name(0)
    cs.log(card)
    t0 = time.perf_counter()
    cs.log(f"build: {_build.build():.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    ncf = NeuralCF(**cs.NCF)
    cs.seeded_weights(ncf.model.module, cs.SEED)
    state = cs.bert_classifier(None, use_flash=True).state_dict()
    x_tr, y_tr, _ = cs.ncf_train_data(np)
    cs.log(f"setup: {time.perf_counter() - t0:.1f} s")
    rep = cs.phase_a7b(
        torch, np, (Broker, ClusterServing, InputQueue, OutputQueue), ncf,
        state, Estimator, x_tr, y_tr, kind)
    cs.log(f"phase 16: {rep['seconds']:.1f} s; launches by path: "
           f"{rep['launches']}")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "serving_torch_a7b.json"),
              "w") as fh:
        json.dump(dict(card=card, kind=kind, a7b=rep), fh, indent=1,
                  default=str)
    cs.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
