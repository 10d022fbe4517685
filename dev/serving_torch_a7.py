#!/usr/bin/env python3
"""chip_smoke.py's phase 15 alone, on one GPU: Cluster Serving's
scheduling and delivery.

    python3 dev/serving_torch_a7.py

Builds the kernels, then the models phase 15 serves as chip_smoke.py
builds them: NeuralCF at MovieLens-1M width with its 8000 rows (phase 4),
the BERT-Base classifier's seeded weights (phase 8), and the Seq2Seq of
bench.py's measure_decode configuration with its greedy generation
(phase 9(a)); TF32 off. Then runs phase 15 (the native broker, NCF behind
the lanes on the Python and the native broker in turns, BERT-Base bf16
warm-up, deadlines, admission, leases, generate records with preemption
and a draft model, the HTTP frontend) with all its checks, prints its
lines and the card's name and power limit, and writes
chiprun_out/serving_torch_a7.json.
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
    from analytics_zoo_tpu_torch.common.compile_ahead import BucketLadder
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.models import NeuralCF, Seq2Seq
    from analytics_zoo_tpu_torch.ops import _build
    from analytics_zoo_tpu_torch.serving import (Broker, ClusterServing,
                                                 InputQueue, OutputQueue)

    if not torch.cuda.is_available():
        print("serving_torch_a7: CUDA is not available", file=sys.stderr)
        return 2
    card = cs.card_line()
    kind = torch.cuda.get_device_name(0)
    cs.log(card)
    t0 = time.perf_counter()
    cs.log(f"build: {_build.build():.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    ncf = NeuralCF(**cs.NCF)
    cs.seeded_weights(ncf.model.module, cs.SEED)
    rng = np.random.RandomState(cs.SEED)
    x = np.stack([rng.randint(1, cs.NCF["user_count"] + 1, cs.BATCH),
                  rng.randint(1, cs.NCF["item_count"] + 1, cs.BATCH)],
                 1).astype(np.float32)
    im = InferenceModel(device="cuda").load_zoo(ncf)
    im.predict(x, batch_size=cs.BATCH)
    state = cs.bert_classifier(None, use_flash=True).state_dict()
    m = Seq2Seq(**cs.DECODE)
    cs.seeded_weights(m.model.module, cs.SEED)
    b = cs.DECODE_BATCH
    drng = np.random.default_rng(7)
    enc = drng.standard_normal((b, 8, cs.DECODE["input_dim"])).astype(
        np.float32)
    start = np.zeros((b, cs.DECODE["output_dim"]), np.float32)
    dec_im = InferenceModel(device="cuda").load_zoo(m)
    dec_im.set_ladder(BucketLadder(b, b))
    greedy = dec_im.generate(enc, start, cs.DECODE_STEPS)
    cs.log(f"setup: {time.perf_counter() - t0:.1f} s")
    rep = cs.phase_serving_a7(
        torch, np, (Broker, ClusterServing, InputQueue, OutputQueue), im,
        x, state, (dec_im, greedy, (enc, start)), kind)
    cs.log(f"phase 15: {rep['seconds']:.1f} s; launches by path: "
           f"{rep['launches']}")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "serving_torch_a7.json"),
              "w") as fh:
        json.dump(dict(card=card, kind=kind, a7=rep), fh, indent=1,
                  default=str)
    cs.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
