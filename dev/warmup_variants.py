#!/usr/bin/env python3
"""What a rung's warm-up leaves warm for the serve thread, on one GPU.

    python3 dev/warmup_variants.py [--trials 3]

For each trial and each variant, a fresh BERT-Base bf16 classifier
(chip_smoke.py's seeded weights, ``use_flash=True``) on a batch rung that
no model of the process has run yet (one new rung a trial and variant,
from 9 upward, so cuBLAS's per-shape choices start cold every time). The
rung is warmed one way, then the main thread (standing in for the serve
thread) times its first and its second predict of one padded batch
(host clock, ending in a synchronize):

- ``none``: no warm-up;
- ``warm_up``: ``InferenceModel.warm_up`` (the serving engine's warm-up);
- ``private_stream``: the forward on a background thread, on a CUDA
  stream of its own, then a sync of that stream;
- ``default_stream``: the forward on a background thread, on the default
  stream;
- ``same_thread``: the forward on the main thread itself.

Variants take turns within each trial. Writes
chiprun_out/warmup_variants.json and prints it with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

VARIANTS = ("none", "warm_up", "private_stream", "default_stream",
            "same_thread")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=3)
    args = ap.parse_args()
    import numpy as np
    import torch

    import chip_smoke as cs
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("warmup_variants: CUDA is not available", file=sys.stderr)
        return 2
    card = cs.card_line()
    cs.log(card)
    _build.build(["flash_attention"])
    state = cs.bert_classifier(None, use_flash=True).state_dict()
    rng = np.random.RandomState(cs.SEED)
    x = cs.bert_inputs(rng, 64)
    bf16 = dict(use_flash=True, dtype=torch.bfloat16)
    # one bf16 predict first, so process-wide first touches (the
    # library's load, the context) fall before every variant alike
    first = InferenceModel(device="cuda").load_torch(
        cs.bert_classifier(state, **bf16), tuple(a[:1] for a in x))
    first.predict(tuple(a[:32] for a in x), batch_size=32)
    torch.cuda.synchronize()

    def timed(im, rung):
        batch = tuple(a[:rung] for a in x)
        t0 = time.perf_counter()
        im.predict_fetch(im.predict_async(batch))
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    rows = {v: [] for v in VARIANTS}
    rung = 9
    for _ in range(args.trials):
        for variant in VARIANTS:
            while rung in (12, 16, 32):
                rung += 1
            im = InferenceModel(device="cuda").load_torch(
                cs.bert_classifier(state, **bf16), tuple(a[:1] for a in x))
            t0 = time.perf_counter()
            batch = tuple(a[:rung] for a in x)
            if variant == "warm_up":
                im.warm_up(rungs=(rung,))
                im.wait_warm()
            elif variant == "private_stream":
                def private():
                    stream = torch.cuda.Stream()
                    with torch.cuda.stream(stream):
                        im.predict_fetch(im.predict_async(batch))
                    stream.synchronize()
                t = threading.Thread(target=private)
                t.start()
                t.join()
            elif variant == "default_stream":
                t = threading.Thread(target=lambda: (
                    im.predict_fetch(im.predict_async(batch)),
                    torch.cuda.synchronize()))
                t.start()
                t.join()
            elif variant == "same_thread":
                timed(im, rung)
            warm_ms = (time.perf_counter() - t0) * 1e3
            rows[variant].append(dict(rung=rung, warm_ms=warm_ms,
                                      first_ms=timed(im, rung),
                                      second_ms=timed(im, rung)))
            rung += 1
    out = {"card": card, "variants": rows,
           "median_first_over_second": {
               v: float(np.median([r["first_ms"] / r["second_ms"]
                                   for r in rs])) for v, rs in rows.items()}}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "warmup_variants.json"),
              "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
