#!/usr/bin/env python3
"""How chip_smoke.py's launch count (``p19_launch_calls``: the CUDA
runtime's kernel launches under ``torch.profiler``) costs and reads with
the profiler's CPU and CUDA activities (its form since slice 18) and
with the CUDA activity alone, on phase 19(b)'s recurrent TextClassifier
fit step (128 x 500 ids, fp32, TF32 off) and its cnn step.

    python3 dev/launch_count_probe.py [--encoders cnn,lstm]

Prints, for each encoder and each form, the count and the wall seconds
of the profiled step, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def count(torch, fn, acts) -> tuple:
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    n = int(sum(e.count for e in prof.key_averages()
                if "LaunchKernel" in e.key))
    return n, time.perf_counter() - t0


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs

    ap = argparse.ArgumentParser()
    ap.add_argument("--encoders", default="cnn,lstm")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("launch_count_probe: CUDA is not available", file=sys.stderr)
        return 2
    os.chdir(ROOT)
    card = cs.card_line()
    cs.log(card)
    rng = np.random.RandomState(cs.SEED)
    x = rng.randint(1, cs.P19_VOCAB, (cs.P19_BATCH,
                                      cs.P19_TC["sequence_length"]))
    y = rng.randint(0, cs.P19_TC["class_num"], cs.P19_BATCH)
    P = torch.profiler.ProfilerActivity
    torch.backends.cuda.matmul.allow_tf32 = False
    for enc in args.encoders.split(","):
        m = cs.p19_model(np, enc)
        m.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
                  device="cuda")
        est = m.model.estimator
        xs, ys = est._tensors(x.astype(np.float32)), est._tensors(
            y.astype(np.int32))
        est._train_step(xs, ys)
        torch.cuda.synchronize()
        for name, acts in (("cpu+cuda", [P.CPU, P.CUDA]),
                           ("cuda", [P.CUDA]), ("cpu+cuda", [P.CPU, P.CUDA]),
                           ("cuda", [P.CUDA])):
            n, sec = count(torch, lambda: est._train_step(xs, ys), acts)
            cs.log(f"{enc} fp32 step, profiler {name}: {n} launches, "
                   f"{sec:.2f} s")
        del m, est
    cs.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
