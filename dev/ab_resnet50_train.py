#!/usr/bin/env python3
"""Time chip_smoke.py's phase 17(a) bf16 ResNet-50 step window of two
checkouts on one GPU.

    python3 dev/ab_resnet50_train.py TREE_A TREE_B [--rounds 2]

Each TREE is the root of a checkout of the repo ("." for this one; another
unpacked with ``git archive`` into a directory that .gitignore lists). The
trees run in turns, A, B, B, A (``--rounds`` times), each in a fresh
process that imports that tree's package and chip_smoke.py and runs
bench.py's ResNet-50 window (``ImageClassifier(resnet-50, 2 classes, 224
px, mixed_bfloat16)``, Adam, batch 32 on the card, 2 warm-up and 10 timed
steps on the host clock) three times, then counts the kernels of one
profiled step. Prints one JSON line per process (the three windows' ms a
step and the kernels a step) and writes chiprun_out/ab_resnet50_train.json.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = """
import json, chip_smoke as cs, numpy as np, torch
x, y = cs.p17_data(np, cs.P17_BATCH)
clf = cs.p17_classifier(np, "mixed_bfloat16")
clf.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
est = clf.model.estimator
xs, ys = est._tensors(x), est._tensors(y)
windows = [cs.p17_window(torch, est, xs, ys) for _ in range(3)]
acts = [torch.profiler.ProfilerActivity.CUDA]
with torch.profiler.profile(activities=acts) as prof:
    est._train_step(xs, ys)
    torch.cuda.synchronize()
kernels = sum(1 for e in prof.events() if e.device_type.name == "CUDA")
print("AB_R50 " + json.dumps({"card": cs.card_line(), "ms": windows,
                              "kernels": kernels}))
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("tree_a")
    ap.add_argument("tree_b")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    runs = []
    for _ in range(args.rounds):
        for tree in (args.tree_a, args.tree_b, args.tree_b, args.tree_a):
            cwd = os.path.abspath(os.path.join(ROOT, tree))
            out = subprocess.run([sys.executable, "-c", CHILD], cwd=cwd,
                                 capture_output=True, text=True, check=True,
                                 timeout=600)
            line = next(ln for ln in out.stdout.splitlines()
                        if ln.startswith("AB_R50 "))
            rec = {"tree": tree, **json.loads(line[len("AB_R50 "):])}
            print(json.dumps(rec), flush=True)
            runs.append(rec)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "ab_resnet50_train.json"),
              "w") as fh:
        json.dump(runs, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
