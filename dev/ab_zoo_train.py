#!/usr/bin/env python3
"""Time chip_smoke.py's phase 12 step windows of two checkouts on one GPU.

    python3 dev/ab_zoo_train.py TREE_A TREE_B

Each TREE is the root of a checkout of the repo ("." for this one; an
older commit unpacked with ``git archive`` into a directory that
.gitignore lists). The trees run in turns, A, B, B, A, each in a fresh
process that imports that tree's package and chip_smoke.py, builds its
kernels into the tree's own build/kernels/ and runs that tree's
``phase_zoo`` (Wide&Deep at bench.py's width, SessionRecommender,
AnomalyDetector, Seq2Seq.fit: fp32 with TF32 off, bench.py's step window
of 50 steps after 2, host clock). Prints one JSON line per process (each
model's ms a step, and the Wide&Deep fit's) and writes
chiprun_out/ab_zoo_train.json.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = """
import json, chip_smoke as cs, numpy as np, torch
from analytics_zoo_tpu_torch.ops import _build, embedding_bag as eb
_build.build()
torch.backends.cuda.matmul.allow_tf32 = False
r = cs.phase_zoo(torch, np, eb, cs.card_line())
print("AB_ZOO " + json.dumps({
    "card": cs.card_line(),
    "widedeep_window_ms": r["widedeep"]["fit"]["widedeep_train_step_ms"],
    "widedeep_fit_ms": r["widedeep"]["fit"]["fit_step_ms"],
    "session_ms": r["session"]["step_ms"],
    "anomaly_ms": r["anomaly"]["step_ms"],
    "seq2seq_ms": r["seq2seq"]["step_ms"]}))
"""


def main(argv) -> int:
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    runs = []
    for tree in (argv[0], argv[1], argv[1], argv[0]):
        cwd = os.path.abspath(os.path.join(ROOT, tree))
        out = subprocess.run([sys.executable, "-c", CHILD], cwd=cwd,
                             capture_output=True, text=True, check=True,
                             timeout=600)
        line = next(ln for ln in out.stdout.splitlines()
                    if ln.startswith("AB_ZOO "))
        rec = {"tree": tree, **json.loads(line[len("AB_ZOO "):])}
        print(json.dumps(rec), flush=True)
        runs.append(rec)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "ab_zoo_train.json"),
              "w") as fh:
        json.dump(runs, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
