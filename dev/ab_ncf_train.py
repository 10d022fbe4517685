#!/usr/bin/env python3
"""Time the NCF training step of two checkouts of the port on one GPU.

    python3 dev/ab_ncf_train.py [--bert] TREE_A TREE_B

Each TREE is the root of a checkout of the repo ("." for this one; an
older commit unpacked with ``git archive`` into a directory that
.gitignore lists). The trees run in turns, A, B, B, A, each in a fresh
process that imports that tree's package and chip_smoke.py and builds its
kernels into the tree's own build/kernels/. A process trains chip_smoke.py's
two configurations (NeuralCF at MovieLens-1M width, and the same with the
item-history column; weights from its numpy seed) through compile/fit with
``Adam(1e-3)``: two warm-up steps of 8000 rows, then STEPS steps timed on
the host clock (the fit ends by reading the step losses back: a sync).
With ``--bert`` the process also times BERT-Base fine-tuning (chip_smoke's
classifier and inputs, ``Estimator.from_torch(..., optimizer="adam")``,
fp32 with TF32 off, 32 x 128): one warm-up step, then BERT_STEPS steps.
Prints one JSON line per process and writes chiprun_out/ab_ncf_train.json.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 40
BERT_STEPS = 10


def bert_ms_per_step(chip_smoke, np, torch) -> float:
    """Host ms a BERT-Base fine-tuning step (fp32) after a warm-up step."""
    from analytics_zoo_tpu_torch.learn import Estimator
    b = chip_smoke.TRAIN_BATCH
    ids, labels = chip_smoke.train_inputs(
        np.random.RandomState(chip_smoke.SEED + 1), b * (1 + BERT_STEPS))
    est = Estimator.from_torch(
        model=chip_smoke.bert_classifier(None, use_flash=True),
        loss="sparse_categorical_crossentropy_logits", optimizer="adam",
        seed=chip_smoke.SEED)
    est.fit((ids[:b], labels[:b]), epochs=1, batch_size=b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est.fit((ids[b:], labels[b:]), epochs=1, batch_size=b, shuffle=False)
    return (time.perf_counter() - t0) * 1e3 / BERT_STEPS


def child(tree: str, bert: bool) -> dict:
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import chip_smoke
    from analytics_zoo_tpu_torch.learn.optimizers import Adam

    if os.path.dirname(os.path.abspath(chip_smoke.__file__)) != tree:
        raise RuntimeError(f"chip_smoke imported from {chip_smoke.__file__}")
    torch.backends.cuda.matmul.allow_tf32 = False
    b = chip_smoke.BATCH
    x, y, hist = chip_smoke.ncf_train_data(np)
    out = {"tree": os.path.relpath(tree, ROOT),
           "card": chip_smoke.card_line(), "steps": STEPS}
    for config in ("ncf", "hist"):
        net = chip_smoke.train_model(config)
        net.compile(optimizer=Adam(chip_smoke.NCF_LR),
                    loss="sparse_categorical_crossentropy")
        net.fit(chip_smoke.train_inputs_of(config, x, hist, 0, 2 * b),
                y[:2 * b], batch_size=b, nb_epoch=1)
        torch.cuda.synchronize()
        lo, hi = 2 * b, (2 + STEPS) * b
        t0 = time.perf_counter()
        net.fit(chip_smoke.train_inputs_of(config, x, hist, lo, hi),
                y[lo:hi], batch_size=b, nb_epoch=1, shuffle=False)
        out[f"{config}_ms_per_step"] = (time.perf_counter() - t0) * 1e3 \
            / STEPS
        del net
        torch.cuda.empty_cache()
    if bert:
        out["bert_fp32_ms_per_step"] = bert_ms_per_step(chip_smoke, np,
                                                        torch)
    return out


def main() -> int:
    if sys.argv[1:2] == ["--child"]:
        print(json.dumps(child(sys.argv[2], sys.argv[3:] == ["--bert"])),
              flush=True)
        return 0
    args = sys.argv[1:]
    bert = "--bert" in args
    trees = [a for a in args if a != "--bert"]
    if len(trees) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    runs = []
    for tree in trees + trees[::-1]:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", tree]
            + (["--bert"] if bert else []),
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "ab_ncf_train.json"),
              "w") as fh:
        json.dump(runs, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
