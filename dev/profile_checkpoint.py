#!/usr/bin/env python3
"""Where a checkpoint's write and read time goes, on one GPU.

    python3 dev/profile_checkpoint.py [--cpu]

For chip_smoke.py's BERT-Base classifier (all 12 blocks, use_flash=True)
after one Adam step at 32 x 128, and for NeuralCF at MovieLens-1M width
after one Adam step of 8000 rows, a save is split into

1. ``tree``: the state tree on the host (``TorchEstimator._state_tree``:
   device-to-host copies, the flax layout's transposes),
2. ``write``: encoding and writing ``state.msgpack`` and ``meta.json``
   (``save_checkpoint``),

and a load into

3. ``read``: the file into memory,
4. ``decode``: ``from_bytes`` against the estimator's spec tree (views
   into the buffer, no copy) and ``validate_state``,
5. ``restore``: ``TorchEstimator._restore`` (the layout's transposes,
   host-to-device copies into the parameters and the optimizer state).

Each part is the median of REPS runs on the host clock, each ended by a
device sync; with the card's name and power limit. ``--cpu`` runs the NCF
alone on the host (to rehearse). Writes chiprun_out/profile_checkpoint.json.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 3


def parts(torch, est, path: str) -> dict:
    from analytics_zoo_tpu_torch.learn import checkpoint as ckpt

    def sync():
        if est.device.type == "cuda":
            torch.cuda.synchronize()

    runs = {k: [] for k in ("tree", "write", "read", "decode", "restore")}
    for _ in range(REPS):
        shutil.rmtree(path, ignore_errors=True)
        sync()
        t0 = time.perf_counter()
        tree = est._state_tree()
        t1 = time.perf_counter()
        out = ckpt.save_checkpoint(path, tree, est._py_step, est._epoch)
        t2 = time.perf_counter()
        file = os.path.join(out, "state.msgpack")
        data = bytearray(os.path.getsize(file))
        with open(file, "rb") as fh:
            fh.readinto(data)
        t3 = time.perf_counter()
        spec = est._state_tree(spec=True)
        state = ckpt.from_bytes(spec, data)
        ckpt.validate_state(state, spec)
        t4 = time.perf_counter()
        est._restore(state)
        sync()
        t5 = time.perf_counter()
        for k, a, b in (("tree", t0, t1), ("write", t1, t2),
                        ("read", t2, t3), ("decode", t3, t4),
                        ("restore", t4, t5)):
            runs[k].append((b - a) * 1e3)
        del tree, state, data
    med = {k: sorted(v)[len(v) // 2] for k, v in runs.items()}
    mb = os.path.getsize(file) / 1e6
    shutil.rmtree(path, ignore_errors=True)
    return dict(mb=mb, median_ms=med, runs_ms=runs,
                save_ms=med["tree"] + med["write"],
                load_ms=med["read"] + med["decode"] + med["restore"])


def main() -> int:
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    import chip_smoke as cs
    from analytics_zoo_tpu_torch.learn.optimizers import Adam
    from analytics_zoo_tpu_torch.models import NeuralCF

    cpu = "--cpu" in sys.argv[1:]
    if not cpu and not torch.cuda.is_available():
        print("profile_checkpoint: CUDA is not available", file=sys.stderr)
        return 2
    device = "cpu" if cpu else "cuda"
    out = {"card": "cpu" if cpu else cs.card_line()}
    base = os.path.join(ROOT, "build", "profile_checkpoint")

    ncf = NeuralCF(**cs.NCF)
    cs.seeded_weights(ncf.model.module, cs.SEED)
    ncf.compile(optimizer=Adam(cs.NCF_LR),
                loss="sparse_categorical_crossentropy", device=device)
    x, y, _ = cs.ncf_train_data(np)
    ncf.fit(x[:cs.BATCH], y[:cs.BATCH], batch_size=cs.BATCH, nb_epoch=1)
    out["ncf"] = parts(torch, ncf.model.estimator, os.path.join(base, "n"))
    if not cpu:
        from analytics_zoo_tpu_torch.text import BERTClassifier, BertConfig
        clf = BERTClassifier(cs.BERT_CLASSES,
                             config=BertConfig(use_flash=True),
                             seq_len=cs.TRAIN_LEN, seed=cs.SEED)
        ids, labels = cs.train_inputs(np.random.RandomState(cs.SEED),
                                      cs.TRAIN_BATCH)
        clf.fit(ids, labels, epochs=1, batch_size=cs.TRAIN_BATCH)
        out["bert"] = parts(torch, clf.estimator, os.path.join(base, "b"))
    shutil.rmtree(base, ignore_errors=True)
    print(json.dumps(out), flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "profile_checkpoint.json"),
              "w") as fh:
        json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
