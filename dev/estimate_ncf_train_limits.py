#!/usr/bin/env python3
"""CPU estimate of how far one NCF training step may move when only the
order of its sums changes: the basis of chip_smoke.py's phase 10(a)
limits (NCF_STEP_LOSS_ATOL, NCF_STEP_PARAM_ATOL).

    python3 dev/estimate_ncf_train_limits.py

Builds both training configurations of chip_smoke.py at full width
(NeuralCF at MovieLens-1M width, and the same with the pooled
item-history column; weights from numpy seed 0), and takes one
``compile(Adam(1e-3))``/``fit`` step on bench.py's first batch of 8000
rows twice on the CPU: with the rows in order and reversed. Reversing the
rows changes the order of every sum over the batch (the loss mean, the
Dense weight gradients, each table row's scatter-add), which is what the
card changes against the CPU (cuBLAS splits its sums in other places).
Prints, per configuration, the loss difference and the largest parameter
difference after the step. Runs on the CPU only; writes nothing.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def step(torch, config, x, y):
    from analytics_zoo_tpu_torch.learn.optimizers import Adam
    net = chip_smoke.train_model(config)
    net.compile(optimizer=Adam(chip_smoke.NCF_LR),
                loss="sparse_categorical_crossentropy", device="cpu")
    net.fit(x, y, batch_size=chip_smoke.BATCH, nb_epoch=1, shuffle=False)
    return net.estimator.step_losses[-1], net.get_weights()


def main() -> int:
    import numpy as np
    import torch

    torch.manual_seed(0)
    x, y, hist = chip_smoke.ncf_train_data(np)
    b = chip_smoke.BATCH
    out = {}
    for config in ("ncf", "hist"):
        runs = []
        for order in (slice(0, b), slice(b - 1, None, -1)):
            xs = chip_smoke.train_inputs_of(config, x, hist, 0, b)
            xs = [a[order] for a in xs] if isinstance(xs, list) \
                else xs[order]
            runs.append(step(torch, config, xs, y[:b][order]))
        (l0, w0), (l1, w1) = runs
        per_leaf = {k: float(np.abs(w0[k] - w1[k]).max()) for k in w0}
        out[config] = dict(loss_diff=abs(l0 - l1),
                           max_param_diff=max(per_leaf.values()),
                           per_leaf=per_leaf)
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
