#!/usr/bin/env python3
"""CPU estimate of how far one TCN training step may move when only the
order of its sums changes: the basis of chip_smoke.py's phase 13(c)
limits (TCN_STEP_LOSS_ATOL, TCN_STEP_PARAM_ATOL).

    python3 dev/estimate_tcn_train_limits.py

Builds chip_smoke.py's phase 13 model, bench.py's measure_tcn
configuration (``TemporalConvNet`` with channels (32, 32, 32), kernel 7,
8 features; dropout 0; weights from chip_smoke.py's numpy seed), and takes
one ``Estimator.from_torch(..., optimizer="adam", loss="mse")`` step on
measure_tcn's batch of 256 x 96 twice on the CPU: with the rows in order
and reversed. Reversing the rows changes the order of every sum over the
batch (the loss mean, each weight gradient), which is what the card
changes against the CPU (cuDNN and cuBLAS split their sums elsewhere).
Prints the loss difference and the largest parameter difference after the
step, per leaf. Runs on the CPU only; writes nothing.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main() -> int:
    import numpy as np

    x, y = chip_smoke.tcn_bench_data(np)
    runs = []
    for order in (slice(None), slice(None, None, -1)):
        est = chip_smoke.tcn_estimator(dropout=0.0, device="cpu")
        loss = float(est._train_step(x[order], y[order]))
        runs.append((loss, {n: p.detach().numpy()
                            for n, p in est.model.named_parameters()}))
    (l0, w0), (l1, w1) = runs
    per_leaf = {k: float(np.abs(w0[k] - w1[k]).max()) for k in w0}
    print(json.dumps(dict(loss_diff=abs(l0 - l1),
                          max_param_diff=max(per_leaf.values()),
                          per_leaf=per_leaf), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
