#!/usr/bin/env python3
"""CPU estimate of how far OPT_STEPS NCF training steps with each
optimizer may move when only the order of their sums changes: the basis
of chip_smoke.py's phase 14(b) limits.

    python3 dev/estimate_optimizer_limits.py [--batch B] [--steps N]

Builds chip_smoke.py's NCF at full width (MovieLens-1M, weights from
numpy seed 0) and trains it for ``--steps`` steps (default OPT_STEPS) of
``--batch`` rows (default bench.py's 8000) with each optimizer of phase
14(b) at its JAX wrapper's defaults, and with Adam(1e-3) for reference,
twice on the CPU: each batch with its rows in order and reversed.
Reversing the rows changes the order of every sum over the batch (the
loss mean, the Dense weight gradients, each table row's scatter-add),
which is what the card changes against the CPU. Prints, per optimizer,
the largest difference of a step's loss, the largest parameter
difference and the leaf it is in, and the share of elements of the worst
leaf past 1e-5 (``share_past_1e5``). Runs on the CPU only; writes nothing.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def run(torch, np, make, x, y, batch, steps, reverse):
    net = chip_smoke.train_model("ncf")
    net.compile(optimizer=make(), loss="sparse_categorical_crossentropy",
                device="cpu")
    if reverse:
        order = np.concatenate([np.arange((i + 1) * batch - 1,
                                          i * batch - 1, -1)
                                for i in range(steps)])
        x, y = x[order], y[order]
    net.fit(x, y, batch_size=batch, nb_epoch=1, shuffle=False)
    return np.asarray(net.estimator.step_losses), net.get_weights()


def main() -> int:
    import numpy as np
    import torch
    from analytics_zoo_tpu_torch.learn import optimizers as opt_lib

    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=chip_smoke.BATCH)
    parser.add_argument("--steps", type=int, default=chip_smoke.OPT_STEPS)
    args = parser.parse_args()
    torch.manual_seed(0)
    x, y, _ = chip_smoke.ncf_train_data(np)
    rows = args.batch * args.steps
    x, y = x[:rows], y[:rows]
    cases = [("adam", lambda: opt_lib.Adam(chip_smoke.NCF_LR))] + [
        (name, lambda c=cls, k=kw: getattr(opt_lib, c)(**k))
        for name, cls, kw in chip_smoke.OPTIMIZER_ARGS]
    out = {"batch": args.batch, "steps": args.steps}
    for name, make in cases:
        (l0, w0), (l1, w1) = [run(torch, np, make, x, y, args.batch,
                                  args.steps, rev) for rev in (False, True)]
        per_leaf = {k: float(np.abs(w0[k] - w1[k]).max()) for k in w0}
        worst = max(per_leaf, key=per_leaf.get)
        out[name] = dict(
            max_loss_diff=float(np.abs(l0 - l1).max()),
            max_param_diff=per_leaf[worst], worst_leaf=worst,
            share_past_1e5=float(np.mean(
                np.abs(w0[worst] - w1[worst]) > 1e-5)),
            first_loss=float(l0[0]), last_loss=float(l0[-1]))
        print(name, json.dumps(out[name]), flush=True)
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
