#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's Wide&Deep training step, on
one GPU.

    python3 dev/profile_torch_widedeep_train.py

Builds chip_smoke.py's phase 12(a) model, bench.py's
measure_widedeep_train configuration (``WideAndDeep(2, ...,
"wide_n_deep")`` at ``WND_DIMS``: a 1116-column wide block, 15
indicator columns, two tables of 17 x 8 and 1001 x 64 looked up by one
fused lookup, 2 continuous columns; weights from chip_smoke.py's numpy
seed), compiles it with ``Adam(1e-3)`` and
``sparse_categorical_crossentropy`` on ``cuda``, and traces ``fit`` over
5 steps of bench.py's batch of 1024 (its one batch repeated, as bench.py
steps it) with torch.profiler, after two warm-up steps. It reports what
dev/profile_torch_ncf_train.py reports for NCF: the wall time, the summed
device time of every CUDA kernel and copy, the device's idle share, the
launches per step, the device time per kernel and per group (GEMMs, the
lookup, the scatter, the sort, the optimizer's multi-tensor kernels, the
rest) and the operators that take the most host time. Writes
chiprun_out/profile_torch_widedeep_train.json and prints it.
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(ROOT))
sys.path.insert(0, ROOT)


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_widedeep_train: CUDA is not available",
              file=sys.stderr)
        return 2
    import chip_smoke
    from profile_torch_ncf import _window
    from profile_torch_ncf_train import STEPS, _groups, _host_ops
    from analytics_zoo_tpu_torch.learn.optimizers import Adam
    from analytics_zoo_tpu_torch.models import WideAndDeep

    torch.backends.cuda.matmul.allow_tf32 = False
    b = chip_smoke.WND_BATCH
    out = {"card": chip_smoke.card_line(), "torch": torch.__version__,
           "batch": b, "steps": STEPS}
    x, y = chip_smoke.wnd_data(np)
    net = chip_smoke.seeded_zoo(
        lambda: WideAndDeep(2, chip_smoke.wnd_info()))
    net.compile(optimizer=Adam(chip_smoke.ZOO_LR),
                loss="sparse_categorical_crossentropy")

    def repeated(n):
        return [np.tile(a, (n, 1)) for a in x], np.tile(y, n)
    net.fit(*repeated(2), batch_size=b, nb_epoch=1, shuffle=False)
    torch.cuda.synchronize()
    data = repeated(STEPS)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        # the fit ends by reading the step losses back: a sync
        net.fit(*data, batch_size=b, nb_epoch=1, shuffle=False)
        wall = time.perf_counter() - t0
    window = _window(prof, wall)
    window["groups"] = _groups(window)
    window["launches_per_step"] = sum(
        k["count"] for k in window["kernels"].values()) / STEPS
    window["host_ops"] = _host_ops(prof)
    window["wall_ms_per_step"] = wall * 1e3 / STEPS
    window["device_ms_per_step"] = window["device_ms"] / STEPS
    out["fit_widedeep"] = window

    os.makedirs(os.path.join(os.path.dirname(ROOT), "chiprun_out"),
                exist_ok=True)
    with open(os.path.join(os.path.dirname(ROOT), "chiprun_out",
                           "profile_torch_widedeep_train.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps({k: v for k, v in out.items()
                      if not isinstance(v, dict)}
                     | {f: window[f] for f in (
                         "wall_ms_per_step", "device_ms_per_step",
                         "idle_share", "launches_per_step", "groups",
                         "host_ops")}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
