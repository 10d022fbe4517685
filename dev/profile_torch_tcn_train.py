#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's TCN training step, on one GPU.

    python3 dev/profile_torch_tcn_train.py

Builds chip_smoke.py's phase 13 model, bench.py's measure_tcn
configuration (``TemporalConvNet`` with channels (32, 32, 32), kernel 7,
dropout 0.2, 8 features; weights from chip_smoke.py's numpy seed) through
``Estimator.from_torch(..., optimizer="adam", loss="mse")`` under
``init_orca_context()`` with ``default_matmul_precision="float32"`` (TF32
off), and traces with torch.profiler, after warm-up steps:

- ``window``: 5 steps on measure_tcn's batch of 256 x 96 already on the
  card (bench.py's ``_measure_step_time``);
- ``window_cudnn_benchmark``: the same with
  ``torch.backends.cudnn.benchmark = True`` (cuDNN times its algorithms
  and keeps the fastest; off by default, when its heuristics choose), for
  what the convolutions' algorithm choice costs;
- ``fit``: ``TCNForecaster.fit`` over 20 steps of phase 13(d)'s windows
  in XShards under DISK_4, through the streaming feed.

Each window is also timed unprofiled (the window's 20 steps, host clock).
For each it reports the wall time, the summed device time of every CUDA
kernel and copy, the device's idle share, the launches per step, the
device time per kernel and per group (convolutions, GEMMs, the optimizer,
copies, the rest) and the operators that take the most host time. Then
the streaming feed alone: one epoch of the same store iterated on the host
with no training, its ms a batch, and the window loads' share
(``data.shard.OP_TOTALS["stream_window"]``). Writes
chiprun_out/profile_torch_tcn_train.json and prints it.
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(ROOT))
sys.path.insert(0, ROOT)

STEPS = 5
FIT_STEPS = 20
#: kernel-name substring -> group, checked in this order
GROUPS = (("memcpy", "copy"), ("memset", "copy"),
          ("multi_tensor_apply", "optimizer"),
          ("conv", "conv"), ("fprop", "conv"), ("dgrad", "conv"),
          ("wgrad", "conv"), ("cudnn", "conv"))
GEMM_NAMES = ("gemm", "nvjet", "cutlass", "xmma", "sm90_")


def _group(name: str) -> str:
    low = name.lower()
    for key, group in GROUPS:
        if key in low:
            return group
    if any(g in low for g in GEMM_NAMES):
        return "gemm"
    return "other"


def _summary(window: dict, steps: int) -> dict:
    groups = {}
    for name, k in window["kernels"].items():
        acc = groups.setdefault(_group(name), [0.0, 0])
        acc[0] += k["device_ms"]
        acc[1] += k["count"]
    total = window["device_ms"]
    window["groups"] = {
        g: {"device_ms_per_step": ms / steps, "share": ms / total,
            "launches_per_step": n / steps}
        for g, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0])}
    window["launches_per_step"] = sum(
        k["count"] for k in window["kernels"].values()) / steps
    window["wall_ms_per_step"] = window["wall_ms"] / steps
    window["device_ms_per_step"] = total / steps
    return window


def _host_ops(prof, steps: int, top: int = 15) -> dict:
    ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return {e.key: {"self_host_ms_per_step": e.self_cpu_time_total / 1e3
                    / steps, "calls_per_step": e.count / steps}
            for e in ops[:top]}


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_tcn_train: CUDA is not available",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from profile_torch_ncf import _window
    from analytics_zoo_tpu_torch import (OrcaContext, init_orca_context,
                                         stop_orca_context)
    from analytics_zoo_tpu_torch.data import XShards, to_sharded_dataset
    from analytics_zoo_tpu_torch.data import shard as shard_lib
    from analytics_zoo_tpu_torch.learn import estimator
    from analytics_zoo_tpu_torch.zouwu.model import TCNForecaster

    OrcaContext.default_matmul_precision = "float32"
    init_orca_context()
    estimator.DEFAULT_LOG_DIR = os.path.join(os.path.dirname(ROOT),
                                             "build", "profile_tcn_logs")
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    out = {"card": cs.card_line(), "torch": torch.__version__,
           "batch": cs.TCN_BATCH, "steps": STEPS, "fit_steps": FIT_STEPS}

    x, y = cs.tcn_bench_data(np)
    for name, bench in (("window", False), ("window_cudnn_benchmark", True)):
        torch.backends.cudnn.benchmark = bench
        est = cs.tcn_estimator()
        xs, ys = est._tensors(x), est._tensors(y)
        for _ in range(3):
            est._train_step(xs, ys)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(cs.TCN_TIMED):
            est._train_step(xs, ys)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / cs.TCN_TIMED * 1e3
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(STEPS):
                est._train_step(xs, ys)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        out[name] = _summary(_window(prof, wall), STEPS)
        out[name]["host_ops"] = _host_ops(prof, STEPS)
        out[name]["step_ms_unprofiled"] = step_ms
    torch.backends.cudnn.benchmark = False

    sx, sy = cs.tcn_stream_data(np)
    rows = FIT_STEPS * cs.TCN_BATCH
    OrcaContext.train_data_store = cs.TCN_STREAM_TIER
    shards = XShards.partition({"x": sx[:rows], "y": sy[:rows]},
                               num_shards=cs.TCN_STREAM_SHARDS)
    f = TCNForecaster(**cs.TCN)
    f.fit(shards, epochs=1, batch_size=cs.TCN_BATCH)        # warm-up
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        f.fit(shards, epochs=1, batch_size=cs.TCN_BATCH)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out["fit"] = _summary(_window(prof, wall), FIT_STEPS)
    out["fit"]["host_ops"] = _host_ops(prof, FIT_STEPS)

    ds = to_sharded_dataset(shards)
    before = list(shard_lib.OP_TOTALS.get("stream_window", [0, 0.0]))
    t0 = time.perf_counter()
    n = sum(1 for _ in ds.iter_batches(cs.TCN_BATCH, shuffle=True, seed=0))
    feed_s = time.perf_counter() - t0
    after = shard_lib.OP_TOTALS["stream_window"]
    out["feed"] = dict(batches=n, ms_per_batch=feed_s * 1e3 / n,
                       windows=after[0] - before[0],
                       window_load_ms=(after[1] - before[1]) * 1e3,
                       peak_window_rows=ds.peak_window_rows)
    stop_orca_context()

    os.makedirs(os.path.join(os.path.dirname(ROOT), "chiprun_out"),
                exist_ok=True)
    with open(os.path.join(os.path.dirname(ROOT), "chiprun_out",
                           "profile_torch_tcn_train.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    brief = {k: v for k, v in out.items() if not isinstance(v, dict)}
    for name in ("window", "window_cudnn_benchmark", "fit"):
        brief[name] = {f: out[name][f] for f in (
            "wall_ms_per_step", "device_ms_per_step", "idle_share",
            "launches_per_step", "groups") if f in out[name]}
        brief[name]["step_ms_unprofiled"] = out[name].get(
            "step_ms_unprofiled")
    brief["feed"] = out["feed"]
    print(json.dumps(brief, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
