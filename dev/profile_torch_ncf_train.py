#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's NCF training step, on one GPU.

    python3 dev/profile_torch_ncf_train.py [--loop K | --cache]

Builds the two training configurations of chip_smoke.py at full width
(NeuralCF at MovieLens-1M width, and the same with the pooled item-history
column; weights from the same numpy seed), compiles each with
``Adam(1e-3)`` and ``sparse_categorical_crossentropy`` on ``cuda``, and
traces ``fit`` over 5 steps of 8000 of bench.py's rows with
torch.profiler, after two warm-up steps. For each window it reports the
wall time, the summed device time of every CUDA kernel and copy, the
device's idle share, the launches per step, the device time of each kernel
by name and per group (GEMMs, the lookup, the bag, the scatter, the
sort, the optimizer's multi-tensor kernels, the rest: elementwise ops,
reductions, copies), the host-to-device copies per step, and the
operators that take the most host time.

``--loop K`` traces ``fit(steps_per_loop=K)`` over K steps (one stacked
copy, then K steps) and ``--cache`` traces ``fit(cache="device")`` over
5 steps of a dataset already on the card (the warm-up fit of the same
dataset object copied it), so a staged or cached step splits into the
same launches, copies and host ms. Both call ``TorchEstimator.fit`` on
the compiled model's estimator with one dataset object.
Writes chiprun_out/profile_torch_ncf_train[_loopK|_cache].json and prints
it.
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
#: substrings of the cuBLAS / CUTLASS GEMM kernels' names
GEMM_NAMES = ("gemm", "nvjet", "cutlass", "xmma", "sm90_")
#: kernel-name substring -> group, checked in this order
GROUPS = (("fused_concat_kernel", "lookup"),
          ("fused_combine_kernel", "lookup"),
          ("bag_kernel", "bag"),
          ("scatter_chunk_kernel", "scatter"),
          ("scatter_runs_kernel", "scatter"),
          ("sort", "sort"),
          ("multi_tensor_apply", "optimizer"))


def _group(name: str) -> str:
    low = name.lower()
    for key, group in GROUPS:
        if key in low:
            return group
    if any(g in low for g in GEMM_NAMES):
        return "gemm"
    return "other"


def _groups(window: dict) -> dict:
    groups = {g: [0.0, 0] for _, g in GROUPS}
    groups.update(gemm=[0.0, 0], other=[0.0, 0])
    for name, k in window["kernels"].items():
        acc = groups[_group(name)]
        acc[0] += k["device_ms"]
        acc[1] += k["count"]
    total = window["device_ms"]
    return {g: {"device_ms_per_step": ms / STEPS, "share": ms / total,
                "launches_per_step": n / STEPS}
            for g, (ms, n) in groups.items()}


def _host_ops(prof, top: int = 20) -> dict:
    """The host's self time per step of the operators that take the most
    of it."""
    ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return {e.key: {"self_host_ms_per_step": e.self_cpu_time_total / 1e3
                    / STEPS, "calls_per_step": e.count / STEPS}
            for e in ops[:top]}


def main() -> int:
    import argparse

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    parser = argparse.ArgumentParser()
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--loop", type=int, default=1,
                      help="fit(steps_per_loop=K), traced over K steps")
    mode.add_argument("--cache", action="store_true",
                      help='fit(cache="device") of a dataset on the card')
    args = parser.parse_args()

    if not torch.cuda.is_available():
        print("profile_torch_ncf_train: CUDA is not available",
              file=sys.stderr)
        return 2
    import chip_smoke
    from profile_torch_ncf import _window
    from analytics_zoo_tpu_torch.data import ShardedDataset
    from analytics_zoo_tpu_torch.learn.optimizers import Adam

    global STEPS
    fit_args, suffix = {}, ""
    if args.loop > 1:
        STEPS, suffix = args.loop, f"_loop{args.loop}"
        fit_args = {"steps_per_loop": args.loop}
    elif args.cache:
        suffix, fit_args = "_cache", {"cache": "device"}
    torch.backends.cuda.matmul.allow_tf32 = False
    b = chip_smoke.BATCH
    out = {"card": chip_smoke.card_line(), "torch": torch.__version__,
           "batch": b, "steps": STEPS, "fit_args": fit_args}
    x, y, hist = chip_smoke.ncf_train_data(np)
    for config in ("ncf", "hist"):
        net = chip_smoke.train_model(config)
        net.compile(optimizer=Adam(chip_smoke.NCF_LR),
                    loss="sparse_categorical_crossentropy")
        net.fit(chip_smoke.train_inputs_of(config, x, hist, 0, 2 * b),
                y[:2 * b], batch_size=b, nb_epoch=1)
        xs = chip_smoke.train_inputs_of(config, x, hist, 2 * b,
                                        (2 + STEPS) * b)
        data = ShardedDataset(tuple(xs) if isinstance(xs, list) else xs,
                              y[2 * b:(2 + STEPS) * b])
        if fit_args:
            # the mode's own warm-up: its loop shape, or the device copy
            net.estimator.fit(data, batch_size=b, shuffle=False,
                              **fit_args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            # the fit ends by reading the step losses back: a sync
            net.estimator.fit(data, batch_size=b, shuffle=False,
                              **fit_args)
            wall = time.perf_counter() - t0
        window = _window(prof, wall)
        window["groups"] = _groups(window)
        window["launches_per_step"] = sum(
            k["count"] for name, k in window["kernels"].items()
            if "Memcpy" not in name and "Memset" not in name) / STEPS
        window["h2d_copies_per_step"] = sum(
            k["count"] for name, k in window["kernels"].items()
            if "HtoD" in name) / STEPS
        window["host_ops"] = _host_ops(prof)
        window["wall_ms_per_step"] = wall * 1e3 / STEPS
        window["device_ms_per_step"] = window["device_ms"] / STEPS
        out[f"fit_{config}"] = window
        print(config, json.dumps(window["groups"]), flush=True)
        del net
        torch.cuda.empty_cache()

    os.makedirs(os.path.join(os.path.dirname(ROOT), "chiprun_out"),
                exist_ok=True)
    with open(os.path.join(os.path.dirname(ROOT), "chiprun_out",
                           f"profile_torch_ncf_train{suffix}.json"),
              "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps({k: v for k, v in out.items()
                      if not isinstance(v, dict)}
                     | {k: {f: v[f] for f in (
                         "wall_ms_per_step", "device_ms_per_step",
                         "idle_share", "launches_per_step",
                         "h2d_copies_per_step", "groups", "host_ops")}
                        for k, v in out.items() if k.startswith("fit_")
                        and isinstance(v, dict) and "groups" in v},
                     indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
