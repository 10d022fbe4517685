#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's decode path, on one GPU.

    python3 dev/profile_torch_decode.py

Builds chip_smoke.py's decode model (bench.py's Seq2Seq: 8 in, 8 out,
hidden 64, GRU, encoder 8, decoder 4; weights from the same numpy seed)
and traces with torch.profiler, after an untimed run of each:

1. greedy ``InferenceModel.generate`` of 8 rows x 32 steps (the host
   gathers the decoder input);
2. 4 streams of 32 steps drained through one ``DecodeScheduler`` with
   ``paged="force"`` (the paged gather kernel assembles the decoder input
   on the card from the page pool copied there each step).

For each window it reports the wall time, the device time of every CUDA
kernel and copy, the device's idle share (1 - device time / wall time),
the kernel launches per wide step (device kernels, copies excluded), the
paged gather's device time per launch, and the host's self time per step
by operator. A third window traces the two paged kernels alone, 20
launches each at chip_smoke.py's phase 3d slice and wide cases, for their
device time per launch. Writes chiprun_out/profile_torch_decode.json and
prints it.
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(ROOT))
sys.path.insert(0, ROOT)


def _host_ops(prof, steps: int, top: int = 15) -> dict:
    """The host's self time per wide step of the operators that take the
    most of it."""
    ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return {e.key: {"self_host_ms_per_step": e.self_cpu_time_total / 1e3
                    / steps, "calls_per_step": e.count / steps}
            for e in ops[:top]}


def _launches(window: dict) -> int:
    return sum(k["count"] for name, k in window["kernels"].items()
               if not name.startswith("Memcpy"))


def _kernel_window(torch, profile, activity, launches: int = 20) -> dict:
    """Device ms per launch of each paged kernel at phase 3d's slice and
    wide cases (fp32, distinct K and V pools), from the profiler."""
    import chip_smoke as cs
    from analytics_zoo_tpu_torch.inference.decode_scheduler import (
        default_pool_pages,
    )
    from analytics_zoo_tpu_torch.ops import paged_attention as pa
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(cs.SEED + 2)
    slice_pages = default_pool_pages(cs.DECODE_BATCH, cs.DECODE_STEPS,
                                     spec_k=0, page_size=cs.PAGE_SIZE)
    cases = {"slice": (slice_pages, cs.PAGE_SIZE, cs.DECODE["output_dim"],
                       cs.DECODE_BATCH,
                       -(-(cs.DECODE_STEPS + 1) // cs.PAGE_SIZE)),
             "wide": (32 * 256, 16, 128, 32, 256)}
    out = {}
    for name, shape in cases.items():
        # as phase 3d draws them: a K pool, the table and lengths, a V pool
        kp, ks, table, lengths = cs.paged_case(torch, gen, dev, torch.float32,
                                               *shape)
        vp, vs, _, _ = cs.paged_case(torch, gen, dev, torch.float32, *shape)
        q = torch.randn(shape[3], shape[2], generator=gen).to(dev)
        calls = {"paged_gather_kernel": lambda: pa.paged_gather(
                     kp, table, lengths, ks),
                 "paged_attention_kernel": lambda: pa.paged_attention(
                     q, kp, vp, table, lengths, k_scales=ks, v_scales=vs)}
        for fn in calls.values():
            fn()
        torch.cuda.synchronize()
        with profile(activities=[activity.CUDA]) as prof:
            for fn in calls.values():
                for _ in range(launches):
                    fn()
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            for kernel in calls:
                if kernel in ev.key:
                    dev_us = getattr(ev, "device_time_total", None)
                    if dev_us is None:
                        dev_us = ev.cuda_time_total
                    out[f"{kernel}_{name}_device_ms_per_launch"] = (
                        dev_us / 1e3 / ev.count)
    return out


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_decode: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke
    from profile_torch_ncf import _window
    from analytics_zoo_tpu_torch.common.compile_ahead import BucketLadder
    from analytics_zoo_tpu_torch.inference import (DecodeScheduler,
                                                   InferenceModel)
    from analytics_zoo_tpu_torch.models import Seq2Seq

    torch.backends.cuda.matmul.allow_tf32 = False
    b, steps = chip_smoke.DECODE_BATCH, chip_smoke.DECODE_STEPS
    m = Seq2Seq(**chip_smoke.DECODE)
    chip_smoke.seeded_weights(m.model.module, chip_smoke.SEED)
    rng = np.random.default_rng(7)
    enc = rng.standard_normal((b, 8, 8)).astype(np.float32)
    start = np.zeros((b, 8), np.float32)
    im = InferenceModel(device="cuda").load_zoo(m)
    im.set_ladder(BucketLadder(b, b))
    paged_fn = im.paged_decode_step_fn()

    def greedy():
        im.generate(enc, start, steps)
        return steps

    def paged():
        sched = DecodeScheduler(
            im.decode_step_fn(), max_batch=b, max_seq=steps, spec_k=0,
            batch_ladder=BucketLadder(b, b), paged_step_fn=paged_fn,
            paged="force")
        for i in range(chip_smoke.DECODE_STREAMS):
            sched.admit(enc[i], start[i], steps)
        sched.drain()
        return sched.steps_run

    out = {"card": chip_smoke.card_line(), "torch": torch.__version__,
           "batch": b, "steps": steps}
    for name, fn in (("greedy_generate", greedy), ("paged_streams", paged)):
        fn()                                   # build + first touch
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            n_steps = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        window = _window(prof, wall)
        window["wide_steps"] = n_steps
        window["wall_ms_per_step"] = window["wall_ms"] / n_steps
        window["device_ms_per_step"] = window["device_ms"] / n_steps
        window["launches_per_step"] = _launches(window) / n_steps
        gather = [k for n, k in window["kernels"].items()
                  if "paged_gather_kernel" in n]
        if gather:
            window["paged_gather_device_ms_per_launch"] = (
                sum(k["device_ms"] for k in gather)
                / sum(k["count"] for k in gather))
        window["host_ops"] = _host_ops(prof, n_steps)
        out[name] = window
        print(name, json.dumps({k: window[k] for k in (
            "wall_ms_per_step", "device_ms_per_step", "idle_share",
            "launches_per_step")}), flush=True)

    out["kernels"] = _kernel_window(torch, profile, ProfilerActivity)
    print("kernels", json.dumps(out["kernels"]), flush=True)

    os.makedirs(os.path.join(os.path.dirname(ROOT), "chiprun_out"),
                exist_ok=True)
    with open(os.path.join(os.path.dirname(ROOT), "chiprun_out",
                           "profile_torch_decode.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
