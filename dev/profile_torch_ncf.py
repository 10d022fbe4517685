#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's NCF serving path, on one GPU.

    python3 dev/profile_torch_ncf.py

Builds NeuralCF at MovieLens-1M width (the model of chip_smoke.py, weights
from the same numpy seed) and traces with torch.profiler:

1. ``InferenceModel.predict`` of 8000 rows, 20 calls;
2. a burst of 512 records through the Python broker and ClusterServing
   (batch 256).

For each window it reports the wall time, the summed device time of every
CUDA kernel and memory copy, the device's idle share (1 - device time /
wall time), and the device time of each kernel by name. The fused lookup
kernel's device time per launch is the number to hold against its bound;
chip_smoke.py's CUDA-event time of back-to-back launches also counts the
host's launch cost. Writes chiprun_out/profile_torch_ncf.json and prints
it.
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _window(prof, wall_s: float) -> dict:
    from torch.autograd import DeviceType
    kernels = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = ev.cuda_time_total
        if ev.device_type == DeviceType.CUDA and dev_us > 0:
            kernels[ev.key] = {"device_ms": dev_us / 1e3,
                               "count": ev.count}
    device_ms = sum(k["device_ms"] for k in kernels.values())
    return {"wall_ms": wall_s * 1e3, "device_ms": device_ms,
            "idle_share": 1.0 - device_ms / (wall_s * 1e3),
            "kernels": dict(sorted(kernels.items(),
                                   key=lambda kv: -kv[1]["device_ms"]))}


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_ncf: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.models import NeuralCF
    from analytics_zoo_tpu_torch.serving import (Broker, ClusterServing,
                                                 InputQueue, OutputQueue)

    out = {"card": chip_smoke.card_line(),
           "torch": torch.__version__}
    ncf = NeuralCF(**chip_smoke.NCF)
    chip_smoke.seeded_weights(ncf.model.module, chip_smoke.SEED)
    rng = np.random.RandomState(chip_smoke.SEED)
    n = chip_smoke.BATCH
    x = np.stack([rng.randint(1, chip_smoke.NCF["user_count"] + 1, n),
                  rng.randint(1, chip_smoke.NCF["item_count"] + 1, n)],
                 1).astype(np.float32)
    im = InferenceModel(device="cuda").load_zoo(ncf)
    for _ in range(5):                      # build + warm up
        im.predict(x, batch_size=n)
    torch.cuda.synchronize()

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(20):
            im.predict(x, batch_size=n)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out["predict_8000x20"] = _window(prof, wall)

    with Broker.launch(backend="python") as broker, \
            ClusterServing(im, broker.port,
                           batch_size=chip_smoke.SERVE_BATCH,
                           max_batch_size=chip_smoke.SERVE_BATCH,
                           warmup=False):
        iq = InputQueue(port=broker.port)
        oq = OutputQueue(port=broker.port)
        warm = iq.enqueue_batch((f"w{i}", {"x": x[i]}) for i in range(256))
        oq.query_many(warm, timeout=60)
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            uris = iq.enqueue_batch((f"b{i}", {"x": x[i]})
                                    for i in range(chip_smoke.N_BURST))
            got = oq.query_many(uris, timeout=120, poll_interval=0.002)
            wall = time.perf_counter() - t0
        iq.close()
        oq.close()
    if any(v is None for v in got.values()):
        raise AssertionError("serving burst lost records")
    out["serving_burst_512"] = _window(prof, wall)

    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "profile_torch_ncf.json"),
              "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
