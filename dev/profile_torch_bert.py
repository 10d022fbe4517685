#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's BERT serving path, on one GPU.

    python3 dev/profile_torch_bert.py

Builds the BERT-Base, Uncased classifier of chip_smoke.py (2 classes,
use_flash=True, weights from the same numpy seed, TF32 off) and traces
``InferenceModel.predict`` of 32 x 512 tokens with torch.profiler, three
calls in fp32 and three in bf16. For each window it reports the wall
time, the summed device time of every CUDA kernel and copy, the device's
idle share, the device time of each kernel by name, and the shares of
device time taken by the flash-attention kernel, the GEMMs and the rest.
Writes chiprun_out/profile_torch_bert.json and prints it.
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(ROOT))
sys.path.insert(0, ROOT)

CALLS = 3
#: substrings of the cuBLAS / CUTLASS GEMM kernels' names
GEMM_NAMES = ("gemm", "nvjet", "cutlass", "xmma", "sm90_")


def _shares(window: dict) -> dict:
    groups = {"flash": 0.0, "gemm": 0.0, "other": 0.0}
    for name, k in window["kernels"].items():
        low = name.lower()
        if "flash_fwd_bf16_kernel" in low or "flash_fwd_f32_kernel" in low:
            groups["flash"] += k["device_ms"]
        elif any(g in low for g in GEMM_NAMES):
            groups["gemm"] += k["device_ms"]
        else:
            groups["other"] += k["device_ms"]
    total = window["device_ms"]
    return {g: {"device_ms_per_call": ms / CALLS, "share": ms / total}
            for g, ms in groups.items()}


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_bert: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke
    from profile_torch_ncf import _window
    from analytics_zoo_tpu_torch.inference import InferenceModel

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"card": chip_smoke.card_line(), "torch": torch.__version__,
           "batch": chip_smoke.BERT_BATCH, "seq": chip_smoke.BERT_LEN,
           "calls": CALLS}
    x = chip_smoke.bert_inputs(np.random.RandomState(chip_smoke.SEED),
                               chip_smoke.BERT_BATCH)
    state = chip_smoke.bert_classifier(None, use_flash=True).state_dict()
    for name, extra in (("fp32", {}), ("bf16", {"dtype": torch.bfloat16})):
        im = InferenceModel(device="cuda").load_torch(
            chip_smoke.bert_classifier(state, use_flash=True, **extra),
            tuple(a[:2] for a in x))
        for _ in range(2):                     # build + warm up
            im.predict(x, batch_size=chip_smoke.BERT_BATCH)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(CALLS):
                im.predict(x, batch_size=chip_smoke.BERT_BATCH)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        window = _window(prof, wall)
        window["groups"] = _shares(window)
        out[f"predict_{name}"] = window
        del im
        torch.cuda.empty_cache()

    os.makedirs(os.path.join(os.path.dirname(ROOT), "chiprun_out"),
                exist_ok=True)
    with open(os.path.join(os.path.dirname(ROOT), "chiprun_out",
                           "profile_torch_bert.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
