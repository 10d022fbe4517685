#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's BERT fine-tuning step, on one
GPU.

    python3 dev/profile_torch_bert_train.py [--remat]

Builds the BERT-Base, Uncased classifier of chip_smoke.py (2 classes,
use_flash=True, dropout 0.1, weights from the same numpy seed, TF32 off)
and traces ``Estimator.from_torch(..., optimizer="adam").fit`` over 3
steps of 32 x 128 tokens with torch.profiler, after two warm-up steps, in
fp32 and in bf16. For each window it reports the wall time, the summed
device time of every CUDA kernel and copy, the device's idle share, the
device time of each kernel by name, and the shares of device time taken
by the GEMMs, the flash forward, dq and dk/dv kernels, the optimizer's
multi-tensor kernels and the rest (elementwise ops, norms, copies), and
the operators that take the most host time, and the peak memory of each
window. ``--remat`` builds the classifier with ``BertConfig(remat=True)``
(every block recomputed in the backward pass; the flash forward launches
twice a block) and writes chiprun_out/profile_torch_bert_train_remat.json;
without it, chiprun_out/profile_torch_bert_train.json. Prints it.
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(ROOT))
sys.path.insert(0, ROOT)

STEPS = 3
#: substrings of the cuBLAS / CUTLASS GEMM kernels' names
GEMM_NAMES = ("gemm", "nvjet", "cutlass", "xmma", "sm90_")
#: kernel-name substring -> group, checked in this order
GROUPS = (("flash_fwd_bf16_kernel", "flash_fwd"),
          ("flash_fwd_f32_kernel", "flash_fwd"),
          ("flash_bwd_dq", "flash_bwd_dq"),
          ("flash_bwd_dkv", "flash_bwd_dkv"),
          ("multi_tensor_apply", "optimizer"))


def _group(name: str) -> str:
    low = name.lower()
    for key, group in GROUPS:
        if key in low:
            return group
    if any(g in low for g in GEMM_NAMES):
        return "gemm"
    return "other"


def _shares(window: dict) -> dict:
    groups = {g: 0.0 for _, g in GROUPS}
    groups.update(gemm=0.0, other=0.0)
    for name, k in window["kernels"].items():
        groups[_group(name)] += k["device_ms"]
    total = window["device_ms"]
    return {g: {"device_ms_per_step": ms / STEPS, "share": ms / total}
            for g, ms in groups.items()}


def _host_ops(prof, top: int = 20) -> dict:
    """The host's self time per step of the operators that take the most
    of it (launches, the autograd engine, Python-side ops)."""
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
    parser.add_argument("--remat", action="store_true",
                        help="BertConfig(remat=True)")
    args = parser.parse_args()

    if not torch.cuda.is_available():
        print("profile_torch_bert_train: CUDA is not available",
              file=sys.stderr)
        return 2
    import chip_smoke
    from profile_torch_ncf import _window
    from analytics_zoo_tpu_torch.learn import Estimator

    torch.backends.cuda.matmul.allow_tf32 = False
    b = chip_smoke.TRAIN_BATCH
    out = {"card": chip_smoke.card_line(), "torch": torch.__version__,
           "batch": b, "seq": chip_smoke.TRAIN_LEN, "steps": STEPS,
           "remat": args.remat}
    ids, labels = chip_smoke.train_inputs(
        np.random.RandomState(chip_smoke.SEED), b * STEPS)
    state = chip_smoke.bert_classifier(None, use_flash=True).state_dict()
    for name, extra in (("fp32", {}), ("bf16", {"dtype": torch.bfloat16})):
        est = Estimator.from_torch(
            model=chip_smoke.bert_classifier(state, use_flash=True,
                                             remat=args.remat, **extra),
            loss="sparse_categorical_crossentropy_logits", optimizer="adam",
            seed=chip_smoke.SEED)
        est.fit((ids[:2 * b], labels[:2 * b]), epochs=1, batch_size=b)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            # the fit ends by reading the step losses back: a sync
            est.fit((ids, labels), epochs=1, batch_size=b, shuffle=False)
            wall = time.perf_counter() - t0
        window = _window(prof, wall)
        window["groups"] = _shares(window)
        window["host_ops"] = _host_ops(prof)
        window["wall_ms_per_step"] = wall * 1e3 / STEPS
        window["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out[f"fit_{name}"] = window
        print(name, json.dumps(window["groups"]), flush=True)
        del est
        torch.cuda.empty_cache()

    os.makedirs(os.path.join(os.path.dirname(ROOT), "chiprun_out"),
                exist_ok=True)
    suffix = "_remat" if args.remat else ""
    with open(os.path.join(os.path.dirname(ROOT), "chiprun_out",
                           f"profile_torch_bert_train{suffix}.json"),
              "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps({k: v for k, v in out.items()
                      if not isinstance(v, dict)}
                     | {k: {f: v[f] for f in ("wall_ms", "device_ms",
                                              "idle_share", "groups",
                                              "peak_memory_gb", "host_ops")}
                        for k, v in out.items() if isinstance(v, dict)},
                     indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
