#!/usr/bin/env python3
"""Which shapes and layouts ``torch._int_mm`` takes on this card, and the
names of its kernels: the basis of inference/quantize.py's ``int_mm``
padding (more than 16 rows, k and n multiples of 8).

    python3 dev/int_mm_probe.py

Prints one line a case (accepted, or the error's first line), the int8
product's kernel names from the profiler, and the card's name and power
limit; writes chiprun_out/int_mm_probe.json.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch

    import chip_smoke as cs
    from analytics_zoo_tpu_torch.inference import quantize as qlib
    if not torch.cuda.is_available():
        print("int_mm_probe: CUDA is not available", file=sys.stderr)
        return 2
    card = cs.card_line()
    cs.log(card)
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(0)
    cases = {}
    for m, k, n, layout in ((32, 768, 3072, "b_transposed"),
                            (32, 768, 3072, "b_contiguous"),
                            (16, 64, 64, "b_transposed"),
                            (17, 64, 64, "b_transposed"),
                            (24, 60, 64, "b_transposed"),
                            (24, 64, 60, "b_transposed"),
                            (4096, 40, 5, "b_transposed")):
        a = torch.randint(-127, 128, (m, k), generator=gen,
                          dtype=torch.int8).to(dev)
        w = torch.randint(-127, 128, (n, k), generator=gen,
                          dtype=torch.int8).to(dev)
        b = w.t() if layout == "b_transposed" else w.t().contiguous()
        key = f"{m}x{k}x{n} {layout}"
        try:
            got = torch._int_mm(a, b)
            want = a.cpu().int() @ b.cpu().int()
            cases[key] = dict(ok=True, exact=bool(torch.equal(got.cpu(),
                                                              want)))
        except RuntimeError as e:
            cases[key] = dict(ok=False, error=str(e).splitlines()[0])
        try:
            padded = qlib.int_mm(a, b)
            cases[key]["padded_exact"] = bool(torch.equal(
                padded.cpu(), a.cpu().int() @ b.cpu().int()))
        except RuntimeError as e:
            cases[key]["padded_error"] = str(e).splitlines()[0]
        cs.log(f"{key}: {cases[key]}")
    a = torch.randint(-127, 128, (32 * 512, 768), generator=gen,
                      dtype=torch.int8).to(dev)
    w = torch.randint(-127, 128, (3072, 768), generator=gen,
                      dtype=torch.int8).to(dev)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        qlib.int_mm(a, w.t())
        torch.cuda.synchronize()
    names = sorted({e.name for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA})
    cs.log(f"int8 product kernels: {names}")
    bad = [k for k, c in cases.items() if not c.get("padded_exact")]
    if bad:
        cs.log(f"int_mm refused or differed at: {bad}")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "int_mm_probe.json"),
              "w") as fh:
        json.dump(dict(card=card, cases=cases, kernel_names=names), fh,
                  indent=1)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
