#!/usr/bin/env python3
"""Time design variants of the flash-attention forward kernel on one GPU.

    python3 dev/flash_fwd_variants.py

Each variant is ``ops/csrc/flash_attention.cu`` with one text substitution,
built by nvcc (the port's flags) into ``build/variants/`` and called
through the same C entry point; ``as_built`` is the source unchanged:

- ``bf16_4_warps``: the bf16 kernel at d <= 64 with 4 warps (64 query rows
  a CTA) instead of 8 (128 rows);
- ``exp2f``: p = exp2f(...) of the math library instead of the raw
  ``ex2.approx.ftz`` instruction (same values over the normal range).

For each variant and shape (b 32, h 12; s 512 and 128 at d 64 from a
packed projection, s 512 at d 128) it prints the CUDA-event mean of 50
back-to-back launches, twice, in turns, the largest |kernel - plain| and
the share of elements that differ from the plain version, with the
registers nvcc reports. Writes ``chiprun_out/flash_fwd_variants.json``.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from analytics_zoo_tpu_torch.ops import _build  # noqa: E402
from analytics_zoo_tpu_torch.ops import flash_attention as fa  # noqa: E402

SRC = os.path.join(ROOT, "analytics_zoo_tpu_torch", "ops", "csrc",
                   "flash_attention.cu")
OUT = os.path.join(ROOT, "build", "variants")
VARIANTS = {
    "as_built": [],
    "bf16_4_warps": [("launch_bf16<64, 8>", "launch_bf16<64, 4>")],
    "exp2f": [('  asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : '
               '"f"((x - m) * kLog2e));',
               "  y = exp2f((x - m) * kLog2e);")],
}
SHAPES = [(512, 64, True), (128, 64, True), (512, 128, False)]


def build() -> dict:
    src = open(SRC).read()
    os.makedirs(OUT, exist_ok=True)
    procs = []
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} is not in the source")
            text = text.replace(old, new)
        cu = os.path.join(OUT, f"{name}.cu")
        with open(cu, "w") as fh:
            fh.write(text)
        so = os.path.join(OUT, f"lib{name}.so")
        procs.append((name, so, subprocess.Popen(
            [_build.nvcc_path(), *_build.nvcc_flags("flash_attention"),
             "-o", so, cu], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    libs, regs = {}, {}
    for name, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        regs[name] = [ln.strip() for ln in log.splitlines()
                      if "registers" in ln]
        libs[name] = fa._bind(ctypes.CDLL(so))
    return libs, regs


def launch(lib, q, k, v, out, lse):
    b, sq, h, d = q.shape
    err = lib.zoo_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, h, sq, k.shape[1], d, *q.stride()[:3],
        *k.stride()[:3], *v.stride()[:3], 0, float(1.0 / d ** 0.5),
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"launch failed: {err}")


def event_ms(fn, iters: int = 50) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_fwd_variants: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    libs, regs = build()
    print(json.dumps({"registers": regs}), flush=True)
    gen = torch.Generator().manual_seed(0)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for sq, d, packed in SHAPES:
            if packed:
                q, k, v = torch.randn(32, sq, 3, 12, d, generator=gen).to(
                    "cuda", dtype).unbind(2)
            else:
                q, k, v = (torch.randn(32, sq, 12, d, generator=gen).to(
                    "cuda", dtype) for _ in range(3))
            want = fa._flash_fwd_ref(q, k, v)
            out = torch.empty((32, sq, 12, d), dtype=dtype, device="cuda")
            lse = torch.empty((32 * 12, sq), device="cuda")
            row = dict(dtype=str(dtype), sq=sq, d=d, ms={}, err={},
                       share={})
            for _ in range(2):   # in turns: as built, variants, again
                for name, lib in libs.items():
                    launch(lib, q, k, v, out, lse)
                    torch.cuda.synchronize()
                    row["err"][name] = float(
                        (out.float() - want.float()).abs().max())
                    row["share"][name] = float((out != want).float().mean())
                    row["ms"].setdefault(name, []).append(event_ms(
                        lambda: launch(lib, q, k, v, out, lse)))
            rows.append(row)
            print(json.dumps(row), flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "flash_fwd_variants.json"),
              "w") as fh:
        json.dump(dict(card=card, registers=regs, rows=rows), fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
