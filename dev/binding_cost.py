#!/usr/bin/env python3
"""The host cost of the two ways a Python wrapper can hand a C entry point
its arguments through ctypes, with everything else held fixed.

    python3 dev/binding_cost.py

Builds (nvcc, the port's flags) a library of four empty C functions with
the argument lists of the paged kernels' entry points and times, on the
host clock, calls that convert the same Python values:

- ``positional``: each argument converted by ctypes from ``argtypes``
  (pointers as ints or None, ints, a float), as ``ops/paged_attention.py``
  and ``ops/embedding_bag.py`` call their entry points: 14 arguments for
  the gather's list, 20 for the attention's;
- ``packed``: the same values packed by ``struct.pack_into`` into a
  buffer of the calling thread, then one pointer converted.

No kernel is launched and no device is touched, so the difference is the
binding's alone. Prints one JSON line and writes
``chiprun_out/binding_cost.json``.
"""

from __future__ import annotations

import ctypes
import json
import os
import struct
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "variants")
SRC = r"""
extern "C" {
int gather_positional(const void*, const void*, const void*, const void*,
                      void*, int, int, int, int, int, int, int, int, void*) {
  return 0;
}
int attention_positional(const void*, const void*, const void*, const void*,
                         const void*, const void*, const void*, void*, void*,
                         int, int, int, int, int, int, int, int, int, void*,
                         float) {
  return 0;
}
int gather_packed(const long long*) { return 0; }
int attention_packed(const long long*) { return 0; }
}
"""
CALLS = 200_000
REPEATS = 5


def per_call_us(fn) -> float:
    """The least, over REPEATS, of the mean host time of CALLS calls."""
    best = float("inf")
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        best = min(best, (time.perf_counter() - t0) / CALLS)
    return best * 1e6


def main() -> int:
    sys.path.insert(0, ROOT)
    from analytics_zoo_tpu_torch.ops import _build
    os.makedirs(OUT, exist_ok=True)
    cu = os.path.join(OUT, "binding_cost.cu")
    so = os.path.join(OUT, "libbinding_cost.so")
    with open(cu, "w") as fh:
        fh.write(SRC)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", so, cu],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(so)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.gather_positional.argtypes = [ptr] * 5 + [i32] * 8 + [ptr]
    lib.attention_positional.argtypes = [ptr] * 9 + [i32] * 9 + [
        ptr, ctypes.c_float]
    for fn in (lib.gather_packed, lib.attention_packed):
        fn.argtypes = [ctypes.POINTER(ctypes.c_char)]
    for fn in (lib.gather_positional, lib.attention_positional,
               lib.gather_packed, lib.attention_packed):
        fn.restype = i32
    gather_call = struct.Struct("@14q")
    attention_call = struct.Struct("@19qd")
    block = (ctypes.c_char * attention_call.size)()
    # addresses as a card's allocations give them, a null, shapes, a flag,
    # the device index and a stream handle
    a = 0x7F12_3400_0000
    g_args = (a, None, a + 512, a + 1024, a + 2048, 8, 5, 8, 8, 136, 40,
              False, 0, 0x5555_0000)
    at_args = (a, a + 4096, a + 8192, None, None, a + 512, a + 1024,
               a + 2048, None, 8, 5, 8, 8, 136, False, 1, 5, 0, 0x5555_0000,
               0.35355339059327373)

    # the packed form of the same values (as the wrapper would write them)
    g_packed = tuple(0 if v is None else int(v) for v in g_args)
    at_packed = tuple(0 if v is None else int(v) for v in at_args[:-1]) \
        + at_args[-1:]

    rec = {
        "calls": CALLS, "repeats": REPEATS,
        "gather_positional_us": per_call_us(
            lambda: lib.gather_positional(*g_args)),
        "gather_packed_us": per_call_us(lambda: (
            gather_call.pack_into(block, 0, *g_packed),
            lib.gather_packed(block))),
        "attention_positional_us": per_call_us(
            lambda: lib.attention_positional(*at_args)),
        "attention_packed_us": per_call_us(lambda: (
            attention_call.pack_into(block, 0, *at_packed),
            lib.attention_packed(block))),
        "empty_lambda_us": per_call_us(lambda: None),
    }
    print(json.dumps(rec), flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "binding_cost.json"),
              "w") as fh:
        json.dump(rec, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
