#!/usr/bin/env python3
"""Time the flash-attention backward kernels (dq, dk/dv) side by side on
one GPU: an older checkout's, this one's, and design variants of this one.

    python3 dev/flash_bwd_variants.py [--parent TREE] [--train]

Each variant is ``ops/csrc/flash_attention_bwd.cu`` with text
substitutions, built by nvcc (the port's flags) into ``build/variants/``
and called through the same C entry points; ``as_built`` is the source
unchanged, ``parent`` the same file of TREE (an older commit unpacked with
``git archive`` into a directory that .gitignore lists, e.g.
``build/parent``):

- ``bf16_chunk_64``: the bf16 kernels at d <= 64 in chunks of 64 streamed
  columns instead of 32 (more registers, fewer passes over the
  fragments);
- ``bf16_8_warps``, ``bf16_2_warps``: the bf16 kernels at d <= 64 with 8
  or 2 warps (128 or 32 resident rows a CTA) instead of 4 (64);
- ``bf16_dkv_uncapped``: the bf16 dk/dv kernel at d <= 64 without the
  cap of ``__launch_bounds__(128, 3)`` on its registers (168, for 3 CTAs
  an SM);
- ``bf16_d128_chunk_16``: the bf16 kernels at d <= 128 in chunks of 16
  streamed columns instead of 32 (fewer registers);
- ``expf``: p = expf(s - lse) of the math library instead of
  ``ex2.approx.ftz`` of (s - lse) * log2(e);
- ``f32_rows_2``: the fp32 kernels at d <= 64 with 2 resident rows a
  thread (32 a CTA) instead of 4 (64).

For each dtype and shape (b 32, h 12, from a packed projection with a
strided dO: the fine-tuning shape s 128 and s 512 at d 64; s 512 at d 128)
it times each library's dq and dk/dv launches replayed from a CUDA graph
(20 launches a graph, device time without the host's), twice, in turns,
with the reading against the plain version (fp32: the largest error over
2e-5 of the largest gradient; bf16: ``chip_smoke.bwd_reading``), the
registers nvcc reports, the bound (``chip_smoke.attention_bwd_bound``) and
the whole backward of ``scaled_dot_product_attention`` as the yardstick.

``--train`` also times BERT-Base fine-tuning steps of TREE and of this
checkout in turns (TREE, this, this, TREE, TRAIN_ROUNDS times), each in a
fresh process that
imports that tree's package and chip_smoke.py and builds its kernels
into the tree's own build/kernels/: chip_smoke.py's classifier and inputs,
``Estimator.from_torch(..., optimizer="adam").fit``, one warm-up step and
TRAIN_STEPS timed steps on the host clock, fp32 (TF32 off) and bf16.

Writes ``chiprun_out/flash_bwd_variants.json``.
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "analytics_zoo_tpu_torch", "ops", "csrc",
                   "flash_attention_bwd.cu")
OUT = os.path.join(ROOT, "build", "variants")
EX2 = ('  asm("ex2.approx.ftz.f32 %0, %1;\\n"\n'
       '      : "=f"(e)\n'
       '      : "f"((__fmul_rn(s, sm_scale) - lse) * kLog2e));\n')
VARIANTS = {
    "as_built": [],
    "bf16_chunk_64": [("launch_dq_bf16<64, 4, 32>",
                       "launch_dq_bf16<64, 4, 64>"),
                      ("launch_dkv_bf16<64, 4, 32, 3>",
                       "launch_dkv_bf16<64, 4, 64, 1>")],
    "bf16_8_warps": [("launch_dq_bf16<64, 4, 32>",
                      "launch_dq_bf16<64, 8, 32>"),
                     ("launch_dkv_bf16<64, 4, 32, 3>",
                      "launch_dkv_bf16<64, 8, 32, 1>")],
    "bf16_2_warps": [("launch_dq_bf16<64, 4, 32>",
                      "launch_dq_bf16<64, 2, 32>"),
                     ("launch_dkv_bf16<64, 4, 32, 3>",
                      "launch_dkv_bf16<64, 2, 32, 1>")],
    "bf16_dkv_uncapped": [("launch_dkv_bf16<64, 4, 32, 3>",
                           "launch_dkv_bf16<64, 4, 32, 1>")],
    "bf16_d128_chunk_16": [("launch_dq_bf16<128, 4, 32>",
                            "launch_dq_bf16<128, 4, 16>"),
                           ("launch_dkv_bf16<128, 4, 32, 1>",
                            "launch_dkv_bf16<128, 4, 16, 1>")],
    "expf": [(EX2, "  e = expf(__fmul_rn(s, sm_scale) - lse);\n")],
    "f32_rows_2": [("launch_dq_f32<64, 4>", "launch_dq_f32<64, 2>"),
                   ("launch_dkv_f32<64, 4>", "launch_dkv_f32<64, 2>")],
}
# (sq, d) at b 32, h 12
SHAPES = [(128, 64), (512, 64), (512, 128)]
TRAIN_STEPS = 20
TRAIN_ROUNDS = 3


def build(parent):
    """Compile every variant (and the parent's source) in parallel:
    {name: bound library}, {name: nvcc's register lines}."""
    import torch  # noqa: F401  (loads the CUDA runtime first)
    from analytics_zoo_tpu_torch.ops import _build
    from analytics_zoo_tpu_torch.ops import flash_attention as fa

    src = open(SRC).read()
    os.makedirs(OUT, exist_ok=True)
    sources = {}
    if parent:
        sources["parent"] = open(os.path.join(
            parent, "analytics_zoo_tpu_torch", "ops", "csrc",
            "flash_attention_bwd.cu")).read()
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} is not in the source")
            text = text.replace(old, new)
        sources[name] = text
    procs = []
    for name, text in sources.items():
        cu = os.path.join(OUT, f"bwd_{name}.cu")
        with open(cu, "w") as fh:
            fh.write(text)
        so = os.path.join(OUT, f"libbwd_{name}.so")
        procs.append((name, so, subprocess.Popen(
            [_build.nvcc_path(), *_build.nvcc_flags("flash_attention_bwd"),
             "-o", so, cu], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    libs, regs = {}, {}
    for name, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        regs[name] = [ln.strip() for ln in log.splitlines()
                      if "registers" in ln or "spill" in ln]
        libs[name] = fa._bind_bwd(ctypes.CDLL(so))
    return libs, regs


def call(lib, name, args, outs):
    """One launch of entry point ``name`` on the current stream."""
    import numpy as np
    import torch
    q, k, v, do, lse, delta, causal, glse = args
    b, sq, h, d = q.shape
    err = getattr(lib, name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(),
        None if glse is None else glse.data_ptr(),
        *(t.data_ptr() for t in outs), b, h, sq, k.shape[1], d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
        int(causal), float(np.float32(1.0 / math.sqrt(d))),
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           + lib.zoo_flash_bwd_error_string(err).decode())


def graph_ms(fn, per_graph: int = 20, replays: int = 10) -> float:
    """Device ms of one ``fn``: ``per_graph`` calls captured in a CUDA
    graph, replayed ``replays`` times back to back."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * per_graph)


def kernels(parent):
    import torch
    import chip_smoke as cs
    from analytics_zoo_tpu_torch.ops import flash_attention as fa

    libs, regs = build(parent)
    print(json.dumps({"registers": regs}), flush=True)
    gen = torch.Generator().manual_seed(cs.SEED)
    b, h = cs.TRAIN_BATCH, 12
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for sq, d in SHAPES:
            randn = lambda *shape: torch.randn(*shape, generator=gen).to(
                "cuda", dtype)
            q, k, v = randn(b, sq, 3, h, d).unbind(2)
            do = randn(b, h, sq, d).transpose(1, 2)
            o, lse = fa.flash_attention_with_lse(q, k, v)
            args = (q, k, v, do, lse, fa._row_delta(o, do), False, None)
            want = (fa._flash_bwd_dq_ref(*args),
                    *fa._flash_bwd_dkv_ref(*args))
            flips = cs.bwd_flip_scale(fa, *args) \
                if dtype == torch.bfloat16 else (None,) * 3
            dq = torch.empty_like(want[0])
            dk, dv = torch.empty_like(want[1]), torch.empty_like(want[2])
            row = dict(dtype=str(dtype), sq=sq, d=d, ms={}, reading={})
            for kern in ("dq", "dkv"):
                row[f"{kern}_bound_ms"] = cs.attention_bwd_bound(
                    kern, b, sq, sq, h, d, False, dtype, False)[0]
            row["sdpa_bwd_ms"] = cs.sdpa_bwd_ms(q, k, v, do, False)
            for _ in range(2):   # in turns: every library, then again
                for name, lib in libs.items():
                    call(lib, "zoo_flash_bwd_dq", args, [dq])
                    call(lib, "zoo_flash_bwd_dkv", args, [dk, dv])
                    torch.cuda.synchronize()
                    row["reading"][name] = {
                        g: cs.bwd_reading(a, w, dtype, f)
                        for g, a, w, f in zip(("dq", "dk", "dv"),
                                              (dq, dk, dv), want, flips)}
                    ms = row["ms"].setdefault(name, {"dq": [], "dkv": []})
                    ms["dq"].append(graph_ms(
                        lambda: call(lib, "zoo_flash_bwd_dq", args, [dq])))
                    ms["dkv"].append(graph_ms(
                        lambda: call(lib, "zoo_flash_bwd_dkv", args,
                                     [dk, dv])))
            rows.append(row)
            print(json.dumps(row), flush=True)
            del q, k, v, do, o, lse, args, want, flips, dq, dk, dv
    return dict(registers=regs, rows=rows)


def train_child(tree: str) -> dict:
    """BERT-Base fine-tuning step times of the checkout at ``tree``."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import chip_smoke as cs
    from analytics_zoo_tpu_torch.learn import Estimator

    if os.path.dirname(os.path.abspath(cs.__file__)) != tree:
        raise RuntimeError(f"chip_smoke imported from {cs.__file__}")
    torch.backends.cuda.matmul.allow_tf32 = False
    b = cs.TRAIN_BATCH
    ids, labels = cs.train_inputs(np.random.RandomState(cs.SEED + 1),
                                  b * (1 + TRAIN_STEPS))
    state = cs.bert_classifier(None, use_flash=True).state_dict()
    out = {"tree": os.path.relpath(tree, ROOT), "card": cs.card_line(),
           "steps": TRAIN_STEPS}
    for label, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
        est = Estimator.from_torch(
            model=cs.bert_classifier(state, use_flash=True, dtype=dtype),
            loss="sparse_categorical_crossentropy_logits", optimizer="adam",
            seed=cs.SEED)
        est.fit((ids[:b], labels[:b]), epochs=1, batch_size=b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # the fit ends by reading the step losses back: a sync
        est.fit((ids[b:], labels[b:]), epochs=1, batch_size=b,
                shuffle=False)
        out[f"{label}_ms_per_step"] = (time.perf_counter() - t0) * 1e3 \
            / TRAIN_STEPS
        out[f"{label}_losses"] = est.step_losses[-TRAIN_STEPS:]
        del est
        torch.cuda.empty_cache()
    return out


def train(parent):
    runs = []
    for tree in (parent, ROOT, ROOT, parent) * TRAIN_ROUNDS:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--train-child",
             tree], capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(proc.stdout + proc.stderr)
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps({k: v for k, v in runs[-1].items()
                          if not k.endswith("losses")}), flush=True)
    return runs


def main() -> int:
    if sys.argv[1:2] == ["--train-child"]:
        print(json.dumps(train_child(sys.argv[2])), flush=True)
        return 0
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("flash_bwd_variants: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    parent = sys.argv[sys.argv.index("--parent") + 1] \
        if "--parent" in sys.argv else None
    parent = os.path.abspath(parent) if parent else None
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"card": cs.card_line(), "torch": torch.__version__,
           "parent": parent and os.path.relpath(parent, ROOT)}
    print(out["card"], flush=True)
    out.update(kernels(parent))
    if "--train" in sys.argv:
        if not parent:
            raise SystemExit("--train needs --parent TREE")
        out["train"] = train(parent)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "flash_bwd_variants.json"),
              "w") as fh:
        json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
