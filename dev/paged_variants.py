#!/usr/bin/env python3
"""Time the paged decode kernels (the gather B6 and the decode attention
B7) of an older checkout and of this one side by side on one GPU, and
design variants of this one's attention.

    python3 dev/paged_variants.py [--parent TREE] [--rounds N]

TREE is an older commit unpacked with ``git archive`` into a directory
that .gitignore lists (e.g. ``build/parent``). The trees run in turns,
TREE, this, this, TREE, N times (default 2), each in a fresh process that
imports that tree's package and chip_smoke.py and builds its kernels
into the tree's own build/kernels/. A process times, on the same inputs
(chip_smoke.py's ``paged_case`` from one torch seed, tables and lengths
on the card):

- the gather at decode's shape (the slice's pool, b 8, 5 page slots of 8,
  d 8) and at the serving engine's 17-slot table: the public
  ``paged_gather``, this tree's launcher ``_gather_cuda`` alone, and
  ``pool[table]`` (the one-call reference, which does less: no zero
  tail), CUDA events over 100 back-to-back calls, in turns HOST_TURNS
  times; the public call and ``pool[table]`` replayed from a CUDA graph
  (device time);
  the wide gather (b 32, 4096 positions, d 128) replayed;
- the attention at the slice (b 8, 40 positions, d 8), wide (b 32, 4096
  positions, d 128) and long (b 8, 32 768 positions, d 128), fp32 and
  int8: the public ``paged_attention``, events in turns and replayed,
  each beside its bound (chip_smoke.py's ``paged_attention_bound``) and
  its distance from the tree's own plain version (recorded, whether
  within chip_smoke.py's limit or not; float64 where the tree's
  ``paged_attention_ref`` takes ``dtype``).

Device times replay PER_GRAPH calls captured in one CUDA graph
(``graph_ms``; fewer for a call slower than a millisecond), so a graph's
own launch cost does not enter.

This checkout's process also times, device time only, each case beside
its distance from the float64 plain version (a setting outside the limit
is marked so):

- the split plan: ``SPLIT_WAVES`` of 1, 2, 4, 8, 16 and 32 (blocks the
  plan aims for, in SM counts) and one split;
- variants of ``ops/csrc/paged_attention.cu`` (text substitutions, built
  by nvcc with the port's flags into ``build/variants/`` and called
  through the same entry point at the plan's splits): ``as_built``;
  ``threads_256`` (blocks of 256 threads); ``ahead_2`` and ``ahead_8``
  (K and V vectors a lane loads before folding them); both together;
  ``unpipelined`` (a round's loads issued after the previous round
  folded, not before); ``int8_words`` (int8 rows in 4-byte words, not 16
  bytes); ``scalar`` (one element a load); ``f32_dot`` (the score's dot
  product summed in float32, not float64); ``scale_f64`` (the softmax
  scale applied in float64 before the score's one rounding). Beside each split plan, the
  split kernel and the combine apart (profiler).

Writes ``chiprun_out/paged_variants.json``; prints one JSON line per
process.
"""

from __future__ import annotations

import ctypes
import inspect
import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "analytics_zoo_tpu_torch", "ops", "csrc",
                   "paged_attention.cu")
OUT = os.path.join(ROOT, "build", "variants")
VARIANTS = {
    "as_built": [],
    "threads_256": [("#define ATTN_THREADS 128", "#define ATTN_THREADS 256")],
    "ahead_2": [("#define ATTN_ROWS_AHEAD 4", "#define ATTN_ROWS_AHEAD 2")],
    "ahead_8": [("#define ATTN_ROWS_AHEAD 4", "#define ATTN_ROWS_AHEAD 8")],
    "threads_256_ahead_8": [
        ("#define ATTN_THREADS 128", "#define ATTN_THREADS 256"),
        ("#define ATTN_ROWS_AHEAD 4", "#define ATTN_ROWS_AHEAD 8")],
    "unpipelined": [("constexpr bool PIPE = VPL * VEC <= 8;",
                     "constexpr bool PIPE = false;")],
    "int8_words": [("if (dim % 16 == 0 && bases % 16 == 0) {",
                    "if (false) {")],
    "scalar": [("  int vec = 1;\n  if (is_int8) {",
                "  int vec = 1;\n  if (false) {"),
               ("  } else if (dim % 4 == 0 && bases % 16 == 0) {\n    vec = 4;",
                "  } else if (false) {\n    vec = 4;")],
    "f32_dot": [("    double qv[VPL][VEC];", "    float qv[VPL][VEC];"),
                ("? (double)a.q[(long long)b * dim + v * VEC + e]\n"
                 "                          : 0.0;",
                 "? a.q[(long long)b * dim + v * VEC + e] : 0.f;"),
                ("        double part = 0.0;", "        float part = 0.f;"),
                ("part = fma(qv[k][e], (double)x[e], part);",
                 "part = fmaf(qv[k][e], x[e], part);"),
                ("s[u] = __double2float_rn(part) * a.softmax_scale;",
                 "s[u] = part * a.softmax_scale;")],
    "scale_f64": [("s[u] = __double2float_rn(part) * a.softmax_scale;",
                   "s[u] = __double2float_rn(part * (double)a.softmax_scale);")],
}
WAVES = (1, 2, 4, 8, 16, 32)
ROUNDS = 2
PER_GRAPH = 20
HOST_TURNS = 5


def graph_ms(fn, per_graph: int = PER_GRAPH, replays: int = 10) -> float:
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
    with torch.cuda.graph(graph):
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


def gather_cases(torch, cs):
    """(name, pool, scales, table, lengths) on the card: decode's shape,
    the serving engine's table, the wide pool; fp32."""
    from analytics_zoo_tpu_torch.inference import generation
    from analytics_zoo_tpu_torch.inference.decode_scheduler import (
        default_pool_pages,
    )
    gen = torch.Generator(device="cpu").manual_seed(cs.SEED + 5)
    dev = torch.device("cuda")
    ps, d = cs.PAGE_SIZE, cs.DECODE["output_dim"]
    slice_pages = default_pool_pages(cs.DECODE_BATCH, cs.DECODE_STEPS,
                                     spec_k=0, page_size=ps)
    serve_pages = default_pool_pages(
        cs.DECODE_BATCH, generation.DEFAULT_SEQ_RUNGS[1], cs.DECODE_SPEC_K,
        ps)
    serve_width = -(-(generation.DEFAULT_SEQ_RUNGS[1] + cs.DECODE_SPEC_K
                      + 1) // ps)
    shapes = [("decode", slice_pages, ps, d, cs.DECODE_BATCH,
               -(-(cs.DECODE_STEPS + 1) // ps)),
              ("serving", serve_pages, ps, d, cs.DECODE_BATCH, serve_width),
              ("wide", 32 * 256, 16, 128, 32, 256)]
    return [(name, *cs.paged_case(torch, gen, dev, torch.float32, *shape))
            for name, *shape in shapes]


def attention_cases(torch, cs):
    """(name, dtype, q, k_pool, v_pool, k_scales, v_scales, table,
    lengths) on the card: chip_smoke.py's phase 3d shapes but its copy of
    JAX's test shape; no scales for fp32."""
    from analytics_zoo_tpu_torch.inference.decode_scheduler import (
        default_pool_pages,
    )
    gen = torch.Generator(device="cpu").manual_seed(cs.SEED + 6)
    dev = torch.device("cuda")
    ps, d = cs.PAGE_SIZE, cs.DECODE["output_dim"]
    shapes = [("slice", default_pool_pages(cs.DECODE_BATCH, cs.DECODE_STEPS,
                                           spec_k=0, page_size=ps), ps, d,
               cs.DECODE_BATCH, -(-(cs.DECODE_STEPS + 1) // ps)),
              ("wide", 32 * 256, 16, 128, 32, 256),
              ("long", 8 * 2048, 16, 128, 8, 2048)]
    out = []
    for dtype in (torch.float32, torch.int8):
        for name, n_pages, ps, d, batch, width in shapes:
            kp, ks, table, lengths = cs.paged_case(
                torch, gen, dev, dtype, n_pages, ps, d, batch, width)
            vp, vs, _, _ = cs.paged_case(torch, gen, dev, dtype, n_pages, ps,
                                         d, batch, width)
            q = torch.randn(batch, d, generator=gen).to(dev)
            if dtype == torch.float32:
                ks = vs = None
            out.append((name, str(dtype), q, kp, vp, ks, vs, table,
                        lengths))
    return out


def child(tree: str) -> dict:
    """The timings of the checkout at ``tree``."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs
    from analytics_zoo_tpu_torch.ops import _build
    from analytics_zoo_tpu_torch.ops import paged_attention as pa

    if os.path.dirname(os.path.abspath(cs.__file__)) != tree:
        raise RuntimeError(f"chip_smoke imported from {cs.__file__}")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(["paged_attention"])
    rec = {"tree": os.path.relpath(tree, ROOT), "card": cs.card_line(),
           "gather": {}, "attention": {}}
    for name, pool, scales, table, lengths in gather_cases(torch, cs):
        idx = table.long().clamp(0, pool.shape[0] - 1)
        got = pa.paged_gather(pool, table, lengths, scales)
        if not cs.same_bits(got, pa.paged_gather_ref(pool, table, lengths,
                                                      scales)):
            raise AssertionError(f"gather {name} != plain")
        call = (lambda: pa.paged_gather(pool, table, lengths, scales))
        take = (lambda: pool[idx])
        r = dict(device_ms=graph_ms(call), take_device_ms=graph_ms(take),
                 ms=[], take_ms=[], launch_ms=[])
        # the launcher alone (this tree's signature: scales None for fp32)
        launch = (lambda: pa._gather_cuda(pool, table, lengths, None,
                                          table.shape[1] * pool.shape[1])) \
            if hasattr(pa, "_attention_plan") else None
        if name != "wide":
            for _ in range(HOST_TURNS):
                r["ms"].append(cs.cuda_ms(call))
                r["take_ms"].append(cs.cuda_ms(take))
                if launch is not None:
                    r["launch_ms"].append(cs.cuda_ms(launch))
        rec["gather"][name] = r
    for name, dtype, q, kp, vp, ks, vs, table, lengths in \
            attention_cases(torch, cs):
        kw = dict(k_scales=ks, v_scales=vs)
        got = pa.paged_attention(q, kp, vp, table, lengths, **kw)
        exact = {"dtype": torch.float64} if "dtype" in inspect.signature(
            pa.paged_attention_ref).parameters else {}
        want = pa.paged_attention_ref(q, kp, vp, table, lengths, **kw,
                                      **exact)
        call = (lambda: pa.paged_attention(q, kp, vp, table, lengths, **kw))
        slow = cs.cuda_ms(call, iters=3, warmup=1) > 1.0
        r = dict(device_ms=graph_ms(call, per_graph=2 if slow else PER_GRAPH),
                 bound_ms=cs.paged_attention_bound(q, kp, lengths,
                                                   table.shape[1])[0],
                 max_abs_err=cs.max_abs_err(got, want),
                 close=cs.paged_close(got, want), ms=[])
        for _ in range(1 if slow else HOST_TURNS):
            r["ms"].append(cs.cuda_ms(call, iters=10 if slow else 100))
        rec["attention"][f"{name}_{dtype}"] = r
    return rec


def build_variants(names=None):
    """Compile the variants ``names`` (default all) in parallel: {name:
    library}, {name: nvcc's register lines}."""
    import torch  # noqa: F401  (loads the CUDA runtime first)
    from analytics_zoo_tpu_torch.ops import _build
    from analytics_zoo_tpu_torch.ops import paged_attention as pa

    src = open(SRC).read()
    os.makedirs(OUT, exist_ok=True)
    procs = []
    for name, subs in VARIANTS.items():
        if names is not None and name not in names:
            continue
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} is not in the source")
            text = text.replace(old, new)
        cu = os.path.join(OUT, f"paged_{name}.cu")
        with open(cu, "w") as fh:
            fh.write(text)
        so = os.path.join(OUT, f"libpaged_{name}.so")
        procs.append((name, so, subprocess.Popen(
            [_build.nvcc_path(), *_build.nvcc_flags("paged_attention"), "-o",
             so, cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs, regs = {}, {}
    for name, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        regs[name] = [ln.strip() for ln in log.splitlines()
                      if "registers" in ln or "spill" in ln]
        lib = ctypes.CDLL(so)
        # the same argument types as the package's own binding
        for fn in ("zoo_paged_attention", "zoo_cuda_error_string"):
            getattr(lib, fn).argtypes = getattr(pa._lib(), fn).argtypes
            getattr(lib, fn).restype = getattr(pa._lib(), fn).restype
        libs[name] = lib
    return libs, regs


def variants() -> dict:
    """Device time of the attention at each split plan and in each
    variant, replayed from a CUDA graph, in turns (every setting, then
    again)."""
    import torch

    import chip_smoke as cs
    from analytics_zoo_tpu_torch.ops import paged_attention as pa

    torch.backends.cuda.matmul.allow_tf32 = False
    libs, regs = build_variants()
    own = pa._lib()
    n_sm = pa._sm_count(torch.cuda.current_device())
    waves0 = pa.SPLIT_WAVES
    plans, rows = {}, {}
    for name, dtype, q, kp, vp, ks, vs, table, lengths in \
            attention_cases(torch, cs):
        case = f"{name}_{dtype}"
        batch, width = table.shape
        sc = 1.0 / math.sqrt(q.shape[1])
        want = pa.paged_attention_ref(q, kp, vp, table, lengths, k_scales=ks,
                                      v_scales=vs, dtype=torch.float64)
        ps, d = kp.shape[1], kp.shape[2]
        quantized = kp.dtype == torch.int8
        settings = {"one_split": 1}
        for w in WAVES:
            pa.SPLIT_WAVES = w
            settings[f"waves_{w}"] = pa._attention_plan(
                batch, width, ps, d, quantized, n_sm)[0]
        pa.SPLIT_WAVES = waves0
        plans[case] = settings
        row = rows.setdefault(case, {})
        outside = set()
        for _ in range(2):
            for label, splits in settings.items():
                fn = (lambda s=splits: pa._attention_cuda(
                    q, kp, vp, table, lengths, ks, vs, sc, splits=s))
                if not cs.paged_close(fn(), want):
                    outside.add(label)
                row.setdefault(label, []).append(graph_ms(fn))
                if splits > 1:
                    apart = cs.kernel_device_ms(torch, fn, (
                        "paged_attention_kernel",
                        "paged_attention_combine_kernel"))
                    row.setdefault(f"{label}_apart", []).append(apart)
            for label, lib in libs.items():
                pa._lib_handle = lib
                try:
                    fn = (lambda: pa._attention_cuda(
                        q, kp, vp, table, lengths, ks, vs, sc))
                    if not cs.paged_close(fn(), want):
                        outside.add(label)
                    row.setdefault(label, []).append(graph_ms(fn))
                finally:
                    pa._lib_handle = own
        row["outside_the_limit"] = sorted(outside)
        print(json.dumps({case: dict(plan=plans[case], device_ms=row)}),
              flush=True)
    return dict(registers=regs, plans=plans, device_ms=rows)


def main() -> int:
    if sys.argv[1:2] == ["--child"]:
        print(json.dumps(child(sys.argv[2])), flush=True)
        return 0
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("paged_variants: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    parent = sys.argv[sys.argv.index("--parent") + 1] \
        if "--parent" in sys.argv else None
    rounds = int(sys.argv[sys.argv.index("--rounds") + 1]) \
        if "--rounds" in sys.argv else ROUNDS
    out = {"card": cs.card_line(), "torch": torch.__version__,
           "parent": parent and os.path.relpath(os.path.abspath(parent),
                                                ROOT)}
    print(out["card"], flush=True)
    out["variants"] = variants()
    trees = (parent, ROOT, ROOT, parent) if parent else (ROOT,)
    out["runs"] = []
    for tree in trees * rounds:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child",
             os.path.abspath(tree)], capture_output=True, text=True,
            timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(proc.stdout + proc.stderr)
        out["runs"].append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(out["runs"][-1]), flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "paged_variants.json"),
              "w") as fh:
        json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
