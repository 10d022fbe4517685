#!/usr/bin/env python3
"""Time the embedding forward kernels (the fused lookup and the bag) of an
older checkout and of this one side by side on one GPU, and design
variants of this one's.

    python3 dev/embedding_variants.py [--parent TREE] [--rounds N]

TREE is an older commit unpacked with ``git archive`` into a directory
that .gitignore lists (e.g. ``build/parent``). The trees run in turns,
TREE, this, this, TREE, N times (default 2), each in a fresh process that
imports that tree's package and chip_smoke.py and builds its kernels
into the tree's own build/kernels/. A process times, on the same inputs
(numpy and torch seeds):

- the bag at the history column's shape as the keras layer calls it
  (b 8000, bag 8, d 20, V 3707, mean, fp32, no lengths, the column's pad
  id 0 counted): the public ``embedding_bag``, the launcher ``_bag_cuda``
  alone (full lengths, which both trees take) and ``F.embedding_bag`` as
  the yardstick, each CUDA events over 100 back-to-back calls, in turns
  HOST_TURNS times; the launcher replayed from a CUDA graph (device
  time);
- the lookup at NCF's concat fp32, b 8000: the public
  ``fused_embedding_lookup``, ``_fused_cuda`` and ``index_select`` +
  ``cat`` in the same way, and the launcher's replay;
- device time (replay) of the wide bag (b 4096, bag 64, d 128, V 100 000,
  lengths in [0, 64], fp32 and bf16) and the wide lookup (b 65 536, 8
  tables of 100 000 x 64, concat and sum, fp32 and bf16), each beside
  its bound (chip_smoke.py's ``bag_bound`` / ``lookup_bound``).
  Device times replay PER_GRAPH calls captured in one CUDA graph
  (``graph_ms``), so a graph's own launch cost does not enter;
- the training path's wrappers: the NCF lookup and the history bag,
  forward and backward under a gradient (the autograd Functions and the
  scatter), CUDA events over 50 calls, HOST_TURNS times;
- NCF predict of 8000 rows (chip_smoke.py's phase 4: InferenceModel on
  the card, PREDICT_REPS calls on the host clock, five times).

This checkout's process also times variants of ``ops/csrc/embedding_bag.cu``
(text substitutions, built by nvcc with the port's flags into
``build/variants/`` and called through the same C entry points), device
time only, every case bitwise against the plain version:

- ``as_built``: the source unchanged;
- ``unroll_8``: the bag's rows 8 slots ahead instead of 4;
- ``bag_no_min_blocks``: the bag without its cap of 64 registers (8
  blocks an SM);
- ``threads_256``: blocks of 256 threads instead of 128 (the bag capped
  for 4 blocks an SM);
- ``scalar``: one element a load (no 16-, 8- or 4-byte vectors).

Writes ``chiprun_out/embedding_variants.json``; prints one JSON line per
process.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "analytics_zoo_tpu_torch", "ops", "csrc",
                   "embedding_bag.cu")
OUT = os.path.join(ROOT, "build", "variants")
VARIANTS = {
    "as_built": [],
    "unroll_8": [("#define BAG_UNROLL 4", "#define BAG_UNROLL 8")],
    "bag_no_min_blocks": [(
        "__launch_bounds__(LOOKUP_THREADS, BAG_BLOCKS_PER_SM)",
        "__launch_bounds__(LOOKUP_THREADS)")],
    "threads_256": [("#define LOOKUP_THREADS 128",
                     "#define LOOKUP_THREADS 256"),
                    ("#define BAG_BLOCKS_PER_SM 8",
                     "#define BAG_BLOCKS_PER_SM 4")],
    "scalar": [("for (int vb = 16; vb > elem; vb >>= 1)",
                "for (int vb = elem; vb > elem; vb >>= 1)")],
}
WIDE_BAG = (4096, 64, 128, 100_000)       # batch, bag, dim, vocab
WIDE_LOOKUP = (65_536, 8, 100_000, 64)    # batch, tables, vocab, dim
PREDICT_REPS = 50
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


def inputs(torch, np, cs):
    """Every case's tensors on the card, the same in every process."""
    gen = torch.Generator().manual_seed(cs.SEED)
    dev = "cuda"
    _, _, hist = cs.ncf_train_data(np)
    items = cs.NCF["item_count"] + 1
    users = cs.NCF["user_count"] + 1
    d = cs.NCF["item_embed"]
    out = {
        "hist_ids": torch.from_numpy(hist[:cs.BATCH]).to(dev),
        "hist_table": torch.randn(items, d, generator=gen).to(dev),
        "ncf_tables": [torch.randn(users, d, generator=gen).to(dev),
                       torch.randn(items, d, generator=gen).to(dev)],
        "ncf_ids": torch.stack([
            torch.randint(0, users, (cs.BATCH,), generator=gen),
            torch.randint(0, items, (cs.BATCH,), generator=gen)],
            1).to(dev, torch.int32)}
    b, bag, dim, vocab = WIDE_BAG
    out["wide_bag"] = (
        torch.randn(vocab, dim, generator=gen).to(dev),
        torch.randint(0, vocab, (b, bag), generator=gen).to(dev,
                                                            torch.int32),
        torch.randint(0, bag + 1, (b,), generator=gen).to(dev, torch.int32))
    b, n, vocab, dim = WIDE_LOOKUP
    out["wide_lookup"] = (
        [torch.randn(vocab, dim, generator=gen).to(dev) for _ in range(n)],
        torch.randint(0, vocab, (b, n), generator=gen).to(dev, torch.int32))
    return out


def same_bits(torch, a, b):
    view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return a.shape == b.shape and torch.equal(a.view(view), b.view(view))


def host_times(cs, public, launcher, library) -> dict:
    """CUDA-event ms a call of the public function, the launcher and the
    library yardstick (100 back-to-back calls each), in turns HOST_TURNS
    times, and the launcher's device time (replay)."""
    rec = dict(ms=[], launch_ms=[], library_ms=[],
               device_ms=graph_ms(launcher))
    for _ in range(HOST_TURNS):
        for key, fn in (("ms", public), ("launch_ms", launcher),
                        ("library_ms", library)):
            rec[key].append(cs.cuda_ms(fn))
    return rec


def child(tree: str) -> dict:
    """The timings of the checkout at ``tree``."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.models import NeuralCF
    from analytics_zoo_tpu_torch.ops import _build
    from analytics_zoo_tpu_torch.ops import embedding_bag as eb

    if os.path.dirname(os.path.abspath(cs.__file__)) != tree:
        raise RuntimeError(f"chip_smoke imported from {cs.__file__}")
    _build.build(["embedding_bag"])
    x = inputs(torch, np, cs)
    rec = {"tree": os.path.relpath(tree, ROOT), "card": cs.card_line()}

    ids, table = x["hist_ids"], x["hist_table"]
    full = torch.full((ids.shape[0],), ids.shape[1], dtype=torch.int32,
                      device="cuda")
    got = eb.embedding_bag(table, ids, None, "mean")
    if not same_bits(torch, got, eb._bag_ref(table, ids, full, True)):
        raise AssertionError("history bag != plain")
    rec["bag_history"] = host_times(
        cs, lambda: eb.embedding_bag(table, ids, None, "mean"),
        lambda: eb._bag_cuda(table, ids, full, True),
        lambda: F.embedding_bag(ids, table, mode="mean"))
    tables, nids = x["ncf_tables"], x["ncf_ids"]
    rec["lookup_ncf_concat"] = host_times(
        cs, lambda: eb.fused_embedding_lookup(tables, nids),
        lambda: eb._fused_cuda(tables, nids, "concat"),
        lambda: cs.library_call(tables, nids, "concat"))
    # the training path's wrappers: forward and backward under a gradient
    tw = [t.clone().requires_grad_(True) for t in tables]
    hw = table.clone().requires_grad_(True)
    g_lookup = torch.randn(cs.BATCH, 2 * table.shape[1], device="cuda")
    g_bag = torch.randn(cs.BATCH, table.shape[1], device="cuda")

    def train_lookup():
        for t in tw:
            t.grad = None
        eb.fused_embedding_lookup(tw, nids).backward(g_lookup)

    def train_bag():
        hw.grad = None
        eb.embedding_bag(hw, ids, None, "mean").backward(g_bag)

    rec["train_ms"] = {"lookup_ncf_concat": [], "bag_history": []}
    for _ in range(HOST_TURNS):
        rec["train_ms"]["lookup_ncf_concat"].append(cs.cuda_ms(train_lookup,
                                                               iters=50))
        rec["train_ms"]["bag_history"].append(cs.cuda_ms(train_bag,
                                                         iters=50))
    for dtype in (torch.float32, torch.bfloat16):
        wt, wids, wlen = x["wide_bag"]
        wt = wt.to(dtype)
        got = eb._bag_cuda(wt, wids, wlen, False)
        if not same_bits(torch, got, eb._bag_ref(wt, wids, wlen, False)):
            raise AssertionError(f"wide bag {dtype} != plain")
        rec[f"bag_wide_{dtype}"] = dict(
            device_ms=graph_ms(lambda: eb._bag_cuda(wt, wids, wlen,
                                                         False)),
            bound_ms=cs.bag_bound(wt, wids, wlen, False)[0])
        lt, lids = x["wide_lookup"]
        lt = [t.to(dtype) for t in lt]
        for combine in ("concat", "sum"):
            got = eb._fused_cuda(lt, lids, combine)
            if not same_bits(torch, got, eb._fused_ref(lt, lids, combine)):
                raise AssertionError(f"wide lookup {combine} {dtype}")
            rec[f"lookup_wide_{combine}_{dtype}"] = dict(
                device_ms=graph_ms(lambda: eb._fused_cuda(lt, lids,
                                                               combine)),
                bound_ms=cs.lookup_bound(lt, lids, combine)[0])
        del lt, got
    rng = np.random.RandomState(cs.SEED)
    xp = np.stack([rng.randint(1, cs.NCF["user_count"] + 1, cs.BATCH),
                   rng.randint(1, cs.NCF["item_count"] + 1, cs.BATCH)],
                  1).astype(np.float32)
    ncf = NeuralCF(**cs.NCF)
    cs.seeded_weights(ncf.model.module, cs.SEED)
    im = InferenceModel(device="cuda").load_zoo(ncf)
    im.predict(xp, batch_size=cs.BATCH)
    rec["predict_ms"] = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(PREDICT_REPS):
            im.predict(xp, batch_size=cs.BATCH)
        rec["predict_ms"].append((time.perf_counter() - t0)
                                 / PREDICT_REPS * 1e3)
    return rec


def build_variants():
    """Compile every variant in parallel: {name: library}, {name: nvcc's
    register lines}."""
    import torch  # noqa: F401  (loads the CUDA runtime first)
    from analytics_zoo_tpu_torch.ops import _build
    from analytics_zoo_tpu_torch.ops import embedding_bag as eb

    src = open(SRC).read()
    os.makedirs(OUT, exist_ok=True)
    procs = []
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} is not in the source")
            text = text.replace(old, new)
        cu = os.path.join(OUT, f"emb_{name}.cu")
        with open(cu, "w") as fh:
            fh.write(text)
        so = os.path.join(OUT, f"libemb_{name}.so")
        procs.append((name, so, subprocess.Popen(
            [_build.nvcc_path(), *_build.nvcc_flags("embedding_bag"), "-o",
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
        for fn in ("zoo_fused_lookup", "zoo_embedding_bag"):
            getattr(lib, fn).argtypes = getattr(eb._lib(), fn).argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs, regs


def variants() -> dict:
    """Device time of each variant's launch, replayed from a CUDA graph,
    in turns (every variant, then again)."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from analytics_zoo_tpu_torch.ops import embedding_bag as eb

    libs, regs = build_variants()
    x = inputs(torch, np, cs)
    index = torch.cuda.current_device()

    def bag_call(lib, table, ids, lengths, mean, out):
        err = lib.zoo_embedding_bag(
            ids.data_ptr(), None if lengths is None else lengths.data_ptr(),
            table.data_ptr(), table.shape[0], table.shape[1], ids.shape[0],
            ids.shape[1], mean, table.dtype == torch.bfloat16,
            out.data_ptr(), index, eb._raw_stream(index))
        eb._check_launch(lib, err, "variant bag")

    def lookup_call(lib, tables, ids, combine, out):
        err = lib.zoo_fused_lookup(
            ids.data_ptr(), ctypes.byref(eb._fused_args(tables, combine)),
            out.data_ptr(), ids.shape[0], index, eb._raw_stream(index))
        eb._check_launch(lib, err, "variant lookup")

    cases = {}
    for dtype in (torch.float32, torch.bfloat16):
        t = x["hist_table"].to(dtype)
        cases[f"bag_history_{dtype}"] = (
            "bag", (t, x["hist_ids"], None, True),
            eb._bag_ref(t, x["hist_ids"], torch.full(
                (x["hist_ids"].shape[0],), 8, dtype=torch.int32,
                device="cuda"), True))
        wt, wids, wlen = x["wide_bag"]
        wt = wt.to(dtype)
        cases[f"bag_wide_{dtype}"] = ("bag", (wt, wids, wlen, False),
                                      eb._bag_ref(wt, wids, wlen, False))
        nt = [s.to(dtype) for s in x["ncf_tables"]]
        cases[f"lookup_ncf_concat_{dtype}"] = (
            "lookup", (nt, x["ncf_ids"], "concat"),
            eb._fused_ref(nt, x["ncf_ids"], "concat"))
        lt = [s.to(dtype) for s in x["wide_lookup"][0]]
        for combine in ("concat", "sum"):
            cases[f"lookup_wide_{combine}_{dtype}"] = (
                "lookup", (lt, x["wide_lookup"][1], combine),
                eb._fused_ref(lt, x["wide_lookup"][1], combine))
    rows = {}
    for case, (kind, args, want) in cases.items():
        out = torch.empty_like(want)
        row = rows.setdefault(case, {})
        for _ in range(2):
            for name, lib in libs.items():
                if kind == "bag":
                    fn = (lambda lib=lib: bag_call(lib, *args, out))
                else:
                    fn = (lambda lib=lib: lookup_call(lib, *args, out))
                out.fill_(0)
                fn()
                torch.cuda.synchronize()
                if not same_bits(torch, out, want):
                    raise AssertionError(f"{name} {case} != plain")
                row.setdefault(name, []).append(graph_ms(fn))
        print(json.dumps({case: row}), flush=True)
    return dict(registers=regs, device_ms=rows)


def main() -> int:
    if sys.argv[1:2] == ["--child"]:
        print(json.dumps(child(sys.argv[2])), flush=True)
        return 0
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("embedding_variants: needs a CUDA device", file=sys.stderr)
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
    with open(os.path.join(ROOT, "chiprun_out", "embedding_variants.json"),
              "w") as fh:
        json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
