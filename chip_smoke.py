#!/usr/bin/env python3
"""Smoke run of the PyTorch port (analytics_zoo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. card    — name and power limit, from nvidia-smi
2. build   — nvcc builds every CUDA kernel from ops/csrc into build/kernels
3. kernels — each kernel against its plain PyTorch version on the same
             CUDA tensors, bitwise (NaN rows compare as NaN), at the main
             path's shapes plus a ragged batch; kernel, plain and one-call
             library times (CUDA events) beside the device-memory bound
4. slice   — NeuralCF at MovieLens-1M width (6040 users, 3706 items, 5
             classes, embeddings of 20, hidden (40, 20, 10), GMF 20), with
             weights drawn from a numpy seed, served by
             InferenceModel(device="cuda").predict on 8000 rows and held
             against the same model on the CPU (plain path)
5. serving — the Python broker + ClusterServing answer a burst of records
             and a run of single requests; every result is held against
             the direct predict

Launch counts are reset right before phase 4 and read right after phase 5:
every kernel of the path must have launched there. The second-to-last
line is the kernels JSON, the last ``{"ok": true, "device": {...}}``.
Details go to chiprun_out/chip_smoke.json. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory (NVIDIA data sheet)
FP32_FLOPS_PER_S = 67e12        # H100 SXM fp32 outside the tensor cores
NCF = dict(user_count=6040, item_count=3706, class_num=5, user_embed=20,
           item_embed=20, hidden_layers=(40, 20, 10), include_mf=True,
           mf_embed=20)
BATCH = 8000
RAGGED = 37
SEED = 0
SLICE_ATOL = 1e-5   # fp32 GEMMs sum in another order on cuBLAS than on CPU
N_BURST = 512
N_SINGLE = 100
SERVE_BATCH = 256


def log(msg: str):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 100) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back launches."""
    import torch
    for _ in range(5):
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


def fmt_ms(ms) -> str:
    return "n/a" if ms is None else f"{ms:.4f}"


def same_bits(a, b) -> bool:
    """Bitwise equality, every NaN counting as one value."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    na, nb = torch.isnan(a), torch.isnan(b)
    if not torch.equal(na, nb):
        return False
    view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return torch.equal(a.view(view)[~na], b.view(view)[~nb])


def max_abs_err(a, b) -> float:
    import torch
    ok = ~(torch.isnan(a) | torch.isnan(b))
    if not bool(ok.any()):
        return 0.0
    return float((a.float() - b.float()).abs()[ok].max())


def lookup_bound(tables, ids, combine):
    """Least time for one fused lookup: bytes it must move (ids read,
    each distinct valid row gathered once, output written) over the
    memory rate, or its fp32 flops over the fp32 rate."""
    import torch
    item = tables[0].element_size()
    batch, n = ids.shape
    moved = ids.numel() * ids.element_size()
    for t, tab in enumerate(tables):
        col = ids[:, t].long()
        vocab = tab.shape[0]
        col = col[(col >= -vocab) & (col < vocab)] % vocab
        moved += torch.unique(col).numel() * tab.shape[1] * item
    d_out = sum(t.shape[1] for t in tables) if combine == "concat" \
        else tables[0].shape[1]
    moved += batch * d_out * item
    flops = 0 if combine == "concat" else \
        batch * d_out * (n - 1 + (combine == "mean"))
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_FLOPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")


def library_call(tables, ids, combine):
    """One-call PyTorch yardstick (timed only, never used by the port)."""
    import torch
    rows = [t.index_select(0, ids[:, i]) for i, t in enumerate(tables)]
    if combine == "concat":
        return torch.cat(rows, dim=1)
    acc = rows[0]
    for r in rows[1:]:
        acc = acc * r if combine == "mul" else acc + r
    return acc / len(rows) if combine == "mean" else acc


def phase_kernels(torch, eb):
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(SEED)

    def tables_of(shapes, dtype):
        return [torch.randn(v, d, generator=gen).to(dev, dtype)
                for v, d in shapes]

    def ids_of(shapes, batch, oob=False):
        # oob: ids over [-2V, 2V), so some are out of range either side
        return torch.stack([torch.randint(-2 * v if oob else 0,
                                          2 * v if oob else v, (batch,),
                                          generator=gen)
                            for v, _ in shapes], 1).to(dev, torch.int32)

    ncf_shapes = [(NCF["user_count"] + 1, NCF["user_embed"]),
                  (NCF["item_count"] + 1, NCF["item_embed"])]
    mixed = [(1000, 8), (2000, 16), (3000, 4)]
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for batch in (BATCH, RAGGED):
            for combine in ("concat", "sum", "mean", "mul"):
                cases.append((f"ncf_{combine}", ncf_shapes, combine, dtype,
                              batch, False))
            cases.append(("mixed_concat", mixed, "concat", dtype, batch,
                          False))
        # ids outside [-V, V) give NaN rows, negative ones wrap
        cases.append(("out_of_range_mul", ncf_shapes, "mul", dtype, BATCH,
                      True))
        cases.append(("out_of_range_concat", ncf_shapes, "concat", dtype,
                      BATCH, True))
    results = []
    for name, shapes, combine, dtype, batch, oob in cases:
        tables = tables_of(shapes, dtype)
        ids = ids_of(shapes, batch, oob)
        got = eb.fused_embedding_lookup(tables, ids, combine)
        want = eb._fused_ref(tables, ids, combine)
        torch.cuda.synchronize()
        if not same_bits(got, want):
            raise AssertionError(f"kernel != plain: {name} {dtype} b{batch}"
                                 f" max_abs_err={max_abs_err(got, want)}")
        bound, bound_by = lookup_bound(tables, ids, combine)
        rec = dict(case=name, combine=combine, dtype=str(dtype),
                   batch=batch, max_abs_err=max_abs_err(got, want),
                   ms=cuda_ms(lambda: eb.fused_embedding_lookup(
                       tables, ids, combine)),
                   plain_ms=cuda_ms(lambda: eb._fused_ref(
                       tables, ids, combine)),
                   # index_select faults on ids out of range: no yardstick
                   library_ms=None if oob else cuda_ms(
                       lambda: library_call(tables, ids, combine)),
                   bound_ms=bound, bound_by=bound_by)
        results.append(rec)
        log(f"  {name:20s} {str(dtype):15s} b{batch:<5d} bitwise ok  "
            f"kernel {rec['ms']:.4f} ms  plain {rec['plain_ms']:.4f} ms  "
            f"library {fmt_ms(rec['library_ms'])} ms  "
            f"bound {rec['bound_ms']:.5f} ms ({bound_by})")
    return results


def ncf_weights(module, seed: int):
    """The model's parameters drawn from a numpy seed: tables U(-0.05,
    0.05), dense kernels glorot-uniform, biases U(-0.05, 0.05)."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    state = {}
    for key, val in module.state_dict().items():
        shape = tuple(val.shape)
        lim = np.sqrt(6.0 / sum(shape)) if key.endswith(".weight") else 0.05
        state[key] = torch.from_numpy(
            rng.uniform(-lim, lim, shape).astype(np.float32))
    module.load_state_dict(state)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.models import NeuralCF
    from analytics_zoo_tpu_torch.ops import _build
    from analytics_zoo_tpu_torch.ops import embedding_bag as eb
    from analytics_zoo_tpu_torch.serving import (Broker, ClusterServing,
                                                 InputQueue, OutputQueue)

    report = {}
    # 1. card
    card = card_line()
    log(card)
    kind = torch.cuda.get_device_name(0)
    report["card"] = card
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    # 2. build
    build_s = _build.build()
    report["build_s"] = build_s
    log(f"build: {build_s:.1f} s")
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # 3. kernel vs plain
    log("kernels vs plain (bitwise):")
    cases = phase_kernels(torch, eb)
    report["kernel_cases"] = cases

    # 4. slice — the main path starts here
    torch.backends.cuda.matmul.allow_tf32 = False
    ncf = NeuralCF(**NCF)
    ncf_weights(ncf.model.module, SEED)
    rng = np.random.RandomState(SEED)
    x = np.stack([rng.randint(1, NCF["user_count"] + 1, BATCH),
                  rng.randint(1, NCF["item_count"] + 1, BATCH)],
                 1).astype(np.float32)
    _build.reset_launch_counts()
    im = InferenceModel(device="cuda").load_zoo(ncf)
    y = im.predict(x, batch_size=BATCH)
    t0 = time.perf_counter()
    reps = 20
    for _ in range(reps):
        im.predict(x, batch_size=BATCH)
    predict_ms = (time.perf_counter() - t0) / reps * 1e3
    y_cpu = InferenceModel(device="cpu").load_zoo(ncf).predict(x)
    diff = float(np.abs(y - y_cpu).max())
    if y.shape != (BATCH, NCF["class_num"]) or not np.isfinite(y).all():
        raise AssertionError(f"bad predict output {y.shape}")
    if diff > SLICE_ATOL:
        raise AssertionError(f"cuda vs cpu predict differ by {diff}")
    if float(np.abs(y.sum(-1) - 1).max()) > 1e-5:
        raise AssertionError("softmax rows do not sum to 1")
    log(f"slice: NeuralCF predict {BATCH} rows on {kind}: "
        f"{predict_ms:.3f} ms/call (host clock), max |cuda - cpu| = "
        f"{diff:.3g} (atol {SLICE_ATOL})")
    report["slice"] = dict(predict_ms=predict_ms, max_abs_diff=diff)

    # 5. serving
    before = eb.launches.value
    with Broker.launch(backend="python") as broker, \
            ClusterServing(im, broker.port, batch_size=SERVE_BATCH) as serving:
        iq = InputQueue(port=broker.port)
        oq = OutputQueue(port=broker.port)
        t0 = time.perf_counter()
        uris = iq.enqueue_batch((f"b{i}", {"x": x[i]})
                                for i in range(N_BURST))
        got = oq.query_many(uris, timeout=120, poll_interval=0.002)
        burst_s = time.perf_counter() - t0
        lat = []
        for i in range(N_SINGLE):
            t1 = time.perf_counter()
            uri = iq.enqueue(f"s{i}", x=x[N_BURST + i])
            r = oq.query(uri, timeout=30, poll_interval=0.0005)
            lat.append(time.perf_counter() - t1)
            got[uri] = r
        metrics = serving.metrics()
        iq.close()
        oq.close()
    rows = {f"b{i}": i for i in range(N_BURST)}
    rows.update({f"s{i}": N_BURST + i for i in range(N_SINGLE)})
    worst = 0.0
    for uri, i in rows.items():
        if got.get(uri) is None:
            raise AssertionError(f"no result for {uri}")
        worst = max(worst, float(np.abs(got[uri] - y[i]).max()))
    if worst > SLICE_ATOL:
        raise AssertionError(f"served result differs from predict: {worst}")
    served = eb.launches.value - before
    if served <= 0:
        raise AssertionError("serving did not launch the lookup kernel")
    rps = N_BURST / burst_s
    p50 = float(np.percentile(lat, 50)) * 1e3
    log(f"serving on {kind}: {N_BURST} records in {burst_s:.3f} s = "
        f"{rps:.1f} records/s (batch {SERVE_BATCH}); single-request p50 "
        f"{p50:.3f} ms over {N_SINGLE}; max |served - predict| = "
        f"{worst:.3g}; kernel launches while serving: {served}; {metrics}")
    report["serving"] = dict(records_per_s=rps, p50_ms=p50,
                             max_abs_diff=worst, launches=served,
                             metrics=metrics)
    counts = _build.launch_counts()
    if counts.get("fused_embedding_lookup", 0) <= 0:
        raise AssertionError(f"main path launched no lookup kernel: {counts}")

    # 6. kernels line: the NCF concat lookup at the predict shape
    head = next(c for c in cases if c["case"] == "ncf_concat"
                and c["dtype"] == "torch.float32" and c["batch"] == BATCH)
    kernels = {"kernels": [{
        "name": "fused_embedding_lookup", "route": "cuda",
        "source": "analytics_zoo_tpu_torch/ops/csrc/embedding_bag.cu",
        "replaces": "analytics_zoo_tpu/ops/embedding_bag.py:102",
        "launches": counts["fused_embedding_lookup"],
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"]}]}
    report["kernels"] = kernels
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as fh:
        json.dump(report, fh, indent=1)
    log(json.dumps(kernels))
    # 7. result
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
