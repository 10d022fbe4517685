#!/usr/bin/env python3
"""Which collectives torch's gloo backend carries on CUDA tensors, on one
GPU: the basis of ``parallel/collectives.py``'s ``GLOO_CUDA_DIRECT``.

    python3 dev/gloo_cuda_probe.py [--mib 4]

For each op the port calls (``all_reduce``, ``broadcast``,
``all_gather_into_tensor``, ``reduce_scatter_tensor``,
``all_to_all_single`` and a ring shift by ``batch_isend_irecv``) two ranks
sharing the card over a gloo group (``parallel/launch.py``) run the op
once directly on CUDA tensors and hold the result bitwise against the
same data movement done on the host. Each op has a launch of its own,
so an op that raises, crashes its rank or hangs (time limit) is recorded
as not carried and touches no other. Where the op is carried, each rank
also times it at ``--mib`` MiB a rank directly and staged through
pinned host buffers (the port's route for the ops the table stages),
host-clock ms a call. Prints the card's name and power limit, torch's
version and a line an op; writes chiprun_out/gloo_cuda_probe.json.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OPS = ("all_reduce", "broadcast", "all_gather", "reduce_scatter",
       "all_to_all", "ring_shift")
TIMEOUT = 90.0


def _inputs(torch, world, rows):
    return [torch.randn((rows * world, 256), generator=torch.Generator()
                        .manual_seed(100 + r)) for r in range(world)]


def _op(torch, dist, op, x, rank, world):
    """``op`` on ``x`` over the default group; the result."""
    if op == "all_reduce":
        x = x.clone()
        dist.all_reduce(x)
        return x
    if op == "broadcast":
        x = x.clone()
        dist.broadcast(x, 0)
        return x
    if op == "all_gather":
        out = x.new_empty((world * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x)
        return out
    if op == "reduce_scatter":
        out = x.new_empty((x.shape[0] // world,) + tuple(x.shape[1:]))
        dist.reduce_scatter_tensor(out, x)
        return out
    if op == "all_to_all":
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x)
        return out
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, (rank + 1) % world),
           dist.P2POp(dist.irecv, out, (rank - 1) % world)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


def _want(torch, op, xs, rank, world):
    """The same data movement on the host."""
    n = xs[0].shape[0] // world
    if op == "all_reduce":
        return sum(xs[1:], xs[0])
    if op == "broadcast":
        return xs[0]
    if op == "all_gather":
        return torch.cat(xs)
    if op == "reduce_scatter":
        return sum(xs[1:], xs[0])[rank * n:(rank + 1) * n]
    if op == "all_to_all":
        return torch.cat([x[rank * n:(rank + 1) * n] for x in xs])
    return xs[(rank - 1) % world]


def probe(op, mib):
    """One rank of ``op``'s launch: carried or not (and why), bitwise or
    not; where carried, ms a call direct and staged."""
    import torch
    import torch.distributed as dist
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = torch.device("cuda", torch.cuda.current_device())
    rows = max(1, int(mib * 2 ** 20 / (256 * 4 * world)))
    xs = _inputs(torch, world, rows)
    rec = {"op": op, "rank": rank, "mib": rows * world * 256 * 4 / 2 ** 20}
    try:
        got = _op(torch, dist, op, xs[rank].to(dev), rank, world)
        torch.cuda.synchronize()
    except Exception as e:      # the probe's reading: gloo refused the op
        rec.update(carried=False, error=f"{type(e).__name__}: {e}"[:400])
        return rec
    rec.update(carried=True, device=str(got.device),
               bitwise=bool(torch.equal(got.cpu(),
                                        _want(torch, op, xs, rank, world))))

    def timed(fn, n=10):
        fn()
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    x = xs[rank].to(dev)
    rec["direct_ms"] = timed(lambda: _op(torch, dist, op, x, rank, world))
    rec["staged_ms"] = timed(lambda: _op(
        torch, dist, op, x.to("cpu").pin_memory(), rank, world).to(dev))
    return rec


def one(op, mib):
    from analytics_zoo_tpu_torch.parallel.launch import launch
    t0 = time.perf_counter()
    try:
        ranks = launch(f"{os.path.abspath(__file__)}:probe", 2,
                       args=(op, mib), device="cuda:0", backend="gloo",
                       timeout=TIMEOUT)
    except (RuntimeError, TimeoutError) as e:
        # a rank crashed or the op hung: gloo does not carry it
        ranks = [{"op": op, "carried": False,
                  "error": f"{type(e).__name__}: {e}"[-600:]}]
    return {"op": op, "ranks": ranks,
            "seconds": time.perf_counter() - t0}


def main() -> int:
    import torch

    import chip_smoke as cs
    ap = argparse.ArgumentParser()
    ap.add_argument("--mib", type=float, default=4.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gloo_cuda_probe: CUDA is not available", file=sys.stderr)
        return 2
    os.chdir(ROOT)
    card = cs.card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    with ThreadPoolExecutor(len(OPS)) as pool:
        recs = list(pool.map(lambda op: one(op, args.mib), OPS))
    table = {}
    for rec in recs:
        ranks = rec["ranks"]
        ok = all(r.get("carried") and r.get("bitwise") for r in ranks)
        table[rec["op"]] = "direct" if ok else "staged"
        detail = "; ".join(
            (f"rank {r['rank']}: bitwise {r['bitwise']}, direct "
             f"{r['direct_ms']:.2f} ms, staged {r['staged_ms']:.2f} ms "
             f"({r['mib']:.2f} MiB)") if r.get("carried") else
            f"not carried: {r['error']}" for r in ranks)
        print(f"{rec['op']}: {table[rec['op']]} ({detail}; "
              f"{rec['seconds']:.1f} s)", flush=True)
    print(f"table: {table}", flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "gloo_cuda_probe.json"),
              "w") as fh:
        json.dump({"card": card, "torch": torch.__version__,
                   "table": table, "ops": recs}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
