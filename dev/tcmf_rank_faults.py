#!/usr/bin/env python3
"""Does each likely fault of TCMF's series-across-ranks fit fail one of
chip_smoke.py's 24(d) limits?

    python3 dev/tcmf_rank_faults.py [--device cuda|cpu] [--small]

Runs 24(d)'s fit (TCMF at the electricity panel's width, rank 64, 300
steps from the SVD start, the series over two ranks sharing the card over
gloo, against the one-rank fit) once as the code is and once for each
fault planted in an in-memory copy of ``TCMFForecaster._run_sharded``
(no file is changed):

- ``x_terms_per_rank``: X's smooth and l2 terms counted once a rank (the
  ``/ p`` dropped);
- ``x_grad_unsummed``: X's gradient left unsummed over the ranks;
- ``mse_local_count``: the mse divided by the rank's own count of
  entries, not the panel's.

Prints each reading beside its limit (``chip_smoke.p24_tcmf_limits``)
and the card's name and power limit, and writes
chiprun_out/tcmf_rank_faults.json. ``--small`` cuts the panel to 200
steps of time, rank 8 and 20 steps (a rehearsal on the CPU).
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

FAULTS = {
    "x_terms_per_rank": [
        ("smooth = torch.mean(torch.diff(x, dim=1) ** 2) / p",
         "smooth = torch.mean(torch.diff(x, dim=1) ** 2)"),
        ("torch.mean(x ** 2) / p", "torch.mean(x ** 2)")],
    "x_grad_unsummed": [
        ("collectives.all_reduce_(gx, mesh, (axis,))", "pass")],
    "mse_local_count": [
        ("** 2) / (n * t)\n", "** 2) / ((hi - lo) * t)\n")],
}
SMALL = {"P20_TCMF": (370, 200), "P20_TCMF_RANK": 8, "P24_TCMF_STEPS": 20}


def _planted(name):
    """``_run_sharded`` with the fault ``name`` planted (None: as it is)."""
    from analytics_zoo_tpu_torch.zouwu.model import tcmf
    fn = tcmf.TCMFForecaster.__dict__["_run_sharded"]
    if name is None:
        return fn
    src = textwrap.dedent(inspect.getsource(fn))
    for old, new in FAULTS[name]:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: {old!r} is not in _run_sharded "
                               "once: the fault no longer applies")
        src = src.replace(old, new)
    scope = dict(vars(tcmf))
    exec(compile(src, f"<{name}>", "exec"), scope)
    return scope["_run_sharded"]


def rank(cfg):
    """One rank: 24(d) for the code and each fault."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from analytics_zoo_tpu_torch.common.context import (OrcaContext,
                                                        init_orca_context,
                                                        stop_orca_context)
    from analytics_zoo_tpu_torch.zouwu.model import tcmf
    vars(cs).update(cfg["sizes"])
    OrcaContext.default_matmul_precision = "float32"   # TF32 off
    init_orca_context(cluster_mode="multihost", device=cfg["device"])
    world = torch.distributed.get_world_size()
    real = tcmf.TCMFForecaster.__dict__["_run_sharded"]
    out = {}
    try:
        for name in [None, *FAULTS]:
            tcmf.TCMFForecaster._run_sharded = _planted(name)
            try:
                out[name or "as_is"] = cs.p24_tcmf(torch, np, cfg, world)
            finally:
                tcmf.TCMFForecaster._run_sharded = real
    finally:
        stop_orca_context()
    return out


def main() -> int:
    import torch

    import chip_smoke as cs
    from analytics_zoo_tpu_torch.parallel.launch import launch
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("tcmf_rank_faults: CUDA is not available", file=sys.stderr)
        return 2
    os.chdir(ROOT)
    card = cs.card_line() if args.device == "cuda" else "cpu"
    sizes = SMALL if args.small else {}
    vars(cs).update(sizes)
    dev = "cuda:0" if args.device == "cuda" else "cpu"
    ranks = launch(rank, 2, args=(dict(device=dev, sizes=sizes),),
                   device=dev, backend="gloo", timeout=900)
    (lf, lx), lm = cs.p24_tcmf_limits()
    caught = {}
    for name, d in ranks[0].items():
        past = [k for k, v, lim in (("F", d["f_err"], lf),
                                    ("X", d["x_err"], lx),
                                    ("mse", d["mse_rel"], lm)) if v > lim]
        caught[name] = past
        cs.log(f"{name}: F {d['f_err']:.6g} (limit {lf:.3g}), X "
               f"{d['x_err']:.6g} (limit {lx:.3g}), mse {d['mse_rel']:.6g} "
               f"relative (limit {lm:.3g}); past its limit: "
               f"{', '.join(past) or 'none'}")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "tcmf_rank_faults.json"),
              "w") as fh:
        json.dump({"card": card, "sizes": sizes, "limits": [lf, lx, lm],
                   "ranks": ranks, "past": caught}, fh, indent=1,
                  default=str)
    cs.log(card)
    ok = not caught["as_is"] and all(caught[f] for f in FAULTS)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
