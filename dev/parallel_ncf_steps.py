#!/usr/bin/env python3
"""Phase 23(c)'s NCF fits step by step, on one GPU: where a rank's fit
leaves the one-rank fit.

    python3 dev/parallel_ncf_steps.py

NCF at MovieLens-1M width (chip_smoke.py's P23 data and weights, batch
8000, Adam(1e-3), 20 steps, TF32 off) is fitted one step at a time on one
rank, then under "dp" and "tp2" over 2 ranks and "dp2,tp2" over 4 sharing
the card over gloo (parallel/launch.py); after every step each rank's
gathered parameters are held against the one-rank fit's: the largest
distance by leaf and the elements past 1e-5. The worst element's
trajectory ends each layout's lines. Writes
chiprun_out/parallel_ncf_steps.json.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
WORK = os.path.join(ROOT, "build", "parallel_ncf_steps")


def fit_steps(torch, np, cs, ncf, x, y, rows):
    """One fit a step; every step's whole parameters."""
    est = ncf.model._ensure_estimator(for_training=True)
    per = len(rows) // cs.P23_NCF_STEPS
    states = []
    for s in range(cs.P23_NCF_STEPS):
        sl = rows[s * per:(s + 1) * per]
        ncf.fit(x[sl], y[sl], batch_size=cs.BATCH, nb_epoch=1, shuffle=False)
        states.append({k: v.detach().float().cpu() for k, v in
                       est.gathered_state_dict().items()})
    return states


def rank(strategy):
    import numpy as np
    import torch

    import chip_smoke as cs
    from analytics_zoo_tpu_torch.common.context import (OrcaContext,
                                                        init_orca_context,
                                                        stop_orca_context)
    from analytics_zoo_tpu_torch.learn import estimator
    OrcaContext.default_matmul_precision = "float32"
    init_orca_context(cluster_mode="multihost", device="cuda:0")
    estimator.DEFAULT_LOG_DIR = os.path.join(WORK, "tb")
    try:
        state = torch.load(os.path.join(WORK, "init.pt"))
        x, y = cs.p23_ncf_data(np)
        ncf = cs.p23_ncf_model(torch, state, strategy, "cuda:0")
        est = ncf.model._ensure_estimator(for_training=True)
        rows = cs.p23_rows(np, len(x), cs.BATCH,
                           est._mesh.data_index(est.strategy.batch_axes()),
                           est._batch_shards)
        states = fit_steps(torch, np, cs, ncf, x, y, rows)
        ref = torch.load(os.path.join(WORK, "ref.pt"))
        steps = []
        for got, want in zip(states, ref):
            diff = {k: (got[k] - want[k]).abs() for k in want}
            steps.append({
                "errs": {k: float(d.max()) for k, d in diff.items()},
                "past": {k: int((d > cs.P23_PARAM_ATOL).sum())
                         for k, d in diff.items()
                         if (d > cs.P23_PARAM_ATOL).any()}})
        leaf = max(steps[-1]["errs"], key=steps[-1]["errs"].get)
        i = int((states[-1][leaf] - ref[-1][leaf]).abs().argmax())
        traj = [[float(ref[s][leaf].reshape(-1)[i]),
                 float(states[s][leaf].reshape(-1)[i])]
                for s in range(len(ref))]
        return {"steps": steps, "worst": [leaf, i, traj]}
    finally:
        stop_orca_context()


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from analytics_zoo_tpu_torch.learn import estimator
    from analytics_zoo_tpu_torch.models import NeuralCF
    from analytics_zoo_tpu_torch.ops import _build
    from analytics_zoo_tpu_torch.parallel.launch import launch

    if not torch.cuda.is_available():
        print("parallel_ncf_steps: CUDA is not available", file=sys.stderr)
        return 2
    os.chdir(ROOT)
    cs.log(cs.card_line())
    cs.log(f"build: {_build.build():.1f} s")
    os.makedirs(WORK, exist_ok=True)
    estimator.DEFAULT_LOG_DIR = os.path.join(WORK, "tb")
    ncf = NeuralCF(**cs.NCF)
    cs.seeded_weights(ncf.model.module, cs.SEED + 23)
    state = {k: v.clone() for k, v in ncf.model.module.state_dict().items()}
    torch.save(state, os.path.join(WORK, "init.pt"))
    x, y = cs.p23_ncf_data(np)
    with cs.p17_tf32(torch, False):
        one = cs.p23_ncf_model(torch, state, "dp", "cuda")
        ref = fit_steps(torch, np, cs, one, x, y, np.arange(len(x)))
    torch.save(ref, os.path.join(WORK, "ref.pt"))
    out = {}
    for world, strategy in ((2, "dp"), (2, "tp2"), (4, "dp2,tp2")):
        res = launch(rank, world, args=(strategy,), device="cuda:0",
                     backend="gloo", timeout=600)[0]
        out[strategy] = res
        for s, step in enumerate(res["steps"]):
            cs.log(f"{strategy} step {s}: largest distance by leaf "
                   f"{ {k: f'{v:.2e}' for k, v in step['errs'].items()} }; "
                   f"elements past {cs.P23_PARAM_ATOL}: {step['past']}")
        cs.log(f"{strategy}: the worst element {res['worst'][0]}"
               f"[{res['worst'][1]}], one rank / ranks by step: "
               f"{res['worst'][2]}")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "parallel_ncf_steps.json"),
              "w") as fh:
        json.dump(out, fh)
    import shutil
    shutil.rmtree(WORK, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
