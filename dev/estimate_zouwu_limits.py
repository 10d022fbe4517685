#!/usr/bin/env python3
"""How far chip_smoke.py's phase 20 computations sit from the same ones in
float64, on the CPU: the basis of phase 20's limits (P20_MTNET_FP32_LIMITS,
P20_MTNET_BF16_LIMITS, P20_TCMF_CPU_FX).

    python3 dev/estimate_zouwu_limits.py [--part mtnet|tcmf|all]
        [--rows 8] [--series 370] [--cols 25968] [--steps 300]
        [--threads 8]

- MTNet (phase 20(f)'s widths: 4 memories of 8 steps, 32 filters of
  height 3, GRUs (16, 32), AR window 4) on the series' first ``--rows``
  windows of 40 steps, weights from the forecaster's seed, dropout off:
  one step in fp32 and in bf16 (``mixed_bfloat16``) against the same step
  in float64, as phase 20 reads the card's: the loss's absolute
  difference, and the output's and the head gradient's distance over
  float64's norm.
- TCMF (phase 20(g): ``--series`` x ``--cols``, rank 64, from the SVD
  start): ``--steps`` Adam steps in fp32 against the same steps in
  float64, as the largest difference of F and of X, and the final mse of
  each. At the panel's full width this needs a few GiB and about a minute
  on 8 cores: run it on a machine that has them.

One JSON object on the last line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def mtnet(torch, np, rows: int) -> dict:
    import copy
    from analytics_zoo_tpu_torch.zouwu.feature import (
        TimeSequenceFeatureTransformer)
    from analytics_zoo_tpu_torch.zouwu.model.forecast import MTNetForecaster
    _, train, _, _ = cs.p20_frames(np)
    back = (cs.P20_MTNET["long_num"] + 1) * cs.P20_MTNET["time_step"]
    x, y = TimeSequenceFeatureTransformer(
        past_seq_len=back, dt_col="timestamp",
        target_col="value").fit_transform(train)
    x, y = x[:rows], y[:rows]
    out, ref, state = {}, None, None
    for dtype in ("float32", "mixed_bfloat16"):
        f = MTNetForecaster(future_seq_len=1, dtype=dtype, device="cpu",
                            **cs.P20_MTNET)
        est = f._ensure_est(x)
        if state is None:
            state = copy.deepcopy(est.model.state_dict())
            ref = cs.p20_mtnet_step(torch, copy.deepcopy(est.model).double(),
                                    x, y, "cpu", f64=True)
        est.model.load_state_dict(state)
        run = cs.p20_mtnet_step(torch, est.model, x, y, "cpu")
        out[dtype] = dict(zip(("loss", "output", "head_grad"),
                              cs.p19_against_f64(run, ref)))
        print(f"mtnet {dtype}: {out[dtype]}", flush=True)
    return out


def tcmf(np, series: int, cols: int, steps: int) -> dict:
    from analytics_zoo_tpu_torch.zouwu.model.tcmf import TCMFForecaster
    cs.P20_TCMF = (series, cols)
    y = cs.p20_panel(np, cols)
    t0 = time.perf_counter()
    m = TCMFForecaster(rank=cs.P20_TCMF_RANK, svd=True, device="cpu")
    f0, x0 = m._init_factors(y)
    svd_s = time.perf_counter() - t0
    m._init_factors = lambda _: (f0.copy(), x0.copy())
    t0 = time.perf_counter()
    mse = m._run_factorization(y, steps, None)
    f32_s = time.perf_counter() - t0
    ref = TCMFForecaster(rank=cs.P20_TCMF_RANK, device="cpu")
    ref._init_factors = lambda _: (f0.astype(np.float64),
                                   x0.astype(np.float64))
    t0 = time.perf_counter()
    mse64 = ref._run_factorization(y.astype(np.float64), steps, None)
    f64_s = time.perf_counter() - t0
    out = dict(series=series, cols=cols, steps=steps,
               F=float(np.abs(m.F - ref.F).max()),
               X=float(np.abs(m.X - ref.X).max()), mse=mse, mse_f64=mse64,
               svd_s=svd_s, fp32_s=f32_s, f64_s=f64_s)
    print(f"tcmf: {out}", flush=True)
    return out


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--part", choices=("mtnet", "tcmf", "all"),
                    default="all")
    ap.add_argument("--rows", type=int, default=cs.P20_CHECK_ROWS)
    ap.add_argument("--series", type=int, default=cs.P20_TCMF[0])
    ap.add_argument("--cols", type=int, default=cs.P20_TCMF[1])
    ap.add_argument("--steps", type=int, default=cs.P20_TCMF_STEPS)
    ap.add_argument("--threads", type=int, default=8)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    out = {}
    if args.part in ("mtnet", "all"):
        out["mtnet"] = mtnet(torch, np, args.rows)
    if args.part in ("tcmf", "all"):
        out["tcmf"] = tcmf(np, args.series, args.cols, args.steps)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
