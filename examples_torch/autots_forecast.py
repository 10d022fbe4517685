"""AutoTS forecasting (mirrors ref apps/automl + zouwu AutoTS usage):
AutoTSTrainer searches model/hp configs on a synthetic series, returns a
TSPipeline used for prediction and incremental fitting.

The counterpart of examples/autots_forecast.py. Runs on the card by default;
``--device cpu`` runs it on the host:

    python examples_torch/autots_forecast.py [--device cpu]
"""

import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse

import numpy as np
import pandas as pd


def make_df(n=600, seed=0):
    rng = np.random.RandomState(seed)
    ds = pd.date_range("2025-01-01", periods=n, freq="h")
    t = np.arange(n)
    y = 5 + np.sin(2 * np.pi * t / 24) * 2 + rng.randn(n) * 0.2
    return pd.DataFrame({"datetime": ds, "value": y})


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args(argv).device

    from analytics_zoo_tpu_torch import init_orca_context, stop_orca_context
    from analytics_zoo_tpu_torch.zouwu.autots.forecast import AutoTSTrainer
    from analytics_zoo_tpu_torch.zouwu.config.recipe import SmokeRecipe

    init_orca_context(cluster_mode="local", device=device)
    try:
        df = make_df()
        train, valid = df[:500], df[500:]
        trainer = AutoTSTrainer(dt_col="datetime", target_col="value",
                                horizon=1, device=device)
        pipeline = trainer.fit(train, valid, recipe=SmokeRecipe())
        pred = pipeline.predict(valid)
        print("forecast shape:", np.asarray(pred).shape)
        scores = pipeline.evaluate(valid, metrics=["mse", "smape"])
        print("evaluation:", {k: round(float(v), 4)
                              for k, v in scores.items()})
        pipeline.fit(valid, epochs=1)  # incremental fit on fresh data
        print("incremental fit OK")
    finally:
        stop_orca_context()


if __name__ == "__main__":
    main()
