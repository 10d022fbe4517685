"""AutoML hyperparameter search (mirrors ref apps/automl: AutoEstimator
over a model creator with an hp search space: concurrent Ray Tune
trials there, the port's local search engine here).

Searches an MLP regressor's width and learning rate on a noisy nonlinear
function, with hyperband-style early stopping, then verifies the restored
best model.

The counterpart of examples/automl_hp_search.py. Runs on the card by default;
``--device cpu`` runs it on the host:

    python examples_torch/automl_hp_search.py [--device cpu]
"""

import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import tempfile

import numpy as np


def make_data(n=512, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-2, 2, (n, 4)).astype(np.float32)
    y = (np.sin(x[:, :1] * 2) + 0.5 * x[:, 1:2] ** 2
         + 0.1 * rng.randn(n, 1)).astype(np.float32)
    return x, y


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args(argv).device

    import torch.nn as nn

    from analytics_zoo_tpu_torch.zouwu.model.nets import lecun_normal_
    from analytics_zoo_tpu_torch import init_orca_context, stop_orca_context
    from analytics_zoo_tpu_torch.automl import AutoEstimator, hp

    init_orca_context(cluster_mode="local", device=device)
    try:
        x, y = make_data()
        xv, yv = make_data(128, seed=1)

        def mlp_creator(config):
            # flax.linen.Dense's initial weights (lecun-normal kernels,
            # zero biases), so the trials start as the JAX example's do
            hidden = int(config["hidden"])
            mlp = nn.Sequential(nn.Linear(4, hidden), nn.ReLU(),
                                nn.Linear(hidden, hidden), nn.ReLU(),
                                nn.Linear(hidden, 1))
            for layer in mlp:
                if isinstance(layer, nn.Linear):
                    lecun_normal_(layer.weight, layer.in_features)
                    nn.init.zeros_(layer.bias)
            return mlp

        with tempfile.TemporaryDirectory() as logs:
            auto = AutoEstimator.from_torch(model_creator=mlp_creator,
                                            logs_dir=logs, name="mlp",
                                            device=device)
            auto.fit((x, y), validation_data=(xv, yv),
                     search_space={
                         "hidden": hp.grid_search([16, 64]),
                         "lr": hp.loguniform(3e-3, 3e-2),
                         "batch_size": 128,
                     },
                     n_sampling=2, epochs=8, metric="mse",
                     scheduler="hyperband")
            best = auto.get_best_config()
            print("best config:", {k: (round(v, 5) if isinstance(v, float)
                                       else v) for k, v in best.items()})
            model = auto.get_best_model()
            mse = model.evaluate(xv, yv, metrics=["mse"])["mse"]
            print("best model val mse:", round(float(mse), 5))
            # must clearly beat predicting the mean
            assert mse < 0.6 * float(np.var(yv)), \
                f"search failed to find a working config ({mse})"
    finally:
        stop_orca_context()


if __name__ == "__main__":
    main()
