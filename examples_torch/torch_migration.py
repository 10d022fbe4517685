"""Bring-your-own-PyTorch on the PyTorch port (the counterpart of
examples/torch_migration.py; ref apps/pytorch): take a torch nn.Module,
train it through Estimator.from_torch, which runs the module itself, and
serve it with InferenceModel.

    python examples_torch/torch_migration.py [--device cpu]
"""

import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args(argv).device

    import torch
    import torch.nn as tnn
    from analytics_zoo_tpu_torch import init_orca_context, stop_orca_context
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.learn.estimator import Estimator

    init_orca_context(cluster_mode="local", device=device)
    try:
        torch.manual_seed(0)
        model = tnn.Sequential(
            tnn.Linear(10, 32), tnn.ReLU(),
            tnn.Linear(32, 32), tnn.ReLU(),
            tnn.Linear(32, 2))

        rng = np.random.RandomState(0)
        x = rng.randn(2048, 10).astype(np.float32)
        y = (x[:, :5].sum(1) > x[:, 5:].sum(1)).astype(np.int32)

        est = Estimator.from_torch(
            model=model, loss="sparse_categorical_crossentropy_logits",
            optimizer="adam", sample_input=x[:2], device=device)
        history = est.fit((x, y), epochs=5, batch_size=128)
        print("loss:", [round(v, 4) for v in history["loss"]])
        assert history["loss"][-1] < history["loss"][0]

        result = est.evaluate((x, y), batch_size=256)
        print("final eval loss:", round(result["loss"], 4))

        im = InferenceModel(concurrent_num=2, device=device).load_torch(
            model, x[:1])
        preds = im.predict_classes(x[:16], batch_size=8)
        print("served classes:", preds.tolist())
    finally:
        stop_orca_context()


if __name__ == "__main__":
    main()
