"""Dogs-vs-cats transfer learning with a torch model (mirrors ref
apps/dogs-vs-cats: fine-tune a pretrained torch CNN on a small cats/dogs
set through the Orca estimator).

Here the "pretrained" torch CNN (conv/BN/dropout backbone; no download,
so its seeded weights stand in for a downloaded checkpoint) is run as it
is by ``Estimator.from_torch`` and fine-tuned on the device: train-mode
BatchNorm uses batch statistics and Dropout really drops, torch's
``.train()`` semantics. (The JAX example translates the module to a jax
function instead.)

The counterpart of examples/dogs_vs_cats_transfer.py. Runs on the card by default;
``--device cpu`` runs it on the host:

    python examples_torch/dogs_vs_cats_transfer.py [--device cpu]
"""

import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse

import numpy as np


def make_pets(n=256, seed=0):
    """Synthetic 16x16 RGB pets: 'cats' are bright in the red channel's
    upper half, 'dogs' in the blue channel's lower half, plus noise."""
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 3, 16, 16).astype(np.float32) * 0.4
    y = rng.randint(0, 2, n)
    for i in range(n):
        if y[i] == 0:
            x[i, 0, :8, :] += 0.8
        else:
            x[i, 2, 8:, :] += 0.8
    return x, y.astype(np.int32)


def build_torch_backbone():
    import torch
    import torch.nn as tnn
    torch.manual_seed(0)
    return tnn.Sequential(
        tnn.Conv2d(3, 8, 3, padding=1), tnn.BatchNorm2d(8), tnn.ReLU(),
        tnn.MaxPool2d(2),
        tnn.Conv2d(8, 16, 3, padding=1), tnn.BatchNorm2d(16), tnn.ReLU(),
        tnn.AdaptiveAvgPool2d(1), tnn.Flatten(),
        tnn.Dropout(0.2), tnn.Linear(16, 2))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args(argv).device

    from analytics_zoo_tpu_torch import init_orca_context, stop_orca_context
    from analytics_zoo_tpu_torch.learn.estimator import Estimator

    init_orca_context(cluster_mode="local", device=device)
    x, y = make_pets()
    split = 192
    model = build_torch_backbone()
    est = Estimator.from_torch(
        model=model, loss="sparse_categorical_crossentropy_logits",
        optimizer="adam", sample_input=x[:2], metrics=["accuracy"],
        device=device)
    est.fit((x[:split], y[:split]), epochs=8, batch_size=32)
    res = est.evaluate((x[split:], y[split:]), batch_size=32)
    print(f"dogs-vs-cats transfer: val accuracy {res['accuracy']:.2f}")
    assert res["accuracy"] > 0.85, "transfer learning failed to converge"
    stop_orca_context()


if __name__ == "__main__":
    main()
