"""Fraud detection (mirrors ref apps/fraud-detection: heavily imbalanced
binary classification over transaction features with resampling + a
neural classifier, evaluated by AUC/recall rather than accuracy).

Synthetic card transactions (0.5% fraud) flow through XShards for the
resampling ETL, train an MLP via the Estimator, and report AUC + recall
at a fixed false-positive budget.

The counterpart of examples/fraud_detection.py. Runs on the card by default;
``--device cpu`` runs it on the host:

    python examples_torch/fraud_detection.py [--device cpu]
"""

import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse

import numpy as np


def make_transactions(n=20000, fraud_rate=0.005, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 8).astype(np.float32)
    is_fraud = rng.rand(n) < fraud_rate
    # fraud skews a few feature directions
    x[is_fraud] += np.array([2.5, -1.5, 0, 2.0, 0, 0, -2.0, 0],
                            np.float32)
    return x, is_fraud.astype(np.int32)


def undersample(x, y, ratio=4, seed=0):
    """Keep all fraud rows + ratio x as many sampled legit rows (the
    reference's class-rebalancing step, done on shards there)."""
    from analytics_zoo_tpu_torch.data import XShards

    shards = XShards.partition({"x": x, "y": y}, num_shards=4)

    def sample_shard(s):
        rng = np.random.RandomState(seed)
        fraud = s["y"] == 1
        legit_idx = np.flatnonzero(~fraud)
        take = rng.choice(legit_idx, min(len(legit_idx),
                                         ratio * max(fraud.sum(), 1)),
                          replace=False)
        keep = np.concatenate([np.flatnonzero(fraud), take])
        rng.shuffle(keep)
        return {"x": s["x"][keep], "y": s["y"][keep]}

    out = shards.transform_shard(sample_shard).collect()
    return (np.concatenate([s["x"] for s in out]),
            np.concatenate([s["y"] for s in out]))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args(argv).device

    import torch
    import torch.nn as nn
    from analytics_zoo_tpu_torch import init_orca_context, stop_orca_context
    from analytics_zoo_tpu_torch.learn.estimator import Estimator

    init_orca_context(cluster_mode="local", device=device)
    x, y = make_transactions()
    split = 16000
    xb, yb = undersample(x[:split], y[:split])
    print(f"resampled train set: {len(yb)} rows, "
          f"{yb.mean():.1%} fraud (raw rate {y.mean():.2%})")

    class Net(nn.Module):
        # dropout is active in the estimator's training steps only (the
        # module's train mode), as flax's ``deterministic=not train``
        def __init__(self):
            super().__init__()
            self.dense1 = nn.Linear(8, 32)
            self.dropout = nn.Dropout(0.2)
            self.dense2 = nn.Linear(32, 16)
            self.out = nn.Linear(16, 2)

        def forward(self, x):
            h = self.dropout(torch.relu(self.dense1(x)))
            h = torch.relu(self.dense2(h))
            return self.out(h)

    torch.manual_seed(0)
    est = Estimator.from_torch(
        model=Net(), loss="sparse_categorical_crossentropy_logits",
        optimizer="adam", sample_input=x[:2], device=device)
    est.fit((xb, yb), epochs=10, batch_size=64)

    logits = torch.from_numpy(
        np.asarray(est.predict(x[split:], batch_size=512)))
    probs = torch.softmax(logits, -1).numpy()[:, 1]
    yt = y[split:]
    from analytics_zoo_tpu_torch.automl.metrics import Evaluator
    auc = Evaluator.evaluate("auc", yt, probs)
    # recall at the threshold flagging 1% of traffic
    thresh = np.quantile(probs, 0.99)
    flagged = probs >= thresh
    recall = (flagged & (yt == 1)).sum() / max((yt == 1).sum(), 1)
    print(f"fraud detection: AUC {auc:.3f}, "
          f"recall@1%FPR-budget {recall:.2f}")
    assert auc > 0.9, "fraud model failed to rank fraud above legit"
    stop_orca_context()


if __name__ == "__main__":
    main()
