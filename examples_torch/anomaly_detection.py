"""Time-series anomaly detection (mirrors ref apps/anomaly-detection):
threshold + autoencoder detectors from zouwu on a synthetic NYC-taxi-like
series with injected anomalies.

The counterpart of examples/anomaly_detection.py. Runs on the card by default;
``--device cpu`` runs it on the host:

    python examples_torch/anomaly_detection.py [--device cpu]
"""

import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse

import numpy as np


def make_series(n=2000, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(n)
    y = 10 + 3 * np.sin(2 * np.pi * t / 48) + rng.randn(n) * 0.3
    anomaly_idx = rng.choice(n, 12, replace=False)
    y[anomaly_idx] += rng.choice([-8, 8], 12)
    return y, set(anomaly_idx.tolist())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args(argv).device

    from analytics_zoo_tpu_torch.zouwu.model.anomaly import (
        AEDetector, ThresholdDetector,
    )

    y, truth = make_series()
    # residual against a seasonal moving average — the usual forecast-based
    # threshold pattern (detector scores |y - y_pred|)
    kernel = np.ones(25) / 25
    smooth = np.convolve(y, kernel, mode="same")

    thd = ThresholdDetector(ratio=3.0)
    thd.fit(y, smooth)
    th_found = set(thd.anomaly_indexes(y, smooth).tolist())
    recall = len(th_found & truth) / len(truth)
    print(f"ThresholdDetector: {len(th_found)} anomalies, "
          f"recall {recall:.2f}")

    ae = AEDetector(roll_len=24, anomaly_ratio=0.01, epochs=3,
                    device=device)
    ae.fit(y)
    ae_found = set(ae.anomaly_indexes(y).tolist())
    ae_recall = len(ae_found & truth) / len(truth)
    print(f"AEDetector: {len(ae_found)} windows flagged, "
          f"recall {ae_recall:.2f}")
    assert recall >= 0.5, "threshold detector missed most anomalies"


if __name__ == "__main__":
    main()
