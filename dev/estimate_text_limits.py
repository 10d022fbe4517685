#!/usr/bin/env python3
"""How far one training step of chip_smoke.py's phase 19 models sits from
the same step in float64, on the CPU: the basis of phase 19's limits
(P19_FP32_LIMITS, P19_BF16_LIMITS, P19_FC_RTOL).

    python3 dev/estimate_text_limits.py [--rows 8] [--threads 8]

For the TextClassifier's cnn, lstm and gru encoders (20 classes, 500 x
200-d, 256 wide, vocabulary 5000) on phase 19(a)'s first ``--rows`` rows,
and for KNRM (10 x 40 ids, 300-d, 21 kernels, vocabulary 30 000) on
19(d)'s, weights from phase 19's numpy seed and dropout off: one step in
fp32 and in bf16 (``mixed_bfloat16``) against the same step in float64,
as phase 19 reads the card's (``p19_step``, ``p19_against_f64``): the
loss's absolute difference, and the logits' and the head gradient's
distance over float64's norm. Then the forecasters of 19(g) at
bench.py's TCN batch: predict in fp32 and bf16 against float64, as the
norm of the difference over float64's norm. One JSON object on the last
line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=cs.P19_CHECK_ROWS)
    ap.add_argument("--threads", type=int, default=8)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    texts, labels = cs.p19_texts(np, cs.P19_TEXTS)
    _, ids, ys = cs.p19_pipeline(texts, labels, 4)
    kx, ky = cs.p19_knrm_data(np, cs.P19_KNRM_BATCH, cs.SEED + 20)
    out = {}
    for what in cs.P19_ENCODERS + ("knrm",):
        x, y = (kx, ky) if what == "knrm" else (ids, ys)
        x, y = x[:args.rows], y[:args.rows]
        state = cs.p19_model(np, what).model.module.state_dict()
        ref = cs.p19_step(torch, np, what, x, y, "cpu", state=state,
                          f64=True)
        row = {}
        for dtype in ("float32", "mixed_bfloat16"):
            run = cs.p19_step(torch, np, what, x, y, "cpu", dtype, state)
            row[dtype] = dict(zip(("loss", "logits", "head_grad"),
                                  cs.p19_against_f64(run, ref)),
                              rnn_dtypes=run["rnn_dtypes"])
            print(f"{what} {dtype}: {row[dtype]}", flush=True)
        out[what] = row
    from analytics_zoo_tpu_torch.zouwu.model.forecast import (
        LSTMForecaster, Seq2SeqForecaster,
    )
    x, _ = cs.tcn_bench_data(np)
    for name, make in (("lstm_forecaster", LSTMForecaster),
                       ("seq2seq_forecaster", Seq2SeqForecaster)):
        row, ref = {}, None
        for dtype in ("float32", "mixed_bfloat16"):
            f = make(dtype=dtype, device="cpu")
            est = f._ensure_est(x)
            cs.seeded_weights(est.model, cs.SEED)
            if ref is None:
                import copy
                net = copy.deepcopy(est.model).double().eval()
                with torch.no_grad():
                    ref = net(torch.from_numpy(x.astype(np.float64)))
            pred = f.predict(x, batch_size=len(x))
            row[dtype] = cs.p17_rel(torch.from_numpy(pred), ref)
        print(f"{name}: {row}", flush=True)
        out[name] = row
    print(json.dumps({"rows": args.rows, "distances": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
