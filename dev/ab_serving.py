#!/usr/bin/env python3
"""NCF serving of two checkouts in turns, on one GPU.

    python3 dev/ab_serving.py build/parent . [--rounds 2]

For each round and each checkout (a directory holding
``analytics_zoo_tpu_torch`` and ``chip_smoke.py``, e.g. an older commit
unpacked by ``git archive``), a fresh process runs chip_smoke.py's phase 5
workload with that checkout's package: NeuralCF at MovieLens-1M width
(weights from chip_smoke.py's seed, its 8000 rows), served by
``ClusterServing`` at batch 256 (the bucket pinned, no warm-up, where the
checkout's engine has those options) over the in-process Python broker:
a burst of 512 records (records/s) and 100 single requests (p50 ms), host
clock. Checkouts take turns within each round. Writes
chiprun_out/ab_serving.json and prints it with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r'''
import inspect, json, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
import chip_smoke as cs
from analytics_zoo_tpu_torch.inference import InferenceModel
from analytics_zoo_tpu_torch.models import NeuralCF
from analytics_zoo_tpu_torch.ops import _build
from analytics_zoo_tpu_torch.serving import (Broker, ClusterServing,
                                             InputQueue, OutputQueue)
_build.build(["embedding_bag"])
ncf = NeuralCF(**cs.NCF)
cs.seeded_weights(ncf.model.module, cs.SEED)
rng = np.random.RandomState(cs.SEED)
x = np.stack([rng.randint(1, cs.NCF["user_count"] + 1, cs.BATCH),
              rng.randint(1, cs.NCF["item_count"] + 1, cs.BATCH)],
             1).astype(np.float32)
im = InferenceModel(device="cuda").load_zoo(ncf)
im.predict(x, batch_size=cs.BATCH)
kw = {}
params = inspect.signature(ClusterServing.__init__).parameters
if "max_batch_size" in params:
    kw = dict(max_batch_size=cs.SERVE_BATCH, warmup=False)
with Broker.launch(backend="python") as broker, \
        ClusterServing(im, broker.port, batch_size=cs.SERVE_BATCH, **kw):
    iq, oq = InputQueue(port=broker.port), OutputQueue(port=broker.port)
    warm = iq.enqueue_batch((f"w{i}", {"x": x[i]}) for i in range(256))
    oq.query_many(warm, timeout=60, poll_interval=0.002)
    t0 = time.perf_counter()
    uris = iq.enqueue_batch((f"b{i}", {"x": x[i]})
                            for i in range(cs.N_BURST))
    got = oq.query_many(uris, timeout=120, poll_interval=0.002)
    burst_s = time.perf_counter() - t0
    lat = []
    for i in range(cs.N_SINGLE):
        t1 = time.perf_counter()
        u = iq.enqueue(f"s{i}", x=x[cs.N_BURST + i])
        oq.query(u, timeout=30, poll_interval=0.0005)
        lat.append(time.perf_counter() - t1)
assert all(v is not None for v in got.values())
print(json.dumps({"records_per_s": cs.N_BURST / burst_s,
                  "single_p50_ms": float(np.percentile(lat, 50)) * 1e3}))
'''


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    card = cs.card_line()
    cs.log(card)
    rows = {t: [] for t in args.trees}
    for r in range(args.rounds):
        order = args.trees if r % 2 == 0 else args.trees[::-1]
        for tree in order:
            out = subprocess.run(
                [sys.executable, "-c", CHILD, os.path.abspath(tree)],
                check=True, capture_output=True, text=True, timeout=900,
                cwd=os.path.abspath(tree))
            rows[tree].append(json.loads(out.stdout.strip().splitlines()[-1]))
            cs.log(f"round {r} {tree}: {rows[tree][-1]}")
    result = {"card": card, "runs": rows}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "ab_serving.json"),
              "w") as fh:
        json.dump(result, fh, indent=1)
    print(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
