"""Cluster Serving end-to-end on the PyTorch port (the counterpart of
examples/cluster_serving.py; ref docs/ClusterServingGuide quick start):
launch the native broker, serve a model, push records through InputQueue,
read results from OutputQueue and the HTTP frontend.

    python examples_torch/cluster_serving.py [--device cpu]
"""

import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import json
import urllib.request

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args(argv).device

    import torch
    import torch.nn as tnn
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.serving import (
        Broker, ClusterServing, FrontEnd, InputQueue, OutputQueue,
    )
    from analytics_zoo_tpu_torch.serving import schema

    torch.manual_seed(0)
    model = tnn.Sequential(tnn.Linear(8, 32), tnn.ReLU(),
                           tnn.Linear(32, 3), tnn.Softmax(dim=-1))
    im = InferenceModel(device=device).load_torch(
        model, np.zeros((1, 8), np.float32))
    rng = np.random.RandomState(0)

    with Broker.launch() as broker:
        print("broker backend:", broker.backend, "port:", broker.port)
        with ClusterServing(im, broker.port, batch_size=8).start() as engine:
            in_q = InputQueue(port=broker.port)
            out_q = OutputQueue(port=broker.port)
            # single-record path (interactive clients)
            in_q.enqueue("req-single", x=rng.randn(8).astype(np.float32))
            single = out_q.query("req-single", timeout=30.0)
            assert single is not None
            # pipelined batch path (bulk producers: one socket write for
            # all records, pipelined polling for the results)
            uris = in_q.enqueue_batch(
                (f"req-{k}", {"x": rng.randn(8).astype(np.float32)})
                for k in range(16))
            results = out_q.query_many(uris, timeout=30.0)
            assert all(v is not None for v in results.values())
            print("queue results:", {k: v.argmax() for k, v in
                                     list(results.items())[:4]})

            with FrontEnd(broker.port, engine=engine,
                          timeout=30.0).start() as fe:
                body = json.dumps({"inputs": {"x": schema.encode_tensor(
                    rng.randn(8).astype(np.float32))}}).encode()
                req = urllib.request.Request(
                    f"http://127.0.0.1:{fe.port}/predict", data=body)
                resp = json.loads(
                    urllib.request.urlopen(req, timeout=30).read())
                print("http result:",
                      schema.decode_tensor(resp["result"]).round(3))
            stats = engine.metrics()
            print("served:", stats["records_out"], "records; stage "
                  "latencies (ms):",
                  {k: round(v["mean_ms"], 1) for k, v in stats.items()
                   if isinstance(v, dict) and "mean_ms" in v})
            print("pipeline gauges:",
                  {k: round(v["mean"], 2) for k, v in stats.items()
                   if isinstance(v, dict) and "mean" in v})


if __name__ == "__main__":
    main()
