"""Cluster Serving from one ``config.yaml``: broker, engine and frontend.

The port's counterpart of ``docker/cluster-serving/start-serving.py`` (ref
the cluster-serving start scripts: Redis, the Flink job and the HTTP
frontend)::

    python -m analytics_zoo_tpu_torch.serving.start config.yaml [--device cpu]

- loads the model of ``model: path:`` (a ``save_model`` directory of
  either package) with ``InferenceModel(device=...)``, on ``cuda`` unless
  ``--device cpu``;
- with ``data: src:`` on this host, serves on the broker already
  answering there, else launches one there (``Broker.launch``, the native
  broker by default; ``--broker python`` for the Python one); a remote
  ``src`` names an existing shared broker and is only connected to;
- runs ``ClusterServing(model, port, batch_size=params: batch_size,
  stream=, result_key=)`` and a ``FrontEnd`` on ``HTTP_PORT`` (default
  8080; 0 picks a free port) bound to ``BIND_HOST`` (default 0.0.0.0),
  which advertises its port to the engine's fleet heartbeat; with
  ``data: record_encrypted: true`` both take ``cfg.build_cipher()``
  (keyed by ``ZOO_SERVING_SECRET``);
- prints ``serving up: broker <host>:<port> http :<port>`` and then
  ``replica <id>``, and stops on SIGTERM or SIGINT (drain, deregister,
  the broker it launched last).
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading
from typing import Optional, Sequence

LOCAL_HOSTS = ("127.0.0.1", "localhost", "0.0.0.0")


def _answers(host: str, port: int) -> bool:
    from analytics_zoo_tpu_torch.serving.broker import BrokerClient
    try:
        client = BrokerClient(host=host, port=port, timeout=2.0)
    except OSError:
        return False
    try:
        return client.ping()
    except (ConnectionError, OSError):
        return False
    finally:
        client.close()


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m analytics_zoo_tpu_torch.serving.start",
        description="Serve the model of a Cluster Serving config.yaml.")
    ap.add_argument("config", nargs="?", default="config.yaml")
    ap.add_argument("--device", default=None,
                    help="the model's device (default: cuda)")
    ap.add_argument("--broker", default="native",
                    choices=("native", "python", "auto"),
                    help="the broker to launch when none answers")
    args = ap.parse_args(argv)

    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.serving import (Broker, ClusterServing,
                                                 FrontEnd)
    from analytics_zoo_tpu_torch.serving.config import ServingConfig

    cfg = ServingConfig.load(args.config)
    model = InferenceModel(device=args.device).load(cfg.model_path)
    broker = None
    b_host, b_port = cfg.broker_host, cfg.broker_port
    if b_host in LOCAL_HOSTS:
        b_host = "127.0.0.1"
        if not _answers(b_host, b_port):
            broker = Broker.launch(port=b_port, backend=args.broker)
    cipher = cfg.build_cipher()
    serving = ClusterServing(model, b_port, batch_size=cfg.batch_size,
                             broker_host=b_host, stream=cfg.stream,
                             result_key=cfg.result_key,
                             image_preprocess=cfg.build_image_preprocess(),
                             cipher=cipher)
    front = FrontEnd(b_port, engine=serving, broker_host=b_host,
                     cipher=cipher,
                     host=os.environ.get("BIND_HOST", "0.0.0.0"),
                     port=int(os.environ.get("HTTP_PORT", "8080")))
    serving.start()
    front.start()
    print(f"serving up: broker {b_host}:{b_port} http :{front.port}",
          flush=True)
    print(f"replica {serving.replica_id}", flush=True)
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    stop.wait()
    serving.stop()
    front.stop()
    if broker is not None:
        broker.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
