"""Serving clients — InputQueue / OutputQueue.

Counterpart of ``analytics_zoo_tpu/serving/client.py`` (ref
pyzoo/zoo/serving/client.py: ``InputQueue:82`` with ``enqueue:144``,
``OutputQueue:234`` with ``query``): enqueue named tensors under a uri,
poll the result hash for the answer; a ``generate`` request asks for an
autoregressive generation instead of one prediction. The telemetry hooks,
priorities, deadlines, images and the Arrow format wait for later slices.
"""

from __future__ import annotations

import time
import uuid
from typing import Dict, Optional

import numpy as np

from analytics_zoo_tpu_torch.serving import schema
from analytics_zoo_tpu_torch.serving.broker import BrokerClient

INPUT_STREAM = "serving_stream"
RESULT_HASH = "result"

__all__ = ["InputQueue", "OutputQueue", "INPUT_STREAM", "RESULT_HASH"]


class InputQueue:
    def __init__(self, host: str = "127.0.0.1", port: int = 6399,
                 stream: str = INPUT_STREAM, cipher: schema.Cipher = None):
        self._client = BrokerClient(host, port)
        self.stream = stream
        self.cipher = cipher

    def _encode(self, uri: Optional[str], inputs: Dict,
                generate: Optional[Dict] = None) -> "tuple[str, str]":
        if not inputs:
            raise ValueError("enqueue needs at least one named tensor")
        gen = schema.validate_generate(generate)
        uri = schema.validate_uri(uri or uuid.uuid4().hex)
        return uri, schema.encode_record(
            uri, {k: np.asarray(v) for k, v in inputs.items()}, self.cipher,
            generate=gen)

    def enqueue(self, uri: Optional[str] = None,
                generate: Optional[Dict] = None, **inputs) -> str:
        """``enqueue("rec1", x=ndarray)``; returns the uri (generated when
        not given). Multi-input models pass several named tensors.

        ``generate`` (``{"max_new_tokens": 16, "mode": "greedy",
        "temperature": 1.0, "seed": None}``, all optional) makes the
        record a generate request: it carries the encoder tensor and a
        ``start`` tensor (the decoder start sign), and the engine answers
        with the generated ``[steps, dim]`` sequence. ``generate`` is
        therefore reserved and cannot name an input tensor."""
        uri, payload = self._encode(uri, inputs, generate)
        self._client.xadd(self.stream, payload)
        return uri

    def enqueue_batch(self, records,
                      generate: Optional[Dict] = None) -> "list[str]":
        """Enqueue many ``(uri, {name: tensor, ...})`` records in pipelined
        socket writes (pass ``None`` as a uri to have one generated).
        ``generate`` applies to every record. Returns the uris in order."""
        uris, cmds = [], []
        for uri, inputs in records:
            uri, payload = self._encode(uri, inputs, generate)
            uris.append(uri)
            cmds.append(("XADD", self.stream, payload))
        self._client.pipeline(cmds)
        return uris

    def __len__(self):
        return self._client.xlen(self.stream)

    def close(self):
        self._client.close()


class OutputQueue:
    def __init__(self, host: str = "127.0.0.1", port: int = 6399,
                 result_key: str = RESULT_HASH, cipher: schema.Cipher = None):
        self._client = BrokerClient(host, port)
        self.result_key = result_key
        self.cipher = cipher

    def query(self, uri: str, timeout: float = 0.0,
              poll_interval: float = 0.01,
              delete: bool = False) -> Optional[np.ndarray]:
        """Result for ``uri`` or None. ``timeout > 0`` polls until then.
        ``delete=True`` removes the entry once fetched. An error result
        raises :class:`~analytics_zoo_tpu_torch.serving.schema.
        ServingError`."""
        deadline = time.monotonic() + timeout
        while True:
            val = self._client.hget(self.result_key, uri)
            if val is not None:
                if delete:
                    self._client.hdel(self.result_key, uri)
                return schema.decode_result(val, self.cipher)
            if time.monotonic() >= deadline:
                return None
            time.sleep(poll_interval)

    def query_many(self, uris, timeout: float = 0.0,
                   poll_interval: float = 0.01,
                   delete: bool = False) -> Dict[str, Optional[np.ndarray]]:
        """Results for many uris, polling with pipelined HGETs. Returns
        ``{uri: ndarray | None}``; None marks uris still unanswered at the
        deadline."""
        pending = list(dict.fromkeys(uris))
        out: Dict[str, Optional[np.ndarray]] = {u: None for u in pending}
        deadline = time.monotonic() + timeout
        while pending:
            vals = self._client.pipeline(
                ("HGET", self.result_key, u) for u in pending)
            hits = [(u, v) for u, v in zip(pending, vals) if v is not None]
            for u, v in hits:
                out[u] = schema.decode_result(v, self.cipher)
            if hits and delete:
                self._client.pipeline(
                    ("HDEL", self.result_key, u) for u, _ in hits)
            pending = [u for u in pending if out[u] is None]
            if not pending or time.monotonic() >= deadline:
                break
            time.sleep(poll_interval)
        return out

    def close(self):
        self._client.close()
