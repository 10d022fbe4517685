"""Serving clients — InputQueue / OutputQueue.

Counterpart of ``analytics_zoo_tpu/serving/client.py`` (ref
pyzoo/zoo/serving/client.py: ``InputQueue:82`` with ``enqueue:144``,
``OutputQueue:234`` with ``query``): enqueue named tensors under a uri on a
priority lane, with an optional deadline or generate request, and poll the
result hash for the answer. Records carry the client's dual-clock stamp
(schema.py), which the engine reads as queue wait and end-to-end latency.
A lane that admission control is shedding raises :class:`ShedError` at
once, counted on ``zoo_serving_shed_total{stream,priority}``. Raw
encoded image bytes (``enqueue(uri, image=bytes)`` or ``enqueue_image``)
ride the record as an image entry, which the engine decodes and
preprocesses. ``InputQueue(arrow=True)`` writes the reference client's
Arrow records instead (pyarrow; they carry no side channel, so no
deadline or generate options), and ``cipher=`` (``common/encryption.
make_cipher``) encrypts every record and decrypts every result.
"""

from __future__ import annotations

import time
import uuid
from typing import Dict, Optional

import numpy as np

from analytics_zoo_tpu_torch.common import telemetry
from analytics_zoo_tpu_torch.serving import schema
from analytics_zoo_tpu_torch.serving.broker import BrokerClient, ShedError

INPUT_STREAM = "serving_stream"
RESULT_HASH = "result"

__all__ = ["InputQueue", "OutputQueue", "ShedError", "INPUT_STREAM",
           "RESULT_HASH"]


class InputQueue:
    def __init__(self, host: str = "127.0.0.1", port: int = 6399,
                 stream: str = INPUT_STREAM, cipher: schema.Cipher = None,
                 arrow: bool = False):
        """``arrow=True`` encodes records in the reference client's Arrow
        wire format (ref client.py:149 data_to_b64) instead of the native
        JSON tensors; the engine reads either."""
        self._client = BrokerClient(host, port)
        self.stream = stream
        self.cipher = cipher
        self.arrow = bool(arrow)
        self._tracer = telemetry.get_tracer()

    @staticmethod
    def _coerce(v):
        """An ndarray (string tensors too) passes through; raw encoded
        image bytes become an :class:`~analytics_zoo_tpu_torch.serving.
        schema.ImageBytes` entry, decoded and preprocessed by the engine
        (the reference client's image enqueue, client.py:144). File
        paths go through ``enqueue_image``: a blanket ``str -> open()``
        here would break string tensors and read arbitrary local
        files."""
        if isinstance(v, schema.ImageBytes):
            return v
        if isinstance(v, (bytes, bytearray)):
            return schema.ImageBytes(bytes(v))
        return np.asarray(v)

    def _shed_counter(self, priority: str):
        """Client-observed shed rejections: an XADD the broker refused
        never reaches the engine, so the client is the only process that
        can count it."""
        return telemetry.get_registry().counter(
            "zoo_serving_shed_total",
            "enqueues rejected by lane admission control",
            ("stream", "priority")).labels(self.stream, priority)

    def _encode(self, uri: Optional[str], inputs: Dict,
                priority: Optional[str] = None,
                deadline_ms: Optional[float] = None,
                generate: Optional[Dict] = None
                ) -> "tuple[str, str, Optional[tuple], str]":
        """(uri, payload, (t_enqueue, sampled), lane); the stamp is None
        for an Arrow record (its format has no side channel, so it takes
        a lane but no deadline or generate request)."""
        if not inputs:
            raise ValueError("enqueue needs at least one named tensor")
        lane = schema.validate_priority(priority)
        if deadline_ms is not None and deadline_ms <= 0:
            raise ValueError(f"deadline_ms must be > 0, got {deadline_ms}")
        gen = schema.validate_generate(generate)
        uri = schema.validate_uri(uri or uuid.uuid4().hex)
        if self.arrow:
            if gen is not None or deadline_ms is not None:
                raise ValueError(
                    "generate requests and deadlines need the native "
                    "record format: the Arrow format carries no side "
                    "channel")
            return uri, schema.encode_record_arrow(
                uri, {k: self._coerce(v) for k, v in inputs.items()},
                self.cipher), None, lane
        # dual-clock stamp: perf_counter is CLOCK_MONOTONIC on Linux
        # (comparable across processes on one host — the engine checks
        # plausibility before trusting it); t_wall is the cross-host
        # fallback
        sampled = self._tracer.should_sample()
        t_pc = time.perf_counter()
        trace = {"id": uri, "t_pc": t_pc, "t_wall": time.time(),
                 "s": int(sampled)}
        if lane != schema.DEFAULT_PRIORITY:
            trace["p"] = lane
        if deadline_ms is not None:
            trace["d"] = float(deadline_ms)
        if gen is not None:
            trace["g"] = gen
        payload = schema.encode_record(
            uri, {k: self._coerce(v) for k, v in inputs.items()},
            self.cipher, trace=trace)
        return uri, payload, (t_pc, sampled), lane

    def enqueue(self, uri: Optional[str] = None,
                priority: Optional[str] = None,
                deadline_ms: Optional[float] = None,
                generate: Optional[Dict] = None, **inputs) -> str:
        """``enqueue("rec1", x=ndarray)``; returns the uri (generated when
        not given). Multi-input models pass several named tensors.

        ``priority`` routes the record onto a broker lane
        (``schema.PRIORITIES``; default "default") and ``deadline_ms``
        bounds how stale a result is still useful — the engine stores an
        explicit expired error once it lapses.

        ``generate`` (``{"max_new_tokens": 16, "mode": "greedy",
        "temperature": 1.0, "seed": None}``, all optional) makes the
        record a generate request: it carries the encoder tensor and a
        ``start`` tensor (the decoder start sign), and the engine answers
        with the generated ``[steps, dim]`` sequence.

        ``priority``, ``deadline_ms`` and ``generate`` are therefore
        reserved and cannot name input tensors. Raises
        :class:`ShedError` at once when admission control is shedding the
        lane."""
        uri, payload, trace, lane = self._encode(uri, inputs, priority,
                                                 deadline_ms, generate)
        try:
            self._client.xadd(self.stream, payload, lane=lane)
        except ShedError:
            self._shed_counter(lane).inc()
            raise
        if trace is not None and trace[1]:
            self._tracer.record(uri, "client_enqueue", trace[0],
                                time.perf_counter())
        return uri

    def enqueue_image(self, uri: Optional[str] = None, image=None,
                      key: str = "image") -> str:
        """Enqueue one raw encoded image: bytes, or the path of a JPEG or
        PNG file (the reference client's image enqueue takes local file
        uris, client.py:144). The engine decodes it and runs its
        preprocessing chain."""
        if isinstance(image, str):
            with open(image, "rb") as f:
                image = f.read()
        if not isinstance(image, (bytes, bytearray, schema.ImageBytes)):
            raise TypeError("enqueue_image takes encoded image bytes or "
                            "a file path")
        return self.enqueue(uri, **{key: self._coerce(image)})

    def enqueue_batch(self, records, priority: Optional[str] = None,
                      deadline_ms: Optional[float] = None,
                      generate: Optional[Dict] = None) -> "list[str]":
        """Enqueue many ``(uri, {name: tensor, ...})`` records in pipelined
        socket writes (pass ``None`` as a uri to have one generated).
        ``priority`` / ``deadline_ms`` / ``generate`` apply to every
        record. A shedding lane raises :class:`ShedError` (earlier records
        of the batch may have been accepted; uris are returned only on full
        success). Returns the uris in order."""
        uris, cmds, traces = [], [], []
        lane = schema.validate_priority(priority)
        for uri, inputs in records:
            uri, payload, trace, _ = self._encode(uri, inputs, priority,
                                                  deadline_ms, generate)
            uris.append(uri)
            traces.append(trace)
            cmds.append(("XADD", self.stream, payload, lane))
        try:
            self._client.pipeline(cmds)
        except ShedError:
            self._shed_counter(lane).inc()
            raise
        t1 = time.perf_counter()
        for uri, trace in zip(uris, traces):
            if trace is not None and trace[1]:
                self._tracer.record(uri, "client_enqueue", trace[0], t1)
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
        ServingError` (an expired deadline its subclass
        ``DeadlineExpiredError``)."""
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
        deadline. An error result raises as ``query`` does."""
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


    def dequeue(self) -> Dict[str, np.ndarray]:
        """Drain all available results (ref OutputQueue.dequeue)."""
        out = {}
        for uri in self._client.hkeys(self.result_key):
            val = self._client.hget(self.result_key, uri)
            if val is not None and self._client.hdel(self.result_key, uri):
                out[uri] = schema.decode_result(val, self.cipher)
        return out

    def close(self):
        self._client.close()
