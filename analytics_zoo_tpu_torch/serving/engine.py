"""Cluster Serving — the streaming inference loop.

Counterpart of the core loop of ``analytics_zoo_tpu/serving/engine.py``
(ref ClusterServing.scala:31): one serve thread reads records from the
broker stream through a consumer group, decodes their tensors in
``input_cols`` order, stacks and pads them to the batch bucket, launches
the batch on the model's device (``predict_async``) while it reads the
next one, fetches the result (``predict_fetch``), writes one result per
record to the result hash and acks the entries. A batch that fails gets
an error result for every record, so no client waits forever.

There is no CPU failover: the model runs on its device or its records get
error results. Lease reclaim, priority lanes, admission control, adaptive
buckets, decode and the telemetry hooks wait for later slices.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
import uuid
from typing import Dict, List, Optional

import numpy as np

from analytics_zoo_tpu_torch.common import compile_ahead
from analytics_zoo_tpu_torch.serving import schema
from analytics_zoo_tpu_torch.serving.broker import BrokerClient
from analytics_zoo_tpu_torch.serving.client import INPUT_STREAM, RESULT_HASH

logger = logging.getLogger(__name__)


class ClusterServing:
    """The serving job.

    ``model``: a loaded InferenceModel (anything with ``predict_async`` /
    ``predict_fetch``). ``input_cols``: the order in which record tensors
    feed the model's inputs (default: sorted names). ``batch_size``: the
    most records one read takes; every batch pads to it. ``pipeline_window``:
    how many launched batches may be in flight while the loop reads the
    next (0 = fetch each batch before reading the next)."""

    def __init__(self, model, broker_port: int, batch_size: int = 8,
                 stream: str = INPUT_STREAM, result_key: str = RESULT_HASH,
                 group: str = "serving", consumer: Optional[str] = None,
                 input_cols: Optional[List[str]] = None,
                 cipher: schema.Cipher = None, postprocess=None,
                 block_ms: int = 50, broker_host: str = "127.0.0.1",
                 pipeline_window: int = 2):
        self.model = model
        self.broker_host = broker_host
        self.broker_port = int(broker_port)
        self.batch_size = int(batch_size)
        if self.batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.stream = stream
        self.result_key = result_key
        self.group = group
        self.consumer = consumer or f"serving-{uuid.uuid4().hex[:8]}"
        self.input_cols = list(input_cols) if input_cols else None
        self.cipher = cipher
        self.postprocess = postprocess
        self.block_ms = int(block_ms)
        self.pipeline_window = int(pipeline_window)
        self._state_lock = threading.Lock()
        self.records_out = 0
        self.records_failed = 0
        self.batches = 0
        self._inflight: collections.deque = collections.deque()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ----------------------------------------------------------- one batch
    def _error_cmds(self, uris, message: str) -> list:
        err = schema.encode_error(message, self.cipher)
        return [("HSET", self.result_key, uri, err) for uri in uris]

    def _produce(self, client: BrokerClient, block_ms: int):
        """Read and decode ONE batch. Returns ``(x, ctx)`` ready to launch,
        or None when nothing servable arrived (records that failed to
        decode are acked here; those with a known uri get an error)."""
        entries = client.xreadgroup(self.group, self.consumer, self.stream,
                                    self.batch_size, block_ms)
        if not entries:
            return None
        acks = [("XACK", self.stream, self.group, str(eid))
                for eid, _ in entries]
        uris, rows = [], []
        for eid, payload in entries:
            # one bad record must not take the batch down
            try:
                uri, inputs = schema.decode_record(payload, self.cipher)
                schema.validate_uri(uri)
            except Exception as e:
                logger.warning("dropping undecodable record %s: %s", eid, e)
                continue
            uris.append(uri)
            rows.append(inputs)
        cmds: list = []
        if rows:
            # batch by the majority shape signature; the rest get errors
            def sig(r):
                return tuple(sorted((k, np.shape(v)) for k, v in r.items()))
            counts = collections.Counter(sig(r) for r in rows)
            best = counts.most_common(1)[0][0]
            keep = [sig(r) == best for r in rows]
            for uri, r, k in zip(uris, rows, keep):
                if not k:
                    cmds += self._error_cmds(
                        [uri], f"tensor shapes {dict(best)} expected, got "
                        f"{ {n: np.shape(v) for n, v in r.items()} }")
            self._count_failed(len(keep) - sum(keep))
            uris = [u for u, k in zip(uris, keep) if k]
            rows = [r for r, k in zip(rows, keep) if k]
        x = None
        if rows:
            try:
                cols = self.input_cols or sorted(rows[0])
                batch = [np.stack([r[c] for r in rows]) for c in cols]
                batch = compile_ahead.pad_to_rung(batch, self.batch_size)
                x = batch[0] if len(batch) == 1 else tuple(batch)
            except Exception as e:      # e.g. an input_cols name missing
                cmds += self._error_cmds(uris, f"bad batch: {e}")
                self._count_failed(len(uris))
        if x is None:
            client.pipeline(cmds + acks)
            return None
        return x, (uris, cmds, acks)

    def _count_failed(self, n: int):
        with self._state_lock:
            self.records_failed += n

    def _launch(self, x, ctx):
        """Launch one batch; a launch that raises becomes that batch's
        error, reported when it retires."""
        try:
            pending, err = self.model.predict_async(x), None
        except Exception as e:
            pending, err = None, e
        self._inflight.append((pending, err, ctx))

    def _finish(self, client: BrokerClient) -> int:
        """Retire the oldest in-flight batch: results (or errors) + acks."""
        pending, err, (uris, cmds, acks) = self._inflight.popleft()
        n = len(uris)
        preds = None
        if err is None:
            try:
                preds = np.asarray(self.model.predict_fetch(pending))[:n]
            except Exception as e:
                err = e
        if err is not None:
            logger.error("inference failed for batch of %d: %s", n, err)
            client.pipeline(cmds + self._error_cmds(
                uris, f"inference failed: {err}") + acks)
            self._count_failed(n)
            return 0
        for uri, pred in zip(uris, preds):
            # a postprocess failure on ONE record must not discard the
            # batch's other results
            try:
                if self.postprocess is not None:
                    pred = self.postprocess(pred)
                val = schema.encode_result(pred, self.cipher)
            except Exception as e:
                logger.warning("postprocess failed for %s: %s", uri, e)
                val = schema.encode_error(f"postprocess failed: {e}",
                                          self.cipher)
            cmds.append(("HSET", self.result_key, uri, val))
        # count before the flush: a client that sees its result and then
        # reads metrics() must find the batch counted
        with self._state_lock:
            self.records_out += n
            self.batches += 1
        client.pipeline(cmds + acks)
        return n

    def _serve_once(self, client: BrokerClient) -> int:
        """One loop turn: read and launch a batch; retire the batches the
        window pushes out, or all of them when the stream is idle."""
        block_ms = 0 if self._inflight else self.block_ms
        produced = self._produce(client, block_ms)
        served = 0
        if produced is not None:
            self._launch(*produced)
            while len(self._inflight) > self.pipeline_window:
                served += self._finish(client)
        else:
            while self._inflight:
                served += self._finish(client)
        return served

    # ---------------------------------------------------------------- loop
    def _run(self):
        logger.info("serving started: stream=%s batch=%d window=%d",
                    self.stream, self.batch_size, self.pipeline_window)
        client: Optional[BrokerClient] = None
        while not self._stop.is_set():
            try:
                if client is None:
                    client = BrokerClient(host=self.broker_host,
                                          port=self.broker_port)
                self._serve_once(client)
            except OSError:
                # broker gone or socket bad: redial next round; launched
                # batches stay in flight and retire on the new connection
                if self._stop.is_set():
                    break
                logger.warning("broker connection lost; reconnecting")
                if client is not None:
                    client.close()
                    client = None
                time.sleep(0.2)
            except Exception:
                # the loop is the service — survive anything per batch
                logger.exception("serve step failed; continuing")
                time.sleep(0.05)
        # drain on stop: launched batches still flush results and acks
        try:
            while self._inflight and client is not None:
                self._finish(client)
        except Exception:
            logger.exception("final drain failed")
        if client is not None:
            client.close()

    # ----------------------------------------------------------------- api
    def start(self) -> "ClusterServing":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="zoo-serving")
        self._thread.start()
        return self

    def stop(self):
        """Stop reading, flush in-flight batches, join the serve thread."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None

    def metrics(self) -> Dict:
        """Records served and failed, batches retired (safe to poll from
        other threads)."""
        with self._state_lock:
            return {"records_out": self.records_out,
                    "records_failed": self.records_failed,
                    "batches": self.batches}

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
