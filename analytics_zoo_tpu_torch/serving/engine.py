"""Cluster Serving — the streaming inference loop.

Counterpart of the core loop of ``analytics_zoo_tpu/serving/engine.py``
(ref ClusterServing.scala:31): one serve thread reads records from the
broker stream through a consumer group, decodes their tensors in
``input_cols`` order, stacks and pads them to the batch bucket, launches
the batch on the model's device (``predict_async``) while it reads the
next one, fetches the result (``predict_fetch``), writes one result per
record to the result hash and acks the entries. A batch that fails gets
an error result for every record, so no client waits forever.

Generate records (a ``generate`` request on the record's side channel,
the encoder tensor plus a ``start`` tensor) go to one step-level
:class:`~analytics_zoo_tpu_torch.inference.decode_scheduler.
DecodeScheduler`, built at the first generate admission from the model's
``decode_step_fn`` and, where the model has one, its
``paged_decode_step_fn`` (the paged gather kernel then runs in every
step). Each serve-loop turn runs one wide decode step after the turn's
predict batch; a sequence's result and ack are written when it retires.
A record the page pool cannot hold yet stays un-acked and is admitted
again after a retirement. Every wide step pads to ``batch_size``, as
predict batches do.

There is no CPU failover: the model runs on its device or its records get
error results. Lease reclaim, priority lanes and decode preemption,
deadlines, admission control, adaptive buckets, per-request costs and the
telemetry hooks wait for later slices (ROADMAP A7).
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
from analytics_zoo_tpu_torch.inference import decode_scheduler, generation
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
        self._decode_sched: Optional[
            decode_scheduler.DecodeScheduler] = None
        # live sequence -> (uri, ack); generate entries the page pool could
        # not hold yet, oldest first
        self._gen_live: Dict = {}
        self._gen_waiting: List[tuple] = []
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
        acks, cmds = [], []
        uris, rows, gens = [], [], []
        for eid, payload in entries:
            ack = ("XACK", self.stream, self.group, str(eid))
            # one bad record must not take the batch down
            try:
                uri, inputs, g = schema.decode_record(payload, self.cipher,
                                                      with_generate=True)
                schema.validate_uri(uri)
            except Exception as e:
                logger.warning("dropping undecodable record %s: %s", eid, e)
                acks.append(ack)
                continue
            try:
                g = schema.validate_generate(g)
            except ValueError as e:
                cmds += self._error_cmds([uri], f"bad generate request: {e}")
                self._count_failed(1)
                acks.append(ack)
                continue
            if g is not None:
                gens.append((ack, uri, inputs, g))   # acked at retirement
                continue
            acks.append(ack)
            uris.append(uri)
            rows.append(inputs)
        if gens:
            self._admit_generate(client, gens)
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

    # ------------------------------------------------------- generate
    def _ensure_scheduler(self) -> decode_scheduler.DecodeScheduler:
        """The decode scheduler, built at the first generate admission
        with the JAX engine's sizing (the default seq-ladder top, the
        default draft window). A model with a paged step seam uses it, or
        this raises."""
        if self._decode_sched is None:
            if getattr(self.model, "decode_step_fn", None) is None:
                raise TypeError("the model has no decode_step_fn: generate "
                                "records need an encoder/decoder model")
            make_paged = getattr(self.model, "paged_decode_step_fn", None)
            self._decode_sched = decode_scheduler.DecodeScheduler(
                self.model.decode_step_fn(), max_batch=self.batch_size,
                max_seq=generation.DEFAULT_SEQ_RUNGS[1],
                batch_ladder=compile_ahead.BucketLadder(self.batch_size,
                                                        self.batch_size),
                paged_step_fn=None if make_paged is None else make_paged())
        return self._decode_sched

    def _admit_generate(self, client: BrokerClient, entries: List[tuple]):
        """Hand generate entries ``(ack, uri, inputs, g)`` to the decode
        scheduler. Malformed ones get an error result and their ack now;
        admitted ones keep their ack until the sequence retires; ones the
        page pool cannot hold yet wait, un-acked, for the next turn."""
        cmds, acks, back = [], [], []
        try:
            sched = self._ensure_scheduler()
        except Exception as e:
            for ack, uri, _, _ in entries:
                cmds += self._error_cmds([uri], f"generate failed: {e}")
                acks.append(ack)
            self._count_failed(len(entries))
            client.pipeline(cmds + acks)
            return
        for entry in entries:
            ack, uri, inputs, g = entry
            if "start" not in inputs or len(inputs) != 2:
                cmds += self._error_cmds(
                    [uri], "generate records carry exactly two inputs: the "
                    "encoder tensor and 'start'")
                self._count_failed(1)
                acks.append(ack)
                continue
            enc_col = next(k for k in sorted(inputs) if k != "start")
            try:
                seq = sched.admit(
                    np.asarray(inputs[enc_col]),
                    np.asarray(inputs["start"], np.float32), g["n"],
                    mode=g.get("m", "greedy"),
                    temperature=float(g.get("t", 1.0)), seed=g.get("s"),
                    tag=uri)
            except decode_scheduler.PagePoolExhausted:
                back.append(entry)
                continue
            except Exception as e:
                cmds += self._error_cmds(
                    [uri], f"generate admission failed: {e}")
                self._count_failed(1)
                acks.append(ack)
                continue
            self._gen_live[seq] = (uri, ack)
        self._gen_waiting = back + self._gen_waiting
        if cmds or acks:
            client.pipeline(cmds + acks)

    def _decode_tick(self, client: BrokerClient) -> int:
        """Admit the generate entries that wait for pages, then run one
        wide decode step and flush what retired. A step that raises gives
        every live sequence an error result."""
        if self._gen_waiting:
            waiting, self._gen_waiting = self._gen_waiting, []
            self._admit_generate(client, waiting)
        sched = self._decode_sched
        if sched is None or not sched.live:
            return 0
        try:
            finished = sched.step()
        except Exception as e:
            logger.error("decode step failed for %d sequences: %s",
                         sched.live, e)
            infos = [self._gen_live.pop(s) for s in sched.abort_all()
                     if s in self._gen_live]
            client.pipeline(
                self._error_cmds([u for u, _ in infos],
                                 f"generate failed: {e}")
                + [ack for _, ack in infos])
            self._count_failed(len(infos))
            return 0
        cmds, acks = [], []
        for seq in finished:
            uri, ack = self._gen_live.pop(seq)
            try:
                pred = seq.result
                if self.postprocess is not None:
                    pred = self.postprocess(pred)
                val = schema.encode_result(pred, self.cipher)
            except Exception as e:
                logger.warning("postprocess failed for %s: %s", uri, e)
                val = schema.encode_error(f"postprocess failed: {e}",
                                          self.cipher)
            cmds.append(("HSET", self.result_key, uri, val))
            acks.append(ack)
        if not acks:
            return 0
        with self._state_lock:
            self.records_out += len(acks)
        client.pipeline(cmds + acks)
        return len(acks)

    def _abort_decode(self):
        """Drop every live and waiting generation (reconnect, stop): their
        entries were never acked."""
        if self._decode_sched is not None:
            self._decode_sched.abort_all()
        self._gen_live.clear()
        self._gen_waiting = []

    def _serve_once(self, client: BrokerClient) -> int:
        """One loop turn: read and launch a batch; retire the batches the
        window pushes out, or all of them when the stream is idle; then
        one decode step."""
        decoding = bool(self._gen_live or self._gen_waiting)
        block_ms = 0 if (self._inflight or decoding) else self.block_ms
        produced = self._produce(client, block_ms)
        served = 0
        if produced is not None:
            self._launch(*produced)
            while len(self._inflight) > self.pipeline_window:
                served += self._finish(client)
        else:
            while self._inflight:
                served += self._finish(client)
        return served + self._decode_tick(client)

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
                self._abort_decode()
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
        # live generations do not run to the end on stop
        self._abort_decode()
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
        """Records served and failed, batches retired, and the decode
        scheduler's wide steps and paged steps (safe to poll from other
        threads)."""
        sched = self._decode_sched
        with self._state_lock:
            return {"records_out": self.records_out,
                    "records_failed": self.records_failed,
                    "batches": self.batches,
                    "decode_steps": 0 if sched is None else sched.steps_run,
                    "paged_steps": 0 if sched is None
                    else sched.paged_steps}

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
