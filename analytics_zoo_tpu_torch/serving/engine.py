"""Cluster Serving — stream in, batch, inference on the card, result out.

Counterpart of ``analytics_zoo_tpu/serving/engine.py`` (ref
ClusterServing.scala:31): one serve thread reads records from the broker
stream through a consumer group, decodes their tensors in ``input_cols``
order, stacks and pads them to a rung of the batch-bucket ladder, launches
the batch on the model's device (``predict_async``) while it reads the
next one (common/pipeline_io.py's bounded in-flight window), fetches the
result (``predict_fetch``), writes one result per record to the result
hash and acks the entries. A batch that fails gets an error result for
every record, so no client waits forever.

Scheduling and delivery, as in the JAX package:

- **Lanes.** Records carry a priority lane (``schema.PRIORITIES``). Reads
  are lane-ordered by a weighted-deficit schedule
  (``ZOO_SERVING_LANE_WEIGHTS``, default interactive 4, default 2, batch
  1) with starvation protection; a partial bucket accumulates up to
  ``ZOO_SERVING_MAX_WAIT_MS`` per lane (default 0: every read dispatches)
  and dispatches early when a member's deadline slack runs out.
- **Deadlines.** A record whose ``deadline_ms`` lapsed gets a typed
  expired result and its ack (``zoo_serving_expired_total``): every
  enqueue ends as a result, an expired result or a shed.
- **Leases.** The consumer defaults to a replica id, so engines sharing a
  group split the stream; a periodic reclaim sweep (``XCLAIM``, lane
  ordered) takes over entries whose lease (``claim_min_idle_ms``,
  ``ZOO_SERVING_LEASE_MS``) lapsed at a dead peer; an entry-id dedupe
  ring, reset when the broker connection is redialed, makes redelivery
  idempotent; ``stop`` flushes and acks every batch it launched.
- **Admission.** A tick (``ZOO_SERVING_ADMISSION_S``) reads the per-lane
  SLO burn (common/slo.py) and flips the broker's ``XSHED`` flag of the
  batch lane, so new batch enqueues fail fast while interactive flows.
- **Adaptive buckets.** Sustained full reads grow the bucket one rung,
  only onto a rung the model reports ready (``rung_ready``); sustained
  idle shrinks it. With ``warmup`` the whole ladder warms at ``start()``
  off the serve thread (``InferenceModel.warm_up``; ``ZOO_WARMUP_BUCKETS``
  caps the rungs, 0 disables).
- **Generate records** (a ``generate`` request, the encoder tensor plus a
  ``start`` tensor) go to one step-level
  :class:`~analytics_zoo_tpu_torch.inference.decode_scheduler.
  DecodeScheduler` sized off the ladder and ``max_batch_size`` (with
  ``draft_model`` / ``spec_k`` for speculative decode). Each serve-loop
  turn runs one wide step, which yields to a waiting encode lane that
  outranks the decoding lanes (``zoo_decode_preemptions_total``) at most
  ``DECODE_STARVATION_FLOOR`` times in a row. A model with a paged step
  seam uses it (the paged gather kernel then runs in every step); a paged
  seam that fails to build raises, it is not swallowed.
- **Telemetry.** Counters, gauges and histograms under the JAX package's
  names and labels (common/telemetry.py), per-uri stage spans (queue
  wait, dequeue, preprocess, device, postprocess), per-request cost
  histograms, and ``metrics()`` with the JAX package's keys.
  ``ZOO_FLIGHT_RECORDER=1`` arms the flight recorder at ``start()``
  (common/profiling.py).
- **The fleet.** With ``ZOO_FLEET_HEARTBEAT_S > 0`` (default 2 s)
  ``start()`` heartbeats this replica's record (id, the frontend's
  advertised host and port, wall-clock stamps, records out) into the
  broker's ``fleet_replicas`` hash (common/fleet.py), so any frontend
  lists and scrapes it, and runs a ``ReplicaSupervisor`` that classifies
  pending entries of consumers with no live heartbeat as orphans and
  runs this replica's next lease sweep at once. ``stop()`` drains and
  acks before the heartbeat deregisters.

- **Image records.** A record entry of raw encoded image bytes
  (``InputQueue.enqueue_image``) is decoded on the host (PIL) at intake
  and run through ``image_preprocess`` (an ndarray -> ndarray chain:
  ``image_pipeline("resnet-50", source=...)`` from a preset, or
  config.yaml's ``preprocessing:`` section), then batched as a tensor
  record. An undecodable image, or a host without PIL, gives the record
  a typed error result; the loop serves on.

- **Backend loss.** A batch or decode step that fails with a lost
  device (``resilience.is_backend_loss``) feeds
  ``resilience.note_backend_loss``: the backend supervisor, where one
  runs (``start()`` starts it when a fault plan is armed, as JAX's engine
  does), moves ok -> suspect -> wedged and dumps the flight recorder
  once an episode. It only reports: the records get error results.

There is no CPU failover: ``ZOO_CPU_FALLBACK=1`` raises at construction.
"""

from __future__ import annotations

import collections
import logging
import os
import threading
import time
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from analytics_zoo_tpu_torch.common import compile_ahead, fleet, profiling, \
    resilience, slo, telemetry, timeseries
from analytics_zoo_tpu_torch.common.pipeline_io import (  # noqa: F401
    Completed,
    DevicePipeline,
    StageTimer,
)
from analytics_zoo_tpu_torch.inference import decode_scheduler, generation
from analytics_zoo_tpu_torch.serving import schema
from analytics_zoo_tpu_torch.serving.broker import BrokerClient
from analytics_zoo_tpu_torch.serving.client import INPUT_STREAM, RESULT_HASH

logger = logging.getLogger(__name__)


def _parse_lane_map(raw: str, defaults: Dict[str, float]) -> Dict[str, float]:
    """Per-lane float knob: ``"40"`` applies to every lane,
    ``"interactive=5,batch=250"`` sets named lanes (unnamed lanes keep
    their default). Malformed parts raise — a silently ignored scheduling
    knob is worse than a failure at construction."""
    out = dict(defaults)
    raw = (raw or "").strip()
    if not raw:
        return out
    if "=" not in raw:
        v = float(raw)
        return {k: v for k in out}
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        k, _, v = part.partition("=")
        out[k.strip()] = float(v)
    return out


def ndarray_chain(pipe):
    """A ChainedPreprocessing over ImageFeature dicts as a plain ndarray
    -> ndarray callable, the engine's ``image_preprocess`` contract (one
    definition for the config-driven and the preset-driven paths)."""
    def run(arr):
        return pipe.transform({"image": np.asarray(arr, np.float32)}
                              )["image"]
    return run


def image_pipeline(model_name: str, source: str = "imagenet"):
    """The ndarray -> ndarray chain of a model's preprocessing preset
    (ref ImagenetConfig's preprocessors feeding PreProcessing.scala), for
    ``ClusterServing(image_preprocess=)``. ``source="torchvision"`` is
    the normalization trained into torchvision checkpoints (with
    ``ImageClassifier(pretrained=)``)."""
    from analytics_zoo_tpu_torch.models.image.imageclassification. \
        image_classifier import preprocessor
    return ndarray_chain(preprocessor(model_name, source=source))


def _cpu_fallback_requested() -> bool:
    return os.environ.get("ZOO_CPU_FALLBACK", "").lower() in (
        "1", "true", "yes", "on")


class ClusterServing:
    """The serving job (ref ClusterServing.scala:31).

    ``model``: a loaded InferenceModel (or anything with ``predict_async``
    / ``predict_fetch``, or a blocking ``predict``). ``input_cols``: the
    order in which record tensors feed the model's inputs (default: sorted
    names). ``batch_size``: the starting bucket (snapped to a rung);
    ``max_batch_size`` (default 4x) caps backlog growth and
    ``min_batch_size`` (default ``batch_size``) bounds idle shrinking; set
    ``max_batch_size=batch_size`` to pin the bucket. ``pipeline_window``:
    how many launched batches may be in flight while the loop reads the
    next (0 = fetch each batch before reading the next). ``warmup``: warm
    the ladder's rungs at ``start()`` (models with ``warm_up``).
    ``consumer`` defaults to ``replica_id``, itself a fresh id by default.
    ``image_preprocess``: the ndarray -> ndarray chain applied to image
    records after the engine decodes them (ref PreProcessing.scala:36,
    67-90); without it a decoded image feeds the model as it is.
    """

    #: consecutive full dequeues that count as "sustained backlog"
    BACKLOG_GROW_AFTER = 8
    #: consecutive under-half-full dequeues before stepping DOWN one rung
    IDLE_SHRINK_AFTER = 32
    #: max entries one reclaim sweep claims (overflow feeds _claim_backlog)
    RECLAIM_BATCH = 256
    #: finished-entry-id ring size for the redelivery dedupe
    DEDUPE_WINDOW = 65536
    #: safety margin subtracted from a record's deadline when computing
    #: the partial-bucket dispatch trigger
    SLACK_MARGIN_S = 0.005
    #: the lane admission control sheds
    ADMISSION_LANE = "batch"
    #: consecutive preempted decode ticks before a step runs regardless
    DECODE_STARVATION_FLOOR = 4
    #: count-shaped buckets for the step/page cost histograms
    COST_COUNT_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0,
                          256.0, 512.0, 1024.0, 4096.0)

    def __init__(self, model, broker_port: int, batch_size: int = 8,
                 stream: str = INPUT_STREAM, result_key: str = RESULT_HASH,
                 group: str = "serving", consumer: Optional[str] = None,
                 input_cols: Optional[List[str]] = None,
                 cipher: schema.Cipher = None,
                 postprocess=None, block_ms: int = 50,
                 claim_min_idle_ms: Optional[int] = None,
                 reclaim_interval_s: Optional[float] = None,
                 broker_host: str = "127.0.0.1",
                 image_preprocess=None,
                 pipeline_window: int = 2,
                 max_batch_size: Optional[int] = None,
                 min_batch_size: Optional[int] = None,
                 warmup: bool = True,
                 replica_id: Optional[str] = None,
                 draft_model=None, spec_k: int = 4):
        if _cpu_fallback_requested():
            raise ValueError("ZOO_CPU_FALLBACK=1: the port has no CPU "
                             "failover (its backend supervisor only "
                             "reports); unset it")
        if int(batch_size) < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.model = model
        self.batch_size = int(batch_size)
        self.pipeline_window = int(pipeline_window)
        self.max_batch_size = int(max_batch_size) if max_batch_size \
            else 4 * self.batch_size
        self.min_batch_size = int(min_batch_size) if min_batch_size \
            else self.batch_size
        # the ladder spans shrink floor -> growth cap; the starting bucket
        # snaps to a rung so every dispatch shape is a ladder shape
        self.ladder = compile_ahead.BucketLadder(
            min(self.min_batch_size, self.batch_size),
            max(self.max_batch_size, self.batch_size))
        self.batch_size = self.ladder.rung_for(self.batch_size)
        self._full_streak = 0
        self._idle_streak = 0
        # ZOO_WARMUP_BUCKETS: 0 disables the warm-up, N caps the rung
        # count (smallest first), unset warms the whole ladder
        raw = os.environ.get("ZOO_WARMUP_BUCKETS", "").strip()
        self._warmup_enabled = bool(warmup) and raw != "0"
        limit = int(raw) if raw.isdigit() and int(raw) > 0 else None
        self._warm_rungs = self.ladder.rungs if limit is None \
            else self.ladder.rungs[:limit]
        self._warm_kicked = False
        self._decode_warm_thread: Optional[threading.Thread] = None
        self.broker_host = broker_host
        self.broker_port = int(broker_port)
        self.stream, self.result_key = stream, result_key
        self.replica_id = replica_id or fleet.default_replica_id(stream)
        self.group = group
        self.consumer = consumer or self.replica_id
        self.input_cols = list(input_cols) if input_cols else None
        self.cipher = cipher
        self.image_preprocess = image_preprocess
        self.postprocess = postprocess
        self.block_ms = int(block_ms)
        # --- lanes
        self.max_wait_ms = _parse_lane_map(
            os.environ.get("ZOO_SERVING_MAX_WAIT_MS", ""),
            {lane: 0.0 for lane in schema.PRIORITIES})
        self.lane_weights = _parse_lane_map(
            os.environ.get("ZOO_SERVING_LANE_WEIGHTS", ""),
            {"interactive": 4.0, "default": 2.0, "batch": 1.0})
        self._lane_credit: Dict[str, float] = {
            lane: 0.0 for lane in schema.PRIORITIES}
        self._lanes_priority = ",".join(schema.PRIORITIES)
        # the assembly bucket: decoded records waiting to fill a batch —
        # (entry_id, uri, inputs, queue_meta, lane, t_arrive, t_deadline,
        #  gen) where gen is the normalized generate request or None
        self._asm: List[tuple] = []
        # ZOO_SERVING_DECODE_MAX_SEQ > 0: the warm-up also runs the decode
        # shapes up to this many positions (InferenceModel.warm_decode),
        # and the scheduler's page pool is sized for it
        raw = os.environ.get("ZOO_SERVING_DECODE_MAX_SEQ", "").strip()
        self._decode_max_seq = int(raw) if raw else 0
        self._decode_sched: Optional[
            decode_scheduler.DecodeScheduler] = None
        self._draft_model = draft_model
        self._spec_k = int(spec_k)
        # live sequence -> (uri, ack_cmd, queue-wait meta, lane, conn_gen)
        self._gen_live: Dict = {}
        self._decode_yield_streak = 0
        # --- admission control
        raw = os.environ.get("ZOO_SERVING_ADMISSION_S", "").strip()
        self._admission_interval_s = float(raw) if raw else 1.0
        self._last_admission = 0.0
        self.admission_shedding = False
        self._admission_dirty = False
        self.records_expired = 0
        # --- leases
        if claim_min_idle_ms is None:
            raw = os.environ.get("ZOO_SERVING_LEASE_MS", "").strip()
            claim_min_idle_ms = int(raw) if raw else 30000
        self.claim_min_idle_ms = int(claim_min_idle_ms)
        if reclaim_interval_s is None:
            raw = os.environ.get("ZOO_SERVING_RECLAIM_S", "").strip()
            reclaim_interval_s = float(raw) if raw \
                else max(0.5, self.claim_min_idle_ms / 2000.0)
        self._claim_interval_s = float(reclaim_interval_s)
        self._last_claim = 0.0
        # the replica supervisor's "sweep now" signal to the serve thread
        self._reclaim_asap = threading.Event()
        self._claim_backlog: Deque[Tuple[int, str, str]] = \
            collections.deque()
        # entry-id dedupe ring: ids in flight or finished by THIS consumer
        # are dropped on re-arrival (serve thread only)
        self._inflight_ids: set = set()
        self._done_ids: "collections.OrderedDict[int, None]" = \
            collections.OrderedDict()
        # broker connection generation: a redial invalidates the ring (a
        # restarted broker reuses entry ids from 1)
        self._conn_gen = 0
        self._seen_client_gen = 0
        self.timer = StageTimer()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # bumped on the serve thread, read from metrics() on any thread
        self._state_lock = threading.Lock()
        self.records_out = 0
        self.records_failed = 0
        self.batches = 0
        self.records_redelivered = 0
        self.lease_reclaims = 0
        self._tracer = telemetry.get_tracer()
        self._register_metrics(telemetry.get_registry(), stream)
        # --- the fleet: where peers scrape this replica (set by its
        # frontend; port 0 = headless), its heartbeat and supervisor
        self._advertise = ("127.0.0.1", 0)
        self._started_wall = 0.0
        self._heartbeater: Optional[fleet.Heartbeater] = None
        self._replica_supervisor: Optional[fleet.ReplicaSupervisor] = None
        #: the backend supervisor this engine started (a fault drill's)
        self._supervisor: Optional[resilience.BackendSupervisor] = None

    def _register_metrics(self, reg, stream: str):
        self._rec_counter = reg.counter(
            "zoo_serving_records_total",
            "Records with a flushed result", ("stream",)).labels(stream)
        self._err_counter = reg.counter(
            "zoo_serving_record_errors_total",
            "Records that got an error result", ("stream",)).labels(stream)
        self._batch_gauge = reg.gauge(
            "zoo_serving_batch_bucket",
            "Current adaptive compile-bucket batch size",
            ("stream",)).labels(stream)
        self._batch_gauge.set(self.batch_size)
        self._wait_hist = reg.histogram(
            "zoo_queue_wait_seconds",
            "Broker queue wait: client enqueue to engine dequeue",
            ("stream",)).labels(stream)
        lat = reg.histogram(
            "zoo_serving_latency_seconds",
            "End-to-end record latency: client enqueue to result flush",
            ("stream", "priority"))
        self._latency_hist = {lane: lat.labels(stream, lane)
                              for lane in schema.PRIORITIES}
        exp = reg.counter(
            "zoo_serving_expired_total",
            "Records whose deadline_ms lapsed before inference; each got "
            "an explicit expired result", ("stream", "priority"))
        self._expired_counter = {lane: exp.labels(stream, lane)
                                 for lane in schema.PRIORITIES}
        depth = reg.gauge(
            "zoo_serving_lane_depth",
            "Broker queue depth per priority lane",
            ("stream", "priority"))
        self._lane_depth_gauge = {lane: depth.labels(stream, lane)
                                  for lane in schema.PRIORITIES}
        self._admission_gauge = reg.gauge(
            "zoo_serving_admission_state",
            "1 while admission control is shedding the batch lane",
            ("stream", "priority")).labels(stream, self.ADMISSION_LANE)
        self._redeliver_counter = reg.counter(
            "zoo_serving_redelivered_total",
            "Entries re-delivered via lease reclaim (XCLAIM)",
            ("stream",)).labels(stream)
        self._reclaim_counter = reg.counter(
            "zoo_serving_lease_reclaims_total",
            "Reclaim sweeps that claimed at least one expired lease",
            ("stream",)).labels(stream)
        self._preempt_counter = reg.counter(
            "zoo_decode_preemptions_total",
            "Decode scheduler steps deferred because a waiting encode "
            "lane outranked the live decode lanes on the weighted-"
            "deficit schedule", ("stream",)).labels(stream)
        # per-request cost, settled when a record's result flushes: an
        # encode record its share of the batch's device time, a generate
        # record its share of every wide step it rode, its steps and the
        # KV pages it held
        cost_dev = reg.histogram(
            "zoo_request_cost_device_seconds",
            "Device-seconds attributed to one record at settlement",
            ("stream", "priority", "kind"))
        cost_steps = reg.histogram(
            "zoo_request_cost_decode_steps",
            "Decode steps one generate record consumed",
            ("stream", "priority", "kind"), buckets=self.COST_COUNT_BUCKETS)
        cost_pages = reg.histogram(
            "zoo_request_cost_kv_pages",
            "KV cache pages one generate record held at retirement",
            ("stream", "priority", "kind"), buckets=self.COST_COUNT_BUCKETS)
        self._cost_device_hist = {
            (lane, kind): cost_dev.labels(stream, lane, kind)
            for lane in schema.PRIORITIES
            for kind in ("encode", "generate")}
        self._cost_steps_hist = {
            lane: cost_steps.labels(stream, lane, "generate")
            for lane in schema.PRIORITIES}
        self._cost_pages_hist = {
            lane: cost_pages.labels(stream, lane, "generate")
            for lane in schema.PRIORITIES}

    # --------------------------------------------------- lane scheduling
    def _lane_order(self) -> str:
        """Comma-joined lane preference for the next read — weighted-
        deficit scheduling. Each lane accrues one credit per record it got
        served; the lane with the lowest credit/weight ratio reads first.
        Under contention lanes converge on their weight shares, and a lane
        that has been skipped drifts to the lowest ratio and reads next —
        batch work always drains."""
        ratios = {lane: self._lane_credit.get(lane, 0.0)
                  / max(self.lane_weights.get(lane, 1.0), 1e-9)
                  for lane in schema.PRIORITIES}
        base = min(ratios.values())
        if base > 0:
            # renormalize so the minimum ratio is 0: credits stay bounded
            # without changing the relative order
            for lane in self._lane_credit:
                self._lane_credit[lane] = max(
                    0.0, self._lane_credit[lane] - base
                    * max(self.lane_weights.get(lane, 1.0), 1e-9))
        order = sorted(schema.PRIORITIES,
                       key=lambda l: (ratios[l],
                                      schema.PRIORITIES.index(l)))
        return ",".join(order)

    def _asm_trigger(self) -> float:
        """perf_counter time at which the assembly bucket must dispatch
        even partially filled: the oldest member's lane max-wait cap,
        tightened by any member whose deadline slack is about to run out.
        With the default max-wait of 0 this is the arrival time itself."""
        t = float("inf")
        for _eid, _uri, _inputs, _m, lane, t_arr, t_deadline, _g \
                in self._asm:
            t = min(t, t_arr + self.max_wait_ms.get(lane, 0.0) / 1000.0)
            if t_deadline is not None:
                t = min(t, max(t_arr, t_deadline - self.SLACK_MARGIN_S))
        return t

    def _expire_record(self, uri: str, lane: str, cmds: list):
        """A record's ``deadline_ms`` lapsed before inference: store an
        explicit typed expired result (the client's poll raises
        DeadlineExpiredError) and count it per lane, apart from errors."""
        cmds.append(("HSET", self.result_key, uri, schema.encode_error(
            "deadline_ms expired before the engine served the record",
            self.cipher, code="expired")))
        self._expired_counter.get(
            lane, self._expired_counter[schema.DEFAULT_PRIORITY]).inc()
        with self._state_lock:
            self.records_expired += 1

    def _count_failed(self, n: int = 1):
        if n > 0:
            self._err_counter.inc(n)
            with self._state_lock:
                self.records_failed += n

    def _decode_images(self, inputs):
        """Each image entry decoded (``transforms.decode_rgb``: PIL on the
        host) and run through ``image_preprocess`` (ref
        PreProcessing.scala:67-90: bytes -> image -> resize, crop,
        normalize -> tensor); other entries as they are."""
        from analytics_zoo_tpu_torch.feature.image.transforms import (
            decode_rgb,
        )
        out = {}
        for k, v in inputs.items():
            if isinstance(v, schema.ImageBytes):
                arr = np.asarray(decode_rgb(v.data), np.float32)
                if self.image_preprocess is not None:
                    arr = self.image_preprocess(arr)
                v = np.asarray(arr, np.float32)
            out[k] = v
        return out

    def _error(self, uri: str, message: str, cmds: list):
        cmds.append(("HSET", self.result_key, uri,
                     schema.encode_error(message, self.cipher)))
        self._count_failed(1)

    # --------------------------------------------------------------- loop
    def _produce(self, client: BrokerClient, block_ms: int):
        """Host stage: dequeue, decode, stack and pad ONE batch. Returns
        ``(x, ctx)`` ready to launch, or None when nothing servable
        arrived (records that end here flush their result and ack here).

        Decoded records accumulate in the assembly bucket ``_asm``; it
        dispatches when full, when the oldest member has waited out its
        lane's max-wait, or when a member's deadline slack runs out. Reads
        and reclaims are lane-ordered."""
        t_dq0 = time.perf_counter()
        entries = []
        room = max(0, self.batch_size - len(self._asm))
        if self._claim_backlog:
            while self._claim_backlog and len(entries) < room:
                entries.append(self._claim_backlog.popleft())
        elif self._reclaim_asap.is_set() or \
                t_dq0 - self._last_claim >= self._claim_interval_s:
            self._reclaim_asap.clear()
            self._last_claim = t_dq0
            # lane-ordered reclaim: a dead peer's interactive entries
            # re-deliver before its batch-lane entries
            claimed = client.xclaim(self.stream, self.group, self.consumer,
                                    self.claim_min_idle_ms,
                                    self.RECLAIM_BATCH,
                                    lanes=self._lanes_priority)
            if claimed:
                self._redeliver_counter.inc(len(claimed))
                self._reclaim_counter.inc()
                with self._state_lock:
                    self.records_redelivered += len(claimed)
                    self.lease_reclaims += 1
                logger.warning("lease reclaim: %d orphaned entries "
                               "re-delivered to %s", len(claimed),
                               self.consumer)
                entries = claimed[:room]
                self._claim_backlog.extend(claimed[room:])
        if not entries and room > 0:
            eff_block = block_ms
            if self._asm:
                # an armed bucket bounds the blocking read
                left_ms = (self._asm_trigger() - t_dq0) * 1000.0
                eff_block = int(min(block_ms, max(0.0, left_ms)))
            entries = client.xreadgroup(self.group, self.consumer,
                                        self.stream, room, eff_block,
                                        lanes=self._lane_order())
        # the client may have redialed inside xclaim/xreadgroup: the peer
        # may be a restarted broker reusing entry ids, so the dedupe ring
        # resets before it classifies this read's ids
        cgen = getattr(client, "generation", 0)
        if cgen != self._seen_client_gen:
            self._seen_client_gen = cgen
            self._reset_delivery_state()
        if entries:
            fresh, stale_acks = [], []
            for eid, lane, payload in entries:
                if eid in self._done_ids:
                    stale_acks.append(
                        ("XACK", self.stream, self.group, str(eid)))
                elif eid not in self._inflight_ids:
                    self._inflight_ids.add(eid)
                    fresh.append((eid, lane, payload))
            if stale_acks:
                client.pipeline(stale_acks)
            entries = fresh
        read_n = len(entries)
        t_dq1 = time.perf_counter()
        if read_n:
            self.timer.record("dequeue", t_dq1 - t_dq0)

        t0 = time.perf_counter()
        term_cmds: list = []
        term_acks: list = []
        for eid, lane, payload in entries:
            ack = ("XACK", self.stream, self.group, str(eid))
            # one bad record (corrupt b64, wrong cipher, bad uri) must not
            # take the batch or the loop down
            try:
                uri, inputs, meta = schema.decode_record_meta(
                    payload, self.cipher)
                schema.validate_uri(uri)
            except Exception as e:
                logger.warning("dropping undecodable record %s: %s", eid, e)
                term_acks.append(ack)
                continue
            try:
                inputs = self._decode_images(inputs)
            except Exception as e:
                # the uri is known: the client gets a typed error result
                # (an image that does not decode, a host without PIL)
                self._error(uri, f"image decode failed: {e}", term_cmds)
                term_acks.append(ack)
                continue
            try:
                missing = sorted({(v.kind, v.package) for v in
                                  inputs.values() if isinstance(
                                      v, schema.UnsupportedInput)})
                if missing:
                    self._error(uri, "; ".join(
                        f"{kind} records need the {pkg} package, which "
                        "this host lacks" for kind, pkg in missing),
                        term_cmds)
                    term_acks.append(ack)
                    continue
                m = self._queue_wait(meta, t_dq1)
                t_deadline = None
                d = meta.get("d") if isinstance(meta, dict) else None
                if isinstance(d, (int, float)) and d > 0 and m is not None:
                    t_deadline = m[0] + d / 1000.0
                if t_deadline is not None and t_dq1 >= t_deadline:
                    self._expire_record(uri, lane, term_cmds)
                    term_acks.append(ack)
                    continue
                try:
                    g = schema.validate_generate(
                        meta.get("g") if isinstance(meta, dict) else None)
                except ValueError as e:
                    self._error(uri, f"bad generate request: {e}",
                                term_cmds)
                    term_acks.append(ack)
                    continue
                self._lane_credit[lane] = \
                    self._lane_credit.get(lane, 0.0) + 1.0
                self._asm.append((eid, uri, inputs, m, lane, t_dq1,
                                  t_deadline, g))
            except Exception as e:
                # the eid is in flight but not settled: end the record
                # here rather than strand it
                logger.exception("record intake failed for %s", eid)
                self._error(uri, f"record intake failed: {e}", term_cmds)
                term_acks.append(ack)
        if term_acks or term_cmds:
            client.pipeline(term_cmds + term_acks)
            self._mark_done(term_acks, self._conn_gen)

        now = time.perf_counter()
        if not self._asm:
            if read_n == 0:
                # an empty poll with an empty bucket is the strongest idle
                # signal there is
                self._grow_batch_on_backlog(0)
            return None
        if len(self._asm) < self.batch_size and now < self._asm_trigger():
            return None                          # keep accumulating
        take = self._asm[:self.batch_size]
        self._asm = self._asm[self.batch_size:]
        self._grow_batch_on_backlog(len(take))

        gen_take = [e for e in take if e[7] is not None]
        if gen_take:
            take = [e for e in take if e[7] is None]
            self._admit_generate(client, gen_take)
            if not take:
                return None

        err_cmds: list = []
        ack_cmds = []
        uris, rows, metas = [], [], []
        for eid, uri, inputs, m, lane, _t_arr, t_deadline, _g in take:
            ack_cmds.append(("XACK", self.stream, self.group, str(eid)))
            if t_deadline is not None and now >= t_deadline:
                self._expire_record(uri, lane, err_cmds)
                continue
            uris.append(uri)
            rows.append(inputs)
            metas.append((m, lane))
        if rows:
            # batch by the majority shape signature — one malformed record
            # must not reject the whole batch
            def sig(r):
                return tuple(sorted((k, np.shape(v)) for k, v in r.items()))
            counts = collections.Counter(sig(r) for r in rows)
            best = counts.most_common(1)[0][0]
            kept = [sig(r) == best for r in rows]
            for uri, r, k in zip(uris, rows, kept):
                if not k:
                    self._error(
                        uri, f"tensor shapes {dict(best)} expected, got "
                        f"{ {n: np.shape(v) for n, v in r.items()} }",
                        err_cmds)
            uris = [u for u, k in zip(uris, kept) if k]
            rows = [r for r, k in zip(rows, kept) if k]
            metas = [m for m, k in zip(metas, kept) if k]
        x = None
        if rows:
            try:
                cols = self.input_cols or sorted(rows[0])
                batch = [np.stack([r[c] for r in rows]) for c in cols]
                # pad to the nearest rung at or below the current bucket
                # (zoo_bucket_pad_fraction is the waste)
                rung = min(self.ladder.rung_for(len(rows)), self.batch_size)
                batch = list(compile_ahead.pad_to_rung(batch, rung,
                                                       site="serving"))
                x = batch[0] if len(batch) == 1 else tuple(batch)
            except Exception as e:      # e.g. an input_cols name missing
                for uri in uris:
                    self._error(uri, f"bad batch: {e}", err_cmds)
        if x is None:
            client.pipeline(err_cmds + ack_cmds)
            self._mark_done(ack_cmds, self._conn_gen)
            return None
        t_pp1 = time.perf_counter()
        self.timer.record("preprocess", t_pp1 - t0)
        trace = (t_dq0, t_dq1, t0, t_pp1) \
            if self._tracer.should_sample() else None
        return x, (uris, err_cmds, ack_cmds, len(rows), trace, metas,
                   self._conn_gen)

    def _reset_delivery_state(self):
        """The broker connection changed: entry ids of the old one mean
        nothing now. Un-acked entries re-deliver through their lease."""
        self._conn_gen += 1
        self._inflight_ids.clear()
        self._done_ids.clear()
        self._claim_backlog.clear()
        self._asm.clear()
        self._abort_decode()

    def _mark_done(self, ack_cmds, gen: int):
        """Move a flushed batch's entry ids from in-flight to the bounded
        done ring (serve thread only). ``gen`` guards against a batch
        that straddled a broker reconnect poisoning the fresh ring."""
        if gen != self._conn_gen:
            return
        for c in ack_cmds:
            eid = int(c[3])
            self._inflight_ids.discard(eid)
            self._done_ids[eid] = None
        while len(self._done_ids) > self.DEDUPE_WINDOW:
            self._done_ids.popitem(last=False)

    def _queue_wait(self, meta, t_dq1: float):
        """One record's broker queue wait from its client stamp:
        ``(t_enqueue_on_this_clock, wait_s)`` or None (no stamp). The
        ``perf_counter`` stamp (CLOCK_MONOTONIC, comparable across
        processes on one host) is used when the delta is plausible
        (0..1h); otherwise the wall-clock stamp, clamped at 0."""
        if not isinstance(meta, dict) or not meta:
            return None
        wait = None
        t_pc = meta.get("t_pc")
        if isinstance(t_pc, (int, float)):
            d = t_dq1 - float(t_pc)
            if 0.0 <= d < 3600.0:
                wait = d
        if wait is None:
            t_wall = meta.get("t_wall")
            if isinstance(t_wall, (int, float)):
                wait = min(max(0.0, time.time() - float(t_wall)), 3600.0)
        if wait is None:
            return None
        self._wait_hist.observe(wait)
        return (t_dq1 - wait, wait)

    # --------------------------------------------------- adaptive buckets
    def _grow_batch_on_backlog(self, dequeued: int):
        """Adaptive bucket stepping, both directions. Every dequeue coming
        back full steps up one rung after ``BACKLOG_GROW_AFTER`` turns,
        but only onto a rung the model reports ready: an unready rung pins
        the streak and kicks its warm-up instead of paying the first-touch
        costs on the serve thread. Sustained under-half-full dequeues
        step back down after ``IDLE_SHRINK_AFTER`` turns."""
        if dequeued >= self.batch_size:
            self._full_streak += 1
            self._idle_streak = 0
        elif dequeued * 2 < self.batch_size:
            self._full_streak = 0
            self._idle_streak += 1
        else:
            self._full_streak = 0
            self._idle_streak = 0
        if (self._full_streak >= self.BACKLOG_GROW_AFTER
                and self.batch_size < self.max_batch_size):
            nxt = self.ladder.up(self.batch_size)
            if not self._rung_ready(nxt):
                self._full_streak = self.BACKLOG_GROW_AFTER
                self._warm_rung(nxt)
                return
            self._set_bucket(nxt, "sustained backlog")
        elif (self._idle_streak >= self.IDLE_SHRINK_AFTER
                and self.batch_size > self.min_batch_size):
            self._set_bucket(self.ladder.down(self.batch_size),
                             "sustained idle")

    def _set_bucket(self, rung: int, why: str):
        self.batch_size = int(rung)
        self._full_streak = 0
        self._idle_streak = 0
        self.timer.record_value("batch_size", self.batch_size)
        self._batch_gauge.set(self.batch_size)
        logger.info("%s: batch bucket -> %d", why, self.batch_size)

    def _rung_ready(self, rung: int) -> bool:
        """Whether growing onto ``rung`` is stall-free. Models without
        ``rung_ready`` and engines without warm-up always read ready."""
        fn = getattr(self.model, "rung_ready", None)
        if fn is None or not self._warmup_enabled:
            return True
        try:
            return bool(fn(rung))
        except Exception:
            return True

    def _warm_rung(self, rung: int):
        """Kick a background warm-up of one rung (growth found it cold,
        e.g. ``ZOO_WARMUP_BUCKETS`` capped the first warm-up)."""
        fn = getattr(self.model, "warm_up", None)
        if fn is not None:
            try:
                fn(rungs=(rung,))
            except Exception:
                logger.debug("rung %d warm-up kick failed", rung,
                             exc_info=True)

    def _kick_warmup(self) -> bool:
        """Attach the ladder to the model and start the background warm-up
        over ``self._warm_rungs``. Returns False (and stays re-kickable
        from the serve loop) only when the model supports warm-up but
        cannot describe its inputs yet."""
        set_ladder = getattr(self.model, "set_ladder", None)
        warm_up = getattr(self.model, "warm_up", None)
        if set_ladder is None or warm_up is None:
            self._warm_kicked = True
            return False
        try:
            set_ladder(self.ladder)
            has_spec = getattr(self.model, "has_warm_spec", None)
            if has_spec is not None and not has_spec():
                return False
            warm_up(rungs=list(self._warm_rungs))
            self._kick_decode_warmup()
            self._warm_kicked = True
            return True
        except Exception:
            logger.exception("ladder warm-up failed; serving continues "
                             "with first touches in band")
            self._warm_kicked = True
            return False

    def _kick_decode_warmup(self):
        """With ``ZOO_SERVING_DECODE_MAX_SEQ`` > 0, also run every decode
        shape (batch rung x seq rung, and the paged step on a pool sized
        as the scheduler will size it) on a background thread."""
        if self._decode_max_seq <= 0:
            return
        fn = getattr(self.model, "warm_decode", None)
        if fn is None:
            return
        kw = {}
        if hasattr(self.model, "paged_decode_step_fn"):
            kw["paged_pool"] = (
                decode_scheduler.default_pool_pages(
                    self.max_batch_size, self._decode_max_seq,
                    spec_k=self._spec_k),
                generation.DEFAULT_SEQ_RUNGS[0])
        t = fn(self._decode_max_seq, rungs=list(self._warm_rungs),
               verify_k=(self._spec_k if self._draft_model is not None
                         else 0), block=False, **kw)
        if t is not None:
            compile_ahead.register_warmup_thread(t)
            self._decode_warm_thread = t

    def wait_warm(self, timeout: Optional[float] = None
                  ) -> "ClusterServing":
        """Block until the background warm-up finishes (no-op for models
        without ``wait_warm``)."""
        t0 = time.monotonic()
        fn = getattr(self.model, "wait_warm", None)
        if fn is not None:
            fn(timeout=timeout)
        t = self._decode_warm_thread
        if t is not None:
            t.join(None if timeout is None
                   else max(0.0, timeout - (time.monotonic() - t0)))
        return self

    def _dispatch(self, x):
        """Device stage: non-blocking when the model supports it; other
        models fall back to their blocking predict."""
        fn = getattr(self.model, "predict_async", None)
        return fn(x) if fn is not None else self.model.predict(x)

    def _fetch(self, pending):
        fn = getattr(self.model, "predict_fetch", None)
        return np.asarray(fn(pending) if fn is not None else pending)

    # --------------------------------------------- step-level decode
    def _ensure_scheduler(self) -> decode_scheduler.DecodeScheduler:
        """The persistent step scheduler, built at the first generate
        admission: the page pool sizes off this engine's ladder and
        ``max_batch_size`` and the decode seq grid
        (``ZOO_SERVING_DECODE_MAX_SEQ``, else the default seq-ladder
        top). A model with a paged step seam uses it, or this raises."""
        if self._decode_sched is None:
            if getattr(self.model, "decode_step_fn", None) is None:
                raise TypeError("the model has no decode_step_fn: generate "
                                "records need an encoder/decoder model")
            draft_fn = None
            if self._draft_model is not None:
                draft_fn = (self._draft_model.decode_step_fn()
                            if hasattr(self._draft_model, "decode_step_fn")
                            else self._draft_model)
            make_paged = getattr(self.model, "paged_decode_step_fn", None)
            sched = decode_scheduler.DecodeScheduler(
                self.model.decode_step_fn(),
                max_batch=self.max_batch_size,
                max_seq=(self._decode_max_seq
                         or generation.DEFAULT_SEQ_RUNGS[1]),
                batch_ladder=self.ladder,
                draft_fn=draft_fn, spec_k=self._spec_k,
                paged_step_fn=None if make_paged is None else make_paged())
            # published under the lock: decode_state() reads it from the
            # HTTP thread
            with self._state_lock:
                self._decode_sched = sched
        return self._decode_sched

    def _admit_generate(self, client: BrokerClient, entries: List[tuple]):
        """Hand assembled generate records to the step scheduler. Expired
        or malformed ones flush a typed result and their ack now; admitted
        ones park their ack in ``_gen_live`` until the sequence retires;
        one the page pool cannot hold yet goes back to the bucket's head,
        un-acked, to retry after the next retirement."""
        term_cmds: list = []
        term_acks: list = []
        try:
            sched = self._ensure_scheduler()
        except Exception as e:
            for entry in entries:
                self._error(entry[1], f"generate failed: {e}", term_cmds)
                term_acks.append(("XACK", self.stream, self.group,
                                  str(entry[0])))
            client.pipeline(term_cmds + term_acks)
            self._mark_done(term_acks, self._conn_gen)
            return
        now = time.perf_counter()
        back: list = []
        for entry in entries:
            eid, uri, inputs, m, lane, _t_arr, t_deadline, g = entry
            ack = ("XACK", self.stream, self.group, str(eid))
            if t_deadline is not None and now >= t_deadline:
                self._expire_record(uri, lane, term_cmds)
                term_acks.append(ack)
                continue
            if "start" not in inputs or len(inputs) != 2:
                self._error(uri, "generate records carry exactly two "
                            "inputs: the encoder tensor and 'start'",
                            term_cmds)
                term_acks.append(ack)
                continue
            enc_col = next(k for k in sorted(inputs) if k != "start")
            try:
                seq = sched.admit(
                    np.asarray(inputs[enc_col]),
                    np.asarray(inputs["start"], np.float32),
                    int(g.get("n", 16)), mode=g.get("m", "greedy"),
                    temperature=float(g.get("t", 1.0)), seed=g.get("s"),
                    tag=uri, lane=lane,
                    trace_uri=(uri if self._tracer.should_sample()
                               else None))
            except decode_scheduler.PagePoolExhausted:
                back.append(entry)
                continue
            except Exception as e:
                self._error(uri, f"generate admission failed: {e}",
                            term_cmds)
                term_acks.append(ack)
                continue
            self._gen_live[seq] = (uri, ack, m, lane, self._conn_gen)
        if back:
            self._asm = back + self._asm
        if term_acks or term_cmds:
            client.pipeline(term_cmds + term_acks)
            self._mark_done(term_acks, self._conn_gen)

    def _decode_should_yield(self) -> bool:
        """Per-step lane preemption on the read schedule's own order:
        defer this decode step when records WAITING in the assembly
        bucket belong to a lane with a strictly lower credit/weight ratio
        than every decoding lane. The starvation floor runs a step after
        ``DECODE_STARVATION_FLOOR`` consecutive deferrals."""
        if self._decode_yield_streak >= self.DECODE_STARVATION_FLOOR:
            return False
        if not self._asm or not self._gen_live:
            return False

        def ratio(lane):
            return (self._lane_credit.get(lane, 0.0)
                    / max(self.lane_weights.get(lane, 1.0), 1e-9))

        waiting = min(ratio(e[4]) for e in self._asm)
        live = min(ratio(info[3]) for info in self._gen_live.values())
        return waiting < live

    def _decode_tick(self, client: BrokerClient) -> int:
        """One serve-loop turn's decode slice: run (or preempt) one
        scheduler step and flush what finished. A step that raises gives
        every live sequence an error result."""
        sched = self._decode_sched
        if sched is None or not sched.live:
            return 0
        if self._decode_should_yield():
            self._decode_yield_streak += 1
            self._preempt_counter.inc()
            return 0
        self._decode_yield_streak = 0
        try:
            finished = sched.step()
        except Exception as e:
            logger.error("decode step failed for %d sequences: %s",
                         sched.live, e)
            resilience.note_backend_loss(e)
            infos = [self._gen_live.pop(s) for s in sched.abort_all()
                     if s in self._gen_live]
            cmds, acks = [], []
            for uri, ack, _m, _lane, gen in infos:
                if gen == self._conn_gen:
                    self._error(uri, f"generate failed: {e}", cmds)
                    acks.append(ack)
            client.pipeline(cmds + acks)
            self._mark_done(acks, self._conn_gen)
            return 0
        return self._finish_decode(client, finished)

    def _finish_decode(self, client: BrokerClient, finished) -> int:
        """Flush retired sequences: postprocess, typed result, held-back
        ack, latency on the record's lane and its cost."""
        if not finished:
            return 0
        cmds: list = []
        acks: list = []
        settled = []
        t1 = time.perf_counter()
        for seq in finished:
            info = self._gen_live.pop(seq, None)
            if info is None:
                continue
            uri, ack, m, lane, gen = info
            if gen != self._conn_gen:
                # admitted before a broker reconnect: the record
                # re-delivers through its lease
                continue
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
            settled.append((m, lane, uri, seq))
        if not acks:
            return 0
        n = len(acks)
        # count before the flush: a client that sees its result and then
        # reads metrics() must find it counted
        with self._state_lock:
            self.records_out += n
        self._rec_counter.inc(n)
        for m, lane, uri, seq in settled:
            ex = uri if seq.trace_uri is not None else None
            lane_key = lane if lane in self._cost_steps_hist \
                else schema.DEFAULT_PRIORITY
            if m is not None:
                self._latency_hist[lane_key].observe(
                    max(0.0, t1 - m[0]), exemplar=ex)
            self._cost_device_hist[(lane_key, "generate")].observe(
                max(0.0, seq.device_s), exemplar=ex)
            self._cost_steps_hist[lane_key].observe(seq.generated)
            self._cost_pages_hist[lane_key].observe(seq.pages_held)
        client.pipeline(cmds + acks)
        self._mark_done(acks, self._conn_gen)
        return n

    def _abort_decode(self):
        """Broker reconnect or shutdown: drop every live sequence (pages
        free at once, held-back acks are discarded; the un-acked entries
        re-deliver through their lease)."""
        if self._decode_sched is not None and self._decode_sched.live:
            self._decode_sched.abort_all()
        self._gen_live.clear()
        self._decode_yield_streak = 0

    # ------------------------------------------------------------ retire
    def _finish(self, client: BrokerClient, comp: Completed) -> int:
        """Drain stage: postprocess and the result/ack flush of one
        retired batch."""
        uris, err_cmds, ack_cmds, n, trace, metas, gen = comp.ctx
        if comp.error is not None:
            # every record gets an error result and its entry is acked; a
            # lost device is failure evidence for the supervisor
            logger.error("inference failed for batch of %d: %s",
                         n, comp.error)
            resilience.note_backend_loss(comp.error)
            err = schema.encode_error(f"inference failed: {comp.error}",
                                      self.cipher)
            client.pipeline(
                err_cmds
                + [("HSET", self.result_key, uri, err) for uri in uris]
                + ack_cmds)
            self._mark_done(ack_cmds, gen)
            self.timer.record("inference_error", comp.inflight_s)
            self._count_failed(n)
            return 0
        self.timer.record("inference", comp.inflight_s)
        preds = np.asarray(comp.result)[:n]
        t0 = time.perf_counter()
        cmds = list(err_cmds)
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
        t_pp_end = time.perf_counter()
        self.timer.record("postprocess", t_pp_end - t0)
        # count before the flush: a client that sees its result and then
        # reads metrics() must find the batch counted
        with self._state_lock:
            self.records_out += n
            self.batches += 1
        self._rec_counter.inc(n)
        dev_share = max(0.0, comp.inflight_s) / max(1, n)
        for (m, lane), uri in zip(metas, uris):
            ex = uri if trace is not None else None
            lane_key = lane if lane in self._latency_hist \
                else schema.DEFAULT_PRIORITY
            if m is not None:
                self._latency_hist[lane_key].observe(
                    max(0.0, t_pp_end - m[0]), exemplar=ex)
            self._cost_device_hist[(lane_key, "encode")].observe(
                dev_share, exemplar=ex)
        if trace is not None:
            self._record_batch_trace(uris, trace, comp, t0, t_pp_end, metas)
        client.pipeline(cmds + ack_cmds)
        self._mark_done(ack_cmds, gen)
        return n

    def _record_batch_trace(self, uris, trace, comp: Completed,
                            t_post0: float, t_post1: float, metas):
        """The sampled batch's stage stamps as per-uri spans: ``serve``
        (dequeue start to postprocess end) over ``dequeue``,
        ``preprocess``, ``device`` (with ``dispatch`` inside) and
        ``postprocess``, plus ``queue_wait`` from the client's stamp."""
        t_dq0, t_dq1, t_pp0, t_pp1 = trace
        tr = self._tracer
        for uri, (m, _lane) in zip(uris, metas):
            if m is not None:
                tr.record(uri, "queue_wait", m[0], t_dq1)
            tr.record(uri, "dequeue", t_dq0, t_dq1, parent="serve")
            tr.record(uri, "preprocess", t_pp0, t_pp1, parent="serve")
            tr.record(uri, "dispatch", comp.t_submit,
                      comp.t_submit + comp.dispatch_s, parent="device")
            tr.record(uri, "device", comp.t_submit,
                      comp.t_submit + comp.inflight_s, parent="serve")
            tr.record(uri, "postprocess", t_post0, t_post1, parent="serve")
            tr.record(uri, "serve", t_dq0, t_post1)

    def _serve_once(self, client: BrokerClient,
                    pipe: Optional[DevicePipeline] = None) -> int:
        """One loop turn: the admission tick, produce a batch and launch
        it; retire the batches the window pushed out (or all of them when
        the stream idles); then one decode step."""
        self._admission_tick(client)
        if pipe is None:                         # direct call
            pipe = self._make_pipe()
            done = []
            produced = self._produce(client, self.block_ms)
            if produced is not None:
                done = pipe.submit(*produced)
            done += pipe.drain()
            return (sum(self._finish(client, c) for c in done)
                    + self._decode_tick(client))
        decode_live = (self._decode_sched is not None
                       and self._decode_sched.live > 0)
        block_ms = 0 if (pipe.in_flight or decode_live) else self.block_ms
        produced = self._produce(client, block_ms)
        if produced is not None:
            done = pipe.submit(*produced)
            if self.pipeline_window == 0:
                done += pipe.drain()
        else:
            done = pipe.drain()
        served = sum(self._finish(client, c) for c in done)
        return served + self._decode_tick(client)

    # ------------------------------------------------- admission control
    def _admission_tick(self, client: BrokerClient):
        """Every ``ZOO_SERVING_ADMISSION_S`` (0 disables): when any
        per-lane p99 burn is past the shed threshold, set the broker's
        ``XSHED`` flag of the batch lane so NEW batch enqueues fail fast
        while interactive keeps flowing; clear it once the burn clears.
        The per-lane depth gauges refresh on the same tick."""
        if self._admission_interval_s <= 0:
            return
        now = time.perf_counter()
        if now - self._last_admission < self._admission_interval_s:
            return
        self._last_admission = now
        mon = slo.get_monitor()
        try:
            mon.tick_if_stale()
        except Exception:
            logger.debug("slo sample failed", exc_info=True)
        want = any(mon.burning(f"serving_p99_latency_{lane}")
                   for lane in schema.PRIORITIES)
        with self._state_lock:
            flip = want != self.admission_shedding or self._admission_dirty
        if flip:
            # dirty re-asserts after a reconnect: a restarted broker lost
            # its shed flags
            client.xshed_set(self.stream, self.ADMISSION_LANE, want)
            with self._state_lock:
                self.admission_shedding = want
                self._admission_dirty = False
            self._admission_gauge.set(1.0 if want else 0.0)
            logger.warning("admission control: %s lane %s",
                           self.ADMISSION_LANE,
                           "SHEDDING" if want else "accepting")
        for lane in schema.PRIORITIES:
            self._lane_depth_gauge[lane].set(
                client.xlen(self.stream, lane))

    def _make_pipe(self) -> DevicePipeline:
        return DevicePipeline(self._dispatch, self._fetch,
                              window=max(1, self.pipeline_window),
                              timer=self.timer)

    def _run(self):
        logger.info("serving started: stream=%s batch=%d window=%d",
                    self.stream, self.batch_size, self.pipeline_window)
        client: Optional[BrokerClient] = None
        # the pipeline outlives broker reconnects: launched batches finish
        # against the redialed client
        pipe = self._make_pipe()
        while not self._stop.is_set():
            try:
                if client is None:
                    client = BrokerClient(host=self.broker_host,
                                          port=self.broker_port)
                if self._warmup_enabled and not self._warm_kicked:
                    # the model could not describe its inputs at start():
                    # warm the ladder the moment it can
                    self._kick_warmup()
                self._serve_once(client, pipe)
            except (ConnectionError, OSError):
                # broker gone or the socket bad: drop the client, redial
                if self._stop.is_set():
                    break
                logger.warning("broker connection lost; reconnecting")
                if client is not None:
                    client.close()
                    client = None
                self._seen_client_gen = 0   # a fresh client starts at 0
                self._reset_delivery_state()
                with self._state_lock:
                    self._admission_dirty = True
                time.sleep(0.2)
            except Exception:
                # the loop is the service — survive anything per batch
                logger.exception("serve step failed; continuing")
                time.sleep(0.05)
        # drain on stop: launched batches still flush results and acks
        try:
            for c in pipe.drain():
                if client is not None:
                    self._finish(client, c)
        except Exception:
            logger.exception("final drain failed; pending entries will be "
                             "re-delivered via XCLAIM")
        # live generations do not run to the end on stop: their entries
        # were never acked and re-deliver through the lease
        self._abort_decode()
        if client is not None:
            client.close()

    # -------------------------------------------------------------- fleet
    def set_advertise(self, host: str, port: int):
        """Where peers scrape this replica's ``/metrics`` — set by the
        FrontEnd that owns this engine (port 0 = headless)."""
        with self._state_lock:   # the heartbeater reads it on its thread
            self._advertise = (host, int(port))

    def _replica_info(self) -> fleet.ReplicaInfo:
        with self._state_lock:
            n = self.records_out
            host, port = self._advertise
            started = self._started_wall
        # wall clock by design: heartbeat ages are compared across
        # processes and hosts (common/fleet.py)
        now = time.time()  # wallclock: ok
        return fleet.ReplicaInfo(
            replica_id=self.replica_id, host=host, port=port,
            started_at=started, last_heartbeat=now,
            records_total=n, stream=self.stream)

    def _expedite_reclaim(self, n_orphans: int):
        """ReplicaSupervisor callback: a stale peer left ``n_orphans``
        unacked entries — run the next lease sweep at once (the entries
        still wait out their lease in the broker)."""
        self._reclaim_asap.set()

    # ---------------------------------------------------------------- api
    def start(self) -> "ClusterServing":
        if self._thread is not None:
            return self
        # ZOO_FLIGHT_RECORDER=1: ring-buffer the serve loop's spans and
        # dump a postmortem on SIGTERM
        profiling.maybe_arm_from_env()
        # windowed history for /metrics/history, /query and the SLO
        # monitor's burn windows (idempotent; ZOO_TS_TICK_S=0 opts out)
        timeseries.get_store().start()
        # supervise the backend when a fault drill wants to observe its
        # verdicts (JAX also does for its CPU failover, which the port
        # does not have): plain deployments get no extra thread
        if resilience.fault_plan_active():
            sup = resilience.get_supervisor()
            with self._state_lock:
                self._supervisor = sup
            sup.ensure_started()
        if self._warmup_enabled:
            self._kick_warmup()
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="zoo-serving")
        self._thread.start()
        # join the fleet (ZOO_FLEET_HEARTBEAT_S=0 opts out): heartbeats
        # through the broker hash, and a supervisor that expedites this
        # replica's lease sweep when a peer's entries are orphaned
        if self._heartbeater is None and fleet.heartbeat_interval_s() > 0:
            with self._state_lock:
                self._started_wall = time.time()  # wallclock: ok
            registry = fleet.ReplicaRegistry(self.broker_host,
                                             self.broker_port)
            self._heartbeater = fleet.Heartbeater(registry,
                                                  self._replica_info)
            self._heartbeater.start()
            self._replica_supervisor = fleet.ReplicaSupervisor(
                registry, self.stream, self.group,
                broker_host=self.broker_host, broker_port=self.broker_port,
                own_replica_id=self.replica_id,
                on_orphans=self._expedite_reclaim)
            self._replica_supervisor.start()
        return self

    def stop(self):
        """Stop reading, flush and ack every launched batch, join the
        serve thread; only then stop the supervisor and deregister the
        heartbeat (deregistering first would hand a peer's supervisor this
        replica's drain as orphans, a window for processing twice)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        rsup, self._replica_supervisor = self._replica_supervisor, None
        if rsup is not None:
            rsup.stop()
        hb, self._heartbeater = self._heartbeater, None
        if hb is not None:
            hb.stop()
        # the supervisor is a process singleton, but the engine is the
        # process's deployment unit: stop its probe loop with the serving
        with self._state_lock:
            sup, self._supervisor = self._supervisor, None
        if sup is not None:
            sup.stop()

    def decode_state(self) -> Dict:
        """Decode occupancy at a glance (the /healthz ``decode`` block):
        live sequences, steps, preemptions and page-pool pages in use and
        free — point-in-time reads without the serve thread."""
        with self._state_lock:
            sched = self._decode_sched
        out = {"live_sequences": int(sched.live) if sched else 0,
               "steps_run": int(sched.steps_run) if sched else 0,
               "preemptions": int(self._preempt_counter.value),
               "pages_in_use": 0, "pages_free": 0}
        alloc = sched.allocator if sched else None
        if alloc is not None:
            out["pages_in_use"] = int(alloc.n_in_use)
            out["pages_free"] = int(alloc.n_free)
        return out

    def metrics(self) -> Dict:
        """Throughput and stage latencies (ref Flink numRecordsOutPerSecond
        and Timer stats), the delivery counts, and the decode scheduler's
        wide steps and paged steps. Safe to poll from other threads."""
        with self._state_lock:
            sched = self._decode_sched
            out = {"records_out": self.records_out,
                   "records_failed": self.records_failed,
                   "batches": self.batches,
                   "records_redelivered": self.records_redelivered,
                   "lease_reclaims": self.lease_reclaims,
                   "records_expired": self.records_expired,
                   "admission_shedding": self.admission_shedding}
        out["decode_steps"] = 0 if sched is None else sched.steps_run
        out["paged_steps"] = 0 if sched is None else sched.paged_steps
        out.update(self.timer.summary())
        # model-parallel placement: strategy, shard count and per-rank
        # parameter bytes when the model was sharded (InferenceModel.shard)
        fn = getattr(self.model, "shard_info", None)
        if fn is not None:
            try:
                info = fn()
            except Exception:
                info = None
            if info:
                out["sharding"] = info
        return out

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
