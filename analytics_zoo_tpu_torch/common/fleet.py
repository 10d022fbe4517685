"""Fleet replica registry — who is serving, where, and how much.

The port's own copy of ``analytics_zoo_tpu/common/fleet.py``; the wire
value is the JAX package's byte for byte, so a replica of either package
lists and scrapes the other's. Replicas are discoverable over the data
plane they already share: every serving engine heartbeats
``{replica_id, host, port, started_at, records_total}`` into one broker
hash (``HSET fleet_replicas <id> <b64(json)>``), and any frontend can
list the hash to find live peers — no extra service, no new wire
protocol, and the broker's hash TTL (broker.py ``hash_ttl_ms``)
garbage-collects replicas that die without saying goodbye.

``GET /metrics?scope=fleet`` (serving/frontend.py) consumes this registry
to scrape+merge live replicas' snapshots (telemetry.merge_snapshot);
``GET /healthz`` reports live/stale counts. Knobs: ``ZOO_FLEET_HEARTBEAT_S``
(engine heartbeat period, 0 disables), ``ZOO_FLEET_STALE_S`` (age past
which a replica reads stale).

Timestamps here are WALL clock on purpose: heartbeat ages are compared
across processes and hosts, where ``perf_counter`` has no shared epoch.
Staleness tolerances are seconds, far above NTP slew.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import uuid
from base64 import b64decode, b64encode
from dataclasses import asdict, dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from analytics_zoo_tpu_torch.common import telemetry

__all__ = [
    "REPLICA_HASH", "ReplicaInfo", "ReplicaRegistry", "Heartbeater",
    "ReplicaSupervisor", "heartbeat_interval_s", "stale_after_s",
    "default_replica_id",
]

#: broker hash holding one field per replica (field = replica_id)
REPLICA_HASH = "fleet_replicas"


def heartbeat_interval_s() -> float:
    """Engine heartbeat period; ``0`` disables fleet registration."""
    return float(os.environ.get("ZOO_FLEET_HEARTBEAT_S", "2.0"))


def stale_after_s() -> float:
    """Heartbeats older than this read as stale (default: 5 periods —
    one lost heartbeat must not flap the fleet view)."""
    raw = os.environ.get("ZOO_FLEET_STALE_S", "").strip()
    if raw:
        return float(raw)
    return 5.0 * max(heartbeat_interval_s(), 1.0)


def default_replica_id(stream: str = "serving") -> str:
    """Unique, uri-charset-safe id: stream + pid + random suffix (two
    replicas in one process — tests — must not collide)."""
    return f"{stream}:{os.getpid()}:{uuid.uuid4().hex[:6]}"


@dataclass
class ReplicaInfo:
    """One replica's heartbeat record (JSON on the wire)."""
    replica_id: str
    host: str = "127.0.0.1"
    port: int = 0                 # metrics/HTTP port (0 = no frontend)
    started_at: float = 0.0       # wall clock, seconds
    last_heartbeat: float = 0.0   # wall clock, seconds
    records_total: int = 0
    stream: str = "serving_stream"
    pid: int = field(default_factory=os.getpid)

    def age_s(self, now: Optional[float] = None) -> float:
        if now is None:
            now = time.time()  # zoolint: disable=wallclock-hotpath
        return max(0.0, now - self.last_heartbeat)

    def stale(self, stale_s: Optional[float] = None,
              now: Optional[float] = None) -> bool:
        return self.age_s(now) > (stale_after_s() if stale_s is None
                                  else stale_s)

    def as_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ReplicaInfo":
        known = {k: d[k] for k in cls.__dataclass_fields__ if k in d}
        return cls(**known)


def _encode(info: ReplicaInfo) -> str:
    return b64encode(json.dumps(info.as_dict()).encode()).decode()


def _decode(val: str) -> ReplicaInfo:
    return ReplicaInfo.from_dict(json.loads(b64decode(val)))


logger = logging.getLogger(__name__)


class ReplicaRegistry:
    """List/publish replicas through the broker hash. Connection-per-call
    (the broker protocol is connection-oriented and callers live on
    arbitrary request threads); every method raises broker
    ``ConnectionError``/``OSError`` to the caller — the frontend maps
    that to its existing broker-down handling."""

    def __init__(self, broker_host: str = "127.0.0.1",
                 broker_port: int = 6399, hash_key: str = REPLICA_HASH):
        self.broker_host = broker_host
        self.broker_port = int(broker_port)
        self.hash_key = hash_key

    def _client(self):
        from analytics_zoo_tpu_torch.serving.broker import BrokerClient
        return BrokerClient(host=self.broker_host, port=self.broker_port)

    def publish(self, info: ReplicaInfo) -> None:
        client = self._client()
        try:
            client.hset(self.hash_key, info.replica_id, _encode(info))
        finally:
            client.close()

    def remove(self, replica_id: str) -> None:
        client = self._client()
        try:
            client.hdel(self.hash_key, replica_id)
        finally:
            client.close()

    def list(self) -> List[ReplicaInfo]:
        client = self._client()
        try:
            ids = client.hkeys(self.hash_key)
            vals = client.pipeline(
                ("HGET", self.hash_key, rid) for rid in ids) if ids else []
        finally:
            client.close()
        out = []
        for rid, val in zip(ids, vals):
            if val is None:
                continue        # expired between HKEYS and HGET
            try:
                out.append(_decode(val))
            except Exception:
                logger.warning("undecodable replica record %r", rid)
        return sorted(out, key=lambda r: r.replica_id)

    def partition(self, stale_s: Optional[float] = None
                  ) -> Tuple[List[ReplicaInfo], List[ReplicaInfo]]:
        """(live, stale) split of :meth:`list`, and publish the
        ``zoo_fleet_replicas`` gauge pair while at it — every caller of
        the fleet view keeps the gauge current."""
        now = time.time()  # zoolint: disable=wallclock-hotpath
        live, stale = [], []
        for r in self.list():
            (stale if r.stale(stale_s, now) else live).append(r)
        gauge = telemetry.get_registry().gauge(
            "zoo_fleet_replicas",
            "Serving replicas in the fleet registry by heartbeat state",
            ("state",))
        gauge.labels("live").set(len(live))
        gauge.labels("stale").set(len(stale))
        return live, stale


class Heartbeater:
    """Engine-owned daemon thread that republishes a replica's record
    every ``interval_s``. ``info_fn`` builds the fresh :class:`ReplicaInfo`
    (the engine closes over its live ``records_out``); publish failures
    count ``zoo_fleet_heartbeat_errors_total`` and never propagate — a
    flapping broker must not take the serve loop's sidecar down."""

    def __init__(self, registry: ReplicaRegistry,
                 info_fn: Callable[[], ReplicaInfo],
                 interval_s: Optional[float] = None):
        self.registry = registry
        self.info_fn = info_fn
        self.interval_s = heartbeat_interval_s() if interval_s is None \
            else float(interval_s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._errors = telemetry.get_registry().counter(
            "zoo_fleet_heartbeat_errors_total",
            "Replica heartbeats that failed to publish", ("replica",))

    def beat_once(self) -> bool:
        info = self.info_fn()
        try:
            self.registry.publish(info)
            return True
        except Exception:
            self._errors.labels(info.replica_id).inc()
            return False

    def _run(self):
        while not self._stop.is_set():
            self.beat_once()
            self._stop.wait(self.interval_s)

    def start(self) -> "Heartbeater":
        if self._thread is not None or self.interval_s <= 0:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="zoo-fleet-heartbeat")
        self._thread.start()
        return self

    def stop(self, deregister: bool = True):
        """Stop beating and (by default) remove the registry record.

        Ordering contract: the engine calls this only AFTER its final
        drain has acked (engine.stop joins the serve thread first).
        Deregistering while a drain is still in flight would let a peer's
        ReplicaSupervisor classify the drain's entries as orphans and
        reclaim work that is about to be acked — a double-processing
        window."""
        t, self._thread = self._thread, None
        self._stop.set()
        if t is not None:
            t.join(timeout=5)
        if deregister:
            try:
                self.registry.remove(self.info_fn().replica_id)
            except Exception:
                pass            # broker already gone: TTL will collect us


def reclaim_interval_s() -> float:
    """Cadence of orphan detection / lease reclaim sweeps
    (``ZOO_SERVING_RECLAIM_S``; default: one heartbeat period, floored
    at 1s so an idle fleet stays cheap)."""
    raw = os.environ.get("ZOO_SERVING_RECLAIM_S", "").strip()
    if raw:
        return float(raw)
    return max(heartbeat_interval_s(), 1.0)


class ReplicaSupervisor:
    """Fleet watchdog: detects crashed replicas and the entries they
    stranded. Each sweep partitions the registry into live/stale, pulls
    the broker's per-consumer pending breakdown (``XPENDING DETAIL``) and
    classifies entries owned by consumers with no live heartbeat as
    ORPHANS — publishing ``zoo_serving_orphan_entries`` and invoking
    ``on_orphans(count)`` so the owning engine can expedite its
    lease-reclaim sweep instead of waiting out the rate limiter. The
    latest sweep's delivery state (pending-per-replica, orphans) is
    surfaced through ``/healthz`` by the frontend; membership counts
    there come fresh from the registry, not this cache.

    Detection only: the actual redelivery stays with the broker's lease
    arbitration (XCLAIM), so a flapping supervisor can never hand the
    same entry to two replicas."""

    def __init__(self, registry: ReplicaRegistry, stream: str,
                 group: str = "serving", broker_host: str = "127.0.0.1",
                 broker_port: int = 6399,
                 interval_s: Optional[float] = None,
                 own_replica_id: Optional[str] = None,
                 on_orphans: Optional[Callable[[int], None]] = None):
        self.registry = registry
        self.stream, self.group = stream, group
        self.broker_host, self.broker_port = broker_host, int(broker_port)
        self.interval_s = reclaim_interval_s() if interval_s is None \
            else float(interval_s)
        self.own_replica_id = own_replica_id
        self.on_orphans = on_orphans
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._last: Dict = {}
        self._sweeps = 0
        self._orphan_gauge = telemetry.get_registry().gauge(
            "zoo_serving_orphan_entries",
            "Pending entries owned by consumers with no live heartbeat",
            ("stream",)).labels(stream)

    def sweep(self) -> Dict:
        """One detection pass; returns (and caches) the fleet view."""
        live, stale = self.registry.partition()
        live_ids = {r.replica_id for r in live}
        if self.own_replica_id:
            live_ids.add(self.own_replica_id)   # we are demonstrably alive
        from analytics_zoo_tpu_torch.serving.broker import BrokerClient
        client = BrokerClient(host=self.broker_host, port=self.broker_port)
        try:
            per_consumer = client.xpending_detail(self.stream, self.group)
        finally:
            client.close()
        orphans = sum(n for c, n in per_consumer.items()
                      if c not in live_ids)
        self._orphan_gauge.set(orphans)
        with self._lock:
            self._sweeps += 1
            snap = {
                "live": len(live), "stale": len(stale),
                "replicas": sorted(r.replica_id for r in live),
                "pending_per_replica": per_consumer,
                "orphan_entries": orphans,
                "sweeps": self._sweeps,
            }
            self._last = snap
        if orphans and self.on_orphans is not None:
            logger.warning(
                "%d orphaned pending entries on stream %s (stale "
                "replicas: %s); expediting reclaim", orphans, self.stream,
                [r.replica_id for r in stale] or "none registered")
            self.on_orphans(orphans)
        return snap

    def snapshot(self) -> Dict:
        """Latest sweep result (empty dict before the first sweep)."""
        with self._lock:
            return dict(self._last)

    def _run(self):
        while not self._stop.is_set():
            try:
                self.sweep()
            except Exception:
                # broker flap or registry hiccup: the watchdog must not
                # die with its patient
                logger.debug("replica supervisor sweep failed",
                             exc_info=True)
            self._stop.wait(self.interval_s)

    def start(self) -> "ReplicaSupervisor":
        if self._thread is not None or self.interval_s <= 0:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="zoo-replica-supervisor")
        self._thread.start()
        return self

    def stop(self):
        t, self._thread = self._thread, None
        self._stop.set()
        if t is not None:
            t.join(timeout=5)
