"""The port's serving fleet (common/fleet.py, the engine's heartbeat and
replica supervisor, the frontend's ``?scope=fleet``) on the CPU, as the
JAX package's tests/test_fleet.py and tests/test_multi_replica.py drive
theirs: the registry, the heartbeater and the knobs; the wire value byte
for byte JAX's; orphan detection; a slow batch redelivered once and
idempotently; the graceful stop's ack-before-deregister order; the
fleet view degrading to partial; a JAX engine and a port engine on one
broker, each frontend listing both and merging the same totals; and the
SIGKILL drill (slow-marked, as JAX's is). JAX is imported inside tests
only. Every engine and frontend stops through a context manager or a
``finally``; sockets carry timeouts."""

import json
import time
import urllib.request

import numpy as np
import pytest

from analytics_zoo_tpu_torch.common import fleet, resilience, telemetry
from analytics_zoo_tpu_torch.serving import (Broker, ClusterServing,
                                             FrontEnd, InputQueue,
                                             OutputQueue)

BACKENDS = ["python", "native"]
STREAM, GROUP = "serving_stream", "serving"


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    from analytics_zoo_tpu_torch.common import slo
    monkeypatch.setenv("ZOO_FLEET_HEARTBEAT_S", "0.25")
    telemetry.reset_for_tests()
    slo.set_monitor(None)
    resilience.install_plan(None)
    yield
    resilience.install_plan(None)
    telemetry.reset_for_tests()


@pytest.fixture(params=BACKENDS)
def broker(request):
    with Broker.launch(backend=request.param) as b:
        yield b


def _counter(family, label=None):
    fam = telemetry.snapshot().get(family, {})
    if not isinstance(fam, dict):
        return float(fam or 0.0)
    if label is None:
        return float(next(iter(fam.values()), 0.0))
    return float(fam.get(label, 0.0))


def _get_json(url, timeout=10.0):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read())


def _wait(cond, timeout=20.0, every=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(every)
    return cond()


# ------------------------------------------------------------- registry

def test_publish_list_partition_remove(broker):
    reg = fleet.ReplicaRegistry("127.0.0.1", broker.port)
    now = time.time()
    fresh = fleet.ReplicaInfo("serving:1:aaa", port=81, started_at=now,
                              last_heartbeat=now, records_total=5)
    old = fleet.ReplicaInfo("serving:2:bbb", port=82, started_at=now - 600,
                            last_heartbeat=now - 600)
    reg.publish(fresh)
    reg.publish(old)
    live, stale = reg.partition()
    assert [r.replica_id for r in live] == ["serving:1:aaa"]
    assert [r.replica_id for r in stale] == ["serving:2:bbb"]
    assert live[0].records_total == 5 and live[0].port == 81
    assert telemetry.snapshot()["zoo_fleet_replicas"] == {
        "state=live": 1.0, "state=stale": 1.0}
    reg.remove("serving:1:aaa")
    live, stale = reg.partition()
    assert live == [] and len(stale) == 1


def test_wire_value_is_jax_byte_for_byte(broker):
    """A JAX replica and a port replica heartbeating into one broker list
    each other: the HSET value is the same base64 JSON."""
    from analytics_zoo_tpu.common import fleet as jfleet
    kw = dict(replica_id="serving:7:abc", host="10.0.0.2", port=8080,
              started_at=1700000000.25, last_heartbeat=1700000001.5,
              records_total=42, stream="s", pid=1234)
    assert fleet._encode(fleet.ReplicaInfo(**kw)) == \
        jfleet._encode(jfleet.ReplicaInfo(**kw))
    fleet.ReplicaRegistry("127.0.0.1", broker.port).publish(
        fleet.ReplicaInfo(**kw))
    jfleet.ReplicaRegistry("127.0.0.1", broker.port).publish(
        jfleet.ReplicaInfo(**dict(kw, replica_id="serving:8:def")))
    port_view = fleet.ReplicaRegistry("127.0.0.1", broker.port).list()
    jax_view = jfleet.ReplicaRegistry("127.0.0.1", broker.port).list()
    assert [r.as_dict() for r in port_view] == \
        [r.as_dict() for r in jax_view]
    assert [r.replica_id for r in port_view] == ["serving:7:abc",
                                                 "serving:8:def"]


def test_heartbeater_counts_failures_without_raising():
    reg = fleet.ReplicaRegistry("127.0.0.1", 1)    # nothing listens
    info = fleet.ReplicaInfo("serving:3:ccc")
    hb = fleet.Heartbeater(reg, lambda: info, interval_s=60)
    assert hb.beat_once() is False
    assert telemetry.snapshot()["zoo_fleet_heartbeat_errors_total"] == {
        "replica=serving:3:ccc": 1.0}
    hb.stop()       # deregistering against a dead broker must not raise


def test_env_knobs(monkeypatch):
    monkeypatch.setenv("ZOO_FLEET_HEARTBEAT_S", "0.5")
    assert fleet.heartbeat_interval_s() == 0.5
    assert fleet.stale_after_s() == 5.0   # 5 x max(interval, 1)
    monkeypatch.setenv("ZOO_FLEET_STALE_S", "42")
    assert fleet.stale_after_s() == 42.0
    monkeypatch.delenv("ZOO_SERVING_RECLAIM_S", raising=False)
    assert fleet.reclaim_interval_s() == 1.0
    monkeypatch.setenv("ZOO_SERVING_RECLAIM_S", "0.25")
    assert fleet.reclaim_interval_s() == 0.25
    a, b = fleet.default_replica_id("s"), fleet.default_replica_id("s")
    assert a != b and a.startswith("s:")


# ------------------------------------------------- orphans, delivery

def test_replica_supervisor_detects_and_reports_orphans(broker):
    c = broker.client()
    for _ in range(4):
        c.xadd(STREAM, "YQ==")
    # "deadbeef" took four deliveries and vanished: no heartbeat
    c.xreadgroup(GROUP, "deadbeef", STREAM, 10)
    reg = fleet.ReplicaRegistry("127.0.0.1", broker.port)
    now = time.time()
    reg.publish(fleet.ReplicaInfo(replica_id="live-1", started_at=now,
                                  last_heartbeat=now))
    fired = []
    sup = fleet.ReplicaSupervisor(
        reg, STREAM, group=GROUP, broker_port=broker.port,
        own_replica_id="live-1", on_orphans=fired.append)
    snap = sup.sweep()
    assert snap["live"] == 1 and snap["replicas"] == ["live-1"]
    assert snap["pending_per_replica"] == {"deadbeef": 4}
    assert snap["orphan_entries"] == 4 and fired == [4]
    assert _counter("zoo_serving_orphan_entries", f"stream={STREAM}") == 4.0
    assert len(c.xclaim(STREAM, GROUP, "live-1", 0, 10)) == 4
    snap2 = sup.sweep()
    assert snap2["orphan_entries"] == 0 and snap2["sweeps"] == 2
    assert fired == [4] and sup.snapshot() == snap2
    c.close()


class _Duck:
    """Doubler whose first predict may stall past its lease."""

    def __init__(self, first_sleep_s=0.0):
        self.first_sleep_s = first_sleep_s
        self._calls = 0

    def predict(self, x):
        self._calls += 1
        if self._calls == 1 and self.first_sleep_s:
            time.sleep(self.first_sleep_s)
        return np.asarray(x) * 2.0


def test_slow_batch_redelivery_is_idempotent_and_single_sweep():
    """Replica A takes one batch and stalls past its lease; B's sweep
    redelivers the whole batch in one sweep, and A's late finish
    (duplicate writes, double acks) is harmless."""
    n = 4
    with Broker.launch(backend="python") as b:
        in_q, out_q = InputQueue(port=b.port), OutputQueue(port=b.port)
        uris = in_q.enqueue_batch(
            (f"rd{i}", {"x": np.full(3, i, np.float32)}) for i in range(n))
        c = b.client()
        with ClusterServing(_Duck(first_sleep_s=1.2), b.port, batch_size=n,
                            max_batch_size=n, consumer="repA",
                            claim_min_idle_ms=300, reclaim_interval_s=30.0,
                            warmup=False):
            assert _wait(lambda: c.xpending_detail(STREAM, GROUP).get(
                "repA") == n, timeout=10.0)
            with ClusterServing(_Duck(), b.port, batch_size=n,
                                max_batch_size=n, consumer="repB",
                                claim_min_idle_ms=300,
                                reclaim_interval_s=0.1, warmup=False):
                res = out_q.query_many(uris, timeout=30.0)
                for i in range(n):
                    np.testing.assert_allclose(
                        res[f"rd{i}"], np.full(3, 2.0 * i, np.float32))
                assert _counter("zoo_serving_redelivered_total",
                                f"stream={STREAM}") == n
                assert _counter("zoo_serving_lease_reclaims_total",
                                f"stream={STREAM}") == 1
                assert _wait(lambda: c.xpending(STREAM, GROUP) == 0,
                             timeout=10.0)
        c.close()


def test_graceful_stop_acks_all_deliveries_before_deregister():
    with Broker.launch(backend="python") as b:
        with ClusterServing(_Duck(), b.port, batch_size=4, max_batch_size=4,
                            warmup=False) as eng:
            assert _wait(lambda: [r.replica_id for r in fleet.ReplicaRegistry(
                "127.0.0.1", b.port).list()] == [eng.replica_id])
            in_q, out_q = InputQueue(port=b.port), OutputQueue(port=b.port)
            uris = in_q.enqueue_batch(
                (f"gs{i}", {"x": np.full(3, i, np.float32)})
                for i in range(12))
            res = out_q.query_many(uris, timeout=30.0)
            assert all(v is not None for v in res.values())
        c = b.client()
        assert c.xpending(STREAM, GROUP) == 0
        assert fleet.ReplicaRegistry("127.0.0.1", b.port).list() == []
        c.close()


def test_expedite_reclaim_sweeps_at_once_on_orphans():
    """The supervisor's orphan callback runs the next lease sweep now,
    not after the rate limiter's interval."""
    with Broker.launch(backend="python") as b:
        c = b.client()
        in_q, out_q = InputQueue(port=b.port), OutputQueue(port=b.port)
        uris = in_q.enqueue_batch(
            (f"ex{i}", {"x": np.full(2, i, np.float32)}) for i in range(3))
        c.xreadgroup(GROUP, "ghost", STREAM, 10)    # a dead consumer
        time.sleep(0.35)                            # its lease lapses
        with ClusterServing(_Duck(), b.port, batch_size=4, max_batch_size=4,
                            claim_min_idle_ms=300, reclaim_interval_s=1e9,
                            warmup=False) as eng:
            eng._last_claim = time.perf_counter()   # the limiter is shut
            res = out_q.query_many(uris, timeout=20.0)
            assert all(v is not None for v in res.values())
            assert eng.lease_reclaims == 1
        c.close()


# ------------------------------------------------------- the fleet view

def test_dead_replica_degrades_fleet_view_to_partial():
    from analytics_zoo_tpu_torch.serving.frontend import (
        scrape_fleet, scrape_fleet_history)
    with Broker.launch(backend="python") as broker:
        reg = fleet.ReplicaRegistry("127.0.0.1", broker.port)
        now = time.time()
        reg.publish(fleet.ReplicaInfo("serving:9:dead", port=1,
                                      started_at=now, last_heartbeat=now))
        telemetry.get_registry().counter("zoo_local_records_total").inc(4)
        merged, meta = scrape_fleet("127.0.0.1", broker.port, timeout_s=0.5)
        assert meta["failed"] == ["serving:9:dead"]
        assert merged["zoo_local_records_total"] == 4.0
        assert telemetry.snapshot()["zoo_fleet_scrape_errors_total"] == {
            "replica=serving:9:dead": 1.0}
        windows, meta = scrape_fleet_history("127.0.0.1", broker.port,
                                             windows=(60.0,), timeout_s=0.5)
        assert meta["failed"] == ["serving:9:dead"] and "60s" in windows


def test_jax_and_port_replicas_see_each_other(monkeypatch):
    """A JAX engine and a port engine heartbeat into one broker: each
    frontend's ``?scope=fleet`` lists both and merges the same totals."""
    from analytics_zoo_tpu.common import telemetry as jtel
    from analytics_zoo_tpu.serving import ClusterServing as JServing
    from analytics_zoo_tpu.serving import FrontEnd as JFrontEnd
    jtel.reset_for_tests()
    n = 24
    with Broker.launch(backend="python") as b:
        jeng = JServing(_Duck(), b.port, batch_size=4, max_batch_size=4,
                        warmup=False, consumer="jax-replica")
        jfe = JFrontEnd(b.port, engine=jeng)
        try:
            jeng.start()
            jfe.start()
            with ClusterServing(_Duck(), b.port, batch_size=4,
                                max_batch_size=4, warmup=False,
                                consumer="port-replica") as eng, \
                    FrontEnd(b.port, engine=eng) as fe:
                in_q, out_q = InputQueue(port=b.port), \
                    OutputQueue(port=b.port)
                uris = in_q.enqueue_batch(
                    (f"x{i}", {"x": np.full(3, i, np.float32)})
                    for i in range(n))
                res = out_q.query_many(uris, timeout=30.0)
                assert all(v is not None for v in res.values())
                ids = {jeng.replica_id, eng.replica_id}
                reg = fleet.ReplicaRegistry("127.0.0.1", b.port)
                assert _wait(lambda: {r.replica_id for r in
                                      reg.partition()[0]} == ids)
                views = [_get_json(f"http://127.0.0.1:{p}/metrics?scope="
                                   "fleet") for p in (fe.port, jfe.port)]
                for v in views:
                    assert v["partial"] is False, v["replicas"]
                    assert sorted(v["replicas"]["scraped"]) == sorted(ids)
                    assert v["metrics"]["zoo_serving_records_total"][
                        f"stream={STREAM}"] == n
                own = [_get_json(f"http://127.0.0.1:{p}/metrics?format="
                                 "snapshot")["zoo_serving_records_total"][
                    f"stream={STREAM}"] for p in (fe.port, jfe.port)]
                assert sum(own) == n
                hz = _get_json(f"http://127.0.0.1:{fe.port}/healthz")
                assert hz["fleet"]["replicas"] == 2
                hist = _get_json(f"http://127.0.0.1:{fe.port}"
                                 "/metrics/history?scope=fleet&windows=60")
                assert hist["partial"] is False and "60s" in hist["windows"]
        finally:
            jfe.stop()
            jeng.stop()
            jtel.reset_for_tests()


# --------------------------------------------------------- chaos drill

@pytest.mark.slow
def test_two_replica_sigkill_chaos_drill():
    """Two subprocess replicas share one stream; the ``kill@replica``
    seam SIGKILLs one mid-stream. No record lost, everything acked, the
    survivor redelivers in one sweep and its fleet view drops to one
    live replica."""
    n = 64
    env = {"ZOO_SERVING_LEASE_MS": "300", "ZOO_SERVING_RECLAIM_S": "0.25",
           "ZOO_FLEET_HEARTBEAT_S": "0.25", "ZOO_FLEET_STALE_S": "1.0"}

    def snap_metric(port, family):
        try:
            snap = _get_json(f"http://127.0.0.1:{port}/metrics?format="
                             "snapshot", timeout=2.0)
        except Exception:
            return 0.0
        fam = snap.get(family, {})
        return float(fam.get(f"stream={STREAM}", 0.0)) \
            if isinstance(fam, dict) else float(fam or 0.0)

    payloads = np.random.default_rng(5).standard_normal(
        (n, 4)).astype(np.float32)
    with resilience.fault_drill("kill@replica:1"), \
            Broker.launch(backend="python") as broker:
        victim = resilience.ServingReplicaProc(
            broker.port, batch_size=4, predict_sleep_ms=60_000.0,
            env_extra=env)
        survivor = resilience.ServingReplicaProc(
            broker.port, batch_size=4, predict_sleep_ms=2.0,
            env_extra=env)
        try:
            in_q, out_q = InputQueue(port=broker.port), \
                OutputQueue(port=broker.port)
            uris = list(in_q.enqueue_batch(
                (f"ch{i}", {"x": payloads[i]}) for i in range(n)))
            time.sleep(0.3)
            assert resilience.maybe_kill_replica(victim)
            assert not victim.alive
            res = out_q.query_many(uris, timeout=60.0)
            assert not [u for u, v in res.items() if v is None]
            c = broker.client()
            assert _wait(lambda: c.xpending(STREAM, GROUP) == 0, 15.0)
            c.close()
            assert snap_metric(survivor.http_port,
                               "zoo_serving_redelivered_total") >= 1.0
            assert snap_metric(survivor.http_port,
                               "zoo_serving_lease_reclaims_total") == 1.0

            def one_live():
                try:
                    return _get_json(f"http://127.0.0.1:{survivor.http_port}"
                                     "/healthz", 2.0)["fleet"][
                        "replicas"] == 1
                except Exception:
                    return False
            assert _wait(one_live, 20.0, 0.25)
        finally:
            survivor.stop()
            victim.stop()
