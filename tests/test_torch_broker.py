"""The port's brokers (the native ``zbroker`` built from the port's own
source, and the Python broker) against the JAX package's: priority lanes,
XSHED, lease-based XCLAIM, XPENDING DETAIL, the hash TTL that never evicts
a pending delivery, the client's reconnect rules, the same command script
answered line for line by JAX's brokers and the port's, each package's
client served by the other's broker and engine, and the native build's
atomic rename."""

import os
import socket
import stat
import time

import numpy as np
import pytest
import torch

from analytics_zoo_tpu.serving import broker as jbroker
from analytics_zoo_tpu_torch.common import telemetry
from analytics_zoo_tpu_torch.serving import broker as tbroker
from analytics_zoo_tpu_torch.serving import schema
from analytics_zoo_tpu_torch.serving.broker import (Broker, BrokerClient,
                                                    ShedError)
from analytics_zoo_tpu_torch.serving.client import InputQueue, OutputQueue

BACKENDS = ["python", "native"]
STREAM, GROUP = "serving_stream", "serving"
LANES = ",".join(schema.PRIORITIES)


@pytest.fixture(params=BACKENDS)
def broker(request):
    b = Broker.launch(backend=request.param)
    assert b.backend == request.param
    yield b
    b.stop()


def _counter(family, label):
    fam = telemetry.snapshot().get(family, {})
    return float(fam.get(label, 0.0)) if isinstance(fam, dict) else 0.0


# ------------------------------------------------------------- lanes

class TestBrokerLanes:
    def test_lane_ordered_read_and_per_lane_xlen(self, broker):
        c = broker.client()
        c.xadd("s", "YjA=", lane="batch")
        c.xadd("s", "YjE=", lane="batch")
        c.xadd("s", "ZDA=", lane="default")
        c.xadd("s", "aTA=", lane="interactive")
        assert c.xlen("s") == 4
        assert [c.xlen("s", lane) for lane in schema.PRIORITIES] == \
            [1, 1, 2]
        got = c.xreadgroup("g", "c0", "s", 10, lanes=LANES)
        # drained in lane-priority order, FIFO within a lane
        assert [(lane, payload) for _, lane, payload in got] == [
            ("interactive", "aTA="), ("default", "ZDA="),
            ("batch", "YjA="), ("batch", "YjE=")]

    def test_laneless_read_is_back_compatible(self, broker):
        c = broker.client()
        c.xadd("s", "YQ==", lane="batch")
        c.xadd("s", "Yg==")
        assert c.xreadgroup("g", "c0", "s", 10) == [(1, "YQ=="),
                                                    (2, "Yg==")]

    def test_xshed_flag_rejects_xadd_on_that_lane_only(self, broker):
        c = broker.client()
        assert c.xshed("s") == []
        c.xshed_set("s", "batch", True)
        assert c.xshed("s") == ["batch"]
        with pytest.raises(ShedError):
            c.xadd("s", "YQ==", lane="batch")
        c.xadd("s", "Yg==", lane="interactive")
        c.xadd("s", "Yw==", lane="default")
        assert c.xlen("s") == 2
        c.xshed_set("s", "batch", False)
        assert c.xshed("s") == []
        c.xadd("s", "YQ==", lane="batch")
        assert c.xlen("s", "batch") == 1

    def test_xclaim_reclaims_interactive_before_batch(self, broker):
        c = broker.client()
        c.xadd("s", "YjA=", lane="batch")
        c.xadd("s", "YjE=", lane="batch")
        c.xadd("s", "aTA=", lane="interactive")
        c.xadd("s", "aTE=", lane="interactive")
        assert len(c.xreadgroup("g", "dead", "s", 10, lanes=LANES)) == 4
        got = c.xclaim("s", "g", "live", 0, 10, lanes=LANES)
        assert [lane for _, lane, _ in got] == \
            ["interactive", "interactive", "batch", "batch"]
        assert [p for _, _, p in got] == ["aTA=", "aTE=", "YjA=", "YjE="]

    def test_enqueue_validation_and_shed_fast_fail(self, broker):
        c = broker.client()
        in_q = InputQueue(port=broker.port)
        label = f"stream={STREAM},priority=batch"
        shed0 = _counter("zoo_serving_shed_total", label)
        try:
            with pytest.raises(ValueError):
                in_q.enqueue("v1", priority="urgent",
                             x=np.zeros(3, np.float32))
            for bad in (0, -5.0):
                with pytest.raises(ValueError):
                    in_q.enqueue("v2", deadline_ms=bad,
                                 x=np.zeros(3, np.float32))
            with pytest.raises(ValueError):
                in_q.enqueue("v3")
            c.xshed_set(STREAM, "batch", True)
            with pytest.raises(ShedError):
                in_q.enqueue("s1", priority="batch",
                             x=np.zeros(3, np.float32))
            assert _counter("zoo_serving_shed_total", label) == shed0 + 1
            in_q.enqueue("s2", priority="interactive",
                         x=np.zeros(3, np.float32))
            assert c.xlen(STREAM, "interactive") == 1
            with pytest.raises(ShedError):
                in_q.enqueue_batch(
                    [(f"sb{i}", {"x": np.zeros(3, np.float32)})
                     for i in range(2)], priority="batch")
            assert _counter("zoo_serving_shed_total", label) == shed0 + 2
        finally:
            in_q.close()


# ------------------------------------------------------------ leases

class TestLeaseSemantics:
    def test_xclaim_never_steals_claimer_own_lease(self, broker):
        c = broker.client()
        for i in range(3):
            c.xadd("s", f"cDA{i}=")
        assert len(c.xreadgroup("g", "c0", "s", 10)) == 3
        assert c.xclaim("s", "g", "c0", 0, 10) == []
        assert c.xpending_detail("s", "g") == {"c0": 3}
        got = c.xclaim("s", "g", "c1", 0, 10)
        assert [e[0] for e in got] == [1, 2, 3]
        assert c.xpending_detail("s", "g") == {"c1": 3}

    def test_xclaim_on_acked_entries_is_noop(self, broker):
        c = broker.client()
        for _ in range(2):
            c.xadd("s", "YQ==")
        for eid, _ in c.xreadgroup("g", "c0", "s", 10):
            assert c.xack("s", "g", eid) == 1
        assert c.xpending("s", "g") == 0
        assert c.xclaim("s", "g", "c1", 0, 10) == []
        assert c.xpending_detail("s", "g") == {}

    def test_lease_expiry_boundary(self, broker):
        c = broker.client()
        c.xadd("s", "YQ==")
        c.xreadgroup("g", "c0", "s", 1)
        assert c.xclaim("s", "g", "c1", 60_000, 10) == []
        time.sleep(0.25)
        assert [e[0] for e in c.xclaim("s", "g", "c1", 200, 10)] == [1]
        # the claim refreshed the lease clock
        assert c.xclaim("s", "g", "c0", 200, 10) == []
        time.sleep(0.25)
        assert [e[0] for e in c.xclaim("s", "g", "c0", 200, 10)] == [1]

    def test_xpending_detail_per_consumer(self, broker):
        c = broker.client()
        for _ in range(5):
            c.xadd("s", "YQ==")
        a = c.xreadgroup("g", "c0", "s", 3)
        c.xreadgroup("g", "c1", "s", 2)
        assert c.xpending_detail("s", "g") == {"c0": 3, "c1": 2}
        assert c.xpending("s", "g") == 5
        c.xack("s", "g", a[0][0])
        assert c.xpending_detail("s", "g") == {"c0": 2, "c1": 2}

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_hash_ttl_never_evicts_pending_delivery_entries(self, backend):
        b = Broker.launch(backend=backend, hash_ttl_ms=150)
        try:
            c = b.client()
            for i in range(3):
                c.xadd("s", f"cGF5{i}")
            c.xreadgroup("g", "c0", "s", 10)
            c.hset("h", "k", "dg==")
            time.sleep(0.6)
            c.hset("h", "poke", "dg==")
            assert c.hget("h", "k") is None
            assert c.xlen("s") == 3
            got = c.xclaim("s", "g", "c1", 0, 10)
            assert [payload for _, payload in got] == \
                ["cGF50", "cGF51", "cGF52"]
            for eid, _ in got:
                c.xack("s", "g", eid)
            assert c.xlen("s") == 0
        finally:
            b.stop()


class TestClientReconnect:
    @pytest.mark.parametrize("backend", BACKENDS)
    def test_idempotent_reads_survive_broker_restart(self, backend):
        b1 = Broker.launch(backend=backend)
        port = b1.port
        c = BrokerClient(port=port)
        try:
            assert c.ping()
            c.xadd("s", "YQ==")
            label = "zoo_broker_reconnects_total"
            before = float(telemetry.snapshot().get(label, 0.0) or 0.0)
            b1.stop()
            b2 = Broker.launch(backend=backend, port=port)
            try:
                assert c.xlen("s") == 0
                assert c.generation == 1
                assert float(telemetry.snapshot()[label]) == before + 1
            finally:
                b2.stop()
        finally:
            c.close()

    def test_xadd_is_never_transparently_resent(self):
        b1 = Broker.launch(backend="python")
        port = b1.port
        c = BrokerClient(port=port)
        try:
            assert c.ping()
            b1.stop()
            b2 = Broker.launch(backend="python", port=port)
            try:
                with pytest.raises((ConnectionError, OSError)):
                    c.xadd("s", "YQ==")
                fresh = BrokerClient(port=port)
                try:
                    assert fresh.xlen("s") == 0
                finally:
                    fresh.close()
            finally:
                b2.stop()
        finally:
            c.close()


# --------------------------------------------- against the JAX brokers

#: one command script over every command; replies compared line for line
SCRIPT = [
    "PING", "XADD s YjA= batch", "XADD s YjE= batch", "XADD s ZDA=",
    "XADD s aTA= interactive", "XLEN s", "XLEN s batch",
    "XREADGROUP g c0 s 2 0 interactive,default,batch",
    "XREADGROUP g c0 s 10 0", "XPENDING s g", "XPENDING s g DETAIL",
    "XCLAIM s g c0 0 10", "XCLAIM s g c1 0 1 interactive,default,batch",
    "XCLAIM s g c1 0 10", "XPENDING s g DETAIL", "XACK s g 1",
    "XACK s g 1", "XACK s g 2", "XPENDING s g", "XSHED s batch 1",
    "XSHED s", "XADD s cQ== batch", "XADD s cQ== default", "XSHED s batch 0",
    "XSHED s", "XLEN s", "HSET h k dg==", "HGET h k", "HGET h nope",
    "HKEYS h", "HDEL h k", "HDEL h k", "DEL s", "XLEN s", "NOPE",
]


def _run_script(port):
    sock = socket.create_connection(("127.0.0.1", port), timeout=10)
    f = sock.makefile("rb")
    out = []
    try:
        for line in SCRIPT:
            sock.sendall((line + "\n").encode())
            head = f.readline().decode().rstrip("\n")
            reply = [head]
            if head.startswith("*"):
                reply += [f.readline().decode().rstrip("\n")
                          for _ in range(int(head[1:]))]
            out.append((line, reply))
    finally:
        f.close()
        sock.close()
    return out


def test_same_script_same_replies_as_the_jax_brokers():
    replies = {}
    for name, launch in (("jax-python", lambda: jbroker.Broker.launch(
            backend="python")), ("jax-native", lambda: jbroker.Broker.launch(
                backend="native")), ("port-python", lambda: Broker.launch(
                    backend="python")), ("port-native", lambda: Broker.launch(
                        backend="native"))):
        b = launch()
        try:
            replies[name] = _run_script(b.port)
        finally:
            b.stop()
    ref = replies["jax-native"]
    for name, got in replies.items():
        for (cmd, want), (_, have) in zip(ref, got):
            assert have == want, f"{name} answered {cmd!r} with {have}, " \
                f"JAX's native broker with {want}"
    assert [r for c, r in ref if c == "XSHED s"] == [["*1", "batch"],
                                                     ["*0"]]
    assert dict(ref)["NOPE"][0].startswith("-ERR")


def test_port_native_source_is_its_own_copy():
    own = tbroker.NATIVE_SRC
    assert not os.path.islink(own)
    assert "analytics_zoo_tpu_torch" in str(own.resolve())
    assert own.read_bytes() != open(jbroker._NATIVE_SRC, "rb").read()


class _Doubler:
    def predict(self, x):
        return np.asarray(x) * 2.0


def _ncf():
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.models import NeuralCF
    torch.manual_seed(0)
    ncf = NeuralCF(user_count=20, item_count=10, class_num=3, user_embed=4,
                   item_embed=4, hidden_layers=(8, 4), include_mf=True,
                   mf_embed=4)
    return InferenceModel(device="cpu").load_zoo(ncf)


@pytest.mark.parametrize("direction", ["jax_client_port_plane",
                                       "port_client_jax_plane"])
def test_clients_are_served_by_the_other_package(direction):
    """A JAX InputQueue enqueues into the port's native broker and engine,
    a port InputQueue into JAX's broker and engine; both get what the
    model predicts, lanes and deadlines included."""
    from analytics_zoo_tpu.serving import client as jclient
    from analytics_zoo_tpu.serving import engine as jengine
    from analytics_zoo_tpu_torch.serving import client as tclient
    from analytics_zoo_tpu_torch.serving import engine as tengine
    im = _ncf()
    rng = np.random.RandomState(1)
    x = np.stack([rng.randint(1, 21, 12), rng.randint(1, 11, 12)],
                 1).astype(np.float32)
    want = im.predict(x, batch_size=4)
    if direction == "jax_client_port_plane":
        b = Broker.launch(backend="native")
        cli, eng = jclient, tengine.ClusterServing(
            im, b.port, batch_size=4, max_batch_size=4, warmup=False)
    else:
        b = jbroker.Broker.launch(backend="native")
        cli, eng = tclient, jengine.ClusterServing(
            im, b.port, batch_size=4, max_batch_size=4, warmup=False)
    try:
        with eng:
            iq = cli.InputQueue(port=b.port)
            oq = cli.OutputQueue(port=b.port)
            uris = iq.enqueue_batch(((f"r{i}", {"x": x[i]})
                                     for i in range(8)), priority="batch")
            uris += [iq.enqueue(f"i{i}", priority="interactive",
                                deadline_ms=30_000.0, x=x[8 + i])
                     for i in range(4)]
            got = oq.query_many(uris, timeout=30)
            iq.close()
            oq.close()
        for i, uri in enumerate(uris):
            np.testing.assert_allclose(got[uri], want[i], rtol=1e-6,
                                       atol=1e-7)
        c = b.client()
        assert c.xpending(STREAM, GROUP) == 0
        c.close()
    finally:
        b.stop()


# --------------------------------------------------------------- build

def test_native_build_lands_by_atomic_rename(monkeypatch, tmp_path):
    """The compiler writes a temporary name that is renamed into place:
    a concurrent reader never finds a half-written binary. The binary is
    named by a digest of source and flags."""
    seen = tmp_path / "seen"
    fake = tmp_path / "fake-c++"
    fake.write_text(
        "#!/bin/sh\n"
        "out=\"\"\nwhile [ $# -gt 0 ]; do\n"
        "  if [ \"$1\" = -o ]; then out=\"$2\"; shift; fi; shift\n"
        "done\n"
        f"echo \"$out\" > {seen}\n"
        "printf '#!/bin/sh\\n' > \"$out\"\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(tbroker, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setenv("CXX", str(fake))
    binary = tbroker.build_native_broker()
    target = seen.read_text().strip()
    assert binary == tbroker.native_binary_path() and binary.exists()
    assert target != str(binary) and target.endswith(".tmp")
    assert not os.path.exists(target)
    assert binary.name.startswith("zbroker-") and len(binary.name) == 24
    # built once: a second call reuses it without compiling
    seen.unlink()
    assert tbroker.build_native_broker() == binary and not seen.exists()
