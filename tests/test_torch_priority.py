"""The port's serving engine schedules as the JAX package's does: priority
lanes under the weighted-deficit order with starvation protection, the
max-wait and deadline-slack triggers, typed expired results, the
admission tick's XSHED flip, lane-ordered lease reclaim, every enqueue
ending as a result, an expired result or a shed, and decode preemption
with its starvation floor. The differential tests drive JAX's engine and
the port's on the same records, turn by turn, and hold them to the same
dispatch order, expiries, tokens and preemption count."""

import time

import numpy as np
import pytest

from analytics_zoo_tpu.serving import broker as jbroker
from analytics_zoo_tpu.serving import client as jclient
from analytics_zoo_tpu.serving import engine as jengine
from analytics_zoo_tpu_torch.common import slo, telemetry
from analytics_zoo_tpu_torch.inference.decode_scheduler import \
    DecodeScheduler
from analytics_zoo_tpu_torch.serving import (Broker, ClusterServing,
                                             InputQueue, OutputQueue,
                                             ShedError)
from analytics_zoo_tpu_torch.serving import client as tclient
from analytics_zoo_tpu_torch.serving import engine as tengine
from analytics_zoo_tpu_torch.serving import schema
from analytics_zoo_tpu_torch.serving.engine import _parse_lane_map

STREAM, GROUP = "serving_stream", "serving"
LANES = ",".join(schema.PRIORITIES)


@pytest.fixture(autouse=True)
def _fresh_slo_monitor():
    """A fresh SLO monitor for every test, so burn windows start at the
    test's first tick."""
    slo.set_monitor(None)
    yield
    slo.set_monitor(None)


def _counter(family, label):
    fam = telemetry.snapshot().get(family, {})
    return float(fam.get(label, 0.0)) if isinstance(fam, dict) else 0.0


class _Track:
    """Doubler that records the distinct row markers of every batch it
    sees — the dispatch-order oracle."""

    def __init__(self, sleep_s=0.0, first_sleep_s=0.0):
        self.sleep_s = sleep_s
        self.first_sleep_s = first_sleep_s
        self.calls = []

    def predict(self, x):
        x = np.asarray(x)
        first = self.first_sleep_s if not self.calls else 0.0
        self.calls.append(sorted(set(float(v) for v in x[:, 0])))
        if first or self.sleep_s:
            time.sleep(first or self.sleep_s)
        return x * 2.0


def _rec(marker):
    return {"x": np.full(3, float(marker), np.float32)}


# ----------------------------------------------------------- lane order

def test_parse_lane_map():
    d = {lane: 0.0 for lane in schema.PRIORITIES}
    assert _parse_lane_map("", d) == d
    assert _parse_lane_map("250", d) == {k: 250.0 for k in d}
    out = _parse_lane_map("interactive=50, batch=4000", d)
    assert out["interactive"] == 50.0 and out["batch"] == 4000.0
    assert out["default"] == 0.0
    with pytest.raises(ValueError):
        _parse_lane_map("interactive=fast", d)


def test_weighted_deficit_lane_order():
    eng = ClusterServing(_Track(), 0, batch_size=4, max_batch_size=4,
                         warmup=False)
    assert eng._lane_order() == LANES
    eng._lane_credit["interactive"] += 100.0
    assert eng._lane_order().split(",")[-1] == "interactive"
    eng._lane_credit["default"] += 1000.0
    order = eng._lane_order().split(",")
    assert order[0] == "batch" and order[-1] == "default"


def test_starvation_protection_batch_drains_under_interactive_load():
    n_int, n_batch = 24, 4
    model = _Track(sleep_s=0.02)
    with Broker.launch(backend="python") as b:
        in_q, out_q = InputQueue(port=b.port), OutputQueue(port=b.port)
        uris = list(in_q.enqueue_batch(
            (f"si{i}", _rec(1 + i)) for i in range(n_int)))
        uris += in_q.enqueue_batch(
            ((f"sb{i}", _rec(100 + i)) for i in range(n_batch)),
            priority="batch")
        with ClusterServing(model, b.port, batch_size=n_batch,
                            max_batch_size=n_batch, pipeline_window=1,
                            warmup=False):
            res = out_q.query_many(uris, timeout=30.0)
        assert all(v is not None for v in res.values())
        markers = {float(100 + i) for i in range(n_batch)}
        hit = [i for i, call in enumerate(model.calls)
               if markers & set(call)]
        assert hit and hit[0] <= 2, f"batch lane starved: {hit}"


def test_max_wait_dispatches_partial_bucket(monkeypatch):
    monkeypatch.setenv("ZOO_SERVING_MAX_WAIT_MS", "150")
    model = _Track()
    with Broker.launch(backend="python") as b:
        with ClusterServing(model, b.port, batch_size=8, max_batch_size=8,
                            block_ms=20, warmup=False):
            in_q, out_q = InputQueue(port=b.port), OutputQueue(port=b.port)
            t0 = time.monotonic()
            uris = list(in_q.enqueue_batch(
                (f"mw{i}", _rec(1 + i)) for i in range(3)))
            res = out_q.query_many(uris, timeout=30.0)
            dt = time.monotonic() - t0
        assert all(v is not None for v in res.values())
        assert len(model.calls) == 1 and \
            set(model.calls[0]) >= {1.0, 2.0, 3.0}
        assert 0.10 <= dt < 5.0, f"dispatch at {dt:.3f}s"


def test_deadline_slack_preempts_max_wait(monkeypatch):
    monkeypatch.setenv("ZOO_SERVING_MAX_WAIT_MS", "5000")
    with Broker.launch(backend="python") as b:
        with ClusterServing(_Track(), b.port, batch_size=8,
                            max_batch_size=8, block_ms=20,
                            warmup=False) as eng:
            in_q, out_q = InputQueue(port=b.port), OutputQueue(port=b.port)
            t0 = time.monotonic()
            uri = in_q.enqueue("ds0", deadline_ms=300.0, **_rec(7))
            assert out_q.query(uri, timeout=30.0) is not None
            dt = time.monotonic() - t0
            assert eng.metrics()["records_expired"] == 0
        assert dt < 3.0, f"held {dt:.3f}s despite a 300ms deadline"


@pytest.mark.parametrize("backend", ["python", "native"])
def test_deadline_expiry_accounting(backend):
    b = Broker.launch(backend=backend)
    try:
        in_q, out_q = InputQueue(port=b.port), OutputQueue(port=b.port)
        label = f"stream={STREAM},priority=interactive"
        exp0 = _counter("zoo_serving_expired_total", label)
        err0 = _counter("zoo_serving_record_errors_total",
                        f"stream={STREAM}")
        dead = in_q.enqueue("exp0", priority="interactive",
                            deadline_ms=30.0, **_rec(1))
        live = in_q.enqueue("ok0", **_rec(2))
        time.sleep(0.1)
        with ClusterServing(_Track(), b.port, batch_size=2,
                            max_batch_size=2, warmup=False) as eng:
            np.testing.assert_allclose(out_q.query(live, timeout=30.0),
                                       np.full(3, 4.0))
            with pytest.raises(schema.DeadlineExpiredError):
                out_q.query(dead, timeout=30.0)
            assert eng.metrics()["records_expired"] == 1
        assert _counter("zoo_serving_expired_total", label) == exp0 + 1
        assert _counter("zoo_serving_record_errors_total",
                        f"stream={STREAM}") == err0
        assert b.client().xpending(STREAM, GROUP) == 0
    finally:
        b.stop()


# -------------------------------------------------- admission control

class _FakeMonitor:
    def __init__(self):
        self.burn = False

    def tick_if_stale(self):
        pass

    def burning(self, name):
        return self.burn

    def stop(self):
        pass


def test_admission_tick_flips_broker_shed_flag():
    fake = _FakeMonitor()
    slo.set_monitor(fake)
    with Broker.launch(backend="native") as b:
        eng = ClusterServing(_Track(), b.port, batch_size=4,
                             max_batch_size=4, warmup=False)
        c = b.client()
        eng._admission_tick(c)
        assert not eng.admission_shedding and c.xshed(STREAM) == []
        fake.burn = True
        eng._last_admission = 0.0
        eng._admission_tick(c)
        assert eng.admission_shedding
        assert c.xshed(STREAM) == [eng.ADMISSION_LANE] == ["batch"]
        with pytest.raises(ShedError):
            c.xadd(STREAM, "YQ==", lane="batch")
        c.xadd(STREAM, "Yg==", lane="interactive")
        label = f"stream={STREAM},priority=batch"
        assert _counter("zoo_serving_admission_state", label) == 1.0
        fake.burn = False
        eng._last_admission = 0.0
        eng._admission_tick(c)
        assert not eng.admission_shedding and c.xshed(STREAM) == []
        c.xadd(STREAM, "YQ==", lane="batch")
        assert _counter("zoo_serving_admission_state", label) == 0.0
        assert _counter("zoo_serving_lane_depth",
                        f"stream={STREAM},priority=interactive") == 1.0


# ------------------------------------------------ lane/lease interplay

def test_lease_reclaim_serves_interactive_before_batch():
    n = 4
    int_markers = {float(1 + i) for i in range(n)}
    batch_markers = {float(100 + i) for i in range(n)}
    with Broker.launch(backend="python") as b:
        in_q, out_q = InputQueue(port=b.port), OutputQueue(port=b.port)
        uris = list(in_q.enqueue_batch(
            ((f"lb{i}", _rec(100 + i)) for i in range(n)),
            priority="batch"))
        uris += in_q.enqueue_batch(
            ((f"li{i}", _rec(1 + i)) for i in range(n)),
            priority="interactive")
        eng_a = ClusterServing(_Track(first_sleep_s=1.0), b.port,
                               batch_size=2 * n, max_batch_size=2 * n,
                               consumer="repA", claim_min_idle_ms=300,
                               reclaim_interval_s=30.0, warmup=False)
        eng_a.start()
        try:
            c = b.client()
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline and \
                    c.xpending_detail(STREAM, GROUP).get("repA") != 2 * n:
                time.sleep(0.02)
            assert c.xpending_detail(STREAM, GROUP) == {"repA": 2 * n}
            model_b = _Track()
            with ClusterServing(model_b, b.port, batch_size=2,
                                max_batch_size=2, consumer="repB",
                                claim_min_idle_ms=300,
                                reclaim_interval_s=0.1,
                                warmup=False) as eng_b:
                res = out_q.query_many(uris, timeout=30.0)
                assert all(v is not None for v in res.values())
                order = [set(call) for call in model_b.calls]
                last_int = max(i for i, s in enumerate(order)
                               if s & int_markers)
                first_batch = min(i for i, s in enumerate(order)
                                  if s & batch_markers)
                assert last_int < first_batch, order
                assert eng_b.metrics()["lease_reclaims"] >= 1
        finally:
            eng_a.stop()
        # A's late finish rewrites the same results and acks harmlessly
        assert c.xpending(STREAM, GROUP) == 0


# ------------------------------------------------ zero-silent-drops

def test_every_enqueue_terminates_result_expired_or_shed():
    n_good, n_exp, n_shed = 4, 2, 2
    shed_label = f"stream={STREAM},priority=batch"
    exp_label = f"stream={STREAM},priority=default"
    with Broker.launch(backend="native") as b:
        in_q, out_q = InputQueue(port=b.port), OutputQueue(port=b.port)
        shed0 = _counter("zoo_serving_shed_total", shed_label)
        exp0 = _counter("zoo_serving_expired_total", exp_label)
        good = list(in_q.enqueue_batch(
            (f"zg{i}", _rec(1 + i)) for i in range(n_good)))
        expired = [in_q.enqueue(f"ze{i}", deadline_ms=25.0, **_rec(10 + i))
                   for i in range(n_exp)]
        time.sleep(0.1)
        c = b.client()
        c.xshed_set(STREAM, "batch", True)
        for i in range(n_shed):
            with pytest.raises(ShedError):
                in_q.enqueue(f"zs{i}", priority="batch", **_rec(20 + i))
        c.xshed_set(STREAM, "batch", False)
        with ClusterServing(_Track(), b.port, batch_size=4,
                            max_batch_size=4, warmup=False) as eng:
            res = out_q.query_many(good, timeout=30.0)
            assert all(v is not None for v in res.values())
            for u in expired:
                with pytest.raises(schema.DeadlineExpiredError):
                    out_q.query(u, timeout=30.0)
            m = eng.metrics()
            assert m["records_out"] == n_good
            assert m["records_expired"] == n_exp
        assert _counter("zoo_serving_shed_total", shed_label) == \
            shed0 + n_shed
        assert _counter("zoo_serving_expired_total", exp_label) == \
            exp0 + n_exp
        assert c.xpending(STREAM, GROUP) == 0


def test_image_and_arrow_records_get_typed_errors():
    """Records that end at intake get typed error results and the loop
    keeps serving: an image whose bytes do not decode (the engine decodes
    image records now) and an Arrow record (still ROADMAP A11's). An
    ``image_preprocess`` chain is taken as given."""
    import base64
    import json
    with Broker.launch(backend="python") as b:
        c = b.client()
        img = {"uri": "img0", "inputs": {"image": {"image": "/9j/4AA="}}}
        arrow = {"uri": "arw0", "data": "QVJST1c="}
        for obj in (img, arrow):
            c.xadd(STREAM, base64.b64encode(json.dumps(obj).encode())
                   .decode())
        in_q, out_q = InputQueue(port=b.port), OutputQueue(port=b.port)
        ok = in_q.enqueue("ok", **_rec(3))
        with ClusterServing(_Track(), b.port, batch_size=4,
                            max_batch_size=4, warmup=False) as eng:
            assert out_q.query(ok, timeout=30.0) is not None
            for uri, pattern in (("img0", "image decode failed"),
                                 ("arw0", "arrow records.*A11")):
                with pytest.raises(schema.ServingError, match=pattern):
                    out_q.query(uri, timeout=30.0)
            assert eng.metrics()["records_failed"] == 2

    def chain(a):
        return a
    assert ClusterServing(_Track(), 0, image_preprocess=chain) \
        .image_preprocess is chain


def test_cpu_fallback_knob_raises(monkeypatch):
    monkeypatch.setenv("ZOO_CPU_FALLBACK", "1")
    with pytest.raises(ValueError, match="A10"):
        ClusterServing(_Track(), 0)


# --------------------------------------------- against JAX's engine

def _drive(eng, client, turns):
    """Run ``turns`` serve-loop turns on the calling thread."""
    pipe = eng._make_pipe()
    for _ in range(turns):
        eng._serve_once(client, pipe)
    for comp in pipe.drain():
        eng._finish(client, comp)


_PACKAGES = {
    "jax": (jbroker.Broker, jengine.ClusterServing, jclient.InputQueue,
            jclient.OutputQueue),
    "port": (Broker, tengine.ClusterServing, tclient.InputQueue,
             tclient.OutputQueue)}


def _lane_scenario(pkg):
    broker_cls, eng_cls, iq_cls, oq_cls = _PACKAGES[pkg]
    model = _Track()
    b = broker_cls.launch(backend="python")
    try:
        iq, oq = iq_cls(port=b.port), oq_cls(port=b.port)
        uris = list(iq.enqueue_batch(((f"b{i}", _rec(100 + i))
                                      for i in range(6)), priority="batch"))
        uris += iq.enqueue_batch(((f"i{i}", _rec(1 + i))
                                  for i in range(10)),
                                 priority="interactive")
        uris += iq.enqueue_batch(((f"d{i}", _rec(50 + i))
                                  for i in range(5)))
        uris += [iq.enqueue(f"x{i}", priority=lane, deadline_ms=1.0,
                            **_rec(200 + i))
                 for i, lane in enumerate(schema.PRIORITIES)]
        time.sleep(0.02)
        eng = eng_cls(model, b.port, batch_size=3, max_batch_size=3,
                      block_ms=0, warmup=False, reclaim_interval_s=1e9)
        c = b.client()
        _drive(eng, c, 12)
        out = {}
        for uri, raw in zip(uris, c.pipeline(
                ("HGET", "result", u) for u in uris)):
            try:
                out[uri] = schema.decode_result(raw)
            except schema.DeadlineExpiredError:
                out[uri] = "expired"
        return model.calls, out, eng.metrics()["records_expired"]
    finally:
        b.stop()


def test_lane_order_and_expiry_agree_with_jax(monkeypatch):
    monkeypatch.setenv("ZOO_SERVING_ADMISSION_S", "0")
    jcalls, jout, jexp = _lane_scenario("jax")
    tcalls, tout, texp = _lane_scenario("port")
    assert tcalls == jcalls
    assert texp == jexp == 3
    assert set(tout) == set(jout)
    for uri, want in jout.items():
        if isinstance(want, str):
            assert tout[uri] == want
        else:
            np.testing.assert_array_equal(tout[uri], want)
    # interactive leads, batch is served before interactive drains
    assert jcalls[0] == [1.0, 2.0, 3.0]


class _Decoder:
    """Duck-typed encoder/decoder for both engines: a causal numpy step
    (each position sees only itself and earlier ones) and a doubling
    predict for plain records."""

    def __init__(self, dim=6, seed=0):
        rng = np.random.default_rng(seed)
        self.w = rng.standard_normal((dim, dim)).astype(np.float32)
        self.calls = 0

    def decode_step_fn(self):
        def step(enc, dec):
            enc = np.asarray(enc, np.float32)
            dec = np.asarray(dec, np.float32)
            h = np.cumsum(dec @ self.w, axis=1)
            return h + enc.mean(axis=1, keepdims=True)
        return step

    def predict(self, x):
        self.calls += 1
        return np.asarray(x) * 2.0


def _decode_scenario(pkg):
    broker_cls, eng_cls, iq_cls, oq_cls = _PACKAGES[pkg]
    model = _Decoder()
    b = broker_cls.launch(backend="python")
    try:
        iq, oq = iq_cls(port=b.port), oq_cls(port=b.port)
        rng = np.random.default_rng(5)
        gens = [iq.enqueue(f"g{i}", priority="batch",
                           generate={"max_new_tokens": 9},
                           x=rng.standard_normal((4, 6)).astype(np.float32),
                           start=np.eye(6, dtype=np.float32)[i])
                for i in range(3)]
        eng = eng_cls(model, b.port, batch_size=4, max_batch_size=4,
                      block_ms=0, warmup=False, reclaim_interval_s=1e9)
        c = b.client()
        _drive(eng, c, 2)
        # interactive records trickle in and wait for a full bucket: each
        # outranks the decoding batch lane
        preds = []
        for t in range(4):
            preds.append(iq.enqueue(f"p{t}", priority="interactive",
                                    x=np.full((3,), t, np.float32)))
            _drive(eng, c, 3)
        _drive(eng, c, 40)
        tokens = {u: oq.query(u, timeout=5.0) for u in gens}
        served = {u: oq.query(u, timeout=5.0) for u in preds}
        return (tokens, served, int(eng._preempt_counter.value),
                eng._decode_sched.steps_run)
    finally:
        b.stop()


def test_decode_preemption_agrees_with_jax(monkeypatch):
    monkeypatch.setenv("ZOO_SERVING_ADMISSION_S", "0")
    monkeypatch.setenv("ZOO_SERVING_MAX_WAIT_MS", "interactive=60000")
    jtok, jpred, jpre, jsteps = _decode_scenario("jax")
    ttok, tpred, tpre, tsteps = _decode_scenario("port")
    assert tpre == jpre and tsteps == jsteps
    assert 0 < tpre <= ClusterServing.DECODE_STARVATION_FLOOR * tsteps
    for u, want in jtok.items():
        assert want.shape == (9, 6)
        np.testing.assert_array_equal(ttok[u], want)
    for u, want in jpred.items():
        np.testing.assert_array_equal(tpred[u], want)


def test_engine_defers_decode_to_hotter_lane_with_starvation_floor():
    eng = ClusterServing(object(), 0, warmup=False)
    step = _Decoder().decode_step_fn()
    sched = DecodeScheduler(step, max_batch=2, max_seq=16, page_size=4)
    seq = sched.admit(np.zeros((4, 6), np.float32),
                      np.eye(6, dtype=np.float32)[0], 8, mode="greedy")
    eng._decode_sched = sched
    eng._gen_live[seq] = ("u1", ("XACK",), None, "batch", eng._conn_gen)
    eng._asm = [(1, "u2", {}, None, "interactive", 0.0, None, None)]
    eng._lane_credit.update({"interactive": 0.0, "batch": 5.0})
    before = eng._preempt_counter.value
    for _ in range(eng.DECODE_STARVATION_FLOOR):
        assert eng._decode_tick(None) == 0
    assert sched.steps_run == 0
    eng._decode_tick(None)
    assert sched.steps_run == 1
    assert eng._preempt_counter.value - before == \
        eng.DECODE_STARVATION_FLOOR
    eng._asm = []
    eng._decode_tick(None)
    assert sched.steps_run == 2
    sched.abort_all()
