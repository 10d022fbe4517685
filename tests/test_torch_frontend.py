"""The port's HTTP frontend on the CPU, as the JAX package's
test_priority.py / test_timeseries.py drive theirs: ``POST /predict``
bitwise the direct predict, its typed answers (429 shed, 504 expired, 400
bad input), ``GET /metrics`` in JSON, Prometheus text and snapshot form,
``/healthz`` (200, and 503 on a lost broker and on backlog), ``/slo``,
``/query``, ``/metrics/history``, ``?scope=fleet`` and ``/trace``, and
``start`` idempotent with ``stop`` joining the serve thread."""

import json
import re
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.common import slo, telemetry
from analytics_zoo_tpu_torch.inference import InferenceModel
from analytics_zoo_tpu_torch.models import NeuralCF
from analytics_zoo_tpu_torch.serving import (Broker, ClusterServing,
                                             FrontEnd, InputQueue)
from analytics_zoo_tpu_torch.serving import schema

STREAM = "serving_stream"


@pytest.fixture(autouse=True)
def _quiet():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    # the registry is process-wide: start from an empty one, so the
    # counts read back are this test's alone
    telemetry.reset_for_tests()
    slo.set_monitor(None)
    yield
    slo.set_monitor(None)
    torch.set_num_threads(prev)


def _get(port, path, headers=None, timeout=10):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 headers=headers or {})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.headers.get("Content-Type"), r.read().decode()


def _get_json(port, path):
    return json.loads(_get(port, path)[2])


def _post(port, body, timeout=30):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/predict", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read().decode())


def _post_error(port, body):
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(port, body)
    return ei.value.code, json.loads(ei.value.read())


def _ncf():
    torch.manual_seed(0)
    ncf = NeuralCF(user_count=20, item_count=10, class_num=3, user_embed=4,
                   item_embed=4, hidden_layers=(8, 4), include_mf=True,
                   mf_embed=4)
    return InferenceModel(device="cpu").load_zoo(ncf)


class _Slow:
    def predict(self, x):
        time.sleep(0.05)
        return np.asarray(x) * 2.0


def test_predict_typed_answers_metrics_and_health():
    im = _ncf()
    rng = np.random.RandomState(2)
    x = np.stack([rng.randint(1, 21, 6), rng.randint(1, 11, 6)],
                 1).astype(np.float32)
    # a lone request is a batch of 1 padded to the bottom rung, 4
    want = [im.predict(x[i:i + 1], batch_size=4)[0] for i in range(6)]
    with Broker.launch(backend="native") as b, \
            ClusterServing(im, b.port, batch_size=4, max_batch_size=4,
                           warmup=False) as eng, \
            FrontEnd(b.port, engine=eng) as fe:
        assert fe.start() is fe                       # idempotent
        for i in range(6):
            out = _post(fe.port, {
                "uri": f"h{i}", "priority": schema.PRIORITIES[i % 3],
                "deadline_ms": 30_000.0,
                "inputs": {"x": schema.encode_tensor(x[i])}})
            assert out["uri"] == f"h{i}"
            np.testing.assert_array_equal(
                schema.decode_tensor(out["result"]), want[i])
        # empty and malformed inputs: 400
        assert _post_error(fe.port, {"inputs": {}})[0] == 400
        assert _post_error(fe.port, {"x": 1})[0] == 400
        assert _post_error(fe.port, {"priority": "urgent", "inputs": {
            "x": schema.encode_tensor(x[0])}})[0] == 400
        # a shed lane: 429 code=shed
        c = b.client()
        c.xshed_set(STREAM, "batch", True)
        code, body = _post_error(fe.port, {
            "priority": "batch", "inputs": {"x": schema.encode_tensor(x[0])}})
        assert code == 429 and body["code"] == "shed"
        hz = _get_json(fe.port, "/healthz")
        assert hz["shed_lanes"] == ["batch"]
        c.xshed_set(STREAM, "batch", False)
        # Prometheus text: the records counted equal the records served
        status, ctype, text = _get(fe.port, "/metrics?format=prometheus")
        assert status == 200 and ctype.startswith("text/plain; version=0.0.4")
        m = re.search(r'^zoo_serving_records_total\{stream="serving_stream"\}'
                      r' (\S+)$', text, re.M)
        assert m and float(m.group(1)) == eng.metrics()["records_out"] == 6
        assert 'zoo_serving_latency_seconds_bucket{stream="serving_stream",' \
            'priority="interactive",le="+Inf"} 2' in text
        _, _, text2 = _get(fe.port, "/metrics", {"Accept": "text/plain"})
        assert "# TYPE zoo_serving_records_total counter" in text2
        assert _get_json(fe.port, "/metrics")["records_out"] == 6
        snap = _get_json(fe.port, "/metrics?format=snapshot")
        assert snap["zoo_serving_records_total"]["stream=serving_stream"] \
            == 6
        # health, SLO, history, query
        hz = _get_json(fe.port, "/healthz")
        assert hz["status"] == "ok" and hz["engine"] is True
        assert set(hz["lanes"]) == set(schema.PRIORITIES)
        assert hz["admission"] == {"shedding": False, "records_expired": 0}
        assert "burn_rates" in hz["slo"] and hz["decode"][
            "live_sequences"] == 0
        rep = _get_json(fe.port, "/slo")
        assert set(rep["lanes"]) == set(schema.PRIORITIES)
        assert "admission" in rep and {s["name"] for s in rep["slos"]} >= {
            "serving_p99_latency_interactive", "serving_availability"}
        q = _get_json(fe.port, "/query?name=zoo_serving_latency_seconds"
                      "&window=60&agg=p99&priority=interactive")
        assert q["agg"] == "p99" and q["points"][0]["value"] is not None
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(fe.port, "/query")
        assert ei.value.code == 400
        hist = _get_json(fe.port, "/metrics/history?name="
                         "zoo_serving_records_total")
        assert "zoo_serving_records_total" in json.dumps(hist)
        win = _get_json(fe.port, "/metrics/history?format=windows"
                        "&windows=60")
        assert "60s" in win["windows"]
        # the fleet view and the trace answer (they were 404 before the
        # fleet was ported): this replica is the fleet's one live member
        flt = _get_json(fe.port, "/metrics?scope=fleet")
        assert flt["scope"] == "fleet" and flt["partial"] is False
        assert flt["replicas"]["scraped"] == [eng.replica_id]
        assert _get_json(fe.port, "/trace")["displayTimeUnit"] == "ms"
        assert _get_json(fe.port, "/") == {"status": "ok"}
        thread = fe._thread
    assert fe._thread is None and not thread.is_alive()   # stop joined
    fe.stop()                                             # idempotent


def test_expired_deadline_answers_504():
    with Broker.launch(backend="python") as b, \
            ClusterServing(_Slow(), b.port, batch_size=4, max_batch_size=4,
                           warmup=False) as eng, \
            FrontEnd(b.port, engine=eng) as fe:
        in_q = InputQueue(port=b.port)
        in_q.enqueue_batch(
            (f"fill{i}", {"x": np.full(3, i, np.float32)}) for i in range(8))
        code, body = _post_error(fe.port, {
            "uri": "fe1", "deadline_ms": 1.0,
            "inputs": {"x": schema.encode_tensor(
                np.full(3, 3.0, np.float32))}})
        assert code == 504 and body == {
            "uri": "fe1", "code": "expired", "error": body["error"]}
        assert _get_json(fe.port, "/healthz")["admission"][
            "records_expired"] >= 1
        in_q.close()


def test_healthz_503_on_backlog_and_lost_broker():
    b = Broker.launch(backend="python")
    fe = FrontEnd(b.port, max_backlog=2).start()
    try:
        c = b.client()
        for i in range(3):
            c.xadd(STREAM, "YQ==", lane="default")
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(fe.port, "/healthz")
        assert ei.value.code == 503
        assert json.loads(ei.value.read())["reason"] == "backlog"
        c.close()
        b.stop()
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(fe.port, "/healthz")
        body = json.loads(ei.value.read())
        assert ei.value.code == 503 and body["status"] == "unavailable"
    finally:
        fe.stop()
        b.stop()


def test_predict_rides_the_engines_stream():
    """With an engine on a stream of its own, ``POST /predict`` enqueues
    there and reads the engine's result hash (JAX's frontend always takes
    the default stream)."""
    with Broker.launch(backend="python") as b, \
            ClusterServing(_Slow(), b.port, batch_size=2, max_batch_size=2,
                           stream="fe_stream", result_key="fe_result",
                           warmup=False) as eng, \
            FrontEnd(b.port, engine=eng) as fe:
        out = _post(fe.port, {"uri": "s1", "inputs": {
            "x": schema.encode_tensor(np.full(3, 2.0, np.float32))}})
        np.testing.assert_array_equal(schema.decode_tensor(out["result"]),
                                      np.full(3, 4.0, np.float32))
        c = b.client()
        assert c.xlen("serving_stream") == 0
        assert c.hget("fe_result", "s1") is None        # collected
        assert _get_json(fe.port, "/healthz")["lanes"] == {
            "interactive": 0, "default": 0, "batch": 0}
