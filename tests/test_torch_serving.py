"""The port's serving path on the CPU: wire schema, the Python broker's
protocol, InferenceModel's device rule, and ClusterServing end to end.

Records and results are byte-compatible with the JAX package's schema, so
the two packages' clients can share a broker. ClusterServing runs an NCF
model on ``device="cpu"``; its results must equal the direct predict.
"""

import threading
import time

import numpy as np
import pytest
import torch

from analytics_zoo_tpu.serving import schema as jschema
from analytics_zoo_tpu_torch.inference import InferenceModel
from analytics_zoo_tpu_torch.models import NeuralCF
from analytics_zoo_tpu_torch.serving import (Broker, ClusterServing,
                                             InputQueue, OutputQueue,
                                             ServingError)
from analytics_zoo_tpu_torch.serving import schema


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # tiny shapes: one intra-op thread, so parallel test workers do not
    # oversubscribe the host's cores
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def broker():
    b = Broker.launch(backend="python")
    yield b
    b.stop()


def _model():
    ncf = NeuralCF(user_count=20, item_count=10, class_num=3, user_embed=4,
                   item_embed=4, hidden_layers=(8, 4), include_mf=True,
                   mf_embed=4)
    return InferenceModel(device="cpu").load_zoo(ncf)


def _pairs(n, seed=0):
    rng = np.random.RandomState(seed)
    return np.stack([rng.randint(1, 21, n), rng.randint(1, 11, n)],
                    1).astype(np.float32)


# ------------------------------------------------------------------ schema

@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32,
                                   np.int64, np.uint8, np.bool_])
def test_tensor_roundtrip(dtype):
    arr = (np.arange(24).reshape(2, 3, 4) % 3).astype(dtype)
    back = schema.decode_tensor(schema.encode_tensor(arr))
    assert back.dtype == arr.dtype
    np.testing.assert_array_equal(back, arr)


def test_record_result_and_error_roundtrip():
    inputs = {"x": np.arange(6, dtype=np.float32).reshape(2, 3),
              "y": np.array([1, 2], np.int64)}
    uri, back = schema.decode_record(schema.encode_record("r-1", inputs))
    assert uri == "r-1" and set(back) == {"x", "y"}
    np.testing.assert_array_equal(back["x"], inputs["x"])
    res = schema.decode_result(schema.encode_result(np.ones(3)))
    np.testing.assert_array_equal(res, np.ones(3))
    with pytest.raises(ServingError, match="boom"):
        schema.decode_result(schema.encode_error("boom"))


def test_records_are_compatible_with_the_jax_schema():
    x = {"x": np.array([3.0, 4.0], np.float32)}
    uri, back = jschema.decode_record(schema.encode_record("u1", x))
    np.testing.assert_array_equal(back["x"], x["x"])
    uri, back = schema.decode_record(jschema.encode_record("u2", x))
    assert uri == "u2"
    np.testing.assert_array_equal(back["x"], x["x"])
    np.testing.assert_array_equal(
        jschema.decode_result(schema.encode_result(np.arange(3))),
        np.arange(3))


def test_cipher_roundtrip():
    cipher = (lambda b: b[::-1], lambda b: b[::-1])
    payload = schema.encode_record("c", {"x": np.ones(2)}, cipher)
    assert schema.decode_record(payload, cipher)[0] == "c"


@pytest.mark.parametrize("uri", ["", "a b", "x\ny", "a" * 257, None])
def test_bad_uris_rejected(uri):
    with pytest.raises(ValueError):
        schema.validate_uri(uri)


# ------------------------------------------------------------------ broker

def test_broker_stream_group_and_hash(broker):
    c = broker.client()
    assert c.ping()
    ids = [c.xadd("s", f"p{i}") for i in range(5)]
    assert ids == [1, 2, 3, 4, 5] and c.xlen("s") == 5
    got = c.xreadgroup("g", "c1", "s", 3)
    assert got == [(1, "p0"), (2, "p1"), (3, "p2")]
    assert c.xreadgroup("g", "c1", "s", 10) == [(4, "p3"), (5, "p4")]
    assert c.xreadgroup("g", "c1", "s", 10, block_ms=20) == []
    assert c.xpending("s", "g") == 5
    assert c.xack("s", "g", 1) == 1 and c.xack("s", "g", 1) == 0
    for eid in range(2, 6):
        c.xack("s", "g", eid)
    assert c.xpending("s", "g") == 0 and c.xlen("s") == 0   # collected
    c.hset("h", "k", "v")
    assert c.hget("h", "k") == "v" and c.hkeys("h") == ["k"]
    assert c.hdel("h", "k") == 1 and c.hget("h", "k") is None
    assert c.pipeline([("HSET", "h", "a", "1"), ("HGET", "h", "a")]) == \
        ["OK", "1"]
    with pytest.raises(RuntimeError, match="unknown command"):
        c.pipeline([("NOPE",)])
    c.close()


def test_blocking_read_wakes_on_xadd(broker):
    reader, writer = broker.client(), broker.client()
    out = []
    t = threading.Thread(target=lambda: out.extend(
        reader.xreadgroup("g", "c", "s", 1, block_ms=5000)))
    t.start()
    writer.xadd("s", "late")
    t.join(timeout=10)
    assert not t.is_alive() and out == [(1, "late")]


def test_uncollected_results_expire():
    with Broker.launch(hash_ttl_ms=50) as b:
        c = b.client()
        c.hset("h", "k", "v")
        time.sleep(0.3)
        assert c.hget("h", "k") is None


def test_only_the_python_backend(monkeypatch, tmp_path):
    """Where the native broker cannot be built, only the Python backend
    runs: ``backend="native"`` raises with the build's error, ``"auto"``
    falls back to Python and ``Broker.backend`` says so."""
    from analytics_zoo_tpu_torch.serving import broker as broker_mod
    monkeypatch.setattr(broker_mod, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="native broker build failed"):
        Broker.launch(backend="native")
    with Broker.launch(backend="auto") as b:
        assert b.backend == "python" and b.client().ping()
    with pytest.raises(ValueError, match="backend"):
        Broker.launch(backend="redis")


# --------------------------------------------------------------- end to end

def test_cluster_serving_matches_direct_predict(broker):
    im = _model()
    x = _pairs(30)
    want = im.predict(x)
    with ClusterServing(im, broker.port, batch_size=8) as serving:
        iq, oq = InputQueue(port=broker.port), OutputQueue(port=broker.port)
        uris = iq.enqueue_batch((f"r{i}", {"x": x[i]}) for i in range(25))
        uris.append(iq.enqueue("single", x=x[25]))
        got = oq.query_many(uris, timeout=30)
        one = oq.query("single", timeout=30, delete=True)
        iq.close()
        oq.close()
    for i, uri in enumerate(uris):
        np.testing.assert_allclose(got[uri], want[i], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(one, want[25], rtol=1e-5, atol=1e-6)
    m = serving.metrics()
    assert m["records_out"] == 26 and m["records_failed"] == 0
    assert m["batches"] >= 4


def test_malformed_records_get_error_results(broker):
    im = _model()
    x = _pairs(4)
    iq, oq = InputQueue(port=broker.port), OutputQueue(port=broker.port)
    # queued before serving starts, so all three arrive in one batch
    uris = iq.enqueue_batch([("ok0", {"x": x[0]}), ("ok1", {"x": x[1]}),
                             ("bad", {"x": np.ones(3, np.float32)})])
    with ClusterServing(im, broker.port, batch_size=8, block_ms=200) \
            as serving:
        res = oq.query_many(["ok0", "ok1"], timeout=30)
        assert all(res[u] is not None for u in ("ok0", "ok1"))
        with pytest.raises(ServingError, match="tensor shapes"):
            oq.query("bad", timeout=30)
        broker.client().xadd("serving_stream", "not-base64!")
        iq.enqueue("after", x=x[2])
        assert oq.query("after", timeout=30) is not None
    assert uris == ["ok0", "ok1", "bad"]
    assert serving.metrics()["records_failed"] == 1


def test_failed_batch_gets_error_results(broker):
    class Broken:
        def predict_async(self, x):
            raise RuntimeError("device fell over")

        def predict_fetch(self, pending):
            raise AssertionError("never fetched")

    with ClusterServing(Broken(), broker.port, batch_size=4) as serving:
        iq, oq = InputQueue(port=broker.port), OutputQueue(port=broker.port)
        iq.enqueue("r", x=np.zeros(2, np.float32))
        with pytest.raises(ServingError, match="device fell over"):
            oq.query("r", timeout=30)
    assert serving.metrics()["records_failed"] == 1
    c = broker.client()
    assert c.xpending("serving_stream", "serving") == 0   # acked


def test_inference_model_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    for device in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            InferenceModel(device=device)
    assert InferenceModel(device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="no model loaded"):
        InferenceModel(device="cpu").predict(np.zeros((1, 2)))


# ------------------------------------------------- delivery and recovery
# (the JAX package's test_serving.py counterparts, on both brokers)

@pytest.fixture(params=["python", "native"])
def any_broker(request):
    b = Broker.launch(backend=request.param)
    yield b
    b.stop()


def test_xclaim_redelivers_dead_consumer_pending(any_broker):
    c = any_broker.client()
    for _ in range(3):
        c.xadd("s", "ZA==")
    got = c.xreadgroup("g", "c0", "s", 3)
    assert len(got) == 3 and c.xpending("s", "g") == 3
    assert c.xreadgroup("g", "c1", "s", 3) == []
    assert c.xclaim("s", "g", "c1", 60000, 10) == []
    claimed = c.xclaim("s", "g", "c1", 0, 10)
    assert [e[0] for e in claimed] == [e[0] for e in got]
    assert claimed[0][1] == "ZA=="
    for eid, _ in claimed:
        c.xack("s", "g", eid)
    assert c.xpending("s", "g") == 0 and c.xlen("s") == 0


def test_engine_recovers_orphaned_pending(any_broker):
    im = _model()
    x = _pairs(1, seed=4)
    in_q = InputQueue(port=any_broker.port)
    in_q.enqueue("orphan", x=x[0])
    ghost = any_broker.client().xreadgroup("serving", "dead",
                                           "serving_stream", 10)
    assert len(ghost) == 1
    with ClusterServing(im, any_broker.port, batch_size=2,
                        max_batch_size=2, claim_min_idle_ms=0,
                        warmup=False) as serving:
        got = OutputQueue(port=any_broker.port).query("orphan", timeout=20)
        assert got is not None
        m = serving.metrics()
    np.testing.assert_allclose(got, im.predict(x)[0], rtol=1e-5, atol=1e-6)
    assert m["records_redelivered"] == 1 and m["lease_reclaims"] == 1
    assert any_broker.client().xpending("serving_stream", "serving") == 0


def test_engine_survives_broker_restart():
    im = _model()
    x = _pairs(2, seed=5)
    b1 = Broker.launch(backend="python")
    port = b1.port
    eng = ClusterServing(im, port, batch_size=2, max_batch_size=2,
                         warmup=False).start()
    try:
        in_q, out_q = InputQueue(port=port), OutputQueue(port=port)
        in_q.enqueue("before", x=x[0])
        assert out_q.query("before", timeout=30.0) is not None
        b1.stop()
        b2 = Broker.launch(backend="python", port=port)
        try:
            InputQueue(port=port).enqueue("after", x=x[1])
            assert OutputQueue(port=port).query("after", timeout=30.0) \
                is not None, "the engine never redialed the new broker"
        finally:
            eng.stop()
            b2.stop()
    finally:
        eng.stop()


def test_one_bad_postprocess_keeps_rest_of_batch(any_broker):
    im = _model()
    x = _pairs(8, seed=3)
    want = im.predict(x)
    thr = float(np.median(want[:, 0]))
    bad = {f"p{i}" for i in range(8) if want[i, 0] > thr}
    assert bad and len(bad) < 8

    def post(pred):
        if pred[0] > thr:
            raise ValueError("boom")
        return pred

    with ClusterServing(im, any_broker.port, batch_size=4, max_batch_size=4,
                        postprocess=post, warmup=False):
        in_q = InputQueue(port=any_broker.port)
        out_q = OutputQueue(port=any_broker.port)
        for i in range(8):
            in_q.enqueue(f"p{i}", x=x[i])
        for i in range(8):
            uri = f"p{i}"
            if uri in bad:
                with pytest.raises(ServingError, match="postprocess"):
                    out_q.query(uri, timeout=20.0)
            else:
                np.testing.assert_allclose(out_q.query(uri, timeout=20.0),
                                           want[i], rtol=1e-5, atol=1e-6)
    assert any_broker.client().xpending("serving_stream", "serving") == 0
