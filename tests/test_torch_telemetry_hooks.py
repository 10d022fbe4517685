"""The four device hooks (``instrument_jit``, ``traced_device_put`` /
``traced_device_get``, ``timed_block_until_ready``) and the registry's
other A10 readings in the port against the JAX package's, on the CPU.

- The same call sequence through both packages' hooks gives equal
  ``zoo_jit_calls_total`` / ``zoo_jit_cache_misses_total`` (a new
  signature is JAX's recompile), equal transfer bytes and the same
  blocked-time observation count.
- A keras fit (2 epochs of 8 steps), a cached epoch and a predict of 10
  rows (two padded chunks of 8) count the same calls, misses and bytes at
  the same sites as JAX's estimator, and mirror the same training
  summaries into the registry (the loss's gauge, the step-time histogram
  a window, the learning rate).
- ``InferenceModel`` counts a miss per new batch signature.
- ``decode_loop`` records JAX's ``decode_step_<t>`` spans on each trace
  id; the data pool's runs land on ``zoo_data_transform_seconds`` and
  ``zoo_data_workers_busy`` (``OP_TOTALS`` and ``workers_busy`` are views
  of them).

JAX is imported by fixtures only.
"""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.common import telemetry


@pytest.fixture(autouse=True)
def _fresh(monkeypatch, tmp_path):
    from analytics_zoo_tpu_torch.learn import estimator
    monkeypatch.setattr(estimator, "DEFAULT_LOG_DIR", str(tmp_path / "logs"))
    telemetry.reset_for_tests()
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
    telemetry.reset_for_tests()


@pytest.fixture(scope="module")
def jx():
    import jax
    jax.config.update("jax_platforms", "cpu")
    from analytics_zoo_tpu.common import telemetry as jtel
    from analytics_zoo_tpu.keras import Input, Model
    from analytics_zoo_tpu.keras import layers as jl
    return dict(jax=jax, tel=jtel, Input=Input, Model=Model, jl=jl)


def _hooks_and_io(tel):
    f = tel.instrument_jit(lambda a, b, k=1: a, name="f")
    g = tel.instrument_jit(name="g")(lambda t: t)
    x2, x4 = np.ones((2, 3), np.float32), np.ones((4, 3), np.float32)
    for args, kw in (((x2, 1), {}), ((x2, 1), {}), ((x4, 1), {}),
                     ((x2, 2), {}), ((x2, 1), {"k": 3}), ((x2, 1), {})):
        f(*args, **kw)
    for tree in ((x2,), [x2, {"a": x4}], (x2,)):
        g(tree)
    # int32: JAX without x64 makes an int64 leaf int32 on the device
    put = tel.traced_device_put({"a": x2, "b": [x4, np.arange(
        5, dtype=np.int32)]})
    tel.traced_device_get(put)
    tel.traced_device_get([x2])
    tel.timed_block_until_ready(put, site="s")
    snap = tel.snapshot()
    return ({k: snap[k] for k in ("zoo_jit_calls_total",
                                  "zoo_jit_cache_misses_total",
                                  "zoo_device_transfer_bytes_total",
                                  "zoo_device_last_transfer_bytes")},
            snap["zoo_device_block_seconds"]["site=s"]["count"],
            f.cache_misses)


def test_hook_counters_are_jax(jx):
    got = _hooks_and_io(telemetry)
    jx["tel"].reset_for_tests()
    want = _hooks_and_io(jx["tel"])
    assert got == want
    assert got[0]["zoo_jit_cache_misses_total"]["fn=f"] == 4
    assert got[0]["zoo_device_transfer_bytes_total"]["direction=h2d"] == \
        4 * 6 + 4 * 12 + 4 * 5


def test_device_put_and_get_move_tensors():
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    out = telemetry.traced_device_put((x, {"t": torch.ones(2)}), "cpu")
    assert isinstance(out[0], torch.Tensor) and out[1]["t"].device.type == \
        "cpu"
    back = telemetry.traced_device_get(out)
    np.testing.assert_array_equal(back[0].numpy(), x)
    assert telemetry.snapshot()["zoo_device_transfer_bytes_total"] == {
        "direction=h2d": 32.0, "direction=d2h": 32.0}


def _counters(snap):
    keep = ("zoo_jit_calls_total", "zoo_jit_cache_misses_total",
            "zoo_device_transfer_bytes_total",
            "zoo_device_last_transfer_bytes", "zoo_training_learning_rate")
    out = {k: snap.get(k) for k in keep}
    out["step_windows"] = snap["zoo_training_step_seconds"]["count"]
    out["loss_gauge"] = "zoo_training_loss" in snap
    return out


def test_fit_cached_epoch_and_predict_count_like_jax(jx):
    x = np.random.RandomState(0).rand(64, 4).astype(np.float32)
    y = np.random.RandomState(1).rand(64, 2).astype(np.float32)

    def run(L, Input, Model, kw):
        inp = Input(shape=(4,))
        m = Model(input=inp, output=L.Dense(2)(inp))
        m.compile(optimizer="sgd", loss="mse", **kw)
        m.fit(x, y, batch_size=8, nb_epoch=2)
        m.fit(x, y, batch_size=8, nb_epoch=1, cache="device")
        assert m.predict(x[:10], batch_size=8).shape == (10, 2)

    from analytics_zoo_tpu_torch.keras import Input, Model
    from analytics_zoo_tpu_torch.keras import layers as tl
    run(tl, Input, Model, {"device": "cpu"})
    got = _counters(telemetry.snapshot())
    # JAX on one device (its cached epoch refuses a sharded batch)
    from analytics_zoo_tpu.parallel import mesh as jmesh
    jx["tel"].reset_for_tests()
    jmesh.build_mesh(devices=jx["jax"].devices()[:1])
    try:
        run(jx["jl"], jx["Input"], jx["Model"], {})
    finally:
        jmesh.build_mesh()
    want = _counters(jx["tel"].snapshot())
    assert got == want
    assert got["zoo_jit_calls_total"]["fn=estimator_train_step"] == 16
    assert got["zoo_jit_cache_misses_total"][
        "fn=estimator_train_step"] == 1


def test_inference_model_counts_a_miss_per_batch_signature():
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.keras import Input, Model
    from analytics_zoo_tpu_torch.keras import layers as tl
    inp = Input(shape=(4,))
    im = InferenceModel(device="cpu").load_zoo(
        Model(input=inp, output=tl.Dense(2)(inp)))
    x = np.ones((8, 4), np.float32)
    im.predict(x, batch_size=8)
    im.predict(x, batch_size=8)
    im.predict(x[:3], batch_size=3)
    snap = telemetry.snapshot()
    assert snap["zoo_jit_calls_total"]["fn=inference_model"] == 3
    assert snap["zoo_jit_cache_misses_total"]["fn=inference_model"] == 2
    assert snap["zoo_device_transfer_bytes_total"]["direction=d2h"] == \
        4 * 2 * (8 + 8 + 3)


def test_decode_spans_are_jax(jx):
    from analytics_zoo_tpu.inference import generation as jgen
    from analytics_zoo_tpu_torch.inference import generation as tgen
    enc = np.zeros((2, 3, 4), np.float32)
    start = np.zeros(5, np.float32)

    def fn(e, dec):
        return np.repeat(dec[:, :, :], 1, axis=0) + 0.5

    def names(tel, gen):
        gen.decode_loop(fn, enc, start, 3, trace_ids=("a", "b"))
        return {uri: [(s.name, s.parent) for s in tel.get_tracer().get(uri)]
                for uri in ("a", "b")}

    got = names(telemetry, tgen)
    jx["tel"].reset_for_tests()
    want = names(jx["tel"], jgen)
    assert got == want
    assert got["a"] == [(f"decode_step_{t}", "device") for t in (1, 2, 3)]


def test_data_pool_runs_land_on_the_registry(monkeypatch):
    from analytics_zoo_tpu_torch.data import shard as shard_lib
    monkeypatch.setenv("ZOO_DATA_WORKERS", "2")
    xs = shard_lib.XShards.partition(
        {"x": np.arange(40, dtype=np.float32).reshape(20, 2)},
        num_shards=4)
    xs.transform_shard(lambda s: {"x": s["x"] * 2}).collect()
    snap = telemetry.snapshot()
    hist = snap["zoo_data_transform_seconds"]["op=transform_shard"]
    assert hist["count"] >= 1
    assert shard_lib.OP_TOTALS["transform_shard"][0] == hist["count"]
    assert snap["zoo_data_workers_busy"] == 0 == shard_lib.workers_busy
