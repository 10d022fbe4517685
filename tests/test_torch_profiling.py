"""The port's profiling layer (common/profiling.py) on the CPU, as the JAX
package's tests/test_profiling.py drives its own: the Chrome trace's
golden structure (the same spans fed to both packages' tracers give the
same JSON apart from ``pid``), the step profiler's MFU on known inputs,
"no peak, no MFU", the env override, the phase histogram and sampling,
the flight recorder (ring, dump, SIGTERM chaining), the backend probe
(and a wedged one), ``GET /trace`` and ``/healthz``'s backend over HTTP;
and the flop count: an MLP step equals its hand count, a BERT step counts
the same through the flash Function as through the einsum chain, a
``fit`` publishes flops and HBM bytes (MFU under ``ZOO_PEAK_FLOPS``), and
a fit with the count taken ends bit for bit where one without it does.
JAX is imported inside tests only."""

import json
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.common import profiling, telemetry


@pytest.fixture(autouse=True)
def fresh_telemetry(monkeypatch, tmp_path):
    from analytics_zoo_tpu_torch.learn import estimator
    monkeypatch.setattr(estimator, "DEFAULT_LOG_DIR", str(tmp_path / "logs"))
    for var in ("BENCH_PEAK_FLOPS", "ZOO_PEAK_FLOPS"):
        monkeypatch.delenv(var, raising=False)
    telemetry.reset_for_tests()
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
    telemetry.reset_for_tests()


def _record_serving_style_trace(tracer, uri="rec-0", t0=100.0):
    tracer.record(uri, "total", t0, t0 + 0.010)
    tracer.record(uri, "dequeue", t0, t0 + 0.001, parent="total")
    tracer.record(uri, "preprocess", t0 + 0.001, t0 + 0.003, parent="total")
    tracer.record(uri, "device", t0 + 0.003, t0 + 0.009, parent="total")
    tracer.record(uri, "postprocess", t0 + 0.009, t0 + 0.010, parent="total")


# ------------------------------------------------------------ chrome trace

def test_golden_structure():
    tracer = telemetry.get_tracer()
    _record_serving_style_trace(tracer, "rec-0", t0=100.0)
    obj = profiling.chrome_trace()
    assert obj["displayTimeUnit"] == "ms"
    ev = obj["traceEvents"]
    assert json.loads(json.dumps(obj)) == obj
    meta = [e for e in ev if e["ph"] == "M"]
    assert meta[0]["name"] == "process_name"
    assert meta[0]["args"]["name"] == "analytics_zoo_tpu"
    assert meta[0]["pid"] == os.getpid()
    assert [m["args"]["name"] for m in meta[1:]] == ["rec-0"]
    xs = {e["name"]: e for e in ev if e["ph"] == "X"}
    assert set(xs) == {"total", "dequeue", "preprocess", "device",
                       "postprocess"}
    for e in xs.values():
        assert e["cat"] == "zoo" and e["tid"] == meta[1]["tid"]
        assert e["args"]["trace_id"] == "rec-0"
    assert xs["total"]["ts"] == 0.0
    assert xs["total"]["dur"] == pytest.approx(10_000.0)
    assert xs["device"]["ts"] == pytest.approx(3_000.0)
    assert xs["device"]["dur"] == pytest.approx(6_000.0)
    assert xs["dequeue"]["args"]["parent"] == "total"


def test_same_spans_give_jax_json_apart_from_pid():
    from analytics_zoo_tpu.common import profiling as jprof
    from analytics_zoo_tpu.common import telemetry as jtel
    jt, pt = jtel.Tracer(), telemetry.Tracer()
    for tracer in (jt, pt):
        _record_serving_style_trace(tracer, "rec-a", t0=10.0)
        _record_serving_style_trace(tracer, "rec-b", t0=10.004)
        tracer.record("train/step-4", "step", 11.0, 11.5)
    for tid in (None, "rec-b"):
        want = jprof.chrome_trace(tid, tracer=jt)
        got = profiling.chrome_trace(tid, tracer=pt)
        for e in want["traceEvents"] + got["traceEvents"]:
            e.pop("pid")
        assert got == want


def test_trace_id_filter_multi_track_and_dump(tmp_path):
    tracer = telemetry.get_tracer()
    _record_serving_style_trace(tracer, "rec-a", t0=10.0)
    _record_serving_style_trace(tracer, "rec-b", t0=20.0)
    tids = {e["tid"] for e in profiling.chrome_trace()["traceEvents"]
            if e["ph"] == "X"}
    assert len(tids) == 2
    only = profiling.chrome_trace("rec-b")
    assert {e["args"]["name"] for e in only["traceEvents"]
            if e["name"] == "thread_name"} == {"rec-b"}
    p = telemetry.dump_trace(str(tmp_path / "sub" / "trace.json"))
    with open(p) as fh:
        obj = json.load(fh)
    assert any(e["ph"] == "X" and e["name"] == "device"
               for e in obj["traceEvents"])
    telemetry.get_tracer().clear()
    empty = profiling.chrome_trace()
    assert [e for e in empty["traceEvents"] if e["ph"] == "X"] == []


# ----------------------------------------------------------- step profiler

def test_mfu_is_exact_for_known_inputs():
    prof = profiling.StepProfiler(name="t", sample_every=1, peak_flops=1e10)
    prof.set_flops(1e9)
    prof.observe_step(0, t_start=0.0, data_wait_s=0.01, dispatch_s=0.001,
                      device_s=0.5)
    snap = telemetry.snapshot()
    assert snap["zoo_step_flops"] == 1e9
    assert snap["zoo_mfu"] == pytest.approx(1e9 / 0.5 / 1e10)
    prof2 = profiling.StepProfiler(name="t2", sample_every=1,
                                   peak_flops=1e10)
    prof2.set_flops(4e9, per_steps=4)
    prof2.observe_step(0, 0.0, 0.01, 0.001, device_s=0.5, n_steps=4)
    assert telemetry.snapshot()["zoo_mfu"] == pytest.approx(
        4 * 1e9 / 0.5 / 1e10)


def test_no_peak_means_no_mfu():
    prof = profiling.StepProfiler(name="t", sample_every=1, device="cpu")
    assert prof.peak_flops is None     # the CPU: no table row, no env
    prof.set_flops(1e9)
    prof.observe_step(0, 0.0, 0.01, 0.001, device_s=0.5)
    snap = telemetry.snapshot()
    assert snap["zoo_step_flops"] == 1e9 and "zoo_mfu" not in snap


def test_env_peak_override_and_table(monkeypatch):
    assert profiling.device_peak_flops("cpu") is None
    assert profiling.PEAK_FLOPS["NVIDIA H100 80GB HBM3"] == 989.4e12
    monkeypatch.setenv("BENCH_PEAK_FLOPS", "2.5e12")
    assert profiling.device_peak_flops() == 2.5e12
    assert profiling.StepProfiler(sample_every=1).peak_flops == 2.5e12
    monkeypatch.delenv("BENCH_PEAK_FLOPS")
    monkeypatch.setenv("ZOO_PEAK_FLOPS", "1e12")
    assert profiling.device_peak_flops("cpu") == 1e12


def test_phase_histogram_and_sampling():
    prof = profiling.StepProfiler(name="t", sample_every=4)
    assert [prof.should_sample(s) for s in range(5)] == \
        [True, False, False, False, True]
    for step in range(8):
        dev = 0.2 if prof.should_sample(step) else None
        prof.observe_step(step, 0.0, 0.01, 0.001, device_s=dev,
                          callback_s=0.002)
    h = telemetry.snapshot()["zoo_train_phase_seconds"]
    assert h["phase=data_wait"]["count"] == 8
    assert h["phase=dispatch"]["count"] == 8
    assert h["phase=callback"]["count"] == 8
    assert h["phase=device"]["count"] == 2


def test_sampled_step_trace_decomposition():
    prof = profiling.StepProfiler(name="train", sample_every=1)
    prof.observe_step(7, t_start=50.0, data_wait_s=0.010, dispatch_s=0.002,
                      device_s=0.100, callback_s=0.005)
    spans = {s.name: s for s in telemetry.get_tracer().get("train/step-7")}
    assert set(spans) == {"step", "data_wait", "dispatch", "device",
                          "callback"}
    assert spans["device"].start == pytest.approx(50.010)
    assert spans["device"].end == pytest.approx(50.110)
    assert spans["callback"].end == spans["step"].end
    assert all(spans[n].parent == "step"
               for n in ("data_wait", "dispatch", "device", "callback"))


def test_hbm_bytes_of_live_tensors_on_cpu():
    keep = [torch.zeros(128, 128), {"m": torch.ones(10)}]
    n, src = profiling.hbm_bytes("cpu", keep)
    assert (n, src) == (128 * 128 * 4 + 40, "live_tensors")
    assert profiling.hbm_bytes("cpu", lambda: keep)[0] == n
    assert profiling.hbm_bytes("cpu") == (None, "unavailable")
    prof = profiling.StepProfiler(sample_every=1, device="cpu",
                                  live_tensors=keep)
    prof.observe_step(0, 0.0, 0.01, 0.001, device_s=0.1)
    assert telemetry.snapshot()["zoo_hbm_bytes"] == {
        "source=live_tensors": float(n)}


# -------------------------------------------------------------- flop count

def _mlp():
    torch.manual_seed(0)
    return torch.nn.Sequential(torch.nn.Linear(6, 16), torch.nn.ReLU(),
                               torch.nn.Dropout(0.2), torch.nn.Linear(16, 3))


def test_mlp_step_flops_equal_the_hand_count():
    from analytics_zoo_tpu_torch.learn.estimator import Estimator
    est = Estimator.from_torch(model=_mlp(), loss="mse", device="cpu")
    x = np.random.RandomState(0).randn(32, 6).astype(np.float32)
    y = np.zeros((32, 3), np.float32)
    m = 32
    # forward 2mkn a product; backward: the weight gradient of each
    # layer, the input gradient of all but the first (x needs none)
    hand = (2 * m * 6 * 16) * 2 + (2 * m * 16 * 3) * 3
    assert profiling.step_flops(lambda: est._loss_and_grads(x, y)) == hand


def _bert_step_flops(use_flash: bool, causal_seq: int = 16) -> float:
    from analytics_zoo_tpu_torch.learn.estimator import Estimator
    from analytics_zoo_tpu_torch.text import BertConfig, init_bert_weights
    from analytics_zoo_tpu_torch.text.estimators import _ClassifierModule
    cfg = BertConfig(vocab=100, hidden_size=64, n_block=2, n_head=4,
                     intermediate_size=128, max_position_len=64,
                     use_flash=use_flash)
    est = Estimator.from_torch(
        model=init_bert_weights(_ClassifierModule(cfg, 2), 0),
        loss="sparse_categorical_crossentropy_logits", device="cpu")
    ids = np.random.RandomState(0).randint(0, 100, (4, causal_seq)).astype(
        np.int32)
    y = np.zeros(4, np.int64)
    return profiling.step_flops(lambda: est._loss_and_grads(ids, y))


@pytest.mark.parametrize("seq", [16, 40])
def test_bert_step_counts_the_same_by_flash_and_einsum(seq):
    """The flash Function's registered count (forward 4bhsqskd, backward
    twice that) is the einsum chain's, which FlopCounterMode measures
    directly; the hand count of the step agrees."""
    flash, chain = _bert_step_flops(True, seq), _bert_step_flops(False, seq)
    b, s, hid, heads, inter, blocks = 4, seq, 64, 4, 128, 2
    m = b * s
    fwd = blocks * (2 * m * (3 * hid * hid + hid * hid + 2 * hid * inter)
                    + 4 * b * heads * s * s * (hid // heads)) \
        + 2 * b * hid * hid + 2 * b * hid * 2
    assert flash == chain == 3 * fwd


def test_flash_counted_ops_hide_their_bodies():
    from torch.utils.flop_counter import FlopCounterMode

    from analytics_zoo_tpu_torch.ops import flash_attention as fa
    q, k, v = (torch.randn(2, 8, 2, 16, requires_grad=True)
               for _ in range(3))
    with fa.counting_flops() as formulas, FlopCounterMode(
            display=False, custom_mapping=formulas) as mode:
        out = fa.flash_attention(q, k, v, causal=True)
        out.sum().backward()
    assert mode.get_total_flops() == 3 * 4 * 2 * 2 * 8 * 8 * 16
    assert not fa.counting()
    want = fa.flash_attention(q.detach(), k.detach(), v.detach(),
                              causal=True)
    torch.testing.assert_close(out.detach(), want, rtol=0, atol=0)


def test_fit_publishes_flops_hbm_and_mfu(monkeypatch):
    from analytics_zoo_tpu_torch.learn.estimator import Estimator
    monkeypatch.setenv("ZOO_PEAK_FLOPS", "1e12")
    est = Estimator.from_torch(model=_mlp(), loss="mse", optimizer="adam",
                               device="cpu")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 6)).astype(np.float32)
    y = rng.normal(size=(64, 3)).astype(np.float32)
    est.fit((x, y), epochs=2, batch_size=8, summary_interval=4)
    snap = telemetry.snapshot()
    m = 8
    assert snap["zoo_step_flops"] == (2 * m * 6 * 16) * 2 + \
        (2 * m * 16 * 3) * 3
    assert 0 < snap["zoo_mfu"] < 1.0
    # sample_every = max(2, 4 // 2): 16 steps, 8 fenced
    assert snap["zoo_train_phase_seconds"]["phase=device"]["count"] == 8
    assert snap["zoo_train_phase_seconds"]["phase=data_wait"]["count"] == 16
    n_params = sum(p.numel() for p in est.model.parameters())
    # the parameters, Adam's two moments, its count
    assert snap["zoo_hbm_bytes"]["source=live_tensors"] >= 3 * 4 * n_params
    text = telemetry.prometheus_text()
    assert "zoo_mfu " in text and 'zoo_hbm_bytes{source="' in text
    xs = [e for e in profiling.chrome_trace()["traceEvents"]
          if e["ph"] == "X"]
    assert any(e["args"]["trace_id"].startswith("train/step-")
               and e["name"] == "device" for e in xs)


@pytest.mark.parametrize("mode", ["per_step", "loop", "cached"])
def test_fit_with_the_flop_count_is_bitwise_one_without(mode):
    """The counting pass (fork_rng, .grad and buffers put back, no
    update) leaves the fit where it would be: dropout's draws, every
    parameter and every step loss bit for bit."""
    from analytics_zoo_tpu_torch.learn.estimator import Estimator

    def run(count):
        est = Estimator.from_torch(model=_mlp(), loss="mse",
                                   optimizer="adam", device="cpu", seed=3)
        for p in est.model.parameters():
            p.grad = torch.full_like(p, 0.5)    # a stale .grad survives
        if not count:
            est._step_flops = lambda x, y: None
        rng = np.random.default_rng(1)
        x = rng.normal(size=(64, 6)).astype(np.float32)
        y = rng.normal(size=(64, 3)).astype(np.float32)
        kw = {"per_step": {}, "loop": {"steps_per_loop": 4},
              "cached": {"cache": "device"}}[mode]
        est.fit((x, y), epochs=2, batch_size=8, summary_interval=4,
                shuffle=False, **kw)
        return est

    a, b = run(True), run(False)
    assert any(v for v in a._flops.values())
    assert a.step_losses == b.step_losses
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(p, q) and torch.equal(p.grad, q.grad)


# ----------------------------------------------------------- flight recorder

def test_ring_is_fed_by_tracer_and_bounded():
    fr = profiling.FlightRecorder(capacity=8).attach()
    tracer = telemetry.get_tracer()
    for i in range(20):
        tracer.record(f"t{i}", "stage", 0.0, 1.0)
    snap = fr.snapshot(reason="unit")
    assert len(snap["spans"]) == 8 and snap["spans"][-1]["trace_id"] == "t19"
    assert snap["kind"] == "zoo_flight_recorder"
    assert snap["reason"] == "unit" and snap["pid"] == os.getpid()
    fr.detach()
    tracer.record("after", "stage", 0.0, 1.0)
    assert len(fr.snapshot()["spans"]) == 8


def test_dump_contents(tmp_path, monkeypatch):
    monkeypatch.setenv("ZOO_DUMMY_FOR_TEST", "42")
    fr = profiling.FlightRecorder(capacity=4,
                                  dump_dir=str(tmp_path)).attach()
    telemetry.get_registry().counter("zoo_fr_test_total").inc(3)
    telemetry.get_tracer().record("u", "device", 1.0, 2.5)
    fr.note("part: ncf_train")
    path = fr.dump(reason="unit-test")
    assert os.path.basename(path).startswith("flightrec_")
    with open(path) as fh:
        d = json.load(fh)
    assert d["reason"] == "unit-test" and d["notes"] == ["part: ncf_train"]
    assert d["env"]["ZOO_DUMMY_FOR_TEST"] == "42"
    assert d["metrics"]["zoo_fr_test_total"] == 3
    assert d["backend"]["status"] == "ok"
    (span,) = d["spans"]
    assert span["name"] == "device"
    assert span["duration_ms"] == pytest.approx(1500.0)
    assert fr.dump_once("wedge") == fr.dump_once("wedge") != ""


def test_sigterm_leaves_a_dump_and_chains_handler(tmp_path, monkeypatch):
    hits = []

    def prior_handler(s, f):
        hits.append(s)

    prev = signal.signal(signal.SIGTERM, prior_handler)
    try:
        monkeypatch.setenv("ZOO_FLIGHT_RECORDER", "1")
        monkeypatch.setenv("ZOO_FLIGHT_RECORDER_DIR", str(tmp_path))
        fr = profiling.maybe_arm_from_env()
        assert fr is not None
        telemetry.get_tracer().record("wedge", "device", 0.0, 9.9)
        os.kill(os.getpid(), signal.SIGTERM)
        dumps = [p for p in os.listdir(tmp_path)
                 if p.startswith("flightrec_")]
        assert len(dumps) == 1
        with open(tmp_path / dumps[0]) as fh:
            d = json.load(fh)
        assert d["reason"] == "signal-SIGTERM"
        assert [s["trace_id"] for s in d["spans"]] == ["wedge"]
        assert hits == [signal.SIGTERM]
        fr.disarm()
        assert signal.getsignal(signal.SIGTERM) is prior_handler
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_arm_gate_thread_and_dump_failure(tmp_path, monkeypatch):
    out = {}
    t = threading.Thread(target=lambda: out.update(
        armed=profiling.FlightRecorder().arm()))
    t.start()
    t.join(10)
    assert out["armed"] is False
    monkeypatch.delenv("ZOO_FLIGHT_RECORDER", raising=False)
    assert profiling.maybe_arm_from_env() is None
    fr = profiling.FlightRecorder(dump_dir=str(tmp_path / "f" / "\0bad"))
    assert fr.dump(reason="x") == ""


def test_engine_start_arms_the_recorder(monkeypatch):
    from analytics_zoo_tpu_torch.serving import Broker, ClusterServing
    monkeypatch.setenv("ZOO_FLIGHT_RECORDER", "1")
    monkeypatch.setenv("ZOO_FLEET_HEARTBEAT_S", "0")
    prev = signal.getsignal(signal.SIGTERM)

    class Duck:
        def predict(self, x):
            return np.asarray(x)

    try:
        with Broker.launch(backend="python") as b, \
                ClusterServing(Duck(), b.port, warmup=False):
            fr = profiling.get_flight_recorder()
            assert signal.getsignal(signal.SIGTERM) == fr._handler
    finally:
        profiling.reset_for_tests()
        signal.signal(signal.SIGTERM, prev)


# ------------------------------------------------------------- the backend

def test_probe_reports_the_cpu_and_caches():
    st = profiling.backend_state()
    assert st == {"status": "ok", "platform": "cpu", "device_kind": "cpu",
                  "device_count": 1}
    st["status"] = "mutated"
    assert profiling.backend_state()["status"] == "ok"


def test_a_wedged_probe_never_hangs(monkeypatch):
    release = threading.Event()

    def hang():
        release.wait(30)
        return False

    monkeypatch.setattr(torch.cuda, "is_available", hang)
    t0 = time.monotonic()
    st = profiling.backend_state(timeout_s=0.2)
    assert st == {"status": "wedged", "probe_timeout_s": 0.2}
    assert time.monotonic() - t0 < 5
    release.set()


def test_trace_and_healthz_backend_over_http():
    import socket
    import urllib.error
    import urllib.request

    from analytics_zoo_tpu_torch.serving.frontend import FrontEnd

    _record_serving_style_trace(telemetry.get_tracer(), "uri-1")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead_port = s.getsockname()[1]
    with FrontEnd(dead_port).start() as fe:
        with urllib.request.urlopen(f"http://127.0.0.1:{fe.port}/trace",
                                    timeout=10) as resp:
            assert resp.status == 200
            obj = json.loads(resp.read())
        assert {"dequeue", "preprocess", "device", "postprocess"} <= {
            e["name"] for e in obj["traceEvents"] if e["ph"] == "X"}
        with urllib.request.urlopen(
                f"http://127.0.0.1:{fe.port}/trace?uri=nope",
                timeout=10) as resp:
            assert [e for e in json.loads(resp.read())["traceEvents"]
                    if e["ph"] == "X"] == []
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"http://127.0.0.1:{fe.port}/healthz",
                                   timeout=10)
        body = json.loads(ei.value.read())
        assert body["backend"]["status"] == "ok"
        assert body["backend"]["platform"] == "cpu"
