"""The port's telemetry stack against the JAX package's: the registry
(counters, gauges, histograms, the Prometheus 0.0.4 text, snapshots and
their merge), the tracer, the windowed time-series store and the SLO
monitor's burn rates. Each scenario runs the same operations on both
packages' modules and must give identical text, snapshots and numbers;
the burn math and the window algebra are also held to the values the JAX
package's own tests (test_fleet.py, test_timeseries.py) hold."""

import re

import numpy as np
import pytest

from analytics_zoo_tpu.common import slo as jslo
from analytics_zoo_tpu.common import telemetry as jtel
from analytics_zoo_tpu.common import timeseries as jts
from analytics_zoo_tpu_torch.common import slo as tslo
from analytics_zoo_tpu_torch.common import telemetry as ttel
from analytics_zoo_tpu_torch.common import timeseries as tts

PACKAGES = {"jax": (jtel, jts, jslo), "port": (ttel, tts, tslo)}


@pytest.fixture(autouse=True)
def _fresh_registries():
    for tel, _, _ in PACKAGES.values():
        tel.reset_for_tests()
    yield
    for tel, _, _ in PACKAGES.values():
        tel.reset_for_tests()


def _both(fn):
    """``fn(tel, ts, slo)`` on each package; returns (jax's, port's)."""
    return fn(*PACKAGES["jax"]), fn(*PACKAGES["port"])


def _registry_ops(tel):
    reg = tel.MetricsRegistry()
    reg.counter("zoo_serving_records_total", "Records with a flushed result",
                ("stream",)).labels("serving_stream").inc(7)
    reg.counter("zoo_a_total", "A counter", ("s",)).labels(
        'x"y\n').inc(2)
    reg.gauge("zoo_g", "G").set(1.5)
    depth = reg.gauge("zoo_serving_lane_depth", "depth",
                      ("stream", "priority"))
    for i, lane in enumerate(("interactive", "default", "batch")):
        depth.labels("serving_stream", lane).set(i * 3)
    h = reg.histogram("zoo_h_seconds", "H", buckets=(0.3, 1.0))
    for v in (0.25, 0.5, 4.0):
        h.observe(v, exemplar="uri-1")
    lat = reg.histogram("zoo_serving_latency_seconds", "lat",
                        ("stream", "priority"))
    rng = np.random.RandomState(3)
    for v in rng.exponential(0.01, size=2000):
        lat.labels("serving_stream", "default").observe(float(v))
    return reg


def test_prometheus_text_and_snapshot_are_identical():
    jreg, treg = _both(lambda tel, ts, slo: _registry_ops(tel))
    assert treg.prometheus_text() == jreg.prometheus_text()
    assert treg.snapshot() == jreg.snapshot()
    # the golden text of the JAX package's own test
    assert 'zoo_a_total{s="x\\"y\\n"} 2\n' in treg.prometheus_text()
    assert re.search(r'zoo_h_seconds_bucket\{le="\+Inf"\} 3 # '
                     r'\{trace_id="uri-1"\}', treg.prometheus_text())


def test_merge_snapshot_and_from_snapshot_agree():
    def run(tel, ts, slo):
        a = _registry_ops(tel).snapshot()
        reg = tel.MetricsRegistry()
        reg.counter("zoo_serving_records_total", "r", ("stream",)).labels(
            "serving_stream").inc(5)
        reg.histogram("zoo_h_seconds", "H", buckets=(0.3, 1.0)).observe(
            0.7)
        merged = tel.MetricsRegistry.merge_snapshot(a, reg.snapshot())
        return merged, tel.MetricsRegistry.from_snapshot(
            merged).prometheus_text()

    (jm, jtext), (tm, ttext) = _both(run)
    assert tm == jm and ttext == jtext
    assert tm["zoo_serving_records_total"]["stream=serving_stream"] == 12.0
    assert tm["zoo_h_seconds"]["count"] == 4
    # mismatched bucket edges refuse to merge in both
    bad = {"zoo_h_seconds": dict(tm["zoo_h_seconds"], le=[0.5, 1.0])}
    for tel in (jtel, ttel):
        with pytest.raises(ValueError):
            tel.MetricsRegistry.merge_snapshot(tm, bad)


def test_tracer_spans_and_sampling_agree():
    def run(tel, ts, slo):
        tr = tel.Tracer(capacity=3, sample=0.5)
        picks = [tr.should_sample() for _ in range(8)]
        for i in range(5):
            tr.record(f"t{i}", "work", 0.0, 1.0 + i, parent="serve")
        with tr.span("outer", trace_id="t4"):
            pass
        return picks, list(tr.traces()), [
            (s.name, s.parent, s.end - s.start)
            for s in tr.get("t4") if s.name == "work"]

    assert _both(run)[0] == _both(run)[1]
    picks, ids, spans = _both(run)[1]
    assert 0 < sum(picks) < 8 and ids == ["t2", "t3", "t4"]
    assert spans == [("work", "serve", 5.0)]


# ---------------------------------------------------------------- SLO


def _slo_series(tel):
    reg = tel.get_registry()
    return (reg.histogram("zoo_serving_latency_seconds", "d",
                          ("stream", "priority")).labels("s", "default"),
            reg.counter("zoo_serving_records_total", "d",
                        ("stream",)).labels("s"),
            reg.counter("zoo_serving_record_errors_total", "d",
                        ("stream",)).labels("s"))


def test_latency_and_availability_burn_math():
    def run(tel, ts, slo):
        tel.reset_for_tests()
        h, good, bad = _slo_series(tel)
        mon = slo.SLOMonitor(windows=(10.0,), shed_burn=2.0, tick_s=1.0)
        mon.tick(now=0.0)
        for _ in range(90):
            h.observe(0.01)
        for _ in range(10):
            h.observe(5.0)
        good.inc(999)
        bad.inc(1)
        mon.tick(now=5.0)
        snap = tel.snapshot()
        return (mon.burn_rates(), mon.overloaded(),
                snap["zoo_slo_burn_rate"], snap["zoo_slo_shedding"],
                mon.report()["shedding"])

    jx, pt = _both(run)
    assert pt == jx
    rates, overloaded, gauges, shedding, _ = pt
    # 10 of 100 slow against 0.99: burn 10; 1 of 1000 bad at 0.999: 1
    assert rates["serving_p99_latency"]["10s"] == pytest.approx(10.0)
    assert rates["serving_availability"]["10s"] == pytest.approx(1.0)
    assert overloaded and shedding == 1.0
    assert gauges["slo=serving_p99_latency,window=10s"] == \
        pytest.approx(10.0)


def test_multi_window_guard_and_per_lane_burn():
    def run(tel, ts, slo):
        tel.reset_for_tests()
        reg = tel.get_registry()
        lat = reg.histogram("zoo_serving_latency_seconds", "d",
                            ("stream", "priority"))
        mon = slo.SLOMonitor(windows=(5.0, 60.0), shed_burn=2.0,
                             tick_s=1.0)
        mon.tick(now=0.0)
        for _ in range(2000):
            lat.labels("s", "default").observe(0.01)
        mon.tick(now=50.0)
        for _ in range(20):
            lat.labels("s", "default").observe(5.0)
        for _ in range(5):
            lat.labels("s", "batch").observe(9.0)
        mon.tick(now=55.0)
        return (mon.burn_rates(), mon.overloaded(),
                {lane: mon.burning(f"serving_p99_latency_{lane}")
                 for lane in ("interactive", "default", "batch")})

    jx, pt = _both(run)
    assert pt == jx
    rates, overloaded, lanes = pt
    br = rates["serving_p99_latency"]
    # the short window sees only the burst, the long one dilutes it: no
    # shedding on a blip
    assert br["5s"] > 2.0 > br["60s"]
    assert not overloaded
    assert lanes["batch"] and not lanes["interactive"]


def test_no_traffic_means_no_burn():
    for tel, ts, slo in PACKAGES.values():
        _slo_series(tel)
        mon = slo.SLOMonitor(windows=(10.0,))
        mon.tick(now=0.0)
        mon.tick(now=5.0)
        assert all(v == 0.0 for per in mon.burn_rates().values()
                   for v in per.values())
        assert not mon.overloaded()


# --------------------------------------------------------- time series


def test_counter_rate_delta_and_gauge_aggregates():
    def run(tel, ts, slo):
        store = ts.TimeSeriesStore(tick_s=5.0, max_points=64)
        c = tel.get_registry().counter("zoo_ts_unit_total", "d")
        g = tel.get_registry().gauge("zoo_ts_unit_depth", "d")
        out = []
        for t, inc, v in ((0.0, 10, 2.0), (10.0, 30, 8.0), (20.0, 5, 4.0)):
            c.inc(inc)
            g.set(v)
            store.tick(now=t)
            out.append(store.query("zoo_ts_unit_total", window=10.0,
                                   now=t))
            out.append(store.query("zoo_ts_unit_total", window=10.0,
                                   agg="delta", now=t))
        for agg in ("last", "max", "min", "avg"):
            out.append(store.query("zoo_ts_unit_depth", window=20.0,
                                   agg=agg, now=20.0))
        with pytest.raises(ValueError):
            store.query("zoo_ts_unit_depth", window=10.0, agg="p99",
                        now=10.0)
        out.append(store.windows_delta((10.0, 60.0), now=20.0))
        out.append(store.history(window=15.0, now=20.0))
        return out

    jx, pt = _both(run)
    assert pt == jx
    assert pt[2]["points"][0]["value"] == pytest.approx(3.0)   # 30 / 10 s
    assert pt[3]["points"][0]["value"] == pytest.approx(30.0)
    assert pt[4]["points"][0]["value"] == pytest.approx(0.5)
    assert [q["points"][0]["value"] for q in pt[6:10]] == \
        [4.0, 8.0, 2.0, pytest.approx(14.0 / 3)]


def test_windowed_p99_and_exemplars_agree():
    def run(tel, ts, slo):
        store = ts.TimeSeriesStore(tick_s=5.0, max_points=64)
        h = tel.get_registry().histogram(
            "zoo_ts_unit_seconds", "d", ("priority",),
            buckets=(0.01, 0.05, 0.1, 0.5, 1.0, 5.0))
        rng = np.random.RandomState(7)
        for v in rng.uniform(0.001, 0.02, size=200):
            h.labels("batch").observe(float(v))
        store.tick(now=0.0)
        for i, v in enumerate(rng.uniform(0.2, 3.0, size=300)):
            h.labels("batch").observe(float(v), exemplar=f"u{i}")
        store.tick(now=60.0)
        return (store.query("zoo_ts_unit_seconds", labels={
                    "priority": "batch"}, window=60.0, agg="p99",
                    now=60.0),
                store.window_hist_delta("zoo_ts_unit_seconds",
                                        window=60.0, now=60.0),
                tel.get_registry().prometheus_text())

    jx, pt = _both(run)
    assert pt == jx
    (pt_p99,) = pt[0]["points"]
    # the window forgets the fast era: its p99 sits in the slow buckets
    assert 1.0 <= pt_p99["value"] <= 5.0
    assert pt_p99["exemplar"]["trace_id"].startswith("u")
    assert re.search(r'# \{trace_id="u\d+"\}', pt[2]) is not None
