"""The port's backend supervisor against the JAX package's, on the CPU.

The same scripted probe sequences as JAX's tests/test_resilience.py
(its ``TestBackendSupervisor``) drive both packages' supervisors: the
state after every probe, the episode count, the ``zoo_backend_state``
gauge, the ``zoo_backend_failovers_total`` counter and the one
flight-recorder dump an episode are equal. The port's default probe is
``profiling.backend_state`` (``torch.cuda``; on this CPU it reads ok).
A serving engine started under a fault plan runs the supervisor, a
batch lost to the backend feeds it (``note_backend_loss``), and
``/healthz`` carries its block and never a ``failover`` key; without a
fault plan no supervisor runs and the block is absent.
"""

import json
import os
import time
import urllib.request

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.common import resilience, slo, telemetry

SEQUENCES = {
    "full_cycle": (["error", "error", "ok", "ok", "ok"], 2),
    "relapse": (["error", "error", "ok", "error", "ok", "ok"], 2),
    "slow_recovery": (["error", "wedged", "ok", "ok", "error", "ok", "ok",
                       "ok"], 3),
    "suspect_heals": (["error", "ok", "ok", "error", "ok"], 2),
}


@pytest.fixture(autouse=True)
def _fresh(tmp_path, monkeypatch):
    monkeypatch.setenv("ZOO_FLIGHT_RECORDER_DIR", str(tmp_path / "port"))
    telemetry.reset_for_tests()
    slo.set_monitor(None)
    yield
    resilience.install_plan(None)
    telemetry.reset_for_tests()


@pytest.fixture(scope="module")
def jx():
    import jax
    jax.config.update("jax_platforms", "cpu")
    from analytics_zoo_tpu.common import profiling as jprofiling
    from analytics_zoo_tpu.common import resilience as jres
    from analytics_zoo_tpu.common import telemetry as jtel
    return dict(res=jres, tel=jtel, prof=jprofiling)


def _run(res, tel, statuses, recover_probes):
    seq = iter(statuses)
    reg = tel.MetricsRegistry()
    sup = res.BackendSupervisor(probe=lambda: {"status": next(seq)},
                                registry=reg, recover_probes=recover_probes)
    states = []
    for _ in statuses:
        sup.probe_once()
        states.append(sup.state)
    snap = reg.snapshot()
    return states, sup.episodes, snap.get("zoo_backend_state"), \
        snap.get("zoo_backend_failovers_total")


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_state_sequence_and_metrics_are_jax(jx, tmp_path, monkeypatch,
                                           name):
    statuses, recover = SEQUENCES[name]
    got = _run(resilience, telemetry, statuses, recover)
    monkeypatch.setenv("ZOO_FLIGHT_RECORDER_DIR", str(tmp_path / "jax"))
    jx["tel"].reset_for_tests()     # JAX's flight recorder reads the dir
    want = _run(jx["res"], jx["tel"], statuses, recover)
    assert got == want
    dumps = {d: sorted(p for p in os.listdir(tmp_path / d)
                       if p.startswith("flightrec"))
             for d in ("port", "jax")
             if os.path.isdir(tmp_path / d)}
    assert len(dumps.get("port", [])) == len(dumps.get("jax", [])) == \
        got[1]          # one postmortem an episode


def test_report_failure_force_wedged_and_the_probe_loop(jx):
    for res, tel in ((resilience, telemetry), (jx["res"], jx["tel"])):
        reg = tel.MetricsRegistry()
        sup = res.BackendSupervisor(probe=lambda: {"status": "ok"},
                                    registry=reg, interval_s=0.02,
                                    backoff_max_s=0.05)
        sup.report_failure(RuntimeError("device lost"))
        assert sup.state == "suspect"
        sup.report_failure(RuntimeError("device lost"))
        assert sup.state == "wedged" and sup.episodes == 1
        sup.ensure_started()
        try:
            deadline = time.monotonic() + 5.0
            while sup.state != "ok" and time.monotonic() < deadline:
                time.sleep(0.02)
            assert sup.state == "ok"
        finally:
            sup.stop()
        sup2 = res.BackendSupervisor(probe=lambda: {"status": "ok"},
                                     registry=tel.MetricsRegistry())
        sup2.force_wedged("init hang")
        assert sup2.state == "wedged" and sup2.episodes == 1


def test_default_probe_and_singleton():
    """The default probe is the torch.cuda one (ok on this CPU); the
    singleton appears in the snapshot only once made, ``note_backend_loss``
    reports only a backend loss, and ``reset_for_tests`` drops it."""
    assert resilience.supervisor_snapshot() is None
    resilience.note_backend_loss(RuntimeError("device lost"))   # none yet
    sup = resilience.get_supervisor()
    assert resilience.get_supervisor() is sup
    assert sup.probe_once()["status"] == "ok" and sup.state == "ok"
    resilience.note_backend_loss(ValueError("bad shape"))
    assert sup.state == "ok"
    resilience.note_backend_loss(RuntimeError("CUDA error: device lost"))
    snap = resilience.supervisor_snapshot()
    assert snap["state"] == "suspect" and snap["episodes"] == 0
    assert snap["last_probe"]["status"] == "error"
    telemetry.reset_for_tests()
    assert resilience.supervisor_snapshot() is None


class _Lost:
    """A model whose every batch dies with a lost device."""

    def predict(self, x):
        raise RuntimeError("CUDA error: device lost")


def _healthz(port):
    """/healthz's JSON, whatever its status (errors burn the SLO, which
    answers 503)."""
    import urllib.error
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=10) as r:
            return json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return json.loads(e.read().decode())


def test_engine_feeds_the_supervisor_and_healthz_shows_it():
    from analytics_zoo_tpu_torch.serving import (Broker, ClusterServing,
                                                 FrontEnd, InputQueue,
                                                 OutputQueue, schema)
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with Broker.launch(backend="python") as b:
            # no fault plan: no supervisor, no block
            with ClusterServing(_Lost(), b.port, batch_size=2,
                                max_batch_size=2, warmup=False) as eng, \
                    FrontEnd(b.port, engine=eng) as fe:
                hz = _healthz(fe.port)
                assert "backend_supervisor" not in hz
                assert "failover" not in hz
            # a fault plan (whose site this path never reaches) makes the
            # engine run the supervisor (made here with a probe that reads
            # the device lost); a lost batch makes it suspect and its
            # re-probe confirms: wedged, one dump
            resilience.install_plan("wedge@step:1000")
            resilience.get_supervisor(probe=lambda: {"status": "error"},
                                      interval_s=0.05)
            iq, oq = InputQueue(port=b.port), OutputQueue(port=b.port)
            with ClusterServing(_Lost(), b.port, batch_size=2,
                                max_batch_size=2, warmup=False) as eng, \
                    FrontEnd(b.port, engine=eng) as fe:
                assert eng._supervisor is resilience.get_supervisor()
                for i in range(2):
                    uri = iq.enqueue(f"r{i}", x=np.ones(3, np.float32))
                    with pytest.raises(schema.ServingError,
                                       match="device lost"):
                        oq.query(uri, timeout=30.0)
                deadline = time.monotonic() + 10.0
                while resilience.supervisor_snapshot()["episodes"] < 1 \
                        and time.monotonic() < deadline:
                    time.sleep(0.02)
                hz = _healthz(fe.port)
                block = hz["backend_supervisor"]
                assert block["episodes"] == 1 and block["state"] == "wedged"
                assert "failover" not in hz
                snap = telemetry.snapshot()
                assert snap["zoo_backend_failovers_total"] == 1
                assert snap["zoo_backend_state"] == 2
            # stop() stopped the probe loop with the serving
            assert eng._supervisor is None
            iq.close()
            oq.close()
    finally:
        torch.set_num_threads(prev)


def test_cpu_fallback_is_refused():
    from analytics_zoo_tpu_torch.serving import ClusterServing
    os.environ["ZOO_CPU_FALLBACK"] = "1"
    try:
        with pytest.raises(ValueError, match="only reports"):
            ClusterServing(_Lost(), 0)
    finally:
        del os.environ["ZOO_CPU_FALLBACK"]
