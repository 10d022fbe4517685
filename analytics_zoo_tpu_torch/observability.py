"""Thin observability helpers over the port's telemetry, profiling and
fleet layers: the counterpart of ``analytics_zoo_tpu/observability.py``,
trimmed to what the port has (no compile-ahead cache); the device hooks
(``instrument_jit``, ``traced_device_put`` / ``get``,
``timed_block_until_ready``) are common/telemetry.py's torch versions.

One import surface for operators and notebooks::

    from analytics_zoo_tpu_torch import observability as obs
    obs.scrape()            # Prometheus text exposition of everything
    obs.metrics()           # JSON-able snapshot
    obs.trace("my-uri")     # a served record's stage spans
    obs.trace_table("uri")  # ... pretty-printed
    obs.dump_trace("out.json")        # Chrome Trace Event JSON
    obs.get_flight_recorder().dump()  # postmortem under zoo_tpu_logs/
    obs.backend_state()               # non-blocking device probe
    obs.merge_snapshot(a, b)          # the federation algebra
    obs.fleet_registry(port=p)        # live serving replicas

The serving FrontEnd serves the same data over HTTP (``GET /metrics``,
``?scope=fleet``, ``GET /healthz``, ``GET /trace``, ``GET /slo``).
"""

from __future__ import annotations

from typing import Dict, List

from analytics_zoo_tpu_torch.common.fleet import (  # noqa: F401  (re-exports)
    Heartbeater, ReplicaInfo, ReplicaRegistry,
)
from analytics_zoo_tpu_torch.common.profiling import (  # noqa: F401
    FlightRecorder, StepProfiler, backend_state, chrome_trace,
    device_peak_flops, dump_trace, get_flight_recorder, hbm_bytes,
    maybe_arm_from_env, step_flops,
)
from analytics_zoo_tpu_torch.common.slo import (  # noqa: F401
    SLO, SLOMonitor, default_slos,
)
from analytics_zoo_tpu_torch.common.slo import \
    get_monitor as get_slo_monitor  # noqa: F401
from analytics_zoo_tpu_torch.common.telemetry import (  # noqa: F401
    MetricsRegistry, Span, Tracer, get_registry, get_tracer, instrument_jit,
    observe_device_block, prometheus_text, set_trace_sampling, snapshot,
    timed_block_until_ready, traced_device_get, traced_device_put,
)

__all__ = [
    "scrape", "metrics", "trace", "trace_table", "get_registry",
    "get_tracer", "instrument_jit", "set_trace_sampling",
    "prometheus_text", "snapshot", "traced_device_put", "traced_device_get",
    "observe_device_block", "timed_block_until_ready", "chrome_trace", "dump_trace", "StepProfiler",
    "FlightRecorder", "get_flight_recorder", "maybe_arm_from_env",
    "backend_state", "step_flops", "device_peak_flops", "hbm_bytes",
    "merge_snapshot", "fleet_registry", "ReplicaRegistry", "ReplicaInfo",
    "Heartbeater", "SLO", "SLOMonitor", "default_slos", "get_slo_monitor",
]


def merge_snapshot(base: Dict, other: Dict) -> Dict:
    """Merge two registry snapshots: counters and gauges sum, histograms
    add bucket counts and union reservoirs
    (:meth:`MetricsRegistry.merge_snapshot`)."""
    return MetricsRegistry.merge_snapshot(base, other)


def fleet_registry(host: str = "127.0.0.1", port: int = 6399
                   ) -> ReplicaRegistry:
    """A :class:`ReplicaRegistry` over the given broker: ``.list()`` /
    ``.partition()`` enumerate serving replicas by heartbeat."""
    return ReplicaRegistry(host, port)


def scrape() -> str:
    """Prometheus text exposition of the process-wide registry."""
    return prometheus_text()


def metrics() -> Dict:
    """JSON-able snapshot of the process-wide registry."""
    return snapshot()


def trace(trace_id: str) -> List[Span]:
    """All spans recorded for ``trace_id`` (a serving record's uri)."""
    return get_tracer().get(trace_id)


def trace_table(trace_id: str) -> str:
    """The trace as an aligned text table (offsets from the first span's
    start, durations in ms)."""
    spans = sorted(trace(trace_id), key=lambda s: s.start)
    if not spans:
        return f"(no trace for {trace_id!r})"
    t0 = spans[0].start
    rows = [f"{'span':<16} {'start_ms':>10} {'dur_ms':>10}  parent"]
    for s in spans:
        rows.append(f"{s.name:<16} {(s.start - t0) * 1e3:>10.3f} "
                    f"{s.duration * 1e3:>10.3f}  {s.parent or '-'}")
    return "\n".join(rows)
