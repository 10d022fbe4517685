"""Burn-rate SLO monitor — declarative latency/availability objectives
evaluated from the telemetry registry.

The port's own copy of ``analytics_zoo_tpu/common/slo.py``, whole; it
reads the port's registry through the history store
(``common/timeseries.py``):

- an :class:`SLO` declares a target: "99% of records complete within
  ``threshold_s``" (latency, read from a histogram's bucket counts) or
  "99.9% of records succeed" (availability, read from a counter pair);
- :class:`SLOMonitor` computes, on every ``tick()``, the **burn rate**
  per rolling window from the store's windowed deltas: ``bad_fraction /
  (1 - objective)`` — burn 1.0 spends the error budget exactly at the
  sustainable rate, burn N spends it N times too fast;
- burns are published as ``zoo_slo_burn_rate{slo,window}`` (and the
  shed decision as ``zoo_slo_shedding``), served by ``GET /slo``, and
  drive the frontend's ``/healthz`` 503: all windows burning past
  ``ZOO_SLO_SHED_BURN`` sheds load. The per-lane objectives
  (``serving_p99_latency_<lane>``) drive the serving engine's admission
  tick instead.

Knobs: ``ZOO_SLO_P99_MS`` (default latency threshold, ms),
``ZOO_SLO_AVAILABILITY`` (default availability objective),
``ZOO_SLO_WINDOWS`` (comma-separated rolling windows, seconds),
``ZOO_SLO_SHED_BURN`` (burn past which all-window agreement sheds),
``ZOO_SLO_TICK_S`` (sampling period for the ticker/``tick_if_stale``).

Stdlib only; monotonic clocks throughout.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from time import monotonic
from typing import Any, Dict, List, Optional, Sequence, Tuple

from analytics_zoo_tpu_torch.common import telemetry, timeseries

__all__ = [
    "SLO", "SLOMonitor", "default_slos", "get_monitor", "set_monitor",
    "reset_for_tests",
]


def _windows_from_env() -> Tuple[float, ...]:
    raw = os.environ.get("ZOO_SLO_WINDOWS", "60,300")
    out = []
    for part in raw.split(","):
        part = part.strip()
        if part:
            out.append(max(1.0, float(part)))
    return tuple(out) or (60.0, 300.0)


@dataclass(frozen=True)
class SLO:
    """One declarative objective over registry series.

    ``kind="latency"``: ``objective`` of observations in histogram
    ``metric`` must land at or under ``threshold_s`` (good = count in
    buckets whose upper edge ≥ threshold covers it). ``kind=
    "availability"``: ``objective`` of events must be good, where good
    rides counter ``metric`` and bad rides counter ``bad_metric``.
    Label children of a family are summed — the SLO is per process (or
    per fleet, when evaluated over a merged snapshot)."""

    name: str
    kind: str                                  # "latency" | "availability"
    objective: float                           # good fraction target (0..1)
    metric: str
    threshold_s: Optional[float] = None        # latency only
    bad_metric: Optional[str] = None           # availability only
    # restrict sampling to children whose labels match every (key, value)
    # pair — e.g. (("priority", "interactive"),) watches one lane of
    # zoo_serving_latency_seconds{stream,priority}. None sums all children
    # (the pre-lane behavior).
    labels: Optional[Tuple[Tuple[str, str], ...]] = None
    # shed=False: the SLO's burn is published and drives lane admission
    # control, but does NOT trip overloaded()/the /healthz 503 — a burning
    # batch lane must throttle batch enqueues, not fail the whole replica
    shed: bool = True

    def __post_init__(self):
        if self.kind not in ("latency", "availability"):
            raise ValueError(f"unknown SLO kind {self.kind!r}")
        if not 0.0 < self.objective < 1.0:
            raise ValueError("objective must be in (0, 1)")
        if self.kind == "latency" and not self.threshold_s:
            raise ValueError("latency SLO needs threshold_s")
        if self.kind == "availability" and not self.bad_metric:
            raise ValueError("availability SLO needs bad_metric")


def default_slos() -> List[SLO]:
    """The serving defaults: p99 end-to-end latency under
    ``ZOO_SLO_P99_MS`` (default 1000 ms), record availability at
    ``ZOO_SLO_AVAILABILITY`` (default 0.999), and one per-priority p99
    latency SLO per lane. The per-lane SLOs are ``shed=False``: their
    burn drives the engine's batch-lane admission control, not the
    replica-wide 503. Per-lane thresholds: ``ZOO_SLO_P99_INTERACTIVE_MS``
    and ``ZOO_SLO_P99_DEFAULT_MS`` default to the overall p99 budget;
    ``ZOO_SLO_P99_BATCH_MS`` defaults to 5x it (batch work tolerates
    queueing by design)."""
    p99_ms = float(os.environ.get("ZOO_SLO_P99_MS", "1000"))
    avail = float(os.environ.get("ZOO_SLO_AVAILABILITY", "0.999"))
    out = [
        SLO(name="serving_p99_latency", kind="latency", objective=0.99,
            metric="zoo_serving_latency_seconds",
            threshold_s=p99_ms / 1000.0),
        SLO(name="serving_availability", kind="availability",
            objective=avail, metric="zoo_serving_records_total",
            bad_metric="zoo_serving_record_errors_total"),
    ]
    lane_env = {
        "interactive": ("ZOO_SLO_P99_INTERACTIVE_MS", p99_ms),
        "default": ("ZOO_SLO_P99_DEFAULT_MS", p99_ms),
        "batch": ("ZOO_SLO_P99_BATCH_MS", 5.0 * p99_ms),
    }
    for lane, (env_name, fallback) in lane_env.items():
        th_ms = float(os.environ.get(env_name, str(fallback)))
        out.append(SLO(
            name=f"serving_p99_latency_{lane}", kind="latency",
            objective=0.99, metric="zoo_serving_latency_seconds",
            threshold_s=th_ms / 1000.0,
            labels=(("priority", lane),), shed=False))
    return out


def _window_good_bad(slo: SLO, store: "timeseries.TimeSeriesStore",
                     window: float, now: float
                     ) -> Tuple[float, float, float]:
    """(good, bad, covered_s) event deltas for one SLO over one rolling
    window, read from the history store. Per-series deltas clamp at 0
    inside the store, so a registry reset (tests) reads as an empty
    window, never a negative one."""
    if slo.kind == "latency":
        le, counts, total, covered = store.window_hist_delta(
            slo.metric, labels=slo.labels, window=window, now=now)
        if not le or total == 0:
            return 0.0, 0.0, covered
        # good = observations in buckets fully at/under the threshold
        # (first edge ≥ threshold still counts: v ≤ edge ⇒ within SLO
        # only when edge ≤ threshold, so use edges ≤ threshold + ulp)
        good = 0
        for edge, c in zip(le, counts):
            if edge <= slo.threshold_s * (1 + 1e-9):
                good += int(c)
        good = min(good, total)
        return float(good), float(total - good), covered
    d_good, cov_g = store.window_scalar_delta(slo.metric, window, now)
    d_bad, cov_b = store.window_scalar_delta(slo.bad_metric, window, now)
    return d_good, d_bad, max(cov_g, cov_b)


@dataclass
class _WindowBurn:
    window_s: float
    events: float = 0.0
    bad: float = 0.0
    bad_fraction: float = 0.0
    burn: float = 0.0
    covered_s: float = 0.0     # how much of the window samples span


class SLOMonitor:
    """Rolling-window burn rates over the process registry.

    ``tick()`` is the one state transition: sample the registry into the
    history store (``timeseries.get_store()`` — re-resolved every tick,
    tests swap it), recompute every (slo, window) burn from the store's
    windowed deltas, publish the gauges. Call it from the daemon ticker
    (``start()``), from a request handler via ``tick_if_stale()`` (the
    frontend's mode — no thread, sampling rides the health-check
    cadence), or directly in tests."""

    def __init__(self, slos: Optional[Sequence[SLO]] = None,
                 windows: Optional[Sequence[float]] = None,
                 shed_burn: Optional[float] = None,
                 tick_s: Optional[float] = None):
        self.slos: Tuple[SLO, ...] = tuple(
            default_slos() if slos is None else slos)
        self.windows: Tuple[float, ...] = tuple(
            _windows_from_env() if windows is None else
            tuple(max(1.0, float(w)) for w in windows))
        self.shed_burn = float(
            os.environ.get("ZOO_SLO_SHED_BURN", "2.0")
            if shed_burn is None else shed_burn)
        self.tick_s = float(
            os.environ.get("ZOO_SLO_TICK_S", "1.0")
            if tick_s is None else tick_s)
        self._lock = threading.Lock()
        # only these SLOs may trip overloaded(): per-lane SLOs declare
        # shed=False so a burning batch lane throttles its own admissions
        # without 503-ing the replica
        self._shed_names = frozenset(
            s.name for s in self.slos if getattr(s, "shed", True))
        self._burns: Dict[str, Dict[str, _WindowBurn]] = {}
        # set at the first tick: burn windows clamp their left edge here,
        # so a fresh monitor never bills traffic that predates it (the
        # store's rings outlive any one monitor; the retired private
        # sample deque baselined at creation and this preserves that)
        self._born: Optional[float] = None
        self._last_tick = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ----------------------------------------------------------- sampling
    def tick(self, now: Optional[float] = None) -> None:
        now = monotonic() if now is None else float(now)
        with self._lock:
            if self._born is None:
                self._born = now
            born = self._born
        # re-resolve per tick: reset_for_tests swaps the global store,
        # and a monitor caching the old one would read cleared rings
        store = timeseries.get_store()
        store.tick(now=now)
        reg = telemetry.get_registry()
        burn_gauge = reg.gauge(
            "zoo_slo_burn_rate",
            "Error-budget burn rate per SLO and rolling window "
            "(1.0 = spending the budget exactly at the sustainable rate)",
            ("slo", "window"))
        shed_gauge = reg.gauge(
            "zoo_slo_shedding",
            "1 while burn-rate load shedding is active (all windows past "
            "ZOO_SLO_SHED_BURN for some SLO)")
        burns: Dict[str, Dict[str, _WindowBurn]] = {}
        for slo in self.slos:
            per_win: Dict[str, _WindowBurn] = {}
            for w in self.windows:
                # clamp the window at the monitor's birth: the shared
                # store retains history across monitor lifetimes, but
                # this monitor's error budget starts spending at its own
                # first tick
                eff = min(w, max(0.0, now - born))
                good, bad, covered = _window_good_bad(slo, store, eff, now)
                events = good + bad
                frac = bad / events if events else 0.0
                burn = frac / max(1e-9, 1.0 - slo.objective)
                per_win[f"{int(w)}s"] = _WindowBurn(
                    window_s=w, events=events, bad=bad,
                    bad_fraction=frac, burn=burn, covered_s=covered)
            burns[slo.name] = per_win
        with self._lock:
            self._last_tick = now
            self._burns = burns
            shedding = self._overloaded_locked()
        for name, per_win in burns.items():
            for wname, wb in per_win.items():
                burn_gauge.labels(name, wname).set(round(wb.burn, 6))
        shed_gauge.set(1.0 if shedding else 0.0)

    def tick_if_stale(self) -> None:
        """Tick when the last sample is older than ``tick_s`` — lets the
        health-check cadence drive sampling without a dedicated thread."""
        with self._lock:
            stale = (monotonic() - self._last_tick) >= self.tick_s
        if stale:
            self.tick()

    # ----------------------------------------------------------- reading
    def burn_rates(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {name: {w: wb.burn for w, wb in per.items()}
                    for name, per in self._burns.items()}

    def _overloaded_locked(self) -> bool:
        for name, per_win in self._burns.items():
            if name not in self._shed_names:
                continue
            if per_win and all(wb.burn > self.shed_burn
                               for wb in per_win.values()):
                return True
        return False

    def overloaded(self) -> bool:
        """Shed? True when, for some shed-eligible SLO, EVERY window
        burns past ``shed_burn`` — the multi-window guard against
        flapping."""
        with self._lock:
            return self._overloaded_locked()

    def burning(self, name: str) -> bool:
        """Is the NAMED SLO past ``shed_burn`` on every window? The
        per-lane admission-control trigger (works for shed=False SLOs —
        that is their whole point); unknown names read False."""
        with self._lock:
            per_win = self._burns.get(name)
            return bool(per_win) and all(wb.burn > self.shed_burn
                                         for wb in per_win.values())

    def report(self) -> Dict[str, Any]:
        """The ``GET /slo`` payload."""
        with self._lock:
            slos = []
            for slo in self.slos:
                per = self._burns.get(slo.name, {})
                slos.append({
                    "name": slo.name, "kind": slo.kind,
                    "objective": slo.objective,
                    "threshold_s": slo.threshold_s,
                    "metric": slo.metric,
                    "labels": dict(slo.labels) if slo.labels else None,
                    "shed": slo.shed,
                    "windows": {
                        w: {"burn": round(wb.burn, 6),
                            "bad_fraction": round(wb.bad_fraction, 6),
                            "events": wb.events,
                            "covered_s": round(wb.covered_s, 3)}
                        for w, wb in per.items()},
                })
            shedding = self._overloaded_locked()
        return {"slos": slos, "shedding": shedding,
                "shed_burn": self.shed_burn,
                "windows_s": list(self.windows),
                "history_points": timeseries.get_store().points_held()}

    # ----------------------------------------------------------- lifecycle
    def start(self) -> "SLOMonitor":
        if self._thread is not None:
            return self
        self._stop.clear()

        def run():
            while not self._stop.is_set():
                try:
                    self.tick()
                except Exception:
                    pass        # the monitor must never take a host down
                self._stop.wait(self.tick_s)

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="zoo-slo-monitor")
        self._thread.start()
        return self

    def stop(self):
        t, self._thread = self._thread, None
        self._stop.set()
        if t is not None:
            t.join(timeout=5)


# ------------------------------------------------------------ process-wide

_MONITOR: Optional[SLOMonitor] = None
_MONITOR_LOCK = threading.Lock()


def get_monitor() -> SLOMonitor:
    """Lazy default monitor (env-configured SLOs, no ticker thread —
    sampling rides health-check reads via ``tick_if_stale`` unless the
    caller ``start()``s it)."""
    global _MONITOR
    with _MONITOR_LOCK:
        if _MONITOR is None:
            _MONITOR = SLOMonitor()
        return _MONITOR


def set_monitor(monitor: Optional[SLOMonitor]) -> None:
    global _MONITOR
    with _MONITOR_LOCK:
        old, _MONITOR = _MONITOR, monitor
    if old is not None and old is not monitor:
        old.stop()


def reset_for_tests():
    set_monitor(None)
