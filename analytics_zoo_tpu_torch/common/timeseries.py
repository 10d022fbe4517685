"""Windowed metric history — a bounded in-process time-series store over
the live telemetry registry.

The port's own copy of ``analytics_zoo_tpu/common/timeseries.py``, whole;
it samples the port's registry (``common/telemetry.py``):

- :class:`TimeSeriesStore` samples every family of the live
  ``MetricsRegistry`` on a tick (``ZOO_TS_TICK_S``, default 5 s; a
  daemon ticker via ``start()`` or request-driven via
  ``tick_if_stale()``) into a fixed-capacity ring per series
  (``ZOO_TS_MAX_POINTS`` points, default 1024).
- Counters are stored as monotone totals, so ``rate(window)`` /
  ``delta(window)`` are two-point subtractions; gauges as last-value
  with ``avg``/``min``/``max`` over the window; histograms as
  cumulative ``(count, sum, bucket_counts)`` tuples so ``p99(window)``
  is answerable from bucket-count deltas over any window.
- :meth:`TimeSeriesStore.query` is the one query seam (``GET /query``);
  :meth:`TimeSeriesStore.history` serializes the raw rings (``GET
  /metrics/history``) with age-relative timestamps;
  :meth:`TimeSeriesStore.windows_delta` renders each window as a
  snapshot-shaped delta dict that merges through
  ``MetricsRegistry.merge_snapshot``.
- Histogram query points carry **exemplars** — the most recent sampled
  trace id per bucket.
- :meth:`window_hist_delta` / :meth:`window_scalar_delta` are the SLO
  monitor's substrate (``common/slo.py``).

All deltas clamp at zero per series, so a registry swap (tests) reads as
an empty window, never a negative one. A window that starts before
retention falls back to the oldest held point (``covered_s`` says how
much of the window is covered).

Thread ownership: ``_series``/``_last_tick`` are guarded by
``self._lock``; registry reads and self-metric publication happen
outside it. The ticker thread (``zoo-ts-sampler``) only calls
``tick()``; ``stop()`` joins it. Stdlib only; monotonic clocks.
"""

from __future__ import annotations

import os
import threading
from collections import deque
from time import monotonic
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from analytics_zoo_tpu_torch.common import telemetry

__all__ = [
    "TimeSeriesStore", "get_store", "set_store", "reset_for_tests",
    "DEFAULT_WINDOWS_S",
]

#: the windows ``/metrics/history?format=windows`` renders by default —
#: the 1m/5m/1h ladder the issue names and the autoscaler will read
DEFAULT_WINDOWS_S = (60.0, 300.0, 3600.0)


def _tick_s_from_env() -> float:
    return float(os.environ.get("ZOO_TS_TICK_S", "5"))


def _max_points_from_env() -> int:
    return max(2, int(os.environ.get("ZOO_TS_MAX_POINTS", "1024")))


class _Series:
    """One (name, label-values) ring. Scalar points are ``(t, value)``;
    histogram points are ``(t, count, sum, bucket_counts)`` with
    cumulative per-bucket (not running-total) counts, +Inf last."""

    __slots__ = ("kind", "le", "labelnames", "labelvalues", "points")

    def __init__(self, kind: str, le: Optional[Tuple[float, ...]],
                 labelnames: Tuple[str, ...], labelvalues: Tuple[str, ...],
                 max_points: int):
        self.kind = kind
        self.le = le
        self.labelnames = labelnames
        self.labelvalues = labelvalues
        self.points: deque = deque(maxlen=max_points)


def _at_or_before(points: Sequence[Tuple], t: float) -> Tuple:
    """The newest point at or before ``t`` — the window's base; falls
    back to the oldest held point (partial window) so a young process
    still reports. Mirrors the SLO monitor's historical ``_sample_at``."""
    best = points[0]
    for p in points:
        if p[0] <= t:
            best = p
        else:
            break
    return best


def _window_base(kind: str, pts: Sequence[Tuple], t: float,
                 first_tick: Optional[float], max_points: int) -> Tuple:
    """The window's base point for a cumulative (counter/histogram)
    series. Normally the newest point at or before ``t``; a series born
    AFTER the store started ticking reads an implicit zero base (the
    registry series simply did not exist yet — its cumulative total was
    zero), matching how the SLO monitor historically sampled missing
    metrics. A full ring may have evicted its left edge, so it falls
    back to the oldest held point instead (partial window)."""
    first = pts[0]
    if first[0] <= t or kind == "gauge":
        return _at_or_before(pts, t)
    if (len(pts) < max_points and first_tick is not None
            and first_tick < first[0]):
        bt = max(t, first_tick)
        if kind == "histogram":
            return (bt, 0, 0.0, (0,) * len(first[3]))
        return (bt, 0.0)
    return first


def _labels_match(key: str, want: Dict[str, str]) -> bool:
    if not want:
        return True
    names, values = telemetry._parse_label_key(key)
    kv = dict(zip(names, values))
    return all(kv.get(k) == str(v) for k, v in want.items())


class TimeSeriesStore:
    """Bounded rings of registry samples + the windowed query layer."""

    def __init__(self, tick_s: Optional[float] = None,
                 max_points: Optional[int] = None):
        self.tick_s = _tick_s_from_env() if tick_s is None else float(tick_s)
        self.max_points = (_max_points_from_env() if max_points is None
                           else max(2, int(max_points)))
        self._lock = threading.Lock()
        self._series: Dict[Tuple[str, str], _Series] = {}
        self._last_tick = 0.0
        self._first_tick: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ----------------------------------------------------------- sampling
    def tick(self, now: Optional[float] = None) -> None:
        """Sample every registry series into its ring. ``now`` is
        injectable (tests / the SLO monitor drive synthetic clocks);
        defaults to ``monotonic()``."""
        now = monotonic() if now is None else float(now)
        reg = telemetry.get_registry()
        rows: List[Tuple[str, str, str, Optional[Tuple[float, ...]],
                         Tuple[str, ...], Tuple[str, ...], Tuple]] = []
        for fam in reg.families():
            for child in fam.children():
                key = ",".join(
                    f"{k}={v}" for k, v in
                    zip(fam.labelnames, child.labelvalues)) or ""
                if fam.kind in ("counter", "gauge"):
                    rows.append((fam.name, key, fam.kind, None,
                                 fam.labelnames, child.labelvalues,
                                 (now, float(child.value))))
                else:
                    counts, total, s, _ = child._state()
                    rows.append((fam.name, key, fam.kind,
                                 tuple(child.buckets),
                                 fam.labelnames, child.labelvalues,
                                 (now, int(total), float(s),
                                  tuple(int(c) for c in counts))))
        with self._lock:
            for name, key, kind, le, lnames, lvalues, point in rows:
                ser = self._series.get((name, key))
                if ser is None or ser.kind != kind:
                    ser = _Series(kind, le, lnames, lvalues,
                                  self.max_points)
                    self._series[(name, key)] = ser
                ser.points.append(point)
            self._last_tick = now
            if self._first_tick is None:
                self._first_tick = now
            n_series = len(self._series)
            n_points = sum(len(s.points) for s in self._series.values())
        # self-metrics resolved fresh — the registry may have been
        # swapped under us by reset_for_tests
        reg = telemetry.get_registry()
        reg.counter("zoo_ts_ticks_total",
                    "History-store sampling ticks taken").inc()
        reg.gauge("zoo_ts_points_held",
                  "Points currently held across all history rings"
                  ).set(n_points)
        reg.gauge("zoo_ts_series",
                  "Distinct series held by the history store").set(n_series)

    def tick_if_stale(self) -> None:
        """Tick when the newest sample is older than ``tick_s`` — lets a
        scrape cadence drive sampling without the ticker thread."""
        with self._lock:
            stale = (monotonic() - self._last_tick) >= self.tick_s
        if stale:
            self.tick()

    # ------------------------------------------------------------ querying
    def query(self, name: str, labels: Optional[Dict[str, str]] = None,
              window: float = 60.0, agg: Optional[str] = None,
              now: Optional[float] = None) -> Dict[str, Any]:
        """Windowed aggregate per matching series.

        Aggregations by kind — counter: ``rate`` (default, events/s),
        ``delta``, ``last``; gauge: ``last`` (default), ``avg``,
        ``min``, ``max`` over in-window points; histogram: ``pNN``
        (``p99`` default — quantile from bucket-count deltas, within
        one bucket bound of the true windowed quantile), ``rate``,
        ``mean``, ``count``, ``sum``. Unknown combinations raise
        ``ValueError`` (the HTTP layer's 400).

        Histogram points carry an ``exemplar`` (trace id + observed
        value) when one landed inside the window — resolvable via
        ``GET /trace?uri=``."""
        want = {k: str(v) for k, v in (labels or {}).items()}
        window = max(0.0, float(window))
        now_real = monotonic()
        now = now_real if now is None else float(now)
        with self._lock:
            matched = [(key, ser, list(ser.points))
                       for (n, key), ser in self._series.items()
                       if n == name and _labels_match(key, want)]
            first_tick = self._first_tick
        agg_out = agg
        points_out: List[Dict[str, Any]] = []
        for key, ser, pts in sorted(matched, key=lambda m: m[0]):
            if not pts:
                continue
            agg_out = agg or {"counter": "rate", "gauge": "last",
                              "histogram": "p99"}[ser.kind]
            last = pts[-1]
            base = _window_base(ser.kind, pts, now - window, first_tick,
                                self.max_points)
            covered = max(0.0, last[0] - base[0])
            value = self._aggregate(ser, pts, last, base, covered,
                                    agg_out, window, now)
            names, values = telemetry._parse_label_key(key)
            entry: Dict[str, Any] = {
                "labels": dict(zip(names, values)),
                "value": value,
                "covered_s": round(covered, 3),
            }
            if ser.kind == "histogram":
                ex = self._exemplar_for(name, ser.labelvalues, window,
                                        now_real)
                if ex is not None:
                    entry["exemplar"] = ex
            points_out.append(entry)
        return {"name": name, "window": window,
                "agg": agg_out or agg or "last", "points": points_out}

    @staticmethod
    def _aggregate(ser: _Series, pts: List[Tuple], last: Tuple,
                   base: Tuple, covered: float, agg: str, window: float,
                   now: float):
        if ser.kind == "counter":
            delta = max(0.0, last[1] - base[1])
            if agg == "rate":
                return delta / covered if covered > 0 else 0.0
            if agg == "delta":
                return delta
            if agg == "last":
                return last[1]
        elif ser.kind == "gauge":
            if agg == "last":
                return last[1]
            in_w = [p[1] for p in pts if p[0] >= now - window] or [last[1]]
            if agg == "avg":
                return sum(in_w) / len(in_w)
            if agg == "min":
                return min(in_w)
            if agg == "max":
                return max(in_w)
        else:
            d_count = max(0, last[1] - base[1])
            d_sum = max(0.0, last[2] - base[2])
            d_counts = [max(0, a - b) for a, b in zip(last[3], base[3])]
            if agg.startswith("p") and agg[1:].replace(".", "", 1).isdigit():
                if not d_count:
                    return None
                return telemetry._bucket_quantile(
                    ser.le, d_counts, float(agg[1:]) / 100.0)
            if agg == "rate":
                return d_count / covered if covered > 0 else 0.0
            if agg == "mean":
                return d_sum / d_count if d_count else None
            if agg == "count":
                return d_count
            if agg == "sum":
                return d_sum
        raise ValueError(f"agg {agg!r} not valid for {ser.kind} series")

    @staticmethod
    def _exemplar_for(name: str, labelvalues: Tuple[str, ...],
                      window: float, now_real: float
                      ) -> Optional[Dict[str, Any]]:
        """Freshest in-window exemplar on the LIVE registry child (the
        store never copies exemplars into rings — one slot per bucket on
        the histogram bounds them)."""
        for fam in telemetry.get_registry().families():
            if fam.name != name or fam.kind != "histogram":
                continue
            exs = fam.labels(*labelvalues)._exemplar_state()
            best = None
            for trace_id, value, ts in exs.values():
                if now_real - ts <= window and (
                        best is None or ts > best[2]):
                    best = (trace_id, value, ts)
            if best is not None:
                return {"trace_id": best[0], "value": best[1],
                        "age_s": round(max(0.0, now_real - best[2]), 3)}
            return None
        return None

    def history(self, names: Optional[Iterable[str]] = None,
                window: Optional[float] = None,
                now: Optional[float] = None) -> Dict[str, Any]:
        """The raw rings, age-relative (``age_s = now - t``) so the
        payload is meaningful across processes. Scalar points are
        ``{age_s, value}``; histogram points ``{age_s, count, sum}``
        (full bucket vectors ride ``windows_delta``/``query``, not the
        ring dump)."""
        now = monotonic() if now is None else float(now)
        keep = set(names) if names else None
        with self._lock:
            items = [((n, key), ser, list(ser.points))
                     for (n, key), ser in self._series.items()
                     if keep is None or n in keep]
        series = []
        for (n, key), ser, pts in sorted(items, key=lambda m: m[0]):
            sel = [p for p in pts
                   if window is None or now - p[0] <= window]
            if not sel:
                continue
            lnames, lvalues = telemetry._parse_label_key(key)
            out_pts = []
            for p in sel:
                age = round(max(0.0, now - p[0]), 3)
                if ser.kind == "histogram":
                    out_pts.append({"age_s": age, "count": p[1],
                                    "sum": p[2]})
                else:
                    out_pts.append({"age_s": age, "value": p[1]})
            series.append({"name": n, "kind": ser.kind,
                           "labels": dict(zip(lnames, lvalues)),
                           "points": out_pts})
        return {"tick_s": self.tick_s, "max_points": self.max_points,
                "series": series}

    def windows_delta(self, windows: Sequence[float],
                      now: Optional[float] = None
                      ) -> Dict[str, Dict[str, Any]]:
        """Each window rendered as a *snapshot-shaped* dict — counters
        as the window delta, gauges as last value, histograms as
        ``{count, sum, mean, p50, p99, le, bucket_counts, reservoir}``
        built from bucket deltas (empty reservoir: windows have no raw
        samples). Two replicas' outputs for the same window merge with
        ``MetricsRegistry.merge_snapshot`` — deltas add, which is
        exactly the fleet-rate algebra (merged delta / window == sum of
        per-replica rates)."""
        now = monotonic() if now is None else float(now)
        with self._lock:
            items = [((n, key), ser.kind, ser.le, list(ser.points))
                     for (n, key), ser in self._series.items()]
            first_tick = self._first_tick
        out: Dict[str, Dict[str, Any]] = {}
        for w in windows:
            w = max(1.0, float(w))
            fams: Dict[str, Dict[str, Any]] = {}
            for (n, key), kind, le, pts in items:
                if not pts:
                    continue
                last = pts[-1]
                base = _window_base(kind, pts, now - w, first_tick,
                                    self.max_points)
                if kind == "counter":
                    val: Any = max(0.0, last[1] - base[1])
                elif kind == "gauge":
                    val = last[1]
                else:
                    d_count = max(0, last[1] - base[1])
                    d_sum = max(0.0, last[2] - base[2])
                    d_counts = [max(0, a - b)
                                for a, b in zip(last[3], base[3])]
                    val = {"count": d_count, "sum": d_sum,
                           "mean": d_sum / d_count if d_count else 0.0,
                           "p50": telemetry._bucket_quantile(
                               le, d_counts, 0.5),
                           "p99": telemetry._bucket_quantile(
                               le, d_counts, 0.99),
                           "le": list(le), "bucket_counts": d_counts,
                           "reservoir": []}
                fams.setdefault(n, {})[key] = val
            snap: Dict[str, Any] = {}
            for n, entries in fams.items():
                snap[n] = entries[""] if list(entries) == [""] else entries
            out[f"{int(w)}s"] = snap
        return out

    # ------------------------------------------------- SLO burn substrate
    def window_hist_delta(self, name: str,
                          labels: Optional[Tuple[Tuple[str, str], ...]]
                          = None, window: float = 60.0,
                          now: Optional[float] = None
                          ) -> Tuple[List[float], List[int], int, float]:
        """Summed per-bucket count deltas over label-filtered children of
        histogram ``name`` in the window: ``(le, bucket_deltas, total,
        covered_s)``. Children with mismatched bucket edges are skipped
        (not lied about); per-series deltas clamp at zero."""
        now = monotonic() if now is None else float(now)
        want = dict(labels or ())
        with self._lock:
            items = [(key, ser.le, list(ser.points))
                     for (n, key), ser in self._series.items()
                     if n == name and ser.kind == "histogram"
                     and _labels_match(key, want)]
            first_tick = self._first_tick
        le: Optional[List[float]] = None
        counts: List[int] = []
        total = 0
        covered = 0.0
        for key, ser_le, pts in items:
            if not pts:
                continue
            if le is None:
                le = list(ser_le)
                counts = [0] * (len(le) + 1)
            if list(ser_le) != le:
                continue
            last = pts[-1]
            base = _window_base("histogram", pts, now - window,
                                first_tick, self.max_points)
            total += max(0, last[1] - base[1])
            for i, (a, b) in enumerate(zip(last[3], base[3])):
                counts[i] += max(0, a - b)
            covered = max(covered, last[0] - base[0])
        return le or [], counts, total, max(0.0, covered)

    def window_scalar_delta(self, name: str, window: float = 60.0,
                            now: Optional[float] = None
                            ) -> Tuple[float, float]:
        """Summed window delta over all children of counter/gauge
        ``name``: ``(delta, covered_s)``; per-series clamp at zero."""
        now = monotonic() if now is None else float(now)
        with self._lock:
            items = [(ser.kind, list(ser.points))
                     for (n, _), ser in self._series.items()
                     if n == name and ser.kind in ("counter", "gauge")]
            first_tick = self._first_tick
        delta = 0.0
        covered = 0.0
        for kind, pts in items:
            if not pts:
                continue
            last = pts[-1]
            base = _window_base(kind, pts, now - window, first_tick,
                                self.max_points)
            delta += max(0.0, last[1] - base[1])
            covered = max(covered, last[0] - base[0])
        return delta, max(0.0, covered)

    # ----------------------------------------------------------- reading
    def series_held(self) -> int:
        with self._lock:
            return len(self._series)

    def points_held(self) -> int:
        with self._lock:
            return sum(len(s.points) for s in self._series.values())

    # --------------------------------------------------------- lifecycle
    def start(self) -> "TimeSeriesStore":
        """Arm the daemon ticker (idempotent). ``tick_s <= 0`` disables
        the thread entirely — sampling then rides ``tick_if_stale()``."""
        if self._thread is not None or self.tick_s <= 0:
            return self
        self._stop.clear()

        def run():
            while not self._stop.is_set():
                try:
                    self.tick()
                except Exception:
                    pass        # the sampler must never take a host down
                self._stop.wait(self.tick_s)

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="zoo-ts-sampler")
        self._thread.start()
        return self

    def stop(self):
        t, self._thread = self._thread, None
        self._stop.set()
        if t is not None:
            t.join(timeout=5)


# ------------------------------------------------------------ process-wide

_STORE: Optional[TimeSeriesStore] = None
_STORE_LOCK = threading.Lock()


def get_store() -> TimeSeriesStore:
    """Lazy default store (env-configured, ticker NOT armed — callers
    that want background sampling ``start()`` it; scrape handlers use
    ``tick_if_stale``)."""
    global _STORE
    with _STORE_LOCK:
        if _STORE is None:
            _STORE = TimeSeriesStore()
        return _STORE


def set_store(store: Optional[TimeSeriesStore]) -> None:
    global _STORE
    with _STORE_LOCK:
        old, _STORE = _STORE, store
    if old is not None and old is not store:
        old.stop()


def reset_for_tests():
    set_store(None)
