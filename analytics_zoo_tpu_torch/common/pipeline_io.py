"""Device-dispatch pipeline — a bounded in-flight window for the serving
hot path.

The port's own copy of ``analytics_zoo_tpu/common/pipeline_io.py``
(``StageTimer``, ``Completed``, ``DevicePipeline``). A CUDA launch returns
at once: the caller keeps *submitting* host batches, each submit
launches its batch, and results are *retired* (fetched to the host) only
when the window is full or the stream idles, so up to ``window`` batches
are on the card while the host decodes the next. Retirement is FIFO in
submission order.

On the card a batch's pending value is its output tensors and a CUDA
event recorded after the launch (``InferenceModel.predict_async``); its
fetch waits for that event, then makes one host copy of the batch
(``InferenceModel.predict_fetch``).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import numpy as np

from analytics_zoo_tpu_torch.common import resilience, telemetry


class StageTimer:
    """Per-stage wall-time stats (ref serving/utils/Timer.scala:26), plus
    unitless gauges (queue depth, overlap ratio) under ``values``.

    Every ``record`` also lands in the process-wide ``zoo_stage_seconds``
    histogram (labelled by stage) and every ``record_value`` sets the
    ``zoo_stage_value`` gauge, so they show up in ``GET /metrics``. The
    local lists give ``summary()`` its exact percentiles."""

    def __init__(self, registry: Optional[telemetry.MetricsRegistry] = None):
        self._lock = threading.Lock()
        self.stats: Dict[str, List[float]] = {}
        self.values: Dict[str, List[float]] = {}
        reg = registry if registry is not None else telemetry.get_registry()
        self._hist = reg.histogram(
            "zoo_stage_seconds", "Per-stage wall time", ("stage",))
        self._gauge = reg.gauge(
            "zoo_stage_value", "Unitless per-stage samples (queue depth, "
            "overlap ratio, batch bucket)", ("stage",))

    def record(self, stage: str, dt: float):
        with self._lock:
            self.stats.setdefault(stage, []).append(dt)
        self._hist.labels(stage).observe(dt)

    def record_value(self, name: str, v: float):
        """A unitless sample (queue depth, ratio) — reported un-scaled."""
        with self._lock:
            self.values.setdefault(name, []).append(float(v))
        self._gauge.labels(name).set(v)

    def summary(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            out = {}
            for stage, xs in self.stats.items():
                arr = np.asarray(xs)
                out[stage] = {"count": len(xs), "mean_ms": float(arr.mean() * 1e3),
                              "p99_ms": float(np.percentile(arr, 99) * 1e3),
                              "total_s": float(arr.sum())}
            for name, xs in self.values.items():
                arr = np.asarray(xs)
                out[name] = {"count": len(xs), "mean": float(arr.mean()),
                             "p99": float(np.percentile(arr, 99))}
            return out


class Completed(NamedTuple):
    """One retired batch: host ``result`` (None if the batch failed),
    the caller's ``ctx`` passed at submit, the ``error`` raised by dispatch
    or fetch (None on success), and timing for stage stats.

    ``t_submit``/``dispatch_s`` place the batch on the process
    ``perf_counter`` clock so consumers (the serving engine) can turn the
    window residency into trace spans: the device span is
    ``[t_submit, t_submit + inflight_s]`` and the dispatch sub-span is
    ``[t_submit, t_submit + dispatch_s]``."""

    result: Any
    ctx: Any
    error: Optional[BaseException]
    inflight_s: float       # submit → retired (device window residency)
    fetch_s: float          # blocking part of the retirement only
    t_submit: float = 0.0   # perf_counter at dispatch
    dispatch_s: float = 0.0  # non-blocking dispatch call duration


class DevicePipeline:
    """Bounded in-flight dispatch window.

    ``submit_fn(batch)`` must *launch* work and return without blocking on
    the result (a forward on the card, returning its output tensors).
    ``fetch_fn(pending)`` blocks for the host value. At most ``window``
    submitted batches are outstanding; the ``window+1``-th submit first
    retires the oldest.

    A batch whose dispatch or fetch raises retires as a ``Completed`` with
    ``error`` set — later batches are unaffected, so a stream consumer can
    fail one batch without tearing down the pipeline.

    Not thread-safe: one pipeline belongs to one producer thread (the
    serve loop).
    """

    def __init__(self, submit_fn: Callable[[Any], Any],
                 fetch_fn: Callable[[Any], Any], window: int = 2,
                 timer: Optional[StageTimer] = None):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.window = int(window)
        self._submit_fn = submit_fn
        self._fetch_fn = fetch_fn
        self._timer = timer
        # (pending_device_value, ctx, t_submit, dispatch_error, dispatch_s)
        self._q: deque = deque()

    # ------------------------------------------------------------- window
    @property
    def in_flight(self) -> int:
        return len(self._q)

    def submit(self, batch, ctx=None) -> List[Completed]:
        """Dispatch one batch. Returns the batches retired to keep the
        window bounded — empty until the window fills, then exactly the
        overflow, oldest first."""
        done = []
        while len(self._q) >= self.window:
            done.append(self._retire())
        t0 = time.perf_counter()
        try:
            # fault_scope owns the "dispatch" arrival for this batch, so a
            # planned `wedge@dispatch:N` wedges exactly the Nth batch
            with resilience.fault_scope("dispatch"):
                pending = self._submit_fn(batch)
            err = None
        except Exception as e:
            # a dispatch-time failure rides the window like any other batch
            # so it retires IN ORDER relative to its neighbours
            pending, err = None, e
        dispatch_s = time.perf_counter() - t0
        if self._timer is not None:
            self._timer.record("dispatch", dispatch_s)
            self._timer.record_value("window_depth", len(self._q) + 1)
        self._q.append((pending, ctx, t0, err, dispatch_s))
        return done

    def _retire(self) -> Completed:
        pending, ctx, t0, err, dispatch_s = self._q.popleft()
        if err is not None:
            return Completed(None, ctx, err, time.perf_counter() - t0, 0.0,
                             t0, dispatch_s)
        t_fetch = time.perf_counter()
        try:
            resilience.maybe_fault("fetch")
            host = self._fetch_fn(pending)
            err = None
        except Exception as e:
            host, err = None, e
        now = time.perf_counter()
        fetch_s, inflight_s = now - t_fetch, now - t0
        # the blocked fetch is the device half of the device-vs-host split
        telemetry.observe_device_block(fetch_s, "fetch")
        if self._timer is not None:
            self._timer.record("fetch", fetch_s)
            # overlap ratio: how much of this batch's window residency the
            # host spent NOT blocked on the fetch (1.0 = compute fully
            # hidden behind host work, 0.0 = synchronous)
            self._timer.record_value(
                "overlap_ratio", 1.0 - fetch_s / max(inflight_s, 1e-9))
        return Completed(host, ctx, err, inflight_s, fetch_s, t0, dispatch_s)

    def drain(self) -> List[Completed]:
        """Retire every in-flight batch, oldest first. Called at stream
        end or when the producer idles."""
        done = []
        while self._q:
            done.append(self._retire())
        return done
