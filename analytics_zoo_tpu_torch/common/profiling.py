"""Profiling and the flight recorder — the diagnostic layer over telemetry.

The port's own copy of ``analytics_zoo_tpu/common/profiling.py``:

- **Chrome-trace export** — the process tracer's span store as Chrome
  Trace Event JSON (Perfetto, ``chrome://tracing``): :func:`chrome_trace`,
  :func:`dump_trace`, served by the frontend's ``GET /trace``. One track
  (tid) per trace id, "X" events in µs from the earliest span, the JAX
  package's layout event for event.
- **StepProfiler** — the per-step training decomposition ``fit`` feeds:
  ``zoo_step_flops`` (the step's products counted once by
  :func:`step_flops`), ``zoo_mfu`` (flops / fenced device seconds / the
  card's peak), ``zoo_hbm_bytes{source}`` (``torch.cuda.memory_stats``
  on the card; on the CPU the summed bytes of the tensors the caller
  names), the ``zoo_train_phase_seconds{phase}`` histogram and sampled
  step traces ``train/step-<n>``.
- **FlightRecorder** — a bounded ring of recent spans and notes that
  dumps a postmortem JSON (spans, a metrics snapshot, env, the backend
  probe) to ``zoo_tpu_logs/`` on SIGTERM or on demand. Armed by
  ``ZOO_FLIGHT_RECORDER=1``.
- **backend probe** — :func:`backend_state`: ``torch.cuda``'s
  availability, device count and name, read in a daemon thread joined
  with a timeout, so ``GET /healthz`` reports a wedged CUDA runtime
  (``status: wedged``) and never hangs on it.

Unknown device → no MFU (never a made-up peak); the CPU has none.

**Counting flops.** :func:`step_flops` runs one forward and backward of
the step under ``torch.utils.flop_counter.FlopCounterMode``, which counts
the products aten runs. The flash-attention kernels are ctypes launches it
cannot see, so while it counts, flash attention runs through operators of
its own (``ops/flash_attention.py``) whose registered count is the einsum
chain's (forward 4·b·h·s_q·s_k·d for QKᵀ and PV; backward twice that, the
recompute of S not counted; causal counts the full square, as the masked
chain computes it) and whose bodies the counter does not see. So a step
counts the same on the CPU and on the card, by either route.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
from collections import deque
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from analytics_zoo_tpu_torch.common import telemetry
from analytics_zoo_tpu_torch.common.telemetry import Span

__all__ = [
    "PEAK_FLOPS", "device_peak_flops", "step_flops", "hbm_bytes",
    "chrome_trace", "chrome_trace_events", "dump_trace", "StepProfiler",
    "FlightRecorder", "get_flight_recorder", "maybe_arm_from_env",
    "backend_state", "DUMP_DIR", "reset_for_tests",
]

# default dump directory for flight-recorder postmortems (relative to cwd;
# override with ZOO_FLIGHT_RECORDER_DIR)
DUMP_DIR = "zoo_tpu_logs"

#: peak dense-product FLOP/s per card (bf16 on the tensor cores), keyed by
#: ``torch.cuda.get_device_name()``; override with BENCH_PEAK_FLOPS /
#: ZOO_PEAK_FLOPS. H100 SXM5: NVIDIA's H100 Tensor Core GPU datasheet,
#: BF16 tensor core 1,979 TFLOPS with sparsity, so 989.4e12 dense.
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989.4e12,
}


def device_peak_flops(device=None) -> Optional[float]:
    """Peak FLOP/s of ``device`` (default: the first CUDA device), from
    the env override (``BENCH_PEAK_FLOPS`` / ``ZOO_PEAK_FLOPS``) or the
    table. None for the CPU and for cards not in the table: MFU is then
    not published."""
    for var in ("BENCH_PEAK_FLOPS", "ZOO_PEAK_FLOPS"):
        if os.environ.get(var):
            return float(os.environ[var])
    try:
        import torch
        dev = torch.device("cuda" if device is None else device)
        if dev.type != "cuda" or not torch.cuda.is_available():
            return None
        return PEAK_FLOPS.get(torch.cuda.get_device_name(dev))
    except Exception:
        return None


def step_flops(fn: Callable[[], Any]) -> Optional[float]:
    """The products of one call of ``fn`` (a step's forward and backward)
    as ``FlopCounterMode`` counts them, flash attention by its registered
    count (module docstring). None when nothing was counted or ``fn``
    raised. The caller keeps ``fn`` free of side effects on its state."""
    try:
        from torch.utils.flop_counter import FlopCounterMode

        from analytics_zoo_tpu_torch.ops import flash_attention as fa
        with fa.counting_flops() as formulas, FlopCounterMode(
                display=False, custom_mapping=formulas) as mode:
            fn()
        return float(mode.get_total_flops()) or None
    except Exception:
        return None


def _tensor_bytes(tensors) -> int:
    import torch
    seen, total = set(), 0

    def walk(obj):
        nonlocal total
        if isinstance(obj, torch.Tensor):
            key = (obj.data_ptr(), obj.numel(), obj.dtype)
            if key not in seen:
                seen.add(key)
                total += obj.numel() * obj.element_size()
        elif isinstance(obj, dict):
            for v in obj.values():
                walk(v)
        elif isinstance(obj, (list, tuple)):
            for v in obj:
                walk(v)

    walk(tensors)
    return total


def hbm_bytes(device=None, tensors=None) -> Tuple[Optional[int], str]:
    """(resident device bytes, source). On the card ``memory_stats``: the
    caching allocator's ``allocated_bytes.all.current``. Elsewhere
    ``live_tensors``: the summed bytes of ``tensors`` (a nest of tensors,
    or a callable returning one), e.g. an estimator's parameters and
    optimizer state. ``(None, "unavailable")`` when neither applies."""
    try:
        import torch
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda" and torch.cuda.is_available():
            stats = torch.cuda.memory_stats(dev)
            return int(stats.get("allocated_bytes.all.current", 0)), \
                "memory_stats"
        if tensors is None:
            return None, "unavailable"
        if callable(tensors):
            tensors = tensors()
        return _tensor_bytes(tensors), "live_tensors"
    except Exception:
        return None, "unavailable"


# -------------------------------------------------------- chrome trace

def chrome_trace_events(
        traces: Optional[Dict[str, List[Span]]] = None,
        tracer: Optional[telemetry.Tracer] = None) -> List[dict]:
    """Flatten a span store into Chrome Trace Event dicts: complete
    ("ph":"X") events, timestamps in µs relative to the earliest span, one
    tid per trace id with a ``thread_name`` metadata event."""
    if traces is None:
        traces = (tracer or telemetry.get_tracer()).traces()
    pid = os.getpid()
    events: List[dict] = [{
        "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
        "args": {"name": "analytics_zoo_tpu"}}]
    all_spans = [s for spans in traces.values() for s in spans]
    t0 = min((s.start for s in all_spans), default=0.0)
    for tid, (trace_id, spans) in enumerate(traces.items(), start=1):
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": tid, "args": {"name": trace_id}})
        for s in sorted(spans, key=lambda s: s.start):
            events.append({
                "name": s.name, "cat": "zoo", "ph": "X",
                "ts": round((s.start - t0) * 1e6, 3),
                "dur": round(s.duration * 1e6, 3),
                "pid": pid, "tid": tid,
                "args": {"trace_id": trace_id,
                         "parent": s.parent or ""}})
    return events


def chrome_trace(trace_id: Optional[str] = None,
                 tracer: Optional[telemetry.Tracer] = None) -> dict:
    """The tracer's span store as a Chrome Trace Event JSON object
    (optionally one ``trace_id``)."""
    tracer = tracer or telemetry.get_tracer()
    traces = tracer.traces()
    if trace_id is not None:
        traces = {k: v for k, v in traces.items() if k == trace_id}
    return {"displayTimeUnit": "ms",
            "traceEvents": chrome_trace_events(traces)}


def dump_trace(path: str, trace_id: Optional[str] = None,
               tracer: Optional[telemetry.Tracer] = None) -> str:
    """Write :func:`chrome_trace` to ``path``; returns the path."""
    obj = chrome_trace(trace_id, tracer=tracer)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(obj, fh)
    return path


# -------------------------------------------------------- step profiler

class StepProfiler:
    """Per-step training decomposition for ``fit``.

    The estimator times each step's phases on the host (the data wait,
    the dispatch, on sampled steps the fenced device time, the callbacks)
    and hands them to :meth:`observe_step`, which keeps

    - the ``zoo_train_phase_seconds{phase}`` histogram (every step),
    - ``zoo_step_flops`` (:meth:`set_flops`) and ``zoo_mfu`` = flops ×
      steps / fenced device seconds / peak (no peak, no MFU),
    - ``zoo_hbm_bytes{source}``, refreshed on sampled steps,
    - spans under ``{name}/step-{n}`` on sampled steps: a ``step`` parent
      over contiguous ``data_wait`` / ``dispatch`` / ``device`` /
      ``callback`` children.

    Only every ``sample_every``-th step is fenced: fencing every step
    would serialize the host against the device."""

    def __init__(self, name: str = "train", sample_every: int = 10,
                 peak_flops: Optional[float] = None, device=None,
                 live_tensors=None,
                 registry: Optional[telemetry.MetricsRegistry] = None,
                 tracer: Optional[telemetry.Tracer] = None):
        reg = registry if registry is not None else telemetry.get_registry()
        self._tracer = tracer if tracer is not None else \
            telemetry.get_tracer()
        self.name = name
        self.sample_every = max(1, int(sample_every))
        self.device = device
        self.live_tensors = live_tensors
        self.peak_flops = (peak_flops if peak_flops is not None
                           else device_peak_flops(device))
        self.flops: Optional[float] = None   # per optimizer step
        self._flops_attempted = False
        self._g_flops = reg.gauge(
            "zoo_step_flops", "FLOPs of one optimizer step (the products "
            "of its forward and backward)")
        self._g_mfu = reg.gauge(
            "zoo_mfu", "Model FLOPs utilization: step flops / fenced "
            "device time / peak")
        self._g_hbm = reg.gauge(
            "zoo_hbm_bytes", "Resident device memory", ("source",))
        self._h_phase = reg.histogram(
            "zoo_train_phase_seconds", "Per-step training phase wall "
            "time", ("phase",))

    # ------------------------------------------------------------ flops
    def set_flops(self, flops: Optional[float], per_steps: int = 1):
        """Record the FLOPs of ``per_steps`` optimizer steps."""
        if flops:
            self.flops = float(flops) / max(1, int(per_steps))
            self._g_flops.set(self.flops)

    def ensure_flops(self, thunk, per_steps: int = 1):
        """Take the count once from ``thunk()`` (attempted a single time;
        the first batch shape wins)."""
        if self._flops_attempted:
            return
        self._flops_attempted = True
        try:
            self.set_flops(thunk(), per_steps)
        except Exception:
            pass

    def should_sample(self, step: int) -> bool:
        """Sampled steps are fenced (device time measured) and traced."""
        return step % self.sample_every == 0

    # ------------------------------------------------------------ steps
    def observe_step(self, step: int, t_start: float, data_wait_s: float,
                     dispatch_s: float, device_s: Optional[float] = None,
                     callback_s: float = 0.0, n_steps: int = 1):
        """One step (or a loop of ``n_steps``), phase durations measured
        by the caller. ``device_s`` is the fenced dispatch-to-done time of
        sampled steps; ``t_start`` the ``perf_counter`` at which the data
        wait began."""
        self._h_phase.labels("data_wait").observe(data_wait_s)
        self._h_phase.labels("dispatch").observe(dispatch_s)
        if callback_s:
            self._h_phase.labels("callback").observe(callback_s)
        if device_s is None:
            return
        self._h_phase.labels("device").observe(device_s)
        if self.flops and device_s > 0 and self.peak_flops:
            self._g_mfu.set(
                self.flops * n_steps / device_s / self.peak_flops)
        n, src = hbm_bytes(self.device, self.live_tensors)
        if n is not None:
            self._g_hbm.labels(src).set(n)
        tid = f"{self.name}/step-{step}"
        t_disp = t_start + data_wait_s
        t_dev_end = t_disp + device_s
        end = t_dev_end + callback_s
        self._tracer.record(tid, "step", t_start, end)
        self._tracer.record(tid, "data_wait", t_start, t_disp,
                            parent="step")
        self._tracer.record(tid, "dispatch", t_disp, t_disp + dispatch_s,
                            parent="step")
        self._tracer.record(tid, "device", t_disp, t_dev_end,
                            parent="step")
        if callback_s:
            self._tracer.record(tid, "callback", t_dev_end, end,
                                parent="step")


# ----------------------------------------------------- flight recorder

class FlightRecorder:
    """Bounded ring of recent spans and free-form notes, dumpable as a
    postmortem JSON.

    ``attach()`` hooks the process tracer so every recorded span lands in
    the ring; ``arm()`` installs a SIGTERM handler (chaining any earlier
    one) so an external kill leaves a dump; ``dump()`` writes the last N
    spans, a metrics snapshot, the env and the backend probe to
    ``zoo_tpu_logs/flightrec_*.json``."""

    _ENV_PREFIXES = ("ZOO_", "BENCH_", "CUDA_", "TORCH_", "PYTORCH_")

    def __init__(self, capacity: int = 256,
                 dump_dir: Optional[str] = None,
                 tracer: Optional[telemetry.Tracer] = None):
        self._tracer = tracer if tracer is not None else \
            telemetry.get_tracer()
        self._spans: "deque[Span]" = deque(maxlen=int(capacity))
        self._notes: "deque[str]" = deque(maxlen=64)
        self._lock = threading.Lock()
        self._attached = False
        self._prev_handlers: Dict[int, Any] = {}
        self._seq = 0
        # dump_once latch: trigger -> written path
        self._dumped: Dict[str, str] = {}
        # an explicit dir wins; else resolved at dump time, so the env
        # override reaches a singleton made before it was set
        self.dump_dir = dump_dir

    # --------------------------------------------------------- feeding
    def observe(self, span: Span):
        self._spans.append(span)   # deque.append is atomic

    def note(self, msg: str):
        """Free-form breadcrumb for the dump."""
        self._notes.append(str(msg))

    def attach(self) -> "FlightRecorder":
        with self._lock:
            if not self._attached:
                self._tracer.add_hook(self.observe)
                self._attached = True
        return self

    def detach(self):
        with self._lock:
            if self._attached:
                self._tracer.remove_hook(self.observe)
                self._attached = False

    # --------------------------------------------------------- dumping
    def snapshot(self, reason: str = "") -> dict:
        spans = list(self._spans)
        env = {k: v for k, v in os.environ.items()
               if k.startswith(self._ENV_PREFIXES)}
        try:
            metrics = telemetry.snapshot()
        except Exception as e:
            metrics = {"error": repr(e)[:200]}
        return {
            "kind": "zoo_flight_recorder",
            "reason": reason,
            "pid": os.getpid(),
            "argv": list(sys.argv),
            "env": env,
            "backend": backend_state(),
            "notes": list(self._notes),
            "metrics": metrics,
            "spans": [{"trace_id": s.trace_id, "name": s.name,
                       "start": s.start, "end": s.end,
                       "duration_ms": round(s.duration * 1e3, 3),
                       "parent": s.parent} for s in spans],
        }

    def dump(self, reason: str = "", path: Optional[str] = None) -> str:
        """Write the postmortem; returns its path, or "" on failure (a
        failing dump on a dying process must not mask the fault)."""
        try:
            if path is None:
                with self._lock:
                    self._seq += 1
                    seq = self._seq
                import time
                stamp = int(time.time())   # wallclock: ok (file name)
                base = (self.dump_dir
                        or os.environ.get("ZOO_FLIGHT_RECORDER_DIR")
                        or DUMP_DIR)
                path = os.path.join(
                    base, f"flightrec_{stamp}_{os.getpid()}_{seq}.json")
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)
            with open(path, "w") as fh:
                json.dump(self.snapshot(reason), fh)
            return path
        except Exception:
            return ""

    def dump_once(self, trigger: str, reason: str = "",
                  path: Optional[str] = None) -> str:
        """At most one postmortem per ``trigger`` key for the life of the
        recorder; a repeat returns the first call's path ("" if that dump
        failed: failure latches too)."""
        with self._lock:
            if trigger in self._dumped:
                return self._dumped[trigger]
        out = self.dump(reason=reason or trigger, path=path)
        with self._lock:
            self._dumped.setdefault(trigger, out)
            return self._dumped[trigger]

    # --------------------------------------------------------- signals
    def _handler(self, signum, frame):
        name = signal.Signals(signum).name
        self.dump_once(trigger=f"signal-{name}", reason=f"signal-{name}")
        prev = self._prev_handlers.get(signum)
        if callable(prev):
            prev(signum, frame)
        elif prev == signal.SIG_DFL:
            # restore and re-deliver: the process still dies the way the
            # sender expects, with the dump written first
            signal.signal(signum, signal.SIG_DFL)
            os.kill(os.getpid(), signum)

    def arm(self, signals: Iterable[int] = (signal.SIGTERM,)) -> bool:
        """Install dump-on-signal handlers. False (nothing installed) off
        the main thread, where CPython refuses signal handlers."""
        try:
            for sig in signals:
                prev = signal.signal(sig, self._handler)
                # never chain to ourselves when re-armed
                if sig not in self._prev_handlers and \
                        prev is not self._handler:
                    self._prev_handlers[sig] = prev
        except ValueError:
            return False
        return True

    def disarm(self):
        for sig, prev in self._prev_handlers.items():
            try:
                signal.signal(sig, prev)
            except ValueError:
                pass
        self._prev_handlers.clear()


_FLIGHT_RECORDER: Optional[FlightRecorder] = None
_FR_LOCK = threading.Lock()


def get_flight_recorder(capacity: int = 256) -> FlightRecorder:
    """The process-wide flight recorder, made and attached on first use."""
    global _FLIGHT_RECORDER
    with _FR_LOCK:
        if _FLIGHT_RECORDER is None:
            _FLIGHT_RECORDER = FlightRecorder(capacity=capacity)
        _FLIGHT_RECORDER.attach()
        return _FLIGHT_RECORDER


def maybe_arm_from_env() -> Optional[FlightRecorder]:
    """``ZOO_FLIGHT_RECORDER=1`` → attach and arm (SIGTERM) the singleton.
    Called from long-running entry points (the serving engine's start)."""
    if os.environ.get("ZOO_FLIGHT_RECORDER", "").lower() not in (
            "1", "true", "yes", "on"):
        return None
    fr = get_flight_recorder()
    fr.arm()
    return fr


# ------------------------------------------------------- backend probe

_BACKEND_CACHE: Dict[str, Any] = {}
# probed from request threads and dump paths at once: the cache update
# must not interleave with clear()
_BACKEND_LOCK = threading.Lock()


def backend_state(timeout_s: float = 2.0) -> dict:
    """The device backend without ever blocking the caller: a daemon
    thread reads ``torch.cuda.is_available()``, ``device_count()`` and
    ``get_device_name()`` and is joined with a timeout, so a wedged CUDA
    runtime gives ``{"status": "wedged"}`` instead of hanging a health
    endpoint.
    ``platform`` is ``gpu`` with the card's name as ``device_kind``, or
    ``cpu``. A successful probe is cached."""
    with _BACKEND_LOCK:
        if _BACKEND_CACHE.get("status") == "ok":
            return dict(_BACKEND_CACHE)
    result: Dict[str, Any] = {}

    def probe():
        try:
            import torch
            if torch.cuda.is_available():
                result.update(status="ok", platform="gpu",
                              device_kind=torch.cuda.get_device_name(0),
                              device_count=torch.cuda.device_count())
            else:
                result.update(status="ok", platform="cpu",
                              device_kind="cpu", device_count=1)
        except BaseException as e:
            result.update(status="error", error=repr(e)[:200])

    t = threading.Thread(target=probe, daemon=True, name="zoo-probe")
    t.start()
    t.join(timeout_s)
    if not result:
        return {"status": "wedged", "probe_timeout_s": timeout_s}
    out = dict(result)
    if out.get("status") == "ok":
        with _BACKEND_LOCK:
            _BACKEND_CACHE.update(out)
    return out


def reset_for_tests():
    """Called from ``telemetry.reset_for_tests()``: drop the flight
    recorder singleton (its tracer hook went with the trace clear) and
    the backend probe's cache."""
    global _FLIGHT_RECORDER
    with _FR_LOCK:
        if _FLIGHT_RECORDER is not None:
            _FLIGHT_RECORDER.detach()
            _FLIGHT_RECORDER.disarm()
            _FLIGHT_RECORDER = None
    with _BACKEND_LOCK:
        _BACKEND_CACHE.clear()
