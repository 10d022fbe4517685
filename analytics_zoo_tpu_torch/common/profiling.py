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

**Counting flops.** :func:`step_flops` runs one training step (forward,
backward and the optimizer's update) under
``torch.utils.flop_counter.FlopCounterMode`` with the mapping of
:func:`step_formulas`, which counts what XLA's cost analysis counts of the
same step in the JAX package (``compiled_step_flops``, ROADMAP C18):

- products at 2 a multiply-add: mm, bmm, and each convolution's taps
  that fall inside its input (XLA counts no tap on padding, its own or
  an explicit zero pad's), forward and each gradient it computes; addmm
  and a convolution's bias add 1 an output element;
- elementwise arithmetic at 1 an element (add, mul, div, relu's mask,
  compares, selects, dtype casts, ``_foreach_*`` updates), reductions at
  1 an input element, transcendentals (exp, log, sqrt, tanh, erf) at 0,
  as XLA files them apart;
- composite ops at the cost of XLA's decomposition of the flax or jax.nn
  op, measured with ``jax.jit(...).lower(...).compile().cost_analysis()``
  on the CPU (:data:`_COMPOSITE`): batch norm, layer norm, gelu, softmax
  and log-softmax, forward and backward;
- random draws at 0: XLA also counts threefry's integer arithmetic (about
  51 an element, dropout's mask), which the port's draws do not run.

Kernels are ctypes launches the counter cannot see, and their plain
versions on the CPU are not the card's arithmetic. So while a step is
counted, a kernel's wrapper hides its body and counts a registered number
instead (:func:`counted`); flash attention runs through operators of its
own (``ops/flash_attention.py``) whose registered count is the einsum
chain's (forward 4·b·h·s_q·s_k·d for QKᵀ and PV; backward twice that;
causal counts the full square, as the masked chain computes it). So a
step counts the same on the CPU and on the card, by either route.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import signal
import sys
import threading
from collections import deque
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from analytics_zoo_tpu_torch.common import telemetry
from analytics_zoo_tpu_torch.common.telemetry import Span

__all__ = [
    "PEAK_FLOPS", "device_peak_flops", "step_flops", "step_flop_counts",
    "step_formulas", "counted", "hbm_bytes",
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


# ------------------------------------------------------- counting flops

#: elementwise aten ops at 1 flop an output element (their in-place forms
#: too): XLA's count of the same HLO (add, multiply, compare, select,
#: maximum, convert, ...)
_POINTWISE = (
    "add", "sub", "rsub", "mul", "div", "neg", "relu", "threshold_backward",
    "where", "clamp_min", "clamp_max", "maximum", "minimum", "eq", "ne",
    "ge", "gt", "le", "lt", "abs", "sign", "reciprocal", "remainder",
    "fmod", "logical_and", "logical_or", "logical_not", "logical_xor",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "masked_fill", "square", "floor", "ceil", "round", "trunc")
#: composite ops: flops an element of the first input, XLA's count of its
#: flax / jax.nn decomposition (forward; backward from a VJP with a live
#: cotangent, its forward subtracted). (training, eval) for batch norm;
#: (exact, tanh) for gelu.
_COMPOSITE = {
    "native_batch_norm": (6, 2), "_native_batch_norm_legit": (6, 2),
    "native_batch_norm_backward": 7,
    "native_layer_norm": 7, "native_layer_norm_backward": 14,
    "gelu": (64, 8), "gelu_backward": (7, 12),
    "_softmax": 4, "_softmax_backward_data": 5,
    "_log_softmax": 5, "_log_softmax_backward_data": 1,
    "sigmoid": 3, "sigmoid_backward": 3, "tanh_backward": 4,
    "clamp": 2, "lerp": 3, "addcmul": 2, "addcdiv": 2,
}
#: reductions at 1 an input element (mean adds its division)
_REDUCE = ("sum", "mean", "amax", "amin", "max", "min", "prod", "cumsum",
           "logsumexp", "norm", "linalg_vector_norm")
#: scatters at 1 an update element
_SCATTER = {"index_add": 2, "index_add_": 2, "scatter_add": 3,
            "scatter_add_": 3}
#: the multi-tensor optimizer ops, flops an element of the first list
_FOREACH = {"add": 1, "sub": 1, "mul": 1, "div": 1, "neg": 1,
            "maximum": 1, "minimum": 1, "clamp_min": 1, "clamp_max": 1,
            "addcmul": 2, "addcdiv": 2, "lerp": 3, "norm": 2, "sign": 1,
            "abs": 1, "reciprocal": 1, "sqrt": 0, "exp": 0, "log": 0,
            "pow": 0, "zero": 0, "copy": 0}

_count_lock = threading.Lock()
_counting: List[List[int]] = []     # one running total per open count


@contextlib.contextmanager
def counted(flops: Callable[[], int]):
    """Wrap a kernel's launch (or its plain version): while a step is
    counted (:func:`step_flops`), hide the block's aten ops from the
    counter and count ``flops()`` for it instead; elsewhere a no-op."""
    if not _counting:
        yield
        return
    from torch.utils._python_dispatch import _disable_current_modes
    with _disable_current_modes():
        yield
    n = int(flops())
    with _count_lock:
        for total in _counting:
            total[0] += n


def _numel(t) -> int:
    return int(t.numel()) if hasattr(t, "numel") else 0


def _raw(fn):
    fn._get_raw = True
    return fn


def _each(rate):
    return _raw(lambda *a, out_val=None, **k: rate * _numel(out_val))


def _of_input(rate):
    return _raw(lambda *a, out_val=None, **k: rate * _numel(a[0]))


def _valid_taps(size: int, out: int, k: int, stride: int, pad: int,
                dil: int) -> int:
    """Kernel taps over all ``out`` positions of one spatial dim that fall
    inside an input of ``size`` (XLA's count; padding taps are free)."""
    taps = 0
    for o in range(out):
        lo = o * stride - pad
        taps += sum(1 for j in range(k) if 0 <= lo + j * dil < size)
    return taps


def _conv_taps(x, w, stride, padding, dilation, out, zero_pads) -> int:
    """Multiply-adds of a convolution over the taps inside its input.
    ``zero_pads`` maps a tensor's data pointer to the zero padding
    ``constant_pad_nd`` gave it (``[batch, *spatial, channels]``: a pair a
    spatial dim), so taps on an explicit pad are not counted either."""
    nd = w.dim() - 2
    pad = list(padding) * nd if len(padding) == 1 else list(padding)
    st = list(stride) * nd if len(stride) == 1 else list(stride)
    dl = list(dilation) * nd if len(dilation) == 1 else list(dilation)
    size = list(x.shape[2:])
    extra = zero_pads.get(x.data_ptr())
    if extra is not None and tuple(extra[0]) == tuple(size):
        for d, (lo, hi) in enumerate(extra[1]):
            size[d] -= lo + hi
            pad[d] += lo
    taps = 1
    for d in range(nd):
        taps *= _valid_taps(size[d], out.shape[2 + d], w.shape[2 + d],
                            st[d], pad[d], dl[d])
    return x.shape[0] * w.shape[0] * w.shape[1] * taps


def _zero_pad(zero_pads):
    """``constant_pad_nd`` at 0 flops; a zero pad of a ``[batch,
    *spatial, channels]`` tensor's spatial dims is remembered for the
    convolution that reads it."""
    @_raw
    def count(x, flat, value=0.0, out_val=None, **kw) -> int:
        flat = list(flat)
        if not value and out_val is not None and len(flat) >= 4 and \
                not any(flat[:2]) and len(flat) <= 2 * (x.dim() - 1):
            pairs = [(flat[i], flat[i + 1]) for i in range(2, len(flat), 2)]
            spatial = x.dim() - 2
            pairs = list(reversed(pairs)) + [(0, 0)] * (spatial - len(pairs))
            zero_pads[out_val.data_ptr()] = (tuple(out_val.shape[1:-1]),
                                             pairs)
        return 0
    return count


def _conv_fwd(zero_pads):
    @_raw
    def count(x, w, bias, stride, padding, dilation, transposed, _op,
              groups, out_val=None, **kw) -> int:
        from torch.utils.flop_counter import conv_flop_count
        if transposed:
            return conv_flop_count(x.shape, w.shape, out_val.shape, True)
        return 2 * _conv_taps(x, w, stride, padding, dilation, out_val,
                              zero_pads) + (
            _numel(out_val) if bias is not None else 0)
    return count


def _conv_bwd(zero_pads):
    @_raw
    def count(grad_out, x, w, bias_sizes, stride, padding, dilation,
              transposed, _op, groups, mask, out_val=None, **kw) -> int:
        from torch.utils.flop_counter import conv_backward_flop
        if transposed:
            return conv_backward_flop(grad_out.shape, x.shape, w.shape,
                                      None, stride, padding, dilation,
                                      transposed, _op, groups, mask)
        fwd = 2 * _conv_taps(x, w, stride, padding, dilation, grad_out,
                             zero_pads)
        return fwd * (int(mask[0]) + int(mask[1])) + (
            _numel(grad_out) if mask[2] else 0)
    return count


@_raw
def _addmm(bias, a, b, *args, out_val=None, **kw) -> int:
    return 2 * a.shape[0] * a.shape[1] * b.shape[1] + _numel(out_val)


@_raw
def _baddbmm(bias, a, b, *args, out_val=None, **kw) -> int:
    return 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2] \
        + _numel(out_val)


@_raw
def _batch_norm(x, *args, out_val=None, **kw) -> int:
    train = args[4] if len(args) > 4 else kw.get("training", False)
    if len(args) == 4 and isinstance(args[2], bool):  # _legit (no stats)
        train = args[2]
    return _COMPOSITE["native_batch_norm"][0 if train else 1] * _numel(x)


@_raw
def _gelu(x, *args, out_val=None, approximate="none", **kw) -> int:
    return _COMPOSITE["gelu"][approximate != "none"] * _numel(x)


@_raw
def _gelu_bwd(g, x, *args, out_val=None, approximate="none", **kw) -> int:
    return _COMPOSITE["gelu_backward"][approximate != "none"] * _numel(x)


@_raw
def _pow(x, exponent=None, *args, out_val=None, **kw) -> int:
    return _numel(out_val) if exponent == 2 else 0


@_raw
def _convert(x, *args, out_val=None, **kw) -> int:
    """A dtype cast is XLA's convert (1 an element); a copy is free."""
    src = args[0] if args and hasattr(args[0], "dtype") else x
    dst = out_val if hasattr(out_val, "dtype") else x
    return _numel(dst) if src.dtype != dst.dtype else 0


@_raw
def _mean(x, *args, out_val=None, **kw) -> int:
    return _numel(x) + _numel(out_val)


def _scatter(pos):
    return _raw(lambda *a, out_val=None, **k: _numel(a[pos]))


@_raw
def _index_put(x, indices, values, accumulate=False, *a, out_val=None,
               **kw) -> int:
    """An accumulating index_put is a scatter-add: 1 an updated element."""
    if not accumulate:
        return 0
    idx = [i for i in indices if i is not None]
    return _numel(idx[0]) * math.prod(x.shape[len(indices):]) if idx else 0


def _foreach(rate):
    return _raw(lambda first, *a, out_val=None, **k:
                rate * sum(_numel(t) for t in first))


def step_formulas() -> Dict[Any, Callable]:
    """``{aten op: count formula}`` for ``FlopCounterMode(custom_mapping=
    ...)``: the module docstring's rules (every formula raw)."""
    import torch
    aten = torch.ops.aten
    out: Dict[Any, Callable] = {}

    def put(name, fn):
        op = getattr(aten, name, None)
        if op is not None:
            out[op] = fn

    for name in _POINTWISE:
        put(name, _each(1))
        put(name + "_", _each(1))
    for name in ("native_batch_norm_backward", "native_layer_norm",
                 "native_layer_norm_backward", "_softmax",
                 "_softmax_backward_data", "_log_softmax",
                 "_log_softmax_backward_data", "sigmoid",
                 "sigmoid_backward", "tanh_backward", "clamp", "lerp",
                 "addcmul", "addcdiv"):
        rate = _COMPOSITE[name]
        put(name, _of_input(rate))
        put(name + "_", _of_input(rate))
    put("native_batch_norm", _batch_norm)
    put("_native_batch_norm_legit", _batch_norm)
    put("gelu", _gelu)
    put("gelu_backward", _gelu_bwd)
    put("pow", _pow)
    for name in _REDUCE:
        put(name, _of_input(1))
    put("mean", _mean)
    for name, pos in _SCATTER.items():
        put(name, _scatter(pos))
    put("index_put_", _index_put)
    put("index_put", _index_put)
    put("_to_copy", _convert)
    put("copy_", _convert)
    for name, rate in _FOREACH.items():
        put(f"_foreach_{name}", _foreach(rate))
        put(f"_foreach_{name}_", _foreach(rate))
    zero_pads: Dict[int, Any] = {}
    put("constant_pad_nd", _zero_pad(zero_pads))
    put("convolution", _conv_fwd(zero_pads))
    put("convolution_backward", _conv_bwd(zero_pads))
    put("addmm", _addmm)
    put("baddbmm", _baddbmm)
    return out


def step_flop_counts(fn: Callable[[], Any]) -> Optional[Dict[str, int]]:
    """One call of ``fn`` (a training step) counted by the rules of the
    module docstring: ``{op name: flops}``, the blocks :func:`counted`
    hides under ``"counted"``. None when ``fn`` raised."""
    try:
        from torch.utils.flop_counter import FlopCounterMode

        from analytics_zoo_tpu_torch.ops import flash_attention as fa
        total = [0]
        with _count_lock:
            _counting.append(total)
        try:
            with fa.counting_flops() as formulas:
                mapping = {**step_formulas(), **formulas}
                with FlopCounterMode(display=False,
                                     custom_mapping=mapping) as mode:
                    fn()
        finally:
            with _count_lock:
                _counting.remove(total)
        counts = {str(op): int(n) for op, n in  # zoolint: disable=hotpath-host-sync (host flop counts)
                  mode.get_flop_counts().get("Global", {}).items() if n}
        if total[0]:
            counts["counted"] = total[0]
        return counts
    except Exception:
        return None


def step_flops(fn: Callable[[], Any]) -> Optional[float]:
    """The flops of one call of ``fn`` (a training step: forward,
    backward and the update) as :func:`step_flop_counts` counts them.
    None when nothing was counted or ``fn`` raised. The caller keeps
    ``fn`` free of side effects on its state."""
    counts = step_flop_counts(fn)
    return float(sum(counts.values())) or None if counts else None


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
                stamp = int(time.time())   # zoolint: disable=wallclock-hotpath (dump filename)
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
