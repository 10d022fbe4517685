"""Telemetry — the process-wide metrics registry and span tracing.

The port's own copy of ``analytics_zoo_tpu/common/telemetry.py``:

- **MetricsRegistry** — thread-safe counters, gauges and histograms
  (fixed Prometheus buckets + a bounded quantile reservoir), the
  Prometheus 0.0.4 text exposition (``prometheus_text``), a JSON-able
  ``snapshot()`` and the snapshot algebra (``merge_snapshot``,
  ``from_snapshot``) that federates replicas.
- **Tracer** — span-based tracing with contextvar propagation and a
  bounded per-trace-id span store. A serving record's uri is its trace
  id: the engine's dequeue/preprocess/dispatch/device/postprocess stages
  record spans against it.
- ``observe_device_block`` — the host time blocked on device results.
- the four device hooks, JAX's counters and labels: ``instrument_jit``
  (calls and "recompiles": a call whose signature (tree structure,
  shapes, dtypes, devices, the values of plain Python arguments) the
  wrapper has not seen, which is what a ``jax.jit`` cache miss is),
  ``traced_device_put`` / ``traced_device_get`` (``.to(device)`` /
  ``.cpu()`` over a tree, with the bytes moved) and
  ``timed_block_until_ready`` (``torch.cuda.synchronize`` on the
  tensors' devices, timed).
- ``dump_trace`` — the span store as Chrome Trace Event JSON
  (common/profiling.py).

Metric names and label sets are the JAX package's letter for letter, so
one dashboard reads either package. Stdlib only.
"""

from __future__ import annotations

import contextvars
import math
import os
import threading
from collections import OrderedDict
from contextlib import contextmanager
from dataclasses import dataclass
from time import monotonic, perf_counter
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "Span", "Tracer",
    "get_registry", "get_tracer", "prometheus_text", "snapshot",
    "observe_device_block", "set_trace_sampling", "dump_trace",
    "reset_for_tests", "instrument_jit", "traced_device_put",
    "traced_device_get", "timed_block_until_ready",
]

# latency-shaped default buckets (seconds): 100µs .. 30s
DEFAULT_BUCKETS = (1e-4, 5e-4, 1e-3, 5e-3, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0)
RESERVOIR_SIZE = 1024
#: how many reservoir samples ride a JSON snapshot per histogram series —
#: enough for stable p50/p99 on the merged side, small enough that a
#: snapshot stays a one-line payload (fleet scrapes and BENCH records
#: both carry it)
SNAPSHOT_RESERVOIR = 256

_NAME_OK = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_:")


def _check_name(name: str) -> str:
    if not name or name[0].isdigit() or not set(name) <= _NAME_OK:
        raise ValueError(f"bad metric name {name!r}")
    return name


def _escape_label(v: str) -> str:
    return str(v).replace("\\", r"\\").replace("\n", r"\n").replace(
        '"', r"\"")


def _fmt_value(v: float) -> str:
    if v != v:
        return "NaN"
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _label_str(labelnames: Sequence[str], labelvalues: Sequence[str]) -> str:
    if not labelnames:
        return ""
    pairs = ",".join(f'{k}="{_escape_label(v)}"'
                     for k, v in zip(labelnames, labelvalues))
    return "{" + pairs + "}"


class _Child:
    """One (metric, label-values) time series."""

    def __init__(self, labelvalues: Tuple[str, ...]):
        self._lock = threading.Lock()
        self.labelvalues = labelvalues


class Counter(_Child):
    def __init__(self, labelvalues=()):
        super().__init__(labelvalues)
        self._value = 0.0

    def inc(self, amount: float = 1.0):
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge(_Child):
    def __init__(self, labelvalues=()):
        super().__init__(labelvalues)
        self._value = 0.0

    def set(self, v: float):
        with self._lock:
            self._value = float(v)

    def inc(self, amount: float = 1.0):
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0):
        self.inc(-amount)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram(_Child):
    """Counts into fixed buckets + a bounded reservoir for quantiles.

    The reservoir keeps the first ``RESERVOIR_SIZE`` samples then switches
    to uniform replacement (algorithm R) with a cheap deterministic LCG —
    no ``random`` module state touched, bounded memory forever.

    ``observe(v, exemplar=trace_id)`` additionally parks the trace id in
    the observed value's bucket — one slot per bucket (latest wins), so
    exemplar memory is bounded by the bucket count. Exposed in the
    Prometheus exposition (OpenMetrics ``# {trace_id="..."} v`` suffix)
    and in ``/query`` results, linking a windowed p99 spike to the
    ``/trace`` span tree that caused it. Callers pass an exemplar only
    for trace-sampled requests (``Tracer.should_sample``), so the id is
    resolvable while the trace store holds it."""

    def __init__(self, labelvalues=(), buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(labelvalues)
        self.buckets = tuple(sorted(buckets))
        self._bucket_counts = [0] * (len(self.buckets) + 1)  # +Inf last
        self._count = 0
        self._sum = 0.0
        self._reservoir: List[float] = []
        self._rng = 0x9E3779B9
        # bucket index -> (trace_id, observed value, monotonic timestamp)
        self._exemplars: Dict[int, Tuple[str, float, float]] = {}

    def observe(self, v: float, exemplar: Optional[str] = None):
        v = float(v)
        with self._lock:
            self._count += 1
            self._sum += v
            i = 0
            for b in self.buckets:
                if v <= b:
                    break
                i += 1
            self._bucket_counts[i] += 1
            if exemplar is not None:
                self._exemplars[i] = (str(exemplar), v, monotonic())
            if len(self._reservoir) < RESERVOIR_SIZE:
                self._reservoir.append(v)
            else:
                # LCG step (Numerical Recipes constants), then mod count
                self._rng = (self._rng * 1664525 + 1013904223) & 0xFFFFFFFF
                j = self._rng % self._count
                if j < RESERVOIR_SIZE:
                    self._reservoir[j] = v

    def quantile(self, q: float) -> float:
        with self._lock:
            if not self._reservoir:
                return float("nan")
            xs = sorted(self._reservoir)
        idx = min(len(xs) - 1, max(0, int(math.ceil(q * len(xs))) - 1))
        return xs[idx]

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def _state(self):
        with self._lock:
            return (list(self._bucket_counts), self._count, self._sum,
                    list(self._reservoir))

    def _exemplar_state(self) -> Dict[int, Tuple[str, float, float]]:
        with self._lock:
            return dict(self._exemplars)


class _Family:
    """A named metric plus its per-label-values children."""

    def __init__(self, name: str, kind: str, help_: str,
                 labelnames: Tuple[str, ...], **kwargs):
        self.name = _check_name(name)
        self.kind = kind
        self.help = help_
        self.labelnames = labelnames
        self._kwargs = kwargs
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], _Child] = {}
        self._cls = {"counter": Counter, "gauge": Gauge,
                     "histogram": Histogram}[kind]

    def labels(self, *labelvalues, **labelkw):
        if labelkw:
            if labelvalues:
                raise ValueError("pass labels positionally or by name")
            labelvalues = tuple(labelkw[k] for k in self.labelnames)
        vals = tuple(str(v) for v in labelvalues)
        if len(vals) != len(self.labelnames):
            raise ValueError(
                f"{self.name} takes labels {self.labelnames}, got {vals}")
        with self._lock:
            child = self._children.get(vals)
            if child is None:
                child = self._cls(vals, **self._kwargs)
                self._children[vals] = child
            return child

    def children(self) -> List[_Child]:
        with self._lock:
            return list(self._children.values())

    # unlabelled convenience: family acts as its own single child
    def _default(self):
        return self.labels()

    def inc(self, amount: float = 1.0):
        self._default().inc(amount)

    def dec(self, amount: float = 1.0):
        self._default().dec(amount)

    def set(self, v: float):
        self._default().set(v)

    def observe(self, v: float, exemplar: Optional[str] = None):
        self._default().observe(v, exemplar)

    @property
    def value(self):
        return self._default().value

    @property
    def count(self):
        return self._default().count

    def quantile(self, q: float):
        return self._default().quantile(q)


# ------------------------------------------------- snapshot merge algebra

def _subsample_sorted(xs: List[float], cap: int) -> List[float]:
    """Deterministic even-stride subsample of an already-sorted list —
    keeps the quantile structure (min/max always survive) with no RNG."""
    n = len(xs)
    if n <= cap:
        return list(xs)
    # spread cap picks over [0, n-1] inclusive of both ends
    return [xs[(i * (n - 1)) // (cap - 1)] for i in range(cap)]


def _is_hist_entry(v: Any) -> bool:
    return isinstance(v, dict) and "count" in v and "le" in v


def _copy_entry(v: Any) -> Any:
    if isinstance(v, dict):
        return {k: list(x) if isinstance(x, (list, tuple)) else x
                for k, x in v.items()}
    return v


def _copy_snapshot(snap: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for name, val in snap.items():
        if isinstance(val, dict) and not _is_hist_entry(val):
            out[name] = {k: _copy_entry(v) for k, v in val.items()}
        else:
            out[name] = _copy_entry(val)
    return out


def _parse_label_key(key: str) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    """Invert snapshot()'s ``k=v,k2=v2`` label-key encoding."""
    if not key:
        return (), ()
    names, values = [], []
    for pair in key.split(","):
        k, _, v = pair.partition("=")
        names.append(k)
        values.append(v)
    return tuple(names), tuple(values)


def _bucket_quantile(le: Sequence[float], bucket_counts: Sequence[int],
                     q: float, hi: Optional[float] = None) -> Optional[float]:
    """Quantile from per-bucket counts: the upper edge of the bucket the
    q-th observation falls in — within one bucket width of the true
    stream quantile by construction (what the merge-algebra test pins).
    ``hi`` caps the +Inf bucket (largest reservoir sample when known)."""
    total = sum(bucket_counts)
    if total <= 0:
        return None
    rank = max(1, int(math.ceil(q * total)))
    cum = 0
    for i, c in enumerate(bucket_counts):
        cum += c
        if cum >= rank:
            if i < len(le):
                return float(le[i])
            return float(hi) if hi is not None else float(le[-1])
    return float(hi) if hi is not None else float(le[-1])


def _merge_hist_entry(name: str, a: Dict[str, Any],
                      b: Dict[str, Any]) -> Dict[str, Any]:
    if list(a["le"]) != list(b["le"]):
        raise ValueError(
            f"histogram {name!r}: bucket edges differ, cannot merge")
    counts = [int(x) + int(y)
              for x, y in zip(a["bucket_counts"], b["bucket_counts"])]
    total = int(a["count"]) + int(b["count"])
    s = float(a["sum"]) + float(b["sum"])
    res = sorted(list(a.get("reservoir", ())) + list(b.get("reservoir", ())))
    hi = res[-1] if res else None
    return {"count": total, "sum": s,
            "mean": s / total if total else 0.0,
            "p50": _bucket_quantile(a["le"], counts, 0.5, hi),
            "p99": _bucket_quantile(a["le"], counts, 0.99, hi),
            "le": list(a["le"]), "bucket_counts": counts,
            "reservoir": _subsample_sorted(res, SNAPSHOT_RESERVOIR)}


#: Gauges describing a physical resource owned by ONE process — a mesh
#: shard's resident parameter bytes, the decode cache's current rung.
#: Two replicas of the same sharded model both report
#: ``zoo_shard_hbm_bytes{shard=0}``; summing those series across the
#: fleet would fabricate a device holding 2x the real bytes, so the
#: fleet merge takes the max instead (the fleet view answers "how big is
#: the biggest shard", never a total).
NON_ADDITIVE_GAUGES = frozenset({
    "zoo_shard_hbm_bytes",
    "zoo_kv_cache_rung",
})


def _merge_scalar(name: str, a, b):
    if name in NON_ADDITIVE_GAUGES:
        return max(a, b)
    return a + b


def _merge_family(name: str, a: Any, b: Any) -> Any:
    if isinstance(a, (int, float)) and isinstance(b, (int, float)):
        return _merge_scalar(name, a, b)
    if _is_hist_entry(a) and _is_hist_entry(b):
        return _merge_hist_entry(name, a, b)
    if isinstance(a, dict) and isinstance(b, dict) \
            and not _is_hist_entry(a) and not _is_hist_entry(b):
        out = {k: _copy_entry(v) for k, v in a.items()}
        for k, v in b.items():
            if k not in out:
                out[k] = _copy_entry(v)
            elif _is_hist_entry(out[k]) and _is_hist_entry(v):
                out[k] = _merge_hist_entry(name, out[k], v)
            elif isinstance(out[k], (int, float)) \
                    and isinstance(v, (int, float)):
                out[k] = _merge_scalar(name, out[k], v)
            else:
                raise ValueError(
                    f"series {name}{{{k}}}: incompatible snapshot shapes")
        return out
    raise ValueError(f"family {name!r}: incompatible snapshot shapes")


class MetricsRegistry:
    """Thread-safe registry of metric families. ``counter``/``gauge``/
    ``histogram`` are get-or-create (idempotent for a matching kind, error
    on a kind clash), so any module can grab its series without import-
    order coupling."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: "OrderedDict[str, _Family]" = OrderedDict()

    def _get(self, name: str, kind: str, help_: str,
             labelnames: Iterable[str], **kwargs) -> _Family:
        labelnames = tuple(labelnames)
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.labelnames != labelnames:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind}{fam.labelnames}, not "
                        f"{kind}{labelnames}")
                return fam
            fam = _Family(name, kind, help_, labelnames, **kwargs)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labelnames: Iterable[str] = ()) -> _Family:
        return self._get(name, "counter", help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Iterable[str] = ()) -> _Family:
        return self._get(name, "gauge", help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Iterable[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> _Family:
        return self._get(name, "histogram", help, labelnames,
                         buckets=buckets)

    def families(self) -> List[_Family]:
        with self._lock:
            return list(self._families.values())

    # -------------------------------------------------------- exposition
    def prometheus_text(self) -> str:
        """Prometheus text exposition format 0.0.4 — one HELP/TYPE block
        per family, histogram children as cumulative ``le`` buckets plus
        ``_sum``/``_count``."""
        lines: List[str] = []
        for fam in self.families():
            if fam.help:
                lines.append(f"# HELP {fam.name} {fam.help}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for child in fam.children():
                label_base = list(zip(fam.labelnames, child.labelvalues))
                if fam.kind in ("counter", "gauge"):
                    lines.append(
                        fam.name
                        + _label_str([k for k, _ in label_base],
                                     [v for _, v in label_base])
                        + " " + _fmt_value(child.value))
                else:
                    counts, total, s, _ = child._state()
                    exs = child._exemplar_state()

                    def _ex_suffix(i: int) -> str:
                        ex = exs.get(i)
                        if ex is None:
                            return ""
                        # OpenMetrics exemplar syntax on the bucket line
                        return (f' # {{trace_id="{_escape_label(ex[0])}"}}'
                                f" {_fmt_value(ex[1])}")

                    cum = 0
                    for i, (b, c) in enumerate(zip(child.buckets, counts)):
                        cum += c
                        names = [k for k, _ in label_base] + ["le"]
                        vals = [v for _, v in label_base] + [_fmt_value(b)]
                        lines.append(f"{fam.name}_bucket"
                                     + _label_str(names, vals)
                                     + " " + str(cum) + _ex_suffix(i))
                    names = [k for k, _ in label_base] + ["le"]
                    vals = [v for _, v in label_base] + ["+Inf"]
                    lines.append(f"{fam.name}_bucket"
                                 + _label_str(names, vals) + " " + str(total)
                                 + _ex_suffix(len(child.buckets)))
                    ls = _label_str([k for k, _ in label_base],
                                    [v for _, v in label_base])
                    lines.append(f"{fam.name}_sum{ls} " + _fmt_value(s))
                    lines.append(f"{fam.name}_count{ls} " + str(total))
        return "\n".join(lines) + "\n"

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able view: counters/gauges as values, histograms as
        {count, sum, mean, p50, p99, le, bucket_counts, reservoir} — what
        rides BENCH records and the JSON ``/metrics`` response. ``le`` is
        the bucket upper-edge list and ``bucket_counts`` the per-bucket
        (NOT cumulative) counts with the +Inf bucket last, so two
        snapshots of the same series are mergeable by addition
        (:meth:`merge_snapshot`); ``reservoir`` is a sorted deterministic
        subsample (≤ ``SNAPSHOT_RESERVOIR``) of the quantile reservoir."""
        out: Dict[str, Any] = {}
        for fam in self.families():
            entries = {}
            for child in fam.children():
                key = ",".join(f"{k}={v}" for k, v in
                               zip(fam.labelnames, child.labelvalues)) or ""
                if fam.kind in ("counter", "gauge"):
                    entries[key] = child.value
                else:
                    counts, total, s, res = child._state()
                    mean = s / total if total else 0.0
                    xs = sorted(res)

                    def pq(q):
                        if not xs:
                            return None
                        return xs[min(len(xs) - 1,
                                      max(0, int(math.ceil(q * len(xs))) - 1))]

                    entries[key] = {
                        "count": total, "sum": s, "mean": mean,
                        "p50": pq(0.5), "p99": pq(0.99),
                        "le": list(child.buckets),
                        "bucket_counts": list(counts),
                        "reservoir": _subsample_sorted(
                            xs, SNAPSHOT_RESERVOIR),
                    }
            if list(entries) == [""]:
                out[fam.name] = entries[""]
            elif entries:
                out[fam.name] = entries
        return out

    # ---------------------------------------------------------- federation
    @staticmethod
    def merge_snapshot(base: Dict[str, Any],
                       other: Dict[str, Any]) -> Dict[str, Any]:
        """Fold snapshot ``other`` into snapshot ``base`` and return the
        merged dict (inputs are not mutated). Counters and gauges add
        (summing is the only associative choice for gauges; a fleet-wide
        gauge reads as a total) — except the ``NON_ADDITIVE_GAUGES``
        per-shard resource gauges, whose identically-labeled series from
        different replicas describe the same-sized resource and merge by
        max, never a sum. Histogram series add bucket counts /
        count / sum and take a subsampled union of the reservoirs. Raises
        ``ValueError`` when the same series has incompatible shapes
        (histogram-vs-scalar, differing ``le`` edges) — the fleet scraper
        treats that replica as a failed scrape rather than corrupting the
        aggregate."""
        out = _copy_snapshot(base)
        for name, val in other.items():
            if name not in out:
                out[name] = _copy_snapshot({name: val})[name]
                continue
            out[name] = _merge_family(name, out[name], val)
        return out

    @classmethod
    def from_snapshot(cls, snap: Dict[str, Any]) -> "MetricsRegistry":
        """Rebuild a registry from a (possibly merged) snapshot so the
        aggregate can be re-exposed (``prometheus_text``) or re-snapshot.
        Kinds are inferred: histogram entries carry ``le``/``count``;
        scalars named ``*_total`` are counters, the rest gauges. Label
        keys round-trip through the snapshot's ``k=v,k2=v2`` encoding
        (label VALUES therefore must not contain ``,`` or ``=`` — true
        for every catalog metric). Entries that are not valid metric
        families (e.g. ``trace_ids_held``) are skipped."""
        reg = cls()
        for name, val in snap.items():
            try:
                entries = val if isinstance(val, dict) and \
                    not _is_hist_entry(val) else {"": val}
                for key, entry in entries.items():
                    labelnames, labelvalues = _parse_label_key(key)
                    if _is_hist_entry(entry):
                        fam = reg.histogram(name, labelnames=labelnames,
                                            buckets=entry["le"])
                        child = fam.labels(*labelvalues)
                        with child._lock:
                            child._bucket_counts = [
                                int(c) for c in entry["bucket_counts"]]
                            child._count = int(entry["count"])
                            child._sum = float(entry["sum"])
                            child._reservoir = [
                                float(v) for v in entry.get("reservoir", [])]
                    elif isinstance(entry, (int, float)):
                        kind = reg.counter if name.endswith("_total") \
                            else reg.gauge
                        child = kind(name, labelnames=labelnames).labels(
                            *labelvalues)
                        with child._lock:
                            child._value = float(entry)
            except (ValueError, KeyError, TypeError):
                continue
        return reg


# ----------------------------------------------------------------- tracing

@dataclass(frozen=True)
class Span:
    """One recorded interval on the process-wide ``perf_counter`` clock."""
    name: str
    trace_id: str
    start: float
    end: float
    parent: Optional[str] = None

    @property
    def duration(self) -> float:
        return self.end - self.start


_current_span: "contextvars.ContextVar[Optional[Tuple[str, str]]]" = \
    contextvars.ContextVar("zoo_current_span", default=None)


class Tracer:
    """Bounded in-memory span store keyed by trace id.

    Serving uses the record uri as the trace id, so spans recorded by the
    FrontEnd, the engine, and the DevicePipeline all land on one trace and
    ``get(uri)`` returns the record's full stage decomposition. The store
    holds the most recent ``capacity`` trace ids (LRU on insert)."""

    def __init__(self, capacity: int = 1024, sample: float = 1.0):
        self._lock = threading.Lock()
        self._traces: "OrderedDict[str, List[Span]]" = OrderedDict()
        self.capacity = int(capacity)
        self._sample = float(sample)
        self._acc = 1.0  # first decision samples (rate > 0)
        # record-hooks: called with every Span as it lands (the flight
        # recorder's ring buffer feeds off this). Exceptions are swallowed
        # — an observer must never break the traced hot path.
        self._hooks: List[Any] = []

    # -------------------------------------------------------- sampling
    def set_sampling(self, rate: float):
        with self._lock:
            self._sample = max(0.0, min(1.0, float(rate)))
            self._acc = self._sample and 1.0

    @property
    def sampling(self) -> float:
        return self._sample

    def should_sample(self) -> bool:
        """Deterministic rate limiter (no RNG): accumulate the rate and
        fire whenever the accumulator crosses 1 — exactly ``rate`` of
        calls return True, evenly spread."""
        with self._lock:
            if self._sample <= 0.0:
                return False
            self._acc += self._sample
            if self._acc >= 1.0:
                self._acc -= 1.0
                return True
            return False

    # -------------------------------------------------------- recording
    def add_hook(self, hook) -> None:
        """Register ``hook(span)`` to observe every recorded span. Used by
        the flight recorder's ring buffer; hooks run outside the store
        lock and their exceptions are swallowed."""
        with self._lock:
            if hook not in self._hooks:
                self._hooks.append(hook)

    def remove_hook(self, hook) -> None:
        with self._lock:
            try:
                self._hooks.remove(hook)
            except ValueError:
                pass

    def record(self, trace_id: str, name: str, start: float, end: float,
               parent: Optional[str] = None):
        span = Span(name, trace_id, start, end, parent)
        evicted = 0
        with self._lock:
            spans = self._traces.get(trace_id)
            if spans is None:
                while len(self._traces) >= self.capacity:
                    self._traces.popitem(last=False)
                    evicted += 1
                spans = []
                self._traces[trace_id] = spans
            spans.append(span)
            hooks = tuple(self._hooks)
        if evicted:
            # traces dropped under LRU pressure would otherwise vanish
            # silently and break exemplar->/trace links; counted outside
            # the store lock (registry locks are independent leaves)
            get_registry().counter(
                "zoo_trace_evictions_total",
                "Traces evicted from the bounded span store under LRU "
                "pressure").inc(evicted)
        for hook in hooks:
            try:
                hook(span)
            except Exception:
                pass
        return span

    @contextmanager
    def span(self, name: str, trace_id: Optional[str] = None):
        """Context-propagating span: nested spans inherit the ambient
        trace id and get the enclosing span's name as ``parent``."""
        ambient = _current_span.get()
        if trace_id is None:
            if ambient is None:
                raise ValueError(
                    "span() without trace_id needs an enclosing span")
            trace_id = ambient[0]
        parent = ambient[1] if ambient and ambient[0] == trace_id else None
        token = _current_span.set((trace_id, name))
        t0 = perf_counter()
        try:
            yield
        finally:
            _current_span.reset(token)
            self.record(trace_id, name, t0, perf_counter(), parent)

    def current_trace_id(self) -> Optional[str]:
        cur = _current_span.get()
        return cur[0] if cur else None

    def get(self, trace_id: str) -> List[Span]:
        with self._lock:
            return list(self._traces.get(trace_id, ()))

    def traces(self) -> "OrderedDict[str, List[Span]]":
        """Every held trace, oldest-inserted first — the chrome-trace
        exporter's view of the store."""
        with self._lock:
            return OrderedDict((k, list(v))
                               for k, v in self._traces.items())

    def clear(self):
        with self._lock:
            self._traces.clear()


# ------------------------------------------------------------ process-wide

_REGISTRY = MetricsRegistry()
_TRACER = Tracer(
    capacity=int(os.environ.get("ZOO_TELEMETRY_TRACES", "1024")),
    sample=float(os.environ.get("ZOO_TELEMETRY_SAMPLE", "1.0")))


def get_registry() -> MetricsRegistry:
    return _REGISTRY


def get_tracer() -> Tracer:
    return _TRACER


def prometheus_text() -> str:
    return _REGISTRY.prometheus_text()


def snapshot() -> Dict[str, Any]:
    return _REGISTRY.snapshot()


def set_trace_sampling(rate: float):
    _TRACER.set_sampling(rate)


def dump_trace(path: str, trace_id: Optional[str] = None) -> str:
    """Write the tracer's span store as Chrome Trace Event JSON to
    ``path`` (optionally one ``trace_id``); returns the path. A delegate
    of :func:`profiling.dump_trace`, imported on use so telemetry does not
    depend on the profiling layer."""
    from analytics_zoo_tpu_torch.common import profiling
    return profiling.dump_trace(path, trace_id=trace_id)


def reset_for_tests():
    """Swap in a fresh registry/trace store (same objects, cleared state)
    — test isolation for the process-wide singletons."""
    import sys
    global _REGISTRY
    _REGISTRY = MetricsRegistry()
    _TRACER.clear()
    with _TRACER._lock:
        _TRACER._hooks = []
    _TRACER.set_sampling(
        float(os.environ.get("ZOO_TELEMETRY_SAMPLE", "1.0")))
    for name in ("profiling", "slo", "timeseries", "resilience"):
        mod = sys.modules.get(f"analytics_zoo_tpu_torch.common.{name}")
        if mod is not None:
            mod.reset_for_tests()



def observe_device_block(seconds: float, site: str = ""):
    """Record time the host spent *blocked* on device results at ``site``
    — the device half of the device-vs-host split. The host half is
    whatever wall time the surrounding stage spans carry."""
    get_registry().histogram(
        "zoo_device_block_seconds",
        "Host time blocked in fetch/block_until_ready, by call site",
        ("site",)).labels(site).observe(seconds)


# ------------------------------------------------------------ device hooks

def _flatten(tree, leaves: list) -> Any:
    """The structure of a tree of lists, tuples and dicts (a hashable
    value), its leaves appended to ``leaves``."""
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__,
                tuple(_flatten(v, leaves) for v in tree))
    if isinstance(tree, dict):
        return ("dict", tuple((k, _flatten(tree[k], leaves))
                              for k in sorted(tree, key=repr)))
    leaves.append(tree)
    return "*"


def _map_tree(fn, tree):
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaf_sig(x) -> Tuple:
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is not None and dtype is not None:
        return ("arr", tuple(shape), str(dtype),
                str(getattr(x, "device", "cpu")))
    if isinstance(x, (int, float, bool, str, bytes, type(None))):
        return ("py", type(x).__name__, x)
    return ("other", type(x).__name__)


class _InstrumentedJit:
    """A callable wrapper that counts calls and "cache misses" (JAX's
    ``_InstrumentedJit`` over an eager function).

    The signature (the tree structure plus shape, dtype and device of
    every array leaf and the value of every plain Python leaf) keys a
    local set; a signature never seen before increments
    ``zoo_jit_cache_misses_total{fn=...}``: where JAX would compile, the
    counter moves, so a steady loop leaves it flat and a shape that
    changes every call shows. Signatures are read before the call."""

    def __init__(self, fn, name: str, registry: MetricsRegistry):
        self._fn = fn
        self.name = name
        self._lock = threading.Lock()
        self._signatures: set = set()
        self._calls = registry.counter(
            "zoo_jit_calls_total", "Calls into instrumented jitted "
            "functions", ("fn",)).labels(name)
        self._misses = registry.counter(
            "zoo_jit_cache_misses_total", "JIT cache misses (compiles + "
            "recompiles) per avals signature", ("fn",)).labels(name)

    def signature(self, args, kwargs) -> Tuple:
        leaves: list = []
        treedef = _flatten((args, kwargs), leaves)
        return (treedef, tuple(_leaf_sig(leaf) for leaf in leaves))

    @property
    def cache_misses(self) -> int:
        return int(self._misses.value)

    def __call__(self, *args, **kwargs):
        sig = self.signature(args, kwargs)
        with self._lock:
            new = sig not in self._signatures
            if new:
                self._signatures.add(sig)
        self._calls.inc()
        if new:
            self._misses.inc()
        return self._fn(*args, **kwargs)


def instrument_jit(fn=None, *, name: Optional[str] = None,
                   registry: Optional[MetricsRegistry] = None):
    """JAX's recompile accounting around an eager function. Usable bare
    (``instrument_jit(f)``) or parameterized
    (``instrument_jit(name="train_step")(f)``)."""
    def wrap(f):
        return _InstrumentedJit(
            f, name or getattr(f, "__name__", "jit_fn"),
            registry if registry is not None else get_registry())

    return wrap(fn) if fn is not None else wrap


def _nbytes(leaf) -> int:
    if hasattr(leaf, "element_size"):          # a torch tensor
        return int(leaf.numel() * leaf.element_size())
    return int(getattr(leaf, "nbytes", 0))


def _tree_nbytes(tree) -> int:
    leaves: list = []
    _flatten(tree, leaves)
    return sum(_nbytes(leaf) for leaf in leaves)


def _transfer_counter(direction: str):
    return get_registry().counter(
        "zoo_device_transfer_bytes_total",
        "Bytes explicitly moved across the host-device boundary",
        ("direction",)).labels(direction)


def _transfer_gauge(direction: str):
    return get_registry().gauge(
        "zoo_device_last_transfer_bytes",
        "Size of the most recent explicit host-device transfer",
        ("direction",)).labels(direction)


def traced_device_put(x, device=None):
    """Every array leaf of ``x`` (torch tensors, numpy arrays) as a tensor
    on ``device`` (``.to(device)``), with h2d byte accounting."""
    import numpy as np
    import torch

    def put(leaf):
        if isinstance(leaf, np.ndarray):
            leaf = torch.from_numpy(np.ascontiguousarray(leaf))
        return leaf.to(device) if isinstance(leaf, torch.Tensor) else leaf

    n = _tree_nbytes(x)
    _transfer_counter("h2d").inc(n)
    _transfer_gauge("h2d").set(n)
    return _map_tree(put, x)


def traced_device_get(x):
    """Every tensor leaf of ``x`` on the host (``.cpu()``), with d2h byte
    accounting counted from what was fetched."""
    import torch
    out = _map_tree(lambda leaf: leaf.cpu() if isinstance(
        leaf, torch.Tensor) else leaf, x)
    n = _tree_nbytes(out)
    _transfer_counter("d2h").inc(n)
    _transfer_gauge("d2h").set(n)
    return out


def timed_block_until_ready(x, site: str = ""):
    """Wait for the work behind ``x`` (``torch.cuda.synchronize`` on each
    CUDA device its tensors are on) and record the blocked time under
    ``site``; returns ``x``."""
    import torch
    leaves: list = []
    _flatten(x, leaves)
    devices = {leaf.device for leaf in leaves
               if isinstance(leaf, torch.Tensor) and leaf.is_cuda}
    t0 = perf_counter()
    for dev in devices:
        torch.cuda.synchronize(dev)
    observe_device_block(perf_counter() - t0, site)
    return x
