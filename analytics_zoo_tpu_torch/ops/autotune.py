"""Kernel autotuner: measure, persist, and dispatch by the verdict.

Counterpart of ``analytics_zoo_tpu/ops/autotune.py``, with JAX's records,
keys, knobs and metrics:

- ``Autotuner.tune`` times every candidate against a reference on the
  same chained-dependency harness (each call's input folds in the previous
  output, so the closing fence covers every call); ``tune_thunks`` times
  nullary host thunks end to end (the decode scheduler's step decision).
  The verdict (``kernel``, ``best``, ``best_ms``, ``reference_ms``,
  ``speedup``, ``use_kernel``, ``candidates_ms``, ``errors``,
  ``platform``, ``iters``) persists to one JSON file keyed by kernel,
  platform and shape. ``use_kernel`` is true only when a candidate
  strictly beat the reference.
- A candidate that raises is recorded under ``errors`` off the card, as
  JAX records a Pallas candidate that cannot run off the TPU. On the card
  it is a fault: ``AutotuneFault`` is raised, nothing is persisted, and
  every later dispatch for that key raises it again (``check_fault``), so
  ``use_kernel: false`` there only ever means the kernel ran and lost.
- On the card the clock is CUDA events fenced by ``torch.cuda.synchronize``
  after one call outside the clock; on the CPU it is the host clock.
- The platform tag is the port's own (``torch-cuda-sm90``,
  ``torch-cpu``) and never a JAX platform name, so a JAX process sharing
  the file never hands the port its Pallas verdicts, nor the port JAX its
  CUDA ones. ``record`` re-reads the file under a lock before it merges,
  so the port's writes keep what other processes wrote.

What a verdict may choose on the card (ROADMAP C26): a CUDA tensor never
runs a kernel's plain version. ``dot_product_attention(use_flash=None)``
reads the flash verdict to choose between the flash kernel and the einsum
chain, JAX's own non-flash route; ``DecodeScheduler(paged="auto")`` reads
the paged-step verdict to choose between the paged step (the gather
kernel inside) and the host gather. The lookups', the bag's and the paged
kernels' verdicts (``tune_fused_lookup``, ``tune_bag``,
``tune_paged_gather``, ``tune_paged_attention``) are measurements of the
kernel against its plain version on the card: the public functions launch
the kernel on a CUDA tensor whatever they say. ``auto_flash_attention``
launches the kernel on the card (the verdict can only name the launcher's
one tile per head dim) and ``blockwise_attention`` on the CPU.

A miss where a verdict is read enqueues the shape (``enqueue_tune``) for
the warm-up workers (``InferenceModel.warm_up``, the serving engine's warm
thread), which call ``tune_pending()`` after their rungs; in ``sync`` mode
it tunes on the spot, unless a CUDA graph is being captured.

Env knobs (as in the JAX package):

- ``ZOO_AUTOTUNE``: ``on`` (default: read verdicts, tune misses in the
  background), ``sync`` (tune at the first miss, blocking), ``off`` (read
  nothing, tune nothing: ``use_flash=None`` takes its heuristic and
  ``paged="auto"`` the host gather).
- ``ZOO_AUTOTUNE_CACHE``: the verdict file (default
  ``zoo_tpu_logs/autotune.json``).
- ``ZOO_AUTOTUNE_ITERS``: timed calls per candidate (default 10).
"""

from __future__ import annotations

import fcntl
import json
import logging
import os
import threading
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

logger = logging.getLogger(__name__)

DEFAULT_CACHE_PATH = os.path.join("zoo_tpu_logs", "autotune.json")

_lock = threading.RLock()
_tuner: Optional["Autotuner"] = None
_pending: "Dict[str, Callable[[], dict]]" = {}
_faults: Dict[str, str] = {}


class AutotuneFault(RuntimeError):
    """A kernel candidate raised while being measured on the card: a
    kernel that did not build or launch, never a verdict."""


def _mode() -> str:
    v = os.environ.get("ZOO_AUTOTUNE", "on").strip().lower()
    return v if v in ("on", "sync", "off") else "on"


def _iters() -> int:
    try:
        return max(1, int(os.environ.get("ZOO_AUTOTUNE_ITERS", "10")))
    except ValueError:
        return 10


def _platform() -> str:
    """``torch-cuda-sm<major><minor>`` of device 0 with a card, else
    ``torch-cpu``: never one of JAX's platform names."""
    if torch.cuda.is_available():
        major, minor = torch.cuda.get_device_capability(0)
        return f"torch-cuda-sm{major}{minor}"
    return "torch-cpu"


def kernels_available() -> bool:
    """Whether the port's kernels can run here: only on a card."""
    return torch.cuda.is_available()


def check_fault(key: str) -> None:
    """Raise the ``AutotuneFault`` a measurement of ``key`` met in this
    process, if any (the dispatch calls it before reading a verdict)."""
    with _lock:
        fault = _faults.get(key)
    if fault is not None:
        raise AutotuneFault(fault)


def use_kernel(rec: dict) -> bool:
    """The route a verdict picks. A record of the card with errors (a
    file written by hand or by an older build) is a fault, not a route."""
    if rec.get("errors") and str(rec.get("platform", "")).startswith(
            "torch-cuda"):
        raise AutotuneFault(f"the verdict for {rec.get('kernel')} records "
                            f"failed candidates: {rec['errors']}")
    return bool(rec.get("use_kernel"))


def dtype_name(dtype) -> str:
    """``jnp.dtype(dtype).name`` for a torch or numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).rsplit(".", 1)[-1]
    return np.dtype(dtype).name


def _metrics() -> dict:
    from analytics_zoo_tpu_torch.common import telemetry
    reg = telemetry.get_registry()
    return {
        "runs": reg.counter(
            "zoo_autotune_runs_total",
            "Completed tuning measurements (one per kernel+shape key)",
            ("kernel",)),
        "hits": reg.counter(
            "zoo_autotune_cache_hits_total",
            "Dispatch decisions served from the persisted verdict cache",
            ("kernel",)),
        "fallbacks": reg.counter(
            "zoo_autotune_fallbacks_total",
            "Tuning verdicts where the reference beat every candidate",
            ("kernel",)),
        "best_ms": reg.gauge(
            "zoo_autotune_best_ms",
            "Best per-call time of the last tuning measurement",
            ("kernel",)),
        "speedup": reg.gauge(
            "zoo_autotune_speedup",
            "reference_ms / best candidate_ms of the last tuning "
            "measurement (< 1.0 means the verdict fell back)",
            ("kernel",)),
        "pending": reg.gauge(
            "zoo_autotune_pending",
            "Tuning requests queued for the background warmup worker"),
    }


def _read_file(path: str) -> Dict[str, dict]:
    try:
        with open(path) as f:
            return {k: v for k, v in json.load(f).items()
                    if isinstance(v, dict)}
    except (OSError, ValueError, AttributeError):
        return {}


def _device_of(args) -> Optional[torch.device]:
    """The device of the first tensor in ``args`` (nested tuples and lists
    searched), or None."""
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
        if isinstance(a, (tuple, list)):
            dev = _device_of(a)
            if dev is not None:
                return dev
    return None


class Autotuner:
    """Measure-and-cache harness for kernel choices: one JSON file maps a
    key to its verdict; keys embed the platform. The methods are
    thread-safe (the warm-up workers and the serving thread may race on a
    first use)."""

    def __init__(self, cache_path: Optional[str] = None):
        self._lock = threading.RLock()
        self._path = cache_path or os.environ.get(
            "ZOO_AUTOTUNE_CACHE", "").strip() or DEFAULT_CACHE_PATH
        self._cache: Optional[Dict[str, dict]] = None
        self._m = _metrics()

    @property
    def path(self) -> str:
        return self._path

    # ------------------------------------------------------------ cache
    def _load(self) -> Dict[str, dict]:
        with self._lock:
            if self._cache is None:
                self._cache = _read_file(self._path)
            return self._cache

    def lookup(self, key: str, kernel: str = "") -> Optional[dict]:
        """The verdict for ``key``, or None; a hit counts on
        ``zoo_autotune_cache_hits_total``."""
        rec = self._load().get(key)
        if rec is not None:
            self._m["hits"].labels(kernel=kernel or rec.get(
                "kernel", "?")).inc()
        return rec

    def record(self, key: str, rec: dict) -> None:
        """Persist ``rec`` under ``key``: the file is re-read under a file
        lock and merged, then replaced atomically, so entries other
        processes wrote meanwhile stay. On a read-only file system the
        verdict stays in this process."""
        with self._lock:
            d = os.path.dirname(self._path)
            tmp = f"{self._path}.tmp.{os.getpid()}"
            try:
                if d:
                    os.makedirs(d, exist_ok=True)
                with open(f"{self._path}.lock", "a") as lk:
                    fcntl.flock(lk, fcntl.LOCK_EX)
                    cache = _read_file(self._path)
                    cache[key] = rec
                    with open(tmp, "w") as f:
                        json.dump(cache, f, indent=1, sort_keys=True)
                    os.replace(tmp, self._path)
            except OSError:
                cache = dict(self._load())
                cache[key] = rec
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
            self._cache = cache

    # ----------------------------------------------------------- timing
    @staticmethod
    def _time_candidate(fn, args, iters: int, chain=None) -> float:
        """Mean seconds a call: one call outside the clock, then ``iters``
        calls with ``chain(out, args)`` folding each result into the next
        call's arguments. On the card: CUDA events around the calls,
        fenced by ``torch.cuda.synchronize``; otherwise the host clock."""
        if chain is None:
            chain = lambda out, a: a  # noqa: E731
        args = tuple(args)
        dev = _device_of(args)
        on_card = dev is not None and dev.type == "cuda"
        with torch.inference_mode():
            out = fn(*args)
            if on_card:
                torch.cuda.synchronize(dev)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(iters):
                    out = fn(*args)
                    args = chain(out, args)
                end.record()
                torch.cuda.synchronize(dev)
                return start.elapsed_time(end) / 1e3 / iters
            t0 = time.perf_counter()
            for _ in range(iters):
                out = fn(*args)
                args = chain(out, args)
            return (time.perf_counter() - t0) / iters

    def tune(self, kernel: str, key: str, candidates: Dict[str, Callable],
             reference: Callable, args: Sequence,
             iters: Optional[int] = None, chain=None) -> dict:
        """Time ``reference`` and every candidate on ``args``; persist and
        return the verdict. A candidate that raises is recorded under
        ``errors`` off the card and raises ``AutotuneFault`` on it."""
        iters = iters or _iters()
        ref_s = self._time_candidate(reference, args, iters, chain)
        times: Dict[str, float] = {}
        errors: Dict[str, str] = {}
        for name, fn in candidates.items():
            try:
                times[name] = self._time_candidate(fn, args, iters, chain)
            except Exception as e:
                errors[name] = repr(e)[:160]
        return self._finish(kernel, key, ref_s, times, errors, iters)

    def tune_thunks(self, kernel: str, key: str,
                    candidates: Dict[str, Callable[[], object]],
                    reference: Callable[[], object],
                    iters: Optional[int] = None) -> dict:
        """``tune`` for nullary host thunks that each run one whole step
        and return a host array (the fence): the host clock covers copies,
        Python loops and device work alike. Same verdict, persistence and
        metrics."""
        iters = iters or _iters()

        def timed(fn) -> float:
            fn()                            # first touch outside the clock
            t0 = time.perf_counter()
            out = None
            for _ in range(iters):
                out = fn()
            np.asarray(out)
            return (time.perf_counter() - t0) / iters

        ref_s = timed(reference)
        times: Dict[str, float] = {}
        errors: Dict[str, str] = {}
        for name, fn in candidates.items():
            try:
                times[name] = timed(fn)
            except Exception as e:
                errors[name] = repr(e)[:160]
        return self._finish(kernel, key, ref_s, times, errors, iters)

    def _finish(self, kernel: str, key: str, ref_s: float,
                times: Dict[str, float], errors: Dict[str, str],
                iters: int) -> dict:
        platform = _platform()
        if errors and platform.startswith("torch-cuda"):
            fault = (f"{kernel} at {key}: candidates raised on the card "
                     f"(a kernel that did not build or launch): {errors}")
            with _lock:
                _faults[key] = fault
            raise AutotuneFault(fault)
        best = min(times, key=times.get) if times else None
        best_s = times[best] if best else float("inf")
        rec = {
            "kernel": kernel,
            "best": best,
            "best_ms": round(best_s * 1e3, 4) if best else None,
            "reference_ms": round(ref_s * 1e3, 4),
            "speedup": round(ref_s / best_s, 4) if best else None,
            "use_kernel": bool(best and best_s < ref_s),
            "candidates_ms": {n: round(s * 1e3, 4)
                              for n, s in sorted(times.items())},
            "errors": errors,
            "platform": platform,
            "iters": iters,
        }
        self.record(key, rec)
        self._m["runs"].labels(kernel=kernel).inc()
        if best:
            self._m["best_ms"].labels(kernel=kernel).set(rec["best_ms"])
            self._m["speedup"].labels(kernel=kernel).set(rec["speedup"])
        if not rec["use_kernel"]:
            self._m["fallbacks"].labels(kernel=kernel).inc()
        return rec


def get_tuner() -> Autotuner:
    global _tuner
    with _lock:
        if _tuner is None:
            _tuner = Autotuner()
        return _tuner


def reset_tuner() -> None:
    """Drop the process-wide tuner and the faults it met: the next
    ``get_tuner()`` reads ``ZOO_AUTOTUNE_CACHE`` and the file afresh."""
    global _tuner
    with _lock:
        _tuner = None
        _faults.clear()


# ------------------------------------------------------- background queue

def enqueue_tune(key: str, thunk: Callable[[], dict]) -> None:
    """Queue a tuning measurement for the warm-up workers, deduped by key;
    a no-op when the key has a verdict or tuning is off."""
    if _mode() == "off" or get_tuner()._load().get(key) is not None:
        return
    with _lock:
        _pending.setdefault(key, thunk)
        _metrics()["pending"].set(len(_pending))


def tune_pending(limit: Optional[int] = None) -> int:
    """Run queued measurements, oldest first (the warm-up workers call it
    after their rungs). A failed one is logged, never raised (a fault on
    the card is raised by the next dispatch of its key instead). Returns
    how many ran."""
    done = 0
    while limit is None or done < limit:
        with _lock:
            if not _pending:
                break
            key, thunk = next(iter(_pending.items()))
            del _pending[key]
            _metrics()["pending"].set(len(_pending))
        try:
            thunk()
        except Exception:
            logger.exception("autotune of %s failed", key)
        done += 1
    return done


def pending_count() -> int:
    with _lock:
        return len(_pending)


def drain_after_warmup() -> int:
    """What a warm-up worker runs after its rungs: the queued measurements
    one at a time until none is left or the process begins to exit
    (``compile_ahead.draining``). Returns how many ran."""
    from analytics_zoo_tpu_torch.common import compile_ahead
    done = 0
    while not compile_ahead.draining() and tune_pending(limit=1):
        done += 1
    return done


def _capturing() -> bool:
    """True while a CUDA graph is being captured on this thread's stream
    (the port's counterpart of JAX's tracer): no measurement may run."""
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


# -------------------------------------------------- flash attention front

def attention_key(b: int, s_q: int, s_k: int, h: int, d: int, dtype,
                  causal: bool) -> str:
    return (f"flash_attention|{_platform()}|b{b}q{s_q}k{s_k}h{h}d{d}"
            f"|{dtype_name(dtype)}|{'causal' if causal else 'full'}")


def tune_attention(b: int, s: int, h: int, d: int,
                   dtype=torch.bfloat16, causal: bool = False,
                   s_k: Optional[int] = None, iters: Optional[int] = None
                   ) -> dict:
    """Time the flash kernel against ``blockwise_attention`` at one shape
    on the card and persist the verdict. The candidate is the one tile the
    launcher offers at the head dim (``flash_attention.kernel_tile``),
    named ``"{bq}x{bk}"``. Off the card the kernel cannot run: its error
    is recorded and the verdict is the reference's."""
    from analytics_zoo_tpu_torch.ops import flash_attention as fa
    s_k = s if s_k is None else s_k
    dev = torch.device("cuda" if kernels_available() else "cpu")
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((b, n, h, d), generator=gen).to(dev, dtype)
               for n in (s, s_k, s_k))
    bq, bk = fa.kernel_tile(d)

    def kernel(q, k, v):
        if q.device.type != "cuda":
            raise RuntimeError("the flash kernel runs only on a card")
        return fa.flash_attention(q, k, v, causal)

    candidates = {f"{bq}x{bk}": kernel}
    reference = lambda q, k, v: fa.blockwise_attention(  # noqa: E731
        q, k, v, causal=causal)
    # the output is a convex combination of v: chained in as the next q it
    # stays bounded
    chain = lambda out, a: (out, a[1], a[2])  # noqa: E731
    return get_tuner().tune(
        "flash_attention", attention_key(b, s, s_k, h, d, dtype, causal),
        candidates, reference, (q, k, v), iters=iters, chain=chain)


def attention_decision(b: int, s_q: int, s_k: int, h: int, d: int, dtype,
                       causal: bool, concrete: bool) -> Optional[dict]:
    """The verdict for the shape, or None. ``concrete``: the caller may
    measure now (not inside a CUDA graph capture); then ``sync`` mode
    tunes on the spot, and otherwise a miss is queued for the warm-up
    workers. A fault met measuring the shape raises."""
    if _mode() == "off" or not kernels_available():
        return None
    key = attention_key(b, s_q, s_k, h, d, dtype, causal)
    check_fault(key)
    rec = get_tuner().lookup(key, "flash_attention")
    if rec is not None:
        return rec
    if _mode() == "sync" and concrete:
        return tune_attention(b, s_q, h, d, dtype, causal=causal, s_k=s_k)
    enqueue_tune(key, lambda: tune_attention(b, s_q, h, d, dtype,
                                             causal=causal, s_k=s_k))
    return None


def auto_flash_attention(q, k, v, causal: bool = False):
    """Verdict-read flash attention: on a CUDA tensor the kernel whatever
    the verdict says (the launcher has one tile per head dim, so a verdict
    has nothing else to choose); on the CPU ``blockwise_attention``, as
    JAX takes off the TPU. A miss is tuned or queued as in
    ``attention_decision``, and a fault met measuring the shape raises."""
    from analytics_zoo_tpu_torch.ops import flash_attention as fa
    if q.device.type != "cuda":
        return fa.blockwise_attention(q, k, v, causal=causal)
    b, s_q, h, d = q.shape
    attention_decision(b, s_q, k.shape[1], h, d, q.dtype, causal,
                       concrete=not _capturing())
    return fa.flash_attention(q, k, v, causal)
