"""Batch-bucket ladder, tail padding and the warm-up threads' exit drain.

Counterpart of ``analytics_zoo_tpu/common/compile_ahead.py``
(``BucketLadder``, ``pad_to_rung`` with its ``zoo_bucket_pad_fraction``
histogram, ``register_warmup_thread`` / ``draining``), without the XLA
executable cache and the persistent compile cache: PyTorch compiles
nothing ahead. Batches pad up to a small set of sizes so every request
shape reuses one of a few kernel configurations; ``InferenceModel.
warm_up`` runs each rung once on a background thread (kernel builds,
cuBLAS's algorithm choice, the caching allocator's growth) before the
first real request lands on it.
"""

from __future__ import annotations

import atexit
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

from analytics_zoo_tpu_torch.common import telemetry

__all__ = ["BucketLadder", "pad_to_rung", "register_warmup_thread",
           "draining"]

#: pad fraction is bounded [0, 1): the latency buckets make no sense here
_PAD_BUCKETS = (0.0, 0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.625, 0.75, 0.875,
                1.0)

# Warm-up threads are daemons so they never hold a healthy exit, but one
# killed inside a CUDA call (or an nvcc build) can take the process down
# at interpreter teardown. The atexit drain tells the remaining rungs to
# stop and joins the one in flight, so a short-lived process exits
# cleanly even while a ladder is still warming.
_warm_threads_lock = threading.Lock()
_warm_threads: List[threading.Thread] = []
_draining = threading.Event()


def draining() -> bool:
    """True once interpreter shutdown began — warm-up workers poll this
    between rungs and skip the rest."""
    return _draining.is_set()


def register_warmup_thread(thread: threading.Thread) -> None:
    """Track a background warm-up thread so process exit joins it instead
    of killing it inside a forward."""
    with _warm_threads_lock:
        _warm_threads[:] = [t for t in _warm_threads if t.is_alive()]
        _warm_threads.append(thread)


def _drain_warmup_threads() -> None:
    _draining.set()
    with _warm_threads_lock:
        threads = list(_warm_threads)
    for t in threads:
        t.join()


atexit.register(_drain_warmup_threads)


class BucketLadder:
    """Power-of-two batch buckets between ``min_batch_size`` and
    ``max_batch_size`` (inclusive; the top rung clamps to the max when the
    doubling overshoots)."""

    def __init__(self, min_batch_size: int,
                 max_batch_size: Optional[int] = None):
        mn = int(min_batch_size)
        mx = int(max_batch_size) if max_batch_size else mn
        if mn < 1:
            raise ValueError(f"min_batch_size must be >= 1, got {mn}")
        if mx < mn:
            raise ValueError(
                f"max_batch_size {mx} < min_batch_size {mn}")
        rungs: List[int] = []
        r = mn
        while r < mx:
            rungs.append(r)
            r *= 2
        rungs.append(mx)
        self.rungs: Tuple[int, ...] = tuple(rungs)

    def rung_for(self, n: int) -> int:
        """Smallest rung that fits ``n`` records (the top rung for
        anything larger)."""
        for r in self.rungs:
            if n <= r:
                return r
        return self.rungs[-1]

    def up(self, rung: int) -> int:
        """The next larger rung (itself at the top)."""
        for r in self.rungs:
            if r > rung:
                return r
        return self.rungs[-1]

    def down(self, rung: int) -> int:
        """The next smaller rung (itself at the bottom)."""
        below = [r for r in self.rungs if r < rung]
        return below[-1] if below else self.rungs[0]

    def __repr__(self) -> str:
        return f"BucketLadder{self.rungs}"


def _pad_hist(site: str):
    return telemetry.get_registry().histogram(
        "zoo_bucket_pad_fraction",
        "Fraction of each dispatched bucket that is tail padding",
        ("site",), buckets=_PAD_BUCKETS).labels(site)


def pad_to_rung(arrays: Sequence[np.ndarray], rung: int,
                site: str = "inference") -> Tuple[np.ndarray, ...]:
    """Pad every array of one logical batch up to ``rung`` rows by
    repeating the last row (the caller masks the tail off the output).
    Records the padded fraction on ``zoo_bucket_pad_fraction{site=}`` for
    every call — a full batch observes 0, so the histogram's mean is the
    real pad-waste rate."""
    arrays = tuple(arrays)
    n = int(arrays[0].shape[0])
    rung = int(rung)
    if n > rung:
        raise ValueError(f"batch of {n} does not fit rung {rung}")
    _pad_hist(site).observe((rung - n) / float(rung))
    if n == rung:
        return arrays
    return tuple(
        np.concatenate([a, np.repeat(a[-1:], rung - n, axis=0)])
        for a in arrays)
