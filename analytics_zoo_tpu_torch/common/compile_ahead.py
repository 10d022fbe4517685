"""Batch-bucket ladder and tail padding.

Counterpart of the ladder in ``analytics_zoo_tpu/common/compile_ahead.py``
(``BucketLadder``, ``pad_to_rung``), without its histograms and ahead-of-
time compilation. Batches pad up to a small set of sizes so every request
shape reuses one of a few kernel configurations.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


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

    def __repr__(self) -> str:
        return f"BucketLadder{self.rungs}"


def pad_to_rung(arrays: Sequence[np.ndarray], rung: int
                ) -> Tuple[np.ndarray, ...]:
    """Pad every array of one logical batch up to ``rung`` rows by
    repeating the last row (the caller masks the tail off the output)."""
    arrays = tuple(arrays)
    n = int(arrays[0].shape[0])
    rung = int(rung)
    if n > rung:
        raise ValueError(f"batch of {n} does not fit rung {rung}")
    if n == rung:
        return arrays
    return tuple(
        np.concatenate([a, np.repeat(a[-1:], rung - n, axis=0)])
        for a in arrays)
