"""Bucketed autoregressive decode — seq-length rungs.

Counterpart of ``analytics_zoo_tpu/inference/generation.py``. The decode
buffer lives in a :class:`BucketedKVCache`, padded to the current
**seq-length rung** of a :class:`~analytics_zoo_tpu_torch.common.
compile_ahead.BucketLadder` and grown rung to rung, so a generation runs
a handful of shapes, not one per step.

Correctness leans on causality: the decoder is a strictly causal scan
over time, so step ``t``'s output depends only on positions ``<= t`` and
rung-padded decode is **bitwise identical** to the exact-length
reference. On the card this also needs every product's shape to be
independent of the rung (keras/layers.py runs the recurrence and
``TimeDistributed`` one time step at a time for that reason).

Generated positions count on the registry's ``zoo_decode_steps_total``
(common/telemetry.py, the JAX package's name); each step records a
``decode_step_<t>`` span (parent ``device``) on every id of
``trace_ids``, as JAX's loop does.
"""

from __future__ import annotations

from time import perf_counter
from typing import Callable, Optional, Sequence

import numpy as np

from analytics_zoo_tpu_torch.common import compile_ahead, telemetry

#: generation modes: ``raw`` feeds the predicted vector straight back
#: (the reference ``Seq2Seq.infer`` semantics); ``greedy`` feeds the
#: one-hot argmax; ``sample`` feeds a one-hot temperature sample.
MODES = ("raw", "greedy", "sample")

#: default seq-length ladder bounds for generate requests
DEFAULT_SEQ_RUNGS = (8, 128)


# metric handles are resolved from the live registry on every write: a
# handle taken at import would go stale when telemetry.reset_for_tests
# swaps the registry
def _m_decode_steps():
    return telemetry.get_registry().counter(
        "zoo_decode_steps_total",
        "Autoregressive decode steps executed (one per generated position "
        "per batch dispatch)")


def decode_steps() -> int:
    """Generated positions so far, over every decode loop and scheduler
    (``zoo_decode_steps_total``)."""
    return int(_m_decode_steps().value)


def seq_ladder(max_seq_len: int,
               min_rung: int = DEFAULT_SEQ_RUNGS[0]
               ) -> compile_ahead.BucketLadder:
    """The seq-length rung ladder for generations up to ``max_seq_len``."""
    lo = max(2, min(int(min_rung), int(max_seq_len)))
    return compile_ahead.BucketLadder(lo, max(lo, int(max_seq_len)))


class BucketedKVCache:
    """The decoder feedback buffer, padded to the live seq-length rung:
    ``view()`` is always ``[batch, rung, dim]`` with zeros past
    :attr:`length`. Without a ladder it is exact-length (the parity
    baseline)."""

    def __init__(self, batch: int, dim: int, ladder=None,
                 start: Optional[np.ndarray] = None,
                 dtype=np.float32):
        self.ladder = ladder
        self.length = 0
        self.dim = int(dim)
        rung = ladder.rung_for(1) if ladder is not None else 1
        self._buf = np.zeros((int(batch), int(rung), self.dim), dtype)
        if start is not None:
            self.append(np.asarray(start, dtype))

    @property
    def rung(self) -> int:
        return int(self._buf.shape[1])

    def append(self, vec: np.ndarray) -> None:
        """Write one position; grow the buffer to the next rung when full
        (re-padded with zeros)."""
        if self.length == self._buf.shape[1]:
            new_rung = (self.ladder.rung_for(self.length + 1)
                        if self.ladder is not None else self.length + 1)
            grown = np.zeros((self._buf.shape[0], new_rung, self.dim),
                             self._buf.dtype)
            grown[:, :self.length, :] = self._buf
            self._buf = grown
        self._buf[:, self.length, :] = vec
        self.length += 1

    def view(self) -> np.ndarray:
        return self._buf


def sample_token_ids(vec: np.ndarray, temperature: float,
                     rng: np.random.Generator) -> np.ndarray:
    """Vectorized Gumbel-max temperature sampling: one token id per row.

    The rng stream contract is exactly ONE uniform draw of ``vec.shape``
    per call (``rng.random(vec.shape)``), as in the JAX package, so the
    same seed gives the same tokens in both."""
    t = max(float(temperature), 1e-6)
    u = rng.random(vec.shape)
    # guard the (measure-zero) u == 0.0 draw; log(-log(u)) must be finite
    u = np.maximum(u, np.finfo(np.float64).tiny)
    gumbel = -np.log(-np.log(u))
    return np.argmax(vec / t + gumbel, axis=-1)


def feedback_rows(vec: np.ndarray, mode: str, temperature: float,
                  rng: Optional[np.random.Generator]) -> np.ndarray:
    """Turn one step's raw prediction rows into the vectors fed back."""
    if mode == "raw":
        return vec
    if mode == "greedy":
        ids = np.argmax(vec, axis=-1)
    else:                                   # sample
        ids = sample_token_ids(vec, temperature, rng)
    out = np.zeros_like(vec)
    out[np.arange(vec.shape[0]), ids] = 1.0
    return out


def count_decode_steps(n: int) -> None:
    """Add ``n`` generated positions to ``zoo_decode_steps_total`` (the
    step scheduler's wide steps account here alongside
    ``decode_loop``)."""
    if n > 0:
        _m_decode_steps().inc(int(n))


def decode_loop(predict_fn: Callable[[np.ndarray, np.ndarray], np.ndarray],
                input_seq: np.ndarray, start_sign: np.ndarray,
                max_new_tokens: int, *, ladder=None, mode: str = "raw",
                temperature: float = 1.0, seed: Optional[int] = None,
                trace_ids: Sequence[str] = ()) -> np.ndarray:
    """Run the autoregressive loop: prefill + ``max_new_tokens`` steps
    through the bucketed cache.

    ``predict_fn(enc, dec) -> [batch, t_dec, dim]`` is the full-sequence
    decoder; step ``t`` reads position ``t-1`` of its output, exactly the
    reference ``infer`` recurrence. ``ladder=None`` runs the exact-length
    unpadded reference (one shape per step). Returns the generated
    ``[batch, max_new_tokens, dim]`` sequence (raw vectors, or one-hot
    rows for greedy/sample). Each step is a ``decode_step_<t>`` span on
    every id of ``trace_ids``."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    input_seq = np.asarray(input_seq)
    start = np.asarray(start_sign, np.float32)
    batch, dim = input_seq.shape[0], start.shape[-1]
    steps = int(max_new_tokens)
    if steps < 1:
        raise ValueError("max_new_tokens must be >= 1")
    rng = np.random.default_rng(seed) if mode == "sample" else None
    tracer = telemetry.get_tracer()

    cache = BucketedKVCache(batch, dim, ladder, start)
    gen = np.zeros((batch, steps, dim), np.float32)
    for t in range(1, steps + 1):
        t0 = perf_counter()
        # the buffer holds positions [0, t) — output t-1 is causal in
        # them, so the rung's zero tail cannot change it
        out = np.asarray(predict_fn(input_seq, cache.view()))
        fed = feedback_rows(out[:, t - 1, :], mode, temperature, rng)
        cache.append(fed)
        gen[:, t - 1, :] = fed
        count_decode_steps(batch)
        t1 = perf_counter()
        for uri in trace_ids:
            tracer.record(uri, f"decode_step_{t}", t0, t1, parent="device")
    return gen
