"""InferenceModel — thread-safe model inference on one device.

Counterpart of ``analytics_zoo_tpu/inference/inference_model.py``
(ref InferenceModel.scala:28-62). A loaded model is a private copy of the
zoo model's module on this model's device (``cuda`` unless the caller
passes ``device="cpu"``), shared by all callers; a semaphore bounds
in-flight predicts at ``concurrent_num``, the reference's backpressure.

- ``load_zoo(model)`` / ``load(path)`` — a zoo keras model or ZooModel
- ``load_torch(module, sample_input)`` — any ``nn.Module`` of the port
  (e.g. the BERT classifier of ``text/estimators.py``)
- ``predict`` — chunked batch predict; with a bucket ladder the tail
  chunk pads to its nearest rung
- ``predict_async`` / ``predict_fetch`` — the serving engine's staged
  dispatch: launch one batch on the device, fetch its host result later

There is no CPU failover: a model on ``cuda`` runs there or raises.
Quantization, sharding and decode wait for later slices.
"""

from __future__ import annotations

import collections
import copy
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from analytics_zoo_tpu_torch.common import compile_ahead
from analytics_zoo_tpu_torch.common.device import (DeviceLike, as_tensor,
                                                   resolve_device, to_numpy)


def _as_tuple(x):
    return tuple(x) if isinstance(x, (list, tuple)) else (x,)


class InferenceModel:
    """Thread-safe inference holder for one model on one device."""

    def __init__(self, concurrent_num: int = 1, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.concurrent_num = int(concurrent_num)
        self._sem = threading.Semaphore(self.concurrent_num)
        self._lock = threading.Lock()
        self._module: Optional[torch.nn.Module] = None
        self._n_inputs = 1
        self._ladder: Optional[compile_ahead.BucketLadder] = None

    # ------------------------------------------------------------- loaders
    def load_zoo(self, model) -> "InferenceModel":
        """Load a zoo keras model (KerasNet) or ZooModel instance
        (ref doLoadBigDL, InferenceModel.scala:96). The model's module is
        copied, so later changes to ``model`` do not reach this one."""
        from analytics_zoo_tpu_torch.keras.models import KerasNet

        net = model.model if isinstance(getattr(model, "model", None),
                                        KerasNet) else model
        module = copy.deepcopy(net.module).to(self.device).eval()
        with self._lock:
            self._module = module
            self._n_inputs = len(module.graph_inputs)
        return self

    def load(self, path: str) -> "InferenceModel":
        """Load a saved ZooModel directory (ref doLoadBigDL from file)."""
        from analytics_zoo_tpu_torch.models.common import ZooModel
        return self.load_zoo(ZooModel.load_model(path))

    def load_torch(self, module: torch.nn.Module, sample_input
                   ) -> "InferenceModel":
        """Load a PyTorch module of the port (ref doLoadPyTorch,
        InferenceModel.scala:249; the counterpart of the JAX package's
        ``load_flax``). ``sample_input`` (an array or a tuple of arrays)
        fixes how many inputs ``predict`` feeds the module. The module is
        copied, so later changes to it do not reach this model."""
        copy_ = copy.deepcopy(module).to(self.device).eval()
        with self._lock:
            self._module = copy_
            self._n_inputs = len(_as_tuple(sample_input))
        return self

    def set_ladder(self, ladder, max_batch_size: Optional[int] = None
                   ) -> "InferenceModel":
        """Attach a batch-bucket ladder: ``predict`` pads each tail chunk
        to the nearest rung instead of the full batch size. Pass a
        :class:`~analytics_zoo_tpu_torch.common.compile_ahead.BucketLadder`
        or ``(min_batch_size, max_batch_size)`` ints."""
        if not isinstance(ladder, compile_ahead.BucketLadder):
            ladder = compile_ahead.BucketLadder(int(ladder), max_batch_size)
        with self._lock:
            self._ladder = ladder
        return self

    # ------------------------------------------------------------- predict
    def _snapshot(self):
        with self._lock:
            # one consistent snapshot: a concurrent load_* can't mix model
            # versions across chunks
            if self._module is None:
                raise RuntimeError("no model loaded")
            return self._module, self._n_inputs, self._ladder

    @staticmethod
    def _coerce(x, n_inputs) -> Tuple[np.ndarray, ...]:
        xs = _as_tuple(x)
        if len(xs) != n_inputs:
            if n_inputs == 1:
                xs = (np.asarray(x),)
            else:
                raise ValueError(
                    f"model takes {n_inputs} inputs, got {len(xs)}")
        return tuple(np.asarray(a) for a in xs)

    def _chunks(self, x, n_inputs, batch_size, ladder=None):
        """Split one logical batch into chunks, padding the tail: yields
        ``(chunk_tuple, n_valid)``. With a bucket ladder attached the tail
        pads to its nearest rung instead of the full chunk size."""
        xs = self._coerce(x, n_inputs)
        n = xs[0].shape[0]
        if n == 0:
            raise ValueError("predict called on an empty batch")
        bs = int(batch_size) if batch_size else \
            (ladder.rung_for(n) if ladder is not None else n)
        for lo in range(0, n, bs):
            hi = min(lo + bs, n)
            chunk = tuple(a[lo:hi] for a in xs)
            valid = hi - lo
            rung = bs if ladder is None else \
                min(bs, ladder.rung_for(valid))
            yield compile_ahead.pad_to_rung(chunk, rung), valid

    def _forward(self, module, xs):
        with torch.inference_mode():
            return module(*(as_tensor(a, self.device) for a in xs))

    def predict(self, x, batch_size: Optional[int] = None,
                pipeline_window: int = 2) -> np.ndarray:
        """Batch predict. ``x``: ndarray, tuple of ndarrays (multi-input),
        or an iterator of such batches. Up to ``pipeline_window`` chunks
        are in flight on the device: chunk N+1 is padded and launched
        before chunk N's result is copied back. Thread-safe; at most
        ``concurrent_num`` predicts run at once."""
        module, n_inputs, ladder = self._snapshot()

        def chunks():
            if hasattr(x, "__next__"):       # stream of batches
                for b in x:
                    yield from self._chunks(b, n_inputs, batch_size, ladder)
            else:
                yield from self._chunks(x, n_inputs, batch_size, ladder)

        outs = []
        window = max(1, int(pipeline_window))
        with self._sem:
            inflight: collections.deque = collections.deque()
            for chunk, valid in chunks():
                inflight.append((self._forward(module, chunk), valid))
                if len(inflight) >= window:
                    out, v = inflight.popleft()
                    outs.append(_head(to_numpy(out), v))
            while inflight:
                out, v = inflight.popleft()
                outs.append(_head(to_numpy(out), v))
        if not outs:
            raise ValueError("predict called on an empty batch")
        if isinstance(outs[0], tuple):
            return tuple(np.concatenate(parts) for parts in zip(*outs))
        return np.concatenate(outs)

    def predict_async(self, x):
        """Launch ONE already-batched input (ndarray or multi-input tuple)
        without waiting for the device. Returns an opaque pending value;
        pass it to ``predict_fetch`` for the host result. The caller owns
        batching and padding and bounds its in-flight work, so the
        ``concurrent_num`` semaphore is not taken here."""
        module, n_inputs, _ = self._snapshot()
        return self._forward(module, self._coerce(x, n_inputs))

    def predict_fetch(self, pending):
        """Blocking host side of ``predict_async``."""
        return to_numpy(pending)

    def predict_classes(self, x, batch_size: Optional[int] = None,
                        zero_based_label: bool = True) -> np.ndarray:
        probs = np.asarray(self.predict(x, batch_size))
        classes = np.argmax(probs, axis=-1)
        return classes if zero_based_label else classes + 1

    # java-flavoured aliases (ref AbstractInferenceModel.java)
    do_predict = predict
    do_load = load


def _head(out, n: int):
    """The first ``n`` rows of an output or of each output of a tuple."""
    if isinstance(out, tuple):
        return tuple(o[:n] for o in out)
    return out[:n]
