"""InferenceModel — thread-safe model inference on one device.

Counterpart of ``analytics_zoo_tpu/inference/inference_model.py``
(ref InferenceModel.scala:28-62). A loaded model is a private copy of the
zoo model's module on this model's device (``cuda`` unless the caller
passes ``device="cpu"``), shared by all callers; a semaphore bounds
in-flight predicts at ``concurrent_num``, the reference's backpressure.

- ``load_zoo(model)`` / ``load(path)`` — a zoo keras model or ZooModel
  (``load`` reads a ``save_model`` directory written by either package)
- ``load_torch(torch_module, sample_input)`` — any ``nn.Module`` (the
  BERT classifier of ``text/estimators.py``, or a foreign one, whose
  ``nn.MultiheadAttention``s take the port's attention core where JAX's
  translation would)
- ``load_openvino(model_path, weight_path)`` — an OpenVINO IR, parsed and
  run with torch (net/openvino_net.py)
- ``load_checkpoint(path)`` — the parameters and the model state
  (``batch_stats``) of a training snapshot, written by either package's
  estimator (learn/checkpoint.py), into the loaded model
- ``predict`` — chunked batch predict; with a bucket ladder the tail
  chunk pads to its nearest rung
- ``predict_async`` / ``predict_fetch`` — the serving engine's staged
  dispatch: launch one batch on the device and record a CUDA event after
  it; the fetch waits for the event, then copies the batch to the host
- ``warm_up`` / ``wait_warm`` / ``rung_ready`` — run one forward at each
  batch rung of the ladder on a background thread (on the device's
  default stream, the one the serving thread launches on, under
  ``inference_mode``), so the kernels' build, cuBLAS's algorithm choice
  and workspace, and the caching allocator's growth fall before the first
  real request on that rung; the serving engine grows its batch bucket
  only onto ready rungs
- decode, for a 2-input (encoder, decoder) model such as ``Seq2Seq``:
  ``decode_step_fn`` / ``paged_decode_step_fn`` (the step seams of
  inference/decode_scheduler.py; the paged one gathers the page pool on
  the device with the paged gather kernel), ``warm_decode`` and
  ``generate`` (greedy / sample / raw, optionally speculative with a
  draft model)

- ``quantize(min_elems, mode="weight"|"int8", calibration_data)`` — the
  post-training int8 of inference/quantize.py: weight int8 resident on
  the device, dequantized inside each forward; ``"int8"`` also
  calibrates activation ranges and runs the calibrated Dense and Conv
  layers as integer products (``_act_ranges`` holds the ranges by flax
  path, ``_qtree`` the quantized parameter tree). Re-quantizing keeps
  what was quantized; the warm rungs are dropped (the forward changed).

Each loaded forward runs under ``telemetry.instrument_jit`` (JAX's name
``inference_model``, the paged seam's ``inference_model_paged``): a new
batch signature counts in ``zoo_jit_cache_misses_total``, as a JAX
recompile does; results come back through ``traced_device_get``.

- ``shard(strategy, param_rules)`` — serve the model sharded over a group
  of ranks (``parallel/sharded_executable.py``, ROADMAP C28): every rank
  loads the same model and calls ``shard``; rank 0 then serves, and every
  predict, warm-up and decode step dispatches through the sharded
  executable, while ranks 1..n-1 call ``follow()`` until rank 0 calls
  ``unshard()`` (or loads another model). ``shard_info()`` is JAX's:
  strategy, shard count, whole and per-rank parameter bytes. Any
  ``load_*``, ``load_checkpoint`` or ``quantize`` drops the sharding (the
  latter two on the whole parameters, gathered first).

There is no CPU failover: a model on ``cuda`` runs there or raises.
"""

from __future__ import annotations

import collections
import copy
import logging
import threading
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from analytics_zoo_tpu_torch.common import compile_ahead, telemetry
from analytics_zoo_tpu_torch.common.device import (DeviceLike, as_tensor,
                                                   resolve_device, to_numpy)
from analytics_zoo_tpu_torch.ops import autotune


logger = logging.getLogger(__name__)


def _as_tuple(x):
    return tuple(x) if isinstance(x, (list, tuple)) else (x,)


class _Pending:
    """One launched batch: its output tensor(s) and, on the card, the
    CUDA event recorded after the launch on the launching stream."""

    __slots__ = ("out", "event")

    def __init__(self, out, event):
        self.out = out
        self.event = event


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
        # ((sample_shape, dtype), ...) per input: what warm_up builds its
        # zero batches from
        self._sample_spec = None
        # rungs whose forward has run and synchronized for the loaded
        # module, and the ones a warm-up thread is running now
        self._ready_rungs: set = set()
        self._warming: set = set()
        self._warm_threads: list = []
        #: after ``quantize``: the quantized parameter tree and, in int8
        #: mode, the calibrated activation ranges by flax path
        self._qtree = None
        self._act_ranges = None
        #: name -> (the module, its instrumented forward): ``_counted``
        self._jitted = {}
        #: after ``shard``: the sharded executable every forward takes
        self._sharded = None

    # ------------------------------------------------------------- loaders
    def load_zoo(self, model) -> "InferenceModel":
        """Load a zoo keras model (KerasNet) or ZooModel instance
        (ref doLoadBigDL, InferenceModel.scala:96). The model's module is
        copied, so later changes to ``model`` do not reach this one."""
        from analytics_zoo_tpu_torch.keras.models import KerasNet

        net = model.model if isinstance(getattr(model, "model", None),
                                        KerasNet) else model
        module = copy.deepcopy(net.module).to(self.device).eval()
        self._drop_sharding()
        with self._lock:
            self._module = module
            self._n_inputs = len(module.graph_inputs)
            self._sample_spec = None
            self._ready_rungs = set()
            self._qtree = self._act_ranges = None
        return self

    def load(self, path: str) -> "InferenceModel":
        """Load a ZooModel directory that ``save_model`` of either package
        wrote (``config.json`` + ``weights/ckpt-<n>/``; ref doLoadBigDL
        from file)."""
        from analytics_zoo_tpu_torch.models.common import ZooModel
        return self.load_zoo(ZooModel.load_model(path))

    def load_openvino(self, model_path: str, weight_path: str,
                      batch_size: int = 0) -> "InferenceModel":
        """Load an OpenVINO IR model (ref
        pyzoo/zoo/pipeline/inference/inference_model.py:69 load_openvino
        -> the native OpenVINO engine): the IR is parsed and run layer by
        layer with torch on this model's device (net/openvino_net.py), so
        the same published artifacts serve here. ``batch_size`` is taken
        for the reference's API (batching is dynamic here)."""
        from analytics_zoo_tpu_torch.net.openvino_net import IRModule
        module = IRModule(model_path, weight_path).to(self.device).eval()
        self._drop_sharding()
        with self._lock:
            self._module = module
            self._n_inputs = module.n_inputs
            self._sample_spec = None
            self._ready_rungs = set()
            self._qtree = self._act_ranges = None
        return self

    def load_torch(self, torch_module: torch.nn.Module, sample_input
                   ) -> "InferenceModel":
        """Load a PyTorch module (ref doLoadPyTorch,
        InferenceModel.scala:249; the counterpart of the JAX package's
        ``load_flax`` and ``load_torch``). ``sample_input`` (an array or a
        tuple of arrays) fixes how many inputs ``predict`` feeds the
        module. The module is copied, so later changes to it do not reach
        this model; in the copy, each ``nn.MultiheadAttention`` of JAX's
        domain runs the port's attention core where JAX's translation
        would (``net.torch_net.swap_attention``: a foreign transformer
        served here launches the flash kernel)."""
        from analytics_zoo_tpu_torch.net.torch_net import swap_attention
        copy_ = copy.deepcopy(torch_module).to(self.device).eval()
        swap_attention(copy_)
        self._drop_sharding()
        with self._lock:
            self._module = copy_
            self._n_inputs = len(_as_tuple(sample_input))
            self._ready_rungs = set()
            self._qtree = self._act_ranges = None
        self._remember_spec(_as_tuple(sample_input), overwrite=True)
        return self

    def load_checkpoint(self, path: str) -> "InferenceModel":
        """Restore the weights of a training snapshot into the loaded
        model (ref doLoadBigDL's weight path): the newest ``ckpt-<n>``
        under ``path``, or ``path`` itself when it is one, written by
        either package (``Estimator.save``, a fit's checkpoint trigger,
        ``save_weights``). The parameters are read from the snapshot's
        ``params`` tree, and the buffers (a batch norm's running
        statistics) from its ``model_state`` where the model has them;
        both are checked against the model's shapes and dtypes first.
        The optimizer state is not read. The restored module replaces the
        loaded one whole, so a predict in flight finishes on the old
        weights."""
        from analytics_zoo_tpu_torch.convert import ParamLayout
        from analytics_zoo_tpu_torch.learn import checkpoint as ckpt_lib

        self._drop_sharding(whole=True)
        with self._lock:
            if self._module is None:
                raise RuntimeError("load a model before load_checkpoint")
            if self._qtree is not None:
                raise RuntimeError("load_checkpoint restores float weights: "
                                   "call it before quantize")
            module = self._module
        found = ckpt_lib.find_latest_checkpoint(path)
        tree, _ = ckpt_lib.read_checkpoint(path if found is None
                                           else found[0])
        layout = ParamLayout(module)
        ckpt_lib.validate_state(tree["params"], layout.like)
        values = layout.from_tree(tree["params"])
        buffers = {k: v for k, v in module.named_buffers()
                   if k in layout.state_paths}
        saved = {}
        if buffers and tree.get("model_state"):
            spec = layout.state_tree({k: v.to("meta")
                                      for k, v in buffers.items()})
            ckpt_lib.validate_state(tree["model_state"], spec)
            saved = layout.state_from_tree(tree["model_state"])
        module = copy.deepcopy(module)
        named = dict(module.named_parameters())
        with torch.no_grad():
            for n, p in named.items():
                p.copy_(values[n])
            for k, b in module.named_buffers():
                if k in saved:
                    b.copy_(saved[k])
        with self._lock:
            self._module = module
        return self

    def quantize(self, min_elems: int = 1024, mode: str = "weight",
                 calibration_data=None) -> "InferenceModel":
        """Post-training int8 quantization (ref BigDL ``model.quantize()``).

        ``mode="weight"``: every parameter leaf with ndim >= 2 and at
        least ``min_elems`` elements is stored int8 under per-channel
        scales on the device and dequantized inside each forward.
        ``mode="int8"``: also a calibration pass over ``calibration_data``
        (an array or tuple, or a list of batches) records each Dense and
        Conv input's range, and those layers then run as ``int8 x int8 ->
        int32`` products (inference/quantize.py). The quantized module
        replaces the loaded one whole, as a load does."""
        from analytics_zoo_tpu_torch.inference import quantize as qlib

        if mode not in ("weight", "int8"):
            raise ValueError(f"mode must be 'weight' or 'int8', got {mode!r}")
        self._drop_sharding(whole=True)
        with self._lock:
            if self._module is None:
                raise RuntimeError("load a model before quantize")
            module, n_inputs = self._module, self._n_inputs
        batches = None
        if mode == "int8":
            if calibration_data is None:
                raise ValueError(
                    "mode='int8' needs calibration_data (a batch or list "
                    "of batches) for the activation-range pass")
            batches = calibration_data \
                if isinstance(calibration_data, list) else [calibration_data]
            if not batches:
                raise ValueError(
                    "mode='int8': calibration_data is empty — pass at "
                    "least one batch to calibrate activation ranges")
        module = copy.deepcopy(module)
        qtree = qlib.quantize_module(module, min_elems)
        act = None
        if batches is not None:
            act = qlib.calibrate_activations(
                module, lambda b: self._forward(
                    module, self._coerce(b, n_inputs)), batches)
            qlib.int8_modules(module, act)
        with self._lock:
            self._module = module
            self._qtree = qtree
            self._act_ranges = act
            self._ready_rungs = set()
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

    # ------------------------------------------------------------ warm-up
    def _remember_spec(self, xs, overwrite: bool = False):
        """Record the per-sample (shape, dtype) of every input (``xs`` is
        batched). A loader's ``sample_input`` overwrites; shapes seen in a
        predict only fill an empty spec."""
        try:
            xs = [a if isinstance(a, torch.Tensor) else np.asarray(a)
                  for a in xs]
            spec = tuple((tuple(a.shape[1:]), a.dtype) for a in xs)
        except Exception:
            return
        with self._lock:
            if overwrite or self._sample_spec is None:
                self._sample_spec = spec

    def has_warm_spec(self) -> bool:
        """True once the input spec warm-up needs is known."""
        with self._lock:
            return self._sample_spec is not None

    def _warm_rung(self, module, spec, rung: int) -> None:
        """One forward at batch ``rung`` on zeros of the spec, then a sync
        of an event recorded after it."""
        def zeros(shape, dtype):
            if isinstance(dtype, torch.dtype):
                return torch.zeros((rung,) + tuple(shape), dtype=dtype,
                                   device=self.device)
            return as_tensor(np.zeros((rung,) + tuple(shape), dtype),
                             self.device)

        fwd = self._sharded if self._sharded is not None else module
        with torch.inference_mode():
            fwd(*(zeros(shape, dtype) for shape, dtype in spec))
        if self.device.type == "cuda":
            # the default stream, not one of the warm thread's own: the
            # caching allocator keeps a freed block for the stream that
            # used it, and cuBLAS its workspace per stream, so a private
            # stream would warm a pool the serving thread never draws from
            # (dev/warmup_variants.py)
            done = torch.cuda.Event()
            done.record()
            done.synchronize()

    def warm_up(self, rungs=None, sample_input=None, block: bool = False):
        """Run one forward at each batch ``rung`` (default: the attached
        ladder's) that is not ready yet, on a background thread, on the
        device's default stream, under ``inference_mode``, and wait for
        it: the kernels' build, cuBLAS's algorithm choice and workspace,
        and the caching allocator's growth to the rung's peak then fall
        before the first real request. The forward shares the module with
        the serving thread and writes no shared state, so results served
        meanwhile keep their bits. After the rungs the worker runs the
        autotuner's queued measurements (``autotune.tune_pending``, as
        JAX's warm-up worker does), off the serving thread; it stops when
        the process begins to exit, and a failed one is logged.
        ``sample_input`` (batched) records the input spec when the loader
        did not. ``block=True`` runs on the caller's thread. Returns the
        thread (None when nothing is left to warm or measure, or the spec
        is unknown); ``wait_warm`` joins them all."""
        if sample_input is not None:
            self._remember_spec(_as_tuple(sample_input), overwrite=True)
        with self._lock:
            module, spec, ladder = \
                self._module, self._sample_spec, self._ladder
            if module is None or spec is None:
                return None
            if rungs is None:
                rungs = ladder.rungs if ladder is not None else ()
            todo = [r for r in sorted({int(r) for r in rungs})
                    if r not in self._ready_rungs
                    and r not in self._warming]
            self._warming.update(todo)
        if not todo and not autotune.pending_count():
            return None

        def run():
            try:
                for rung in todo:
                    if compile_ahead.draining():
                        break
                    try:
                        self._warm_rung(module, spec, rung)
                    except Exception:
                        logger.exception("warm-up of rung %d failed", rung)
                        continue
                    with self._lock:
                        if self._module is module:
                            self._ready_rungs.add(rung)
            finally:
                with self._lock:
                    self._warming.difference_update(todo)
            autotune.drain_after_warmup()

        if block:
            run()
            return None
        t = threading.Thread(target=run, daemon=True, name="zoo-warm-up")
        compile_ahead.register_warmup_thread(t)
        with self._lock:
            self._warm_threads = [w for w in self._warm_threads
                                  if w.is_alive()] + [t]
        t.start()
        return t

    def wait_warm(self, timeout: Optional[float] = None
                  ) -> "InferenceModel":
        """Join every outstanding warm-up thread (within ``timeout``
        seconds in all, when given)."""
        with self._lock:
            threads = list(self._warm_threads)
        deadline = None if timeout is None else \
            time.monotonic() + float(timeout)
        for t in threads:
            t.join(None if deadline is None
                   else max(0.0, deadline - time.monotonic()))
        return self

    def rung_ready(self, rung: int) -> bool:
        """True once a forward at batch ``rung`` has run and synchronized
        for the loaded model — the serving engine's gate for growing its
        batch bucket."""
        with self._lock:
            return int(rung) in self._ready_rungs

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

    def _counted(self, module, name: str = "inference_model"):
        """``module`` under ``telemetry.instrument_jit``, one wrapper per
        loaded module (JAX instruments each installed forward anew)."""
        with self._lock:
            cur = self._jitted.get(name)
            if cur is None or cur[0] is not module:
                cur = self._jitted[name] = (module, telemetry.instrument_jit(
                    module, name=name))
        return cur[1]

    def _forward(self, module, xs):
        se = self._sharded
        if se is not None:
            return se(*xs)
        with torch.inference_mode():
            return self._counted(module)(
                *(as_tensor(a, self.device) for a in xs))

    def shard(self, strategy, param_rules=None, mesh=None,
              devices=None) -> "InferenceModel":
        """Partition the loaded model over a group of ranks by the
        ``ShardingStrategy`` (e.g. ``"tp2"``, ``"dp2,tp2"``); collective:
        every rank loads the same model and calls it. Afterwards rank 0's
        predicts, warm-ups and decode steps dispatch through the sharded
        executable and the other ranks call ``follow()``. The warm rungs
        start over. A sharded model is sharded again only from its whole
        parameters: ``unshard`` (rank 0) or load the model again first."""
        from analytics_zoo_tpu_torch.parallel.sharded_executable import (
            ShardedExecutable,
        )
        with self._lock:
            if self._sharded is not None:
                raise RuntimeError(
                    "the model is sharded: unshard() on rank 0 (the "
                    "followers' follow() returns) and load the model again "
                    "on the others before shard")
            if self._module is None:
                raise RuntimeError("load a model before shard")
            module = self._module
        se = ShardedExecutable(module, None, strategy,
                               param_rules=param_rules, mesh=mesh,
                               devices=devices, name="inference_model",
                               device=self.device)
        with self._lock:
            # the rank holds its blocks only: the whole module goes
            self._module = se.module
            self._sharded = se
            self._ready_rungs = set()
        return self

    def shard_info(self):
        """Per-rank parameter bytes of the sharded model (None when
        unsharded): ``{"strategy", "n_shards", "total_param_bytes",
        "shard_hbm_bytes"}``, the ``/healthz`` block showing that no rank
        holds the whole model (the bytes every rank counted when it
        sharded: no rank is asked again)."""
        se = self._sharded
        if se is None:
            return None
        return {"strategy": str(se.strategy), "n_shards": se.n_shards,
                "total_param_bytes": se.total_param_bytes(),
                "shard_hbm_bytes": se.shard_hbm_bytes()}

    def follow(self) -> int:
        """Ranks 1..n-1 of a sharded model: run rank 0's dispatches until
        it calls ``unshard`` or loads another model, then drop the
        sharding and the model here too (the rank held its blocks only:
        load a model to predict or shard again); the forwards run."""
        se = self._sharded
        if se is None:
            raise RuntimeError("shard the model before follow")
        served = se.follow()
        with self._lock:
            if self._sharded is se:
                self._sharded = None
                self._module = None
                self._ready_rungs = set()
        return served

    def unshard(self) -> "InferenceModel":
        """Rank 0: gather the whole parameters back, release the
        followers and serve unsharded."""
        self._drop_sharding(whole=True)
        return self

    def _drop_sharding(self, whole: bool = False) -> None:
        """Release the followers; with ``whole``, the module with every
        parameter whole first (gathered over the ranks)."""
        with self._lock:
            se, self._sharded = self._sharded, None
            if se is None:
                return
            self._ready_rungs = set()
        if whole:
            module = se.whole_module()
            with self._lock:
                self._module = module
        se.close()

    def predict(self, x, batch_size: Optional[int] = None,
                pipeline_window: int = 2) -> np.ndarray:
        """Batch predict. ``x``: ndarray, tuple of ndarrays (multi-input),
        or an iterator of such batches. Up to ``pipeline_window`` chunks
        are in flight on the device: chunk N+1 is padded and launched
        before chunk N's result is copied back. Thread-safe; at most
        ``concurrent_num`` predicts run at once."""
        module, n_inputs, ladder = self._snapshot()
        if not hasattr(x, "__next__"):
            self._remember_spec(self._coerce(x, n_inputs))

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
                    outs.append(_head(to_numpy(
                        telemetry.traced_device_get(out)), v))
            while inflight:
                out, v = inflight.popleft()
                outs.append(_head(to_numpy(
                    telemetry.traced_device_get(out)), v))
        if not outs:
            raise ValueError("predict called on an empty batch")
        if isinstance(outs[0], tuple):
            return tuple(np.concatenate(parts) for parts in zip(*outs))
        return np.concatenate(outs)

    def predict_async(self, x):
        """Launch ONE already-batched input (ndarray or multi-input tuple)
        without waiting for the device, and on the card record a CUDA
        event after it on the current stream. Returns an opaque pending
        value; pass it to ``predict_fetch`` for the host result. The
        caller owns batching and padding and bounds its in-flight work, so
        the ``concurrent_num`` semaphore is not taken here."""
        module, n_inputs, _ = self._snapshot()
        xs = self._coerce(x, n_inputs)
        self._remember_spec(xs)
        out = self._forward(module, xs)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        return _Pending(out, event)

    def predict_fetch(self, pending):
        """Blocking host side of ``predict_async``: wait for the batch's
        event, then one host copy of its output."""
        if isinstance(pending, _Pending):
            if pending.event is not None:
                pending.event.synchronize()
            pending = pending.out
        return to_numpy(telemetry.traced_device_get(pending))

    def predict_classes(self, x, batch_size: Optional[int] = None,
                        zero_based_label: bool = True) -> np.ndarray:
        probs = np.asarray(self.predict(x, batch_size))
        classes = np.argmax(probs, axis=-1)
        return classes if zero_based_label else classes + 1

    # --------------------------------------------------------------- decode
    def _decode_module(self):
        """The loaded module, checked to be a 2-input encoder/decoder."""
        module, n_inputs, ladder = self._snapshot()
        if n_inputs != 2:
            raise ValueError("decode needs a 2-input (encoder, decoder) "
                             f"model, got {n_inputs} inputs")
        return module, ladder

    def decode_step_fn(self):
        """The scheduler-facing step seam: one wide ``(enc, dec) -> out``
        forward on this model's device, host arrays in and out."""
        self._decode_module()

        def step(enc, dec):
            return self.predict_fetch(self.predict_async((enc, dec)))

        return step

    def paged_decode_step_fn(self):
        """Paged counterpart of :meth:`decode_step_fn`: one wide ``(enc,
        pool, scales, table, lengths) -> out`` forward where the host pool
        goes to the device and the paged gather kernel
        (ops/paged_attention.py) assembles the decoder input there, at
        ``table_width * page_size`` positions. That buffer is bitwise the
        host-gathered one, so outputs at live positions match the plain
        seam bit for bit. The pool is copied to the device every step (the
        JAX package hands the step the host pool too); keeping it on the
        device is later speed work (queue B's R6, ROADMAP)."""
        self._decode_module()

        def step(enc, pool, scales, table, lengths):
            from analytics_zoo_tpu_torch.ops.paged_attention import (
                paged_gather,
            )
            module, _ = self._decode_module()
            fwd = self._sharded if self._sharded is not None else \
                self._counted(module, "inference_model_paged")
            with torch.inference_mode():
                dec = paged_gather(as_tensor(pool, self.device), table,
                                   lengths, scales=as_tensor(scales,
                                                             self.device))
                out = fwd(as_tensor(enc, self.device), dec)
            return to_numpy(telemetry.traced_device_get(out))

        return step

    def _decode_shapes(self, module):
        """(encoder sample shape, decoder width) from the model's graph
        inputs, or None where the graph leaves one unknown."""
        nodes = {n.id: n for n in getattr(module, "order", ())}
        shapes = [getattr(nodes.get(i), "shape", None)
                  for i in getattr(module, "graph_inputs", ())]
        if len(shapes) != 2 or shapes[0] is None or shapes[1] is None:
            return None
        enc, dec = shapes
        if None in enc or dec[-1] is None:
            return None
        return tuple(int(d) for d in enc), int(dec[-1])

    def warm_decode(self, max_seq_len: int, rungs=None, seq_rungs=None,
                    verify_k: int = 0, block: bool = True, paged_pool=None):
        """Run every (batch rung × seq rung) decode shape a ``generate``
        up to ``max_seq_len`` can present once on zeros, so that the
        kernels' build and every first-touch cost fall before any timed
        step. PyTorch has nothing to compile ahead; this is the whole of
        the JAX package's ahead-of-time decode grid here. ``rungs``
        defaults to the attached batch ladder's (none without one);
        ``verify_k > 0`` extends the seq grid for speculative verify
        steps. ``paged_pool=(n_pages, page_size)`` also runs the paged
        step at every (batch rung × table width), on a pool of
        ``ZOO_KV_DTYPE``. The encoder shape comes from the model's graph
        (``Seq2Seq(encoder_seq_len=...)``); without one nothing runs.
        ``block=False`` runs in a thread and returns it."""
        from analytics_zoo_tpu_torch.inference import generation, quantize

        module, ladder = self._decode_module()
        shapes = self._decode_shapes(module)
        if seq_rungs is None:
            seq_rungs = generation.seq_ladder(
                int(max_seq_len) + max(0, int(verify_k))).rungs
        if rungs is None:
            rungs = ladder.rungs if ladder is not None else ()
        rungs = sorted({int(r) for r in rungs})
        seq_rungs = sorted({int(s) for s in seq_rungs})
        if shapes is None or not rungs:
            return None
        (enc_shape, dim) = shapes

        def run():
            step = self.decode_step_fn()
            for r in rungs:
                enc = np.zeros((r,) + enc_shape, np.float32)
                for sr in seq_rungs:
                    step(enc, np.zeros((r, sr, dim), np.float32))
            if paged_pool is not None:
                run_paged()
            autotune.drain_after_warmup()

        def run_paged():
            n_pages, page_size = (int(v) for v in paged_pool)
            pool = np.zeros((n_pages, page_size, dim),
                            quantize.resolve_kv_dtype(None))
            scales = np.ones((n_pages,), np.float32)
            paged = self.paged_decode_step_fn()
            widths = sorted({-(-sr // page_size) for sr in seq_rungs})
            for r in rungs:
                enc = np.zeros((r,) + enc_shape, np.float32)
                for w in widths:
                    paged(enc, pool, scales, np.zeros((r, w), np.int32),
                          np.zeros((r,), np.int32))

        if block:
            run()
            return None
        t = threading.Thread(target=run, daemon=True, name="zoo-warm-decode")
        t.start()
        return t

    def generate(self, input_seq, start_sign, max_new_tokens: int = 16, *,
                 mode: str = "greedy", temperature: float = 1.0,
                 seed: Optional[int] = None, ladder=None,
                 trace_ids: Sequence[str] = (), draft=None,
                 spec_k: int = 4) -> np.ndarray:
        """Autoregressive generation over the seq-length rungs; the loaded
        model must be a 2-input encoder/decoder (e.g. ``Seq2Seq`` via
        ``load_zoo``). ``ladder=None`` takes ``seq_ladder(max_new_tokens
        + 1)``.

        ``draft`` (another InferenceModel, or a bare ``(enc, dec)``
        callable) switches to speculative decoding through the step
        scheduler: the draft proposes ``spec_k`` tokens per step and this
        model verifies them in one wide step, greedy output bitwise the
        plain decode's. Every wide step then pads to the whole batch, so
        the row count of every product stays that of the plain loop as
        sequences finish. Each row keeps a private rng stream under
        ``draft`` (seeded ``seed + row``). ``trace_ids`` is ignored (no
        telemetry yet). Returns ``[batch, max_new_tokens, output_dim]``."""
        from analytics_zoo_tpu_torch.inference import generation

        self._decode_module()
        if draft is not None:
            from analytics_zoo_tpu_torch.inference import decode_scheduler

            draft_fn = (draft.decode_step_fn()
                        if hasattr(draft, "decode_step_fn") else draft)
            input_seq = np.asarray(input_seq)
            start = np.asarray(start_sign, np.float32)
            n = max(1, int(input_seq.shape[0]))
            sched = decode_scheduler.DecodeScheduler(
                self.decode_step_fn(), max_batch=n,
                max_seq=int(max_new_tokens) + 1,
                batch_ladder=compile_ahead.BucketLadder(n, n),
                draft_fn=draft_fn, spec_k=spec_k)
            seqs = [sched.admit(
                        input_seq[i], start[i], max_new_tokens,
                        mode=mode, temperature=temperature,
                        seed=None if seed is None else int(seed) + i,
                        tag=i)
                    for i in range(input_seq.shape[0])]
            sched.drain()
            return np.stack([s.result for s in seqs])
        if ladder is None:
            ladder = generation.seq_ladder(int(max_new_tokens) + 1)
        return generation.decode_loop(
            self.decode_step_fn(), input_seq, start_sign,
            max_new_tokens, ladder=ladder, mode=mode,
            temperature=temperature, seed=seed)

    # java-flavoured aliases (ref AbstractInferenceModel.java)
    do_predict = predict
    do_load = load


def _head(out, n: int):
    """The first ``n`` rows of an output or of each output of a tuple."""
    if isinstance(out, tuple):
        return tuple(o[:n] for o in out)
    return out[:n]
