"""Orca-style Estimator over a PyTorch module: fit, evaluate, predict.

Counterpart of ``analytics_zoo_tpu/learn/estimator.py``
(``Estimator.from_torch`` / ``JaxEstimator``; ref
``pyzoo/zoo/orca/learn/pytorch/estimator.py:35``). The JAX package turns
a torch module into a JAX function and trains it in a jitted step; the
port trains the ``nn.Module`` as it is, on one device (``cuda`` unless
the caller passes ``device="cpu"``; without CUDA that raises), eagerly:

- **The step** follows ``step_fn``: the module's forward with
  ``train=True`` when its ``forward`` takes ``train`` (and
  ``module.train()`` for layers that read it), the mean of the
  per-sample loss plus ``param_penalty`` of the parameters (the keras
  regularizers; the reported loss includes it, as JAX's does), its
  gradients, clipping, the optimizer's update.
  Dropout draws from the device's generator seeded from ``seed`` and the
  step, inside ``torch.random.fork_rng`` so the caller's streams are left
  as they were (the bits differ from JAX's), and under
  ``common.device.RNG_LOCK``, so fits on threads side by side draw what
  each would alone.
- **Clipping** follows optax: ``clip_by_global_norm`` scales by
  ``max_norm / norm`` unless ``norm < max_norm``; constant clipping clips
  at ``max(|lo|, |hi|)``. Changing it rebuilds the optimizer state, as the
  JAX estimator re-initialises its optax chain.
- **fit** takes one step per batch, drops the final partial batch, shuffles
  in the JAX package's order (``data/dataset.py``) and returns the mean
  loss of each epoch. Step losses stay on the device and are read back
  once per ``summary_interval`` steps, never once per step.
- **Summaries** are the JAX package's TensorBoard events
  (common/summary.py): at each read-back window ``Loss`` (the last step
  read), ``Throughput`` (samples/s over the window, host clock) and
  ``LearningRate`` at the step count, and after each epoch with
  validation data every validation metric, under ``set_tensorboard``'s
  ``<log_dir>/<app_name>/{train,validation}``, else ``<model_dir>/...``
  or ``./zoo_tpu_logs/...``. The writer sees only the values the window
  already read back.
- **evaluate** pads the final batch and masks the padded rows out of the
  loss and the metrics; **predict** runs in ``torch.inference_mode()`` and
  drops the padded rows.
- **Checkpoints** are the JAX package's, byte for byte
  (learn/checkpoint.py): ``save``/``load`` and the ``model_dir``
  snapshots write ``ckpt-<step>/state.msgpack`` holding ``{"model_state",
  "opt_state", "params", "step"}`` with flax's names and layouts
  (``convert.ParamLayout``; a BatchNorm's running statistics in
  ``model_state`` as flax's ``batch_stats`` collection) and the optimizer
  state as optax's tree (learn/optimizers.py), so each package reads what
  the other wrote.
- **Snapshots and retries** mirror ``JaxEstimator.fit``: with
  ``model_dir`` set, ``checkpoint_trigger`` (default ``EveryEpoch()``) is
  tested after every step with the last loss read back, and again after
  each epoch; a failed epoch reloads the newest snapshot and goes on, up
  to ``failure_retry_times`` times (``auto_resume=True``: the newest one
  that validates, and ``ZOO_FIT_MAX_RESUMES``). A resume inside this fit
  skips the batches of its epoch that the snapshot already took, so the
  run ends bitwise where an unfaulted one does. Triggers read host values
  only: no step adds a read-back.

- **Data**: ``fit``, ``evaluate`` and ``predict`` take what
  ``data.to_sharded_dataset`` takes; XShards in a tier other than DRAM
  (``OrcaContext.train_data_store = "DISK_n"``) and a
  ``StreamingShardedDataset`` stream window by window, so the store's
  residency bound holds through training; nothing reads a streaming set's
  ``x``. A resume inside ``fit`` skips batches of the stream as of an
  in-memory set, and lands bitwise the same way.
- **Device**: ``device=None`` takes the active context's first device
  (``init_orca_context``), else ``cuda``.
- **Loop modes** (JAX ``fit``'s ``steps_per_loop``, ``cache``):
  ``steps_per_loop=k`` copies ``k`` batches to the device as one stacked
  tensor (``ShardedDataset.device_scan_iterator``) and takes ``k`` eager
  steps from it; the fault seam ``step`` counts one arrival a loop (JAX's
  fused scan counts once), and after each loop the checkpoint trigger is
  tested at every step the loop took (at most one snapshot a loop, of the
  loop's end). ``cache="device"`` copies a labelled in-memory dataset to
  the device once per dataset object (a strong reference) and runs each
  epoch's ``n // batch_size`` steps from it, the permutation drawn on the
  device from a generator seeded from ``seed + 17`` and ``977 + epoch``
  (JAX folds ``PRNGKey(seed + 17)`` with ``977 + epoch``; the bits differ,
  ROADMAP C14); the epoch's losses are read back once, and summaries and
  checkpoint triggers come at its end. No step of either mode differs
  from the per-step fit's: with ``shuffle=False`` (and for the loop, with
  any order) they end bitwise where it does. There is no CUDA graph: a
  loop is ``k`` eager steps (capturing it is ROADMAP R6).
- **Profile** (JAX ``_ProfileWindow``): ``profile=True`` or
  ``profile_steps=(start, stop)`` (default ``(0, 20)``) runs
  ``torch.profiler`` over the fit-relative steps ``[start, stop)``, each
  step inside a ``zoo_step_<n>`` range, and writes the trace to
  ``<tensorboard train dir>/plugins/profile``; the profiler starts and
  stops between steps (between loops with ``steps_per_loop``) and stops
  in ``fit``'s ``finally``.

- **Step profiler** (JAX ``fit``'s ``StepProfiler``, always on):
  ``common/profiling.StepProfiler`` with ``sample_every = max(2,
  summary_interval // 2)`` takes each step's (each loop's, with
  ``n_steps=k``) data wait, dispatch and callback time; every sampled
  step is fenced (``torch.cuda.synchronize``) for its device time, gives
  ``zoo_mfu`` and ``zoo_hbm_bytes`` and its ``train/step-<n>`` spans.
  ``zoo_step_flops`` is counted once per estimator and batch shape
  (``profiling.step_flops`` over one step of the batch: forward, backward
  and the optimizer's update applied to copies of the parameters and of
  its state): under ``fork_rng``, each parameter's ``.grad`` and the
  buffers put back after, so a fit ends bitwise where it would without
  the count. The count's own launches fall in the first fit of a shape.

``Estimator.from_keras`` / ``from_graph`` return a zoo keras model's
own estimator (its compile settings kept, explicit arguments first).

Every summary window's scalars are mirrored into the telemetry registry
(``zoo_training_loss``, ``zoo_training_throughput_samples_per_sec``,
``zoo_training_step_seconds``, ``zoo_training_learning_rate``), the step
functions run under ``telemetry.instrument_jit`` with JAX's names
(``estimator_train_step``, ``_train_scan``, ``_epoch_cached``,
``_predict``) and the cached dataset's copy and the losses' read-backs go
through ``traced_device_put`` / ``traced_device_get``, as in JAX.

**Strategies** (JAX's ``strategy=`` and ``param_rules=``;
``parallel/strategy.py``). Without a process group the estimator trains
on its one device, and a strategy that needs more ranks raises. Across
ranks (``init_orca_context(cluster_mode="multihost")``, torchrun,
``parallel/launch.py``) every rank builds the same estimator over the
strategy's mesh of ranks:

- the parameters start as rank 0's; each parameter the strategy shards
  (``convert.shard_plan``: JAX's rules against flax's paths and shapes)
  is held as this rank's block, and so is its optimizer state;
- a module that computes on its blocks (``sharded_params``:
  ``parallel/tensor_parallel.py``'s paths: a table split by columns,
  Megatron's pairs, a Dense split by outputs) gets them; every other
  sharded parameter is all-gathered for the step (backward:
  reduce-scatter), the FSDP way;
- each rank feeds its block of every global batch
  (``batch_feed_fraction``: ``batch_size / n`` rows where the batch axes
  make ``n`` blocks, the whole batch where the batch is replicated). Each
  rank's loss is its rows' share of the global mean, divided by the
  ranks that hold the same rows; the collectives' backwards are their
  adjoints, so the gradients of the ranks' sum are the global batch's.
  Each gradient is then summed over the axes its parameter is replicated
  on (one ``all_reduce`` a group of parameters). The reported loss, the
  history, ``evaluate``'s metrics and ``predict``'s outputs are the
  global batch's, the same on every rank (evaluate and predict gather the
  outputs over the batch axes; a padded final batch counts its valid
  rows). Every rank must feed the same number of batches;
- MoE layers (``ops/moe.py``) add their load-balance loss times
  ``aux_loss_weight`` (0.01) to the objective, as JAX's step does;
- snapshots gather every leaf into the layout an unsharded fit writes;
  rank 0 writes, every rank reads, and the blocks are cut again on load.
  ``get_model()`` returns a copy of the module with the whole parameters.
- not under sharded parameters: the optimizers whose update reads more
  than one element (LARS, LAMB, L-BFGS), ``cache="device"`` with a
  sharded batch, the step's flop count (ROADMAP R17).
- **pipeline parallelism** (``"pp"``, ``"dp2,pp4"``): a model of
  ``parallel/pipeline.py`` through ``Estimator.from_fn``, its stage
  parameters on the ``pipe`` axis by its ``param_rules``. Each rank holds
  its stage's row and runs only its stage; the row's gradient is summed
  over ``data`` alone. Every pipe rank of a data index feeds the same
  block and computes the same loss (the output is replicated over
  ``pipe``), so the rule above (divided by the ranks that hold the same
  rows) is the pipe axis's loss scaling: the all_reduce that replicates
  the output sums the S ranks' cotangents back into one.
"""

from __future__ import annotations

import copy
import inspect
import itertools
import logging
import math
import os
import time
import warnings
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from analytics_zoo_tpu_torch.common import (profiling, resilience,
                                           telemetry)
from analytics_zoo_tpu_torch.common.context import active_context
from analytics_zoo_tpu_torch.common.device import (RNG_LOCK, DeviceLike,
                                                   as_tensor, resolve_device,
                                                   to_numpy)
from analytics_zoo_tpu_torch.common.summary import SummaryWriter
from analytics_zoo_tpu_torch.convert import ParamLayout
from analytics_zoo_tpu_torch.data.dataset import (ShardedDataset,
                                                  StreamingShardedDataset,
                                                  to_sharded_dataset,
                                                  tree_map)
from analytics_zoo_tpu_torch.data.shard import HostXShards, XShards
from analytics_zoo_tpu_torch.learn import checkpoint as ckpt_lib
from analytics_zoo_tpu_torch.learn import losses as loss_lib
from analytics_zoo_tpu_torch.learn import metrics as metric_lib
from analytics_zoo_tpu_torch.learn.optimizers import Optimizer
from analytics_zoo_tpu_torch.learn.trigger import EveryEpoch, MaxScore, Trigger
from analytics_zoo_tpu_torch.learn.trigger import fire as _fire_trigger
from analytics_zoo_tpu_torch.parallel import collectives
from analytics_zoo_tpu_torch.parallel import mesh as mesh_lib
from analytics_zoo_tpu_torch.parallel import tensor_parallel
from analytics_zoo_tpu_torch.parallel.strategy import ShardingStrategy

logger = logging.getLogger(__name__)

#: where the summaries go without ``set_tensorboard`` or ``model_dir``
DEFAULT_LOG_DIR = os.path.join(".", "zoo_tpu_logs")


def _leaves(tree) -> list:
    """The arrays of a batch: a tensor or array, or a tuple, list or dict
    of them."""
    if isinstance(tree, dict):
        return [a for v in tree.values() for a in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [a for v in tree for a in _leaves(v)]
    return [] if tree is None else [tree]


def _trigger_needs_score(trigger) -> bool:
    """True if the trigger (transitively) contains a MaxScore."""
    if isinstance(trigger, MaxScore):
        return True
    return any(_trigger_needs_score(t)
               for t in getattr(trigger, "triggers", ()))


def _n_inputs(model: nn.Module, sig: inspect.Signature) -> Optional[int]:
    """How many inputs the model's forward takes: a keras graph's input
    count, else its required positional parameters (None when it takes
    ``*args``)."""
    graph_inputs = getattr(model, "graph_inputs", None)
    if graph_inputs is not None:
        return len(graph_inputs)
    if isinstance(model, FnModule):
        return model.n_inputs
    n = 0
    for p in sig.parameters.values():
        if p.kind == p.VAR_POSITIONAL:
            return None
        if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD) and \
                p.default is p.empty:
            n += 1
    return n


class _ProfileWindow:
    """(JAX ``_ProfileWindow``) ``torch.profiler`` over the absolute step
    thresholds ``[start_step, stop_step)``, computed at fit start:
    ``on_step`` after every optimizer step or loop starts it once the
    step count reaches ``start_step`` and closes it at ``stop_step``;
    ``close`` (from fit's ``finally``) writes the trace under
    ``log_dir``."""

    def __init__(self, log_dir: str, start_step: int, stop_step: int,
                 device: torch.device):
        if stop_step <= start_step:
            raise ValueError(
                f"profile_steps window must be non-empty, got "
                f"({start_step}, {stop_step})")
        self.log_dir = log_dir
        self.start_step, self.stop_step = int(start_step), int(stop_step)
        self.device = device
        self.active = False
        self.done = False
        self._prof = None

    def on_step(self, py_step: int) -> None:
        if not self.active and not self.done and \
                py_step >= self.start_step:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
                # no kernel of an earlier step is still in flight
                torch.cuda.synchronize(self.device)
            self._prof = profile(activities=acts)
            self._prof.start()
            self.active = True
            logger.info("torch profiler tracing steps [%d, %d) to %s",
                        self.start_step, self.stop_step, self.log_dir)
        if self.active and py_step >= self.stop_step:
            self.close()

    def close(self) -> None:
        if self.active:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._prof.stop()
            os.makedirs(self.log_dir, exist_ok=True)
            self.path = os.path.join(
                self.log_dir, f"zoo.{time.time_ns()}.pt.trace.json")
            self._prof.export_chrome_trace(self.path)
            self._prof = None
            self.active = False
            self.done = True


class Estimator:
    """Factory (ref orca/learn/tf/estimator.py Estimator)."""

    @staticmethod
    def from_torch(*, model: nn.Module, loss, optimizer="adam", metrics=None,
                   sample_input=None, model_dir: Optional[str] = None,
                   strategy="dp", param_rules=None, seed: int = 0,
                   device: DeviceLike = None) -> "TorchEstimator":
        """Train a PyTorch ``nn.Module`` (ref
        pyzoo/zoo/orca/learn/pytorch/estimator.py:35
        Estimator.from_torch). JAX's keywords are taken: the port needs no
        ``sample_input`` to initialise, so a given one only checks that a
        copy of the module on the CPU runs on it (in eval mode, without a
        gradient; ``ValueError`` if it does not). ``strategy`` and
        ``param_rules`` are JAX's (the module docstring's Strategies); a
        module of the port is matched by flax's paths and shapes, any
        other module by its torch parameter names joined by '/' and
        torch's shapes."""
        if sample_input is not None:
            _probe(model, sample_input)
        return TorchEstimator(model, loss=loss, optimizer=optimizer,
                              metrics=metrics, model_dir=model_dir,
                              strategy=strategy, param_rules=param_rules,
                              seed=seed, device=device)

    @staticmethod
    def from_keras(*, keras_model, loss=None, optimizer=None, metrics=None,
                   model_dir: Optional[str] = None, strategy=None,
                   param_rules=None, device: DeviceLike = None
                   ) -> "TorchEstimator":
        """The estimator of a zoo keras model (ref
        pyzoo/zoo/orca/learn/tf/estimator.py:335 Estimator.from_keras).
        Settings already on the model (a ``compile``, a ``set_strategy``)
        are kept and explicit arguments override them; ``device`` (the
        port's addition, as in ``from_torch``) likewise. The model's own
        estimator is returned, so a later ``model.fit`` trains the same
        state."""
        from analytics_zoo_tpu_torch.keras.models import KerasNet
        model = getattr(keras_model, "model", keras_model)  # a ZooModel
        if not isinstance(model, KerasNet):
            raise TypeError(
                f"from_keras expects a zoo keras model, got "
                f"{type(keras_model).__name__}; use from_torch for torch "
                "modules")
        compiled = model._compile_args or {}
        if loss is None and compiled.get("loss") is None:
            raise ValueError(
                "no loss: pass loss=... or compile the model first (every "
                "other training entry point errors here too)")
        if strategy is not None or param_rules is not None:
            model.set_strategy(strategy or model._strategy,
                               param_rules=param_rules)
        model.compile(
            optimizer=optimizer if optimizer is not None
            else compiled.get("optimizer", "adam"),
            loss=loss if loss is not None else compiled["loss"],
            metrics=metrics if metrics is not None
            else compiled.get("metrics"),
            device=device if device is not None
            else compiled.get("device"))
        est = model._ensure_estimator(for_training=True)
        if model_dir:
            est.model_dir = model_dir
        return est

    @staticmethod
    def from_graph(*, inputs, outputs, loss, optimizer="adam", metrics=None,
                   model_dir: Optional[str] = None, strategy="dp",
                   param_rules=None, device: DeviceLike = None
                   ) -> "TorchEstimator":
        """The estimator of a symbolic layer graph, ``Input()`` and layer
        nodes (ref orca/learn/tf/estimator.py:291 Estimator.from_graph,
        which takes TF1 graph tensors; here the zoo keras graph)."""
        from analytics_zoo_tpu_torch.keras.models import Model
        return Estimator.from_keras(
            keras_model=Model(inputs, outputs), loss=loss,
            optimizer=optimizer, metrics=metrics, model_dir=model_dir,
            strategy=strategy, param_rules=param_rules, device=device)

    @staticmethod
    def from_fn(*, apply_fn, params, loss, optimizer="adam", metrics=None,
                n_inputs: int = 1, model_dir: Optional[str] = None,
                strategy="dp", param_rules=None, seed: int = 0,
                device: DeviceLike = None) -> "TorchEstimator":
        """Any pure ``apply_fn(params, *inputs)`` over a nested dict of
        tensors (JAX ``Estimator.from_fn``'s escape hatch; ``FnModule``).
        ``params`` holds numpy arrays or tensors, the initial values;
        ``param_rules`` read their '/'-joined dict paths (JAX's)."""
        return TorchEstimator(FnModule(apply_fn, params, n_inputs),
                              loss=loss, optimizer=optimizer,
                              metrics=metrics, model_dir=model_dir,
                              strategy=strategy, param_rules=param_rules,
                              seed=seed, device=device)

    @staticmethod
    def latest_checkpoint(model_dir: str) -> Optional[str]:
        """The newest ``ckpt-<n>`` under ``model_dir``, or None."""
        found = ckpt_lib.find_latest_checkpoint(model_dir)
        return found[0] if found else None


def _probe(model: nn.Module, sample_input) -> None:
    """Run a CPU copy of ``model`` once on ``sample_input`` (an array or a
    tuple of arrays), in eval mode and without a gradient; raise
    ``ValueError`` naming the failure."""
    xs = sample_input if isinstance(sample_input, (tuple, list)) \
        else (sample_input,)
    probe = copy.deepcopy(model).cpu().eval()
    try:
        with torch.no_grad():
            probe(*(torch.as_tensor(np.asarray(a)) for a in xs))
    except Exception as e:
        raise ValueError(f"from_torch: the model does not run on "
                         f"sample_input: {e!r}") from e


class _ParamTree(nn.Module):
    """One dict level of ``FnModule``'s parameters: a leaf is a parameter
    under its key, a dict a child module under its key."""

    def __init__(self, tree):
        super().__init__()
        for key, value in tree.items():
            key = str(key)
            if hasattr(self, key) or "." in key:
                raise ValueError(f"from_fn: parameter key {key!r} cannot "
                                 "name a module attribute")
            if isinstance(value, dict):
                setattr(self, key, _ParamTree(value))
                continue
            t = torch.as_tensor(np.asarray(value) if not isinstance(
                value, torch.Tensor) else value).detach().clone()
            if t.dtype == torch.float64:
                t = t.float()
            self.register_parameter(key, nn.Parameter(
                t, requires_grad=t.is_floating_point()))
        self._keys = list(tree)

    def tree(self) -> Dict:
        """The dict of the current tensors (the ones ``functional_call``
        substitutes included)."""
        return {k: (v.tree() if isinstance(v := getattr(self, k),
                                           _ParamTree) else v)
                for k in self._keys}


class FnModule(_ParamTree):
    """A pure ``apply_fn(params, *inputs)`` as a module (JAX
    ``FnModelAdapter`` without buffers). The parameters sit under their
    dict keys, one child module a dict level, so the torch names are the
    dict paths joined by '.' and the rules read them joined by '/' as
    JAX's ``param_rules`` do; a checkpoint's ``params`` tree is the dict
    itself. A parameter the strategy puts on the ``pipe`` axis reaches
    ``apply_fn`` as this rank's block (``parallel/pipeline.py`` computes
    on it); every other sharded one is whole for the step."""

    def __init__(self, apply_fn, params, n_inputs: int = 1):
        super().__init__(params)
        self._apply_fn = apply_fn
        #: inputs ``forward`` takes (``from_fn``'s ``n_inputs``)
        self.n_inputs = int(n_inputs)

    def forward(self, *inputs):
        return self._apply_fn(self.tree(), *inputs)

    def sharded_params(self, shards) -> set:
        from analytics_zoo_tpu_torch.parallel.mesh import PIPE_AXIS
        return {n for n, s in shards.items() if s.axes == {PIPE_AXIS}}


class TorchEstimator:
    """The engine (ref Scala Estimator zoo/.../pipeline/estimator/
    Estimator.scala:68-309), on one device."""

    def __init__(self, model: nn.Module, loss, optimizer="adam",
                 metrics=None, model_dir: Optional[str] = None,
                 strategy="dp", seed: int = 0, device: DeviceLike = None,
                 param_penalty=None, param_rules=None,
                 aux_loss_weight: float = 0.01):
        self.strategy = ShardingStrategy.parse(strategy,
                                               param_rules=param_rules)
        #: weight of the MoE layers' load-balance loss (JAX's
        #: aux_loss_weight)
        self.aux_loss_weight = float(aux_loss_weight)
        if device is None and active_context() is not None:
            device = active_context().devices[0]
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.loss_fn = loss_lib.get(loss)
        self.optimizer = Optimizer.get(optimizer)
        self.metrics = [metric_lib.get(m) for m in (metrics or [])]
        self.seed = int(seed)
        self.model_dir = model_dir
        #: ``{parameter name: tensor} -> scalar`` added to the loss
        self.param_penalty = param_penalty
        self._tb_dirs = None
        self._train_writer: Optional[SummaryWriter] = None
        self._val_writer: Optional[SummaryWriter] = None
        # ref Topology.scala:1256 bigdl.failure.retryTimes
        self.failure_retry_times = 5
        #: every step's loss, read back once per summary window
        self.step_losses: List[float] = []
        trainable = [(n, p) for n, p in self.model.named_parameters()
                     if p.requires_grad]
        self._names = [n for n, _ in trainable]
        self._params = [p for _, p in trainable]
        self._layout: Optional[ParamLayout] = None
        self._opt_state: Optional[dict] = None
        self._grad_clip = None  # ("norm", v) | ("const", min, max)
        self._epoch = 0
        self._py_step = 0
        #: cache="device": the dataset object held on the device, its
        #: tensors, and the profile window of the last fit
        self._cached = None
        self._profile_window: Optional[_ProfileWindow] = None
        #: step flops by batch signature (profiling.step_flops), and the
        #: step profiler of the running fit
        self._flops: Dict[tuple, Optional[float]] = {}
        self._step_prof: Optional[profiling.StepProfiler] = None
        sig = inspect.signature(self.model.forward)
        self._takes_train = "train" in sig.parameters
        self._n_inputs = _n_inputs(self.model, sig)
        #: JAX's instrumented step functions, built at first use
        self._jit: Optional[Dict[str, object]] = None
        self._setup_strategy()

    # ------------- strategies (the module docstring's Strategies) -------
    def _ensure_mesh(self):
        """The strategy's mesh of ranks (the default mesh where it has
        the strategy's axes and spans the ranks, as JAX's ``_ensure_mesh``
        takes it); without a process group a one-rank mesh over the
        estimator's device."""
        import torch.distributed as dist
        if not (dist.is_available() and dist.is_initialized()):
            for kind, n in self.strategy.sizes:
                if n > 1:
                    raise ValueError(
                        f"strategy {self.strategy} needs {n} ranks on its "
                        f"{kind} axis; this process is one rank: start the "
                        "ranks (parallel/launch.py, torchrun) and "
                        "init_orca_context(cluster_mode='multihost')")
            shape = [1] * len(self.strategy.sizes)
            return mesh_lib.build_mesh(self.strategy.axis_names(), shape,
                                       devices=[self.device],
                                       set_default=False)
        cur = mesh_lib._default_mesh
        if cur is not None and cur.size == dist.get_world_size() and \
                set(cur.axis_names) >= set(self.strategy.axis_names()):
            return cur
        return self.strategy.build_mesh()

    def _setup_strategy(self) -> None:
        self._mesh = self._ensure_mesh()
        self._parallel = self._mesh.size > 1
        #: torch name -> TorchShard, the sharded parameters; of them, the
        #: names gathered for the step
        self._shards: Dict[str, object] = {}
        self._gathered: List[str] = []
        if not self._parallel:
            return
        from analytics_zoo_tpu_torch.convert import shard_plan
        mesh = self._mesh
        # the checkpoint layout keeps the whole shapes
        self._layout = ParamLayout(self.model)
        with torch.no_grad():
            # every replica starts from rank 0's values
            for t in itertools.chain(self.model.parameters(),
                                     self.model.buffers()):
                collectives.broadcast_mesh_(t.data, mesh)
        self._shards = shard_plan(self.model, self.strategy, mesh)
        tensor_parallel.install_shards(self.model, self._shards)
        if self._shards:
            from analytics_zoo_tpu_torch.learn.optimizers import (LAMB, LARS,
                                                                  LBFGS)
            if isinstance(self.optimizer, (LAMB, LARS, LBFGS)):
                raise NotImplementedError(
                    f"{type(self.optimizer).__name__} reads more than one "
                    "element of a parameter at once; under sharded "
                    "parameters the port trains with the elementwise "
                    "optimizers (ROADMAP R17)")
        covered = tensor_parallel.covered_names(self.model, self._shards)
        self._gathered = [n for n in self._shards if n not in covered]
        trainable = [(n, p) for n, p in self.model.named_parameters()
                     if p.requires_grad]
        self._names = [n for n, _ in trainable]
        self._params = [p for _, p in trainable]
        self._by_name = dict(self.model.named_parameters())
        live = [ax for ax in mesh.axis_names if mesh.shape[ax] > 1]
        self._reduce_axes = {
            n: tuple(ax for ax in live if n not in self._shards
                     or ax not in self._shards[n].axes)
            for n in self._names}
        self._batch_shards = self.strategy.batch_shards(mesh)
        self._feed = self.strategy.batch_feed_fraction(mesh)

    def _whole(self, name: str, tensor: torch.Tensor) -> torch.Tensor:
        """``tensor`` (a parameter's block, or state shaped like it) as
        the whole (collective under a shard)."""
        shard = self._shards.get(name)
        return tensor if shard is None else shard.gather(tensor)

    def _block(self, name: str, tensor: torch.Tensor) -> torch.Tensor:
        shard = self._shards.get(name)
        return tensor if shard is None else shard.block(tensor)

    def _reduce_grads(self, grads: List[torch.Tensor]) -> None:
        """Sum each gradient over the axes its parameter is replicated on,
        one all_reduce a group of parameters with the same axes and
        dtype."""
        buckets = defaultdict(list)
        for i, name in enumerate(self._names):
            axes = self._reduce_axes[name]
            if axes:
                buckets[(axes, grads[i].dtype)].append(i)
        for (axes, _), idx in buckets.items():
            flat = torch.cat([grads[i].reshape(-1) for i in idx])
            collectives.all_reduce_(flat, self._mesh, axes)
            off = 0
            for i in idx:
                n = grads[i].numel()
                grads[i] = flat[off:off + n].view_as(grads[i])
                off += n

    def _global_sq_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The squared global norm of the gradients, each block counted
        once over the ranks."""
        world = self._mesh.size
        total = sum(torch.sum(g * g) * (int(np.prod(
            [self._mesh.shape[ax] for ax in self._shards[n].axes]))
            if n in self._shards else 1) / world
            for n, g in zip(self._names, grads))
        return collectives.all_reduce_(total.reshape(1).clone(), self._mesh,
                                       self._mesh.axis_names)[0]

    def _check_batches(self, n_batches: int) -> None:
        """Every rank feeds the same number of batches (the collectives of
        a step pair up across the ranks)."""
        t = torch.tensor([n_batches, -n_batches], dtype=torch.float64,
                         device=self.device)
        collectives.all_reduce_(t, self._mesh, self._mesh.axis_names,
                                op="max")
        if int(t[0]) != -int(t[1]):
            raise ValueError(
                f"the ranks feed from {-int(t[1])} to {int(t[0])} batches; "
                "give every rank's data the same number of batches")

    def gathered_state_dict(self) -> Dict[str, torch.Tensor]:
        """The module's ``state_dict`` with every sharded parameter whole
        (collective under sharding: every rank calls it)."""
        with torch.no_grad():
            return {k: self._whole(k, v.detach())
                    for k, v in self.model.state_dict(keep_vars=True).items()}

    def _instrumented(self, which: str):
        """The step functions under ``telemetry.instrument_jit`` with
        JAX's names (its learn/estimator.py:551-632): a step, a loop of
        ``steps_per_loop`` steps, a cached epoch and a predict batch each
        count their calls and new signatures (JAX's recompiles) in
        ``zoo_jit_calls_total`` / ``zoo_jit_cache_misses_total``. Built
        once, on the registry current at first use, as JAX builds its
        jitted steps once: the three training functions together, the
        predict function at the first predict."""
        if self._jit is None:
            self._jit = {
                "step": telemetry.instrument_jit(
                    self._step, name="estimator_train_step"),
                "scan": telemetry.instrument_jit(
                    self._loop_steps, name="estimator_train_scan"),
                "cached": telemetry.instrument_jit(
                    self._run_epoch_cached, name="estimator_epoch_cached")}
        if which == "predict" and which not in self._jit:
            self._jit[which] = telemetry.instrument_jit(
                self._forward, name="estimator_predict")
        return self._jit[which]

    # ------------- gradient clipping (ref spark_estimator.py:150-180) ----
    def set_constant_gradient_clipping(self, min_value: float,
                                       max_value: float):
        self._grad_clip = ("const", float(min_value), float(max_value))
        self._opt_state = None

    def set_l2_norm_gradient_clipping(self, clip_norm: float):
        self._grad_clip = ("norm", float(clip_norm))
        self._opt_state = None

    def clear_gradient_clipping(self):
        self._grad_clip = None
        self._opt_state = None

    def _clip(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        if self._grad_clip is None:
            return grads
        if self._grad_clip[0] == "const":
            mag = max(abs(self._grad_clip[1]), abs(self._grad_clip[2]))
            return [g.clamp(-mag, mag) for g in grads]
        max_norm = self._grad_clip[1]
        # optax global_norm: the square root of the summed squares
        norm = torch.sqrt(self._global_sq_norm(grads) if self._parallel
                          else sum(torch.sum(g * g) for g in grads))
        keep = norm < max_norm
        return [torch.where(keep, g, (g / norm) * max_norm) for g in grads]

    # ------------- the step ----------------------------------------------
    def _ensure_opt_state(self) -> dict:
        if self._opt_state is None:
            # "count": optax's update count, which restarts with the state
            self._opt_state = {"count": 0,
                               **self.optimizer.init(self._params)}
        return self._opt_state

    def _tensors(self, tree):
        return tree_map(lambda a: as_tensor(a, self.device), tree)

    def _fraction(self) -> Optional[float]:
        """The share of each global batch this rank feeds (None: all of
        it, one rank)."""
        return self._feed if self._parallel else None

    def _per_rank(self, batch_size: int) -> int:
        return ShardedDataset._per_host(batch_size, self._fraction())

    def _gather_rows(self, tree):
        """The global batch's rows of a rank's outputs: gathered over the
        batch axes, in data-index order."""
        axes = self.strategy.batch_axes()
        return tree_map(lambda a: collectives.gather_axes(
            a, self._mesh, axes, 0), tree)

    def _forward(self, x, train: bool):
        args = x if isinstance(x, (tuple, list)) else (x,)
        kwargs = {"train": train} if self._takes_train else {}
        if not self._gathered:
            return self.model(*args, **kwargs)
        # the shards no module computes on, whole for this step
        whole = {n: self._whole(n, self._by_name[n]) for n in self._gathered}
        return torch.func.functional_call(self.model, whole, tuple(args),
                                          kwargs, strict=False)

    def _loss_and_grads(self, x, y):
        """One batch's loss (the penalty included) and the gradient of
        each trainable parameter, from the forward with ``train=True``
        under the step's dropout seed."""
        x, y = self._tensors(x), self._tensors(y)
        cuda = self.device.type == "cuda"
        devices = [self.device.index if self.device.index is not None
                   else torch.cuda.current_device()] if cuda else []
        step_seed = (self.seed * 1000003 + self._py_step) & 0x7FFFFFFFFFFF
        with RNG_LOCK, torch.random.fork_rng(devices=devices):
            torch.random.default_generator.manual_seed(step_seed)
            if cuda:
                with torch.cuda.device(self.device):
                    torch.cuda.manual_seed(step_seed)
            from analytics_zoo_tpu_torch.ops import moe
            with moe.collect_aux_losses() as aux:
                preds = self._forward(x, train=True)
        per = self.loss_fn(y, preds)
        if not self._parallel:
            loss = per.mean()
            if self.param_penalty is not None:
                loss = loss + self.param_penalty(dict(zip(self._names,
                                                          self._params)))
            if aux:
                loss = loss + self.aux_loss_weight * sum(aux)
            grads = torch.autograd.grad(loss, self._params,
                                        allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(self._params, grads)]
            return loss.detach(), grads
        return self._parallel_loss_and_grads(per, aux)

    def _parallel_loss_and_grads(self, per, aux):
        """The module docstring's Strategies: this rank's share of the
        global loss, its gradients summed over the ranks, and the global
        loss (the same on every rank)."""
        mesh = self._mesh
        world = mesh.size
        copies = world // self._batch_shards
        # this rank's rows' share of the global mean
        local = per.sum() / (per.numel() * self._batch_shards)
        objective = local / copies
        extra = torch.zeros((), dtype=local.dtype, device=local.device)
        if self.param_penalty is not None:
            # every rank adds the whole penalty; the ranks' sum counts it
            # once
            whole = {n: self._whole(n, p)
                     for n, p in zip(self._names, self._params)}
            pen = self.param_penalty(whole)
            objective = objective + pen / world
            extra = extra + pen.detach()
        if aux:
            term = self.aux_loss_weight * sum(aux)
            objective = objective + term / world
            extra = extra + term.detach()
        grads = torch.autograd.grad(objective, self._params,
                                    allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self._params, grads)]
        self._reduce_grads(grads)
        loss = collectives.all_reduce_(
            (local.detach() / copies).reshape(1).clone(), mesh,
            mesh.axis_names)[0] + extra
        return loss, grads

    def _step_flops(self, x, y) -> Optional[float]:
        """The flops of one step on batch ``(x, y)``, counted once per
        batch signature. The counting pass runs the step's forward and
        backward under ``fork_rng`` and the update on copies of the
        parameters and the optimizer state, then puts back each ``.grad``
        and every buffer: the fit does not move."""
        key = tuple((tuple(a.shape), str(a.dtype)) for a in
                    _leaves(x) + _leaves(y))
        if self._parallel:
            # a counting pass would add collectives to one rank's step
            return None
        if key not in self._flops:
            grads = [p.grad for p in self._params]
            bufs = [(b, b.detach().clone()) for b in self.model.buffers()]
            params = [p.detach().clone() for p in self._params]
            state = copy.deepcopy(self._opt_state) or {
                "count": 0, **self.optimizer.init(params)}

            def step():
                _, g = self._loss_and_grads(x, y)
                with torch.no_grad():
                    self.optimizer.step(params, self._clip(g), state,
                                        state["count"])

            cuda = self.device.type == "cuda"
            devices = [self.device.index if self.device.index is not None
                       else torch.cuda.current_device()] if cuda else []
            try:
                # under RNG_LOCK: leaving fork_rng puts the generators
                # back, which must not land inside another thread's step
                with RNG_LOCK, torch.random.fork_rng(devices=devices):
                    self._flops[key] = profiling.step_flops(step)
            finally:
                with torch.no_grad():
                    for p, g in zip(self._params, grads):
                        p.grad = g
                    for b, saved in bufs:
                        b.copy_(saved)
        return self._flops[key]

    def _live_tensors(self):
        """What ``zoo_hbm_bytes`` sums off the card: the parameters and
        the optimizer state."""
        return [self._params, self._opt_state or {}]

    def _sampled_device_s(self, t1: float, x, y) -> float:
        """A sampled step's fenced device time since its dispatch began at
        ``t1``; then the step's flop count, once (its time is no phase's)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        device_s = time.perf_counter() - t1
        self._step_prof.ensure_flops(lambda: self._step_flops(x, y))
        return device_s

    def _train_step(self, x, y) -> torch.Tensor:
        state = self._ensure_opt_state()
        loss, grads = self._loss_and_grads(x, y)
        with torch.no_grad():
            self.optimizer.step(self._params, self._clip(grads), state,
                                state["count"])
        state["count"] += 1
        return loss

    # ------------- summaries (ref estimator.py:167-220) ----------------
    def set_tensorboard(self, log_dir: str, app_name: str):
        """Write the summaries under ``<log_dir>/<app_name>/train`` and
        ``.../validation`` from now on."""
        self._tb_dirs = (os.path.join(log_dir, app_name, "train"),
                         os.path.join(log_dir, app_name, "validation"))
        if self._train_writer is not None:
            self._train_writer.close()
            self._val_writer.close()
            self._train_writer = self._val_writer = None

    def _writers(self):
        if self._train_writer is None:
            if self._tb_dirs is None:
                base = self.model_dir or DEFAULT_LOG_DIR
                self._tb_dirs = (os.path.join(base, "train"),
                                 os.path.join(base, "validation"))
            self._train_writer = SummaryWriter(self._tb_dirs[0])
            self._val_writer = SummaryWriter(self._tb_dirs[1])
        return self._train_writer, self._val_writer

    def get_train_summary(self, tag: str):
        """``[(step, value)]`` of a training scalar ("Loss",
        "Throughput", "LearningRate"; ref Topology.scala:208-240)."""
        return self._train_writer.get_scalar(tag) if self._train_writer \
            else []

    def get_validation_summary(self, tag: str):
        """``[(step, value)]`` of a validation metric ("loss",
        "accuracy", ...)."""
        return self._val_writer.get_scalar(tag) if self._val_writer else []

    def _current_lr(self, step: int) -> Optional[float]:
        """The optimizer's rate at ``step``, where it has one."""
        lr = getattr(self.optimizer, "_lr", None)
        return None if lr is None else float(lr(step))

    # ------------- public API --------------------------------------------
    def _dataset(self, data, feature_cols, label_cols) -> ShardedDataset:
        """``data`` as a ShardedDataset. A single-input model fed one
        input per DataFrame column (the reference's DataFrame
        convention) gets the scalar columns stacked into one matrix (not
        a streaming set, as in JAX: its rows never gather)."""
        ds = to_sharded_dataset(data, feature_cols, label_cols)
        if isinstance(ds, StreamingShardedDataset):
            return ds
        if (self._n_inputs == 1 and isinstance(ds.x, tuple)
                and all(np.ndim(a) == 1 for a in ds.x)):
            return ShardedDataset(np.column_stack(ds.x), ds.y)
        return ds

    def fit(self, data, epochs: int = 1, batch_size: int = 32,
            feature_cols=None, label_cols=None, validation_data=None,
            checkpoint_trigger: Optional[Trigger] = None,
            summary_interval: int = 20, shuffle: bool = True,
            steps_per_loop: int = 1, cache: Optional[str] = None,
            profile: bool = False, profile_steps=None,
            auto_resume: bool = False) -> Dict[str, List[float]]:
        """(ref orca/learn/tf/estimator.py fit:486) One optimizer step per
        batch of ``batch_size``; returns ``{"loss": [mean loss of each
        epoch], "val_<metric>": [...]}``. ``data`` and ``validation_data``
        take what ``to_sharded_dataset`` takes (``feature_cols`` and
        ``label_cols`` name a DataFrame's columns).

        With ``model_dir`` set, ``checkpoint_trigger`` (default
        ``EveryEpoch()``) snapshots the state, and a failed epoch is
        retried from the newest snapshot up to ``failure_retry_times``
        times (ref Topology.scala:1255-1337). ``auto_resume=True`` reloads
        the newest snapshot that validates against this model, walking
        past torn or mismatched ones, within ``ZOO_FIT_MAX_RESUMES``
        resumes: the step and epoch counts, the optimizer state and the
        data order come back, so the run ends bitwise where an unfaulted
        one does.

        ``steps_per_loop``, ``cache="device"``, ``profile`` and
        ``profile_steps`` are the module docstring's loop modes and
        profile window."""
        if cache not in (None, "device"):
            raise ValueError(f"unknown cache mode {cache!r} "
                             "(supported: 'device')")
        ds = self._dataset(data, feature_cols, label_cols)
        if cache == "device" and (getattr(ds, "x", None) is None
                                  or ds.y is None):
            raise ValueError("cache='device' needs a materialized labelled "
                             "dataset (streaming/tiered feeds stay on the "
                             "standard path)")
        if cache == "device" and self._parallel and self._batch_shards > 1:
            raise ValueError(
                "cache='device' needs an unsharded batch (one rank, or a "
                "strategy that replicates the batch); use the standard feed "
                "for data-parallel meshes")
        if self._parallel:
            self._check_batches(ds.n // self._per_rank(batch_size))
        val_ds = (self._dataset(validation_data, feature_cols, label_cols)
                  if validation_data is not None else None)
        if checkpoint_trigger is None and self.model_dir:
            checkpoint_trigger = EveryEpoch()
        if checkpoint_trigger is not None and \
                _trigger_needs_score(checkpoint_trigger) and val_ds is None:
            warnings.warn(
                "checkpoint_trigger contains MaxScore but fit() got no "
                "validation_data: the trigger can never fire and no "
                "checkpoints will be written")
        trigger = checkpoint_trigger if self.model_dir else None
        train_writer, val_writer = self._writers()
        history: Dict[str, List[float]] = {"loss": []}
        target = self._epoch + epochs
        start = (self._py_step, self._epoch, len(self.step_losses),
                 ds.n // self._per_rank(batch_size))
        window = None
        if profile or profile_steps is not None:
            lo, hi = profile_steps if profile_steps is not None else (0, 20)
            window = _ProfileWindow(
                os.path.join(self._tb_dirs[0], "plugins", "profile"),
                self._py_step + int(lo), self._py_step + int(hi),
                self.device)
        self._profile_window = window
        self._step_prof = profiling.StepProfiler(
            name="train", sample_every=max(2, int(summary_interval) // 2),
            device=self.device, live_tensors=self._live_tensors)
        try:
            if window is not None:
                window.on_step(self._py_step)
            self._fit_epochs(ds, val_ds, target, batch_size, shuffle,
                             max(1, int(summary_interval)), trigger,
                             max(1, int(steps_per_loop)), cache, window,
                             auto_resume, start, history)
        finally:
            self._step_prof = None
            if window is not None:
                window.close()
        train_writer.flush()
        val_writer.flush()
        return history

    def _fit_epochs(self, ds, val_ds, target, batch_size, shuffle,
                    summary_interval, trigger, steps_per_loop, cache,
                    window, auto_resume, start, history) -> None:
        """``fit``'s epochs, each retried from the newest snapshot on a
        failure."""
        retries, skip = 0, 0
        train_writer, val_writer = self._writers()
        while self._epoch < target:
            try:
                if cache == "device":
                    epoch_loss = self._instrumented("cached")(
                        ds, batch_size, shuffle, train_writer, window, skip)
                else:
                    epoch_loss = self._run_epoch(
                        ds, batch_size, shuffle, summary_interval, trigger,
                        train_writer, skip, steps_per_loop, window)
            except Exception as e:
                # retry from the newest snapshot (ref Topology.scala:1255)
                retries += 1
                limit = self.failure_retry_times
                if auto_resume:
                    resilience.note_backend_loss(e)
                    limit = resilience.fit_max_resumes(limit)
                if not self.model_dir or retries > limit:
                    raise
                if auto_resume:
                    path = self._auto_resume_reload()
                    if path is None:
                        raise
                else:
                    path = Estimator.latest_checkpoint(self.model_dir)
                    if path is None:
                        raise
                    self.load_orca_checkpoint(path)
                logger.exception("training step failed; retry %d/%d from %s",
                                 retries, limit, path)
                skip = self._resume_point(start, history)
                continue
            skip = 0
            history["loss"].append(epoch_loss)
            self._epoch += 1
            val_score = None
            if val_ds is not None:
                val_score = self.evaluate(val_ds, batch_size)
                for k, v in val_score.items():
                    history.setdefault("val_" + k, []).append(v)
                    val_writer.add_scalar(k, v, self._py_step)
            if trigger is not None and _fire_trigger(
                    trigger, self._epoch, self._py_step, epoch_loss,
                    val_score):
                self._save_snapshot()

    def _resume_point(self, start, history) -> int:
        """After a reload inside ``fit``: how many batches of the restored
        epoch the snapshot already took. The history and the read-back
        step losses go back to the snapshot, so the epoch's mean covers
        each of its steps once. A snapshot from before this fit (or one
        that does not fall inside its epochs) restarts its epoch, as the
        JAX estimator does."""
        step0, epoch0, base, per_epoch = start
        done = self._py_step - (step0 + (self._epoch - epoch0) * per_epoch)
        if self._epoch < epoch0 or not 0 <= done <= per_epoch:
            return 0
        for vals in history.values():
            del vals[self._epoch - epoch0:]
        del self.step_losses[base + self._py_step - step0:]
        return done

    def _step(self, x, y, window: Optional[_ProfileWindow]
              ) -> torch.Tensor:
        """One optimizer step (inside a ``zoo_step_<n>`` profiler range
        while a window traces); the step count moves on."""
        if window is not None and window.active:
            with torch.profiler.record_function(f"zoo_step_{self._py_step}"):
                loss = self._train_step(x, y)
        else:
            loss = self._train_step(x, y)
        self._py_step += 1
        return loss

    def _mirror_train_scalars(self, writer: SummaryWriter, step: int,
                              loss: float, throughput: float,
                              step_seconds: float) -> None:
        """One window's training scalars go both ways, as JAX's do: the
        events file (TensorBoard) and the telemetry registry
        (``zoo_training_loss``, ``..._throughput_samples_per_sec``,
        ``..._step_seconds``, ``..._learning_rate``)."""
        reg = telemetry.get_registry()
        reg.gauge("zoo_training_loss",
                  "Last flushed training loss").set(loss)
        reg.gauge("zoo_training_throughput_samples_per_sec",
                  "Training throughput over the last summary window"
                  ).set(throughput)
        reg.histogram("zoo_training_step_seconds",
                      "Mean per-step wall time per summary window"
                      ).observe(step_seconds)
        lr = self._current_lr(step)
        if lr is not None:
            writer.add_scalar("LearningRate", lr, step)
            reg.gauge("zoo_training_learning_rate",
                      "Learning rate at the last flushed step").set(lr)

    def _loop_steps(self, x, y, k: int, window: Optional[_ProfileWindow]
                    ) -> List[torch.Tensor]:
        """The ``k`` steps of one loop of stacked batches (JAX's scan)."""
        return [self._step(tree_map(lambda a: a[i], x),
                           tree_map(lambda a: a[i], y), window)
                for i in range(k)]

    def _run_epoch(self, ds: ShardedDataset, batch_size: int, shuffle: bool,
                   summary_interval: int, trigger: Optional[Trigger],
                   writer: SummaryWriter, skip: int = 0,
                   steps_per_loop: int = 1,
                   window: Optional[_ProfileWindow] = None) -> float:
        """One epoch from its ``skip``-th batch; the mean loss of all its
        steps (those before ``skip`` are the last ``skip`` read back)."""
        start = len(self.step_losses) - skip
        pending: List[torch.Tensor] = []
        t_window = time.perf_counter()

        def flush():
            # one read-back per window of step losses, and the window's
            # summaries from what it read (JAX's flush_window)
            nonlocal t_window
            if not pending:
                return
            t_fetch = time.perf_counter()
            vals = telemetry.traced_device_get(
                torch.stack(pending)).double().tolist()
            telemetry.observe_device_block(time.perf_counter() - t_fetch,
                                           "train_flush")
            self.step_losses.extend(vals)
            step = self._py_step
            writer.add_scalar("Loss", vals[-1], step)
            dt = time.perf_counter() - t_window
            throughput = len(pending) * batch_size / max(dt, 1e-9)
            writer.add_scalar("Throughput", throughput, step)
            self._mirror_train_scalars(writer, step, vals[-1], throughput,
                                       dt / max(len(pending), 1))
            t_window = time.perf_counter()
            pending.clear()

        self.model.train(True)
        if steps_per_loop > 1:
            # one stacked copy a loop, then its steps
            loops = ds.device_scan_iterator(
                self._mesh, self.strategy, batch_size, steps_per_loop,
                shuffle, seed=self.seed, epoch=self._epoch, skip=skip)
        else:
            loops = ((x, y, 1) for x, y, _ in itertools.islice(
                ds.iter_batches(batch_size, shuffle, seed=self.seed,
                                epoch=self._epoch, drop_remainder=True,
                                process_fraction=self._fraction()),
                skip, None))
        prof = self._step_prof
        loops = iter(loops)
        while True:
            # the step profiler's phases: the data wait is the next()
            t0 = time.perf_counter()
            try:
                x, y, k = next(loops)
            except StopIteration:
                break
            t1 = time.perf_counter()
            sampled = prof.should_sample(self._py_step)
            # fault-injection seam: one arrival per loop (a step, or a
            # fused loop as JAX's scan counts once)
            resilience.maybe_fault("step")
            first = self._py_step
            if steps_per_loop > 1:
                pending.extend(self._instrumented("scan")(x, y, k, window))
            else:
                pending.append(self._instrumented("step")(x, y, window))
            t2 = time.perf_counter()
            device_s = None
            if sampled:
                if steps_per_loop > 1:
                    x, y = tree_map(lambda a: a[0], x), \
                        tree_map(lambda a: a[0], y)
                device_s = self._sampled_device_s(t1, x, y)
            t3 = time.perf_counter()
            if len(pending) >= summary_interval:
                flush()
            # iteration-granular snapshots, e.g. SeveralIteration(n), on
            # the last loss read back (ref Topology.scala checkpointTrigger):
            # every step of the loop is tested, one snapshot at most
            last = (self.step_losses[-1] if len(self.step_losses) > start
                    else None)
            if trigger is not None and any(
                    trigger(self._epoch, s, last)
                    for s in range(first + 1, self._py_step + 1)):
                flush()
                self._save_snapshot()
            if window is not None:
                window.on_step(self._py_step)
            prof.observe_step(self._py_step, t0, t1 - t0, t2 - t1, device_s,
                              time.perf_counter() - t3, n_steps=k)
        flush()
        losses = self.step_losses[start:]
        return float(np.mean(losses)) if losses else float("nan")

    def _device_order(self, n: int, shuffle: bool) -> torch.Tensor:
        """The cached epoch's row order, made on the device: a permutation
        from a generator seeded from ``seed + 17`` and ``977 + epoch``
        (ROADMAP C14), or ``arange(n)``."""
        if not shuffle:
            return torch.arange(n, device=self.device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(((self.seed + 17) * 1000003 + 977 + self._epoch)
                        & 0x7FFFFFFFFFFF)
        return torch.randperm(n, generator=gen, device=self.device)

    def _run_epoch_cached(self, ds: ShardedDataset, batch_size: int,
                          shuffle: bool, writer: SummaryWriter,
                          window: Optional[_ProfileWindow] = None,
                          skip: int = 0) -> float:
        """(JAX ``_run_epoch_cached``) One epoch over the device-resident
        dataset: the permutation drawn on the device, every batch indexed
        there, the losses read back once."""
        if self._cached is None or self._cached[0] is not ds:
            # a strong reference: an id() could alias a new dataset made
            # at a freed one's address
            cpu = torch.device("cpu")
            self._cached = (ds, *(telemetry.traced_device_put(
                tree_map(lambda a: as_tensor(a, cpu), t), self.device)
                for t in (ds.x, ds.y)))
        _, cx, cy = self._cached
        n_steps = ds.n // batch_size
        if n_steps < 1:
            raise ValueError(f"batch_size {batch_size} > dataset {ds.n}")
        order = self._device_order(ds.n, shuffle)
        idx = order[:n_steps * batch_size].view(n_steps, batch_size)
        self.model.train(True)
        prof = self._step_prof
        t_epoch = time.perf_counter()
        losses = []
        for i in range(skip, n_steps):
            t0 = time.perf_counter()
            ib = idx[i]
            x, y = tree_map(lambda a: a[ib], cx), tree_map(lambda a: a[ib],
                                                           cy)
            t1 = time.perf_counter()
            sampled = prof.should_sample(self._py_step)
            losses.append(self._step(x, y, window))
            t2 = time.perf_counter()
            device_s = self._sampled_device_s(t1, x, y) if sampled else None
            t3 = time.perf_counter()
            if window is not None:
                window.on_step(self._py_step)
            prof.observe_step(self._py_step, t0, t1 - t0, t2 - t1, device_s,
                              time.perf_counter() - t3)
        t_fetch = time.perf_counter()
        vals = telemetry.traced_device_get(
            torch.stack(losses)).double().tolist() if losses else []
        telemetry.observe_device_block(time.perf_counter() - t_fetch,
                                       "train_epoch_cached")
        dt = time.perf_counter() - t_epoch
        self.step_losses.extend(vals)
        if vals:
            step = self._py_step
            throughput = len(vals) * batch_size / max(dt, 1e-9)
            writer.add_scalar("Loss", vals[-1], step)
            writer.add_scalar("Throughput", throughput, step)
            self._mirror_train_scalars(writer, step, vals[-1], throughput,
                                       dt / len(vals))
        done = self.step_losses[len(self.step_losses) - n_steps:]
        return float(np.mean(done)) if done else float("nan")

    def evaluate(self, data, batch_size: int = 32, feature_cols=None,
                 label_cols=None) -> Dict[str, float]:
        """(ref orca/learn/tf/estimator.py evaluate:656) The mean loss and
        each metric over every row; the padded rows of the final batch are
        masked out."""
        ds = self._dataset(data, feature_cols, label_cols)
        states = [m.init_state(self.device) for m in self.metrics]
        sums, counts = [], []
        self.model.train(False)
        if self._parallel:
            self._check_batches(math.ceil(ds.n / self._per_rank(batch_size)))
        with torch.inference_mode():
            for x, y, mask in ds.iter_batches(
                    batch_size, drop_remainder=False,
                    process_fraction=self._fraction()):
                preds = self._forward(self._tensors(x), train=False)
                y = self._tensors(y)
                if self._parallel:
                    # the global batch: every rank's rows and masks
                    n = _leaves(y)[0].shape[0]
                    mask = self._gather_rows(
                        torch.ones(n, device=self.device) if mask is None
                        else as_tensor(mask, self.device))
                    preds, y = self._gather_rows(preds), \
                        self._gather_rows(y)
                    if bool((mask > 0).all()):
                        mask = None
                per = self.loss_fn(y, preds)
                m = torch.ones_like(per) if mask is None else \
                    as_tensor(mask, self.device)
                sums.append((per * m).sum())
                counts.append(m.sum())
                mt = None if mask is None else m
                states = [metric.update(s, y, preds, mt)
                          for metric, s in zip(self.metrics, states)]
        loss_sum = float(torch.stack(sums).double().sum())
        count = float(torch.stack(counts).double().sum())
        out = {"loss": loss_sum / max(count, 1.0)}
        for metric, s in zip(self.metrics, states):
            out[metric.name] = metric.result(s)
        return out

    def predict(self, data, batch_size: int = 32, feature_cols=None,
                pipeline_window: int = 2):
        """(ref estimator.py predict:598-654) The model's outputs for every
        row, as numpy (a tuple of arrays for a model with several); given
        XShards, ``HostXShards([{"prediction": outputs}])``. Batches go
        through ``common/pipeline_io.DevicePipeline``: up to
        ``pipeline_window`` launched batches stay in flight, and a batch
        is read back only when the window retires it. The outputs are
        bitwise the synchronous ones (``pipeline_window=1``). Across ranks
        each batch is synchronous and the outputs are the global batch's,
        on every rank."""
        was_shards = isinstance(data, XShards)
        if isinstance(data, tuple):
            # predict takes features only: a tuple is a multi-input x
            data = {"x": data}
        ds = self._dataset(data, feature_cols, None)
        if ds.n == 0:
            raise ValueError("predict called on an empty dataset")
        outs = []

        def take(comp):
            if comp.error is not None:
                raise comp.error
            preds, mask = comp.result, comp.ctx
            if mask is not None:
                valid = int(mask.sum())
                preds = tree_map(lambda a: a[:valid], preds)
            outs.append(preds)

        forward = self._instrumented("predict")
        self.model.train(False)
        if self._parallel:
            self._check_batches(math.ceil(ds.n / self._per_rank(batch_size)))
            with torch.inference_mode():
                for x, _, mask in ds.iter_batches(
                        batch_size, drop_remainder=False,
                        process_fraction=self._fraction()):
                    preds = forward(self._tensors(x), train=False)
                    n = _leaves(preds)[0].shape[0]
                    keep = self._gather_rows(
                        torch.ones(n, device=self.device) if mask is None
                        else as_tensor(mask, self.device)) > 0
                    outs.append(to_numpy(tree_map(
                        lambda a: a[keep], self._gather_rows(preds))))
        else:
            self._predict_local(ds, batch_size, forward, pipeline_window,
                                take)
        if isinstance(outs[0], tuple):
            merged = tuple(np.concatenate([o[i] for o in outs])
                           for i in range(len(outs[0])))
        else:
            merged = np.concatenate(outs)
        if was_shards:
            return HostXShards([{"prediction": merged}])
        return merged

    def _predict_local(self, ds, batch_size, forward, pipeline_window,
                       take) -> None:
        from analytics_zoo_tpu_torch.common.pipeline_io import DevicePipeline
        with torch.inference_mode():
            pipe = DevicePipeline(
                lambda x: forward(self._tensors(x), train=False),
                lambda out: to_numpy(telemetry.traced_device_get(out)),
                window=max(1, int(pipeline_window)),
                trace_id="estimator_predict")
            for x, _, mask in ds.iter_batches(batch_size,
                                              drop_remainder=False):
                for comp in pipe.submit(x, ctx=mask):
                    take(comp)
            for comp in pipe.drain():
                take(comp)

    # ------------- persistence (JAX layout, learn/checkpoint.py) -------
    def _param_layout(self) -> ParamLayout:
        if self._layout is None:
            self._layout = ParamLayout(self.model)
        return self._layout

    def _state_tree(self, spec: bool = False) -> dict:
        """The JAX estimator's state tree, ``{"model_state", "opt_state",
        "params", "step"}``, as host arrays; with ``spec`` the same tree
        with meta tensors for leaves (shapes and dtypes only), to restore
        and validate against."""
        layout = self._param_layout()
        named = dict(self.model.named_parameters())
        buffers = {k: v for k, v in self.model.state_dict(
            keep_vars=True).items() if k not in named}
        if self._shards and not spec:
            # every leaf whole, as an unsharded fit writes it
            with torch.no_grad():
                named = {n: self._whole(n, p.detach())
                         for n, p in named.items()}
        if spec:
            opt_state = (self._opt_state if self._opt_state is not None
                         else defaultdict(lambda: None, count=0))
            opt = self.optimizer.optax_state(
                opt_state, lambda _, lead=(): layout.spec(lead))
            params = layout.like
            model_state = layout.state_tree({k: v.to("meta")
                                             for k, v in buffers.items()})
        else:
            def tree(tensors, lead=()):
                with torch.no_grad():
                    given = {n: self._whole(n, t.detach()) for n, t in
                             zip(self._names, tensors)}
                for n, p in named.items():
                    if n not in given:      # frozen: optax keeps zeros
                        given[n] = p.new_zeros(tuple(lead) + p.shape)
                return layout.to_tree(given, lead)
            opt = self.optimizer.optax_state(self._ensure_opt_state(), tree)
            params = layout.to_tree(named)
            model_state = layout.state_tree({k: v.detach().cpu()
                                             for k, v in buffers.items()})
        if self._grad_clip is not None:
            # the JAX _tx() chains the clip in front: {"0": {}, "1": tx}
            opt = {"0": {}, "1": opt}
        return {"model_state": model_state, "opt_state": opt,
                "params": params,
                "step": np.asarray(self._py_step, np.int32)}

    def _restore(self, state: dict) -> None:
        """Copy a restored state tree into the module (in place) and the
        optimizer state."""
        layout = self._param_layout()
        named = dict(self.model.named_parameters())
        values = layout.from_tree(state["params"])
        buffers = {k: v for k, v in self.model.state_dict(
            keep_vars=True).items() if k not in named}
        saved = layout.state_from_tree(state["model_state"])
        with torch.no_grad():
            for n, p in named.items():
                p.copy_(self._block(n, values[n]))
            for k, b in buffers.items():
                b.copy_(saved[k])

        def untree(tree, lead=0):
            vals = layout.from_tree(tree, lead)
            return [self._block(n, vals[n]).to(self.device, named[n].dtype,
                                               copy=True)
                    for n in self._names]
        opt = state["opt_state"]
        if self._grad_clip is not None:
            opt = opt["1"]
        self._opt_state = self.optimizer.from_optax_state(opt, untree)

    def _write(self, directory: str, **kw) -> str:
        """The state into ``directory``'s next ``ckpt-<step>``; across
        ranks every rank gathers, rank 0 writes and the others wait for
        it."""
        state = self._state_tree()
        path = os.path.join(directory, f"ckpt-{self._py_step}")
        if not self._parallel or self._mesh.rank == 0:
            path = ckpt_lib.save_checkpoint(directory, state, self._py_step,
                                            self._epoch, **kw)
        if self._parallel:
            collectives.barrier()
        return path

    def _save_snapshot(self) -> str:
        path = self._write(self.model_dir)
        logger.info("checkpoint saved: %s", path)
        return path

    def save(self, path: str) -> str:
        """Weights, optimizer state and step into ``path/ckpt-<step>/``, as
        ``JaxEstimator.save`` writes them (ref spark_estimator.save)."""
        os.makedirs(path, exist_ok=True)
        self._write(path, max_to_keep=10 ** 9)
        return path

    def load(self, path: str) -> "TorchEstimator":
        """Restore the newest ``ckpt-<n>`` under ``path`` (or ``path``
        itself when it is one), written by either package."""
        found = ckpt_lib.find_latest_checkpoint(path)
        return self.load_orca_checkpoint(path if found is None else found[0])

    def load_orca_checkpoint(self, path: str, version: Optional[int] = None
                             ) -> "TorchEstimator":
        """(ref orca/learn/tf/estimator.py:270-289) Restore ``path`` (or
        ``path/ckpt-<version>``), validated against this model."""
        if version is not None:
            path = os.path.join(path, f"ckpt-{version}")
        state, meta = ckpt_lib.load_checkpoint(path,
                                               self._state_tree(spec=True))
        self._restore(state)
        self._epoch = int(meta.get("epoch", 0))
        self._py_step = int(meta.get("iteration", 0))
        return self

    def _auto_resume_reload(self) -> Optional[str]:
        """Reload the newest snapshot in ``model_dir`` that validates
        against this model; its path, or None when none is usable."""
        loaded = ckpt_lib.load_latest_checkpoint(self.model_dir,
                                                 self._state_tree(spec=True))
        if loaded is None:
            return None
        state, meta, path = loaded
        self._restore(state)
        self._epoch = int(meta.get("epoch", 0))
        self._py_step = int(meta.get("iteration", 0))
        return path

    def get_model(self) -> nn.Module:
        """The trained module (ref spark_estimator.get_model); under
        sharded parameters a copy with them whole (collective: every rank
        calls it)."""
        if not self._shards:
            return self.model
        whole = self.gathered_state_dict()
        model = copy.deepcopy(self.model)
        for name in self._shards:
            owner, _, leaf = name.rpartition(".")
            mod = model.get_submodule(owner) if owner else model
            setattr(mod, leaf, nn.Parameter(
                whole[name].clone(), requires_grad=getattr(mod, leaf)
                .requires_grad))
        return model
