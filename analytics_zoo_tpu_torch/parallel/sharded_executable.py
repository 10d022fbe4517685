"""A model sharded over a group of ranks behind one serving replica.

Counterpart of ``analytics_zoo_tpu/parallel/sharded_executable.py``.
``ClusterServing`` scales out by adding replicas; this module scales the
other axis: one replica whose model is partitioned by a
``ShardingStrategy`` (tp / fsdp / dp rules, the first match wins) over a
mesh of ranks.

**The design (ROADMAP C28).** JAX's one process drives every device of
its mesh, so its sharded replica is one process. Here one process drives
one device (C27), so a sharded replica is a group of ranks:

- every rank builds the same ``ShardedExecutable`` (the constructor is
  collective): the parameters start as rank 0's, each parameter the
  strategy shards is held as this rank's block (``convert.shard_plan``,
  JAX's rules against flax's paths and shapes), and the modules that
  compute on blocks get them (``tensor_parallel``'s column, row and
  lookup paths); the other sharded parameters are all-gathered for each
  forward;
- **rank 0 leads**: it holds the ``InferenceModel``, the engine, the
  broker clients and the frontend, and each dispatch (``__call__``)
  broadcasts a header (the op, and the batch's shapes and dtypes) and
  then the batch; it alone returns the result;
- **ranks 1..n-1 follow** (``follow()``): for each header they receive
  the batch, run the same forward on their blocks under
  ``torch.inference_mode`` and join its collectives, until rank 0 sends
  stop (``close()``). A follower that raises exits its process, which
  fails the launch (``parallel/launch.py``);
- the batch is split over the strategy's batch axes (each rank its block
  of rows, the rows must divide) and the output gathered over them; under
  tensor parallelism every rank computes the whole batch.

``shard_hbm_bytes`` counts each rank's resident parameter bytes (its
blocks and its replicated parameters), gathered keyed by rank once, in
the constructor (the blocks stay as they are until the executable is
dropped), publishing ``zoo_shard_hbm_bytes{shard}``; reading them later
is local, so ``/healthz`` never waits on the group. Each rank's forward runs
under ``telemetry.instrument_jit`` with the executable's name, so a rung
warmed by ``warm`` dispatches after with ``zoo_jit_cache_misses_total``
flat on every rank.
"""

from __future__ import annotations

import copy
import threading
from typing import Dict, Tuple

import numpy as np
import torch

from analytics_zoo_tpu_torch.common import telemetry
from analytics_zoo_tpu_torch.parallel import collectives
from analytics_zoo_tpu_torch.parallel import tensor_parallel
from analytics_zoo_tpu_torch.parallel.strategy import ShardingStrategy


class ShardedExecutable:
    """A module (or a pure ``fn(params, *inputs)``) with its parameters
    sharded over a mesh of ranks, dispatched from rank 0 (the module
    docstring).

    ``module_or_fn``: an ``nn.Module`` (copied), its parameters replaced
    by ``params`` when given (a flax tree, through
    ``convert.flax_to_shard_state_dict``); or a pure ``fn(params,
    *inputs)``, whose ``params`` (a nested dict) become an
    ``FnModule``'s. ``device``: this rank's device (default: the mesh's
    device for this rank)."""

    def __init__(self, module_or_fn, params=None, strategy="tp", *,
                 param_rules=None, mesh=None, devices=None,
                 name: str = "sharded", device=None):
        import torch.distributed as dist
        from analytics_zoo_tpu_torch.convert import (flax_to_shard_state_dict,
                                                     shard_plan)
        self.name = name
        self.strategy = ShardingStrategy.parse(strategy,
                                               param_rules=param_rules)
        grouped = dist.is_available() and dist.is_initialized()
        if mesh is None:
            if not grouped and devices is None:
                for kind, n in self.strategy.sizes:
                    if n > 1:
                        raise ValueError(
                            f"strategy {self.strategy} needs {n} ranks on "
                            f"its {kind} axis; this process is one rank: "
                            "start the ranks (parallel/launch.py, torchrun)"
                            " and shard on every one")
                from analytics_zoo_tpu_torch.common.device import (
                    resolve_device)
                from analytics_zoo_tpu_torch.parallel import mesh as mesh_lib
                mesh = mesh_lib.build_mesh(
                    self.strategy.axis_names(),
                    [1] * len(self.strategy.sizes),
                    devices=[resolve_device(device)], set_default=False)
            else:
                mesh = self.strategy.build_mesh(devices=devices,
                                                set_default=False)
        if mesh.size > 1 and not mesh.distributed:
            raise ValueError(f"a mesh of {mesh.size} devices needs as many "
                             "ranks: one process drives one device")
        self.mesh = mesh
        self.device = torch.device(device) if device is not None \
            else mesh.device
        if isinstance(module_or_fn, torch.nn.Module):
            module = copy.deepcopy(module_or_fn)
        else:
            from analytics_zoo_tpu_torch.learn.estimator import FnModule
            module, params = FnModule(module_or_fn, params), None
        module = module.to(self.device).eval()
        blocks = None
        if params is not None:
            # a flax tree: this rank's blocks, the rest whole
            blocks = flax_to_shard_state_dict(params, module, self.strategy,
                                              mesh)
        self.shards = shard_plan(module, self.strategy, mesh)
        with torch.no_grad():
            if blocks is not None:
                module.load_state_dict({k: v for k, v in blocks.items()
                                        if k not in self.shards},
                                       strict=False)
            elif mesh.distributed:
                # every rank starts from rank 0's parameters and buffers
                for t in module.state_dict(keep_vars=True).values():
                    collectives.broadcast_mesh_(t.data, mesh)
        tensor_parallel.install_shards(module, self.shards, blocks)
        for p in module.parameters():
            p.requires_grad_(False)
        covered = tensor_parallel.covered_names(module, self.shards)
        self.gathered = [n for n in self.shards if n not in covered]
        self.module = module
        self._by_name = dict(module.named_parameters())
        self._lock = threading.RLock()
        self._closed = False
        self._armed = False        # rank 0: the followers are listening
        self._jitted = telemetry.instrument_jit(self._local, name=name)
        self._m_shard_hbm = telemetry.get_registry().gauge(
            "zoo_shard_hbm_bytes",
            "Parameter bytes resident per mesh shard (device) — "
            "max(shard) < total proves the model never fits one device",
            ("shard",))
        #: every rank's resident bytes, gathered once (collective)
        self._hbm_totals = self._hbm()
        self._publish(self._hbm_totals)
        self._armed = self.leader and mesh.size > 1

    # ------------------------------------------------------------ layout
    @property
    def leader(self) -> bool:
        return self.mesh.rank == 0

    @property
    def n_shards(self) -> int:
        return int(self.mesh.size)

    def batch_sharding(self, ndim: int) -> tuple:
        """The batch's spec (JAX's ``PartitionSpec`` as a tuple)."""
        return self.strategy.batch_spec(ndim)

    def _batch_axes(self) -> Tuple[str, ...]:
        return tuple(ax for ax in self.strategy.batch_axes()
                     if self.mesh.shape.get(ax, 1) > 1)

    # --------------------------------------------------------- forward
    def _local(self, *xs):
        """This rank's part of one forward: its rows, its blocks."""
        axes = self._batch_axes()
        if axes:
            n = int(np.prod([self.mesh.shape[ax] for ax in axes]))
            rows = xs[0].shape[0]
            if rows % n:
                raise ValueError(f"batch {rows} does not divide over the "
                                 f"batch axes {axes} ({n} blocks)")
            i, step = self.mesh.data_index(axes), rows // n
            xs = tuple(x[i * step:(i + 1) * step] for x in xs)
        if self.gathered:
            whole = {n: self.shards[n].gather(self._by_name[n])
                     for n in self.gathered}
            out = torch.func.functional_call(self.module, whole, xs,
                                             strict=False)
        else:
            out = self.module(*xs)
        if axes:
            gather = lambda t: collectives.gather_axes(  # noqa: E731
                t, self.mesh, axes, 0)
            out = tuple(map(gather, out)) if isinstance(out, tuple) \
                else gather(out)
        return out

    def _tensors(self, xs):
        from analytics_zoo_tpu_torch.common.device import as_tensor
        return tuple(x.to(self.device) if isinstance(x, torch.Tensor)
                     else as_tensor(np.asarray(x), self.device) for x in xs)

    def _send(self, op: str, tensors=()) -> None:
        """Rank 0: the header, then each tensor, to the followers."""
        header = {"op": op, "specs": [(tuple(t.shape), str(t.dtype))
                                      for t in tensors]}
        collectives.broadcast_object(header, self.mesh)
        for t in tensors:
            collectives.broadcast_mesh_(t.contiguous(), self.mesh)

    def __call__(self, *xs):
        """Rank 0: one forward over the group; the output on rank 0."""
        if not self.leader:
            raise RuntimeError("rank 0 dispatches; the other ranks follow()")
        with self._lock:
            if self._closed:
                raise RuntimeError("the sharded executable is closed")
            xs = self._tensors(xs)
            with torch.inference_mode():
                if self._armed:
                    self._send("forward", xs)
                return self._jitted(*xs)

    def warm(self, spec, rungs, block: bool = True, cpu_also: bool = False):
        """One forward on zeros at each rung of ``spec`` (the per-sample
        ``((shape, dtype), ...)`` form ``InferenceModel`` records) on every
        rank, so that each rank's first run of the shape falls here.
        ``block=False`` runs on a thread; ``cpu_also`` is JAX's (it warms
        a CPU failover the port does not have) and is ignored."""
        def zeros(rung, shape, dtype):
            shape = (int(rung),) + tuple(shape)
            if isinstance(dtype, torch.dtype):
                return torch.zeros(shape, dtype=dtype, device=self.device)
            return np.zeros(shape, np.dtype(dtype))

        def run():
            for r in rungs:
                self(*(zeros(r, shape, dtype) for shape, dtype in spec))
        if block:
            run()
            return self
        t = threading.Thread(target=run, daemon=True,
                             name=f"{self.name}-warm")
        t.start()
        return self

    # -------------------------------------------------------- followers
    def follow(self) -> int:
        """Ranks 1..n-1: serve rank 0's dispatches until it sends stop;
        returns the number of forwards run."""
        if self.leader:
            raise RuntimeError("rank 0 leads; follow() runs on the others")
        served = 0
        while True:
            header = collectives.broadcast_object(None, self.mesh)
            op = header["op"]
            if op == "stop":
                self._closed = True
                return served
            if op == "whole":
                self._whole_state()
            elif op == "forward":
                xs = []
                for shape, dtype in header["specs"]:
                    t = torch.empty(shape, dtype=getattr(
                        torch, dtype.replace("torch.", "")),
                        device=self.device)
                    xs.append(collectives.broadcast_mesh_(t, self.mesh))
                with torch.inference_mode():
                    self._jitted(*xs)
                served += 1
            else:
                raise RuntimeError(f"unknown op {op!r} from rank 0")

    def close(self) -> None:
        """Rank 0: release the followers (their ``follow()`` returns).
        Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            if self._armed:
                self._send("stop")

    # ------------------------------------------------------ accounting
    def total_param_bytes(self) -> int:
        """Bytes of the whole model's parameters."""
        total = 0
        for n, p in self._by_name.items():
            shape = self.shards[n].shape if n in self.shards else p.shape
            total += int(np.prod(shape)) * p.element_size()
        return total

    def _hbm(self) -> Dict[str, int]:
        """Every rank's resident parameter bytes, summed into its slot
        (collective)."""
        mine = torch.zeros(self.mesh.size, dtype=torch.float64,
                           device=self.device)
        mine[self.mesh.rank] = float(sum(
            p.numel() * p.element_size() for p in self._by_name.values()))
        if self.mesh.distributed:
            collectives.all_reduce_(mine, self.mesh, self.mesh.axis_names)
        return {str(r): int(v) for r, v in enumerate(mine.tolist())}

    def shard_hbm_bytes(self, publish: bool = True) -> Dict[str, int]:
        """Parameter bytes resident on each rank, keyed by rank, as every
        rank counted its tensors in the constructor (local: no rank is
        asked again)."""
        totals = dict(self._hbm_totals)
        if publish:
            self._publish(totals)
        return totals

    def _publish(self, totals: Dict[str, int]) -> None:
        for shard, nbytes in totals.items():
            self._m_shard_hbm.labels(shard=shard).set(nbytes)

    def _whole_state(self) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            return {k: (self.shards[k].gather(v) if k in self.shards
                        else v).detach()
                    for k, v in self.module.state_dict(
                        keep_vars=True).items()}

    def whole_module(self) -> torch.nn.Module:
        """Rank 0: a copy of the module with every parameter whole
        (collective)."""
        with self._lock:
            if self.mesh.size > 1 and (self._closed or not self.leader):
                raise RuntimeError("rank 0 gathers the whole module, before "
                                   "close()")
            if self._armed:
                self._send("whole")
            state = self._whole_state()
        module = copy.deepcopy(self.module)
        for n in self.shards:
            owner, _, leaf = n.rpartition(".")
            mod = module.get_submodule(owner) if owner else module
            setattr(mod, leaf, torch.nn.Parameter(state[n].clone(),
                                                  requires_grad=False))
        return module
