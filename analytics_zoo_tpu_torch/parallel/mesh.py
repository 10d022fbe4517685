"""The device mesh: a grid of ranks with named axes.

Counterpart of ``analytics_zoo_tpu/parallel/mesh.py``. JAX's mesh is a
grid of the devices of every process; one JAX process drives all of its
host's devices. Here one process drives one device (ROADMAP C27): a
``DeviceMesh`` is a grid of ``torch.distributed`` ranks, each rank one
process on one device. Every rank builds the same mesh; each knows its
coordinate on every axis (``coord``) and holds the ``torch.distributed``
subgroup of the ranks it shares every other coordinate with
(``axis_group``: the ranks of its row along that axis). Without a process
group the mesh has one rank, this process, and no groups.

A mesh is built as JAX builds its ``jax.sharding.Mesh``: a 1-D
``("data",)`` mesh by default, ``shape`` may hold one ``-1`` that takes
the rest, and the shape must cover every rank. ``build_mesh(devices=...)``
with devices of this process (the context's local meshes, TCMF's
one-device mesh) keeps the one-process grid of earlier slices.

- ``place_on_mesh(tree, mesh, spec_fn)``: each leaf is the global host
  array, the same on every rank; the result is this rank's block of it
  under ``spec_fn(leaf)`` (a tuple of axis names or None per dim, JAX's
  ``PartitionSpec`` as a tuple), on the rank's device. dtypes are
  canonicalised as JAX's are (float64 to float32); int64 stays int64 (the
  port's lookups take either, ROADMAP C23).
- ``local_batch_to_global(batch, mesh, axis_name)``: each rank feeds its
  own rows (``ShardedDataset.iter_batches(process_fraction=)``), so the
  rank's batch already is its block of the global batch; it goes to the
  rank's device as it is. In a one-rank mesh both are JAX's.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
EXPERT_AXIS = "expert"
#: the stages of parallel/pipeline.py
PIPE_AXIS = "pipe"

_default_mesh = None


class DeviceMesh:
    """``devices``: an object array of the mesh's shape holding each rank's
    ``torch.device`` (this rank's own where the rank is this process; the
    others' as ``cuda:<local rank>`` or ``cpu``, as the launch placed
    them); ``ranks``: the global rank at each position; ``rank``: this
    process's global rank; ``axis_names``: one name per dimension."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 ranks: Optional[np.ndarray] = None, rank: int = 0):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.ranks = (np.arange(devices.size).reshape(devices.shape)
                      if ranks is None else ranks)
        self.rank = int(rank)
        #: axis name -> the subgroup this rank is in (None: a one-rank
        #: row, or no process group)
        self._groups: Dict[str, object] = {}

    @property
    def shape(self) -> Dict[str, int]:
        """``{axis name: size}``, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def distributed(self) -> bool:
        """True when the mesh spans ranks of a process group."""
        return self.size > 1 and torch.distributed.is_initialized() \
            and torch.distributed.get_world_size() == self.size

    @property
    def device(self) -> torch.device:
        """This rank's device."""
        return self.devices.flat[int(np.argmax(self.ranks.ravel()
                                               == self.rank))]

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis`` (0 for an axis the mesh
        lacks)."""
        if axis not in self.axis_names:
            return 0
        pos = np.argwhere(self.ranks == self.rank)[0]
        return int(pos[self.axis_names.index(axis)])

    def axis_ranks(self, axis: str) -> List[int]:
        """The global ranks of this rank's row along ``axis``, in axis
        order."""
        if axis not in self.axis_names:
            return [self.rank]
        pos = list(np.argwhere(self.ranks == self.rank)[0])
        i = self.axis_names.index(axis)
        pos[i] = slice(None)
        return [int(r) for r in self.ranks[tuple(pos)]]

    def axis_group(self, axis: str):
        """The ``torch.distributed`` group of ``axis_ranks(axis)``, or None
        for a row of one rank."""
        return self._groups.get(axis)

    def data_index(self, axes: Sequence[str]) -> int:
        """This rank's index over ``axes`` together, the first axis
        major: which block of each global batch the rank feeds."""
        idx = 0
        for ax in axes:
            idx = idx * mesh_axis_size(self, ax) + self.coord(ax)
        return idx

    def __repr__(self):
        inner = ", ".join(f"'{a}': {n}" for a, n in self.shape.items())
        return f"DeviceMesh({inner})"


def _devices_of_context():
    from analytics_zoo_tpu_torch.common.context import active_context
    ctx = active_context()
    if ctx is not None:
        return ctx.devices
    from analytics_zoo_tpu_torch.common.device import resolve_device
    return [resolve_device(None)]


def _resolve_shape(axes, shape, n: int) -> List[int]:
    if shape is None:
        if len(axes) != 1:
            raise ValueError("mesh_shape required when len(mesh_axes) > 1")
        shape = (n,)
    shape = list(shape)
    if shape.count(-1) > 1:
        raise ValueError("at most one -1 axis size")
    if -1 in shape:
        i = shape.index(-1)
        rest = math.prod(s for s in shape if s != -1)
        if n % rest:
            raise ValueError(f"cannot infer -1 in mesh shape {shape} over "
                             f"{n} devices")
        shape[i] = n // rest
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} does not cover {n} devices")
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    return shape


def _rank_device() -> torch.device:
    """This rank's device: the context's first device, else the CUDA
    device of ``LOCAL_RANK`` where CUDA is present, else the CPU."""
    from analytics_zoo_tpu_torch.common.context import active_context
    ctx = active_context()
    if ctx is not None:
        return ctx.devices[0]
    import os
    if torch.cuda.is_available():
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return torch.device("cpu")


def _make_groups(mesh: DeviceMesh) -> None:
    """Every rank creates every row's group, in one order (``new_group``
    is collective over the whole world), and keeps its own rows'."""
    import torch.distributed as dist
    shape = mesh.devices.shape
    for i, axis in enumerate(mesh.axis_names):
        if shape[i] == 1:
            continue
        moved = np.moveaxis(mesh.ranks, i, -1).reshape(-1, shape[i])
        for row in moved:
            row = [int(r) for r in row]
            if len(row) == mesh.size:
                group = dist.group.WORLD
            else:
                group = dist.new_group(ranks=row)
            if mesh.rank in row:
                mesh._groups[axis] = group


def build_mesh(axes: Optional[Sequence[str]] = None,
               shape: Optional[Sequence[int]] = None,
               devices=None, set_default: bool = True) -> DeviceMesh:
    """A mesh over the ranks of the process group (every rank calls it
    with the same arguments), or over ``devices`` of this process, or,
    without a process group, over the active context's devices (else the
    CUDA device, which raises without CUDA). ``shape`` may contain one
    ``-1`` which absorbs the remaining ranks."""
    global _default_mesh
    axes = (DATA_AXIS,) if axes is None else tuple(axes)
    import torch.distributed as dist
    if devices is None and dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        shape = _resolve_shape(axes, shape, world)
        own = _rank_device()
        grid = np.empty(world, dtype=object)
        for r in range(world):
            grid[r] = own if r == rank else torch.device(
                own.type, r % max(1, torch.cuda.device_count())) \
                if own.type == "cuda" else torch.device("cpu")
        mesh = DeviceMesh(grid.reshape(shape), axes,
                          ranks=np.arange(world).reshape(shape), rank=rank)
        _make_groups(mesh)
    else:
        if devices is None:
            devices = _devices_of_context()
        shape = _resolve_shape(axes, shape, len(devices))
        grid = np.empty(len(devices), dtype=object)
        grid[:] = list(devices)
        mesh = DeviceMesh(grid.reshape(shape), axes)
    if set_default:
        _default_mesh = mesh
    return mesh


def get_default_mesh() -> DeviceMesh:
    """The process-wide default mesh, a 1-D data mesh built on first
    ask."""
    if _default_mesh is None:
        build_mesh()
    return _default_mesh


def set_default_mesh(mesh: Optional[DeviceMesh]) -> None:
    global _default_mesh
    _default_mesh = mesh


def mesh_axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The size of ``axis`` in ``mesh``; 1 for an axis it lacks."""
    return mesh.shape.get(axis, 1)


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def block_of(a, mesh: DeviceMesh, spec) -> np.ndarray:
    """This rank's block of host array ``a`` under ``spec`` (one entry per
    leading dim: None, an axis name or a tuple of them, the first axis
    major). A dim must divide over its axes."""
    out = np.asarray(a)
    for dim, entry in enumerate(tuple(spec or ())):
        axes = [ax for ax in _axes(entry) if mesh_axis_size(mesh, ax) > 1]
        if not axes:
            continue
        n = math.prod(mesh_axis_size(mesh, ax) for ax in axes)
        if out.shape[dim] % n:
            raise ValueError(f"dim {dim} of size {out.shape[dim]} does not "
                             f"divide over {axes} ({n})")
        step = out.shape[dim] // n
        i = mesh.data_index(axes)
        out = np.take(out, np.arange(i * step, (i + 1) * step), axis=dim)
    return out


def _canonical(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == np.float64 else a


def place_on_mesh(tree, mesh: DeviceMesh, spec_fn):
    """This rank's block of every leaf of ``tree`` (global host arrays,
    the same on every rank) under ``spec_fn(leaf)``, as tensors on the
    rank's device; float64 becomes float32."""
    from analytics_zoo_tpu_torch.data.dataset import tree_map
    device = mesh.device

    def one(x):
        a = _canonical(x)
        return torch.from_numpy(np.ascontiguousarray(
            block_of(a, mesh, spec_fn(a)))).to(device)
    return tree_map(one, tree)


def local_batch_to_global(batch, mesh: DeviceMesh,
                          axis_name: str = DATA_AXIS):
    """The rank's own rows of a global batch (its block along
    ``axis_name``) on the rank's device; float64 becomes float32."""
    from analytics_zoo_tpu_torch.data.dataset import tree_map
    device = mesh.device
    return tree_map(lambda x: torch.from_numpy(np.ascontiguousarray(
        _canonical(x))).to(device), batch)
