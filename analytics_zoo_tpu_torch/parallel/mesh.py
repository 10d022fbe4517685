"""The device mesh: the part the context needs.

Counterpart of ``analytics_zoo_tpu/parallel/mesh.py:39-100``. A mesh here
is a grid of ``torch.device``s with named axes (``DeviceMesh``), built as
JAX builds its ``jax.sharding.Mesh``: a 1-D ``("data",)`` mesh over the
devices by default, ``shape`` may hold one ``-1`` that takes the rest, and
the shape must cover every device. The port drives the devices of one
process and shards nothing yet: ``torch.distributed``, the sharding
strategies and ``place_on_mesh`` are ROADMAP A9.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np

DATA_AXIS = "data"

_default_mesh = None


class DeviceMesh:
    """``devices``: an object array of ``torch.device`` of the mesh's
    shape; ``axis_names``: one name per dimension."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        """``{axis name: size}``, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

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


def build_mesh(axes: Optional[Sequence[str]] = None,
               shape: Optional[Sequence[int]] = None,
               devices=None, set_default: bool = True) -> DeviceMesh:
    """A mesh over ``devices`` (default: the active context's, else the
    CUDA device, which raises without CUDA). ``shape`` may contain one
    ``-1`` which absorbs the remaining devices."""
    global _default_mesh
    if devices is None:
        devices = _devices_of_context()
    n = len(devices)
    axes = (DATA_AXIS,) if axes is None else tuple(axes)
    if shape is None:
        if len(axes) != 1:
            raise ValueError("mesh_shape required when len(mesh_axes) > 1")
        shape = (n,)
    shape = list(shape)
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
    grid = np.empty(n, dtype=object)
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
